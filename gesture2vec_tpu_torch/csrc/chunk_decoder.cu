// Fused Part-b chunk rollout for Hopper (sm_90a), fp32 on the CUDA cores,
// the decoder's weights resident across a 16-block thread-block cluster.
//
// Replaces the TPU kernel gesture2vec_tpu/ops/decoder_pallas.py
// (fused_chunk_decode -> _decoder_kernel). One launch runs all n_steps of
//   p   = relu((x @ w_pre^T) * bn_scale + bn_bias)  (eval BN, pre bias folded)
//   h0' = GRU(p,  h0; w0_ih, w0_hh, b0_ih, b0_hh)     (gate order r, z, n)
//   h1' = GRU(h0', h1; w1_ih, w1_hh, b1_ih, b1_hh)
//   x   = h1' @ w_out^T + b_out                        -> ys[t], fed back
// Weights come in the torch layout (out, in).
//
// Bound at the decode path's width (H=200, D=40, 20 steps): each row and
// step is ~992 kFLOP, so 0.0018 ms at B=6 and 0.54 ms at B=1824 at the
// card's 67 TFLOP/s fp32 (non-tensor-core) peak; the 2 MB of weights take
// 0.0006 ms at 3.35 TB/s. Bound by operations, but at small B a launch is
// a chain of 20 dependent steps, each two GRU phases and two exchanges
// between blocks, so the latency of a step sets the time.
//
// Design. The TPU kernel keeps all weights in VMEM for all steps. The two
// GRU layers' weights are 1.92 MB at H=200: over 8 blocks that is 240,000
// B a block, more than one block's 232,448, so a cluster of C=16 blocks (a
// non-portable cluster size) holds them:
//  - block `rank` owns the hidden units [rank*U, rank*U + U), U =
//    ceil(H/16) (13 at H=200; the last block owns 5). Once per launch it
//    stages its r, z, n rows of w_ih and w_hh for both layers (124,800 B)
//    and full copies of w_pre and w_out (64,000 B) into shared memory with
//    cp.async.bulk copies completing on an mbarrier; the step loop reads
//    no weight from global memory, only x0 and h0 at a tile's start;
//  - every block holds the tile's full state of both layers, double
//    buffered, and computes the full p and the full x locally from its
//    copies of w_pre and w_out. After each GRU layer a block writes its
//    units' new state into its own full state and into a compact slice;
//    one cluster barrier publishes the slices, and each block pulls the
//    other 15 slices through distributed shared memory (float4 reads):
//    two barriers a step;
//  - a GRU unit is a warp: its 32 lanes split k (float4 chunks) over R
//    rows x (r, z, n_in, n_h) accumulators, and a butterfly reduce-scatter
//    over the warp leaves each lane one sum, so the gates of a row finish
//    in one lane; the out layer splits k the same way, 4 outputs a warp,
//    and the pre-linear gives each unit a lane pair. The order of sums is
//    free here: the rollout feeds no argmin or argmax (the tokens are
//    fixed before it);
//  - clusters are persistent: the grid is min(tiles, the clusters the card
//    holds), each stages the weights once and walks its tiles of R <= 8
//    rows; R comes from B by rows_for (mirrored by
//    ops/decoder_kernel.launch_shape): as few rounds of tiles as the card
//    allows, then as few rows a tile as those rounds allow. The kernel is
//    a template over R, so every row loop is unrolled;
//  - rows past B start from zeros, read nothing and are never written.
// What holds it back: a step costs about 5 us at R=1 and 9 us at R=8
// (PERF.md). The card holds 7 such clusters, so B=1824 takes 33 rounds of
// 20 steps, and its time is 11x its bound. Taller tiles do not cure it:
// w_pre and w_out sliced by unit (up to 32 rows a tile, one more barrier
// a step) measured on an H100 (PERF.md) 13 % faster at B=1824 and 22 %
// slower at B=6, since a row's step costs about as much in a tall tile
// as in a short one.
//
// bf16 instantiation (g2v_chunk_decode_bf16): the eval-mode decode of a
// bf16-trained tokenizer's validation (the JAX package's compute_dtype:
// bfloat16 runs its DecoderStep in bf16: pre_linear, BatchNorm and the GRU
// cells return bf16 and the hidden is carried in bf16). The same kernel,
// templated on the storage type of x0, h0, the weights, the folded BN and
// ys. Products and gate math stay fp32 on the CUDA cores; what JAX holds
// in bf16 between modules is rounded to bf16 (__float2bfloat16_rn) where
// it is stored: p after the folded BN and ReLU, each layer's new h (the
// carry) and each output x (fed back). The weights sit in shared memory as
// bf16 (four are one 8-byte read; the copy is a plain loop: bulk copies
// want 16-byte rows), so more H fits; the state tiles stay fp32 holding
// bf16 values. Bound at B=128, H=200, D=40, 19 steps: 2.41 GFLOP at the
// card's 989 TFLOP/s bf16 tensor-core peak (0.0024 ms) against 1 MB of
// bf16 bytes: bound by operations. The products run on the CUDA cores
// (0.036 ms at 67 TFLOP/s fp32).
//
// Eligibility: the block's shared memory (layout() below) must fit
// 232,448 B and a block's units must be at most 16 (a warp each, H <=
// 256): fp32 H <= 204 at D=40 (shared memory), bf16 H <= 256 (units; its
// shared memory would take H <= 292). A block has 512 threads.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "storage.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int C = 16;   // blocks per cluster
constexpr int RM = 8;   // most rows in a tile
constexpr int S = 32;   // lanes that split k for one unit: a warp
constexpr int US = 16;  // stride of the units in the `own` slices, >= U
constexpr int kThreads = 512;
constexpr int kSmemLimit = 232448;
constexpr unsigned kFull = 0xffffffffu;

// Offsets (in floats) into a block's shared memory. The weight regions
// (wg, wpre, wout) hold esz-byte values, each region rounded up to 16
// bytes; the rest is fp32.
struct Layout {
  int U, H4, DP, DR;
  int wg, wpre, wout, bns, bnb, bout, bg, own, xs, ps, h0a, h0b, h1a, h1b,
      total;
};

__host__ __device__ inline Layout layout(int H, int D, int esz) {
  // floats taken by n weights of esz bytes
  const auto wf = [esz](int n) { return 4 * ((n * esz + 15) / 16); };
  Layout l;
  l.U = (H + C - 1) / C;
  l.H4 = 4 * ((H + 3) / 4);
  const int q = (D + 3) / 4;
  // w_pre's rows, read by lane pairs that take alternate float4s: 2
  // float4s past a multiple of 4, so the 4 rows and 8 float4s a quarter
  // warp reads fall in distinct banks
  l.DP = 4 * (q + ((2 - q) % 4 + 4) % 4);
  l.DR = 4 * q;
  int o = 4;                          // the mbarrier, 16 bytes
  l.wg = o;   o += wf(12 * l.U * l.H4);  // [layer][ih, hh][r, z, n][U][H4]
  l.wpre = o; o += wf(H * l.DP);         // [H][DP]
  l.wout = o; o += wf(l.DR * l.H4);      // [DR][H4]
  l.bns = o;  o += l.H4;
  l.bnb = o;  o += l.H4;
  l.bout = o; o += l.DR;
  l.bg = o;   o += 4 * ((12 * l.U + 3) / 4);  // [layer][ih, hh][r, z, n][U]
  l.own = o;  o += 2 * RM * US;       // [layer][RM][US]
  l.xs = o;   o += RM * l.DP;         // the tile's x, [RM][DP]
  l.ps = o;   o += RM * l.H4;         // p, [RM][H4]
  l.h0a = o;  o += RM * l.H4;         // layer-0 state, twice
  l.h0b = o;  o += RM * l.H4;
  l.h1a = o;  o += RM * l.H4;         // layer-1 state, twice
  l.h1b = o;  o += RM * l.H4;
  l.total = o;
  return l;
}

size_t smem_bytes(int H, int D, int esz) {
  return sizeof(float) * layout(H, D, esz).total;
}

// Rows per tile for B rows when the card holds max_clusters clusters.
int rows_for(int B, int max_clusters) {
  const int rounds = (B + RM * max_clusters - 1) / (RM * max_clusters);
  const int r = (B + rounds * max_clusters - 1) / (rounds * max_clusters);
  return r < RM ? r : RM;
}

// The gates' sigmoid from the fast exponential and division (relative
// error near 1e-7, far inside the 1e-4 contract; it sits on each step's
// dependent chain)
__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared bulk copy (16-byte aligned, a multiple of 16 bytes)
// completing on the mbarrier at `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// Rows rounded up to a power of two: the accumulators a lane keeps per
// output are 4 * pow2(R), so the butterfly below halves them evenly.
__host__ __device__ constexpr int pow2(int r) {
  return r <= 1 ? 1 : 2 * pow2((r + 1) / 2);
}

// One butterfly level over a warp (partner at offset O): N values become
// N/2, each the sum of this lane's and its partner's; a single value is
// summed with the partner's.
template <int N, int O>
__device__ __forceinline__ void level(float* v) {
  if constexpr (N >= 2) {
    const bool up = threadIdx.x & O;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = up ? v[i] : v[i + N / 2];
      const float keep = up ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
  } else {
    v[0] += __shfl_xor_sync(kFull, v[0], O);
  }
}

// Sums v (N <= 32 values) over the warp. After it, lane s holds the sum
// of v[s * N / 32] in v[0].
template <int N>
__device__ __forceinline__ void reduce32(float (&v)[N]) {
  static_assert(N <= 32, "one value a lane at most");
  level<N, 16>(v);
  level<(N >= 2 ? N / 2 : 1), 8>(v);
  level<(N >= 4 ? N / 4 : 1), 4>(v);
  level<(N >= 8 ? N / 8 : 1), 2>(v);
  level<(N >= 16 ? N / 16 : 1), 1>(v);
}

// The first lane that holds the sum of index i after reduce32<N>.
template <int N>
__device__ __forceinline__ int lane_of(int i) {
  return i * (32 / N);
}

template <typename Elt>
struct Params {
  const Elt *x0, *h0, *w_pre, *bn_scale, *bn_bias, *w_out, *b_out;
  const Elt* w[4];  // w0_ih, w0_hh, w1_ih, w1_hh, each (3H, H)
  const Elt* b[4];  // b0_ih, b0_hh, b1_ih, b1_hh, each (3H)
  Elt* ys;          // (T, B, D)
  int B, D, H, T, bulk;
};

// a read through the read-only cache (fp32) or a plain one
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ldg(const __nv_bfloat16* p) {
  return *p;
}

// The fp32 weights' bulk copies (stage_weights' `bulk` case).
__device__ void stage_bulk(const Params<float>& P, const Layout& L,
                           float* sm, int u0, int nv, float* wg, float* wpre,
                           float* wout) {
  const int H = P.H, D = P.D, U = L.U, H4 = L.H4, DP = L.DP;
  const int tid = threadIdx.x, nt = blockDim.x;
  // bulk: H4 == H and L.DR == D, so a gate's unit rows and all of w_out
  // are contiguous on both sides; w_pre's rows are padded to DP here
  const uint32_t bar = smem_u32(sm);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t bytes = 4u * (12u * nv * H + 2u * H * D);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(bytes)
                 : "memory");
  }
  __syncthreads();
  if (tid < 12 && nv > 0) {
    const int m = tid / 3, g = tid % 3;
    bulk_copy(wg + (m * 3 + g) * U * H4, P.w[m] + (size_t)(g * H + u0) * H,
              4u * nv * H, bar);
  }
  if (tid == 12) bulk_copy(wout, P.w_out, 4u * D * H, bar);
  for (int n = tid; n < H; n += nt)
    bulk_copy(wpre + n * DP, P.w_pre + (size_t)n * D, 4u * D, bar);
  // what no copy writes: the rows of units this block lacks, w_pre's pad
  for (int i = tid; i < 12 * (U - nv) * H4; i += nt) {
    const int per = (U - nv) * H4, s = i / per, r = i % per;
    wg[s * U * H4 + nv * H4 + r] = 0.f;
  }
  for (int i = tid; i < H * (DP - D); i += nt)
    wpre[(i / (DP - D)) * DP + D + i % (DP - D)] = 0.f;
  mbar_wait(bar, 0);
  __syncthreads();
}

// Stages this block's weights and biases; `bulk` copies (fp32 only) need
// H and D multiples of 4 and 16-byte aligned weights.
template <typename Elt>
__device__ void stage_weights(const Params<Elt>& P, const Layout& L,
                              float* sm, int u0, int nv) {
  const int H = P.H, D = P.D, U = L.U, H4 = L.H4, DP = L.DP;
  const int tid = threadIdx.x, nt = blockDim.x;
  Elt* wg = reinterpret_cast<Elt*>(sm + L.wg);
  Elt* wpre = reinterpret_cast<Elt*>(sm + L.wpre);
  Elt* wout = reinterpret_cast<Elt*>(sm + L.wout);
  const Elt zero = from_f<Elt>(0.f);
  for (int i = tid; i < 12 * U; i += nt) {
    const int m = i / (3 * U), g = (i / U) % 3, j = i % U;
    sm[L.bg + i] = j < nv ? to_f(P.b[m][g * H + u0 + j]) : 0.f;
  }
  for (int i = tid; i < H; i += nt) {
    sm[L.bns + i] = to_f(P.bn_scale[i]);
    sm[L.bnb + i] = to_f(P.bn_bias[i]);
  }
  for (int i = tid; i < D; i += nt) sm[L.bout + i] = to_f(P.b_out[i]);

  if (!P.bulk) {
    for (int i = tid; i < 12 * U * H4; i += nt) {
      const int row = i / H4, k = i % H4;
      const int m = row / (3 * U), g = (row / U) % 3, j = row % U;
      wg[i] = j < nv && k < H
                  ? ldg(P.w[m] + (size_t)(g * H + u0 + j) * H + k) : zero;
    }
    for (int i = tid; i < H * DP; i += nt) {
      const int n = i / DP, k = i % DP;
      wpre[i] = k < D ? ldg(P.w_pre + (size_t)n * D + k) : zero;
    }
    for (int i = tid; i < L.DR * H4; i += nt) {
      const int d = i / H4, k = i % H4;
      wout[i] = d < D && k < H ? ldg(P.w_out + (size_t)d * H + k) : zero;
    }
    __syncthreads();
    return;
  }
  if constexpr (is_f32<Elt>()) stage_bulk(P, L, sm, u0, nv, wg, wpre, wout);
}

// One GRU layer for a tile of R rows: `in` and `hc` [RM][H4] -> the
// block's units of the new state (rounded to the storage type: the
// carry), into its full next state `hn` and its compact slice `own`
// [RM][US], from which the other blocks pull them.
template <typename Elt, int R>
__device__ __forceinline__ void gru_layer(const float* in, const float* hc,
                                          float* hn, float* own,
                                          const Elt* ws, const float* bs,
                                          const Layout& L, int u0, int nv) {
  constexpr int N = 4 * pow2(R);  // [row][r, z, n_in, n_h]
  const int U = L.U, H4 = L.H4, q4 = H4 / 4;
  const int j = threadIdx.x / S, s = threadIdx.x % S;
  const bool act = j < nv;
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  if (act) {
    const Elt* wi = ws + j * H4;            // w_ih rows r, z, n of unit j
    const Elt* wh = ws + (3 * U + j) * H4;  // w_hh rows
    for (int c = s; c < q4; c += S) {
      const int k = 4 * c;
      const float4 wir = ld4(wi + k), wiz = ld4(wi + U * H4 + k),
                   win = ld4(wi + 2 * U * H4 + k);
      const float4 whr = ld4(wh + k), whz = ld4(wh + U * H4 + k),
                   whn = ld4(wh + 2 * U * H4 + k);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 pv = ld4(in + r * H4 + k), hv = ld4(hc + r * H4 + k);
        acc[4 * r] = dot4(hv, whr, dot4(pv, wir, acc[4 * r]));
        acc[4 * r + 1] = dot4(hv, whz, dot4(pv, wiz, acc[4 * r + 1]));
        acc[4 * r + 2] = dot4(pv, win, acc[4 * r + 2]);
        acc[4 * r + 3] = dot4(hv, whn, acc[4 * r + 3]);
      }
    }
  }
  reduce32(acc);
  // the first lane of a row's sums gathers its four and finishes the row
  const int r = s * N / 128;
  float g[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    g[k] = __shfl_sync(kFull, acc[0], lane_of<N>(4 * r + k));
  if (act && s == lane_of<N>(4 * r) && r < R) {
    const float* bi = bs;          // b_ih slice [r, z, n][U]
    const float* bh = bs + 3 * U;  // b_hh slice
    const float rg = sigmoid_f(g[0] + bi[j] + bh[j]);
    const float zg = sigmoid_f(g[1] + bi[U + j] + bh[U + j]);
    const float ng = tanhf(g[2] + bi[2 * U + j] + rg * (g[3] + bh[2 * U + j]));
    const float h =
        round_to<Elt>((1.f - zg) * ng + zg * hc[r * H4 + u0 + j]);
    hn[r * H4 + u0 + j] = h;
    own[r * US + j] = h;
  }
}

// After the cluster barrier: every other block's units of the new state,
// read from its `own` slice through distributed shared memory (float4s),
// into this block's full next state.
template <int R>
__device__ __forceinline__ void pull_units(cg::cluster_group& cluster,
                                           float* own, float* hn,
                                           const Layout& L, int rank, int H) {
  const int U = L.U, H4 = L.H4;
  for (int i = threadIdx.x; i < C * R * 4; i += blockDim.x) {
    const int c = i / (R * 4), r = (i / 4) % R, q = i % 4;
    if (c == rank || 4 * q >= U) continue;
    const float4 v = ld4(cluster.map_shared_rank(own, c) + r * US + 4 * q);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * q + k, u = c * U + j;
      if (j < U && u < H) hn[r * H4 + u] = e[k];
    }
  }
}

template <typename Elt, int R>
__global__ void __launch_bounds__(kThreads, 1)
chunk_decode_kernel(const Params<Elt> P) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int B = P.B, D = P.D, H = P.H;
  const Layout L = layout(H, D, sizeof(Elt));
  const int U = L.U, H4 = L.H4, DP = L.DP, u0 = rank * U;
  const int nv = max(0, min(U, H - u0));
  const int tid = threadIdx.x, nt = blockDim.x;

  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* xs = sm + L.xs;
  float* ps = sm + L.ps;
  float* h0c = sm + L.h0a;
  float* h0n = sm + L.h0b;
  float* h1c = sm + L.h1a;
  float* h1n = sm + L.h1b;
  const Elt* wg = reinterpret_cast<const Elt*>(sm + L.wg);
  const Elt* wpre = reinterpret_cast<const Elt*>(sm + L.wpre);
  const Elt* wout = reinterpret_cast<const Elt*>(sm + L.wout);
  // the tile buffers' padding (columns past D or H) must read as zeros
  for (int i = L.xs + tid; i < L.total; i += nt) sm[i] = 0.f;
  stage_weights(P, L, sm, u0, nv);
  // every block's buffers are ready before any peer reads them
  cluster.sync();

  constexpr int NO = 4 * pow2(R);  // out layer: [4 outputs][pow2(R) rows]
  const int q4 = H4 / 4, dq = L.DR / 4;
  const int warp = tid / S, s = tid % S;
  const int n_tiles = (B + R - 1) / R;
  for (int tile = blockIdx.x / C; tile < n_tiles; tile += gridDim.x / C) {
    const int row0 = tile * R;
    for (int i = tid; i < R * D; i += nt) {
      const int r = i / D, k = i % D, b = row0 + r;
      xs[r * DP + k] = b < B ? to_f(P.x0[(size_t)b * D + k]) : 0.f;
    }
    for (int i = tid; i < R * H; i += nt) {
      const int r = i / H, k = i % H, b = row0 + r;
      h0c[r * H4 + k] = b < B ? to_f(P.h0[(size_t)b * H + k]) : 0.f;
      h1c[r * H4 + k] = b < B ? to_f(P.h0[((size_t)B + b) * H + k]) : 0.f;
    }
    __syncthreads();

    for (int t = 0; t < P.T; ++t) {
      // p = relu((x @ w_pre^T) * scale + shift): a lane pair per unit,
      // each lane taking alternate float4s of k
      for (int n0 = 0; n0 < H; n0 += nt / 2) {
        const int n = n0 + tid / 2, half = tid % 2;
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
        if (n < H) {
          const Elt* w = wpre + n * DP;
          for (int c = half; c < dq; c += 2) {
            const float4 wv = ld4(w + 4 * c);
#pragma unroll
            for (int r = 0; r < R; ++r)
              acc[r] = dot4(ld4(xs + r * DP + 4 * c), wv, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] += __shfl_xor_sync(kFull, acc[r], 1);
        if (n < H && !half) {
          const float sc = sm[L.bns + n], sh = sm[L.bnb + n];
#pragma unroll
          for (int r = 0; r < R; ++r)
            ps[r * H4 + n] =
                round_to<Elt>(fmaxf(fmaf(acc[r], sc, sh), 0.f));
        }
      }
      __syncthreads();
      float* own0 = sm + L.own;
      float* own1 = own0 + RM * US;
      gru_layer<Elt, R>(ps, h0c, h0n, own0, wg, sm + L.bg, L, u0, nv);
      // publishes every block's new units of layer 0
      cluster.sync();
      pull_units<R>(cluster, own0, h0n, L, rank, H);
      __syncthreads();
      float* tmp = h0c; h0c = h0n; h0n = tmp;
      gru_layer<Elt, R>(h0c, h1c, h1n, own1, wg + 6 * U * H4,
                        sm + L.bg + 6 * U, L, u0, nv);
      cluster.sync();
      pull_units<R>(cluster, own1, h1n, L, rank, H);
      __syncthreads();
      tmp = h1c; h1c = h1n; h1n = tmp;

      // x = h1 @ w_out^T + b_out: a warp per 4 outputs, k split over its
      // lanes; each block writes its share of ys
      for (int g0 = 0; g0 < dq; g0 += kThreads / S) {
        const int g = g0 + warp;
        float acc[NO];
#pragma unroll
        for (int i = 0; i < NO; ++i) acc[i] = 0.f;
        if (g < dq) {
          const Elt* w = wout + 4 * g * H4;
          for (int c = s; c < q4; c += S) {
            const int k = 4 * c;
            const float4 w0 = ld4(w + k), w1 = ld4(w + H4 + k),
                         w2 = ld4(w + 2 * H4 + k), w3 = ld4(w + 3 * H4 + k);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float4 hv = ld4(h1c + r * H4 + k);
              acc[r] = dot4(hv, w0, acc[r]);
              acc[NO / 4 + r] = dot4(hv, w1, acc[NO / 4 + r]);
              acc[NO / 2 + r] = dot4(hv, w2, acc[NO / 2 + r]);
              acc[3 * NO / 4 + r] = dot4(hv, w3, acc[3 * NO / 4 + r]);
            }
          }
        }
        reduce32(acc);
        // lane s holds index i = s * NO / 32: output i / pow2(R), row
        // i % pow2(R); where lanes share an index the first writes it
        const int i = s * NO / 32, r = i % (NO / 4);
        const int d = 4 * g + i / (NO / 4), b = row0 + r;
        if (g < dq && s % (32 / NO) == 0 && r < R && d < D) {
          const float y = round_to<Elt>(acc[0] + sm[L.bout + d]);
          xs[r * DP + d] = y;
          if (b < B && (r * D + d) % C == rank)
            P.ys[((size_t)t * B + b) * D + d] = from_f<Elt>(y);
        }
      }
      __syncthreads();
    }
  }
  // no block leaves while a peer may still read its `own` slices
  cluster.sync();
}

template <typename Elt>
using Kernel = void (*)(Params<Elt>);
// one instantiation per tile height: rows are unrolled in every loop
template <typename Elt>
const Kernel<Elt>* kernels() {
  static const Kernel<Elt> k[RM] = {
      chunk_decode_kernel<Elt, 1>, chunk_decode_kernel<Elt, 2>,
      chunk_decode_kernel<Elt, 3>, chunk_decode_kernel<Elt, 4>,
      chunk_decode_kernel<Elt, 5>, chunk_decode_kernel<Elt, 6>,
      chunk_decode_kernel<Elt, 7>, chunk_decode_kernel<Elt, 8>};
  return k;
}

cudaLaunchConfig_t launch_config(int clusters, size_t smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// per device (device_slot) and storage type (fp32, bf16): the (H, D)
// prepare() last succeeded for, and the clusters the card holds, under
// prepare_mutex: a server's threads launch concurrently
std::mutex prepare_mutex;
struct Checked {
  int H[2] = {-1, -1}, D[2] = {-1, -1};
  int max_clusters[2] = {0, 0};
};
Checked checked_on[kMaxDevices];

// Sets the kernels' attributes (dynamic shared memory, the non-portable
// cluster size) and reads how many 16-block clusters of this shape the
// card holds at once (the least over the tile heights) into *clusters;
// fails if none.
template <typename Elt>
cudaError_t prepare(int H, int D, int* clusters) {
  const std::lock_guard<std::mutex> lock(prepare_mutex);
  const int ti = is_f32<Elt>() ? 0 : 1;
  const int dev = device_slot();
  Checked unknown;
  Checked& checked = dev < 0 ? unknown : checked_on[dev];
  if (H == checked.H[ti] && D == checked.D[ti]) {
    *clusters = checked.max_clusters[ti];
    return cudaSuccess;
  }
  const size_t smem = smem_bytes(H, D, sizeof(Elt));
  // a warp per unit: U <= 16
  if (smem > kSmemLimit || layout(H, D, sizeof(Elt)).U > kThreads / S)
    return cudaErrorInvalidValue;
  int least = 1 << 30;
  for (int i = 0; i < RM; ++i) {
    const Kernel<Elt> k = kernels<Elt>()[i];
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(1, smem, nullptr, &attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
    if (e != cudaSuccess) return e;
    least = n < least ? n : least;
  }
  if (least <= 0) return cudaErrorInvalidConfiguration;
  checked.H[ti] = H;
  checked.D[ti] = D;
  checked.max_clusters[ti] = least;
  *clusters = least;
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename Elt>
int launch(const Elt* x0, const Elt* h0, const Elt* w_pre,
           const Elt* bn_scale, const Elt* bn_bias, const Elt* w0_ih,
           const Elt* w0_hh, const Elt* b0_ih, const Elt* b0_hh,
           const Elt* w1_ih, const Elt* w1_hh, const Elt* b1_ih,
           const Elt* b1_hh, const Elt* w_out, const Elt* b_out, Elt* ys,
           int B, int D, int H, int T, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  int mc = 0;
  cudaError_t e = prepare<Elt>(H, D, &mc);
  if (e != cudaSuccess) return (int)e;
  const int R = rows_for(B, mc);
  Params<Elt> P = {x0, h0, w_pre, bn_scale, bn_bias, w_out, b_out,
                   {w0_ih, w0_hh, w1_ih, w1_hh},
                   {b0_ih, b0_hh, b1_ih, b1_hh}, ys, B, D, H, T, 0};
  // bulk copies: fp32 weights with 16-byte rows
  P.bulk = is_f32<Elt>() && H % 4 == 0 && D % 4 == 0 && aligned16(w_pre) &&
           aligned16(w_out);
  for (int m = 0; m < 4; ++m) P.bulk = P.bulk && aligned16(P.w[m]);
  const int tiles = (B + R - 1) / R;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      tiles < mc ? tiles : mc, smem_bytes(H, D, sizeof(Elt)),
      static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, kernels<Elt>()[R - 1], P);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename Elt>
int shape(int B, int H, int D, long long* out) {
  if (B <= 0 || H <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  int clusters = 0;
  const cudaError_t e = prepare<Elt>(H, D, &clusters);
  const int mc = e == cudaSuccess ? clusters : 1;
  const int R = rows_for(B, mc), tiles = (B + R - 1) / R;
  out[0] = R;
  out[1] = C;
  out[2] = kThreads;
  out[3] = (long long)smem_bytes(H, D, sizeof(Elt));
  out[4] = tiles;
  out[5] = tiles < mc ? tiles : mc;
  out[6] = e == cudaSuccess ? clusters : 0;
  return (int)e;
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers to
// contiguous arrays (fp32, or bf16 for the _bf16 entry points), weights in
// the torch layout: w_pre (H, D), the GRU's (3H, H), w_out (D, H);
// `stream` is a cudaStream_t. Return a cudaError_t code (0 = launched).
extern "C" int g2v_chunk_decode(
    const float* x0, const float* h0, const float* w_pre,
    const float* bn_scale, const float* bn_bias, const float* w0_ih,
    const float* w0_hh, const float* b0_ih, const float* b0_hh,
    const float* w1_ih, const float* w1_hh, const float* b1_ih,
    const float* b1_hh, const float* w_out, const float* b_out, float* ys,
    int B, int D, int H, int T, void* stream) {
  return launch<float>(x0, h0, w_pre, bn_scale, bn_bias, w0_ih, w0_hh, b0_ih,
                       b0_hh, w1_ih, w1_hh, b1_ih, b1_hh, w_out, b_out, ys, B,
                       D, H, T, stream);
}

extern "C" int g2v_chunk_decode_bf16(
    const __nv_bfloat16* x0, const __nv_bfloat16* h0,
    const __nv_bfloat16* w_pre, const __nv_bfloat16* bn_scale,
    const __nv_bfloat16* bn_bias, const __nv_bfloat16* w0_ih,
    const __nv_bfloat16* w0_hh, const __nv_bfloat16* b0_ih,
    const __nv_bfloat16* b0_hh, const __nv_bfloat16* w1_ih,
    const __nv_bfloat16* w1_hh, const __nv_bfloat16* b1_ih,
    const __nv_bfloat16* b1_hh, const __nv_bfloat16* w_out,
    const __nv_bfloat16* b_out, __nv_bfloat16* ys, int B, int D, int H,
    int T, void* stream) {
  return launch<__nv_bfloat16>(x0, h0, w_pre, bn_scale, bn_bias, w0_ih,
                               w0_hh, b0_ih, b0_hh, w1_ih, w1_hh, b1_ih,
                               b1_hh, w_out, b_out, ys, B, D, H, T, stream);
}

// The launch shape for (B, H, D), so callers can check their mirror of
// it: out = {rows per tile, blocks per cluster, threads per block, dynamic
// shared bytes, tiles, clusters in the grid, clusters the card holds}.
extern "C" int g2v_chunk_decode_shape(int B, int H, int D, long long* out) {
  return shape<float>(B, H, D, out);
}

extern "C" int g2v_chunk_decode_shape_bf16(int B, int H, int D,
                                           long long* out) {
  return shape<__nv_bfloat16>(B, H, D, out);
}
