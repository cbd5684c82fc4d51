// Gradient of the single-layer GRU recurrence over a whole sequence for
// Hopper (sm_90a), fp32 on the CUDA cores, one thread-block cluster per
// tile of batch rows.
//
// The TPU kernel gesture2vec_tpu/ops/gru_pallas.py (gru_sequence_fused ->
// _gru_seq_kernel) has no gradient: the JAX trainers run the recurrence as
// lax.scan and let JAX differentiate it. The port routes every BiGRU
// through csrc/gru_sequence.cu, so training on the card needs this kernel:
// the backward pass through time (BPTT) of the forward's math
//   gh = h_prev @ w_hh^T + b_hh                      (gate order r, z, n)
//   r  = sigmoid(xp_r + gh_r),  z = sigmoid(xp_z + gh_z)
//   n  = tanh(xp_n + r * gh_n), h = (1 - z) * n + z * h_prev
// walking the steps in the opposite order from the forward (t = T-1 .. 0,
// or 0 .. T-1 for `reverse`). At each step it recomputes gh and the gates
// from h_prev (the previous step's output, read back from ys, or h0), adds
// the step's output gradient to the carried one (dh = dys[t] + carry) and
// writes
//   d x_proj[t] = (dpre_r, dpre_z, dpre_n)
//   dgh[t]      = (dpre_r, dpre_z, dpre_n * r)     (the hidden-side gates)
// with dpre_n = dh (1 - z)(1 - n^2), dpre_r = dpre_n gh_n r (1 - r),
// dpre_z = dh (h_prev - n) z (1 - z); then carries
//   dh_prev = dh * z + dgh[t] @ w_hh
// and finally writes d h0. The weight gradients dW_hh = dgh^T h_prev and
// db_hh = sum dgh are two large products over all steps at once, left to
// the caller (ops/gru_kernel.GRUSequenceFn), as the JAX package leaves
// them to XLA.
//
// Bound at the tokenizer's width (T=20, B=128, H=200): the recomputed gh
// and dgh @ w_hh are 4*T*B*H*3H = 1.23 GFLOP, 0.018 ms at the card's 67
// TFLOP/s fp32 peak; the bytes (x_proj, h0, w_hh, b_hh, ys, dys, dh_last
// in; d x_proj, dgh, d h0 out: 22 MB) take 0.007 ms at 3.35 TB/s. So it
// is bound by operations. Like the forward, each step is a dependent chain
// and its latency, not the FMA rate, sets the pace.
//
// Design. It keeps the forward's layout: a cluster of C=4 blocks owns R=20
// batch rows, block `rank` owns the hidden units [rank*U, rank*U + U),
// U = ceil(H/C), and holds its r, z, n rows of w_hh (3U x H) and its b_hh
// slice in shared memory for the whole launch.
//  - gh and the gates of its own units need the full h_prev tile (R x H):
//    every block stages it from ys (or h0) with cp.async, double-buffered
//    so the next step's tile lands during this step;
//  - dh_prev needs w_hh's columns (dgh @ w_hh sums over all 3H rows), and
//    a second, transposed copy of the block's rows would not fit beside
//    the first (2 x 120 KB at H=200). So each block forms the partial sum
//    over its own 3U rows for every column k, and sends the part for
//    units owned by block c into c's receive slot through distributed
//    shared memory; after one cluster barrier a block adds its C partials
//    in rank order (a fixed order, so the result does not depend on
//    timing) and the carried dh*z;
//  - the receive slots are double-buffered by step parity: a block cannot
//    write slot s&1 again before every block has passed step s+1's
//    barrier, which follows its reads of step s. One cluster barrier a
//    step suffices;
//  - a thread's gate item is RT=4 rows x 1 unit x 3 gates, the forward's;
//    its partial-sum items are RT rows x 1 column, neighbouring threads on
//    neighbouring columns (conflict-free rows of w_hh);
//  - ragged batches: rows past B read zeros, their gradients are zero,
//    and they write nothing.
//
// Eligibility: the block's shared memory, 4 * (3*U*HP + 2*R*HP + 2*C*R*U
// + R*3U + R*U + 3U) bytes with HP the padded row (see smem_bytes), must
// fit 232,448 B: H <= 216 (gru_kernel.backward_launch_shape mirrors the
// formula).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int R = 20;   // batch rows per cluster
constexpr int C = 4;    // blocks per cluster
constexpr int RT = 4;   // rows per thread
constexpr int kMaxThreads = 512;
constexpr int kSmemLimit = 232448;
static_assert(R % RT == 0, "tile");

__host__ __device__ __forceinline__ int units(int H) {
  return (H + C - 1) / C;
}
// row stride in floats: an odd number of float4s, so the 32 units a warp
// reads at once fall in distinct banks
__host__ __device__ __forceinline__ int padded(int H) {
  const int q = (H + 3) / 4;
  return 4 * (q % 2 ? q : q + 1);
}
// one thread per gate item (a unit and RT rows)
int threads_for(int H) { return (units(H) * (R / RT) + 31) / 32 * 32; }
size_t smem_bytes(int H) {
  const size_t U = units(H), HP = padded(H);
  return sizeof(float) * (3 * U * HP + 2 * R * HP + 2 * C * R * U +
                          R * 3 * U + R * U + 3 * U);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// copies n_rows x width floats from `src` (row stride ld_src) to `dst`
// (row stride ld_dst), zero-filling rows >= valid_rows and columns >=
// valid_cols; 16-byte copies when `vec` (widths and strides multiples of
// 4, aligned pointers)
__device__ __forceinline__ void stage(float* dst, int ld_dst, const float* src,
                                      int ld_src, int n_rows, int width,
                                      int valid_rows, int valid_cols,
                                      const float* safe, bool vec) {
  const int step = vec ? 4 : 1, per_row = width / step;
  for (int i = threadIdx.x; i < n_rows * per_row; i += blockDim.x) {
    const int r = i / per_row, k = (i % per_row) * step;
    const bool ok = r < valid_rows && k < valid_cols;
    const float* from = ok ? src + (size_t)r * ld_src + k : safe;
    if (vec)
      cp_async16(dst + r * ld_dst + k, from, ok ? 16 : 0);
    else
      cp_async4(dst + r * ld_dst + k, from, ok ? 4 : 0);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
gru_sequence_backward_kernel(
    const float* __restrict__ xp,     // (T, B, 3H) forward input
    const float* __restrict__ h0,     // (B, H)
    const float* __restrict__ whh,    // (3H, H)
    const float* __restrict__ bhh,    // (3H)
    const float* __restrict__ ys,     // (T, B, H) forward outputs
    const float* __restrict__ dys,    // (T, B, H) output gradients
    const float* __restrict__ dhl,    // (B, H) last-hidden gradient
    float* __restrict__ dxp,          // (T, B, 3H)
    float* __restrict__ dgh,          // (T, B, 3H)
    float* __restrict__ dh0,          // (B, H)
    int T, int B, int H, int reverse, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = units(H), HP = padded(H), q4 = (H + 3) / 4;
  const int u0 = rank * U, row0 = (blockIdx.x / C) * R;

  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [3U][HP] w_hh slice
  float* hp = ws + 3 * U * HP;                  // [2][R][HP] h_prev tiles
  float* recv = hp + 2 * R * HP;                // [2][C][R][U] partials
  float* dg = recv + 2 * C * R * U;             // [R][3U] this step's dgh
  float* dhc = dg + R * 3 * U;                  // [R][U] carried dh
  float* bs = dhc + R * U;                      // [3U] b_hh slice

  // the step order of the backward and the h_prev each step reads
  auto t_of = [&](int s) { return reverse ? s : T - 1 - s; };
  auto h_prev_src = [&](int t) -> const float* {
    const int tp = reverse ? t + 1 : t - 1;
    const float* base = (tp >= 0 && tp < T) ? ys + (size_t)tp * B * H : h0;
    return base + (size_t)row0 * H;
  };

  for (int g = 0; g < 3; ++g)
    stage(ws + g * U * HP, HP, whh + ((size_t)g * H + u0) * H, H, U, HP,
          H - u0, H, whh, vec);
  stage(hp, HP, h_prev_src(t_of(0)), H, R, HP, B - row0, H, whh, vec);
  cp_async_commit();
  for (int i = threadIdx.x; i < 3 * U; i += blockDim.x) {
    const int g = i / U, u = u0 + i % U;
    bs[i] = u < H ? bhh[g * H + u] : 0.f;
  }

  // this thread's gate item: unit u0 + j and rows grp*RT .. grp*RT + RT-1
  const int grp = threadIdx.x / U, j = threadIdx.x % U, u = u0 + j;
  const bool active = grp < R / RT, unit_ok = active && u < H;
  for (int i = threadIdx.x; i < R * U; i += blockDim.x) {
    const int r = i / U, uu = u0 + i % U, b = row0 + r;
    dhc[i] = (uu < H && b < B) ? dhl[(size_t)b * H + uu] : 0.f;
  }
  cp_async_wait<0>();
  // every block's buffers are ready before any peer writes them
  cluster.sync();

  const int n_items = (R / RT) * H;
  for (int s = 0; s < T; ++s) {
    const int t = t_of(s);
    if (s + 1 < T)
      stage(hp + ((s + 1) & 1) * R * HP, HP, h_prev_src(t_of(s + 1)), H, R,
            HP, B - row0, H, whh, vec);
    cp_async_commit();
    cp_async_wait<1>();  // this step's h_prev tile has landed
    __syncthreads();
    const float* hcur = hp + (s & 1) * R * HP;

    // gh = h_prev @ w_hh^T for this item's rows, k in order
    float acc[RT][3];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.f;
    if (active) {
      const float* wr = ws + j * HP;
      const float* hr = hcur + grp * RT * HP;
#pragma unroll 2
      for (int q = 0; q < q4; ++q) {
        float4 w[3];
#pragma unroll
        for (int g = 0; g < 3; ++g)
          w[g] = *reinterpret_cast<const float4*>(wr + g * U * HP + 4 * q);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float4 h = *reinterpret_cast<const float4*>(hr + i * HP + 4 * q);
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            acc[i][g] = fmaf(h.x, w[g].x, acc[i][g]);
            acc[i][g] = fmaf(h.y, w[g].y, acc[i][g]);
            acc[i][g] = fmaf(h.z, w[g].z, acc[i][g]);
            acc[i][g] = fmaf(h.w, w[g].w, acc[i][g]);
          }
        }
      }
    }

    // the gates' gradients of this item's rows
    float dhz[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      dhz[i] = 0.f;
      if (!active) continue;
      const int r = grp * RT + i, b = row0 + r;
      float* d = dg + r * 3 * U + j;
      if (!unit_ok || b >= B) {
        d[0] = d[U] = d[2 * U] = 0.f;
        continue;
      }
      const size_t o3 = ((size_t)t * B + b) * 3 * H + u;
      const float ghn = acc[i][2] + bs[2 * U + j];
      const float rg = sigmoid_f(xp[o3] + (acc[i][0] + bs[j]));
      const float zg = sigmoid_f(xp[o3 + H] + (acc[i][1] + bs[U + j]));
      const float ng = tanhf(xp[o3 + 2 * H] + rg * ghn);
      const float hprev = hcur[r * HP + u];
      const float dh = dys[((size_t)t * B + b) * H + u] + dhc[r * U + j];
      const float dpn = dh * (1.f - zg) * (1.f - ng * ng);
      const float dpr = dpn * ghn * rg * (1.f - rg);
      const float dpz = dh * (hprev - ng) * zg * (1.f - zg);
      dxp[o3] = dpr;
      dxp[o3 + H] = dpz;
      dxp[o3 + 2 * H] = dpn;
      dgh[o3] = dpr;
      dgh[o3 + H] = dpz;
      dgh[o3 + 2 * H] = dpn * rg;
      d[0] = dpr;
      d[U] = dpz;
      d[2 * U] = dpn * rg;
      dhz[i] = dh * zg;
    }
    __syncthreads();  // this block's dgh rows are complete

    // partial dgh @ w_hh over this block's 3U rows, for every column k,
    // sent to the block that owns unit k
    float* slot = recv + (s & 1) * C * R * U + rank * R * U;
    for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
      const int pg = it / H, k = it % H;
      float p[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) p[i] = 0.f;
      const float* dr = dg + pg * RT * 3 * U;
      for (int m = 0; m < 3 * U; ++m) {
        const float w = ws[m * HP + k];
#pragma unroll
        for (int i = 0; i < RT; ++i) p[i] = fmaf(dr[i * 3 * U + m], w, p[i]);
      }
      float* dst = cluster.map_shared_rank(slot, k / U);
#pragma unroll
      for (int i = 0; i < RT; ++i) dst[(pg * RT + i) * U + k % U] = p[i];
    }
    // publishes the partials; every read of this step's tile is done
    cluster.sync();

    // dh_prev of this item's rows: dh * z plus the C partials in order
    const float* got = recv + (s & 1) * C * R * U;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = grp * RT + i, b = row0 + r;
      if (!unit_ok || b >= B) continue;
      float v = dhz[i];
#pragma unroll
      for (int c = 0; c < C; ++c) v += got[(c * R + r) * U + j];
      dhc[r * U + j] = v;
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = grp * RT + i, b = row0 + r;
    if (unit_ok && b < B) dh0[(size_t)b * H + u] = dhc[r * U + j];
  }
}

cudaLaunchConfig_t launch_config(int B, int H, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + R - 1) / R) * C);
  cfg.blockDim = dim3(threads_for(H));
  cfg.dynamicSmemBytes = smem_bytes(H);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// sets the shared-memory attribute and checks that one cluster of this
// shape fits the card
cudaError_t prepare(int B, int H, cudaStream_t stream, int* max_clusters) {
  *max_clusters = 0;
  const size_t smem = smem_bytes(H);
  if (smem > kSmemLimit || threads_for(H) > kMaxThreads)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      gru_sequence_backward_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(B, H, stream, &attr);
  e = cudaOccupancyMaxActiveClusters(max_clusters,
                                     gru_sequence_backward_kernel, &cfg);
  if (e != cudaSuccess) return e;
  return *max_clusters > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

std::mutex prepare_mutex;
int checked_H = -1;

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers to
// contiguous fp32 arrays, w_hh in the torch layout (3H, H); `stream` is a
// cudaStream_t. Returns a cudaError_t code (0 = launched).
extern "C" int g2v_gru_sequence_backward(
    const float* xp, const float* h0, const float* whh, const float* bhh,
    const float* ys, const float* dys, const float* dhl, float* dxp,
    float* dgh, float* dh0, int T, int B, int H, int reverse, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  {
    const std::lock_guard<std::mutex> lock(prepare_mutex);
    if (H != checked_H) {
      int n = 0;
      const cudaError_t e = prepare(B, H, st, &n);
      if (e != cudaSuccess) return (int)e;
      checked_H = H;
    }
  }
  const bool vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(whh) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h0) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ys) % 16 == 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(B, H, st, &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gru_sequence_backward_kernel, xp, h0, whh, bhh, ys, dys, dhl,
      dxp, dgh, dh0, T, B, H, reverse, (int)vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch shape for (B, H), so callers can check their mirror of it:
// out = {rows per cluster, blocks per cluster, threads per block, dynamic
// shared bytes, clusters in the grid, clusters the card holds at once}.
extern "C" int g2v_gru_sequence_backward_shape(int B, int H,
                                               long long* out) {
  if (B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  int n = 0;
  cudaError_t e;
  {
    // prepare() sets the kernel's shared-memory attribute for this H: a
    // launch re-prepares for its own H afterwards
    const std::lock_guard<std::mutex> lock(prepare_mutex);
    e = prepare(B, H, nullptr, &n);
    checked_H = e == cudaSuccess ? H : -1;
  }
  out[0] = R;
  out[1] = C;
  out[2] = threads_for(H);
  out[3] = (long long)smem_bytes(H);
  out[4] = (B + R - 1) / R;
  out[5] = n;
  return (int)e;
}
