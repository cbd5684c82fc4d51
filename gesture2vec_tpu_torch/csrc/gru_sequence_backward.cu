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
// or 0 .. T-1 for `reverse`). It reads the gates r, z, n and gh_n that the
// forward's training variant saved (g2v_gru_sequence_gates, (T, B, 4H)),
// adds the step's output gradient to the carried one (dh = dys[t] + carry)
// and writes
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
// What held the first design back. It took x_proj instead of the gates
// and cost 0.479 ms at T=20, B=128 (26x its bound), 0.55 ms at B=512 and
// 1.27 ms at T=48 on an H100 80GB HBM3 at 700 W (PERF.md): ~24 us a step
// against the forward's ~8.6 us.
//  1. Every step recomputed the forward's gates: gh = h_prev @ w_hh^T, 600
//     FMAs a thread at H=200, with the whole R x H h_prev tile staged each
//     step. That doubled the step's FLOPs and sat in the serial chain,
//     though the gates do not depend on the carried dh.
//  2. The gate math then loaded x_proj and dys from global memory on the
//     dependent chain, with no prefetch.
//  3. The partial product dgh @ w_hh ran out of scalar shared-memory loads:
//     5*H items over 8 warps (4 rounds), each walking the 3U rows with one
//     w_hh load and four dgh loads for four FMAs (~2,400 FMAs and ~3,000
//     loads a thread a step).
//
// Bound at the tokenizer's width (T=20, B=128, H=200): the one product a
// step, dgh @ w_hh, is 2*T*B*3H*H = 0.61 GFLOP, 0.0092 ms at the card's
// 67 TFLOP/s fp32 peak; the bytes (gates, h0, w_hh, ys, dys, dh_last in;
// d x_proj, dgh, d h0 out: 25 MB) take 0.0076 ms at 3.35 TB/s. So it is
// bound by operations, barely. As in the forward, each step is a
// dependent chain (gate math, product, remote stores, cluster barrier)
// and its latency, not the FMA rate, sets the pace.
//
// Design. A cluster of C=4 blocks owns R=20 batch rows, block `rank` owns
// the hidden units [rank*U, rank*U + U), U = ceil(H/C), and holds its r, z,
// n rows of w_hh (3U x H) in shared memory for the whole launch.
//  - gate items: a thread owns RT=4 rows x 1 unit. The step's inputs of
//    its item (the four saved gates, dys and h_prev of its own unit) are
//    loaded into registers a step ahead, so they land while the previous
//    step's product runs; the carried dh stays in registers. No h_prev
//    tile and no product for gh: the gate math is ~20 flops a row.
//    (cp.async into shared-memory slots, the forward's way, would need
//    2 x R x 6 x U floats double-buffered: 239,328 B a block at H=216,
//    past the card's 232,448. Registers cost no shared memory.)
//  - the step's dgh rows are stored transposed ([3U][R], one float4 of a
//    thread's 4 rows a gate), so the product's items read them as
//    broadcast float4s;
//  - one product a step, the partial dgh @ w_hh over the block's 3U rows
//    for every column k: a thread owns an item of RT rows x 4 columns
//    (16 sums in registers), walks the 3U rows in order with one float4
//    of dgh and one float4 of w_hh (neighbouring threads on neighbouring
//    columns: no bank conflicts) for 16 FMAs. There are (R/RT) x
//    ceil(H/4) = (R/RT) x U items, one round for the block's threads;
//  - the part for units owned by block c goes into c's receive slot
//    through distributed shared memory, one float4 (the item's 4 rows) a
//    column: the slots are laid out [C][U][R], so the gate item that owns
//    a unit reads its 4 rows of a partial as one float4 too (4 remote
//    stores and 4 loads a thread a step instead of 16 scalar ones; PERF.md
//    has the step's time both ways). After one cluster barrier a block
//    adds its C partials in rank order (a fixed order, so the result does
//    not depend on timing) to dh * z;
//  - the receive slots are double-buffered by step parity: a block cannot
//    write slot s&1 again before every block has passed step s+1's
//    barrier, which follows its reads of step s. One cluster barrier a
//    step suffices;
//  - ragged batches: rows past B read nothing, their gradients are zero,
//    and they write nothing.
// What holds it back now: a step costs about what a forward step costs
// (PERF.md), far above its share of the bound: the latency of its
// dependent chain (gate math, block barrier, the product's 3U rows in
// order, remote stores, cluster barrier), as in the forward.
//
// bf16 instantiation (g2v_gru_sequence_backward_bf16), the gradient of
// the bf16 forward (csrc/gru_sequence.cu's bf16 instantiation, which saves
// bf16 gates): the same kernel, templated on the storage type of the
// gates, h0, w_hh, ys, dys, dh_last and of d x_proj, dgh and d h0. It
// reads bf16 and computes in fp32: the gate math, the product dgh @ w_hh
// (from the fp32 dgh of the step, before it is rounded for the store) and
// the carried dh stay fp32; d x_proj, dgh and d h0 are rounded to bf16 as
// they are written. The w_hh slice sits in shared memory as bf16 (four
// weights are one 8-byte read). Bound at T=20, B=128, H=200: 12.7 MB of
// bf16 bytes (0.0038 ms at 3.35 TB/s) against 0.61 GFLOP at the card's
// 989 TFLOP/s bf16 tensor-core peak (0.00062 ms): bound by bytes. The
// product runs on the CUDA cores (0.0092 ms at 67 TFLOP/s fp32). Staging
// is a plain copy loop, once per launch.
//
// Eligibility: the block's shared memory (smem_bytes: fp32 4 * (3U*W +
// 2*C*R*U + 3U*R) bytes with W = H rounded up to a multiple of 4; bf16 the
// slice at 2 bytes a weight rounded up to 16 bytes, plus 4 * (2*C*R*U +
// 3U*R)) must fit 232,448 B and the block's threads the launch bound of
// 320: fp32 H <= 244 (shared memory), bf16 H <= 256 (threads);
// gru_kernel.backward_launch_shape mirrors both. The forward's limits
// (fp32 H <= 232, bf16 H <= 340) apply too.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "storage.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int R = 20;   // batch rows per cluster
constexpr int C = 4;    // blocks per cluster
constexpr int RT = 4;   // rows per thread
constexpr int kMaxThreads = 320;  // the launch bound; H <= 256 takes <= 320
constexpr int kSmemLimit = 232448;
constexpr int kIn = 6;  // a gate item's inputs a row: r, z, n, gh_n, dy, h_prev
static_assert(R % RT == 0 && RT == 4, "tile: a float4 of rows");

__host__ __device__ __forceinline__ int units(int H) {
  return (H + C - 1) / C;
}
// w_hh row stride in floats: H rounded up to a float4 (the product reads
// neighbouring float4s of one row, so no padding is needed for banks)
__host__ __device__ __forceinline__ int row4(int H) { return (H + 3) / 4 * 4; }
// one thread per gate item (a unit and RT rows)
int threads_for(int H) { return (units(H) * (R / RT) + 31) / 32 * 32; }
// bytes of the block's w_hh slice, rounded up to 16 so the fp32 buffers
// after it stay float4-aligned
template <typename Elt>
__host__ __device__ __forceinline__ size_t slice_bytes(int H) {
  return (sizeof(Elt) * 3 * units(H) * row4(H) + 15) / 16 * 16;
}
template <typename Elt>
size_t smem_bytes(int H) {
  const size_t U = units(H);
  return slice_bytes<Elt>(H) + sizeof(float) * (2 * C * R * U + 3 * U * R);
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

template <typename Elt>
__global__ void __launch_bounds__(kMaxThreads)
gru_sequence_backward_kernel(
    const Elt* __restrict__ gates,  // (T, B, 4H) r | z | n | gh_n
    const Elt* __restrict__ h0,     // (B, H)
    const Elt* __restrict__ whh,    // (3H, H)
    const Elt* __restrict__ ys,     // (T, B, H) forward outputs
    const Elt* __restrict__ dys,    // (T, B, H) output gradients
    const Elt* __restrict__ dhl,    // (B, H) last-hidden gradient
    Elt* __restrict__ dxp,          // (T, B, 3H)
    Elt* __restrict__ dgh,          // (T, B, 3H)
    Elt* __restrict__ dh0,          // (B, H)
    int T, int B, int H, int reverse, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = units(H), W = row4(H), Q = W / 4;
  const int u0 = rank * U, row0 = (blockIdx.x / C) * R;

  extern __shared__ float4 smem4[];
  Elt* ws = reinterpret_cast<Elt*>(smem4);      // [3U][W] w_hh slice
  float* recv = reinterpret_cast<float*>(       // [2][C][U][R] partials
      reinterpret_cast<char*>(smem4) + slice_bytes<Elt>(H));
  float* dgt = recv + 2 * C * R * U;            // [3U][R] step's dgh

  if constexpr (is_f32<Elt>()) {
    for (int g = 0; g < 3; ++g)
      stage(ws + g * U * W, W, whh + ((size_t)g * H + u0) * H, H, U, W,
            H - u0, H, whh, vec);
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < 3 * U * W; i += blockDim.x) {
      const int g = i / (U * W), u = u0 + (i / W) % U, k = i % W;
      ws[i] = u < H && k < H ? whh[((size_t)g * H + u) * H + k]
                             : from_f<Elt>(0.f);
    }
  }

  // this thread's gate item: unit u0 + j and rows grp*RT .. grp*RT + RT-1
  const int grp = threadIdx.x / U, j = threadIdx.x % U, u = u0 + j;
  const bool active = grp < R / RT, unit_ok = active && u < H;
  auto t_of = [&](int s) { return reverse ? s : T - 1 - s; };
  // the item's inputs of step t: the saved gates, dys and h_prev (the
  // output of the step taken before, or h0), zeros for absent rows
  auto fetch = [&](int t, float (&v)[RT][kIn]) {
    const int tp = reverse ? t + 1 : t - 1;
    const Elt* hsrc = (tp >= 0 && tp < T) ? ys + (size_t)tp * B * H : h0;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int b = row0 + grp * RT + i;
      if (unit_ok && b < B) {
        const Elt* g = gates + ((size_t)t * B + b) * 4 * H + u;
        v[i][0] = to_f(g[0]);
        v[i][1] = to_f(g[H]);
        v[i][2] = to_f(g[2 * H]);
        v[i][3] = to_f(g[3 * H]);
        v[i][4] = to_f(dys[((size_t)t * B + b) * H + u]);
        v[i][5] = to_f(hsrc[(size_t)b * H + u]);
      } else {
#pragma unroll
        for (int k = 0; k < kIn; ++k) v[i][k] = 0.f;
      }
    }
  };
  float nxt[RT][kIn], dh[RT];
  fetch(t_of(0), nxt);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int b = row0 + grp * RT + i;
    dh[i] = (unit_ok && b < B) ? to_f(dhl[(size_t)b * H + u]) : 0.f;
  }
  if constexpr (is_f32<Elt>()) cp_async_wait_all();
  // every block's buffers are ready before any peer writes them
  cluster.sync();

  const int n_items = (R / RT) * Q;
  for (int s = 0; s < T; ++s) {
    const int t = t_of(s);
    float cur[RT][kIn];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int k = 0; k < kIn; ++k) cur[i][k] = nxt[i][k];
    if (s + 1 < T) fetch(t_of(s + 1), nxt);

    // the gates' gradients of this item's rows
    float dr[RT], dz[RT], dn[RT], dhz[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      dr[i] = dz[i] = dn[i] = dhz[i] = 0.f;
      const int b = row0 + grp * RT + i;
      if (!unit_ok || b >= B) continue;
      const float rg = cur[i][0], zg = cur[i][1], ng = cur[i][2];
      const float ghn = cur[i][3], hprev = cur[i][5];
      const float d = cur[i][4] + dh[i];
      const float dpn = d * (1.f - zg) * (1.f - ng * ng);
      const float dpr = dpn * ghn * rg * (1.f - rg);
      const float dpz = d * (hprev - ng) * zg * (1.f - zg);
      const size_t o3 = ((size_t)t * B + b) * 3 * H + u;
      dxp[o3] = from_f<Elt>(dpr);
      dxp[o3 + H] = from_f<Elt>(dpz);
      dxp[o3 + 2 * H] = from_f<Elt>(dpn);
      dgh[o3] = from_f<Elt>(dpr);
      dgh[o3 + H] = from_f<Elt>(dpz);
      dgh[o3 + 2 * H] = from_f<Elt>(dpn * rg);
      dr[i] = dpr;
      dz[i] = dpz;
      dn[i] = dpn * rg;
      dhz[i] = d * zg;
    }
    if (active) {
      float* d = dgt + j * R + grp * RT;
      *reinterpret_cast<float4*>(d) = make_float4(dr[0], dr[1], dr[2], dr[3]);
      *reinterpret_cast<float4*>(d + U * R) =
          make_float4(dz[0], dz[1], dz[2], dz[3]);
      *reinterpret_cast<float4*>(d + 2 * U * R) =
          make_float4(dn[0], dn[1], dn[2], dn[3]);
    }
    __syncthreads();  // this block's dgh rows are complete

    // partial dgh @ w_hh over this block's 3U rows for RT rows x 4
    // columns, sent to the blocks that own those units
    float* slot = recv + (s & 1) * C * R * U + rank * R * U;
    for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
      const int pg = it / Q, k0 = 4 * (it % Q);
      float acc[RT][4];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      const float* dcol = dgt + pg * RT;
      const Elt* wcol = ws + k0;
#pragma unroll 4
      for (int m = 0; m < 3 * U; ++m) {
        const float4 dv = *reinterpret_cast<const float4*>(dcol + m * R);
        const float4 wv = ld4(wcol + m * W);
        const float d4[RT] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          acc[i][0] = fmaf(d4[i], wv.x, acc[i][0]);
          acc[i][1] = fmaf(d4[i], wv.y, acc[i][1]);
          acc[i][2] = fmaf(d4[i], wv.z, acc[i][2]);
          acc[i][3] = fmaf(d4[i], wv.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = k0 + c;
        if (k >= H) break;
        float* dst = cluster.map_shared_rank(slot, k / U);
        *reinterpret_cast<float4*>(dst + (k % U) * R + pg * RT) =
            make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
      }
    }
    // publishes the partials; every read of this step's dgh rows is done
    cluster.sync();

    // dh_prev of this item's rows: dh * z plus the C partials in order
    if (unit_ok) {
      const float* got = recv + (s & 1) * C * R * U + j * R + grp * RT;
      float4 p[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        p[c] = *reinterpret_cast<const float4*>(got + c * U * R);
      dh[0] = dhz[0] + p[0].x + p[1].x + p[2].x + p[3].x;
      dh[1] = dhz[1] + p[0].y + p[1].y + p[2].y + p[3].y;
      dh[2] = dhz[2] + p[0].z + p[1].z + p[2].z + p[3].z;
      dh[3] = dhz[3] + p[0].w + p[1].w + p[2].w + p[3].w;
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int b = row0 + grp * RT + i;
    if (unit_ok && b < B) dh0[(size_t)b * H + u] = from_f<Elt>(dh[i]);
  }
}

template <typename Elt>
cudaLaunchConfig_t launch_config(int B, int H, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + R - 1) / R) * C);
  cfg.blockDim = dim3(threads_for(H));
  cfg.dynamicSmemBytes = smem_bytes<Elt>(H);
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
template <typename Elt>
cudaError_t prepare(int B, int H, cudaStream_t stream, int* max_clusters) {
  *max_clusters = 0;
  const size_t smem = smem_bytes<Elt>(H);
  if (smem > kSmemLimit || threads_for(H) > kMaxThreads)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      gru_sequence_backward_kernel<Elt>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<Elt>(B, H, stream, &attr);
  e = cudaOccupancyMaxActiveClusters(max_clusters,
                                     gru_sequence_backward_kernel<Elt>, &cfg);
  if (e != cudaSuccess) return e;
  return *max_clusters > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// the H prepare() last succeeded for, per device (device_slot) and
// storage type (fp32, bf16)
std::mutex prepare_mutex;
struct Checked {
  int H[2] = {-1, -1};
};
Checked checked_on[kMaxDevices];

template <typename Elt>
int launch(const Elt* gates, const Elt* h0, const Elt* whh, const Elt* ys,
           const Elt* dys, const Elt* dhl, Elt* dxp, Elt* dgh, Elt* dh0,
           int T, int B, int H, int reverse, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  {
    const std::lock_guard<std::mutex> lock(prepare_mutex);
    const int dev = device_slot();
    int unknown = -1;
    int& checked = dev < 0 ? unknown : checked_on[dev].H[is_f32<Elt>() ? 0 : 1];
    if (H != checked) {
      int n = 0;
      const cudaError_t e = prepare<Elt>(B, H, st, &n);
      if (e != cudaSuccess) return (int)e;
      checked = H;
    }
  }
  const bool vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(whh) % 16 == 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<Elt>(B, H, st, &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gru_sequence_backward_kernel<Elt>, gates, h0, whh, ys, dys, dhl,
      dxp, dgh, dh0, T, B, H, reverse, (int)vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename Elt>
int shape(int B, int H, long long* out) {
  if (B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  int n = 0;
  cudaError_t e;
  {
    // prepare() sets the kernel's shared-memory attribute for this H: a
    // launch re-prepares for its own H afterwards
    const std::lock_guard<std::mutex> lock(prepare_mutex);
    e = prepare<Elt>(B, H, nullptr, &n);
    const int dev = device_slot();
    if (dev >= 0)
      checked_on[dev].H[is_f32<Elt>() ? 0 : 1] = e == cudaSuccess ? H : -1;
  }
  out[0] = R;
  out[1] = C;
  out[2] = threads_for(H);
  out[3] = (long long)smem_bytes<Elt>(H);
  out[4] = (B + R - 1) / R;
  out[5] = n;
  return (int)e;
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers to
// contiguous arrays (fp32, or bf16 for the _bf16 entry points): the gates
// the forward's training variant saved (T, B, 4H), w_hh in the torch
// layout (3H, H); `stream` is a cudaStream_t. Return a cudaError_t code
// (0 = launched).
extern "C" int g2v_gru_sequence_backward(
    const float* gates, const float* h0, const float* whh, const float* ys,
    const float* dys, const float* dhl, float* dxp, float* dgh, float* dh0,
    int T, int B, int H, int reverse, void* stream) {
  return launch<float>(gates, h0, whh, ys, dys, dhl, dxp, dgh, dh0, T, B, H,
                       reverse, stream);
}

extern "C" int g2v_gru_sequence_backward_bf16(
    const __nv_bfloat16* gates, const __nv_bfloat16* h0,
    const __nv_bfloat16* whh, const __nv_bfloat16* ys,
    const __nv_bfloat16* dys, const __nv_bfloat16* dhl, __nv_bfloat16* dxp,
    __nv_bfloat16* dgh, __nv_bfloat16* dh0, int T, int B, int H,
    int reverse, void* stream) {
  return launch<__nv_bfloat16>(gates, h0, whh, ys, dys, dhl, dxp, dgh, dh0,
                               T, B, H, reverse, stream);
}

// The launch shape for (B, H), so callers can check their mirror of it:
// out = {rows per cluster, blocks per cluster, threads per block, dynamic
// shared bytes, clusters in the grid, clusters the card holds at once}.
extern "C" int g2v_gru_sequence_backward_shape(int B, int H,
                                               long long* out) {
  return shape<float>(B, H, out);
}

extern "C" int g2v_gru_sequence_backward_shape_bf16(int B, int H,
                                                    long long* out) {
  return shape<__nv_bfloat16>(B, H, out);
}
