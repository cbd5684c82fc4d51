// Single-layer GRU recurrence over a whole sequence for Hopper (sm_90a),
// fp32 on the CUDA cores, one thread-block cluster per tile of batch rows.
//
// Replaces the TPU kernel gesture2vec_tpu/ops/gru_pallas.py
// (gru_sequence_fused -> _gru_seq_kernel). The input projections are
// hoisted out of the recurrence by the caller (x_proj = xs @ w_ih^T + b_ih,
// one large matmul); one launch then runs all T steps of
//   gh = h @ w_hh^T + b_hh                          (gate order r, z, n)
//   r  = sigmoid(xp_r + gh_r),  z = sigmoid(xp_z + gh_z)
//   n  = tanh(xp_n + r * gh_n), h' = (1 - z) * n + z * h  -> ys[t]
// walking t = 0..T-1, or T-1..0 with `reverse` (lax.scan(reverse=True):
// outputs stay at their time positions, h_last is the state after the
// last step taken).
//
// Bound at the tokenizer's width (T=20, B=512, H=200): the recurrent
// products are 2*T*B*H*3H = 2.46 GFLOP, 0.037 ms at the card's 67 TFLOP/s
// fp32 (non-tensor-core) peak; the bytes (x_proj, h0, w_hh, outputs,
// 34 MB) take 0.010 ms at 3.35 TB/s. So it is bound by operations. TF32
// mma is ruled out: the encoder's final hidden is the token's input.
//
// Design. The TPU kernel keeps w_hh (480 KB at H=200) in VMEM; one SM has
// 227 KB, so the weights are split across a thread-block cluster of C=4
// blocks:
//  - a cluster owns R=20 batch rows; block `rank` owns the hidden units
//    [rank*U, rank*U + U), U = ceil(H/C), and keeps its r, z, n rows of
//    w_hh (3U x H, staged once by cp.async from the torch layout (3H, H))
//    and its b_hh slice in shared memory for the whole launch: inside the
//    step loop no weight is read from global memory;
//  - every block holds the tile's full state h (R x H), double-buffered;
//    after a step a block writes its U new units into the next-state
//    buffer of every block of the cluster through distributed shared
//    memory, and one cluster barrier per step publishes them (reads of
//    the old buffer are finished by then, so two buffers suffice);
//  - each thread prefetches the x_proj values its gates read for the
//    next step with cp.async into its own slots; x_proj is read once;
//  - the dot products are spread over the whole block: a thread owns an
//    item (RT=4 rows x 1 unit x 3 gates), walks k in order as float4
//    reads and finishes its rows' gates in registers; rows are padded to
//    an odd number of float4s, so the units a warp reads fall in distinct
//    banks. Summing k in order keeps results independent of the tile;
//  - R=20 keeps the launch in one wave: the H100 holds 30 clusters of
//    these blocks at once (cudaOccupancyMaxActiveClusters), B=512 needs 26;
//  - ragged batches are masked: rows past B start from zeros, read no
//    input and are never written.
// What holds it back now: a step costs about 8.6 us at B=512 (PERF.md),
// and tiles of 16 to 32 rows per cluster were no faster a step, so the
// latency of a step's dependent chain (dot products, gate math, remote
// stores, cluster barrier) rather than FMA throughput sets the pace.
//
// Training variant (g2v_gru_sequence_gates): the same kernel with
// kGates set also writes, for its own units and rows, the step's gates
// r, z, n and gh_n = (h @ w_hh^T + b_hh)_n into gates (T, B, 4H), so that
// the backward (csrc/gru_sequence_backward.cu) needs no recompute. The
// values are the ones the step computes anyway; the stores are the only
// new work (4*T*B*H values), and ys comes out bit-identical to the
// inference launch's (same products, same order of sums).
//
// bf16 instantiation (g2v_gru_sequence_bf16, g2v_gru_sequence_gates_bf16;
// the JAX package's compute_dtype: bfloat16, whose gru_layer casts x_proj,
// h0, w_hh and b_hh to bf16 and carries h in bf16 through its lax.scan):
// the same kernel, templated on the storage type T of x_proj, h0, w_hh,
// b_hh, ys, h_last and the gates. Products and gate math stay fp32 on the
// CUDA cores; a step's new h is rounded to bf16 (__float2bfloat16_rn)
// before it is stored, published and carried, so the carry is JAX's bf16
// carry; nothing else inside a step is rounded. The w_hh slice sits in
// shared memory as bf16 (half the bytes: four weights are one 8-byte read,
// rows padded as in fp32, so a warp's reads still fall in distinct
// banks); the state tiles stay fp32 holding bf16 values. x_proj cannot go
// through cp.async (its smallest copy is 4 bytes, a value 2), so each
// thread loads its item's 3*RT values of a step into registers at the
// top of the step, ahead of the product. Bound at T=20, B=128, H=200: the
// bf16 bytes 4.4 MB (0.0013 ms at 3.35 TB/s) against the products' 0.61
// GFLOP at the card's 989 TFLOP/s bf16 tensor-core peak (0.00062 ms):
// bound by bytes (8.5 MB, 0.0026 ms, with the gates). The products run on
// the CUDA cores (0.0092 ms at 67 TFLOP/s fp32), so the bound is out of
// reach until they move to the tensor cores. Staging is a plain copy
// loop, once per launch.
//
// Eligibility: the block's shared memory (smem_bytes: fp32 4 * (3*U*HP +
// 2*R*HP + 2*R*3U + 3U) bytes with HP the padded row; bf16 the slice at 2
// bytes a weight rounded up to 16 bytes, plus 4 * (2*R*HP + 3U)) must
// fit 232,448 B: fp32 H <= 232, bf16 H <= 340 (gru_kernel.launch_shape
// mirrors both). A block then has at most ceil(H/4) * R/RT items, one a
// thread, within the 512 of the launch bound.
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
constexpr int kMaxThreads = 512;  // the launch bound; H <= 340 takes <= 448
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
// one thread per item (a unit and RT rows)
int threads_for(int H) { return (units(H) * (R / RT) + 31) / 32 * 32; }
// bytes of the block's w_hh slice, rounded up to 16 so the fp32 tiles
// after it stay float4-aligned
template <typename Elt>
__host__ __device__ __forceinline__ size_t slice_bytes(int H) {
  return (sizeof(Elt) * 3 * units(H) * padded(H) + 15) / 16 * 16;
}
template <typename Elt>
size_t smem_bytes(int H) {
  const size_t U = units(H), HP = padded(H);
  // fp32 prefetches x_proj into shared slots; bf16 into registers
  const size_t slots = is_f32<Elt>() ? 2 * R * 3 * U : 0;
  return slice_bytes<Elt>(H) + sizeof(float) * (2 * R * HP + slots + 3 * U);
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

template <typename Elt, bool kGates>
__global__ void __launch_bounds__(kMaxThreads)
gru_sequence_kernel(const Elt* __restrict__ xp,   // (T, B, 3H)
                    const Elt* __restrict__ h0,   // (B, H)
                    const Elt* __restrict__ whh,  // (3H, H)
                    const Elt* __restrict__ bhh,  // (3H)
                    Elt* __restrict__ ys,         // (T, B, H)
                    Elt* __restrict__ hlast,      // (B, H)
                    Elt* __restrict__ gates,      // (T, B, 4H) if kGates
                    int T, int B, int H, int reverse, int vec) {
  constexpr bool kF32 = is_f32<Elt>();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = units(H), HP = padded(H), q4 = (H + 3) / 4;
  const int u0 = rank * U, row0 = (blockIdx.x / C) * R;

  extern __shared__ float4 smem4[];
  Elt* ws = reinterpret_cast<Elt*>(smem4);      // [3][U][HP] w_hh slice
  float* hc = reinterpret_cast<float*>(         // [R][HP] current state
      reinterpret_cast<char*>(smem4) + slice_bytes<Elt>(H));
  float* hn = hc + R * HP;                      // [R][HP] next state
  float* xb = hn + R * HP;                      // fp32: [2][R][3][U] x_proj
  float* bs = xb + (kF32 ? 2 * R * 3 * U : 0);  // [3][U] b_hh slice

  if constexpr (kF32) {
    for (int g = 0; g < 3; ++g)
      stage(ws + g * U * HP, HP, whh + ((size_t)g * H + u0) * H, H, U, HP,
            H - u0, H, whh, vec);
    stage(hc, HP, h0 + (size_t)row0 * H, H, R, HP, B - row0, H, h0, vec);
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < 3 * U * HP; i += blockDim.x) {
      const int g = i / (U * HP), u = u0 + (i / HP) % U, k = i % HP;
      ws[i] = u < H && k < H ? whh[((size_t)g * H + u) * H + k]
                             : from_f<Elt>(0.f);
    }
    for (int i = threadIdx.x; i < R * HP; i += blockDim.x) {
      const int b = row0 + i / HP, k = i % HP;
      hc[i] = b < B && k < H ? to_f(h0[(size_t)b * H + k]) : 0.f;
    }
  }
  for (int i = threadIdx.x; i < R * HP; i += blockDim.x) hn[i] = 0.f;
  for (int i = threadIdx.x; i < 3 * U; i += blockDim.x) {
    const int g = i / U, u = u0 + i % U;
    bs[i] = u < H ? to_f(bhh[g * H + u]) : 0.f;
  }

  // this thread's item: unit u0 + j and rows grp*RT .. grp*RT + RT-1
  const int grp = threadIdx.x / U, j = threadIdx.x % U, u = u0 + j;
  const bool active = grp < R / RT, unit_ok = active && u < H;
  // fp32: the x_proj values this thread's gates read, into its own slots
  auto prefetch = [&](int t, int buf) {
    if constexpr (kF32) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = grp * RT + i, b = row0 + r;
        if (unit_ok && b < B)
#pragma unroll
          for (int g = 0; g < 3; ++g)
            cp_async4(xb + buf * R * 3 * U + (r * 3 + g) * U + j,
                      xp + ((size_t)t * B + b) * 3 * H + g * H + u, 4);
      }
    }
  };
  prefetch(reverse ? T - 1 : 0, 0);
  if constexpr (kF32) {
    cp_async_commit();
    cp_async_wait<1>();  // the weights and h0 have landed
  }
  // every block's buffers are ready before any peer writes them
  cluster.sync();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    // this step's x_proj values of the item: fp32 in the slots prefetched
    // a step ahead, bf16 loaded into registers here, ahead of the product
    const float* xcur = xb + (s & 1) * R * 3 * U;
    float xv[RT][3];
    if constexpr (kF32) {
      if (s + 1 < T) prefetch(reverse ? t - 1 : t + 1, (s + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();  // this step's x_proj slots have landed
    } else {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int b = row0 + grp * RT + i;
#pragma unroll
        for (int g = 0; g < 3; ++g)
          xv[i][g] = unit_ok && b < B
                         ? to_f(xp[((size_t)t * B + b) * 3 * H + g * H + u])
                         : 0.f;
      }
    }

    float acc[RT][3];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.f;
    if (active) {
      const Elt* wr = ws + j * HP;
      const float* hr = hc + grp * RT * HP;
#pragma unroll 2
      for (int q = 0; q < q4; ++q) {
        float4 w[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) w[g] = ld4(wr + g * U * HP + 4 * q);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float4 h = ld4(hr + i * HP + 4 * q);
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

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = grp * RT + i, b = row0 + r;
      if (!unit_ok || b >= B) continue;
      float x[3];
#pragma unroll
      for (int g = 0; g < 3; ++g)
        x[g] = kF32 ? xcur[r * 3 * U + g * U + j] : xv[i][g];
      const float ghn = acc[i][2] + bs[2 * U + j];
      const float rg = sigmoid_f(x[0] + (acc[i][0] + bs[j]));
      const float zg = sigmoid_f(x[1] + (acc[i][1] + bs[U + j]));
      const float ng = tanhf(x[2] + rg * ghn);
      // the carry in the storage type (bf16: JAX's bf16 scan carry)
      const float h = round_to<Elt>((1.f - zg) * ng + zg * hc[r * HP + u]);
#pragma unroll
      for (int c = 0; c < C; ++c)
        cluster.map_shared_rank(hn, c)[r * HP + u] = h;
      ys[((size_t)t * B + b) * H + u] = from_f<Elt>(h);
      if (kGates) {
        Elt* gt = gates + ((size_t)t * B + b) * 4 * H + u;
        gt[0] = from_f<Elt>(rg);
        gt[H] = from_f<Elt>(zg);
        gt[2 * H] = from_f<Elt>(ng);
        gt[3 * H] = from_f<Elt>(ghn);
      }
    }
    // publishes the new state; after it the old buffer is free again
    cluster.sync();
    float* tmp = hc; hc = hn; hn = tmp;
  }
  if constexpr (kF32) cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = grp * RT + i, b = row0 + r;
    if (unit_ok && b < B)
      hlast[(size_t)b * H + u] = from_f<Elt>(hc[r * HP + u]);
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
template <typename Elt, bool kGates>
cudaError_t prepare(int B, int H, cudaStream_t stream, int* max_clusters) {
  *max_clusters = 0;
  const size_t smem = smem_bytes<Elt>(H);
  if (smem > kSmemLimit || threads_for(H) > kMaxThreads)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      gru_sequence_kernel<Elt, kGates>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<Elt>(B, H, stream, &attr);
  e = cudaOccupancyMaxActiveClusters(max_clusters,
                                     gru_sequence_kernel<Elt, kGates>, &cfg);
  if (e != cudaSuccess) return e;
  return *max_clusters > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// the H prepare() last succeeded for, per device (device_slot), storage
// type and variant, under prepare_mutex: a server's threads launch
// concurrently
std::mutex prepare_mutex;
struct Checked {
  int H[2][2] = {{-1, -1}, {-1, -1}};
};
Checked checked_on[kMaxDevices];

template <typename Elt>
__host__ __device__ constexpr int type_index() { return is_f32<Elt>() ? 0 : 1; }

template <typename Elt, bool kGates>
int launch(const Elt* xp, const Elt* h0, const Elt* whh, const Elt* bhh,
           Elt* ys, Elt* hlast, Elt* gates, int T, int B, int H,
           int reverse, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  {
    const std::lock_guard<std::mutex> lock(prepare_mutex);
    const int dev = device_slot();
    int unknown = -1;
    int& checked =
        dev < 0 ? unknown : checked_on[dev].H[type_index<Elt>()][kGates];
    if (H != checked) {
      int n = 0;
      const cudaError_t e = prepare<Elt, kGates>(B, H, st, &n);
      if (e != cudaSuccess) return (int)e;
      checked = H;
    }
  }
  const bool vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(whh) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h0) % 16 == 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<Elt>(B, H, st, &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gru_sequence_kernel<Elt, kGates>, xp, h0, whh, bhh, ys, hlast,
      gates, T, B, H, reverse, (int)vec);
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
    e = prepare<Elt, false>(B, H, nullptr, &n);
    const int dev = device_slot();
    if (dev >= 0)
      checked_on[dev].H[type_index<Elt>()][0] = e == cudaSuccess ? H : -1;
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
// contiguous arrays (fp32, or bf16 for the _bf16 entry points), w_hh in
// the torch layout (3H, H); `stream` is a cudaStream_t. Return a
// cudaError_t code (0 = launched).
extern "C" int g2v_gru_sequence(const float* xp, const float* h0,
                                const float* whh, const float* bhh,
                                float* ys, float* hlast, int T, int B, int H,
                                int reverse, void* stream) {
  return launch<float, false>(xp, h0, whh, bhh, ys, hlast, nullptr, T, B, H,
                              reverse, stream);
}

// The training variant: also writes the gates (T, B, 4H), r | z | n | gh_n.
extern "C" int g2v_gru_sequence_gates(const float* xp, const float* h0,
                                      const float* whh, const float* bhh,
                                      float* ys, float* hlast, float* gates,
                                      int T, int B, int H, int reverse,
                                      void* stream) {
  return launch<float, true>(xp, h0, whh, bhh, ys, hlast, gates, T, B, H,
                             reverse, stream);
}

extern "C" int g2v_gru_sequence_bf16(
    const __nv_bfloat16* xp, const __nv_bfloat16* h0,
    const __nv_bfloat16* whh, const __nv_bfloat16* bhh, __nv_bfloat16* ys,
    __nv_bfloat16* hlast, int T, int B, int H, int reverse, void* stream) {
  return launch<__nv_bfloat16, false>(xp, h0, whh, bhh, ys, hlast, nullptr,
                                      T, B, H, reverse, stream);
}

extern "C" int g2v_gru_sequence_gates_bf16(
    const __nv_bfloat16* xp, const __nv_bfloat16* h0,
    const __nv_bfloat16* whh, const __nv_bfloat16* bhh, __nv_bfloat16* ys,
    __nv_bfloat16* hlast, __nv_bfloat16* gates, int T, int B, int H,
    int reverse, void* stream) {
  return launch<__nv_bfloat16, true>(xp, h0, whh, bhh, ys, hlast, gates, T,
                                     B, H, reverse, stream);
}

// The launch shape for (B, H), so callers can check their mirror of it:
// out = {rows per cluster, blocks per cluster, threads per block, dynamic
// shared bytes, clusters in the grid, clusters the card holds at once}.
extern "C" int g2v_gru_sequence_shape(int B, int H, long long* out) {
  return shape<float>(B, H, out);
}

extern "C" int g2v_gru_sequence_shape_bf16(int B, int H, long long* out) {
  return shape<__nv_bfloat16>(B, H, out);
}
