// Fused nearest-code search for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernel gesture2vec_tpu/ops/vq_pallas.py
// (_vq_argmin_padded / vq_argmin -> _vq_kernel). For every row x of
// (N, D) and codebook e of (K, D) it computes
//   d[k] = (|x|^2 + |e_k|^2) - 2 x.e_k                (fp32)
// and returns argmin_k d (first index on ties, like jnp.argmin) and
// min_k d, without ever writing the (N, K) distance matrix. |e|^2 is
// precomputed by the wrapper, as the TPU wrapper does.
//
// Bound at K-Means' width (N=58,488, K=300, D=400): 2*N*K*D = 14.0 GFLOP,
// 0.21 ms at the card's 67 TFLOP/s fp32 (non-tensor-core) peak; the
// bytes (x, codebook, outputs, 94.5 MB) take 0.028 ms at 3.35 TB/s. So
// it is bound by operations, and the design is about keeping the FMA
// pipe fed. TF32 mma is ruled out: token identity and K-Means labels
// depend on the exact argmin.
//
// Design (register-tiled SGEMM with the argmin as the epilogue):
//  - one block per BM rows of x (BM = 128, 64 or 32, chosen by the
//    wrapper); the rows are staged into shared memory once, with 16-byte
//    cp.async, and |x|^2 is computed from that copy, so x is read from
//    device memory exactly once;
//  - the codebook streams through a ring of STAGES=2 shared-memory slices
//    of BN=64 codes x BK=32 dims, filled by cp.async while the previous
//    slice is multiplied; a block walks code tiles x D slices as one
//    sequence, so the ring runs across code-tile boundaries; the
//    codebook (480-800 KB) stays in L2 across blocks;
//  - 2*BM threads, each owning an 8x4 register micro-tile (rows
//    ty + (BM/8)*i, codes tx + 16*j), read as float4 along D and double-
//    buffered in registers: 12 shared loads per 128 FMAs; code rows are
//    padded to an odd number of float4s, so a warp's 16 code reads are
//    free of bank conflicts, and its row reads are broadcasts of 2 rows;
//  - after each code tile a thread folds its distances into a running
//    (min, argmin) per row, visiting its codes in ascending order with a
//    strict <; the 16 threads of a row then reduce by warp shuffles, the
//    lower index winning on equal values: jnp.argmin's first-index rule;
//  - ragged rows, ragged codes and D not a multiple of BK are masked by
//    cp.async's zero fill: nothing is padded in device memory; the last
//    slice of a row stops at D's float4, so a row never reads its
//    neighbour's values;
//  - the sums over D run in order and |x|^2 in a fixed order, so indices
//    and minima are bitwise the same at every block height.
// What holds it back now: on the H100 it issues FMAs at about 40 % of the
// fp32 peak whatever the block height, warp count or micro-tile tried
// (PERF.md); with the rows resident a block holds at most 128 rows
// beside the ring, so its tile is at most 128 x 64 outputs and 8 warps,
// where the library's SIMT GEMMs run larger tiles per thread. At small N
// (the residual-VQ sweep's <= 512 rows) too few blocks fill the card.
//
// Eligibility: 4 * (BM*LDX + STAGES*BN*(BK+4) + BM) bytes of shared
// memory, LDX = D rounded up to 4 (see x_stride), must fit 232,448 B at
// BM=32: D <= 1,668 (vq_kernel.launch_shape mirrors this formula and the
// choice of BM).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64, BK = 32, STAGES = 2;
constexpr int TM = 8, TN = 4, NTX = BN / TN;  // 16 across codes
constexpr int BKP = BK + 4;  // an odd number of float4s per code
constexpr int kSmemLimit = 232448;

// row stride of the staged x in floats: D rounded up to 4, avoiding a
// multiple of 32, so the 2 rows a warp reads at once fall in distinct
// banks
__host__ __device__ __forceinline__ int x_stride(int D) {
  const int q = (D + 3) / 4;
  return 4 * (q % 8 ? q : q + 1);
}
size_t smem_bytes(int BM, int D) {
  return sizeof(float) * ((size_t)BM * x_stride(D) +
                          (size_t)STAGES * BN * BKP + BM);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// copies rows x width floats of a (., D) array at `src` into `dst` (row
// stride ld), zero-filling rows >= valid_rows and columns >= valid_cols;
// 16-byte copies when `vec` (D % 4 == 0 and aligned pointers)
template <int NT>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int D, int rows, int width,
                                      int valid_rows, int valid_cols,
                                      bool vec) {
  const int step = vec ? 4 : 1, per_row = width / step;
  for (int i = threadIdx.x; i < rows * per_row; i += NT) {
    const int r = i / per_row, k = (i % per_row) * step;
    const bool ok = r < valid_rows && k < valid_cols;
    const float* from = ok ? src + (size_t)r * D + k : src;
    if (vec)
      cp_async16(dst + r * ld + k, from, ok ? 16 : 0);
    else
      cp_async4(dst + r * ld + k, from, ok ? 4 : 0);
  }
}

// acc[i][j] += a[i] . b[j] over one float4 of dims, in order
__device__ __forceinline__ void fma_tile(const float4 (&a)[TM],
                                         const float4 (&b)[TN],
                                         float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
      acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
      acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
      acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
    }
}

template <int BM>
__global__ void __launch_bounds__(BM / TM * NTX)
vq_argmin_kernel(const float* __restrict__ x,   // (N, D)
                 const float* __restrict__ cb,  // (K, D)
                 const float* __restrict__ e2,  // (K)
                 long long* __restrict__ idx,   // (N)
                 float* __restrict__ dmin,      // (N)
                 int N, int K, int D, int vec) {
  constexpr int NT = BM / TM * NTX, NTY = BM / TM;
  extern __shared__ float4 smem4[];
  const int LDX = x_stride(D);
  float* xs = reinterpret_cast<float*>(smem4);  // [BM][LDX] rows of x
  float* ring = xs + BM * LDX;                  // [STAGES][BN][BKP] codes
  float* x2s = ring + STAGES * BN * BKP;        // [BM] |x|^2
  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  const int row0 = blockIdx.x * BM;
  const int nks = (D + BK - 1) / BK, n_slices = ((K + BN - 1) / BN) * nks;

  // the rows of x, zero-filled past N and from D to the stride
  stage<NT>(xs, LDX, x + (size_t)row0 * D, D, BM, LDX, N - row0, D, vec);
  auto load_slice = [&](int s) {
    const int c0 = (s / nks) * BN, k0 = (s % nks) * BK;
    stage<NT>(ring + (s % STAGES) * BN * BKP, BKP, cb + (size_t)c0 * D + k0,
              D, BN, BK, K - c0, D - k0, vec);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slices) load_slice(s);
    cp_async_commit();  // the first group also carries the rows of x
  }

  float best[TM], acc[TM][TN];
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = __int_as_float(0x7f800000);  // +inf
    best_i[i] = INT_MAX;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  for (int s = 0; s < n_slices; ++s) {
    if (s + STAGES - 1 < n_slices) load_slice(s + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // slice s (and the rows of x) landed
    __syncthreads();
    if (s == 0) {
      // |x|^2 from the staged rows: 4 neighbouring lanes a row, each over
      // every 4th dim, then two shuffles: an order of sums that does not
      // depend on BM, like the dot products' (dims in order), so indices
      // and minima are bitwise the same at every block height
      for (int r0 = 0; r0 < BM; r0 += NT / 4) {
        const int r = r0 + tid / 4;
        float q = 0.f;
        if (r < BM)
          for (int k = tid % 4; k < D; k += 4)
            q = fmaf(xs[r * LDX + k], xs[r * LDX + k], q);
        q += __shfl_xor_sync(0xffffffffu, q, 1);
        q += __shfl_xor_sync(0xffffffffu, q, 2);
        if (r < BM && tid % 4 == 0) x2s[r] = q;
      }
      __syncthreads();
    }
    const float* cs = ring + (s % STAGES) * BN * BKP + tx * BKP;
    const int k0 = (s % nks) * BK;
    const float* xk = xs + ty * LDX + k0;
    if (k0 + BK <= D) {
      // register double buffer: the next float4 of every row and code is
      // loaded while the current one is multiplied
      float4 a[2][TM], b[2][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[0][i] = *reinterpret_cast<const float4*>(xk + NTY * i * LDX);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[0][j] = *reinterpret_cast<const float4*>(cs + NTX * j * BKP);
#pragma unroll
      for (int kq = 0; kq < BK / 4; ++kq) {
        const int cur = kq % 2, nxt = cur ^ 1;
        if (kq + 1 < BK / 4) {
#pragma unroll
          for (int i = 0; i < TM; ++i)
            a[nxt][i] = *reinterpret_cast<const float4*>(
                xk + NTY * i * LDX + 4 * (kq + 1));
#pragma unroll
          for (int j = 0; j < TN; ++j)
            b[nxt][j] = *reinterpret_cast<const float4*>(
                cs + NTX * j * BKP + 4 * (kq + 1));
        }
        fma_tile(a[cur], b[cur], acc);
      }
    } else {
      // the last slice of a row, D not a multiple of BK: it stops at D's
      // float4, inside the row's stride, so it never reads the next row
      for (int kq = 0; kq < (D - k0 + 3) / 4; ++kq) {
        float4 a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[i] = *reinterpret_cast<const float4*>(xk + NTY * i * LDX + 4 * kq);
#pragma unroll
        for (int j = 0; j < TN; ++j)
          b[j] = *reinterpret_cast<const float4*>(cs + NTX * j * BKP + 4 * kq);
        fma_tile(a, b, acc);
      }
    }
    if (s % nks == nks - 1) {  // a code tile is complete: fold it
      const int c0 = (s / nks) * BN;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float xx = x2s[ty + NTY * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) {  // codes ascending within the thread
          const int c = c0 + tx + NTX * j;
          if (c < K) {
            const float d = (xx + __ldg(e2 + c)) - 2.f * acc[i][j];
            if (d < best[i]) {
              best[i] = d;
              best_i[i] = c;
            }
          }
          acc[i][j] = 0.f;
        }
      }
    }
    __syncthreads();  // the slice's stage is refilled next
  }
  cp_async_wait<0>();

  // the 16 threads of a row are lanes (ty % 2) * 16 + 0..15 of one warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float d = best[i];
    int c = best_i[i];
#pragma unroll
    for (int off = NTX / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int oc = __shfl_xor_sync(0xffffffffu, c, off);
      if (od < d || (od == d && oc < c)) {
        d = od;
        c = oc;
      }
    }
    const int b = row0 + ty + NTY * i;
    if (tx == 0 && b < N) {
      idx[b] = c;
      dmin[b] = d;
    }
  }
}

template <int BM>
cudaError_t prepare(int D) {
  const size_t smem = smem_bytes(BM, D);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(vq_argmin_kernel<BM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int BM>
int launch(const float* x, const float* cb, const float* e2, long long* idx,
           float* dmin, int N, int K, int D, cudaStream_t stream) {
  const cudaError_t e = prepare<BM>(D);
  if (e != cudaSuccess) return (int)e;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cb) % 16 == 0;
  vq_argmin_kernel<BM><<<(N + BM - 1) / BM, BM / TM * NTX,
                         smem_bytes(BM, D), stream>>>(x, cb, e2, idx, dmin,
                                                      N, K, D, vec);
  return (int)cudaGetLastError();
}

template <int BM>
int blocks_per_sm(int D, int* n) {
  *n = 0;
  const cudaError_t e = prepare<BM>(D);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, vq_argmin_kernel<BM>, BM / TM * NTX, smem_bytes(BM, D));
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers to
// contiguous arrays (fp32; idx int64); `block_rows` is BM (128, 64 or
// 32); `stream` is a cudaStream_t. Returns a cudaError_t code (0 =
// launched).
extern "C" int g2v_vq_argmin(const float* x, const float* cb, const float* e2,
                             long long* idx, float* dmin, int N, int K, int D,
                             int block_rows, void* stream) {
  if (N <= 0 || K <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block_rows) {
    case 128: return launch<128>(x, cb, e2, idx, dmin, N, K, D, st);
    case 64: return launch<64>(x, cb, e2, idx, dmin, N, K, D, st);
    case 32: return launch<32>(x, cb, e2, idx, dmin, N, K, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch shape for (N, D, BM), so callers can check their mirror of
// it: out = {threads per block, dynamic shared bytes, blocks, blocks an
// SM holds at once}. Returns a cudaError_t code.
extern "C" int g2v_vq_argmin_shape(int N, int D, int block_rows,
                                   long long* out) {
  int n = 0, e = (int)cudaErrorInvalidValue;
  switch (block_rows) {
    case 128: e = blocks_per_sm<128>(D, &n); break;
    case 64: e = blocks_per_sm<64>(D, &n); break;
    case 32: e = blocks_per_sm<32>(D, &n); break;
  }
  out[0] = block_rows / TM * NTX;
  out[1] = (long long)smem_bytes(block_rows, D);
  out[2] = (N + block_rows - 1) / block_rows;
  out[3] = n;
  return e;
}
