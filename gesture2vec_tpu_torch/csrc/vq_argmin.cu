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
// it is bound by operations. TF32 mma is ruled out: token identity and
// K-Means labels depend on the exact argmin.
//
// Design (classic SGEMM tiling with the argmin as the epilogue):
//  - one block per tile of BM=64 rows; the codebook streams through
//    shared memory in tiles of BN=64 codes, and D in slices of BK=16;
//    both slices are stored k-major with one float of padding, so the
//    transposing stores and the compute loads are free of bank conflicts;
//  - 256 threads; each owns a 4x4 register micro-tile of dot products,
//    rows ty + 16i and codes tx + 16j, so a warp's loads of a slice are
//    broadcasts (rows) or consecutive (codes);
//  - after each code tile a thread folds its 4x4 distances into a running
//    (min, argmin) per row, visiting its codes in ascending order with a
//    strict <; the 16 threads of a row then reduce by warp shuffles,
//    the lower index winning on equal values: jnp.argmin's first-index
//    rule;
//  - ragged rows (N not a multiple of 64) and a ragged last code tile
//    are masked here: nothing is padded.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kThreads = 256;  // (BM / TM) * (BN / TN)

__global__ void __launch_bounds__(kThreads)
vq_argmin_kernel(const float* __restrict__ x,   // (N, D)
                 const float* __restrict__ cb,  // (K, D)
                 const float* __restrict__ e2,  // (K)
                 long long* __restrict__ idx,   // (N)
                 float* __restrict__ dmin,      // (N)
                 int N, int K, int D) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  __shared__ float x2s[BM];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BM;

  {  // |x|^2 of the block's rows: 4 neighbouring lanes per row
    const int r = tid / 4, part = tid % 4, b = row0 + r;
    float s = 0.f;
    if (b < N)
      for (int k = part; k < D; k += 4) {
        const float v = __ldg(x + (size_t)b * D + k);
        s = fmaf(v, v, s);
      }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) x2s[r] = s;
  }

  float best[TM];
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = __int_as_float(0x7f800000);  // +inf
    best_i[i] = INT_MAX;
  }

  for (int c0 = 0; c0 < K; c0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += BK) {
      // each slice is 64 x 16 floats: 4 per thread; 16 neighbouring
      // threads read 64 contiguous bytes of one row
#pragma unroll
      for (int l = 0; l < (BM * BK) / kThreads; ++l) {
        const int e = tid + l * kThreads;
        const int r = e / BK, kk = e % BK, k = k0 + kk;
        const int b = row0 + r, c = c0 + r;
        As[kk][r] = (b < N && k < D) ? __ldg(x + (size_t)b * D + k) : 0.f;
        Bs[kk][r] = (c < K && k < D) ? __ldg(cb + (size_t)c * D + k) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float xx = x2s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {  // codes ascending within the thread
        const int c = c0 + tx + 16 * j;
        if (c < K) {
          const float d = (xx + __ldg(e2 + c)) - 2.f * acc[i][j];
          if (d < best[i]) {
            best[i] = d;
            best_i[i] = c;
          }
        }
      }
    }
  }

  // the 16 threads of a row are lanes (ty % 2) * 16 + 0..15 of one warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float d = best[i];
    int c = best_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int oc = __shfl_xor_sync(0xffffffffu, c, off);
      if (od < d || (od == d && oc < c)) {
        d = od;
        c = oc;
      }
    }
    const int b = row0 + ty + 16 * i;
    if (tx == 0 && b < N) {
      idx[b] = c;
      dmin[b] = d;
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers to
// contiguous arrays (fp32; idx int64); `stream` is a cudaStream_t.
// Returns a cudaError_t code (0 = launched).
extern "C" int g2v_vq_argmin(const float* x, const float* cb, const float* e2,
                             long long* idx, float* dmin, int N, int K, int D,
                             void* stream) {
  if (N <= 0 || K <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BM - 1) / BM);
  vq_argmin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, cb, e2, idx, dmin, N, K, D);
  return (int)cudaGetLastError();
}
