// Single-layer GRU recurrence over a whole sequence for Hopper (sm_90a),
// fp32 on the CUDA cores.
//
// Replaces the TPU kernel gesture2vec_tpu/ops/gru_pallas.py
// (gru_sequence_fused -> _gru_seq_kernel). The input projections are
// hoisted out of the recurrence by the caller (x_proj = xs @ w_ih^T + b_ih,
// one large matmul); one launch then runs all T steps of
//   gh = h @ w_hh^T + b_hh                          (gate order r, z, n)
//   r  = sigmoid(xp_r + gh_r),  z = sigmoid(xp_z + gh_z)
//   n  = tanh(xp_n + r * gh_n), h' = (1 - z) * n + z * h  -> ys[t]
// walking t = 0..T-1, or T-1..0 with `reverse` (lax.scan(reverse=True):
// outputs stay at their time positions, h_last is the state after t = 0).
//
// Bound at the tokenizer's width (T=20, B=512, H=200): the recurrent
// products are 2*T*B*H*3H = 2.46 GFLOP, 0.037 ms at the card's 67 TFLOP/s
// fp32 (non-tensor-core) peak; the bytes (x_proj, h0, w_hh, outputs,
// 34 MB) take 0.010 ms at 3.35 TB/s. So it is bound by operations. TF32
// mma is ruled out: the encoder's final hidden is the token's input.
//
// Design (the chunk decoder's layout):
//  - one block per tile of R batch rows; the tile's hidden state lives in
//    shared memory, stored transposed ([k][R]) so a thread reads all R
//    rows of one k with R/4 broadcast float4 loads, and double-buffered,
//    since other threads still read the old state while the new one is
//    written;
//  - one thread per hidden unit u: it accumulates the r, z and n
//    recurrent pre-activations of u for all R rows in registers, so the
//    gates need no shared-memory buffers;
//  - w_hh comes transposed (H, 3H) so neighbouring threads read
//    neighbouring columns; at 480 KB it does not fit one SM's shared
//    memory, and is streamed from L2, where it stays resident; each
//    weight read serves the tile's R rows;
//  - ragged batches are masked here: rows past B start from zeros, read
//    no input and are never written.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
// batch rows per block; 8 beat 4 by about 8% at B = 512 on the H100
// (PERF.md), although 4 gives twice the blocks
constexpr int R = 8;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kMaxThreads)
gru_sequence_kernel(const float* __restrict__ xp,    // (T, B, 3H)
                    const float* __restrict__ h0,    // (B, H)
                    const float* __restrict__ whhT,  // (H, 3H)
                    const float* __restrict__ bhh,   // (3H)
                    float* __restrict__ ys,          // (T, B, H)
                    float* __restrict__ hlast,       // (B, H)
                    int T, int B, int H, int reverse) {
  extern __shared__ float4 smem4[];
  float* hc = reinterpret_cast<float*>(smem4);  // H x R, current state
  float* hn = hc + H * R;                       // H x R, next state
  const int H3 = 3 * H;
  const int row0 = blockIdx.x * R;

  for (int i = threadIdx.x; i < H * R; i += blockDim.x) {
    const int k = i / R, b = row0 + i % R;
    hc[i] = b < B ? h0[(size_t)b * H + k] : 0.f;
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    for (int u = threadIdx.x; u < H; u += blockDim.x) {
      float a_r[R], a_z[R], a_n[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a_r[r] = a_z[r] = a_n[r] = 0.f;
      const float* w = whhT + u;
      // unrolled so that several k's weight loads are in flight at once:
      // L2 latency is what a step waits on
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float wr = __ldg(w), wz = __ldg(w + H), wn = __ldg(w + 2 * H);
        w += H3;
        const float4* h4 = reinterpret_cast<const float4*>(hc + k * R);
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
          const float4 hv = h4[q];
          const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a_r[4 * q + j] = fmaf(hs[j], wr, a_r[4 * q + j]);
            a_z[4 * q + j] = fmaf(hs[j], wz, a_z[4 * q + j]);
            a_n[4 * q + j] = fmaf(hs[j], wn, a_n[4 * q + j]);
          }
        }
      }
      const float br = __ldg(bhh + u), bz = __ldg(bhh + H + u);
      const float bn = __ldg(bhh + 2 * H + u);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = row0 + r;
        float xr = 0.f, xz = 0.f, xn = 0.f;
        if (b < B) {
          const float* x = xp + ((size_t)t * B + b) * H3;
          xr = __ldg(x + u);
          xz = __ldg(x + H + u);
          xn = __ldg(x + 2 * H + u);
        }
        const float rg = sigmoid_f(xr + (a_r[r] + br));
        const float zg = sigmoid_f(xz + (a_z[r] + bz));
        const float ng = tanhf(xn + rg * (a_n[r] + bn));
        const float h = (1.f - zg) * ng + zg * hc[u * R + r];
        hn[u * R + r] = h;
        if (b < B) ys[((size_t)t * B + b) * H + u] = h;
      }
    }
    __syncthreads();
    float* tmp = hc; hc = hn; hn = tmp;
  }
  for (int i = threadIdx.x; i < H * R; i += blockDim.x) {
    const int k = i / R, b = row0 + i % R;
    if (b < B) hlast[(size_t)b * H + k] = hc[i];
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers to
// contiguous fp32 arrays; `stream` is a cudaStream_t. Returns a
// cudaError_t code (0 = launched).
extern "C" int g2v_gru_sequence(const float* xp, const float* h0,
                                const float* whhT, const float* bhh,
                                float* ys, float* hlast, int T, int B, int H,
                                int reverse, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (size_t)R * H;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gru_sequence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((H + 31) / 32) * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  const dim3 grid((B + R - 1) / R);
  gru_sequence_kernel<<<grid, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      xp, h0, whhT, bhh, ys, hlast, T, B, H, reverse);
  return (int)cudaGetLastError();
}

