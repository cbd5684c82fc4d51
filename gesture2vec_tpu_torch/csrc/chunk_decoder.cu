// Fused Part-b chunk rollout for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernel gesture2vec_tpu/ops/decoder_pallas.py
// (fused_chunk_decode -> _decoder_kernel). One launch runs all n_steps of
//   p   = relu((x @ w_pre) * bn_scale + bn_bias)     (eval BN + pre bias folded)
//   h0' = GRU(p,  h0; w0_ih, w0_hh, b0_ih, b0_hh)     (gate order r, z, n)
//   h1' = GRU(h0', h1; w1_ih, w1_hh, b1_ih, b1_hh)
//   x   = h1' @ w_out + b_out                          -> ys[t], fed back
//
// Bound at the bench width (H=200, D=40, 20 steps, 1824 chunk rows): each
// row and step is ~992 kFLOP, 36.2 GFLOP in all, 0.54 ms at the card's
// 67 TFLOP/s fp32 (non-tensor-core) peak; the bytes (inputs, weights and
// outputs, ~11 MB) take ~3 us at 3.35 TB/s. So the kernel is bound by
// operations. TF32 mma is ruled out by the 1e-5 fp32 parity contract.
//
// Design:
//  - one block per tile of R chunk rows; the tile's input frame, both
//    layers' hidden state and the pre-activation live in shared memory,
//    stored transposed ([k][R]) so a thread reads all R rows of one k with
//    R/4 broadcast float4 loads;
//  - weights stay in device memory (1.9 MB of GRU weights do not fit one
//    SM but stay resident in the 50 MB L2), transposed to (in, out) so
//    neighbouring threads read neighbouring columns; each weight read is
//    used for R rows;
//  - in the GRU phases a thread owns hidden unit u and accumulates the
//    r, z and both n pre-activations of u for all R rows in registers, so
//    the gate nonlinearity and state update need no shared-memory gate
//    buffers; new states go to a second buffer (double buffering), since
//    other threads still read the old state;
//  - ragged row counts are masked here: rows past B start from zeros and
//    are never written.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
// chunk rows per block: 8-row tiles fill more SMs than 16-row ones, which
// were slower at every batch size of the main path
constexpr int kRows = 8;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// out[n][r] = act(sum_k inT[k][r] * w[k][n] * scale[n] + shift[n]) for the
// pre_linear (relu, folded BN) and, with scale == nullptr, the out_layer.
template <int R>
__device__ __forceinline__ void linear_rows(
    const float* __restrict__ inT, int K, const float* __restrict__ w, int N,
    const float* __restrict__ scale, const float* __restrict__ shift,
    bool relu, float* __restrict__ outT) {
  for (int i = threadIdx.x; i < N * R; i += blockDim.x) {
    const int n = i % N;
    const int r = i / N;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) acc = fmaf(inT[k * R + r], __ldg(w + k * N + n), acc);
    float y = scale ? acc * __ldg(scale + n) + __ldg(shift + n)
                    : acc + __ldg(shift + n);
    if (relu) y = fmaxf(y, 0.f);
    outT[n * R + r] = y;
  }
}

// One GRU layer for the tile: xT (H x R) input, hT (H x R) state,
// writes the new state to outT (H x R). Weights (H, 3H), transposed.
template <int R>
__device__ __forceinline__ void gru_rows(
    const float* __restrict__ xT, const float* __restrict__ hT,
    float* __restrict__ outT, const float* __restrict__ w_ih,
    const float* __restrict__ w_hh, const float* __restrict__ b_ih,
    const float* __restrict__ b_hh, int H) {
  const int H3 = 3 * H;
  for (int u = threadIdx.x; u < H; u += blockDim.x) {
    float a_r[R], a_z[R], a_in[R], a_hn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a_r[r] = a_z[r] = a_in[r] = a_hn[r] = 0.f;
    const float* wi = w_ih + u;
    const float* wh = w_hh + u;
    // unrolled so that several k's weight loads are in flight at once:
    // a block has few warps, and L2 latency is what a step waits on
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float wir = __ldg(wi), wiz = __ldg(wi + H), win = __ldg(wi + 2 * H);
      const float whr = __ldg(wh), whz = __ldg(wh + H), whn = __ldg(wh + 2 * H);
      wi += H3;
      wh += H3;
      const float4* x4 = reinterpret_cast<const float4*>(xT + k * R);
      const float4* h4 = reinterpret_cast<const float4*>(hT + k * R);
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 xv = x4[q];
        const float4 hv = h4[q];
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
        const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 4 * q + j;
          a_r[r] = fmaf(hs[j], whr, fmaf(xs[j], wir, a_r[r]));
          a_z[r] = fmaf(hs[j], whz, fmaf(xs[j], wiz, a_z[r]));
          a_in[r] = fmaf(xs[j], win, a_in[r]);
          a_hn[r] = fmaf(hs[j], whn, a_hn[r]);
        }
      }
    }
    const float br = __ldg(b_ih + u) + __ldg(b_hh + u);
    const float bz = __ldg(b_ih + H + u) + __ldg(b_hh + H + u);
    const float bin = __ldg(b_ih + 2 * H + u);
    const float bhn = __ldg(b_hh + 2 * H + u);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float rg = sigmoid_f(a_r[r] + br);
      const float zg = sigmoid_f(a_z[r] + bz);
      const float ng = tanhf(a_in[r] + bin + rg * (a_hn[r] + bhn));
      outT[u * R + r] = (1.f - zg) * ng + zg * hT[u * R + r];
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
chunk_decode_kernel(const float* __restrict__ x0,     // (B, D)
                    const float* __restrict__ h0,     // (2, B, H)
                    const float* __restrict__ w_pre,  // (D, H)
                    const float* __restrict__ bn_scale,
                    const float* __restrict__ bn_bias,  // (H)
                    const float* __restrict__ w0_ih, const float* __restrict__ w0_hh,
                    const float* __restrict__ b0_ih, const float* __restrict__ b0_hh,
                    const float* __restrict__ w1_ih, const float* __restrict__ w1_hh,
                    const float* __restrict__ b1_ih, const float* __restrict__ b1_hh,
                    const float* __restrict__ w_out,  // (H, D)
                    const float* __restrict__ b_out,  // (D)
                    float* __restrict__ ys,           // (T, B, D)
                    int B, int D, int H, int T) {
  extern __shared__ float4 smem4[];
  float* xT = reinterpret_cast<float*>(smem4);  // D x R
  float* pT = xT + D * R;                       // H x R
  float* h0c = pT + H * R;                      // layer-0 state, H x R
  float* h0n = h0c + H * R;
  float* h1c = h0n + H * R;                     // layer-1 state, H x R
  float* h1n = h1c + H * R;

  const int row0 = blockIdx.x * R;
  for (int i = threadIdx.x; i < D * R; i += blockDim.x) {
    const int k = i / R, b = row0 + i % R;
    xT[i] = b < B ? x0[(size_t)b * D + k] : 0.f;
  }
  for (int i = threadIdx.x; i < H * R; i += blockDim.x) {
    const int k = i / R, b = row0 + i % R;
    h0c[i] = b < B ? h0[(size_t)b * H + k] : 0.f;
    h1c[i] = b < B ? h0[((size_t)B + b) * H + k] : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    linear_rows<R>(xT, D, w_pre, H, bn_scale, bn_bias, true, pT);
    __syncthreads();
    gru_rows<R>(pT, h0c, h0n, w0_ih, w0_hh, b0_ih, b0_hh, H);
    __syncthreads();
    float* tmp = h0c; h0c = h0n; h0n = tmp;
    gru_rows<R>(h0c, h1c, h1n, w1_ih, w1_hh, b1_ih, b1_hh, H);
    __syncthreads();
    tmp = h1c; h1c = h1n; h1n = tmp;
    linear_rows<R>(h1c, H, w_out, D, nullptr, b_out, false, xT);
    __syncthreads();
    float* y = ys + (size_t)t * B * D;
    for (int i = threadIdx.x; i < D * R; i += blockDim.x) {
      const int n = i % D, r = i / D;
      if (row0 + r < B) y[(size_t)(row0 + r) * D + n] = xT[n * R + r];
    }
    // the next step's pre_linear only reads xT, which nothing writes
    // before the next barrier
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers to
// contiguous fp32 arrays; `stream` is a cudaStream_t. Returns a cudaError_t
// code (0 = launched).
extern "C" int g2v_chunk_decode(
    const float* x0, const float* h0, const float* w_pre,
    const float* bn_scale, const float* bn_bias, const float* w0_ih,
    const float* w0_hh, const float* b0_ih, const float* b0_hh,
    const float* w1_ih, const float* w1_hh, const float* b1_ih,
    const float* b1_hh, const float* w_out, const float* b_out, float* ys,
    int B, int D, int H, int T, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kRows * (D + 5 * (size_t)H);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunk_decode_kernel<kRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((H + 31) / 32) * 32;
  threads = threads < 64 ? 64 : (threads > kMaxThreads ? kMaxThreads : threads);
  const dim3 grid((B + kRows - 1) / kRows);
  chunk_decode_kernel<kRows><<<grid, threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      x0, h0, w_pre, bn_scale, bn_bias, w0_ih, w0_hh, b0_ih, b0_hh, w1_ih,
      w1_hh, b1_ih, b1_hh, w_out, b_out, ys, B, D, H, T);
  return (int)cudaGetLastError();
}
