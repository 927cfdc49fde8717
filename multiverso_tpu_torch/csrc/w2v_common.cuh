// Device pieces shared by the word2vec step kernels (K4-K8): the clipped
// sigmoid cross-entropy with its gradient formed as JAX's autodiff forms
// it, warp sums, and the band pass that sums the gradients of the C+2W
// band rows from per-(center, offset) coefficients without atomics.
// The plain PyTorch versions carry the same functions in
// multiverso_tpu_torch/kernels/objective.py.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMaxExp = 6.0f;

// Window offset of pair-mask column j: -W..-1, 1..W.
__device__ __forceinline__ int offset_of(int j, int W) {
  return j < W ? j - W : j - W + 1;
}

__device__ __forceinline__ float clip(float x) {
  return fminf(kMaxExp, fmaxf(-kMaxExp, x));
}

// d clip(x) / dx as JAX differentiates minimum(6, maximum(-6, x)).
__device__ __forceinline__ float clip_grad(float x) {
  const float lo = x > -kMaxExp ? 1.0f : (x == -kMaxExp ? 0.5f : 0.0f);
  const float m = fmaxf(-kMaxExp, x);
  const float hi = m < kMaxExp ? 1.0f : (m == kMaxExp ? 0.5f : 0.0f);
  return lo * hi;
}

// Sigmoid cross-entropy max(x,0) - x*y + log1p(exp(-|x|)).
__device__ __forceinline__ float xent(float x, float y) {
  return fmaxf(x, 0.0f) - x * y + log1pf(expf(-fabsf(x)));
}

// Its derivative as JAX's autodiff forms it: 1/2 for max(x, 0) at
// x == 0 and d|x|/dx = 1 at x == 0, so exactly 0 gives -y (every logit
// against the zero-initialized output table is exactly 0).
__device__ __forceinline__ float xent_grad(float x, float y) {
  const float e = expf(-fabsf(x));
  const float relu = x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f);
  const float sgn = x >= 0.0f ? 1.0f : -1.0f;
  return relu - y - sgn * (e / (1.0f + e));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Fixed-order sums of two per-block partial arrays by one warp (the
// result is the same on every run).
__device__ __forceinline__ void reduce_parts(const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             int n, float* __restrict__ a_out,
                                             float* __restrict__ b_out) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  float sa = 0.0f, sb = 0.0f;
  for (int i = lane; i < n; i += 32) {
    sa += a[i];
    if (b != nullptr) sb += b[i];
  }
  sa = warp_sum(sa);
  sb = warp_sum(sb);
  if (lane == 0) {
    a_out[0] = sa;
    if (b_out != nullptr) b_out[0] = sb;
  }
}

// The band pass: one warp per band row r of (C+2W)*L (t = r / L band
// position, l = r % L node):
//   out[r] = scale * sum_j coef[(c_j*2W + j)*L + l] * vec[c_j],
//   c_j = t - W - off_j, for c_j in [0, C).
// L = 1 is the plain band (K4: coef = the positive coefficients, vec =
// the center rows; K5, K7: coef = the pair mask, vec = the gradient of
// each center's window sum). Block `band_blocks` sums the partials.
__global__ void band_pass(const float* __restrict__ vec,
                          const float* __restrict__ coef, int C, int W,
                          int L, int D, float scale, int64_t band_blocks,
                          const float* __restrict__ loss_part,
                          const float* __restrict__ count_part, int nparts,
                          float* __restrict__ out,
                          float* __restrict__ loss_out,
                          float* __restrict__ count_out) {
  if (blockIdx.x == band_blocks) {
    reduce_parts(loss_part, count_part, nparts, loss_out, count_out);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int W2 = 2 * W;
  const int64_t r = (blockIdx.x * (int64_t)kThreads + threadIdx.x) >> 5;
  if (r >= ((int64_t)C + W2) * L) return;
  const int64_t t = r / L;
  const int l = (int)(r - t * L);
  float* dst = out + r * D;
  for (int d = lane; d < D; d += 32) {
    float g = 0.0f;
    for (int j = 0; j < W2; ++j) {
      const int64_t c = t - W - offset_of(j, W);
      if (c >= 0 && c < C)
        g += coef[(c * W2 + j) * L + l] * vec[c * D + d];
    }
    dst[d] = scale * g;
  }
}

inline cudaError_t launch_band_pass(const float* vec, const float* coef,
                                    int C, int W, int L, int D, float scale,
                                    const float* loss_part,
                                    const float* count_part, int nparts,
                                    float* out, float* loss_out,
                                    float* count_out, cudaStream_t stream) {
  const int64_t rows = ((int64_t)C + 2 * W) * L;
  const int64_t band_blocks = (rows * 32 + kThreads - 1) / kThreads;
  band_pass<<<(unsigned)(band_blocks + 1), kThreads, 0, stream>>>(
      vec, coef, C, W, L, D, scale, band_blocks, loss_part, count_part,
      nparts, out, loss_out, count_out);
  return cudaGetLastError();
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
