// K4 banded_sgns_grad: the skip-gram negative-sampling step of the PS
// word2vec pipeline on pulled rows, in banded form.
//
// Replaces the objective of the reference's `_block_step_fn` (skip-gram,
// negative sampling, per_pair=False;
// multiverso_tpu/models/wordembedding/device_train.py:729-788, with
// `_banded_sgns_loss_and_grads` :131-156). For C consecutive centers with
// rows v[C, D], the band rows u[0 : C+2W] and the block-shared negatives
// u[C+2W : C+2W+nb*K] (nb = C/B blocks of B centers share K negatives):
//   pos[c, j] = v[c] . u[c + W + off_j]   (off_j in -W..-1, 1..W)
//   neg[n, b, k] = v[nB+b] . u[C+2W + nK+k]
// both clipped to +-6 (_MAX_EXP) with JAX's clip gradient (0 outside,
// 1/2 exactly on the bound, 1 inside), sigmoid cross-entropy at label 1
// masked by pmask and at label 0 weighted by the center's valid-pair
// count. Outputs scale * gradient (scale = -lr / num_workers):
//   d_v[C, D], d_u[C+2W+nb*K, D], plus the loss and the pair count.
//
// Bound on the card: bytes (the dot products are ~380 MFLOP against
// ~90 MB of rows at full width). Two launches, no atomics, so the result
// is the same on every run:
//   A. one block per negative block n: its B center rows, B+2W band rows,
//      K negative rows and pair mask go to shared memory; one warp per
//      logit computes the 2W*B + K*B dot products, one thread per logit
//      the clipped sigmoid-xent terms; the block then writes the
//      complete d_v of its centers and d_u of its negatives, the
//      per-(center, offset) positive coefficients gpos[C, 2W] and its
//      loss and pair partial sums.
//   B. one warp per band row t: d_u[t] = scale * sum_j gpos[c_j, j] *
//      v[c_j] with c_j = t - W - off_j; the last block sums the loss and
//      pair partials in a fixed order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMaxExp = 6.0f;

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

__global__ void sgns_block(const float* __restrict__ v,
                           const float* __restrict__ u,
                           const float* __restrict__ pmask, int C, int W,
                           int K, int B, int D, float scale,
                           float* __restrict__ d_v, float* __restrict__ d_u,
                           float* __restrict__ gpos,
                           float* __restrict__ loss_part,
                           float* __restrict__ pairs_part) {
  extern __shared__ float smem[];
  const int W2 = 2 * W;
  const int n = blockIdx.x;
  const int c0 = n * B;
  const int n_pos = B * W2;
  const int n_logits = n_pos + B * K;
  float* sv = smem;                      // [B][D]
  float* sband = sv + B * D;             // [B + 2W][D]
  float* sneg = sband + (B + W2) * D;    // [K][D]
  float* spm = sneg + K * D;             // [B][2W] pair mask
  float* sdot = spm + n_pos;             // [n_logits] raw logits
  float* spos = sdot + n_logits;         // [B][2W] positive coefficients
  float* sngc = spos + n_pos;            // [B][K] negative coefficients
  float* snval = sngc + B * K;           // [B] valid pairs per center
  float* swl = snval + B;                // [kWarps] loss per warp

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* vsrc = v + (int64_t)c0 * D;
  for (int i = tid; i < B * D; i += kThreads) sv[i] = vsrc[i];
  const float* bsrc = u + (int64_t)c0 * D;  // band rows c0 .. c0+B+2W
  for (int i = tid; i < (B + W2) * D; i += kThreads) sband[i] = bsrc[i];
  const float* nsrc = u + ((int64_t)C + W2 + (int64_t)n * K) * D;
  for (int i = tid; i < K * D; i += kThreads) sneg[i] = nsrc[i];
  const float* msrc = pmask + (int64_t)c0 * W2;
  for (int i = tid; i < n_pos; i += kThreads) spm[i] = msrc[i];
  __syncthreads();
  if (tid < B) {
    float s = 0.0f;
    for (int j = 0; j < W2; ++j) s += spm[tid * W2 + j];
    snval[tid] = s;
  }

  // One warp per logit: the dot products.
  for (int p = warp; p < n_logits; p += kWarps) {
    const float* a;
    const float* b;
    if (p < n_pos) {
      const int bi = p / W2;
      a = sv + bi * D;
      b = sband + (bi + W + offset_of(p - bi * W2, W)) * D;
    } else {
      const int q = p - n_pos;
      const int bi = q / K;
      a = sv + bi * D;
      b = sneg + (q - bi * K) * D;
    }
    float dot = 0.0f;
    for (int d = lane; d < D; d += 32) dot += a[d] * b[d];
    dot = warp_sum(dot);
    if (lane == 0) sdot[p] = dot;
  }
  __syncthreads();

  // One thread per logit: clipped sigmoid-xent loss and coefficient.
  float wloss = 0.0f;
  for (int p = tid; p < n_logits; p += kThreads) {
    const float x = sdot[p];
    const float xc = clip(x);
    if (p < n_pos) {
      const float m = spm[p];
      wloss += xent(xc, 1.0f) * m;
      spos[p] = xent_grad(xc, 1.0f) * clip_grad(x) * m;
    } else {
      const int q = p - n_pos;
      const float nv = snval[q / K];
      wloss += xent(xc, 0.0f) * nv;
      sngc[q] = xent_grad(xc, 0.0f) * clip_grad(x) * nv;
    }
  }
  wloss = warp_sum(wloss);
  if (lane == 0) swl[warp] = wloss;
  __syncthreads();

  // d_v of this block's centers: positives from the band, negatives.
  for (int i = tid; i < B * D; i += kThreads) {
    const int bi = i / D;
    const int d = i - bi * D;
    float g = 0.0f;
    for (int j = 0; j < W2; ++j)
      g += spos[bi * W2 + j] * sband[(bi + W + offset_of(j, W)) * D + d];
    for (int k = 0; k < K; ++k) g += sngc[bi * K + k] * sneg[k * D + d];
    d_v[(int64_t)(c0 + bi) * D + d] = scale * g;
  }
  // d_u of this block's negatives.
  float* dneg = d_u + ((int64_t)C + W2 + (int64_t)n * K) * D;
  for (int i = tid; i < K * D; i += kThreads) {
    const int k = i / D;
    const int d = i - k * D;
    float g = 0.0f;
    for (int bi = 0; bi < B; ++bi) g += sngc[bi * K + k] * sv[bi * D + d];
    dneg[i] = scale * g;
  }
  for (int i = tid; i < n_pos; i += kThreads)
    gpos[(int64_t)c0 * W2 + i] = spos[i];
  if (tid == 0) {
    float l = 0.0f;
    for (int w = 0; w < kWarps; ++w) l += swl[w];
    float pr = 0.0f;
    for (int bi = 0; bi < B; ++bi) pr += snval[bi];
    loss_part[n] = l;
    pairs_part[n] = pr;
  }
}

__global__ void sgns_band(const float* __restrict__ v,
                          const float* __restrict__ gpos, int C, int W,
                          int D, float scale, int64_t band_blocks,
                          const float* __restrict__ loss_part,
                          const float* __restrict__ pairs_part, int nb,
                          float* __restrict__ d_u,
                          float* __restrict__ loss_out,
                          float* __restrict__ pairs_out) {
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == band_blocks) {
    // Fixed-order reduction of the per-block partials (deterministic).
    if (threadIdx.x < 32) {
      float l = 0.0f, p = 0.0f;
      for (int i = lane; i < nb; i += 32) {
        l += loss_part[i];
        p += pairs_part[i];
      }
      l = warp_sum(l);
      p = warp_sum(p);
      if (lane == 0) {
        loss_out[0] = l;
        pairs_out[0] = p;
      }
    }
    return;
  }
  const int W2 = 2 * W;
  const int64_t t = (blockIdx.x * (int64_t)kThreads + threadIdx.x) >> 5;
  if (t >= (int64_t)C + W2) return;
  float* dst = d_u + t * D;
  for (int d = lane; d < D; d += 32) {
    float g = 0.0f;
    for (int j = 0; j < W2; ++j) {
      const int64_t c = t - W - offset_of(j, W);
      if (c >= 0 && c < C) g += gpos[c * W2 + j] * v[c * D + d];
    }
    dst[d] = scale * g;
  }
}

}  // namespace

extern "C" size_t mv_banded_sgns_smem(int W, int K, int B, int D) {
  const size_t n_pos = (size_t)B * 2 * W;
  const size_t n_logits = n_pos + (size_t)B * K;
  return sizeof(float) * ((size_t)(B + B + 2 * W + K) * D + n_pos +
                          n_logits + n_pos + (size_t)B * K + B + kWarps);
}

// gpos is scratch [C, 2W]; loss_part and pairs_part scratch [C / B].
extern "C" cudaError_t mv_banded_sgns_grad(
    const float* v, const float* u, const float* pmask, int C, int W, int K,
    int B, int D, float scale, float* d_v, float* d_u, float* gpos,
    float* loss_part, float* pairs_part, float* loss_out, float* pairs_out,
    cudaStream_t stream) {
  const int nb = C / B;
  const size_t smem = mv_banded_sgns_smem(W, K, B, D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sgns_block, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sgns_block<<<nb, kThreads, smem, stream>>>(v, u, pmask, C, W, K, B, D,
                                             scale, d_v, d_u, gpos,
                                             loss_part, pairs_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t band_rows = (int64_t)C + 2 * W;
  const int64_t band_blocks = (band_rows * 32 + kThreads - 1) / kThreads;
  sgns_band<<<(unsigned)(band_blocks + 1), kThreads, 0, stream>>>(
      v, gpos, C, W, D, scale, band_blocks, loss_part, pairs_part, nb, d_u,
      loss_out, pairs_out);
  return cudaGetLastError();
}
