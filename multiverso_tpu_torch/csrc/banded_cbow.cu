// K5 banded_cbow_grad: the CBOW negative-sampling step of the local
// word2vec pipeline, in banded form.
//
// Replaces the reference's `_banded_cbow_loss_and_grads`
// (multiverso_tpu/models/wordembedding/device_train.py:159-193) as
// `_apply_step(cbow=True)` (:211-221) drives it. For C consecutive
// centers with the band's INPUT rows u_band[C+2W, D], the OUTPUT rows
// u_out = [centers (C) | block-shared negatives (nb*K)] (nb = C/B blocks
// of B centers share K negatives) and the pair mask pmask[C, 2W]:
//   vmean[c] = (sum_j pmask[c, j] * u_band[c + W + off_j]) / max(n_c, 1)
//   pos[c] = vmean[c] . u_out[c],  neg[n, b, k] = vmean[nB+b] . u_out[C + nK+k]
// both clipped to +-6 with JAX's clip gradient, sigmoid cross-entropy at
// label 1 and 0, masked by has_ctx[c] = (n_c > 0), n_c = sum_j pmask[c, j].
// Outputs scale * gradient (scale = -lr): d_band[C+2W, D],
// d_out[C + nb*K, D], the loss and the examples (centers with a context).
//
// Bound on the card: bytes (~45 MB of rows a step at C=16384, D=128, W=5,
// K=5, B=8; ~0.1 GFLOP). Two launches, no atomics, so the result is the
// same on every run:
//   A. one block per negative block n: its B+2W band rows, B center rows,
//      K negative rows and pair mask go to shared memory; the block forms
//      its B window means, one warp per logit computes the B + B*K dot
//      products, one thread per logit the clipped sigmoid-xent terms;
//      the block then writes the complete d_out of its centers and
//      negatives, the gradient of each center's window sum
//      gacc[c] = g_vmean[c] / max(n_c, 1) into a [C, D] scratch, and its
//      loss and example partial sums.
//   B. the shared band pass (w2v_common.cuh):
//      d_band[t] = scale * sum_j pmask[c_j, j] * gacc[c_j],
//      c_j = t - W - off_j; its last block sums the partials.

#include "w2v_common.cuh"

namespace {

__global__ void cbow_block(const float* __restrict__ u_band,
                           const float* __restrict__ u_out,
                           const float* __restrict__ pmask, int C, int W,
                           int K, int B, int D, float scale,
                           float* __restrict__ d_out,
                           float* __restrict__ gacc,
                           float* __restrict__ loss_part,
                           float* __restrict__ ex_part) {
  extern __shared__ float smem[];
  const int W2 = 2 * W;
  const int n = blockIdx.x;
  const int c0 = n * B;
  const int n_logits = B + B * K;
  float* sband = smem;                   // [B + 2W][D]
  float* sctr = sband + (B + W2) * D;    // [B][D] center output rows
  float* sneg = sctr + B * D;            // [K][D]
  float* svm = sneg + K * D;             // [B][D] window means
  float* spm = svm + B * D;              // [B][2W] pair mask
  float* sdot = spm + B * W2;            // [n_logits] raw logits
  float* scoef = sdot + n_logits;        // [n_logits] coefficients
  float* sden = scoef + n_logits;        // [B] max(n_c, 1)
  float* shc = sden + B;                 // [B] has_ctx
  float* swl = shc + B;                  // [kWarps] loss per warp

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* bsrc = u_band + (int64_t)c0 * D;  // band rows c0..c0+B+2W
  for (int i = tid; i < (B + W2) * D; i += kThreads) sband[i] = bsrc[i];
  const float* csrc = u_out + (int64_t)c0 * D;
  for (int i = tid; i < B * D; i += kThreads) sctr[i] = csrc[i];
  const float* nsrc = u_out + ((int64_t)C + (int64_t)n * K) * D;
  for (int i = tid; i < K * D; i += kThreads) sneg[i] = nsrc[i];
  const float* msrc = pmask + (int64_t)c0 * W2;
  for (int i = tid; i < B * W2; i += kThreads) spm[i] = msrc[i];
  __syncthreads();
  for (int bi = tid; bi < B; bi += kThreads) {
    float s = 0.0f;
    for (int j = 0; j < W2; ++j) s += spm[bi * W2 + j];
    sden[bi] = fmaxf(s, 1.0f);
    shc[bi] = s > 0.0f ? 1.0f : 0.0f;
  }
  __syncthreads();
  // Window means, summed in offset order as the reference sums them.
  for (int i = tid; i < B * D; i += kThreads) {
    const int bi = i / D;
    const int d = i - bi * D;
    float acc = 0.0f;
    for (int j = 0; j < W2; ++j)
      acc += spm[bi * W2 + j] * sband[(bi + W + offset_of(j, W)) * D + d];
    svm[i] = acc / sden[bi];
  }
  __syncthreads();

  // One warp per logit: the dot products.
  for (int p = warp; p < n_logits; p += kWarps) {
    const float* a;
    const float* b;
    if (p < B) {
      a = svm + p * D;
      b = sctr + p * D;
    } else {
      const int q = p - B;
      const int bi = q / K;
      a = svm + bi * D;
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
    const float hc = shc[p < B ? p : (p - B) / K];
    const float y = p < B ? 1.0f : 0.0f;
    wloss += xent(xc, y) * hc;
    scoef[p] = xent_grad(xc, y) * clip_grad(x) * hc;
  }
  wloss = warp_sum(wloss);
  if (lane == 0) swl[warp] = wloss;
  __syncthreads();

  // d_out of this block's centers and gacc of their window sums.
  for (int i = tid; i < B * D; i += kThreads) {
    const int bi = i / D;
    const int d = i - bi * D;
    const float gp = scoef[bi];
    d_out[(int64_t)(c0 + bi) * D + d] = scale * (gp * svm[i]);
    float g = gp * sctr[i];
    for (int k = 0; k < K; ++k) g += scoef[B + bi * K + k] * sneg[k * D + d];
    gacc[(int64_t)(c0 + bi) * D + d] = g / sden[bi];
  }
  // d_out of this block's negatives.
  float* dneg = d_out + ((int64_t)C + (int64_t)n * K) * D;
  for (int i = tid; i < K * D; i += kThreads) {
    const int k = i / D;
    const int d = i - k * D;
    float g = 0.0f;
    for (int bi = 0; bi < B; ++bi) g += scoef[B + bi * K + k] * svm[bi * D + d];
    dneg[i] = scale * g;
  }
  if (tid == 0) {
    float l = 0.0f;
    for (int w = 0; w < kWarps; ++w) l += swl[w];
    float ex = 0.0f;
    for (int bi = 0; bi < B; ++bi) ex += shc[bi];
    loss_part[n] = l;
    ex_part[n] = ex;
  }
}

size_t cbow_smem(int W, int K, int B, int D) {
  const size_t n_logits = (size_t)B + (size_t)B * K;
  return sizeof(float) * ((size_t)(B + 2 * W + B + K + B) * D +
                          (size_t)B * 2 * W + 2 * n_logits + 2 * B + kWarps);
}

}  // namespace

// gacc is scratch [C, D]; loss_part and ex_part scratch [C / B].
extern "C" cudaError_t mv_banded_cbow_grad(
    const float* u_band, const float* u_out, const float* pmask, int C,
    int W, int K, int B, int D, float scale, float* d_band, float* d_out,
    float* gacc, float* loss_part, float* ex_part, float* loss_out,
    float* ex_out, cudaStream_t stream) {
  const int nb = C / B;
  const size_t smem = cbow_smem(W, K, B, D);
  cudaError_t err = allow_smem(cbow_block, smem);
  if (err != cudaSuccess) return err;
  cbow_block<<<nb, kThreads, smem, stream>>>(u_band, u_out, pmask, C, W, K,
                                             B, D, scale, d_out, gacc,
                                             loss_part, ex_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_band_pass(gacc, pmask, C, W, 1, D, scale, loss_part,
                          ex_part, nb, d_band, loss_out, ex_out, stream);
}
