// K6 banded_hs_sg_grad and K7 hs_cbow_grad: the hierarchical-softmax
// steps of the local word2vec pipeline.
//
// K6 replaces the reference's `_hs_sg_loss_and_grads`
// (multiverso_tpu/models/wordembedding/device_train.py:316-347): center
// row v[c] against the Huffman-path rows of the context word at band
// position p = c + W + off_j, gathered once per band position:
//   u_bp[p*L + l] (node l of band position p), path_band/code_band[C+2W, L]
//   mask[c, j, l] = (path >= 0 && code >= 0) * pmask[c, j]
//   logit = clip(v[c] . u_bp[p*L + l]), label = (1 - code) * mask
//   loss = sum xent(logit, label) * mask
// K7 replaces `_hs_cbow_loss_and_grads` (:350-377): the masked window
// mean of the band's INPUT rows against the center's own path rows
// u_path[c*L + l], masked by has_ctx. Both as `_group_fn_hs` (:381-416)
// drives them. Outputs scale * gradient (scale = -lr).
//
// Bound on the card: bytes (~195 MB of path rows a step at C=8192,
// L=22, D=128, W=5, the masked nodes included). A masked node (padding
// past the path's end, or a pair outside the shrunk window) contributes
// exactly zero loss and gradient, so its row is not read. Two launches
// each, no atomics, so the result is the same on every run:
//   K6 A. one block per center: one warp per (offset, node) computes the
//         logit and its coefficient g[c, j, l] (saved in a [C, 2W, L]
//         scratch) and accumulates g * u_bp into a per-warp d_v row; the
//         block writes d_v[c] and its loss and pair partial sums.
//   K6 B. the shared band pass (w2v_common.cuh) with L nodes, one warp
//         per path row: d_bp[p*L + l] = scale * sum_j g[c_j, j, l] * v[c_j],
//         c_j = p - W - off_j.
//   K7 A. one block per center: the window mean, then one warp per node
//         computes the logit, writes the node's d_path row (owned by the
//         center) and accumulates its share of the mean's gradient; the
//         block saves gacc[c] = g_vmean[c] / max(n_c, 1).
//   K7 B. K5's band pass: d_band[t] = scale * sum_j pmask[c_j, j] *
//         gacc[c_j].

#include "w2v_common.cuh"

namespace {

// Loss of one warp's logits, then the block's, by lane 0 of each warp.
__device__ __forceinline__ float block_loss(float wloss, float* swl) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) swl[threadIdx.x >> 5] = wloss;
  __syncthreads();
  float l = 0.0f;
  for (int w = 0; w < kWarps; ++w) l += swl[w];
  return l;
}

__global__ void hs_sg_center(const float* __restrict__ v,
                             const float* __restrict__ u_bp,
                             const int* __restrict__ path_band,
                             const int* __restrict__ code_band,
                             const float* __restrict__ pmask, int C, int W,
                             int L, int D, float scale,
                             float* __restrict__ d_v,
                             float* __restrict__ coef,
                             float* __restrict__ loss_part,
                             float* __restrict__ pairs_part) {
  extern __shared__ float smem[];
  const int W2 = 2 * W;
  const int c = blockIdx.x;
  float* sv = smem;              // [D] the center row
  float* sacc = sv + D;          // [kWarps][D] d_v partials
  float* swl = sacc + kWarps * D;  // [kWarps]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < D; i += kThreads) sv[i] = v[(int64_t)c * D + i];
  for (int i = tid; i < kWarps * D; i += kThreads) sacc[i] = 0.0f;
  __syncthreads();

  float wloss = 0.0f;
  float* acc = sacc + warp * D;
  for (int item = warp; item < W2 * L; item += kWarps) {
    const int j = item / L;
    const int l = item - j * L;
    const int64_t p = (int64_t)c + W + offset_of(j, W);
    const int node = path_band[p * L + l];
    const int code = code_band[p * L + l];
    const float mask =
        (node >= 0 && code >= 0 ? 1.0f : 0.0f) * pmask[(int64_t)c * W2 + j];
    float g = 0.0f;
    if (mask != 0.0f) {
      const float* row = u_bp + (p * L + l) * D;
      float dot = 0.0f;
      for (int d = lane; d < D; d += 32) dot += sv[d] * row[d];
      dot = warp_sum(dot);
      const float xc = clip(dot);
      const float y = (1.0f - (float)code) * mask;
      wloss += xent(xc, y) * mask;
      g = xent_grad(xc, y) * clip_grad(dot) * mask;
      for (int d = lane; d < D; d += 32) acc[d] += g * row[d];
    }
    if (lane == 0) coef[((int64_t)c * W2 + j) * L + l] = g;
  }
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float g = 0.0f;
    for (int w = 0; w < kWarps; ++w) g += sacc[w * D + d];
    d_v[(int64_t)c * D + d] = scale * g;
  }
  const float l = block_loss(wloss, swl);
  if (tid == 0) {
    float pr = 0.0f;
    for (int j = 0; j < W2; ++j) pr += pmask[(int64_t)c * W2 + j];
    loss_part[c] = l;
    pairs_part[c] = pr;
  }
}

__global__ void hs_cbow_center(const float* __restrict__ u_band,
                               const float* __restrict__ u_path,
                               const int* __restrict__ path,
                               const int* __restrict__ code,
                               const float* __restrict__ pmask, int C,
                               int W, int L, int D, float scale,
                               float* __restrict__ d_path,
                               float* __restrict__ gacc,
                               float* __restrict__ loss_part,
                               float* __restrict__ ex_part) {
  extern __shared__ float smem[];
  const int W2 = 2 * W;
  const int c = blockIdx.x;
  float* svm = smem;               // [D] window mean
  float* sacc = svm + D;           // [kWarps][D] g_vmean partials
  float* swl = sacc + kWarps * D;  // [kWarps]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* pm = pmask + (int64_t)c * W2;
  float nvalid = 0.0f;
  for (int j = 0; j < W2; ++j) nvalid += pm[j];
  const float denom = fmaxf(nvalid, 1.0f);
  const float has_ctx = nvalid > 0.0f ? 1.0f : 0.0f;
  // Window mean, summed in offset order as the reference sums it.
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.0f;
    for (int j = 0; j < W2; ++j)
      a += pm[j] * u_band[((int64_t)c + W + offset_of(j, W)) * D + d];
    svm[d] = a / denom;
  }
  for (int i = tid; i < kWarps * D; i += kThreads) sacc[i] = 0.0f;
  __syncthreads();

  float wloss = 0.0f;
  float* acc = sacc + warp * D;
  for (int l = warp; l < L; l += kWarps) {
    const int64_t r = (int64_t)c * L + l;
    const int node = path[r];
    const int cd = code[r];
    const float mask = (node >= 0 && cd >= 0 ? 1.0f : 0.0f) * has_ctx;
    float* dst = d_path + r * D;
    if (mask != 0.0f) {
      const float* row = u_path + r * D;
      float dot = 0.0f;
      for (int d = lane; d < D; d += 32) dot += svm[d] * row[d];
      dot = warp_sum(dot);
      const float xc = clip(dot);
      const float y = (1.0f - (float)cd) * mask;
      wloss += xent(xc, y) * mask;
      const float g = xent_grad(xc, y) * clip_grad(dot) * mask;
      for (int d = lane; d < D; d += 32) {
        acc[d] += g * row[d];
        dst[d] = scale * (g * svm[d]);
      }
    } else {
      for (int d = lane; d < D; d += 32) dst[d] = 0.0f;
    }
  }
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float g = 0.0f;
    for (int w = 0; w < kWarps; ++w) g += sacc[w * D + d];
    gacc[(int64_t)c * D + d] = g / denom;
  }
  const float l = block_loss(wloss, swl);
  if (tid == 0) {
    loss_part[c] = l;
    ex_part[c] = has_ctx;
  }
}

size_t center_smem(int D) {
  return sizeof(float) * ((size_t)(1 + kWarps) * D + kWarps);
}

}  // namespace

// coef is scratch [C, 2W, L]; loss_part and pairs_part scratch [C].
extern "C" cudaError_t mv_banded_hs_sg_grad(
    const float* v, const float* u_bp, const int* path_band,
    const int* code_band, const float* pmask, int C, int W, int L, int D,
    float scale, float* d_v, float* d_bp, float* coef, float* loss_part,
    float* pairs_part, float* loss_out, float* pairs_out,
    cudaStream_t stream) {
  const size_t smem = center_smem(D);
  cudaError_t err = allow_smem(hs_sg_center, smem);
  if (err != cudaSuccess) return err;
  hs_sg_center<<<C, kThreads, smem, stream>>>(
      v, u_bp, path_band, code_band, pmask, C, W, L, D, scale, d_v, coef,
      loss_part, pairs_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_band_pass(v, coef, C, W, L, D, scale, loss_part,
                          pairs_part, C, d_bp, loss_out, pairs_out, stream);
}

// gacc is scratch [C, D]; loss_part and ex_part scratch [C].
extern "C" cudaError_t mv_hs_cbow_grad(
    const float* u_band, const float* u_path, const int* path,
    const int* code, const float* pmask, int C, int W, int L, int D,
    float scale, float* d_band, float* d_path, float* gacc,
    float* loss_part, float* ex_part, float* loss_out, float* ex_out,
    cudaStream_t stream) {
  const size_t smem = center_smem(D);
  cudaError_t err = allow_smem(hs_cbow_center, smem);
  if (err != cudaSuccess) return err;
  hs_cbow_center<<<C, kThreads, smem, stream>>>(
      u_band, u_path, path, code, pmask, C, W, L, D, scale, d_path, gacc,
      loss_part, ex_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_band_pass(gacc, pmask, C, W, 1, D, scale, loss_part,
                          ex_part, C, d_band, loss_out, ex_out, stream);
}
