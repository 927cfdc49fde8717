// K10 pairlist_hs_grad: the host-batch word2vec step with hierarchical
// softmax, over explicit per-pair row lists.
//
// Replaces the hierarchical-softmax branch of the reference's
// `Word2Vec._compact_loss` (multiverso_tpu/models/wordembedding/
// model.py:351-362) as `_make_step_core` (:395-450) and `_build_ps_step`
// (:755-767) differentiate it. For B pairs, with the input vector v[p]
// formed as in K9 (a center row, or the masked window mean over
// max(n, 1)), and the target's Huffman path points_idx[p, 0..L) with
// codes[p, l] (-1 padded):
//   mask[p, l] = (codes[p, l] >= 0) * m[p],  label = 1 - codes[p, l]
//   x[p, l] = clip(v[p] . eout[points_idx[p, l]])
//   loss = sum mask * xent(x, label * mask)
// with JAX's clip gradient. Outputs scale * gradient per position: d_in
// (as K9's), d_out [B*L, D] (row p*L + l is node l of pair p; a masked
// node's row is exactly zero and its path row is not read), the loss and
// the count (masked pairs; CBOW: masked windows with a context).
//
// Bound on the card: bytes (the unmasked path rows read, every d_out row
// written: ~B*L rows each way). One warp owns one pair: it forms v once,
// scores the L nodes in order, writes each node's gradient row and sums
// the input gradient in its own shared memory; a lane owns the columns
// d = lane + 32 i. No atomics; per-block loss and count partials are
// summed by a one-block second launch in a fixed order.

#include "w2v_common.cuh"

namespace {

__global__ void pairlist_hs(const float* __restrict__ ein,
                            const float* __restrict__ eout,
                            const int* __restrict__ in_idx,
                            const float* __restrict__ win_mask, int W2,
                            const int* __restrict__ points_idx,
                            const int* __restrict__ codes,
                            const float* __restrict__ pair_mask, int B,
                            int L, int D, float scale,
                            float* __restrict__ d_in,
                            float* __restrict__ d_out,
                            float* __restrict__ loss_part,
                            float* __restrict__ count_part) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* sv = smem + warp * 2 * D;  // [D] the pair's input vector
  float* sg = sv + D;               // [D] its gradient
  float* swl = smem + warps * 2 * D;
  float* swc = swl + warps;
  const int p = blockIdx.x * warps + warp;
  float wloss = 0.0f;
  float wcount = 0.0f;
  if (p < B) {
    const float m = pair_mask[p];
    const int rows_in = W2 > 0 ? W2 : 1;
    float* din = d_in + (int64_t)p * rows_in * D;
    float* dout = d_out + (int64_t)p * L * D;
    if (m == 0.0f) {
      for (int i = lane; i < L * D; i += 32) dout[i] = 0.0f;
      for (int i = lane; i < rows_in * D; i += 32) din[i] = 0.0f;
    } else {
      float denom = 1.0f;
      float has_ctx = 1.0f;
      if (W2 == 0) {
        const float* row = ein + (int64_t)in_idx[p] * D;
        for (int d = lane; d < D; d += 32) sv[d] = row[d];
      } else {
        const int* widx = in_idx + (int64_t)p * W2;
        const float* wm = win_mask + (int64_t)p * W2;
        float nctx = 0.0f;
        for (int j = 0; j < W2; ++j) nctx += wm[j];
        denom = fmaxf(nctx, 1.0f);
        has_ctx = nctx > 0.0f ? 1.0f : 0.0f;
        for (int d = lane; d < D; d += 32) {
          float s = 0.0f;
          for (int j = 0; j < W2; ++j)
            if (wm[j] != 0.0f) s += ein[(int64_t)widx[j] * D + d] * wm[j];
          sv[d] = s / denom;
        }
      }
      wcount = m * has_ctx;
      for (int d = lane; d < D; d += 32) sg[d] = 0.0f;
      const int* prow = points_idx + (int64_t)p * L;
      const int* crow = codes + (int64_t)p * L;
      for (int l = 0; l < L; ++l) {
        float* out = dout + (int64_t)l * D;
        const int code = crow[l];
        if (code < 0) {
          for (int d = lane; d < D; d += 32) out[d] = 0.0f;
          continue;
        }
        const float* row = eout + (int64_t)prow[l] * D;
        float dot = 0.0f;
        for (int d = lane; d < D; d += 32) dot += sv[d] * row[d];
        dot = warp_sum(dot);
        const float xc = clip(dot);
        const float y = (1.0f - (float)code) * m;
        wloss += xent(xc, y) * m;
        const float coef = xent_grad(xc, y) * clip_grad(dot) * m;
        for (int d = lane; d < D; d += 32) {
          sg[d] += coef * row[d];
          out[d] = scale * (coef * sv[d]);
        }
      }
      for (int d = lane; d < D; d += 32) {
        if (W2 == 0) {
          din[d] = scale * sg[d];
        } else {
          const float gm = sg[d] / denom;
          const float* wm = win_mask + (int64_t)p * W2;
          for (int j = 0; j < W2; ++j) din[j * D + d] = scale * (gm * wm[j]);
        }
      }
    }
  }
  if (lane == 0) {
    swl[warp] = wloss;
    swc[warp] = wcount;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.0f, c = 0.0f;
    for (int w = 0; w < warps; ++w) {
      l += swl[w];
      c += swc[w];
    }
    loss_part[blockIdx.x] = l;
    count_part[blockIdx.x] = c;
  }
}

__global__ void pairlist_hs_sums(const float* __restrict__ loss_part,
                                 const float* __restrict__ count_part,
                                 int nparts, float* __restrict__ loss_out,
                                 float* __restrict__ count_out) {
  reduce_parts(loss_part, count_part, nparts, loss_out, count_out);
}

}  // namespace

// `warps` warps a block, one pair each; loss_part and count_part are
// scratch [ceil(B / warps)].
extern "C" cudaError_t mv_pairlist_hs_grad(
    const float* ein, const float* eout, const int* in_idx,
    const float* win_mask, int W2, const int* points_idx, const int* codes,
    const float* pair_mask, int B, int L, int D, float scale, int warps,
    float* d_in, float* d_out, float* loss_part, float* count_part,
    float* loss_out, float* count_out, cudaStream_t stream) {
  const int blocks = B > 0 ? (B + warps - 1) / warps : 1;
  const size_t smem = sizeof(float) * ((size_t)warps * 2 * D + 2 * warps);
  cudaError_t err = allow_smem(pairlist_hs, smem);
  if (err != cudaSuccess) return err;
  pairlist_hs<<<blocks, warps * 32, smem, stream>>>(
      ein, eout, in_idx, win_mask, W2, points_idx, codes, pair_mask, B, L,
      D, scale, d_in, d_out, loss_part, count_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pairlist_hs_sums<<<1, 32, 0, stream>>>(loss_part, count_part, blocks,
                                         loss_out, count_out);
  return cudaGetLastError();
}
