// K9 pairlist_ns_grad: the host-batch word2vec step with negative
// sampling, over explicit per-pair row lists.
//
// Replaces the negative-sampling branch of the reference's
// `Word2Vec._compact_loss` (multiverso_tpu/models/wordembedding/
// model.py:337-384) as `_make_step_core` (:395-453) and `_build_ps_step`
// (:755-767) differentiate it. For B pairs, with the input vector
//   v[p] = ein[in_idx[p]]                                  (skip-gram)
//   v[p] = sum_j mask[p,j] ein[in_idx[p,j]] / max(n_p, 1)  (CBOW, W2 = 2W)
// and the K negatives neg_idx[p / nb] that each block of nb consecutive
// pairs shares:
//   pos[p] = clip(v[p] . eout[tgt_idx[p]]),
//   neg[p, k] = clip(v[p] . eout[neg_idx[p / nb, k]]),
//   loss = sum_p m[p] (xent(pos, 1) + sum_k xent(neg, 0))
// with JAX's clip gradient (w2v_common.cuh). Outputs scale * gradient per
// position: d_in (one row a pair, or one a CBOW window slot, mask * g_v /
// max(n, 1)), d_out = [targets (B) | negatives (B/nb * K)], the loss and
// the count (masked pairs; CBOW: masked windows with a context).
//
// Bound on the card: bytes. Every row a pair names is read once (the
// shared negatives from L1/L2 after the first pair of their block) and
// every gradient row is written once. One warp owns one negative block:
// it walks its nb pairs in order, writes each pair's input and target
// gradient rows, and sums the negatives' gradients in its own shared
// memory, so no two warps write one row and there are no atomics. A lane
// owns the columns d = lane + 32 i of every row it touches, so the
// per-warp vectors need no synchronization. Per-block loss and count
// partials are summed by a one-block second launch in a fixed order.

#include "w2v_common.cuh"

namespace {

__global__ void pairlist_ns(const float* __restrict__ ein,
                            const float* __restrict__ eout,
                            const int* __restrict__ in_idx,
                            const float* __restrict__ win_mask, int W2,
                            const int* __restrict__ tgt_idx,
                            const int* __restrict__ neg_idx,
                            const float* __restrict__ pair_mask, int B,
                            int nb, int K, int D, float scale,
                            float* __restrict__ d_in,
                            float* __restrict__ d_out,
                            float* __restrict__ loss_part,
                            float* __restrict__ count_part) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int per_warp = D + K * D + K + 1;
  float* sv = smem + warp * per_warp;  // [D] the pair's input vector
  float* sacc = sv + D;                // [K][D] negatives' gradient sums
  float* scoef = sacc + K * D;         // [K + 1] the pair's coefficients
  float* swl = smem + warps * per_warp;  // [warps] loss per warp
  float* swc = swl + warps;              // [warps] count per warp
  const int NB = B / nb;
  const int n = blockIdx.x * warps + warp;
  float wloss = 0.0f;
  float wcount = 0.0f;
  if (n < NB) {
    for (int i = lane; i < K * D; i += 32) sacc[i] = 0.0f;
    const int* nrow = neg_idx + (int64_t)n * K;
    const int rows_in = W2 > 0 ? W2 : 1;
    for (int p = n * nb; p < (n + 1) * nb; ++p) {
      const float m = pair_mask[p];
      float* din = d_in + (int64_t)p * rows_in * D;
      float* dt = d_out + (int64_t)p * D;
      if (m == 0.0f) {
        for (int d = lane; d < D; d += 32) dt[d] = 0.0f;
        for (int i = lane; i < rows_in * D; i += 32) din[i] = 0.0f;
        continue;
      }
      // The input vector.
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
      wcount += m * has_ctx;
      // The 1 + K logits and their coefficients.
      const float* ut = eout + (int64_t)tgt_idx[p] * D;
      for (int k = 0; k <= K; ++k) {
        const float* row = k == 0 ? ut : eout + (int64_t)nrow[k - 1] * D;
        float dot = 0.0f;
        for (int d = lane; d < D; d += 32) dot += sv[d] * row[d];
        dot = warp_sum(dot);
        const float xc = clip(dot);
        const float y = k == 0 ? 1.0f : 0.0f;
        wloss += xent(xc, y) * m;
        if (lane == 0) scoef[k] = xent_grad(xc, y) * clip_grad(dot) * m;
      }
      __syncwarp();
      // Gradient rows: the input side, the target, the negatives' sums.
      for (int d = lane; d < D; d += 32) {
        const float x = sv[d];
        float g = scoef[0] * ut[d];
        for (int k = 0; k < K; ++k) {
          g += scoef[k + 1] * eout[(int64_t)nrow[k] * D + d];
          sacc[k * D + d] += scoef[k + 1] * x;
        }
        dt[d] = scale * (scoef[0] * x);
        if (W2 == 0) {
          din[d] = scale * g;
        } else {
          const float gm = g / denom;
          const float* wm = win_mask + (int64_t)p * W2;
          for (int j = 0; j < W2; ++j) din[j * D + d] = scale * (gm * wm[j]);
        }
      }
      __syncwarp();
    }
    float* dn = d_out + ((int64_t)B + (int64_t)n * K) * D;
    for (int i = lane; i < K * D; i += 32) dn[i] = scale * sacc[i];
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

__global__ void pairlist_ns_sums(const float* __restrict__ loss_part,
                                 const float* __restrict__ count_part,
                                 int nparts, float* __restrict__ loss_out,
                                 float* __restrict__ count_out) {
  reduce_parts(loss_part, count_part, nparts, loss_out, count_out);
}

}  // namespace

// `warps` warps a block, one negative block each; loss_part and
// count_part are scratch [ceil((B / nb) / warps)].
extern "C" cudaError_t mv_pairlist_ns_grad(
    const float* ein, const float* eout, const int* in_idx,
    const float* win_mask, int W2, const int* tgt_idx, const int* neg_idx,
    const float* pair_mask, int B, int nb, int K, int D, float scale,
    int warps, float* d_in, float* d_out, float* loss_part,
    float* count_part, float* loss_out, float* count_out,
    cudaStream_t stream) {
  const int NB = B / nb;
  const int blocks = NB > 0 ? (NB + warps - 1) / warps : 1;
  const size_t smem =
      sizeof(float) * ((size_t)warps * (D + K * D + K + 1) + 2 * warps);
  cudaError_t err = allow_smem(pairlist_ns, smem);
  if (err != cudaSuccess) return err;
  pairlist_ns<<<blocks, warps * 32, smem, stream>>>(
      ein, eout, in_idx, win_mask, W2, tgt_idx, neg_idx, pair_mask, B, nb,
      K, D, scale, d_in, d_out, loss_part, count_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pairlist_ns_sums<<<1, 32, 0, stream>>>(loss_part, count_part, blocks,
                                         loss_out, count_out);
  return cudaGetLastError();
}
