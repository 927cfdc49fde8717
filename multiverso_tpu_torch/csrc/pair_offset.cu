// K8 pair_offset_grad: one window offset's sub-step of the per-pair
// skip-gram quality mode.
//
// Replaces the reference's `_pair_offset_loss_and_grads`
// (multiverso_tpu/models/wordembedding/device_train.py:233-250) as
// `_seq_pair_step` (:253-285) drives it, once for each of the 2W offsets
// against the live tables. For C pairs with center rows v[C, D] and
// u = [context rows (C) | each pair's own K negatives (C*K)]:
//   pos[c] = clip(v[c] . u[c]),  neg[c, k] = clip(v[c] . u[C + cK + k])
//   loss = sum m[c] * (xent(pos, 1) + sum_k xent(neg, 0))
// with JAX's clip gradient. Outputs scale * gradient (scale = -lr):
// d_v[C, D] and d_u[C + C*K, D], every row owned by one pair, the loss
// and the examples (sum of m).
//
// Bound on the card: bytes (~7.3 MB of rows in and out a sub-step at
// C=2048, K=5, D=128). One warp per pair computes its K+1 dot products
// and writes its K+2 gradient rows; a pair with m == 0 contributes
// exactly zero and reads nothing. No atomics: each block writes its loss
// and example partials and a one-block second launch sums them in a
// fixed order.

#include "w2v_common.cuh"

namespace {

__global__ void pair_block(const float* __restrict__ v,
                           const float* __restrict__ u,
                           const float* __restrict__ m, int C, int K, int D,
                           float scale, float* __restrict__ d_v,
                           float* __restrict__ d_u,
                           float* __restrict__ loss_part,
                           float* __restrict__ ex_part) {
  extern __shared__ float smem[];
  float* scoef = smem;              // [kWarps][K + 1] coefficients
  float* swl = scoef + kWarps * (K + 1);  // [kWarps] loss per warp
  float* swm = swl + kWarps;              // [kWarps] m per warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarps + warp;
  float wloss = 0.0f;
  float wm = 0.0f;
  if (c < C) {
    const float mc = m[c];
    wm = mc;
    const float* vr = v + (int64_t)c * D;
    float* dv = d_v + (int64_t)c * D;
    float* dpos = d_u + (int64_t)c * D;
    float* dneg = d_u + ((int64_t)C + (int64_t)c * K) * D;
    if (mc != 0.0f) {
      float* coef = scoef + warp * (K + 1);
      for (int k = 0; k <= K; ++k) {
        const float* row = k == 0 ? u + (int64_t)c * D
                                  : u + ((int64_t)C + (int64_t)c * K + k - 1) * D;
        float dot = 0.0f;
        for (int d = lane; d < D; d += 32) dot += vr[d] * row[d];
        dot = warp_sum(dot);
        const float xc = clip(dot);
        const float y = k == 0 ? 1.0f : 0.0f;
        wloss += xent(xc, y) * mc;
        if (lane == 0) coef[k] = xent_grad(xc, y) * clip_grad(dot) * mc;
      }
      __syncwarp();
      const float* upos = u + (int64_t)c * D;
      const float* uneg = u + ((int64_t)C + (int64_t)c * K) * D;
      for (int d = lane; d < D; d += 32) {
        const float x = vr[d];
        float g = coef[0] * upos[d];
        for (int k = 0; k < K; ++k) g += coef[k + 1] * uneg[k * D + d];
        dv[d] = scale * g;
        dpos[d] = scale * (coef[0] * x);
        for (int k = 0; k < K; ++k) dneg[k * D + d] = scale * (coef[k + 1] * x);
      }
    } else {
      for (int d = lane; d < D; d += 32) {
        dv[d] = 0.0f;
        dpos[d] = 0.0f;
        for (int k = 0; k < K; ++k) dneg[k * D + d] = 0.0f;
      }
    }
  }
  if (lane == 0) {
    swl[warp] = wloss;
    swm[warp] = wm;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.0f, ex = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      l += swl[w];
      ex += swm[w];
    }
    loss_part[blockIdx.x] = l;
    ex_part[blockIdx.x] = ex;
  }
}

__global__ void pair_sums(const float* __restrict__ loss_part,
                          const float* __restrict__ ex_part, int nparts,
                          float* __restrict__ loss_out,
                          float* __restrict__ ex_out) {
  reduce_parts(loss_part, ex_part, nparts, loss_out, ex_out);
}

}  // namespace

// loss_part and ex_part are scratch [ceil(C / 8)].
extern "C" cudaError_t mv_pair_offset_grad(const float* v, const float* u,
                                           const float* m, int C, int K,
                                           int D, float scale, float* d_v,
                                           float* d_u, float* loss_part,
                                           float* ex_part, float* loss_out,
                                           float* ex_out,
                                           cudaStream_t stream) {
  const int blocks = C > 0 ? (C + kWarps - 1) / kWarps : 1;
  const size_t smem =
      sizeof(float) * ((size_t)kWarps * (K + 1) + 2 * kWarps);
  cudaError_t err = allow_smem(pair_block, smem);
  if (err != cudaSuccess) return err;
  pair_block<<<blocks, kThreads, smem, stream>>>(v, u, m, C, K, D, scale,
                                                 d_v, d_u, loss_part,
                                                 ex_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pair_sums<<<1, 32, 0, stream>>>(loss_part, ex_part, blocks, loss_out,
                                  ex_out);
  return cudaGetLastError();
}
