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
// Bound on the card: bytes. Every row a pair names is read once and
// every gradient row is written once. One warp owns one negative block
// and walks its nb pairs in order, writing each pair's input and target
// gradient rows, so no two warps write one row and there are no atomics.
// Per-block loss and count partials are summed by a one-block second
// launch in a fixed order.
//
// The main form (pairlist_ns_reg, K <= 8 and rows of at most 64 float4
// or 128 float columns) keeps a warp's whole state in registers: a lane
// owns U units (a float4 at D = 128, one load a lane a row) of every row;
// the block's K negative rows are loaded once and stay in registers
// beside the K gradient sums (K * U units a lane: 20 floats at K = 5,
// D = 128); the next pair's input and target rows are loaded before the
// current pair's K + 1 dots are reduced (the block's target and center
// ids and masks read once, a lane a pair), and the dots are reduced
// together, their butterflies interleaved, so a pair waits for one
// reduction's latency rather than K + 1 in turn; lane k then forms logit
// k's loss and coefficient. Other shapes take the
// general form (pairlist_ns), which keeps the input vector and the
// negatives' sums in shared memory and walks the dots one by one.

#include "w2v_common.cuh"

namespace {

// ---- the general form: the input vector and the sums in shared memory ----

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

// ---- the main form: the warp's state in registers ----

constexpr int kMaxNeg = 8;  // negatives the register form holds

__device__ __forceinline__ float dotp(float a, float b) { return a * b; }
__device__ __forceinline__ float dotp(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float madd(float s, float a, float acc) {
  return acc + s * a;
}
__device__ __forceinline__ float4 madd(float s, float4 a, float4 acc) {
  return make_float4(acc.x + s * a.x, acc.y + s * a.y, acc.z + s * a.z,
                     acc.w + s * a.w);
}
__device__ __forceinline__ float scl(float s, float a) { return s * a; }
__device__ __forceinline__ float4 scl(float s, float4 a) {
  return make_float4(s * a.x, s * a.y, s * a.z, s * a.w);
}
__device__ __forceinline__ float quot(float a, float d) { return a / d; }
__device__ __forceinline__ float4 quot(float4 a, float d) {
  return make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
}

// Row `row` of a [*, nu]-unit table, this lane's units (zero past nu).
template <typename T, int U>
__device__ __forceinline__ void load_row(const T* __restrict__ table,
                                         int64_t row, int nu, int lane,
                                         T (&out)[U]) {
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = lane + 32 * i;
    out[i] = u < nu ? __ldg(table + row * nu + u) : T{};
  }
}

// The input vector of pair p: its center row (skip-gram), or its window's
// masked mean (CBOW), with the mean's denominator and context flag.
template <typename T, int U>
__device__ __forceinline__ void input_vec(
    const T* __restrict__ ein, const int* __restrict__ in_idx,
    const float* __restrict__ win_mask, int W2, int p, int nu, int lane,
    T (&v)[U], float& denom, float& has_ctx) {
  denom = 1.0f;
  has_ctx = 1.0f;
  if (W2 == 0) {
    load_row<T, U>(ein, in_idx[p], nu, lane, v);
    return;
  }
  const int* widx = in_idx + (int64_t)p * W2;
  const float* wm = win_mask + (int64_t)p * W2;
  float nctx = 0.0f;
#pragma unroll
  for (int i = 0; i < U; ++i) v[i] = T{};
  for (int j = 0; j < W2; ++j) {
    const float mj = wm[j];
    nctx += mj;
    if (mj == 0.0f) continue;
    T row[U];
    load_row<T, U>(ein, widx[j], nu, lane, row);
#pragma unroll
    for (int i = 0; i < U; ++i) v[i] = madd(mj, row[i], v[i]);
  }
  denom = fmaxf(nctx, 1.0f);
  has_ctx = nctx > 0.0f ? 1.0f : 0.0f;
#pragma unroll
  for (int i = 0; i < U; ++i) v[i] = quot(v[i], denom);
}

// KM: the negatives the registers hold (K <= KM).
template <typename T, int U, int KM>
__global__ void __launch_bounds__(256) pairlist_ns_reg(
    const float* __restrict__ ein_f, const float* __restrict__ eout_f,
    const int* __restrict__ in_idx, const float* __restrict__ win_mask,
    int W2, const int* __restrict__ tgt_idx, const int* __restrict__ neg_idx,
    const float* __restrict__ pair_mask, int B, int nb, int K, int D,
    float scale, float* __restrict__ d_in, float* __restrict__ d_out,
    float* __restrict__ loss_part, float* __restrict__ count_part) {
  __shared__ float swl[2 * 8];
  const T* ein = reinterpret_cast<const T*>(ein_f);
  const T* eout = reinterpret_cast<const T*>(eout_f);
  const int nu = D / (int)(sizeof(T) / sizeof(float));  // units a row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int NB = B / nb;
  const int n = blockIdx.x * warps + warp;
  const int rows_in = W2 > 0 ? W2 : 1;
  float wloss = 0.0f, wcount = 0.0f;
  if (n < NB) {
    // The block's negatives and their gradient sums, in registers.
    T neg[KM][U], acc[KM][U];
#pragma unroll
    for (int k = 0; k < KM; ++k) {
#pragma unroll
      for (int i = 0; i < U; ++i) {
        neg[k][i] = T{};
        acc[k][i] = T{};
      }
      if (k < K) load_row<T, U>(eout, neg_idx[(int64_t)n * K + k], nu, lane,
                                neg[k]);
    }
    const int p0 = n * nb;
    // The block's target ids, masks and (skip-gram) centers, a lane a
    // pair, read once: a pair's rows then wait for one load, not two.
    const bool lanes = nb <= 32;
    const int mine = lanes && lane < nb ? p0 + lane : p0;
    const int my_tgt = tgt_idx[mine];
    const float my_mask = pair_mask[mine];
    const int my_in = W2 == 0 ? in_idx[mine] : 0;
    auto tgt_of = [&](int p) {
      return lanes ? __shfl_sync(0xffffffffu, my_tgt, p - p0) : tgt_idx[p];
    };
    auto rows_of = [&](int p, T (&v)[U], T (&t)[U], float& den,
                       float& ctx) {
      const int target = tgt_of(p);
      if (W2 == 0) {
        const int center =
            lanes ? __shfl_sync(0xffffffffu, my_in, p - p0) : in_idx[p];
        load_row<T, U>(ein, center, nu, lane, v);
        den = ctx = 1.0f;
      } else {
        input_vec<T, U>(ein, in_idx, win_mask, W2, p, nu, lane, v, den, ctx);
      }
      load_row<T, U>(eout, target, nu, lane, t);
    };
    T v[U], t[U], vn[U], tn[U];
    float den, ctx, den_n, ctx_n;
    rows_of(p0, vn, tn, den_n, ctx_n);
    for (int p = p0; p < p0 + nb; ++p) {
#pragma unroll
      for (int i = 0; i < U; ++i) {
        v[i] = vn[i];
        t[i] = tn[i];
      }
      den = den_n;
      ctx = ctx_n;
      // The next pair's rows, in flight while this pair's dots reduce.
      if (p + 1 < p0 + nb) rows_of(p + 1, vn, tn, den_n, ctx_n);
      const float m =
          lanes ? __shfl_sync(0xffffffffu, my_mask, p - p0) : pair_mask[p];
      T* din = reinterpret_cast<T*>(d_in) + (int64_t)p * rows_in * nu;
      T* dt = reinterpret_cast<T*>(d_out) + (int64_t)p * nu;
      if (m == 0.0f) {
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const int u = lane + 32 * i;
          if (u >= nu) continue;
          dt[u] = T{};
          for (int j = 0; j < rows_in; ++j) din[j * nu + u] = T{};
        }
        continue;
      }
      wcount += m * ctx;
      // The K + 1 dots, reduced together.
      float dot[KM + 1];
#pragma unroll
      for (int k = 0; k <= KM; ++k) {
        dot[k] = 0.0f;
#pragma unroll
        for (int i = 0; i < U; ++i)
          dot[k] += dotp(v[i], k == 0 ? t[i] : neg[k > 0 ? k - 1 : 0][i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k <= KM; ++k)
          if (k <= K) dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], o);
      }
      // Lane k forms logit k's loss and coefficient; every lane then
      // takes the K + 1 coefficients from those lanes.
      float my_dot = 0.0f;
#pragma unroll
      for (int k = 0; k <= KM; ++k)
        if (lane == k) my_dot = dot[k];
      float my_coef = 0.0f;
      if (lane <= K) {
        const float xc = clip(my_dot);
        const float y = lane == 0 ? 1.0f : 0.0f;
        wloss += xent(xc, y) * m;
        my_coef = xent_grad(xc, y) * clip_grad(my_dot) * m;
      }
      float coef[KM + 1];
#pragma unroll
      for (int k = 0; k <= KM; ++k)
        coef[k] = __shfl_sync(0xffffffffu, my_coef, k);
      // Gradient rows: the input side, the target, the negatives' sums.
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int u = lane + 32 * i;
        T g = scl(coef[0], t[i]);
#pragma unroll
        for (int k = 0; k < KM; ++k) {
          if (k >= K) continue;
          g = madd(coef[k + 1], neg[k][i], g);
          acc[k][i] = madd(coef[k + 1], v[i], acc[k][i]);
        }
        if (u >= nu) continue;
        dt[u] = scl(scale, scl(coef[0], v[i]));
        if (W2 == 0) {
          din[u] = scl(scale, g);
        } else {
          const T gm = quot(g, den);
          const float* wm = win_mask + (int64_t)p * W2;
          for (int j = 0; j < W2; ++j)
            din[j * nu + u] = scl(scale, scl(wm[j], gm));
        }
      }
    }
    T* dn = reinterpret_cast<T*>(d_out) + ((int64_t)B + (int64_t)n * K) * nu;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k >= K) continue;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int u = lane + 32 * i;
        if (u < nu) dn[k * nu + u] = scl(scale, acc[k][i]);
      }
    }
  }
  wloss = warp_sum(wloss);  // lanes 0..K hold the pairs' losses
  if (lane == 0) {
    swl[warp] = wloss;
    swl[8 + warp] = wcount;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.0f, c = 0.0f;
    for (int w = 0; w < warps; ++w) {
      l += swl[w];
      c += swl[8 + w];
    }
    loss_part[blockIdx.x] = l;
    count_part[blockIdx.x] = c;
  }
}

template <typename T, int U>
cudaError_t launch_reg(int blocks, int warps, const float* ein,
                       const float* eout, const int* in_idx,
                       const float* win_mask, int W2, const int* tgt_idx,
                       const int* neg_idx, const float* pair_mask, int B,
                       int nb, int K, int D, float scale, float* d_in,
                       float* d_out, float* loss_part, float* count_part,
                       cudaStream_t stream) {
  if (K <= 5) {
    pairlist_ns_reg<T, U, 5><<<blocks, warps * 32, 0, stream>>>(
        ein, eout, in_idx, win_mask, W2, tgt_idx, neg_idx, pair_mask, B, nb,
        K, D, scale, d_in, d_out, loss_part, count_part);
  } else {
    pairlist_ns_reg<T, U, kMaxNeg><<<blocks, warps * 32, 0, stream>>>(
        ein, eout, in_idx, win_mask, W2, tgt_idx, neg_idx, pair_mask, B, nb,
        K, D, scale, d_in, d_out, loss_part, count_part);
  }
  return cudaGetLastError();
}

__global__ void pairlist_ns_sums(const float* __restrict__ loss_part,
                                 const float* __restrict__ count_part,
                                 int nparts, float* __restrict__ loss_out,
                                 float* __restrict__ count_out) {
  reduce_parts(loss_part, count_part, nparts, loss_out, count_out);
}

}  // namespace

// `warps` warps a block (at most 8 for the register form), one negative
// block each; loss_part and count_part are scratch
// [ceil((B / nb) / warps)].
extern "C" cudaError_t mv_pairlist_ns_grad(
    const float* ein, const float* eout, const int* in_idx,
    const float* win_mask, int W2, const int* tgt_idx, const int* neg_idx,
    const float* pair_mask, int B, int nb, int K, int D, float scale,
    int warps, float* d_in, float* d_out, float* loss_part,
    float* count_part, float* loss_out, float* count_out,
    cudaStream_t stream) {
  const int NB = B / nb;
  const int blocks = NB > 0 ? (NB + warps - 1) / warps : 1;
  // The register form where its registers hold the shape: float4 units
  // on 16-byte aligned rows of D % 4 == 0 floats, else floats; U units a
  // lane.
  const bool vec = D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(ein) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(eout) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d_in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d_out) % 16 == 0;
  const int units = vec ? D / 4 : D;
  const int U = units <= 32 ? 1 : (units <= 64 ? 2 : (!vec && units <= 128 ? 4 : 0));
  cudaError_t err = cudaSuccess;
  if (K <= kMaxNeg && U > 0 && warps <= 8) {
#define MV_K9_REG(T, UU)                                                    \
  launch_reg<T, UU>(blocks, warps, ein, eout, in_idx, win_mask, W2,         \
                    tgt_idx, neg_idx, pair_mask, B, nb, K, D, scale, d_in, \
                    d_out, loss_part, count_part, stream)
    if (vec) {
      err = U == 1 ? MV_K9_REG(float4, 1) : MV_K9_REG(float4, 2);
    } else {
      err = U == 1 ? MV_K9_REG(float, 1)
                   : (U == 2 ? MV_K9_REG(float, 2) : MV_K9_REG(float, 4));
    }
#undef MV_K9_REG
  } else {
    const size_t smem =
        sizeof(float) * ((size_t)warps * (D + K * D + K + 1) + 2 * warps);
    err = allow_smem(pairlist_ns, smem);
    if (err != cudaSuccess) return err;
    pairlist_ns<<<blocks, warps * 32, smem, stream>>>(
        ein, eout, in_idx, win_mask, W2, tgt_idx, neg_idx, pair_mask, B, nb,
        K, D, scale, d_in, d_out, loss_part, count_part);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  pairlist_ns_sums<<<1, 32, 0, stream>>>(loss_part, count_part, blocks,
                                         loss_out, count_out);
  return cudaGetLastError();
}
