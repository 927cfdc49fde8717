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
// Bound on the card: bytes: at `ps` (C = 32768) and local_sgns (C =
// 16384), D = 128, W = 5, K = 5, B = 8: 89 / 45 MB of rows read and
// written once (0.027 / 0.013 ms at 3.35 TB/s) against ~0.4 / 0.2
// GFLOP. One span kernel, then a one-warp launch that sums the blocks'
// loss and pair partials in block order; no atomics, so the result is
// the same on every run. A block owns a span of S centers (a multiple
// of B, so its negative blocks are whole; kernels/sgns.py
// span_geometry: 48 at both paths) and:
//   - stages, with asynchronous copies, the V rows of its centers and of
//     the 2W before them (the halo), the band rows of the positions
//     [c0, c0 + S + 2W), its negatives' rows and its pair mask, once;
//   - forms the positive logits of its centers and of the halo centers'
//     pairs that reach its positions, and the negative logits of its
//     centers: a warp takes 8 centers by 4 offsets (or negatives), its
//     lanes sum the 32 partial dot products of their columns
//     (transpose_sum32) and each lane forms one coefficient;
//   - writes each of its centers' d_v, the d_u of its band positions
//     (the last block: up to C + 2W) and of its negatives once.
// A halo pair is computed by both blocks that need it, the same way, so
// no block waits for another and no row has two writers; the halo
// re-reads (S + 2W) / S = 1.21 of the V and band rows. Two blocks share
// an SM (128 registers a thread), so one stages while the other
// computes. The previous form (a block of B centers, then a second
// launch over every band row re-reading v and the coefficients) spent
// 38% of its time in that second launch (PERF.md §6). The span
// kernel takes ~2.7x its byte bound: a block's rows arrive, it computes,
// then it writes, with a few dependent round trips and barriers between,
// and with 683 / 342 spans of 48 at the two paths' C the card runs only
// two or three waves of such blocks.

#include "w2v_common.cuh"

namespace {

// The layout of one K4 block in shared memory (floats); kernels/sgns.py
// `span_smem` mirrors it.
struct SgnsSpan {
  int NC;   // logits-centers (S + 2W rounded up to tiles of 8)
  int DP;   // shared row stride: D rounded up to 4
  int KS;   // positive coefficient rows: 2W + 1 rounded up to 4
  int OFF;  // column shift of gc and gp, so that (2W + OFF) % 4 == 0
  int GCW, GPW;  // their row widths
  int NN;   // negative rows of the span: S / B * K
  int KN;   // negative coefficient rows: K rounded up to 4
  int SW;   // their row width: S rounded up to 8
  size_t v, u, n, gc, gp, gn, pm, nv, wl, floats;
};

__host__ __device__ inline SgnsSpan sgns_span(int S, int W, int K, int B,
                                              int D, int warps) {
  SgnsSpan s;
  const int W2 = 2 * W;
  s.NC = (S + W2 + 7) / 8 * 8;
  s.DP = (D + 3) / 4 * 4;
  s.KS = (W2 + 1 + 3) / 4 * 4;
  s.OFF = (4 - W2 % 4) % 4;
  s.GCW = (s.NC + s.OFF + 8 + 3) / 4 * 4;
  s.GPW = (s.NC + s.KS + s.OFF + 3) / 4 * 4;
  s.NN = S / B * K;
  s.KN = (K + 3) / 4 * 4;
  s.SW = (S + 7) / 8 * 8;
  s.v = 0;
  s.u = s.v + (size_t)s.NC * s.DP;
  s.n = s.u + (size_t)s.NC * s.DP;
  s.gc = s.n + (size_t)s.NN * s.DP;
  s.gp = s.gc + (size_t)s.KS * s.GCW;
  s.gn = s.gp + (size_t)s.KS * s.GPW;
  s.pm = s.gn + (size_t)s.KN * s.SW;
  s.nv = s.pm + (size_t)s.NC * W2;
  s.wl = s.nv + s.SW;
  s.floats = s.wl + 2 * warps;
  return s;
}

// Shared-memory indices: logits-center ci (center c0 - 2W + ci, V row
// ci), band row r (position c0 + r), span center cs = ci - 2W (center
// c0 + cs); the pair (ci, k) reaches band row ci - 2W + k, k = W + off.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    sgns_span(const float* __restrict__ v, const float* __restrict__ u,
              const float* __restrict__ pmask, int C, int W, int K, int B,
              int D, int S, float scale, float* __restrict__ d_v,
              float* __restrict__ d_u, float* __restrict__ loss_part,
              float* __restrict__ pairs_part) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int NW = blockDim.x >> 5;
  const SgnsSpan s = sgns_span(S, W, K, B, D, NW);
  const int W2 = 2 * W, NC = s.NC, DP = s.DP, NU = s.DP / 4;
  float* sV = smem + s.v;
  float* sU = smem + s.u;
  float* sN = smem + s.n;
  float* gc = smem + s.gc;
  float* gp = smem + s.gp;
  float* gn = smem + s.gn;
  float* spm = smem + s.pm;
  float* snv = smem + s.nv;
  float* swl = smem + s.wl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t c0 = (int64_t)blockIdx.x * S;
  const int64_t cbase = c0 - W2;
  const int64_t P = (int64_t)C + W2;
  const int own_c = (int)(C - c0 < S ? C - c0 : S);  // a multiple of B
  const int own_pos = c0 + S >= C ? (int)(P - c0) : S;
  const int64_t n0 = c0 / B;  // the span's first negative block

  stage_rows<VEC>(sV, NC, D, DP, v, [&](int r) -> const float* {
    const int64_t c = cbase + r;
    return c >= 0 && c < C ? v + c * D : nullptr;
  });
  stage_rows<VEC>(sU, NC, D, DP, u, [&](int r) -> const float* {
    return c0 + r < P ? u + (c0 + r) * D : nullptr;
  });
  stage_rows<VEC>(sN, s.NN, D, DP, u, [&](int r) -> const float* {
    return r < own_c / B * K ? u + (P + n0 * K + r) * D : nullptr;
  });
  for (int i = tid; i < NC * W2; i += blockDim.x) {
    const int64_t c = cbase + i / W2;
    const bool in = c >= 0 && c < C;
    copy_async<false>(spm + i, in ? pmask + cbase * W2 + i : pmask, in);
  }
  copy_commit();
  for (size_t i = tid; i < s.pm - s.gc; i += blockDim.x) gc[i] = 0.0f;
  copy_wait<0>();
  __syncthreads();
  // The valid-pair counts (read by the negatives, after the next
  // barrier).
  float wpairs = 0.0f;
  for (int cs = tid; cs < s.SW; cs += blockDim.x) {
    float n = 0.0f;
    if (cs < own_c)
      for (int j = 0; j < W2; ++j) n += spm[(cs + W2) * W2 + j];
    snv[cs] = n;
    wpairs += n;
  }

  float wloss = 0.0f;
  // Positive logits: tiles of 8 logits-centers by 4 offsets.
  for (int t0 = warp * 8; t0 < NC; t0 += NW * 8) {
    float4 vv[8];
    tile_rows(vv, sV, t0, DP, NU, lane);
    for (int kb = 0; kb < s.KS; kb += 4) {
      float part[32];
      tile_partials(part, sV, t0, sU, t0 - W2 + kb, NC, DP, NU, lane, vv);
      const float x = transpose_sum32(part, lane);
      const int ci = t0 + (lane >> 2), k = kb + (lane & 3);
      const int r = ci - W2 + k;
      float g = 0.0f;
      if (k <= W2 && k != W && r >= 0 && r < NC) {
        const float m = spm[ci * W2 + (k < W ? k : k - 1)];
        if (m != 0.0f) {
          float loss;
          xent_pair(x, 1.0f, loss, g);
          if (ci >= W2 && ci < W2 + S) wloss += loss * m;
          g *= m;
        }
      }
      gc[k * s.GCW + ci + s.OFF] = g;
      gp[k * s.GPW + ci + k + s.OFF] = g;
    }
  }
  __syncthreads();  // snv
  // Negative logits: tiles of 8 span centers by 4 negatives.
  for (int cs0 = warp * 8; cs0 < own_c; cs0 += NW * 8) {
    const bool one = cs0 / B == (cs0 + 7) / B;  // the 8 share a block
    for (int kb = 0; kb < K; kb += 4) {
      float part[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = 0.0f;
      for (int uu_ = lane; uu_ < NU; uu_ += 32) {
        float4 vv[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) vv[t] = ld4(sV, cs0 + W2 + t, DP, uu_);
        if (one) {
          float4 nn[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            nn[q] = kb + q < K ? ld4(sN, cs0 / B * K + kb + q, DP, uu_)
                               : zero4();
#pragma unroll
          for (int t = 0; t < 8; ++t)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              part[t * 4 + q] = dot4(vv[t], nn[q], part[t * 4 + q]);
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int cs = cs0 + t;
              const float4 nr = kb + q < K && cs < own_c
                                    ? ld4(sN, cs / B * K + kb + q, DP, uu_)
                                    : zero4();
              part[t * 4 + q] = dot4(vv[t], nr, part[t * 4 + q]);
            }
        }
      }
      const float x = transpose_sum32(part, lane);
      const int cs = cs0 + (lane >> 2), k = kb + (lane & 3);
      if (k < K && cs < own_c) {
        const float nv = snv[cs];
        float loss, g;
        xent_pair(x, 0.0f, loss, g);
        wloss += loss * nv;
        gn[k * s.SW + cs] = g * nv;
      }
    }
  }
  __syncthreads();

  // d_v of the span's centers: the band (window of band rows sliding
  // with k) and the negatives.
  for (int cs0 = warp * 8; cs0 < own_c; cs0 += NW * 8) {
    const bool one = cs0 / B == (cs0 + 7) / B;
    for (int uu_ = lane; uu_ < NU; uu_ += 32) {
      float4 acc[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) acc[t] = zero4();
      band_window<1>(
          acc, cs0, W,
          [&](int r) { return r < NC ? ld4(sU, r, DP, uu_) : zero4(); },
          [&](int k, float (&g)[8]) {
            load8(gc + k * s.GCW + cs0 + W2 + s.OFF, g);
          });
      for (int k = 0; k < K; ++k) {
        float g[8];
        load8(gn + k * s.SW + cs0, g);
        if (one) {
          const float4 nr = ld4(sN, cs0 / B * K + k, DP, uu_);
#pragma unroll
          for (int t = 0; t < 8; ++t) acc[t] = axpy4(g[t], nr, acc[t]);
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t)
            if (cs0 + t < own_c)
              acc[t] = axpy4(g[t], ld4(sN, (cs0 + t) / B * K + k, DP, uu_),
                             acc[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (cs0 + t < own_c)
          store4<VEC>(d_v + (c0 + cs0 + t) * D, uu_, D, scale, acc[t]);
    }
  }
  // d_u of the span's band positions q: the centers ci = q + 2W - k.
  for (int q0 = warp * 8; q0 < own_pos; q0 += NW * 8) {
    for (int uu_ = lane; uu_ < NU; uu_ += 32) {
      float4 acc[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) acc[t] = zero4();
      band_window<-1>(
          acc, q0 + W2, W,
          [&](int ci) {
            return ci >= 0 && ci < NC ? ld4(sV, ci, DP, uu_) : zero4();
          },
          [&](int k, float (&g)[8]) {
            load8(gp + k * s.GPW + q0 + W2 + s.OFF, g);
          });
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (q0 + t < own_pos)
          store4<VEC>(d_u + (c0 + q0 + t) * D, uu_, D, scale, acc[t]);
    }
  }
  // d_u of the span's negatives: row (block nl, negative k) sums its B
  // centers' coefficients times their V rows, 4 negatives at a time.
  const int nbs = own_c / B;
  for (int item = warp; item < nbs * s.KN / 4; item += NW) {
    const int nl = item / (s.KN / 4), kb = (item - nl * (s.KN / 4)) * 4;
    for (int uu_ = lane; uu_ < NU; uu_ += 32) {
      float4 acc[4] = {zero4(), zero4(), zero4(), zero4()};
      for (int b = 0; b < B; ++b) {
        const int cs = nl * B + b;
        const float4 vr = ld4(sV, cs + W2, DP, uu_);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[q] = axpy4(gn[(kb + q) * s.SW + cs], vr, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (kb + q < K)
          store4<VEC>(d_u + (P + (n0 + nl) * K + kb + q) * D, uu_, D, scale,
                      acc[q]);
    }
  }
  block_sums(wloss, wpairs, swl, loss_part, pairs_part, blockIdx.x);
}

}  // namespace

extern "C" size_t mv_banded_sgns_smem(int S, int W, int K, int B, int D,
                                      int warps) {
  return sizeof(float) * sgns_span(S, W, K, B, D, warps).floats;
}

// S centers a block (a multiple of B; kernels/sgns.py span_geometry) in
// ceil(C / S) blocks of 32 * warps threads; loss_part and pairs_part
// scratch [blocks].
extern "C" cudaError_t mv_banded_sgns_grad(
    const float* v, const float* u, const float* pmask, int C, int W, int K,
    int B, int D, int S, int warps, float scale, float* d_v, float* d_u,
    float* loss_part, float* pairs_part, float* loss_out, float* pairs_out,
    cudaStream_t stream) {
  if (S <= 0 || S % B != 0 || warps <= 0 || 32 * warps > kThreads)
    return cudaErrorInvalidValue;
  const int blocks = (C + S - 1) / S;
  const size_t smem = mv_banded_sgns_smem(S, W, K, B, D, warps);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d_v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d_u) % 16 == 0;
  cudaError_t err;
  if (vec) {
    err = allow_smem(sgns_span<true>, smem);
    if (err != cudaSuccess) return err;
    sgns_span<true><<<blocks, 32 * warps, smem, stream>>>(
        v, u, pmask, C, W, K, B, D, S, scale, d_v, d_u, loss_part,
        pairs_part);
  } else {
    err = allow_smem(sgns_span<false>, smem);
    if (err != cudaSuccess) return err;
    sgns_span<false><<<blocks, 32 * warps, smem, stream>>>(
        v, u, pmask, C, W, K, B, D, S, scale, d_v, d_u, loss_part,
        pairs_part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce_parts(loss_part, pairs_part, blocks, loss_out,
                             pairs_out, stream);
}
