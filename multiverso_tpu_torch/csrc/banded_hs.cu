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
// Bound on the card: bytes. A masked node (padding past the path's end,
// or a pair outside the shrunk window) contributes exactly zero loss and
// gradient, so its row is not read. At local_hs_sg (C = 8192) and
// ps_hs_sg (C = 32768), L = 22, D = 128, W = 5, ~20% of the path ids
// padding: 177 / 706 MB (every unmasked path row read once, d_bp and d_v
// written once), 0.053 / 0.211 ms at 3.35 TB/s. No atomics, so the
// result is the same on every run.
//
// K6 is one span kernel, then a one-warp launch that sums the blocks'
// loss and pair partials in block order. A block owns S consecutive
// centers and their band positions (kernels/hs.py span_geometry: S =
// 8 NT - 2W for NT tiles of 8 logits-centers) and streams the positions'
// path rows node by node through shared memory with 16-byte asynchronous
// copies, double-buffered. Its first 2W positions also take pairs from
// the 2W centers before the span; the block recomputes those halo pairs
// (as the block before does, in the same order) instead of exchanging
// partial sums, so no block waits for another and no row is summed
// twice. Each path row thus crosses HBM (S + 2W) / S times (1.26 at S =
// 38, the span both paths take): ~198 / ~795 MB moved. The previous form
// (a block a center, reading each path row once for each of its up to
// 2W centers, then a second launch over every path row re-reading the
// coefficients and 2W center rows) split its time evenly between the
// two launches (PERF.md §6). The span kernel takes ~4x its byte
// bound: each block walks the L nodes in turn, and at each its warps run
// chains of dependent shared-memory loads, shuffles and FMAs (the
// logits, d_v and d_bp: ~3 x 2W x D FMAs a center and node) that few
// warps an SM cannot hide; blocks of 6 warps, two an SM (168 registers
// a thread), hide the most of them.
//
// K7 is one span kernel too, then the same one-warp sum: a block owns S
// consecutive centers (kernels/hs.py cbow_span_geometry: 32 at
// local_hs_cbow, 64 at ps_hs_cbow) and their band positions, stages its
// centers' windows' band rows and pair mask once (16-byte asynchronous
// copies), and a warp takes a center: the window mean in registers,
// then the center's own path rows straight from HBM in chunks of 8
// nodes (the 8 loads in flight together; a masked node's row is not
// read, its d_path row is written as zeros), 8 dot products from one
// transposed sum, the d_path rows written once and the window gradient
// kept in shared memory. At local_hs_cbow and ps_hs_cbow (C = 8192,
// 32768) its bound is 176 / 706 MB (each unmasked path row read once,
// every d_path row written once, the band rows), 0.053 / 0.211 ms at
// 3.35 TB/s. Each path row crosses HBM once: no halo is
// recomputed (K6's would re-read 2W paths a span); the first 2W band
// positions take the 2W window gradients of the span before by the
// handoff of w2v_common.cuh (cbow_publish, cbow_band). The previous form (a block a
// center, one warp a node over a 128-float row, the window gradients
// through a [C, D] scratch and a second launch, the band pass, 18-23% of
// the time) ran at 2.2-2.4x its bound; this one at 1.3-1.5x (PERF.md
// §6).

#include "w2v_common.cuh"

namespace {

// ---- K6: the span kernel ----

// The layout of one span block in shared memory (floats), for S centers
// a block, window W, rows of D floats and L nodes; kernels/hs.py
// `span_smem` mirrors it.
struct HsSpan {
  int NC;   // logits-centers a block (its halo included) = U rows staged
  int DP;   // shared row stride: D rounded up to 4 (the padding zero)
  int KS;   // coefficient rows: 2W + 1 offsets rounded up to 4
  int OFF;  // gp's column shift, so that (2W + OFF) % 4 == 0
  int GPW;  // gp's row width
  size_t v, u, acc, gc, gp, pm, wl, code, floats;  // offsets, total
};

__host__ __device__ inline HsSpan hs_span(int S, int W, int D, int L,
                                          int warps) {
  HsSpan s;
  const int W2 = 2 * W;
  s.NC = (S + W2 + 7) / 8 * 8;
  s.DP = (D + 3) / 4 * 4;
  s.KS = (W2 + 1 + 3) / 4 * 4;
  s.OFF = (4 - W2 % 4) % 4;
  s.GPW = (s.NC + s.KS + s.OFF + 3) / 4 * 4;
  s.v = 0;
  s.u = s.v + (size_t)s.NC * s.DP;          // two node buffers
  s.acc = s.u + 2 * (size_t)s.NC * s.DP;
  s.gc = s.acc + (size_t)s.NC * s.DP;
  s.gp = s.gc + (size_t)s.KS * s.NC;        // two node buffers
  s.pm = s.gp + 2 * (size_t)s.KS * s.GPW;
  s.wl = s.pm + (size_t)s.NC * W2;
  s.code = s.wl + 2 * warps;                // ints [NC][L]
  s.floats = s.code + (size_t)s.NC * L;
  return s;
}

// One block: the centers [c0, c0 + S) and their d_v, and the band
// positions [c0, c0 + S) (the last block: up to C + 2W) and their d_bp
// at every node. Shared memory holds the V rows of the logits-centers
// [c0 - 2W, c0 - 2W + NC) (the owned ones and a halo of 2W before them,
// whose pairs reach the owned positions), the codes of the positions
// [c0, c0 + NC) at every node (-1 where the node is masked), their path
// rows at two nodes (node l + 2 streams in while node l + 1 is
// computed), the d_v accumulators, and the coefficients g of a node in
// two layouts: gc[k][ci] by center for d_v, gp[k][ci + k + OFF] by
// position for d_bp (k = p - c in [0, 2W], k = W the center itself; gp
// for two nodes). Each warp owns tiles of 8 logits-centers: for 4
// offsets at a time its lanes sum the 32 partial dot products of their
// columns (transpose_sum32), each lane then forms one pair's
// coefficient; d_v is accumulated over the nodes in offset order with a
// window of U rows sliding with k, d_bp over k with a window of V rows
// (band_window). One barrier a node: between node l's coefficients and
// its d_bp, which then runs beside node l + 1's coefficients. A halo
// pair is computed by both blocks that need it, in the same order, so no
// block waits for another and nothing is added twice.
// At most 168 registers a thread: two blocks of 6 warps (or three of
// 4) fit an SM's 65,536 (kernels/hs.py WARPS_PER_SM = 12).
template <bool VEC>
__global__ void __maxnreg__(168)
    hs_sg_span(const float* __restrict__ v, const float* __restrict__ u_bp,
               const int* __restrict__ path_band,
               const int* __restrict__ code_band,
               const float* __restrict__ pmask, int C, int W, int L, int D,
               int S, float scale, float* __restrict__ d_v,
               float* __restrict__ d_bp, float* __restrict__ loss_part,
               float* __restrict__ pairs_part) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int NW = blockDim.x >> 5;
  const HsSpan s = hs_span(S, W, D, L, NW);
  const int W2 = 2 * W, NC = s.NC, DP = s.DP, NU = s.DP / 4;
  const size_t GPN = (size_t)s.KS * s.GPW;  // gp floats a node
  float* sV = smem + s.v;
  float* sU = smem + s.u;
  float* sacc = smem + s.acc;
  float* gc = smem + s.gc;
  float* gp = smem + s.gp;
  float* spm = smem + s.pm;
  float* swl = smem + s.wl;
  int* scode = reinterpret_cast<int*>(smem + s.code);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t c0 = (int64_t)blockIdx.x * S;
  const int64_t cbase = c0 - W2;  // the center of V row 0
  const int64_t P = (int64_t)C + W2;
  const int own_pos = c0 + S >= C ? (int)(P - c0) : S;

  // The positions' codes at every node: rows [c0, c0 + NC) of the
  // [P, L] path and code arrays are contiguous.
  for (int i = tid; i < NC * L; i += blockDim.x) {
    const int64_t j = c0 * L + i;
    const bool in = c0 + i / L < P;
    const int node = in ? path_band[j] : -1, cd = in ? code_band[j] : -1;
    scode[i] = node >= 0 && cd >= 0 ? cd : -1;
  }
  __syncthreads();
  stage_rows<VEC>(sV, NC, D, DP, v, [&](int r) -> const float* {
    const int64_t c = cbase + r;
    return c >= 0 && c < C ? v + c * D : nullptr;
  });
  // Node l's unmasked path rows into buffer b; a masked row reads
  // nothing.
  auto stage_node = [&](int l, int b) {
    stage_rows<VEC>(sU + (size_t)b * NC * DP, NC, D, DP, u_bp,
                    [&](int r) -> const float* {
                      return scode[r * L + l] >= 0
                                 ? u_bp + ((c0 + r) * L + l) * D
                                 : nullptr;
                    });
    copy_commit();
  };
  stage_node(0, 0);
  if (L > 1) stage_node(1, 1);
  for (int i = tid; i < NC * W2; i += blockDim.x) {
    const int64_t c = cbase + i / W2;
    spm[i] = c >= 0 && c < C ? pmask[cbase * W2 + i] : 0.0f;
  }
  for (int i = tid; i < NC * DP; i += blockDim.x) sacc[i] = 0.0f;
  for (size_t i = tid; i < s.pm - s.gc; i += blockDim.x) gc[i] = 0.0f;
  if (L > 1) {
    copy_wait<1>();
  } else {
    copy_wait<0>();
  }
  __syncthreads();

  float wloss = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int b = l & 1;
    const float* U = sU + (size_t)b * NC * DP;
    float* gpl = gp + b * GPN;
    // Node l: logits and coefficients, then d_v, tile by tile.
    for (int t0 = warp * 8; t0 < NC; t0 += NW * 8) {
      float4 vv[8];
      tile_rows(vv, sV, t0, DP, NU, lane);
      for (int kb = 0; kb < s.KS; kb += 4) {
        float part[32];
        tile_partials(part, sV, t0, U, t0 - W2 + kb, NC, DP, NU, lane, vv);
        const float x = transpose_sum32(part, lane);
        const int ci = t0 + (lane >> 2), k = kb + (lane & 3);
        const int qi = ci - W2 + k;
        float g = 0.0f;
        if (k <= W2 && k != W && qi >= 0 && qi < NC) {
          const int cd = scode[qi * L + l];
          const float mask =
              (cd >= 0 ? 1.0f : 0.0f) * spm[ci * W2 + (k < W ? k : k - 1)];
          if (mask != 0.0f) {
            float loss;
            xent_pair(x, (1.0f - (float)cd) * mask, loss, g);
            if (ci >= W2 && ci < W2 + S) wloss += loss * mask;
            g *= mask;
          }
        }
        gc[k * NC + ci] = g;
        gpl[k * s.GPW + ci + k + s.OFF] = g;
      }
      __syncwarp();
      for (int u = lane; u < NU; u += 32) {
        float4 acc[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[t] = ld4(sacc, t0 + t, DP, u);
        band_window<1>(
            acc, t0 - W2, W,
            [&](int r) {
              return r >= 0 && r < NC ? ld4(U, r, DP, u) : zero4();
            },
            [&](int k, float (&g)[8]) { load8(gc + k * NC + t0, g); });
#pragma unroll
        for (int t = 0; t < 8; ++t)
          reinterpret_cast<float4*>(sacc + (size_t)(t0 + t) * DP)[u] = acc[t];
      }
      __syncwarp();
    }
    // Node l + 1's rows have landed (issued a node ago), node l's
    // coefficients are complete and its buffer is free.
    copy_wait<0>();
    __syncthreads();
    if (l + 2 < L) stage_node(l + 2, b);
    // d_bp of the owned positions q = p - c0 at node l: the pairs of
    // the centers ci = q + 2W - k, k = 0..2W.
    for (int q0 = warp * 8; q0 < own_pos; q0 += NW * 8) {
      for (int u = lane; u < NU; u += 32) {
        float4 acc[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[t] = zero4();
        band_window<-1>(
            acc, q0 + W2, W,
            [&](int ci) {
              return ci >= 0 && ci < NC ? ld4(sV, ci, DP, u) : zero4();
            },
            [&](int k, float (&g)[8]) {
              load8(gpl + k * s.GPW + q0 + W2 + s.OFF, g);
            });
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (q0 + t < own_pos)
            store4<VEC>(d_bp + ((c0 + q0 + t) * L + l) * D, u, D, scale,
                        acc[t]);
        }
      }
    }
  }
  __syncthreads();
  // d_v of the owned centers.
  for (int i = tid; i < S * NU; i += blockDim.x) {
    const int r = i / NU, u = i - r * NU;
    const int64_t c = c0 + r;
    if (c < C) store4<VEC>(d_v + c * D, u, D, scale, ld4(sacc, W2 + r, DP, u));
  }
  float wpairs = 0.0f;
  for (int i = tid; i < S * W2; i += blockDim.x) wpairs += spm[W2 * W2 + i];
  block_sums(wloss, wpairs, swl, loss_part, pairs_part, blockIdx.x);
}

// ---- K7: the CBOW span kernel ----

struct HsCbowArgs {
  const float* u_band;
  const float* u_path;
  const int* path;
  const int* code;
  const float* pmask;
  int C, W, L, D, S;
  float scale;
  float* d_band;
  float* d_path;
  float* loss_part;
  float* ex_part;
  Handoff h;
};

// A warp a center: its window mean (offset order) into smean, then its
// path in chunks of 8 nodes: the chunk's unmasked rows are loaded (a
// lane's columns, all 8 loads in flight before the first use; a masked
// node reads nothing), 8 dot products come out of one transposed sum,
// lane i forms node i's coefficient, and the chunk's d_path rows are
// written (zeros for masked nodes) and its rows added into the center's
// window gradient, in node order. ONE: a lane owns one column (D <= 128
// in float4s, <= 32 in floats), so the rows stay in registers between
// the dot products and the gradient; otherwise they are read again.
template <typename T, bool ONE>
__global__ void __launch_bounds__(kThreads)
    hs_cbow_span(HsCbowArgs a) {
  extern __shared__ float4 smem4[];
  __shared__ int s_span;
  float* smem = reinterpret_cast<float*>(smem4);
  const int NW = blockDim.x >> 5;
  const int W = a.W, W2 = 2 * W, L = a.L, D = a.D, S = a.S;
  const CbowSpan s = cbow_span(S, W, D, NW);
  const int DP = s.DP;
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int NU = (D + kPer - 1) / kPer;
  float* sband = smem + s.band;
  float* smean = smem + s.mean;
  float* sgacc = smem + s.gacc;
  float* spm = smem + s.pm;
  float* scnt = smem + s.cnt;
  float* swl = smem + s.wl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = span_ticket(a.h, &s_span);
  const int64_t c0 = (int64_t)span * S;
  const int own_c = (int)(a.C - c0 < S ? a.C - c0 : S);
  const int own_pos = span + 1 == (int)gridDim.x ? own_c + W2 : S;

  stage_cbow<sizeof(T) == 16>(sband, spm, a.u_band, a.pmask, c0, own_c, S,
                              a.C, W, D, DP);
  copy_commit();
  copy_wait<0>();
  __syncthreads();
  for (int cs = tid; cs < S; cs += blockDim.x) {
    float n = 0.0f;
    if (cs < own_c)
      for (int j = 0; j < W2; ++j) n += spm[(W2 + cs) * W2 + j];
    scnt[cs] = n;
  }
  __syncthreads();

  float wloss = 0.0f, wex = 0.0f;
  for (int cs = warp; cs < own_c; cs += NW) {
    const float n = scnt[cs], den = fmaxf(n, 1.0f);
    const bool ctx = n > 0.0f;
    const float* pmr = spm + (W2 + cs) * W2;
    float* mrow = smean + (size_t)cs * DP;
    float* grow = sgacc + (size_t)(W2 + cs) * DP;
    T vm1 = zero_col<T>(), ga1 = zero_col<T>();
    for (int u = lane; u < NU; u += 32) {
      const T vm = window_mean_col<T>(sband, pmr, cs, u, W, DP, den);
      if (ONE) {
        vm1 = vm;
      } else {
        store_col(mrow, u, vm);
        store_col(grow, u, zero_col<T>());
      }
    }
    if (lane == 0 && ctx) wex += 1.0f;
    const int64_t prow = (c0 + cs) * L;  // the center's first path row
    for (int l0 = 0; l0 < L; l0 += 8) {
      const int nch = L - l0 < 8 ? L - l0 : 8;
      int cd = -1;
      bool ok = false;
      if (lane < nch) {
        const int node = __ldg(a.path + prow + l0 + lane);
        cd = __ldg(a.code + prow + l0 + lane);
        ok = ctx && node >= 0 && cd >= 0;
      }
      const unsigned bits = __ballot_sync(0xffffffffu, ok);
      const float* rows = a.u_path + (prow + l0) * D;
      float part[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) part[i] = 0.0f;
      T r1[8];
      for (int u = lane; u < NU; u += 32) {
        T r[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          r[i] = (bits >> i) & 1u ? ldg_col(rows + (size_t)i * D, u, T())
                                  : zero_col<T>();
        const T vm = ONE ? vm1 : load_col(mrow, u, T());
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          part[i] = dot_col(vm, r[i], part[i]);
          if (ONE) r1[i] = r[i];
        }
      }
      const float x = transpose_sum<8>(part, lane);
      float g = 0.0f;
      if (ok) {
        float loss;
        xent_pair(x, 1.0f - (float)cd, loss, g);
        wloss += loss;
      }
      float gk[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) gk[i] = __shfl_sync(0xffffffffu, g, i);
      for (int u = lane; u < NU; u += 32) {
        const T vm = ONE ? vm1 : load_col(mrow, u, T());
        T ga = ONE ? ga1 : load_col(grow, u, T());
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i >= nch) break;
          float* dst = a.d_path + (prow + l0 + i) * D;
          if ((bits >> i) & 1u) {
            stcs_col(dst, u, scale_col(a.scale, scale_col(gk[i], vm)));
            ga = axpy_col(gk[i],
                          ONE ? r1[i] : ldg_col(rows + (size_t)i * D, u, T()),
                          ga);
          } else {
            stcs_col(dst, u, zero_col<T>());
          }
        }
        if (ONE) {
          ga1 = ga;
        } else {
          store_col(grow, u, ga);
        }
      }
    }
    for (int u = lane; u < NU; u += 32)
      store_col(grow, u, div_col(ONE ? ga1 : load_col(grow, u, T()), den));
  }
  __syncthreads();
  cbow_publish<T>(a.h, sgacc, span, own_c, W, D, DP);
  cbow_band<T>(a.h, sgacc, spm, span, own_c, own_pos, W, D, DP, a.scale,
               a.d_band, c0);
  block_sums(wloss, wex, swl, a.loss_part, a.ex_part, span);
  span_done(a.h);
}

template <typename T, bool ONE>
cudaError_t launch_hs_cbow(const HsCbowArgs& a, int blocks, size_t smem,
                           cudaStream_t stream) {
  cudaError_t err = allow_smem(hs_cbow_span<T, ONE>, smem);
  if (err != cudaSuccess) return err;
  hs_cbow_span<T, ONE><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t mv_hs_cbow_smem(int S, int W, int D) {
  return sizeof(float) * cbow_span(S, W, D, kWarps).floats;
}

extern "C" size_t mv_hs_span_smem(int S, int W, int D, int L, int warps) {
  return sizeof(float) * hs_span(S, W, D, L, warps).floats;
}

// S centers a block (kernels/hs.py span_geometry) in ceil(C / S) blocks
// of 32 * warps threads; loss_part and pairs_part scratch [blocks].
extern "C" cudaError_t mv_banded_hs_sg_grad(
    const float* v, const float* u_bp, const int* path_band,
    const int* code_band, const float* pmask, int C, int W, int L, int D,
    int S, int warps, float scale, float* d_v, float* d_bp,
    float* loss_part, float* pairs_part, float* loss_out, float* pairs_out,
    cudaStream_t stream) {
  if (S <= 0 || warps <= 0 || 32 * warps > kThreads) return cudaErrorInvalidValue;
  const int blocks = (C + S - 1) / S;
  const size_t smem = mv_hs_span_smem(S, W, D, L, warps);
  const bool vec = D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(u_bp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d_v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d_bp) % 16 == 0;
  cudaError_t err;
  if (vec) {
    err = allow_smem(hs_sg_span<true>, smem);
    if (err != cudaSuccess) return err;
    hs_sg_span<true><<<blocks, 32 * warps, smem, stream>>>(
        v, u_bp, path_band, code_band, pmask, C, W, L, D, S, scale, d_v,
        d_bp, loss_part, pairs_part);
  } else {
    err = allow_smem(hs_sg_span<false>, smem);
    if (err != cudaSuccess) return err;
    hs_sg_span<false><<<blocks, 32 * warps, smem, stream>>>(
        v, u_bp, path_band, code_band, pmask, C, W, L, D, S, scale, d_v,
        d_bp, loss_part, pairs_part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce_parts(loss_part, pairs_part, blocks, loss_out,
                             pairs_out, stream);
}

// S centers a span (at least 2W unless one span holds all C;
// kernels/hs.py cbow_span_geometry) in ceil(C / S) blocks of 256
// threads. parts: scratch [2 * blocks]; ctr [2] and flags [blocks]:
// zero, left zero; halo: scratch [blocks][2W][D].
extern "C" cudaError_t mv_hs_cbow_grad(
    const float* u_band, const float* u_path, const int* path,
    const int* code, const float* pmask, int C, int W, int L, int D, int S,
    float scale, float* d_band, float* d_path, float* loss_part,
    float* ex_part, unsigned* ctr, unsigned* flags, float* halo,
    float* loss_out, float* ex_out, cudaStream_t stream) {
  const int blocks = (C + S - 1) / S;
  if (C <= 0 || S <= 0 || (blocks > 1 && S < 2 * W))
    return cudaErrorInvalidValue;
  const size_t smem = mv_hs_cbow_smem(S, W, D);
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  const bool vec = D % 4 == 0 && aligned(u_band) && aligned(u_path) &&
                   aligned(d_band) && aligned(d_path) && aligned(halo);
  HsCbowArgs a{u_band, u_path,    path,    code,
               pmask,  C,         W,       L,
               D,      S,         scale,   d_band,
               d_path, loss_part, ex_part, Handoff{ctr, flags, halo}};
  cudaError_t err;
  if (vec) {
    err = D <= 128 ? launch_hs_cbow<float4, true>(a, blocks, smem, stream)
                   : launch_hs_cbow<float4, false>(a, blocks, smem, stream);
  } else {
    err = D <= 32 ? launch_hs_cbow<float, true>(a, blocks, smem, stream)
                  : launch_hs_cbow<float, false>(a, blocks, smem, stream);
  }
  if (err != cudaSuccess) return err;
  return launch_reduce_parts(loss_part, ex_part, blocks, loss_out, ex_out,
                             stream);
}
