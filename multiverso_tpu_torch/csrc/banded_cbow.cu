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
// Bound on the card: bytes. At local_cbow (C = 16384) and ps_cbow (C =
// 32768), D = 128, W = 5, K = 5, B = 8: 45 / 89 MB of rows read and
// written once (0.013 / 0.027 ms at 3.35 TB/s) against ~0.1 / 0.2 GFLOP.
// One span kernel, then a one-warp launch that sums the spans' loss and
// example partials in span order; no float atomics, so the result is
// the same on every run. A block owns a span of S centers (a multiple
// of B, so its negative blocks are whole; kernels/cbow.py
// span_geometry: 24 at B = 8) and:
//   - stages, with 16-byte asynchronous copies, the band rows of its
//     centers' windows [c0, c0 + S + 2W), its centers' output rows, its
//     negatives' rows and the pair mask of its centers and the 2W
//     before them, once;
//   - a warp a center: forms the window mean in registers (offset
//     order), the 1 + K dot products from one transposed sum of N
//     partials a lane (N = 8, 16 or 32, the least that holds 1 + K), the
//     1 + K coefficients one a lane; writes the center's d_out row and
//     keeps its window gradient g_vmean / max(n_c, 1) in shared memory,
//     over its output row;
//   - writes its negatives' d_out rows (each the sum over its block's B
//     centers, in center order) and the d_band rows of its positions,
//     the first 2W from the window gradients that the span before hands
//     over (w2v_common.cuh cbow_publish, cbow_band: it publishes its
//     own last 2W as soon as they are complete), the rest from its own.
// The window gradients never reach HBM beyond the 2W handed over a span.
// The previous form (a block of B centers writing every window gradient
// to a [C, D] scratch, then a second launch over every band row reading
// them and the pair mask back) spent 39-40% of its time in that second
// launch (PERF.md §6).

#include "w2v_common.cuh"

namespace {

// K5's shared memory (floats): the CBOW span's (cbow_span), then the
// span's S / B * K negative rows and its centers' K negative
// coefficients; kernels/cbow.py span_smem mirrors it.
struct NsSpan {
  CbowSpan c;
  size_t neg, gn, floats;
};

__host__ __device__ inline NsSpan ns_span(int S, int W, int K, int B, int D,
                                          int warps) {
  NsSpan s;
  s.c = cbow_span(S, W, D, warps);
  s.neg = s.c.floats;
  s.gn = s.neg + (size_t)(S / B) * K * s.c.DP;
  s.floats = align4(s.gn + (size_t)S * K);
  return s;
}

struct CbowArgs {
  const float* u_band;
  const float* u_out;
  const float* pmask;
  int C, W, K, B, D, S;
  float scale;
  float* d_band;
  float* d_out;
  float* loss_part;
  float* ex_part;
  Handoff h;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) cbow_span_kernel(CbowArgs a) {
  extern __shared__ float4 smem4[];
  __shared__ int s_span;
  float* smem = reinterpret_cast<float*>(smem4);
  const int NW = blockDim.x >> 5;
  const int W = a.W, W2 = 2 * W, K = a.K, B = a.B, D = a.D, S = a.S;
  const NsSpan s = ns_span(S, W, K, B, D, NW);
  const int DP = s.c.DP;
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int NU = (D + kPer - 1) / kPer;
  float* sband = smem + s.c.band;
  float* smean = smem + s.c.mean;
  float* sgacc = smem + s.c.gacc;
  float* sout = sgacc + (size_t)W2 * DP;  // the centers' output rows
  float* spm = smem + s.c.pm;
  float* scnt = smem + s.c.cnt;
  float* swl = smem + s.c.wl;
  float* sneg = smem + s.neg;
  float* sgn = smem + s.gn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = span_ticket(a.h, &s_span);
  const int64_t c0 = (int64_t)span * S;
  const int own_c = (int)(a.C - c0 < S ? a.C - c0 : S);  // a multiple of B
  const int own_pos = span + 1 == (int)gridDim.x ? own_c + W2 : S;
  const int64_t n0 = c0 / B;  // the span's first negative block
  constexpr bool VEC = sizeof(T) == 16;

  stage_cbow<VEC>(sband, spm, a.u_band, a.pmask, c0, own_c, S, a.C, W, D,
                  DP);
  stage_rows<VEC>(sout, S, D, DP, a.u_out, [&](int r) -> const float* {
    return r < own_c ? a.u_out + (c0 + r) * D : nullptr;
  });
  const int nneg = own_c / B * K;
  stage_rows<VEC>(sneg, S / B * K, D, DP, a.u_out, [&](int r) -> const float* {
    return r < nneg ? a.u_out + ((int64_t)a.C + n0 * K + r) * D : nullptr;
  });
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
    const float hc = n > 0.0f ? 1.0f : 0.0f;
    const float* pmr = spm + (W2 + cs) * W2;
    const float* negs = sneg + (size_t)(cs / B) * K * DP;
    float* orow = sout + (size_t)cs * DP;
    float* mrow = smean + (size_t)cs * DP;
    float part[N];
#pragma unroll
    for (int i = 0; i < N; ++i) part[i] = 0.0f;
    for (int u = lane; u < NU; u += 32) {
      const T vm = window_mean_col<T>(sband, pmr, cs, u, W, DP, den);
      store_col(mrow, u, vm);
      part[0] = dot_col(vm, load_col(orow, u, T()), part[0]);
#pragma unroll
      for (int i = 1; i < N; ++i)
        if (i <= K)
          part[i] = dot_col(vm, load_col(negs + (size_t)(i - 1) * DP, u, T()),
                            part[i]);
    }
    const float x = transpose_sum<N>(part, lane);
    float g = 0.0f;
    if (lane <= K) {
      float loss;
      xent_pair(x, lane == 0 ? 1.0f : 0.0f, loss, g);
      wloss += loss * hc;
      g *= hc;
      if (lane > 0) sgn[cs * K + lane - 1] = g;
    }
    if (lane == 0) wex += hc;
    float gk[N];
#pragma unroll
    for (int i = 0; i < N; ++i) gk[i] = __shfl_sync(0xffffffffu, g, i);
    for (int u = lane; u < NU; u += 32) {
      const T vm = load_col(mrow, u, T());
      stcs_col(a.d_out + (c0 + cs) * D, u,
               scale_col(a.scale, scale_col(gk[0], vm)));
      T gv = scale_col(gk[0], load_col(orow, u, T()));
#pragma unroll
      for (int i = 1; i < N; ++i)
        if (i <= K)
          gv = axpy_col(gk[i], load_col(negs + (size_t)(i - 1) * DP, u, T()),
                        gv);
      // The window gradient over the output row (this lane's column).
      store_col(orow, u, div_col(gv, den));
    }
  }
  __syncthreads();
  cbow_publish<T>(a.h, sgacc, span, own_c, W, D, DP);
  // The negatives' d_out rows: row (block nl, negative k) sums its B
  // centers' coefficients times their window means, in center order.
  for (int i = tid; i < nneg * NU; i += blockDim.x) {
    const int row = i / NU, u = i - row * NU;
    const int nl = row / K, k = row - nl * K;
    T acc = zero_col<T>();
    for (int b = 0; b < B; ++b) {
      const int cs = nl * B + b;
      acc = axpy_col(sgn[cs * K + k], load_col(smean + (size_t)cs * DP, u, T()),
                     acc);
    }
    stcs_col(a.d_out + ((int64_t)a.C + n0 * K + row) * D, u,
             scale_col(a.scale, acc));
  }
  cbow_band<T>(a.h, sgacc, spm, span, own_c, own_pos, W, D, DP, a.scale,
               a.d_band, c0);
  block_sums(wloss, wex, swl, a.loss_part, a.ex_part, span);
  span_done(a.h);
}

template <typename T>
cudaError_t launch_cbow(const CbowArgs& a, int blocks, size_t smem,
                        cudaStream_t stream) {
  const int K1 = a.K + 1;
  cudaError_t err;
  if (K1 <= 8) {
    err = allow_smem(cbow_span_kernel<T, 8>, smem);
    if (err != cudaSuccess) return err;
    cbow_span_kernel<T, 8><<<blocks, kThreads, smem, stream>>>(a);
  } else if (K1 <= 16) {
    err = allow_smem(cbow_span_kernel<T, 16>, smem);
    if (err != cudaSuccess) return err;
    cbow_span_kernel<T, 16><<<blocks, kThreads, smem, stream>>>(a);
  } else {
    err = allow_smem(cbow_span_kernel<T, 32>, smem);
    if (err != cudaSuccess) return err;
    cbow_span_kernel<T, 32><<<blocks, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t mv_banded_cbow_smem(int S, int W, int K, int B, int D) {
  return sizeof(float) * ns_span(S, W, K, B, D, kWarps).floats;
}

// S centers a span (a multiple of B, at least 2W unless one span holds
// all C; kernels/cbow.py span_geometry) in ceil(C / S) blocks of 256
// threads. parts: scratch [2 * blocks]; ctr [2] and flags [blocks]:
// zero, left zero; halo: scratch [blocks][2W][D].
extern "C" cudaError_t mv_banded_cbow_grad(
    const float* u_band, const float* u_out, const float* pmask, int C,
    int W, int K, int B, int D, int S, float scale, float* d_band,
    float* d_out, float* loss_part, float* ex_part, unsigned* ctr,
    unsigned* flags, float* halo, float* loss_out, float* ex_out,
    cudaStream_t stream) {
  const int blocks = (C + S - 1) / S;
  if (C <= 0 || S <= 0 || S % B != 0 || K + 1 > 32 ||
      (blocks > 1 && S < 2 * W))
    return cudaErrorInvalidValue;
  const size_t smem = mv_banded_cbow_smem(S, W, K, B, D);
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  const bool vec = D % 4 == 0 && aligned(u_band) && aligned(u_out) &&
                   aligned(d_band) && aligned(d_out) && aligned(halo);
  CbowArgs a{u_band,   u_out,   pmask, C,   W, K, B, D, S, scale, d_band,
             d_out, loss_part, ex_part, Handoff{ctr, flags, halo}};
  cudaError_t err = vec ? launch_cbow<float4>(a, blocks, smem, stream)
                        : launch_cbow<float>(a, blocks, smem, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce_parts(loss_part, ex_part, blocks, loss_out, ex_out,
                             stream);
}
