// Device pieces shared by the word2vec step kernels (K4-K8): the clipped
// sigmoid cross-entropy with its gradient formed as JAX's autodiff forms
// it, warp sums, the pieces of the span kernels (K4-K7): asynchronous
// row copies into shared memory and the warp's transposed sums, a
// lane's float4 or float columns (K5, K7, K8), and the CBOW spans' (K5,
// K7) window means, band gradients and their handoff of the halo's
// window gradients from one span to the next.
// The plain PyTorch versions carry the same functions in
// multiverso_tpu_torch/kernels/objective.py.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMaxExp = 6.0f;

// Window offset of pair-mask column j: -W..-1, 1..W.
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

// The loss and the gradient of one clipped logit x at label y, as xent
// and xent_grad (times clip_grad) form them, sharing exp(-|clip(x)|).
__device__ __forceinline__ void xent_pair(float x, float y, float& loss,
                                          float& grad) {
  const float xc = clip(x);
  const float e = expf(-fabsf(xc));
  loss = fmaxf(xc, 0.0f) - xc * y + log1pf(e);
  const float relu = xc > 0.0f ? 1.0f : (xc == 0.0f ? 0.5f : 0.0f);
  const float sgn = xc >= 0.0f ? 1.0f : -1.0f;
  grad = (relu - y - sgn * (e / (1.0f + e))) * clip_grad(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Fixed-order sums of two per-block partial arrays by one warp (the
// result is the same on every run).
__device__ __forceinline__ void reduce_parts(const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             int n, float* __restrict__ a_out,
                                             float* __restrict__ b_out) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  float sa = 0.0f, sb = 0.0f;
  for (int i = lane; i < n; i += 32) {
    sa += a[i];
    if (b != nullptr) sb += b[i];
  }
  sa = warp_sum(sa);
  sb = warp_sum(sb);
  if (lane == 0) {
    a_out[0] = sa;
    if (b_out != nullptr) b_out[0] = sb;
  }
}

// The loss and pair partial sums of every block, summed in block order
// by one warp: a launch of its own after a span kernel.
__global__ void reduce_parts_kernel(const float* __restrict__ loss_part,
                                    const float* __restrict__ count_part,
                                    int nparts, float* __restrict__ loss_out,
                                    float* __restrict__ count_out) {
  reduce_parts(loss_part, count_part, nparts, loss_out, count_out);
}

inline cudaError_t launch_reduce_parts(const float* loss_part,
                                       const float* count_part, int nparts,
                                       float* loss_out, float* count_out,
                                       cudaStream_t stream) {
  reduce_parts_kernel<<<1, 32, 0, stream>>>(loss_part, count_part, nparts,
                                            loss_out, count_out);
  return cudaGetLastError();
}

// ---- the span kernels (K4, K6) ----

// A span block's loss and pair count: each thread's partial sums summed
// over the warp, then the warps in order, into slot `slot` of the parts
// (the span's; swl: 2 floats a warp); the same order on every run.
__device__ __forceinline__ void block_sums(float wloss, float wpairs,
                                           float* swl, float* loss_part,
                                           float* pairs_part, int slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  wloss = warp_sum(wloss);
  wpairs = warp_sum(wpairs);
  if (lane == 0) {
    swl[2 * warp] = wloss;
    swl[2 * warp + 1] = wpairs;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.0f, p = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      l += swl[2 * w];
      p += swl[2 * w + 1];
    }
    loss_part[slot] = l;
    pairs_part[slot] = p;
  }
}

// 16 bytes (VEC: one float4) or 4 bytes from global to shared memory,
// asynchronously; `valid` false writes zeros and reads nothing.
template <bool VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? (VEC ? 16 : 4) : 0;
  if (VEC) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes));
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [0, n) into shared rows of `dp` floats (d rounded up to 4; the
// padding zero), by all the block's threads: row i from src_row(i), a
// row of d floats in global memory, or zeros where src_row returns null
// (then `any`, a valid global address, stands in and is not read).
template <bool VEC, typename RowOf>
__device__ __forceinline__ void stage_rows(float* dst, int n, int d, int dp,
                                           const float* any, RowOf src_row) {
  const int per = VEC ? dp / 4 : dp;  // copies a row
  for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
    const int r = i / per;
    const int col = (i - r * per) * (VEC ? 4 : 1);
    const float* row = src_row(r);
    const bool valid = row != nullptr && col < d;
    copy_async<VEC>(dst + r * dp + col, valid ? row + col : any, valid);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float g, float4 x, float4 acc) {
  return make_float4(fmaf(g, x.x, acc.x), fmaf(g, x.y, acc.y),
                     fmaf(g, x.z, acc.z), fmaf(g, x.w, acc.w));
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// Float4 u of shared row `row` (rows `dp` floats apart).
__device__ __forceinline__ float4 ld4(const float* base, int row, int dp,
                                      int u) {
  return reinterpret_cast<const float4*>(base + (size_t)row * dp)[u];
}

// Columns 4u..4u+3 of a global row of D floats: s * x (VEC: the row is
// 16-byte aligned and D % 4 == 0; otherwise the columns < D one by one).
template <bool VEC>
__device__ __forceinline__ void store4(float* row, int u, int D, float s,
                                       float4 x) {
  // Streaming stores: a gradient row is written once and not read back
  // by this kernel, so it should not evict the rows still to be read.
  const int c = 4 * u;
  if (VEC) {
    __stcs(reinterpret_cast<float4*>(row) + u,
           make_float4(s * x.x, s * x.y, s * x.z, s * x.w));
  } else {
    if (c < D) __stcs(row + c, s * x.x);
    if (c + 1 < D) __stcs(row + c + 1, s * x.y);
    if (c + 2 < D) __stcs(row + c + 2, s * x.z);
    if (c + 3 < D) __stcs(row + c + 3, s * x.w);
  }
}

// The 8 coefficients at g[0:8] of shared memory (16-byte aligned).
__device__ __forceinline__ void load8(const float* g, float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(g);
  const float4 b = *reinterpret_cast<const float4*>(g + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// acc[t] += sum over k in [0, 2W], k != W, of coef(k)[t] * row(first +
// t + DIR * k), t = 0..7: the rows of 8 consecutive centers (DIR = 1)
// or positions (DIR = -1) against the 2W window offsets, in k order.
// The 8 rows in use live in a ring of registers indexed by (t + DIR * k)
// mod 8: a step loads one new row, and unrolling k by 8 makes every
// ring index a constant, so no register is moved. row_at(r) is a float4
// of shared row r (zero out of range); coef_at(k, g) loads the 8
// coefficients of offset k.
template <int DIR, typename RowAt, typename CoefAt>
__device__ __forceinline__ void band_window(float4 (&acc)[8], int first,
                                            int W, RowAt row_at,
                                            CoefAt coef_at) {
  const int W2 = 2 * W;
  float4 win[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) win[s] = row_at(first + s);
  for (int k0 = 0; k0 <= W2; k0 += 8) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int k = k0 + kk;
      if (k > W2) break;
      if (k != W) {
        float g[8];
        coef_at(k, g);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          acc[t] = axpy4(g[t], win[(t + DIR * kk + 8) & 7], acc[t]);
      }
      if (k < W2) {
        if (DIR > 0) {
          win[kk] = row_at(first + k + 8);
        } else {
          win[(7 - kk) & 7] = row_at(first - k - 1);
        }
      }
    }
  }
}

// The 32 partial dot products of a warp's tile: V rows v0 + t (t < 8)
// against the rows u0 + t + q (q < 4) of U, over this lane's float4
// columns, lanes on columns (u = lane, lane + 32, ...). Rows of U outside
// [0, nu_rows) count as zero. Where a lane has one column (NU <= 32) the
// caller passes its V columns in vv and they are not reloaded.
__device__ __forceinline__ void tile_partials(float (&part)[32],
                                              const float* sV, int v0,
                                              const float* U, int u0,
                                              int nu_rows, int DP, int NU,
                                              int lane,
                                              const float4 (&vv1)[8]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.0f;
  for (int u = lane; u < NU; u += 32) {
    float4 vv[8], uu[11];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      vv[t] = NU <= 32 ? vv1[t] : ld4(sV, v0 + t, DP, u);
#pragma unroll
    for (int i = 0; i < 11; ++i) {
      const int r = u0 + i;
      uu[i] = r >= 0 && r < nu_rows ? ld4(U, r, DP, u) : zero4();
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        part[t * 4 + q] = dot4(vv[t], uu[t + q], part[t * 4 + q]);
  }
}

// This lane's float4 column of the V rows v0 .. v0 + 7 where a lane has
// one column (NU <= 32), for tile_partials; zeros otherwise.
__device__ __forceinline__ void tile_rows(float4 (&vv)[8], const float* sV,
                                          int v0, int DP, int NU, int lane) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
    vv[t] = NU <= 32 && lane < NU ? ld4(sV, v0 + t, DP, lane) : zero4();
}

// One halving step of transpose_sum32: lanes exchange half of their N
// partial sums with the lane N/2 away and keep the other half, summed.
template <int N>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  constexpr int H = N / 2;
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// 32 per-lane partial sums summed over the warp's 32 lanes: lane i ends
// with the total of v[i]. Halving exchanges (16 + 8 + 4 + 2 + 1 = 31
// shuffles instead of 32 x 5), in a fixed order.
__device__ __forceinline__ float transpose_sum32(float (&v)[32], int lane) {
  halve<32>(v, lane);
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  return v[0];
}

// ---- a lane's columns (K5, K7, K8) ----

// The float4 or float columns a lane owns, in global or shared memory
// (plain loads: K8's in-place form writes its rows in the same launch).
__device__ __forceinline__ float4 load_col(const float* row, int u, float4) {
  return reinterpret_cast<const float4*>(row)[u];
}
__device__ __forceinline__ float load_col(const float* row, int u, float) {
  return row[u];
}
__device__ __forceinline__ float dot_col(float4 a, float4 b, float acc) {
  return dot4(a, b, acc);
}
__device__ __forceinline__ float dot_col(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ float4 axpy_col(float g, float4 x, float4 acc) {
  return axpy4(g, x, acc);
}
__device__ __forceinline__ float axpy_col(float g, float x, float acc) {
  return fmaf(g, x, acc);
}
__device__ __forceinline__ float4 scale_col(float s, float4 x) {
  return make_float4(__fmul_rn(s, x.x), __fmul_rn(s, x.y), __fmul_rn(s, x.z),
                     __fmul_rn(s, x.w));
}
__device__ __forceinline__ float scale_col(float s, float x) {
  return __fmul_rn(s, x);
}
__device__ __forceinline__ float4 add_col(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float add_col(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ void store_col(float* row, int u, float4 x) {
  reinterpret_cast<float4*>(row)[u] = x;
}
__device__ __forceinline__ void store_col(float* row, int u, float x) {
  row[u] = x;
}
template <typename T>
__device__ __forceinline__ T zero_col();
template <>
__device__ __forceinline__ float4 zero_col<float4>() {
  return zero4();
}
template <>
__device__ __forceinline__ float zero_col<float>() {
  return 0.0f;
}

// One halving step: lanes H apart swap halves of their first 2H sums.
template <int N, int H>
__device__ __forceinline__ void halve_n(float (&v)[N], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// N per-lane partial sums over the warp: lane l ends with the total of
// v[l % N] (log2 N halvings, then a sum over the lane groups).
template <int N>
__device__ __forceinline__ float transpose_sum(float (&v)[N], int lane) {
  if constexpr (N >= 32) halve_n<N, 16>(v, lane);
  if constexpr (N >= 16) halve_n<N, 8>(v, lane);
  halve_n<N, 4>(v, lane);
  halve_n<N, 2>(v, lane);
  halve_n<N, 1>(v, lane);
  float x = v[0];
  for (int o = N; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float4 div_col(float4 x, float d) {
  return make_float4(__fdiv_rn(x.x, d), __fdiv_rn(x.y, d), __fdiv_rn(x.z, d),
                     __fdiv_rn(x.w, d));
}
__device__ __forceinline__ float div_col(float x, float d) {
  return __fdiv_rn(x, d);
}
// A read-only global row's column (through the non-coherent cache).
__device__ __forceinline__ float4 ldg_col(const float* row, int u, float4) {
  return __ldg(reinterpret_cast<const float4*>(row) + u);
}
__device__ __forceinline__ float ldg_col(const float* row, int u, float) {
  return __ldg(row + u);
}
// A streaming store: a gradient row is written once and not read back.
__device__ __forceinline__ void stcs_col(float* row, int u, float4 x) {
  __stcs(reinterpret_cast<float4*>(row) + u, x);
}
__device__ __forceinline__ void stcs_col(float* row, int u, float x) {
  __stcs(row + u, x);
}

// ---- the CBOW spans (K5, K7) ----
//
// A span block owns S consecutive centers [c0, c0 + S) and the band
// positions [c0, c0 + S) (the last span: up to C + 2W). Band position p
// takes the window gradient of the centers c = p - W - off_j: for
// position q = p - c0 of the span, the span-local center q - j (j < W)
// or q - j - 1 (j >= W), in [q - 2W, q]. The span's own centers give
// every position q >= 2W; the first 2W positions also need the 2W
// centers before c0, the last 2W of the span before. Those come by a
// handoff, not by recomputing them: the spans take their order from an
// atomic ticket at start (so span i - 1 has started whenever span i
// runs, and it publishes before it waits for anything: no block waits
// on one that is not running); a span publishes its last 2W centers'
// window gradients to a global scratch, then a flag (a release store),
// and finishes its other positions before it acquires the flag of the
// span before. Each position's sum keeps its fixed offset order, so the
// result is the same bits on every run. The consumer clears the flag it
// read and the last block to finish clears the ticket, so both are zero
// again for the next launch (one stream at a time: the port launches
// every kernel of a device on one stream).

struct Handoff {
  unsigned* ctr;    // [2]: the ticket, the blocks done; zero at launch
  unsigned* flags;  // [spans]: span i's halo published; zero at launch
  float* halo;      // [spans][2W][D] the last 2W centers' gradients
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// This block's span (the order in which the blocks started).
__device__ __forceinline__ int span_ticket(const Handoff& h, int* s_span) {
  if (threadIdx.x == 0) *s_span = (int)atomicAdd(h.ctr, 1u);
  __syncthreads();
  return *s_span;
}

// The last block to finish clears the ticket for the next launch (every
// block took its ticket before it counts itself done; nothing is
// published, so no fence).
__device__ __forceinline__ void span_done(const Handoff& h) {
  if (threadIdx.x == 0) {
    if (atomicAdd(h.ctr + 1, 1u) == gridDim.x - 1) {
      h.ctr[0] = 0u;
      h.ctr[1] = 0u;
    }
  }
}

// The CBOW span's shared memory (floats): the band rows of its
// positions' windows, its centers' window means, the window gradients
// of the 2W halo centers then of its own S centers, the pair mask of
// the same 2W + S centers, its centers' valid-context counts and two
// slots a warp for the sums; each region 16-byte aligned.
// kernels/cbow.py `span_smem` and kernels/hs.py `cbow_span_smem` mirror
// it (K5 adds its negatives' rows and coefficients after `floats`).
struct CbowSpan {
  int DP;  // shared row stride: D rounded up to 4
  size_t band, mean, gacc, pm, cnt, wl, floats;
};

__host__ __device__ inline size_t align4(size_t x) { return (x + 3) / 4 * 4; }

__host__ __device__ inline CbowSpan cbow_span(int S, int W, int D,
                                              int warps) {
  CbowSpan s;
  const int W2 = 2 * W;
  s.DP = (D + 3) / 4 * 4;
  s.band = 0;
  s.mean = s.band + (size_t)(S + W2) * s.DP;
  s.gacc = s.mean + (size_t)S * s.DP;
  s.pm = s.gacc + (size_t)(W2 + S) * s.DP;
  s.cnt = align4(s.pm + (size_t)(W2 + S) * W2);
  s.wl = align4(s.cnt + S);
  s.floats = align4(s.wl + 2 * warps);
  return s;
}

// Stage the span's band rows [c0, c0 + own_c + 2W) into sband and the
// pair mask of the centers [c0 - 2W, c0 + S) into spm (zeros outside
// [0, C)); asynchronous copies, not yet committed.
template <bool VEC>
__device__ __forceinline__ void stage_cbow(float* sband, float* spm,
                                           const float* u_band,
                                           const float* pmask, int64_t c0,
                                           int own_c, int S, int C, int W,
                                           int D, int DP) {
  const int W2 = 2 * W;
  stage_rows<VEC>(sband, S + W2, D, DP, u_band, [&](int r) -> const float* {
    return r < own_c + W2 ? u_band + (c0 + r) * D : nullptr;
  });
  const int64_t base = (c0 - W2) * W2;
  for (int i = threadIdx.x; i < (W2 + S) * W2; i += blockDim.x) {
    const int64_t c = c0 - W2 + i / W2;
    const bool in = c >= 0 && c < C;
    copy_async<false>(spm + i, in ? pmask + base + i : pmask, in);
  }
}

// Column u of the window mean of span center cs: the masked sum of its
// band rows in offset order (the reference's), over max(n_c, 1).
template <typename T>
__device__ __forceinline__ T window_mean_col(const float* sband,
                                             const float* pmr, int cs, int u,
                                             int W, int DP, float den) {
  T acc = zero_col<T>();
  for (int j = 0; j < 2 * W; ++j) {
    const int k = j < W ? j : j + 1;
    acc = axpy_col(pmr[j], load_col(sband + (size_t)(cs + k) * DP, u, T()),
                   acc);
  }
  return div_col(acc, den);
}

// The d_band rows of the span positions [q_lo, q_hi): scale times the
// sum over j, in order, of pmask[c, j] * gacc[c] for the centers c
// whose window holds the position (span-local c in [c_min, own_c);
// sgacc row 2W + c, spm row 2W + c).
template <typename T>
__device__ __forceinline__ void band_rows(const float* sgacc,
                                          const float* spm, int q_lo,
                                          int q_hi, int c_min, int own_c,
                                          int W, int D, int DP, float scale,
                                          float* d_band, int64_t c0) {
  const int W2 = 2 * W;
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int NU = (D + kPer - 1) / kPer;
  const int n = (q_hi - q_lo) * NU;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int q = q_lo + i / NU, u = i - (i / NU) * NU;
    T acc = zero_col<T>();
    for (int j = 0; j < W2; ++j) {
      const int c = j < W ? q - j : q - j - 1;
      if (c >= c_min && c < own_c)
        acc = axpy_col(spm[(W2 + c) * W2 + j],
                       load_col(sgacc + (size_t)(W2 + c) * DP, u, T()), acc);
    }
    store_col(d_band + (c0 + q) * D, u, scale_col(scale, acc));
  }
}

// Once the span's window gradients are complete in sgacc (a barrier
// before): its last 2W, the halo of the span after, go to the scratch,
// then the flag. The barrier orders every thread's stores before thread
// 0's release store (no fence needed; the last span publishes nothing).
template <typename T>
__device__ __forceinline__ void cbow_publish(const Handoff& h,
                                             const float* sgacc, int span,
                                             int own_c, int W, int D,
                                             int DP) {
  if (span + 1 >= (int)gridDim.x) return;
  const int W2 = 2 * W;
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int NU = (D + kPer - 1) / kPer;
  float* dst = h.halo + (size_t)span * W2 * D;
  for (int i = threadIdx.x; i < W2 * NU; i += blockDim.x) {
    const int r = i / NU, u = i - (i / NU) * NU;
    store_col(dst + (size_t)r * D, u,
              load_col(sgacc + (size_t)(own_c + r) * DP, u, T()));
  }
  __syncthreads();
  if (threadIdx.x == 0) st_release(h.flags + span, 1u);
}

// The span's d_band rows: the positions [2W, own_pos) from its own
// centers, then, once the span before has published (its flag
// acquired), the halo into sgacc rows [0, 2W) and the positions [0, 2W).
template <typename T>
__device__ __forceinline__ void cbow_band(const Handoff& h, float* sgacc,
                                          const float* spm, int span,
                                          int own_c, int own_pos, int W,
                                          int D, int DP, float scale,
                                          float* d_band, int64_t c0) {
  const int W2 = 2 * W;
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int NU = (D + kPer - 1) / kPer;
  band_rows<T>(sgacc, spm, W2 < own_pos ? W2 : own_pos, own_pos, 0, own_c,
               W, D, DP, scale, d_band, c0);
  if (span > 0) {
    if (threadIdx.x == 0) {
      while (ld_acquire(h.flags + span - 1) == 0u) {
      }
      h.flags[span - 1] = 0u;
    }
    __syncthreads();
    const float* src = h.halo + (size_t)(span - 1) * W2 * D;
    for (int i = threadIdx.x; i < W2 * NU; i += blockDim.x) {
      const int r = i / NU, u = i - (i / NU) * NU;
      T x;
      if constexpr (sizeof(T) == 16) {
        x = __ldcg(reinterpret_cast<const float4*>(src + (size_t)r * D) + u);
      } else {
        x = __ldcg(src + (size_t)r * D + u);
      }
      store_col(sgacc + (size_t)r * DP, u, x);
    }
    __syncthreads();
  }
  band_rows<T>(sgacc, spm, 0, W2 < own_pos ? W2 : own_pos,
               span > 0 ? -W2 : 0, own_c, W, D, DP, scale, d_band, c0);
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
