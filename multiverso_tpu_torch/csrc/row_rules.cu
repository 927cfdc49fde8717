// K13 row_rule_apply and K14 rows_apply_gather: the updater's row rules
// on the card.
//
// K13 replaces the stateful rules' row updates, MomentumRule.rows,
// AdaGradRule.rows and DCASGDRule.rows
// (multiverso_tpu/updater/rules.py:120-125, 144-151, 184-198), as
// UpdateEngine.apply_rows drives them (multiverso_tpu/updater/
// engine.py:103-130). K14 replaces UpdateEngine.apply_rows_gather
// (engine.py:155-193): any rule's row update, then
// `data.at[get_ids].get(mode="fill")[..., :n_col]` from the UPDATED
// table, in one program.
//
// The rules, for an id r taken by a worker w with delta row dv:
//   momentum: s' = m*s[r] + (1-m)*dv;  s[r] = s';  data[r] -= s'
//   adagrad:  g = dv/max(lr,1e-12);  G' = G[w,r] + g*g;
//             data[r] -= rho*g*(1/sqrt(G'+1e-6));  G[w,r] = G'
//   dcasgd:   g = dv/max(lr,1e-12);
//             step = dv + lr*lambda*g*g*(data[r] - B[w,r]);
//             data[r] -= step;  B[w,r] = data_old[r] - step
// JAX's semantics for an id that repeats: every occurrence computes its
// step from the rows and state as they were BEFORE the call, the table
// row receives the sum of the steps (`.at[].add`), and the state row
// keeps one occurrence's value (`.at[].set`; XLA keeps the last). So
// nothing may be written before everything is read. The caller sorts
// the ids stably by row (the wrapped id as the key, ids out of range
// sort apart and are skipped); the warp at the head of a row's run owns
// the row: it reads the row and its state once, walks the run in
// position order summing the steps in that order, and writes the row
// once and the state from the last occurrence. No atomics, and the
// result is the same on every run. Ids in [-rows, -1] wrap, for the
// table and the state alike; every other out-of-range id (the pad
// sentinel `rows` among them) is dropped, and gathers a zero row. A
// worker at or past the state's slots reads zero state and its state
// writes are dropped (JAX's fill/drop), while its step still lands on
// the table. The delta is zero-extended in rows (ids past k_delta take
// a zero delta, which still moves momentum and dcasgd state) and only
// its d_cols columns are touched: the storage columns past them hold
// zero state and take a zero delta, which changes nothing under any
// rule.
//
// K14 is ONE cooperative launch: the update phase (the stateless rules
// scatter-add with float atomics through atomic_add_row of
// row_common.cuh, so their duplicates sum in an order that varies from
// run to run: ROADMAP C11's remainder, off the word2vec and
// model-average paths; the stateful ones run K13's segments), a
// grid-wide barrier, then the gather phase, a warp per requested row,
// reading through L2 (`__ldcg`) the rows that other blocks have just
// written. The grid is as large as can be resident at once (occupancy x
// SMs) and both phases stride over it.
//
// The arithmetic uses the _rn intrinsics in the reference's expression
// order, so no FMA contraction moves a rounding. AdaGrad's
// 1/sqrt(G + eps) is __fdiv_rn(1, __fsqrt_rn(.)), two correctly rounded
// operations, as the plain version forms it on the CPU and on the card
// (rsqrtf, like torch.rsqrt, is not correctly rounded).
//
// Bound on the card: bytes. K13 reads each id, delta row, table row and
// state row once and writes each table and state row once; K14 adds
// the gathered rows' ids and write. Rows of 50 floats are not 16-byte
// aligned, so the lanes take scalar columns (K14's stateless update
// takes float4s on aligned rows, as K3 does).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kAdaGradEps = 1e-6f;  // ref: adagrad_updater.h:18

enum RuleCode : int {
  kDefault = 0,
  kSgd = 1,
  kMomentum = 2,
  kAdaGrad = 3,
  kDcasgd = 4,
};

struct Hyp {
  float m, one_m, lr, safe_lr, rho, lam;
};

struct Rows {
  float* data;
  int64_t rows, stride;
  float* state;  // momentum [rows, stride]; adagrad, dcasgd [workers, rows, stride]
  int workers, worker;
  const int32_t* ids;    // the ids as given (stateless update)
  const int32_t* keys;   // wrapped ids, stably sorted (stateful update)
  const int64_t* order;  // the position of each sorted key
  int64_t n;             // number of ids
  const float* delta;    // [k_delta, d_cols]
  int64_t k_delta;
  int d_cols;
  bool vec;  // rows_vec4: the stateless update adds float4s
  Hyp hyp;
};

struct Gather {
  const int32_t* ids;
  int64_t n;
  float* out;  // [n, n_col]
  int n_col;
};

template <int RULE>
__device__ __forceinline__ void rule_step(const Hyp& h, float x0, float s0,
                                          float dv, float& step,
                                          float& s_new) {
  if (RULE == kMomentum) {
    const float sm = __fadd_rn(__fmul_rn(h.m, s0), __fmul_rn(h.one_m, dv));
    step = sm;
    s_new = sm;
  } else if (RULE == kAdaGrad) {
    const float g = __fdiv_rn(dv, h.safe_lr);
    const float gs = __fadd_rn(s0, __fmul_rn(g, g));
    step = __fmul_rn(__fmul_rn(h.rho, g),
                     __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(gs, kAdaGradEps))));
    s_new = gs;
  } else {  // kDcasgd
    const float g = __fdiv_rn(dv, h.safe_lr);
    const float c = __fmul_rn(__fmul_rn(__fmul_rn(h.lr, h.lam), g), g);
    step = __fadd_rn(dv, __fmul_rn(c, __fsub_rn(x0, s0)));
    s_new = __fsub_rn(x0, step);
  }
}

// One warp: the run of sorted position j, if j heads the run of a valid
// row.
template <int RULE>
__device__ void apply_segment(const Rows& a, int64_t j, int lane) {
  const int32_t key = a.keys[j];
  if (key < 0 || key >= a.rows) return;
  if (j > 0 && a.keys[j - 1] == key) return;
  int64_t end = j + 1;
  while (end < a.n && a.keys[end] == key) ++end;
  float* drow = a.data + (int64_t)key * a.stride;
  float* srow = nullptr;
  if (RULE == kMomentum) {
    srow = a.state + (int64_t)key * a.stride;
  } else if (a.worker < a.workers) {
    srow = a.state + ((int64_t)a.worker * a.rows + key) * a.stride;
  }
  for (int c = lane; c < a.d_cols; c += 32) {
    const float x0 = drow[c];
    const float s0 = srow != nullptr ? srow[c] : 0.f;
    float acc = x0, s_last = s0;
    for (int64_t p = j; p < end; ++p) {
      const int64_t pos = a.order[p];
      const float dv = pos < a.k_delta ? a.delta[pos * a.d_cols + c] : 0.f;
      float step, s_new;
      rule_step<RULE>(a.hyp, x0, s0, dv, step, s_new);
      acc = __fsub_rn(acc, step);
      s_last = s_new;
    }
    drow[c] = acc;
    if (srow != nullptr) srow[c] = s_last;
  }
}

// One warp: delta row i scatter-added (default) or subtracted (sgd), as
// K3 adds it, but with float atomics.
template <int RULE>
__device__ void add_row(const Rows& a, int64_t i, int lane) {
  if (i >= a.k_delta) return;
  const int64_t id = wrap_id(a.ids[i], a.rows);
  if (id < 0) return;
  const float sign = RULE == kSgd ? -1.0f : 1.0f;
  float* dst = a.data + id * a.stride;
  const float* src = a.delta + i * a.d_cols;
  if (a.vec) {
    atomic_add_row<true>(dst, src, a.d_cols, sign, lane);
  } else {
    atomic_add_row<false>(dst, src, a.d_cols, sign, lane);
  }
}

template <int RULE>
__global__ void __launch_bounds__(kThreads)
    row_rule_apply_kernel(Rows a) {
  const int64_t j = (blockIdx.x * (int64_t)kThreads + threadIdx.x) >> 5;
  if (j < a.n) apply_segment<RULE>(a, j, threadIdx.x & 31);
}

template <int RULE>
__global__ void __launch_bounds__(kThreads)
    rows_apply_gather_kernel(Rows a, Gather g) {
  const int lane = threadIdx.x & 31;
  const int64_t first = (blockIdx.x * (int64_t)kThreads + threadIdx.x) >> 5;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t j = first; j < a.n; j += warps) {
    if (RULE == kDefault || RULE == kSgd) {
      add_row<RULE>(a, j, lane);
    } else {
      apply_segment<RULE>(a, j, lane);
    }
  }
  cg::this_grid().sync();
  for (int64_t i = first; i < g.n; i += warps) {
    const int64_t id = wrap_id(g.ids[i], a.rows);
    float* dst = g.out + i * g.n_col;
    if (id < 0) {
      for (int c = lane; c < g.n_col; c += 32) dst[c] = 0.f;
      continue;
    }
    const float* src = a.data + id * a.stride;
    for (int c = lane; c < g.n_col; c += 32) dst[c] = __ldcg(src + c);
  }
}

Hyp make_hyp(float m, float lr, float rho, float lam) {
  Hyp h;
  h.m = m;
  h.one_m = 1.0f - m;
  h.lr = lr;
  h.safe_lr = fmaxf(lr, 1e-12f);
  h.rho = rho;
  h.lam = lam;
  return h;
}

template <int RULE>
cudaError_t launch_rule(const Rows& a, cudaStream_t stream) {
  const int64_t blocks = (a.n * 32 + kThreads - 1) / kThreads;
  row_rule_apply_kernel<RULE><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int RULE>
cudaError_t launch_fused(Rows a, Gather g, cudaStream_t stream) {
  // The most blocks that can be resident at once: a cooperative launch
  // refuses more.
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rows_apply_gather_kernel<RULE>, kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
    resident = per_sm * sms;
  }
  const int64_t work = a.n > g.n ? a.n : g.n;
  int64_t blocks = (work * 32 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > resident) blocks = resident;
  void* args[] = {&a, &g};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(rows_apply_gather_kernel<RULE>),
      dim3((unsigned)blocks), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t mv_row_rule_apply(
    int rule, float* data, int64_t rows, int64_t stride, float* state,
    int workers, int worker, const int32_t* keys, const int64_t* order,
    int64_t n, const float* delta, int64_t k_delta, int d_cols, float m,
    float lr, float rho, float lam, cudaStream_t stream) {
  if (n <= 0 || d_cols <= 0) return cudaSuccess;
  Rows a{data, rows, stride, state, workers, worker, nullptr, keys, order,
         n, delta, k_delta, d_cols, false, make_hyp(m, lr, rho, lam)};
  switch (rule) {
    case kMomentum: return launch_rule<kMomentum>(a, stream);
    case kAdaGrad: return launch_rule<kAdaGrad>(a, stream);
    case kDcasgd: return launch_rule<kDcasgd>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" cudaError_t mv_rows_apply_gather(
    int rule, float* data, int64_t rows, int64_t stride, float* state,
    int workers, int worker, const int32_t* ids, const int32_t* keys,
    const int64_t* order, int64_t n, const float* delta, int64_t k_delta,
    int d_cols, float m, float lr, float rho, float lam,
    const int32_t* get_ids, int64_t n_get, float* out, int n_col,
    cudaStream_t stream) {
  if (n <= 0 && n_get <= 0) return cudaSuccess;
  Rows a{data, rows, stride, state, workers, worker, ids, keys, order,
         d_cols > 0 ? n : 0, delta, k_delta, d_cols,
         rows_vec4(data, stride, delta, d_cols), make_hyp(m, lr, rho, lam)};
  Gather g{get_ids, n_col > 0 ? n_get : 0, out, n_col};
  switch (rule) {
    case kDefault: return launch_fused<kDefault>(a, g, stream);
    case kSgd: return launch_fused<kSgd>(a, g, stream);
    case kMomentum: return launch_fused<kMomentum>(a, g, stream);
    case kAdaGrad: return launch_fused<kAdaGrad>(a, g, stream);
    case kDcasgd: return launch_fused<kDcasgd>(a, g, stream);
    default: return cudaErrorInvalidValue;
  }
}
