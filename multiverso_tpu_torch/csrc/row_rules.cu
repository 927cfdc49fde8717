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
//   momentum: s' = fma(m, s[r], (1-m)*dv) (in column swap_step of the
//             step, swap_state of the state: fma(1-m, dv, m*s[r]));
//             s[r] = s';  data[r] -= s'
//   adagrad:  g = dv/max(lr,1e-12);  G' = fma(g, g, G[w,r]);
//             data[r] -= rho*g*(1/sqrt(G'+1e-6));  G[w,r] = G'
//   dcasgd:   g = dv/max(lr,1e-12);
//             step = fma(lr*lambda*g*g, data[r] - B[w,r], dv);
//             data[r] -= step;  B[w,r] = data_old[r] - step
// JAX's semantics for an id that repeats: every occurrence computes its
// step from the rows and state as they were BEFORE the call, the table
// row receives the sum of the steps (`.at[].add`), and the state row
// keeps one occurrence's value (`.at[].set`; XLA keeps the last). So
// nothing may be written before everything is read. The caller sorts
// the ids stably by row on the card (K20 key_sort: the wrapped id as the
// key, ids out of range as `rows`, sorted last and skipped). A warp takes
// a tile of 32 sorted positions, finds the heads of runs among them with
// one ballot and owns each such row in turn (no warp is spent on a
// position inside a run): it reads the row and its state once, walks the
// run in position order summing the steps in that order, and writes the
// row once and the state from the last occurrence. No atomics, and the
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
// K14 is ONE cooperative launch: the update phase, a grid-wide barrier,
// then the gather phase, a warp per requested row, reading through L2
// (`__ldcg`) the rows that other blocks have just written. The grid is
// as large as can be resident at once (occupancy x SMs) and every phase
// strides over it (one launch beat two plain launches, update then
// gather, by 15-25% on the stateful arms). The update phase has no float
// atomic with more than one contributor an address, so the result is the
// same on every run:
//   - on ids the caller vouches strictly ascend in range (host ids the
//     engine found ascending), every rule takes one writer an element,
//     no sort: the stateful rules a thread an element of the n x d_cols
//     ids and columns (apply_distinct: x0, s0 and the delta read once,
//     the row and state written once; ids past k_delta take a zero
//     delta, a worker past the slots zero state), the stateless rules
//     K3's distinct form (row_common.cuh distinct_unit);
//   - the stateful rules on every other id list: K13's run heads on
//     K20's sort;
//   - the stateless rules on every other id list: K3's sorted form. The
//     wrapper sorts the keys stably (rows.scatter_plan); the levels of
//     row_common.cuh (tasks of kChunk sorted positions, two slots a
//     task, until one task holds a level) run one after another in this
//     launch, a grid-wide barrier between two levels and after the last,
//     reading what earlier levels wrote through L2. So the sums are, bit
//     for bit, K3's: rows.row_scatter_add_ordered then the gather.
//
// The arithmetic uses the _rn intrinsics in the reference's expression
// order, and __fmaf_rn exactly where the reference's XLA contracts a
// product into an add (above; no other contraction moves a rounding),
// so the stateful arms equal their plain versions bit for bit. AdaGrad's
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
  // Momentum: the column whose fused product is (1-m)*dv, not m*s, in
  // the step added to the table (the last one of rows up to 29 floats)
  // and in the state written back (up to 33), as the reference's row
  // programs contract them; -1 for none. From the row width, on the host.
  int swap_step, swap_state;
};

struct Rows {
  float* data;
  int64_t rows, stride;
  float* state;  // momentum [rows, stride]; adagrad, dcasgd [workers, rows, stride]
  int workers, worker;
  const int32_t* ids;    // the ids as given (stateless update)
  const int32_t* keys;   // sorted keys (stateful: K20's, dropped ids R)
  const void* order;     // each sorted key's position (stateful: int32,
                         // K20's; stateless sorted: int64)
  int64_t n;             // number of ids
  const float* delta;    // [k_delta, d_cols]
  int64_t k_delta;
  int d_cols;
  bool distinct;  // the in-range ids strictly ascend (no sort)
  int32_t* slot_keys;  // stateless, sorted: the levels' slot scratch
  float* slot_vals;
  int64_t cap_a;
  Hyp hyp;
};

struct Gather {
  const int32_t* ids;
  int64_t n;
  float* out;  // [n, n_col]
  int n_col;
};

template <int RULE>
__device__ __forceinline__ void rule_step(const Hyp& h, int c, float x0,
                                          float s0, float dv, float& step,
                                          float& s_new) {
  // __fmaf_rn where the reference's XLA contracts a product into the
  // add that follows it (ROADMAP C13; tests/test_torch_fma.py pins
  // each): its product is neither rounded nor flushed.
  if (RULE == kMomentum) {
    const float sm = __fmaf_rn(h.m, s0, __fmul_rn(h.one_m, dv));
    const float swapped = __fmaf_rn(h.one_m, dv, __fmul_rn(h.m, s0));
    step = c == h.swap_step ? swapped : sm;
    s_new = c == h.swap_state ? swapped : sm;
  } else if (RULE == kAdaGrad) {
    const float g = __fdiv_rn(dv, h.safe_lr);
    const float gs = __fmaf_rn(g, g, s0);
    step = __fmul_rn(__fmul_rn(h.rho, g),
                     __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(gs, kAdaGradEps))));
    s_new = gs;
  } else {  // kDcasgd
    const float g = __fdiv_rn(dv, h.safe_lr);
    const float c = __fmul_rn(__fmul_rn(__fmul_rn(h.lr, h.lam), g), g);
    step = __fmaf_rn(c, __fsub_rn(x0, s0), dv);
    s_new = __fsub_rn(x0, step);
  }
}

// One warp, one run: the rows of key `key` at sorted positions
// [j, end), each step from the row and state as they were before the
// call, summed in position order; the row written once, the state from
// the last occurrence. Lanes on columns.
template <int RULE>
__device__ void apply_run(const Rows& a, int32_t key, int64_t j, int64_t end,
                          int lane) {
  const int32_t* order = static_cast<const int32_t*>(a.order);
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
      const int64_t pos = order[p];
      const float dv = pos < a.k_delta ? a.delta[pos * a.d_cols + c] : 0.f;
      float step, s_new;
      rule_step<RULE>(a.hyp, c, x0, s0, dv, step, s_new);
      acc = __fsub_rn(acc, step);
      s_last = s_new;
    }
    drow[c] = acc;
    if (srow != nullptr) srow[c] = s_last;
  }
}

// One warp, a tile of 32 sorted positions: the runs whose heads lie in
// it, found by one ballot and taken in turn (no warp waits on a position
// that heads nothing); a run's end is found 32 keys at a time.
template <int RULE>
__device__ void apply_tile(const Rows& a, int64_t tile, int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  const int64_t p = tile * 32 + lane;
  const int32_t key = p < a.n ? a.keys[p] : -1;
  const int32_t prev = (p > 0 && p < a.n) ? a.keys[p - 1] : -1;
  unsigned heads =
      __ballot_sync(kAll, key >= 0 && key < a.rows && key != prev);
  while (heads != 0u) {
    const int l = __ffs(heads) - 1;
    heads &= heads - 1u;
    const int32_t k = __shfl_sync(kAll, key, l);
    const int64_t j = tile * 32 + l;
    int64_t end = j;
    for (int64_t base = j;; base += 32) {
      const int64_t q = base + lane;
      const unsigned in = __ballot_sync(kAll, q < a.n && a.keys[q] == k);
      if (in != kAll) {
        end = base + __ffs(~in) - 1;
        break;
      }
    }
    apply_run<RULE>(a, k, j, end, lane);
  }
}

// e / d, by a 32-bit division where e fits one.
__device__ __forceinline__ int64_t quotient(int64_t e, int d) {
  return e <= 0xffffffffLL ? (int64_t)((uint32_t)e / (uint32_t)d) : e / d;
}

// V floats at p (a float2 load or store where V is 2).
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&x)[V]) {
  if (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[V - 1] = v.y;
  } else {
    x[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&x)[V]) {
  if (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[V - 1]);
  } else {
    *p = x[0];
  }
}

// Unit e (V consecutive columns) of the distinct form (ids strictly
// ascending in range, one writer an element, no sort): threads flat
// over the n x d_cols / V units; ids past k_delta take a zero delta; a
// worker past the slots reads zero state and its state write drops. The
// same operations as apply_run on a run of one.
template <int RULE, int V>
__device__ __forceinline__ void apply_distinct(const Rows& a, int64_t e) {
  const int w = a.d_cols / V;
  const int64_t i = quotient(e, w);
  const int c = (int)(e - i * w) * V;
  const int64_t id = wrap_id(a.ids[i], a.rows);
  if (id < 0) return;
  float* x = a.data + id * a.stride + c;
  float* s = nullptr;
  if (RULE == kMomentum) {
    s = a.state + id * a.stride + c;
  } else if (a.worker < a.workers) {
    s = a.state + ((int64_t)a.worker * a.rows + id) * a.stride + c;
  }
  float x0[V], s0[V], dv[V], xn[V], sn[V];
  load_v<V>(x, x0);
  if (s != nullptr) {
    load_v<V>(s, s0);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) s0[j] = 0.f;
  }
  if (i < a.k_delta) {
    load_v<V>(a.delta + i * a.d_cols + c, dv);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dv[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float step;
    rule_step<RULE>(a.hyp, c + j, x0[j], s0[j], dv[j], step, sn[j]);
    xn[j] = __fsub_rn(x0[j], step);
  }
  store_v<V>(x, xn);
  if (s != nullptr) store_v<V>(s, sn);
}

// The stateful update in either form, striding over the grid; V: the
// distinct form's columns a thread (2 on rows of an even width at 8-byte
// alignment).
template <int RULE, int V>
__device__ void stateful_update(const Rows& a) {
  const int64_t thread = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  const int64_t threads = (int64_t)gridDim.x * kThreads;
  if (a.distinct) {
    const int64_t units = a.n * (a.d_cols / V);
    for (int64_t e = thread; e < units; e += threads)
      apply_distinct<RULE, V>(a, e);
    return;
  }
  const int64_t tiles = (a.n + 31) / 32;
  for (int64_t t = thread >> 5; t < tiles; t += threads >> 5)
    apply_tile<RULE>(a, t, threadIdx.x & 31);
}

template <int RULE>
__global__ void __launch_bounds__(kThreads)
    row_rule_apply_kernel(Rows a) {
  stateful_update<RULE, 1>(a);
}

// The stateless update (sign +1 default, -1 sgd) in K3's forms, inside
// the cooperative launch: one writer an element, or the sorted levels
// with a grid-wide barrier after each but the last.
template <typename T>
__device__ void stateless_update(const Rows& a, float sign,
                                 cg::grid_group& grid, int32_t* s_key,
                                 int64_t* s_row, uint8_t* s_flag) {
  const int lane = threadIdx.x & 31;
  const int64_t thread = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  const int64_t threads = (int64_t)gridDim.x * kThreads;
  const int64_t warp = thread >> 5;
  const int64_t warps = threads >> 5;
  if (a.distinct) {
    const int64_t units = a.k_delta * (a.d_cols / (int)(sizeof(T) / 4));
    for (int64_t e = thread; e < units; e += threads)
      distinct_unit<T>(a.data, a.rows, a.stride, a.ids, a.delta, a.d_cols,
                       sign, e);
    return;
  }
  Level L{a.keys, static_cast<const int64_t*>(a.order), a.delta, a.n, sign,
          nullptr, nullptr};
  for (int level = 0;; ++level) {
    place_slots(L, level, a.slot_keys, a.slot_vals, a.cap_a, a.d_cols);
    const int64_t tasks = tasks_of(L.n);
    if (a.d_cols < 32) {
      for (int64_t t = thread; t < tasks; t += threads)
        level_task_thread<true>(a.data, a.rows, a.stride, a.d_cols, L, t);
    } else {
      for (int64_t t = warp; t < tasks; t += warps)
        level_task_warp<T, true>(a.data, a.rows, a.stride, a.d_cols, L, t,
                                 lane, s_key, s_row, s_flag);
    }
    if (tasks == 1) return;
    grid.sync();
    L = next_level(L);
  }
}

// The gathered rows: a warp a requested row, lanes on columns (a
// thread an element was 3-4% slower), reading through L2 (`__ldcg`)
// what the update has just written.
__device__ void gather_rows(const Rows& a, const Gather& g) {
  const int lane = threadIdx.x & 31;
  const int64_t first = (blockIdx.x * (int64_t)kThreads + threadIdx.x) >> 5;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
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

// T: the update's column unit — the stateless rules' float4 on 16-byte
// aligned rows, the stateful distinct form's float2 on 8-byte aligned
// rows of an even width, else float — one instantiation each, so that
// the float form does not carry the wider forms' registers (and runs
// more blocks an SM).
template <int RULE, typename T>
__global__ void __launch_bounds__(kThreads)
    rows_apply_gather_kernel(Rows a, Gather g) {
  cg::grid_group grid = cg::this_grid();
  if constexpr (RULE == kDefault || RULE == kSgd) {
    __shared__ int32_t s_key[kWarps][kChunk];
    __shared__ int64_t s_row[kWarps][kChunk];
    __shared__ uint8_t s_flag[kWarps][kChunk];
    const int wib = threadIdx.x >> 5;
    const float sign = RULE == kSgd ? -1.0f : 1.0f;
    if (a.n > 0)
      stateless_update<T>(a, sign, grid, s_key[wib], s_row[wib],
                          s_flag[wib]);
  } else {
    stateful_update<RULE, (int)(sizeof(T) / sizeof(float))>(a);
  }
  grid.sync();
  gather_rows(a, g);
}

Hyp make_hyp(float m, float lr, float rho, float lam, int swap_step,
             int swap_state) {
  Hyp h;
  h.m = m;
  h.one_m = 1.0f - m;
  h.lr = lr;
  h.safe_lr = fmaxf(lr, 1e-12f);
  h.rho = rho;
  h.lam = lam;
  h.swap_step = swap_step;
  h.swap_state = swap_state;
  return h;
}

template <int RULE>
cudaError_t launch_rule(const Rows& a, cudaStream_t stream) {
  const int64_t blocks = (a.n + kThreads - 1) / kThreads;  // a warp a tile
  row_rule_apply_kernel<RULE><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int RULE, typename T = float>
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
          &per_sm, rows_apply_gather_kernel<RULE, T>, kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
    resident = per_sm * sms;
  }
  // Threads: the update's (a unit of an element, or a warp a run or
  // task) and the gather's (a warp a row).
  const int64_t units =
      a.distinct ? a.n * (a.d_cols / (int)(sizeof(T) / 4)) : a.n * 32;
  const int64_t work = units > g.n * 32 ? units : g.n * 32;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > resident) blocks = resident;
  void* args[] = {&a, &g};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(rows_apply_gather_kernel<RULE, T>),
      dim3((unsigned)blocks), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t mv_row_rule_apply(
    int rule, float* data, int64_t rows, int64_t stride, float* state,
    int workers, int worker, const int32_t* keys, const int32_t* order,
    int64_t n, const float* delta, int64_t k_delta, int d_cols, float m,
    float lr, float rho, float lam, int swap_step, int swap_state,
    cudaStream_t stream) {
  if (n <= 0 || d_cols <= 0) return cudaSuccess;
  Rows a{data, rows, stride, state, workers, worker, nullptr, keys, order,
         n, delta, k_delta, d_cols, false, nullptr, nullptr, 0,
         make_hyp(m, lr, rho, lam, swap_step, swap_state)};
  switch (rule) {
    case kMomentum: return launch_rule<kMomentum>(a, stream);
    case kAdaGrad: return launch_rule<kAdaGrad>(a, stream);
    case kDcasgd: return launch_rule<kDcasgd>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ids[0:n] as given (stateful: all n take a step; a stateless rule's
// distinct form reads ids[0:k_delta]); keys/order: the stateful rules'
// K20 sort (int32 order), or the stateless sorted form's plan (n = its
// keys, the first k_delta ids', each in [0, rows) or skipped; int64
// order) with the levels' slot scratch (slot_keys, slot_vals, cap_a as
// mv_row_scatter_add_sorted takes them); distinct: the in-range ids
// strictly ascend (no keys).
extern "C" cudaError_t mv_rows_apply_gather(
    int rule, float* data, int64_t rows, int64_t stride, float* state,
    int workers, int worker, const int32_t* ids, const int32_t* keys,
    const void* order, int64_t n, const float* delta, int64_t k_delta,
    int d_cols, float m, float lr, float rho, float lam, int swap_step,
    int swap_state,
    const int32_t* get_ids, int64_t n_get, float* out, int n_col,
    int distinct, int32_t* slot_keys, float* slot_vals, int64_t cap_a,
    cudaStream_t stream) {
  if (n <= 0 && n_get <= 0) return cudaSuccess;
  const bool stateless = rule == kDefault || rule == kSgd;
  // Float4 columns where every row in play is 16-byte aligned (K3's
  // choice for each form).
  const bool vec =
      stateless && rows_vec4(data, stride, delta, d_cols) &&
      (distinct || (d_cols >= 32 &&
                    (slot_vals == nullptr ||
                     reinterpret_cast<uintptr_t>(slot_vals) % 16 == 0)));
  Rows a{data, rows, stride, state, workers, worker, ids, keys, order,
         d_cols > 0 ? n : 0, delta, k_delta, d_cols, distinct != 0,
         slot_keys, slot_vals, cap_a,
         make_hyp(m, lr, rho, lam, swap_step, swap_state)};
  Gather g{get_ids, n_col > 0 ? n_get : 0, out, n_col};
  // The stateful distinct form's float2 columns.
  const bool pairs =
      !stateless && distinct && d_cols % 2 == 0 && stride % 2 == 0 &&
      reinterpret_cast<uintptr_t>(data) % 8 == 0 &&
      reinterpret_cast<uintptr_t>(delta) % 8 == 0 &&
      (state == nullptr || reinterpret_cast<uintptr_t>(state) % 8 == 0);
  switch (rule) {
    case kDefault:
      return vec ? launch_fused<kDefault, float4>(a, g, stream)
                 : launch_fused<kDefault, float>(a, g, stream);
    case kSgd:
      return vec ? launch_fused<kSgd, float4>(a, g, stream)
                 : launch_fused<kSgd, float>(a, g, stream);
    case kMomentum:
      return pairs ? launch_fused<kMomentum, float2>(a, g, stream)
                   : launch_fused<kMomentum>(a, g, stream);
    case kAdaGrad:
      return pairs ? launch_fused<kAdaGrad, float2>(a, g, stream)
                   : launch_fused<kAdaGrad>(a, g, stream);
    case kDcasgd:
      return pairs ? launch_fused<kDcasgd, float2>(a, g, stream)
                   : launch_fused<kDcasgd>(a, g, stream);
    default: return cudaErrorInvalidValue;
  }
}
