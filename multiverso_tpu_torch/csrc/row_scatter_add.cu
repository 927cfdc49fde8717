// K3 row_scatter_add: data[ids[i], :d_cols] += sign * delta[i, :d_cols],
// and K16 row_scatter_add_bounded: the same over a server shard's window
// of GLOBAL ids.
//
// K3 replaces the reference's DefaultRule.rows / SGDRule.rows
// (multiverso_tpu/updater/rules.py:94-105) as driven by
// UpdateEngine.apply_rows / rows_padded
// (multiverso_tpu/updater/engine.py:73-128): the jitted
// `data.at[ids].add(+-delta, mode="drop")`. Duplicate ids sum. Ids in
// [-rows, -1] wrap (mode="drop" keeps them); every other out-of-range id
// (the pad sentinel `rows` among them) is dropped. The delta is
// zero-extended in columns (d_cols <= stride) and in rows (k_delta <=
// number of ids): the extension adds zero, so only the first k_delta ids
// and the first d_cols columns are touched. sign is +1 (default) or -1
// (sgd).
//
// K16 replaces UpdateEngine._bounded_rows_fn (engine.py:132-153), the
// scatter of a device-key Add on a table of several servers: every
// server receives the same global ids and deltas, adds the rows of the
// ids in its window [ofs, ofs + n) at id - ofs and drops every other
// id (negative ones included: no wrap). Stateless rules only, as K3.
//
// Every table element has one writer, so the result is the same on
// every run. Two forms.
//
// Distinct ids (mv_row_scatter_add_distinct; the caller vouches that the
// in-range ids do not repeat, e.g. host ids the engine found ascending):
// a thread a float (a float4 on 16-byte aligned rows) of the flat delta,
// one writer an element. Rows narrower than a warp (lr_sparse_ps's
// 1-float rows) take neighbouring lanes on neighbouring delta elements,
// so id and delta loads coalesce, where a warp a row left 31 of 32
// lanes idle. The add is a single fire-and-forget add in L2 per element
// (no load, add and store: with one add an element there is no order to
// vary, and the SM waits for no table load; measured 1.3x faster on the
// tbl_* rows). Like the card's other float atomics (index_add_'s
// among them) it flushes subnormal inputs and results to zero, which
// the plain version on the CPU does not: a table element or delta below
// 2^-126 in magnitude is the one place the two can differ.
//
// Ids that can repeat (mv_row_scatter_add_sorted; K16 always): the
// wrapper maps the ids to keys (wrapped, or local to the window; a key
// outside [0, rows) is skipped) and sorts them stably on the card, so
// each row's occurrences form a run in position order. The sorted
// positions are cut into tasks of kChunk. A run that lies inside one
// task has one owner: it reads the table row once, adds the run's deltas
// in position order and writes the row once. A run that crosses a cut
// (a Zipf head repeats thousands of times in a word2vec step; an HS
// batch's padded nodes all name row 0) leaves, from each task it
// touches, a partial sum in scratch: the task's first run, if it
// continues from the task before, in the task's slot 0, and its last
// run, if it continues into the next task, in slot 1 (a task inside one
// run writes slot 0 and a zero slot 1). The slots, in task order, are a
// keyed sequence again with the same property: the next level of the
// same kernel sums them, and so on until one task holds everything
// (ceil(log_16(n)) levels at most; ~4 at a word2vec step). So no warp
// walks more than kChunk rows and the order of every sum is fixed by
// the data alone. Where a run fits a task the sum is the sequential one
// of the plain version, bit for bit; a longer run is summed as a tree of
// sequential sums of kChunk terms. Wide rows take a warp a task (lanes
// on columns, float4s on aligned rows), narrow ones (d_cols < 32) a
// thread a task.
//
// Bound on the card: bytes. Each id and delta row is read once and each
// table row it reaches read and written once; the sorted form adds the
// sort (torch's radix sort of the keys) and, per level, 2/kChunk of the
// rows in scratch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // sorted positions a task walks
constexpr int kGroup = 8;   // positions whose loads a lane issues at once

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float mul_rn(float s, float v) {
  return __fmul_rn(s, v);
}
__device__ __forceinline__ float4 mul_rn(float s, float4 v) {
  return make_float4(__fmul_rn(s, v.x), __fmul_rn(s, v.y), __fmul_rn(s, v.z),
                     __fmul_rn(s, v.w));
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ float4 zero_of<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---- distinct ids ----

// A thread a unit (a float4 on aligned rows, else a float) of the flat
// delta: its delta load and its id load go out together, then one
// fire-and-forget add in L2 (`red.global.add`, the result unused). The
// in-range ids are distinct, so each table element takes at most one
// add: the result is x0 + sign * delta rounded once, the same bits as a
// load, add and store (and as the plain version), on every run, without
// the round trip of the table load.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scatter_distinct(float* __restrict__ data, int64_t rows, int64_t stride,
                     const int32_t* __restrict__ ids, int64_t k,
                     const float* __restrict__ delta, int d_cols,
                     float sign) {
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int w = d_cols / kPer;  // units a row
  const int64_t e = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (e >= k * w) return;
  const int64_t i = w == 1 ? e : e / w;
  const T v = __ldg(reinterpret_cast<const T*>(delta) + e);
  const int64_t id = wrap_id(__ldg(ids + i), rows);
  if (id < 0) return;
  // sm_90 has the float4 form of the add (16 bytes in one operation).
  atomicAdd(reinterpret_cast<T*>(data) + id * (stride / kPer) + (e - i * w),
            mul_rn(sign, v));
}

// ---- ids that can repeat: one level of the sorted scatter ----

struct Level {
  const int32_t* keys;   // [n], runs of equal keys contiguous
  const int64_t* order;  // level 0: sorted position -> delta row; else null
  const float* vals;     // level 0: delta [k, d]; above: partials [n, d]
  int64_t n;
  float sign;            // level 0: sign; above: 1 (partials carry it)
  int32_t* next_keys;    // [2 * tasks] slot keys, or null at the last level
  float* next_vals;      // [2 * tasks, d]
};

inline int64_t tasks_of(int64_t n) { return (n + kChunk - 1) / kChunk; }

// Where a run of a task goes: slot 0 (it continues from the task
// before), slot 1 (it continues into the next) or the table (it lies
// inside the task).
constexpr int kSlot0 = 0, kSlot1 = 1, kTable = 2;

__device__ __forceinline__ int run_target(int32_t key, int32_t first,
                                          int32_t last, bool before,
                                          bool after) {
  if (key == first && before) return kSlot0;
  if (key == last && after) return kSlot1;
  return kTable;
}

// Per-position flags of a task (shared memory): the run's target in the
// low bits, then whether the position heads its run, ends it, and names
// a row.
constexpr uint8_t kHead = 4, kEnd = 8, kValid = 16;

// The slot keys of task `task`: the continuing runs' keys, -1 (skipped)
// for an empty slot.
__device__ __forceinline__ void write_slot_keys(const Level& L, int64_t task,
                                                int32_t first, int32_t last,
                                                bool before, bool after) {
  if (L.next_keys == nullptr) return;
  L.next_keys[2 * task] = before ? first : -1;
  L.next_keys[2 * task + 1] = after ? last : -1;
}

// Wide rows: a warp a task, lanes on columns (T = float4 on aligned
// rows). A lane issues the loads of kGroup positions (their value rows,
// and the table row at the head of each run that lies in the task)
// before it adds them in position order, so a task of many short runs
// waits for a few round trips to memory, not one a run.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scatter_level_warp(float* __restrict__ data, int64_t rows,
                       int64_t stride, int d_cols, Level L) {
  __shared__ int32_t s_key[kWarps][kChunk];
  __shared__ int64_t s_row[kWarps][kChunk];
  __shared__ uint8_t s_flag[kWarps][kChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t task = blockIdx.x * (int64_t)kWarps + warp;
  const int64_t lo = task * kChunk;
  if (lo >= L.n) return;
  const int cnt = (int)(L.n - lo < kChunk ? L.n - lo : kChunk);
  int32_t key = 0;
  if (lane < cnt) {
    key = L.keys[lo + lane];
    s_key[warp][lane] = key;
    s_row[warp][lane] = L.order != nullptr ? L.order[lo + lane] : lo + lane;
  }
  __syncwarp();
  const int32_t first = s_key[warp][0];
  const int32_t last = s_key[warp][cnt - 1];
  const bool before = lo > 0 && L.keys[lo - 1] == first;
  const bool after = lo + cnt < L.n && L.keys[lo + cnt] == last;
  if (lane == 0) write_slot_keys(L, task, first, last, before, after);
  if (lane < cnt) {
    const bool head = lane == 0 || s_key[warp][lane - 1] != key;
    const bool end = lane == cnt - 1 || s_key[warp][lane + 1] != key;
    s_flag[warp][lane] = (uint8_t)(
        run_target(key, first, last, before, after) | (head ? kHead : 0) |
        (end ? kEnd : 0) | (key >= 0 && key < rows ? kValid : 0));
  }
  __syncwarp();
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int nv = d_cols / kPer;
  const int64_t srow = stride / kPer;
  T* table = reinterpret_cast<T*>(data);
  const T* vals = reinterpret_cast<const T*>(L.vals);
  T* slots = reinterpret_cast<T*>(L.next_vals);
  const uint8_t* flag = s_flag[warp];
  const int32_t* keys = s_key[warp];
  const int64_t* from = s_row[warp];
  for (int c = lane; c < nv; c += 32) {
    T acc = zero_of<T>();
    for (int base = 0; base < cnt; base += kGroup) {
      T v[kGroup], x[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int p = base + u;
        v[u] = zero_of<T>();
        x[u] = zero_of<T>();
        if (p < cnt && (flag[p] & kValid)) {
          v[u] = __ldg(vals + from[p] * nv + c);
          if ((flag[p] & kHead) && (flag[p] & 3) == kTable)
            x[u] = table[keys[p] * srow + c];
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int p = base + u;
        if (p >= cnt || !(flag[p] & kValid)) continue;
        const int target = flag[p] & 3;
        if (flag[p] & kHead) acc = target == kTable ? x[u] : zero_of<T>();
        acc = add_rn(acc, mul_rn(L.sign, v[u]));
        if (!(flag[p] & kEnd)) continue;
        if (target == kTable) {
          table[keys[p] * srow + c] = acc;
        } else {
          slots[(2 * task + target) * nv + c] = acc;
          if (target == kSlot0 && p == cnt - 1 && after)
            slots[(2 * task + 1) * nv + c] = zero_of<T>();
        }
      }
    }
  }
}

// Narrow rows (d_cols < 32): a thread a task, columns in turn.
__global__ void __launch_bounds__(kThreads)
    scatter_level_thread(float* __restrict__ data, int64_t rows,
                         int64_t stride, int d_cols, Level L) {
  const int64_t task = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  const int64_t lo = task * kChunk;
  if (lo >= L.n) return;
  const int cnt = (int)(L.n - lo < kChunk ? L.n - lo : kChunk);
  const int32_t* keys = L.keys + lo;
  const int32_t first = keys[0];
  const int32_t last = keys[cnt - 1];
  const bool before = lo > 0 && L.keys[lo - 1] == first;
  const bool after = lo + cnt < L.n && L.keys[lo + cnt] == last;
  write_slot_keys(L, task, first, last, before, after);
  for (int c = 0; c < d_cols; ++c) {
    int t = 0;
    while (t < cnt) {
      const int32_t key = keys[t];
      int e = t + 1;
      while (e < cnt && keys[e] == key) ++e;
      if (key >= 0 && key < rows) {
        const int target = run_target(key, first, last, before, after);
        float* row = data + key * stride + c;
        float acc = target == kTable ? *row : 0.f;
        for (int p = t; p < e; ++p) {
          const int64_t r = L.order != nullptr ? L.order[lo + p] : lo + p;
          acc = __fadd_rn(acc, __fmul_rn(L.sign, L.vals[r * d_cols + c]));
        }
        if (target == kTable) {
          *row = acc;
        } else {
          L.next_vals[(2 * task + target) * d_cols + c] = acc;
          if (target == kSlot0 && e == cnt && after)
            L.next_vals[(2 * task + 1) * d_cols + c] = 0.f;
        }
      }
      t = e;
    }
  }
}

}  // namespace

// Distinct in-range ids: ids[0:k_delta] (the rest add zero).
extern "C" cudaError_t mv_row_scatter_add_distinct(
    float* data, int64_t rows, int64_t stride, const int32_t* ids,
    int64_t k_delta, const float* delta, int d_cols, float sign,
    cudaStream_t stream) {
  if (k_delta <= 0 || d_cols <= 0) return cudaSuccess;
  const bool vec = rows_vec4(data, stride, delta, d_cols);
  const int64_t units = k_delta * (vec ? d_cols >> 2 : d_cols);
  const int64_t blocks = (units + kThreads - 1) / kThreads;
  if (vec) {
    scatter_distinct<float4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        data, rows, stride, ids, k_delta, delta, d_cols, sign);
  } else {
    scatter_distinct<float><<<(unsigned)blocks, kThreads, 0, stream>>>(
        data, rows, stride, ids, k_delta, delta, d_cols, sign);
  }
  return cudaGetLastError();
}

// Sorted keys: keys[0:n] (a key in [0, rows) names a row of data; every
// other key is skipped), order[0:n] their delta rows. The levels ping-pong
// between two scratch areas of slots: the first cap_a slots for the
// levels 1, 3, ..., the rest for 2, 4, ...; level l + 1 has 2 *
// ceil(n_l / 32) slots (the wrapper sizes them alike, rows.py
// `scatter_levels`).
extern "C" cudaError_t mv_row_scatter_add_sorted(
    float* data, int64_t rows, int64_t stride, const int32_t* keys,
    const int64_t* order, int64_t n, const float* delta, int d_cols,
    float sign, int32_t* slot_keys, float* slot_vals, int64_t cap_a,
    cudaStream_t stream) {
  if (n <= 0 || d_cols <= 0) return cudaSuccess;
  // Float4 columns where every row in play is 16-byte aligned: the table
  // rows, the delta rows and the slot rows (d_cols % 4 == 0).
  const bool vec = d_cols >= 32 && rows_vec4(data, stride, delta, d_cols) &&
                   (slot_vals == nullptr ||
                    reinterpret_cast<uintptr_t>(slot_vals) % 16 == 0);
  Level L{keys, order, delta, n, sign, nullptr, nullptr};
  for (int level = 0;; ++level) {
    const int64_t tasks = tasks_of(L.n);
    const bool last = tasks == 1;
    const int64_t at = level % 2 == 0 ? 0 : cap_a;
    L.next_keys = last ? nullptr : slot_keys + at;
    L.next_vals = last ? nullptr : slot_vals + at * d_cols;
    if (d_cols < 32) {
      const int64_t blocks = (tasks + kThreads - 1) / kThreads;
      scatter_level_thread<<<(unsigned)blocks, kThreads, 0, stream>>>(
          data, rows, stride, d_cols, L);
    } else {
      const int64_t blocks = (tasks + kWarps - 1) / kWarps;
      if (vec) {
        scatter_level_warp<float4>
            <<<(unsigned)blocks, kThreads, 0, stream>>>(data, rows, stride,
                                                        d_cols, L);
      } else {
        scatter_level_warp<float>
            <<<(unsigned)blocks, kThreads, 0, stream>>>(data, rows, stride,
                                                        d_cols, L);
      }
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    L = Level{L.next_keys, nullptr, L.next_vals, 2 * tasks, 1.0f, nullptr,
              nullptr};
  }
}
