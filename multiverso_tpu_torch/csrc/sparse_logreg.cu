// K11 sparse_lr_forward and K12 sparse_lr_apply: the sparse logistic
// regression step.
//
// Together they replace the reference's make_sparse_step
// (multiverso_tpu/models/logreg/objective.py:89-116) as fused into
// LocalModel.fused (multiverso_tpu/models/logreg/model.py:54-59),
// PSModel.update (:144-163, with _scale/_apply_local/_gather_rows
// :123-127) and FTRLModel.fused (:211-223). The work is split in two
// launches because every forward read of a batch, and the
// regularization, must see the OLD weights: no row may be written before
// every sample is scored, which one launch could only ensure with a
// grid-wide barrier.
//
// K11, one warp a sample b: logits[c] = sum_k values[b,k] * W[key, c],
// W gathered as JAX's w[keys] gathers (an id in [-R, -1] wraps, then
// every id clamps into [0, R-1]); W is w, or FTRL's weights_of(z, n)
// computed for the gathered rows only. Then pred = act(logits) (linear,
// sigmoid, or softmax with the max subtracted), and with labels
// diff = (pred - onehot) * weight[b], the per-sample loss times its
// weight (logs clipped at 1e-6; the linear loss is a mean over classes)
// and the per-sample hit (pred >= 0.5 for one output, else the first
// argmax, counted only where weight > 0). Lanes stride over the K
// positions for the logits and over the C classes for the rest.
//
// K12, over the batch's UNIQUE touched rows (ids as JAX's .at[keys].add
// takes them: [-R, -1] wraps, every other out-of-range id is dropped).
// The caller sorts the flat positions by row on the card (K20 key_sort,
// csrc/key_sort.cu; dropped ids sort last). Most touched rows hold one to
// three positions and one is hot — the padding key input_size names a
// real row, 25 of every 64 positions at criteo's widths — so the sum of
// values[pos] * diff[b] / count over each row's run is segmented, with
// no idle lanes: a warp takes 256 sorted positions, a lane 8 of them in
// turn; the runs open at the lanes' ends are joined by a segmented scan
// over the lanes; a run that ends inside the warp's 256 updates its row
// there; a run that crosses the warp's first or last position leaves its
// partial sum in the warp's two slots, and the next level (a launch)
// sums those slots the same way, until one warp holds a level (K3's
// level scheme). One writer a row and a fixed order: the same bits on
// every run, and no host sync (the grids are sized from B*K). Then
// g = sum + reg(W_old) (L1 coef*sign, L2 coef*w, or 0) and
//   sgd:  w -= scale * g  (scale = lr, or 1 for the default updater),
//         optionally writing the delta rows scale * g for the PS push
//         (kept at the run's end position, then packed in row order with
//         the rows themselves, R past the last, by one more launch);
//   ftrl: sigma = (sqrt(n + g^2) - sqrt(n)) / alpha, z += g - sigma * w,
//         n += g^2, optionally writing g - sigma*w and g^2 into zeroed
//         dense push buffers.
// Untouched rows are left alone, which equals the reference's dense
// update on them (g = 0 there). The elementwise arithmetic after the sums
// uses the _rn intrinsics in the reference's order, so no FMA contraction
// changes a rounding: on inputs whose sums are exact in any order the
// kernel and its plain version agree bit for bit.
//
// Bound on the card: bytes. K11 reads keys and values once and one 32-byte
// sector of W (or of z and n) for each distinct row; K12 reads the
// positions' values and diffs and reads and writes one sector of each
// touched row of each table.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLogClip = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;

enum Act { kLinear = 0, kSigmoid = 1, kSoftmax = 2 };
enum Reg { kRegNone = 0, kRegL1 = 1, kRegL2 = 2 };

struct Ftrl {
  float alpha, beta, l1, l2;
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// jnp.sign: -1, +1, or the zero (or NaN) itself.
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// FTRL's weights_of (model.py:211-213), operation by operation:
// -(sign(z) * max(|z| - l1, 0)) / ((beta + sqrt(n)) / alpha + l2).
__device__ __forceinline__ float ftrl_weight(float z, float n, Ftrl f) {
  float excess = __fsub_rn(fabsf(z), f.l1);
  excess = excess < 0.f ? 0.f : excess;
  const float shrunk = __fmul_rn(sign_of(z), excess);
  const float den =
      __fadd_rn(__fdiv_rn(__fadd_rn(f.beta, __fsqrt_rn(n)), f.alpha), f.l2);
  return __fdiv_rn(-shrunk, den);
}

// The row JAX's w[keys] reads: [-R, -1] wraps, then clamp into [0, R-1].
__device__ __forceinline__ int64_t gather_row(int32_t key, int64_t rows) {
  int64_t r = key;
  if (r < 0) r += rows;
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

__device__ __forceinline__ float reg_of(float w, int reg, float coef) {
  if (reg == kRegL1) return __fmul_rn(coef, sign_of(w));
  if (reg == kRegL2) return __fmul_rn(coef, w);
  return 0.f;
}

__global__ void sparse_lr_forward_kernel(
    const float* __restrict__ w, const float* __restrict__ z,
    const float* __restrict__ n, int64_t rows, int C,
    const int32_t* __restrict__ keys, const float* __restrict__ values,
    int B, int K, const int32_t* __restrict__ labels,
    const float* __restrict__ weights, int act, int ftrl_on, Ftrl f,
    float* __restrict__ pred, float* __restrict__ diff,
    float* __restrict__ loss, int32_t* __restrict__ hit) {
  extern __shared__ float smem[];  // [kWarps][C] logits
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp leaves together
  float* lg = smem + (size_t)warp * C;
  const int32_t* kb = keys + (int64_t)b * K;
  const float* vb = values + (int64_t)b * K;
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
    for (int k = lane; k < K; k += 32) {
      const int64_t at = gather_row(kb[k], rows) * C + c;
      const float wv = ftrl_on ? ftrl_weight(__ldg(z + at), __ldg(n + at), f)
                               : __ldg(w + at);
      acc += vb[k] * wv;
    }
    acc = warp_sum(acc);
    if (lane == 0) lg[c] = acc;
  }
  __syncwarp();

  float mx = 0.f, se = 1.f;
  if (act == kSoftmax) {
    mx = -INFINITY;
    for (int c = lane; c < C; c += 32) mx = fmaxf(mx, lg[c]);
    mx = warp_max(mx);
    se = 0.f;
    for (int c = lane; c < C; c += 32) se += expf(lg[c] - mx);
    se = warp_sum(se);
  }
  const bool labelled = labels != nullptr;
  const int lab = labelled ? labels[b] : 0;
  const float wt = labelled ? weights[b] : 0.f;
  float lsum = 0.f, best = -INFINITY, p0 = 0.f;
  int best_c = 0;
  for (int c = lane; c < C; c += 32) {
    const float x = lg[c];
    float p = x;
    if (act == kSigmoid) {
      p = 1.f / (1.f + expf(-x));
    } else if (act == kSoftmax) {
      p = expf(x - mx) / se;
    }
    pred[(int64_t)b * C + c] = p;
    if (c == 0) p0 = p;
    if (!labelled) continue;
    const float y = (C == 1) ? (lab == 1 ? 1.f : 0.f) : (c == lab ? 1.f : 0.f);
    diff[(int64_t)b * C + c] = (p - y) * wt;
    if (act == kSigmoid) {
      lsum -= y * logf(fmaxf(p, kLogClip)) +
              (1.f - y) * logf(fmaxf(1.f - p, kLogClip));
    } else if (act == kSoftmax) {
      lsum -= y * logf(fmaxf(p, kLogClip));
    } else {
      lsum += (p - y) * (p - y);
    }
    if (p > best) {  // the first maximum of this lane's classes
      best = p;
      best_c = c;
    }
  }
  if (!labelled) return;
  lsum = warp_sum(lsum);
  if (act != kSigmoid && act != kSoftmax) lsum /= (float)C;
  // The first maximum over the lanes: larger value, then smaller class.
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, best, o);
    const int oc = __shfl_xor_sync(kFull, best_c, o);
    if (ov > best || (ov == best && oc < best_c)) {
      best = ov;
      best_c = oc;
    }
  }
  if (lane == 0) {
    loss[b] = lsum * wt;
    const int guess = (C == 1) ? (p0 >= 0.5f ? 1 : 0) : best_c;
    hit[b] = (wt > 0.f && guess == lab) ? 1 : 0;
  }
}

// ---- K12 ----

constexpr int kRun = 8;             // sorted positions a lane sums in turn
constexpr int kSpan = 32 * kRun;    // 256 positions a warp's tile

struct Apply {
  float* w;
  float* z;
  float* n;
  int C;
  int64_t rows;             // R; level 0's dropped ids carry the key R
  // The level: level 0 the sorted keys and their flat positions; above,
  // the slots of the level below (key -1: empty; `ends`: the level-0
  // position where the slot's run ends, or -1) with their partial sums.
  const int32_t* keys;
  const int32_t* order;
  const int32_t* ends;
  const float* vals;
  int64_t len;
  // Level 0's terms: values[pos] * diff[pos / K] / count.
  const float* values;
  const float* diff;
  int K;
  const float* count;
  int reg;
  float coef;
  int ftrl_on;
  Ftrl f;
  float scale;
  float* delta_end;         // [N, C] delta rows at their run's end, or null
  float* dz;
  float* dn;
  int32_t* next_keys;       // the next level's slots (two a tile), or null
  int32_t* next_ends;
  float* next_vals;
  int32_t* tile_ends;       // level 0: run ends a tile (with delta_end)
};

// The update of element c of a touched row from its gradient sum and its
// old value(s) (`o1`: w or z; `o2`: n), as the reference orders it
// (FTRL, or sgd with the delta row kept at the run's end position for
// the PS push).
__device__ __forceinline__ void finalize(const Apply& a, int32_t row, int c,
                                         float sum, int32_t end, float o1,
                                         float o2) {
  const int64_t at = (int64_t)row * a.C + c;
  if (a.ftrl_on) {
    const float zo = o1, no = o2;
    const float wo = ftrl_weight(zo, no, a.f);
    const float g = __fadd_rn(sum, reg_of(wo, a.reg, a.coef));
    const float g2 = __fmul_rn(g, g);
    const float sigma = __fdiv_rn(
        __fsub_rn(__fsqrt_rn(__fadd_rn(no, g2)), __fsqrt_rn(no)), a.f.alpha);
    const float step = __fsub_rn(g, __fmul_rn(sigma, wo));
    a.z[at] = __fadd_rn(zo, step);
    a.n[at] = __fadd_rn(no, g2);
    if (a.dz != nullptr) {
      a.dz[at] = step;
      a.dn[at] = g2;
    }
  } else {
    const float wo = o1;
    const float g = __fadd_rn(sum, reg_of(wo, a.reg, a.coef));
    const float d = __fmul_rn(g, a.scale);
    a.w[at] = __fsub_rn(wo, d);
    if (a.delta_end != nullptr) a.delta_end[(int64_t)end * a.C + c] = d;
  }
}

template <bool FIRST>
__device__ __forceinline__ int32_t key_of(const Apply& a, int64_t i) {
  if (i < 0 || i >= a.len) return -1;
  const int32_t k = a.keys[i];
  return FIRST ? (k < a.rows ? k : -1) : k;
}

// One level of the segmented sum: a warp a tile of 256 positions (level
// 0: sorted keys; above: slots), a lane 8 consecutive ones. Each lane
// sums its runs in position order; a run that lies inside the lane is
// complete and updates its row at once; the runs open at the lanes'
// ends are summed over the lanes by a segmented scan (a fixed tree);
// a run that lies inside the tile updates its row from the lane where
// it ends; a run that crosses the tile's first or last position leaves
// its partial sum in the tile's slots for the next level. One writer a
// row, sums in an order fixed by the data.
template <bool FIRST>
__global__ void __launch_bounds__(kThreads) lr_level(Apply a) {
  const int lane = threadIdx.x & 31;
  const int64_t tile = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t lo = tile * kSpan;
  if (lo >= a.len) return;  // the whole warp
  const int64_t mine = lo + lane * kRun;
  int32_t key[kRun], tag[kRun];
  float val[kRun];
  int32_t bix[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int64_t i = mine + j;
    key[j] = key_of<FIRST>(a, i);
    tag[j] = FIRST ? (int32_t)i : (i < a.len ? a.ends[i] : -1);
    val[j] = 0.f;
    bix[j] = 0;
    if (FIRST && key[j] >= 0) {
      const int32_t pos = a.order[i];
      val[j] = a.values[pos];
      bix[j] = pos / a.K;
    }
  }
  const int32_t before = key_of<FIRST>(a, lo - 1);
  const int32_t after = key_of<FIRST>(a, lo + kSpan);
  const int32_t tile_first = __shfl_sync(kFull, key[0], 0);
  const int32_t tile_last = __shfl_sync(kFull, key[kRun - 1], 31);
  const bool cross_left = tile_first >= 0 && tile_first == before;
  const bool cross_right = tile_last >= 0 && tile_last == after;
  int32_t next_first = __shfl_down_sync(kFull, key[0], 1);
  if (lane == 31) next_first = after;
  const int32_t prev_last = __shfl_up_sync(kFull, key[kRun - 1], 1);
  const bool continues = lane > 0 && key[0] >= 0 && key[0] == prev_last;
  if (a.next_keys != nullptr && lane == 0) {
    a.next_keys[2 * tile] = cross_left ? tile_first : -1;
    a.next_keys[2 * tile + 1] = cross_right ? tile_last : -1;
    if (!cross_left) a.next_ends[2 * tile] = -1;
    a.next_ends[2 * tile + 1] = -1;
  }
  if (FIRST && a.tile_ends != nullptr) {
    int ends = 0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int32_t nx = j + 1 < kRun ? key[j + 1] : next_first;
      ends += key[j] >= 0 && key[j] != nx;
    }
    ends = (int)warp_sum((float)ends);
    if (lane == 0) a.tile_ends[tile] = ends;
  }
  const float cnt = FIRST ? *a.count : 1.f;
  for (int c = 0; c < a.C; ++c) {
    float t[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      t[j] = 0.f;
      if (key[j] >= 0) {
        t[j] = FIRST ? __fdiv_rn(__fmul_rn(val[j],
                                           a.diff[(int64_t)bix[j] * a.C + c]),
                                 cnt)
                     : a.vals[(mine + j) * a.C + c];
      }
    }
    // This lane's runs in position order. A run that ends at item j and
    // is complete in the tile leaves its sum in fin[j] (bit j of done);
    // the rows' old values are loaded together afterwards.
    float fin[kRun];
    unsigned done = 0;
    float acc = t[0], first_sum = 0.f;
    bool first_closed = false;
    int first_at = 0;
#pragma unroll
    for (int j = 1; j < kRun; ++j) {
      if (key[j] != key[j - 1]) {
        if (!first_closed) {
          first_sum = acc;
          first_closed = true;
          first_at = j - 1;
        } else if (key[j - 1] >= 0) {
          fin[j - 1] = acc;
          done |= 1u << (j - 1);
        }
        acc = t[j];
      } else {
        acc = __fadd_rn(acc, t[j]);
      }
    }
    // The runs open at the lanes' ends, summed over the lanes.
    float S = acc;
    int F = first_closed || !continues;
    for (int o = 1; o < 32; o <<= 1) {
      const float up_s = __shfl_up_sync(kFull, S, o);
      const int up_f = __shfl_up_sync(kFull, F, o);
      if (lane >= o) {
        if (!F) S = __fadd_rn(up_s, S);
        F |= up_f;
      }
    }
    const float carry = __shfl_up_sync(kFull, S, 1);
    float* slot0 = a.next_vals + (2 * tile) * a.C + c;
    float* slot1 = a.next_vals + (2 * tile + 1) * a.C + c;
    if (first_closed && key[0] >= 0) {
      // The lane's first run ended inside the lane.
      const float total = continues ? __fadd_rn(carry, first_sum)
                                    : first_sum;
#pragma unroll
      for (int j = 0; j < kRun - 1; ++j) {
        if (j != first_at) continue;
        if (cross_left && key[0] == tile_first) {
          *slot0 = total;
          if (c == 0) a.next_ends[2 * tile] = tag[j];
        } else {
          fin[j] = total;
          done |= 1u << j;
        }
      }
    }
    const int32_t tail = key[kRun - 1];
    if (tail >= 0 && tail != next_first) {
      // The lane's last run ends at the lane's end.
      if (cross_left && tail == tile_first) {
        *slot0 = S;
        if (c == 0) a.next_ends[2 * tile] = tag[kRun - 1];
      } else {
        fin[kRun - 1] = S;
        done |= 1u << (kRun - 1);
      }
    } else if (lane == 31 && cross_right) {
      // It runs on into the next tile.
      if (cross_left && tail == tile_first) {
        *slot0 = S;
        *slot1 = 0.f;
        if (c == 0) a.next_ends[2 * tile] = -1;
      } else {
        *slot1 = S;
      }
    }
    // The complete runs' rows: every old value loaded, then updated.
    float o1[kRun], o2[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      o1[j] = o2[j] = 0.f;
      if (!(done >> j & 1u)) continue;
      const int64_t at = (int64_t)key[j] * a.C + c;
      if (a.ftrl_on) {
        o1[j] = a.z[at];
        o2[j] = a.n[at];
      } else {
        o1[j] = a.w[at];
      }
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      if (done >> j & 1u) finalize(a, key[j], c, fin[j], tag[j], o1[j], o2[j]);
  }
}

// The touched rows in order and their delta rows (PS push): a warp a
// level-0 tile; rows past the U touched ones read R.
__global__ void __launch_bounds__(kThreads) lr_rows(
    const int32_t* __restrict__ keys, int64_t len, int64_t rows, int C,
    const int32_t* __restrict__ tile_ends, int64_t tiles,
    const float* __restrict__ delta_end, int64_t* __restrict__ rows_out,
    float* __restrict__ delta_out) {
  const int lane = threadIdx.x & 31;
  const int64_t tile = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (tile >= tiles) return;
  int64_t base = 0, total = 0;
  for (int64_t t = lane; t < tiles; t += 32) {
    const int32_t e = tile_ends[t];
    total += e;
    if (t < tile) base += e;
  }
  for (int o = 16; o > 0; o >>= 1) {
    base += __shfl_xor_sync(kFull, base, o);
    total += __shfl_xor_sync(kFull, total, o);
  }
  const int64_t lo = tile * kSpan + lane * kRun;
  bool end[kRun];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int64_t i = lo + j;
    const int32_t k = i < len ? keys[i] : (int32_t)rows;
    const int32_t nx = i + 1 < len ? keys[i + 1] : (int32_t)rows;
    end[j] = k < rows && k != nx;
    mine += end[j];
  }
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  int64_t u = base + incl - mine;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int64_t i = lo + j;
    if (i < len && i >= total) rows_out[i] = rows;
    if (!end[j]) continue;
    rows_out[u] = keys[i];
    for (int c = 0; c < C; ++c)
      delta_out[u * C + c] = delta_end[i * C + c];
    ++u;
  }
}

}  // namespace

extern "C" cudaError_t mv_sparse_lr_forward(
    const float* w, const float* z, const float* n, int64_t rows, int C,
    const int32_t* keys, const float* values, int B, int K,
    const int32_t* labels, const float* weights, int act, int ftrl_on,
    float alpha, float beta, float l1, float l2, float* pred, float* diff,
    float* loss, int32_t* hit, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  const size_t smem = (size_t)kWarps * C * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const Ftrl f{alpha, beta, l1, l2};
  const unsigned blocks = (unsigned)((B + kWarps - 1) / kWarps);
  sparse_lr_forward_kernel<<<blocks, kThreads, smem, stream>>>(
      w, z, n, rows, C, keys, values, B, K, labels, weights, act, ftrl_on, f,
      pred, diff, loss, hit);
  return cudaGetLastError();
}

// The slots of the levels: cap_a [2 * ceil(len / 256)] for levels 1, 3,
// ..., the rest for 2, 4, ... (keys, ends and C partials each).
// delta_end [len, C], tile_ends [ceil(len / 256)], rows_out [len] and
// delta_out [len, C] go together: given, the touched rows and their
// delta rows are written; null, none is.
extern "C" cudaError_t mv_sparse_lr_apply(
    float* w, float* z, float* n, int C, int64_t rows, const int32_t* keys,
    const int32_t* order, int64_t len, const float* values,
    const float* diff, int K, const float* count, int reg, float coef,
    int ftrl_on, float alpha, float beta, float l1, float l2, float scale,
    float* dz, float* dn, int32_t* slot_keys, int32_t* slot_ends,
    float* slot_vals, int64_t cap_a, float* delta_end, int32_t* tile_ends,
    int64_t* rows_out, float* delta_out, cudaStream_t stream) {
  if (len <= 0) return cudaSuccess;
  Apply a{w,     z,    n,    C,       rows,   keys,   order,  nullptr,
          nullptr, len, values, diff, K,      count,  reg,    coef,
          ftrl_on, Ftrl{alpha, beta, l1, l2}, scale,  delta_end, dz, dn,
          nullptr, nullptr, nullptr, tile_ends};
  const int64_t tiles0 = (len + kSpan - 1) / kSpan;
  for (int level = 0;; ++level) {
    const int64_t tiles = (a.len + kSpan - 1) / kSpan;
    const int64_t at = level % 2 == 0 ? 0 : cap_a;
    const bool last = tiles == 1;
    a.next_keys = last ? nullptr : slot_keys + at;
    a.next_ends = last ? nullptr : slot_ends + at;
    a.next_vals = last ? nullptr : slot_vals + at * C;
    const unsigned blocks = (unsigned)((tiles * 32 + kThreads - 1) / kThreads);
    if (level == 0) {
      lr_level<true><<<blocks, kThreads, 0, stream>>>(a);
    } else {
      lr_level<false><<<blocks, kThreads, 0, stream>>>(a);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (last) break;
    a.keys = a.next_keys;
    a.ends = a.next_ends;
    a.vals = a.next_vals;
    a.order = nullptr;
    a.len = 2 * tiles;
    a.tile_ends = nullptr;
  }
  if (rows_out == nullptr) return cudaSuccess;
  const unsigned blocks = (unsigned)((tiles0 * 32 + kThreads - 1) / kThreads);
  lr_rows<<<blocks, kThreads, 0, stream>>>(keys, len, rows, C, tile_ends,
                                           tiles0, delta_end, rows_out,
                                           delta_out);
  return cudaGetLastError();
}
