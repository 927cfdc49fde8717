// K11 sparse_lr_forward and K12 sparse_lr_apply: the sparse logistic
// regression step; and K21 dense_lr_forward, K11's elementwise part for
// the dense models (at its definition below).
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
// K11: logits[c] = sum_k values[b,k] * W[key, c], W gathered as JAX's
// w[keys] gathers (an id in [-R, -1] wraps, then every id clamps into
// [0, R-1]); W is w, or FTRL's weights_of(z, n) computed for the gathered
// rows only. Then pred = act(logits) (linear, sigmoid, or softmax), and
// with labels diff = (pred - onehot) * weight[b], the per-sample loss
// times its weight and the per-sample hit (pred >= 0.5 for one output,
// else the first argmax, counted only where weight > 0), formed as the
// reference's XLA forms them: its exp and log, the loss's products fused
// into the sum over classes, every class loop in class order. A sample
// takes G lanes (the host's forward_lanes: at criteo's K of 64 padded
// and one class, 8 lanes, 4 samples a warp and 8 terms a lane; a warp
// for several classes). Each lane issues all its key and value loads,
// then all its row (or z and n) gathers, before its first add, sums its
// positions in order, and the group's xor tree (log2 G shuffles) sums
// the lanes; lane 0 then finishes the sample alone, with no warp-wide
// reduction. The order is fixed, and sparse_lr_forward_ordered
// (kernels/logreg.py) is its model on the CPU: the same bits.
//
// K12, over the batch's UNIQUE touched rows (ids as JAX's .at[keys].add
// takes them: [-R, -1] wraps, every other out-of-range id is dropped).
// The reference folds zeros.at[keys].add(u) + touched * reg(w) into ONE
// scatter-add into touched * reg(w) (reg: L1 coef*sign(w), L2 coef*w, or
// +0), which XLA's CPU backend runs as a loop over the positions in
// order. K12 forms each row's sum the same way: from reg(w_old), the
// terms values[pos] * diff[b] / count added one by one in position order
// (ROADMAP C13). The caller sorts the flat positions by row on the card
// (K20 key_sort, csrc/key_sort.cu: stable, so a row's run is in position
// order; dropped ids sort last). Most touched rows hold one to three
// positions, a few are hot: the padding key input_size names a real row
// (25 of every 64 positions at criteo's widths, every term a zero) and
// criteo's 13 numeric keys sit in every sample. lr_runs takes a warp a
// tile of 256 sorted positions: the terms go to shared memory, and the
// lane at the head of a run that lies in the tile sums it and updates
// its row. A run that leaves its tile is listed and summed by a block of
// lr_long: a stretch of tiles whose terms are all zeros adds as ONE zero
// (adding zeros changes only a zero sum's sign: +0 if any term is +0),
// from the per-tile flags lr_runs records, and the tiles with a nonzero
// term are loaded eight at a time and added by one thread, a dependent
// add a term: the reference's order allows no tree. One writer a row:
// the same bits on every run, and no host sync. Then
//   sgd:  w = fma(-g, scale, w) (LocalModel's fused program), or with
//         the PS push d = g * scale, w -= d, the delta rows kept at the
//         run's end position, then packed in row order with the rows
//         themselves, R past the last, by one more launch (lr_rows);
//   ftrl: n' = fma(g, g, n), sigma = (sqrt(n') - sqrt(n)) * (1/alpha),
//         z += g - sigma * w, optionally writing g - sigma*w and g*g
//         into zeroed dense push buffers.
// Every other operation is an _rn intrinsic in the reference's order.
// Untouched rows are left alone, which equals the reference's dense
// update on them but for zeros and subnormals: that update flushes a
// subnormal, and under a regularizer and in FTRL's state turns a -0 or a
// subnormal into +0 ("plus"). The step settles them in its first kernel,
// lr_settle, when its SettleFlag slot is up: the host raises it after a
// load or a pull, and K12 raises it, under "plus", when it writes a -0
// into a touched row (ROADMAP C12). No host sync either way.
//
// Bound on the card: bytes. K11 reads keys and values once and one 32-byte
// sector of W (or of z and n) for each distinct row; K12 reads the
// positions' values and diffs and reads and writes one sector of each
// touched row of each table. Beside the bytes, K12's hot rows wait on a
// chain of dependent adds, one a term in the reference's order (4,096 a
// batch for each of criteo's 13 numeric keys), which no tree may
// shorten.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kLogClip = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;

enum Act { kLinear = 0, kSigmoid = 1, kSoftmax = 2 };
enum Reg { kRegNone = 0, kRegL1 = 1, kRegL2 = 2 };

// inv_alpha: 1/alpha rounded to float32, as the reference's XLA turns the
// division by the constant alpha into a multiplication.
struct Ftrl {
  float inv_alpha, beta, l1, l2;
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// jnp.sign: -1, +1, or the zero (or NaN) itself.
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// FTRL's weights_of (model.py:211-213), operation by operation as the
// reference's XLA compiles it: -(sign(z) * max(|z| - l1, 0)) /
// fma(sqrt(n) + beta, 1/alpha, l2).
__device__ __forceinline__ float ftrl_weight(float z, float n, Ftrl f) {
  float excess = __fsub_rn(fabsf(z), f.l1);
  excess = excess < 0.f ? 0.f : excess;
  const float shrunk = __fmul_rn(sign_of(z), excess);
  const float den =
      __fmaf_rn(__fadd_rn(__fsqrt_rn(n), f.beta), f.inv_alpha, f.l2);
  return __fdiv_rn(-shrunk, den);
}

// XLA's exp on the CPU before its last step (ROADMAP C13): the input
// clamped, 2^k split off, a degree-5 polynomial, the products fused into
// the adds that follow them as the reference's machine code fuses them;
// exp(x) = e1 * scale (kernels/logreg.py _exp_parts).
struct ExpParts {
  float e1, scale;
};

__device__ __forceinline__ ExpParts xla_exp_parts(float x) {
  const float lo = __int_as_float(0xC2AF999A), hi = __int_as_float(0x42B1999A);
  x = (x >= lo || isnan(x)) ? x : lo;
  x = (x <= hi || isnan(x)) ? x : hi;
  float k = floorf(__fmaf_rn(x, __int_as_float(0x3FB8AA3B), 0.5f));
  k = k >= -127.f ? k : -127.f;
  k = k <= 127.f ? k : 127.f;
  float r = __fmaf_rn(-k, __int_as_float(0x3F318000), x);
  r = __fmaf_rn(-k, __int_as_float(0xB95E8083), r);
  float y = __fmaf_rn(__int_as_float(0x39506967), r, __int_as_float(0x3AB743CE));
  y = __fmaf_rn(y, r, __int_as_float(0x3C088908));
  y = __fmaf_rn(y, r, __int_as_float(0x3D2AA9C1));
  y = __fmaf_rn(y, r, __int_as_float(0x3E2AAAAA));
  y = __fmaf_rn(y, r, 0.5f);
  return {__fadd_rn(__fmaf_rn(y, __fmul_rn(r, r), r), 1.f),
          __int_as_float(((int)k + 127) << 23)};
}

// jax.nn.sigmoid as the reference's XLA compiles it: 1 / (exp(-z) + 1),
// the scaling by 2^k fused into the + 1.
__device__ __forceinline__ float xla_sigmoid(float z) {
  const ExpParts p = xla_exp_parts(-z);
  return __fdiv_rn(1.f, __fmaf_rn(p.e1, p.scale, 1.f));
}

__device__ __forceinline__ float xla_exp(float x) {
  const ExpParts p = xla_exp_parts(x);
  return __fmul_rn(p.e1, p.scale);
}

// jnp.log as the reference's XLA compiles it on the CPU (ROADMAP C14; its
// constants read from the compiled loss, kernels/logreg.py log): the
// mantissa and exponent split off, a degree-8 polynomial in three fused
// chains, e * ln 2 added in two parts. 0 gives -inf, +inf itself, a
// negative or NaN input NaN with every bit set.
__device__ __forceinline__ float xla_log(float x) {
  const float flt_min = __int_as_float(0x00800000);
  const int bits = __float_as_int(x > flt_min ? x : flt_min);
  float e = __fadd_rn((float)((bits >> 23) - 127), 1.f);
  const float mant = __int_as_float((bits & (int)0x807FFFFF) | 0x3F000000);
  const bool low = mant < __int_as_float(0x3F3504F3);
  e = __fsub_rn(e, low ? 1.f : 0.f);
  const float m = __fadd_rn(__fsub_rn(mant, 1.f), low ? mant : 0.f);
  const float m2 = __fmul_rn(m, m), m3 = __fmul_rn(m2, m);
  float y = __fmaf_rn(__fmaf_rn(m, __int_as_float(0x3D9021BB),
                                __int_as_float(0xBDEBD1B8)),
                      m, __int_as_float(0x3DEF251A));
  const float y1 = __fmaf_rn(__fmaf_rn(m, __int_as_float(0xBDFE5D4F),
                                       __int_as_float(0x3E11E9BF)),
                             m, __int_as_float(0xBE2AAE50));
  const float y2 = __fmaf_rn(__fmaf_rn(m, __int_as_float(0x3E4CCEAC),
                                       __int_as_float(0xBE7FFFFC)),
                             m, __int_as_float(0x3EAAAAAA));
  y = __fmaf_rn(y, m3, y1);
  y = __fmaf_rn(y, m3, y2);
  y = __fmaf_rn(y, m3, __fmul_rn(e, __int_as_float(0xB95E8083)));
  const float r = __fmaf_rn(e, __int_as_float(0x3F318000),
                            __fadd_rn(__fmaf_rn(-0.5f, m2, m), y));
  if (x == 0.f) return -INFINITY;
  if (x == INFINITY) return x;
  return x > 0.f ? r : __int_as_float(-1);
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

// ---- K11 ----

constexpr int kFwdThreads = 128;
constexpr int kTerms = 8;  // terms a lane loads at once (FWD_TERMS)

struct Fwd {
  const float* w;
  const float* z;
  const float* n;
  int64_t rows;
  int C;
  const int32_t* keys;
  const float* values;
  int B, K;
  const int32_t* labels;  // null: pred only
  const float* weights;
  int act;
  int ftrl_on;
  Ftrl f;
  float inv_c;            // float32 1/C: the linear loss's mean
  float* pred;
  float* diff;
  float* loss;
  int32_t* hit;
};

// One sample's activation, loss and hit from its C logits lg (in place:
// lg becomes pred), as kernels/logreg.py forms them (activation,
// sample_loss, sample_hits): every class loop in class order, the
// softmax's max and sum and the loss's sum over classes; the loss's
// products fused as the reference fuses them. ONE: C == 1.
template <bool ONE>
__device__ __forceinline__ void finish_sample(const Fwd& a, float* lg,
                                              int64_t b) {
  const int C = ONE ? 1 : a.C;
  if (a.act == kSigmoid) {
    for (int c = 0; c < C; ++c) lg[c] = xla_sigmoid(lg[c]);
  } else if (a.act == kSoftmax) {
    float m = lg[0];
    for (int c = 1; c < C; ++c) m = fmaxf(m, lg[c]);
    float s = 0.f;
    for (int c = 0; c < C; ++c) {
      lg[c] = xla_exp(__fsub_rn(lg[c], m));
      s = __fadd_rn(s, lg[c]);
    }
    for (int c = 0; c < C; ++c) lg[c] = __fdiv_rn(lg[c], s);
  }
  for (int c = 0; c < C; ++c) a.pred[b * C + c] = lg[c];
  if (a.labels == nullptr) return;
  const int lab = a.labels[b];
  const float wt = a.weights[b];
  float acc = 0.f, best = -INFINITY;
  int best_c = 0;
  for (int c = 0; c < C; ++c) {
    const float p = lg[c];
    const float y = (ONE ? lab == 1 : c == lab) ? 1.f : 0.f;
    a.diff[b * C + c] = __fmul_rn(__fsub_rn(p, y), wt);
    if (a.act == kSigmoid) {
      const float t = __fmaf_rn(
          y, xla_log(fmaxf(p, kLogClip)),
          __fmul_rn(__fsub_rn(1.f, y),
                    xla_log(fmaxf(__fsub_rn(1.f, p), kLogClip))));
      acc = ONE ? t : __fadd_rn(acc, t);  // XLA folds a sum of one
    } else if (a.act == kSoftmax) {
      acc = __fmaf_rn(y, xla_log(fmaxf(p, kLogClip)), acc);
    } else {
      const float d = __fsub_rn(p, y);
      acc = __fmaf_rn(d, d, acc);
    }
    if (p > best) {  // the first maximum
      best = p;
      best_c = c;
    }
  }
  const float l = a.act == kLinear ? __fmul_rn(acc, a.inv_c) : -acc;
  a.loss[b] = __fmul_rn(l, wt);
  const int guess = ONE ? (lg[0] >= 0.5f ? 1 : 0) : best_c;
  a.hit[b] = (wt > 0.f && guess == lab) ? 1 : 0;
}

// G lanes a sample (a power of two; the host's forward_lanes). Lane g of a
// group takes positions g, g + G, g + 2G, ...: it loads kTerms keys and
// values, then their rows (or FTRL's z and n), all before its first add,
// and adds its products in position order from +0. The group's xor tree
// then sums the lanes (log2 G shuffles, the same bits in every lane), and
// lane 0 finishes the sample alone. ONE (C == 1): the logit stays in a
// register; else (a warp a sample) the C logits go to shared memory.
template <int G, bool ONE>
__global__ void __launch_bounds__(kFwdThreads) lr_forward(Fwd a) {
  extern __shared__ float s_logits[];  // [kFwdThreads / 32][C] (not ONE)
  const int g = threadIdx.x & (G - 1);
  const int64_t b = ((int64_t)blockIdx.x * kFwdThreads + threadIdx.x) / G;
  const bool live = b < a.B;  // dead lanes still join the shuffles
  const int32_t* kb = a.keys + (live ? b : 0) * a.K;
  const float* vb = a.values + (live ? b : 0) * a.K;
  const int C = ONE ? 1 : a.C;
  float reg[1];
  float* lg = ONE ? reg : s_logits + (threadIdx.x >> 5) * a.C;
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
    for (int k0 = g; k0 < a.K; k0 += G * kTerms) {
      int64_t at[kTerms];
      float val[kTerms], wv[kTerms];
#pragma unroll
      for (int j = 0; j < kTerms; ++j) {
        const int k = k0 + j * G;
        const bool in = live && k < a.K;
        at[j] = in ? gather_row(__ldg(kb + k), a.rows) * C + c : -1;
        val[j] = in ? __ldg(vb + k) : 0.f;
      }
      if (a.ftrl_on) {
        float zz[kTerms], nn[kTerms];
#pragma unroll
        for (int j = 0; j < kTerms; ++j) {
          zz[j] = at[j] >= 0 ? __ldg(a.z + at[j]) : 0.f;
          nn[j] = at[j] >= 0 ? __ldg(a.n + at[j]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kTerms; ++j)
          wv[j] = ftrl_weight(zz[j], nn[j], a.f);
      } else {
#pragma unroll
        for (int j = 0; j < kTerms; ++j)
          wv[j] = at[j] >= 0 ? __ldg(a.w + at[j]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kTerms; ++j)
        if (at[j] >= 0) acc = __fadd_rn(acc, __fmul_rn(val[j], wv[j]));
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, o));
    if (g == 0 && live) lg[c] = acc;
  }
  if (!ONE) __syncwarp();
  if (g == 0 && live) finish_sample<ONE>(a, lg, b);
}

template <int G, bool ONE>
cudaError_t launch_forward(const Fwd& a, cudaStream_t stream) {
  const int64_t per_block = kFwdThreads / G;
  const unsigned blocks = (unsigned)((a.B + per_block - 1) / per_block);
  const size_t smem =
      ONE ? 0 : (size_t)(kFwdThreads / 32) * a.C * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  lr_forward<G, ONE><<<blocks, kFwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- K21 ----

// K21 dense_lr_forward: the dense models' elementwise stages after their
// x @ w (make_dense_step, multiverso_tpu/models/logreg/objective.py:
// 67-86): K11's finish from given logits, a thread a sample (C logits in
// a register, or in shared memory for several classes). Bound on the
// card: bytes (the logits read once, pred and diff written once); at the
// dense paths' batches (20 samples) a launch.
constexpr int kDenseThreads = 128;

template <bool ONE>
__global__ void __launch_bounds__(kDenseThreads) lr_dense_forward(
    Fwd a, const float* __restrict__ logits) {
  extern __shared__ float s_dense[];  // [blockDim.x][C] (not ONE)
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int C = ONE ? 1 : a.C;
  float reg[1];
  float* lg = ONE ? reg : s_dense + (size_t)threadIdx.x * C;
  for (int c = 0; c < C; ++c) lg[c] = logits[b * C + c];
  finish_sample<ONE>(a, lg, b);
}

// ---- K12 ----

constexpr int kRun = 8;             // sorted positions a lane takes
constexpr int kSpan = 32 * kRun;    // 256 positions a warp's tile
constexpr uint8_t kNonzero = 1, kPlusZero = 2;  // a segment's term flags
constexpr int kBatch = kThreads / 32;  // tiles a long run loads at once

struct Apply {
  float* w;
  float* z;
  float* n;
  int C;
  int64_t rows;             // R: dropped ids carry the key R, sorted last
  const int32_t* keys;      // [len] sorted keys
  const int32_t* order;     // [len] each one's flat position b * K + k
  int64_t len;
  const float* values;
  const float* diff;
  int K;
  const float* count;
  int reg;
  float coef;
  int ftrl_on;
  Ftrl f;
  float scale;
  int fused;                // sgd: w - g * scale as one fused multiply-add
  float* delta_end;         // [len, C] delta rows at their run's end, or null
  float* dz;
  float* dn;
  int32_t* tile_ends;       // [tiles] run ends a tile
  int32_t* long_heads;      // [tiles] heads of the runs that leave their tile
  int32_t* long_count;
  uint8_t* seg_flags;       // [tiles][2][C]: first and last segment's flags
  int32_t* settle;          // SettleFlag's two slots, or null
  int epoch;
  int plus;                 // settle to +0 (else flush to the sign's zero)
};

// Term of sorted position p in column c: values[pos] * diff[b, c] / count,
// as the reference's updates (objective.py:104).
__device__ __forceinline__ float term_of(const Apply& a, int64_t p, int c,
                                         float cnt) {
  const int32_t pos = a.order[p];
  return __fdiv_rn(__fmul_rn(a.values[pos],
                             a.diff[(int64_t)(pos / a.K) * a.C + c]),
                   cnt);
}

// A touched row's element before the update: o1 (w, or FTRL's z), o2
// (FTRL's n) and the weight w_old; returns the gradient's first value,
// touched * reg(w_old) (+0 without a regularizer), into which the
// reference's scatter adds the terms.
__device__ __forceinline__ float row_start(const Apply& a, int32_t row, int c,
                                           float& o1, float& o2,
                                           float& wo) {
  const int64_t at = (int64_t)row * a.C + c;
  if (a.ftrl_on) {
    o1 = a.z[at];
    o2 = a.n[at];
    wo = ftrl_weight(o1, o2, a.f);
  } else {
    o1 = a.w[at];
    o2 = 0.f;
    wo = o1;
  }
  return reg_of(wo, a.reg, a.coef);
}

__device__ __forceinline__ bool neg_zero(float x) {
  return __float_as_uint(x) == 0x80000000u;
}

// The update of element c of a touched row from its gradient g, as the
// reference forms it (LocalModel's w - g * lr fused; PSModel's delta
// rounded, kept at the run's end position for the push; FTRL's n + g * g
// fused and its 1/alpha a multiplication). A -0 written raises the
// SettleFlag of this epoch under "plus".
__device__ __forceinline__ void finalize(const Apply& a, int32_t row, int c,
                                         float g, int64_t end, float o1,
                                         float o2, float wo) {
  const int64_t at = (int64_t)row * a.C + c;
  bool zero;
  if (a.ftrl_on) {
    const float nn = __fmaf_rn(g, g, o2);
    const float sigma = __fmul_rn(
        __fsub_rn(__fsqrt_rn(nn), __fsqrt_rn(o2)), a.f.inv_alpha);
    const float step = __fsub_rn(g, __fmul_rn(sigma, wo));
    const float zn = __fadd_rn(o1, step);
    a.z[at] = zn;
    a.n[at] = nn;
    if (a.dz != nullptr) {
      a.dz[at] = step;
      a.dn[at] = __fmul_rn(g, g);
    }
    zero = neg_zero(zn) || neg_zero(nn);
  } else {
    float wn;
    if (a.fused) {
      wn = __fmaf_rn(-g, a.scale, o1);
    } else {
      const float d = __fmul_rn(g, a.scale);
      wn = __fsub_rn(o1, d);
      if (a.delta_end != nullptr) a.delta_end[end * a.C + c] = d;
    }
    a.w[at] = wn;
    zero = neg_zero(wn);
  }
  if (zero && a.plus && a.settle != nullptr) a.settle[a.epoch & 1] = a.epoch;
}

__device__ __forceinline__ int32_t key_at(const Apply& a, int64_t i) {
  return (i >= 0 && i < a.len) ? a.keys[i] : -1;
}

// Runs, a warp a tile of 256 sorted positions, a lane 8 consecutive
// ones. A run that lies inside the tile is summed by the lane of its
// head, from its regularization term in position order (the terms from
// the warp's shared row), and updated at once; a run that leaves the
// tile is listed for lr_long (summing the short ones here from memory
// made lr_runs slower by more than it saved lr_long). For those, each tile also records, per
// column, whether its first and its last segment (the positions of its
// first and its last key) hold a nonzero term and a +0 term.
__global__ void __launch_bounds__(kThreads) lr_runs(Apply a) {
  __shared__ float s_term[kThreads / 32][kSpan];
  __shared__ int32_t s_key[kThreads / 32][kSpan];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int64_t tile = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t lo = tile * kSpan;
  if (lo >= a.len) return;  // the whole warp
  const int64_t hi = (a.len - lo < kSpan ? a.len - lo : kSpan);  // positions
  int32_t key[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int at = lane * kRun + j;
    key[j] = at < hi ? a.keys[lo + at] : -1;
    s_key[wib][at] = key[j];
  }
  __syncwarp();
  const int32_t first = s_key[wib][0], last = s_key[wib][hi - 1];
  const bool cross_left = first < a.rows && key_at(a, lo - 1) == first;
  const bool cross_right = last < a.rows && key_at(a, lo + hi) == last;
  bool head[kRun];
  int ends = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int at = lane * kRun + j;
    const int32_t prev = at > 0 ? s_key[wib][at - 1] : key_at(a, lo - 1);
    const int32_t next = at + 1 < hi ? s_key[wib][at + 1] : key_at(a, lo + hi);
    const bool valid = at < hi && key[j] < a.rows;
    head[j] = valid && key[j] != prev;
    ends += valid && key[j] != next;
    // A head whose run leaves the tile is lr_long's.
    if (head[j] && key[j] == last && cross_right) {
      head[j] = false;
      a.long_heads[atomicAdd(a.long_count, 1)] = (int32_t)(lo + at);
    }
  }
  if (a.tile_ends != nullptr) {
    ends = (int)warp_sum((float)ends);
    if (lane == 0) a.tile_ends[tile] = ends;
  }
  const float cnt = *a.count;
  for (int c = 0; c < a.C; ++c) {
    bool nz_first = false, pz_first = false, nz_last = false,
         pz_last = false;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int at = lane * kRun + j;
      const bool valid = at < hi && key[j] < a.rows;
      const float t = valid ? term_of(a, lo + at, c, cnt) : 0.f;
      s_term[wib][at] = t;
      if (valid && key[j] == first) {
        nz_first |= t != 0.f;
        pz_first |= __float_as_uint(t) == 0u;
      }
      if (valid && key[j] == last) {
        nz_last |= t != 0.f;
        pz_last |= __float_as_uint(t) == 0u;
      }
    }
    const unsigned full = 0xffffffffu;
    nz_first = __any_sync(full, nz_first);
    pz_first = __any_sync(full, pz_first);
    nz_last = __any_sync(full, nz_last);
    pz_last = __any_sync(full, pz_last);
    if (lane == 0 && (cross_left || cross_right)) {
      uint8_t* fl = a.seg_flags + (tile * 2) * a.C + c;
      fl[0] = (nz_first ? kNonzero : 0) | (pz_first ? kPlusZero : 0);
      fl[a.C] = (nz_last ? kNonzero : 0) | (pz_last ? kPlusZero : 0);
    }
    __syncwarp();
    // This lane's runs: the old values loaded together, then summed.
    float o1[kRun], o2[kRun], wo[kRun], g[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      if (head[j]) g[j] = row_start(a, key[j], c, o1[j], o2[j], wo[j]);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (!head[j]) continue;
      int at = lane * kRun + j;
      float acc = g[j];
      do {
        acc = __fadd_rn(acc, s_term[wib][at]);
        ++at;
      } while (at < hi && s_key[wib][at] == key[j]);
      finalize(a, key[j], c, acc, lo + at - 1, o1[j], o2[j], wo[j]);
    }
    __syncwarp();
  }
}

// The runs that leave their tile (lr_runs' list), a block each: in
// position order from the regularization term, as the reference's scatter
// loop adds them. Between two tiles with a nonzero term, a stretch of
// tiles whose terms are all zeros adds as ONE zero (+0 if any of them is
// +0, else -0: adding zeros changes only a zero sum, and only its sign),
// so a long run of zero terms (the padding key's) costs its flags; the
// tiles with a nonzero term are loaded kBatch at a time and summed by one
// thread.
__global__ void __launch_bounds__(kThreads) lr_long(Apply a) {
  __shared__ __align__(16) float s_term[kBatch][kSpan];
  __shared__ int64_t s_tile[kBatch];
  __shared__ int s_nb, s_end_tile, s_tail, s_cursor;
  __shared__ unsigned s_nz[kThreads / 32], s_pz[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, wib = tid >> 5;
  const int64_t tiles = (a.len + kSpan - 1) / kSpan;
  const float cnt = *a.count;
  for (int slot = blockIdx.x; slot < *a.long_count; slot += gridDim.x) {
    const int64_t h = a.long_heads[slot];
    const int32_t key = a.keys[h];
    const int64_t th = h / kSpan;
    // The run's last tile: the tile before the first later tile that
    // does not start with the key.
    if (tid == 0) s_end_tile = (int)(tiles - 1);
    __syncthreads();
    for (int64_t base = th + 1; base < tiles; base += kThreads) {
      const int64_t t = base + tid;
      if (t < tiles && a.keys[t * kSpan] != key) atomicMin(&s_end_tile, (int)(t - 1));
      if (__syncthreads_or(s_end_tile < tiles - 1)) break;
    }
    const int64_t te = s_end_tile;
    {
      const int64_t p = te * kSpan + tid;
      const int in_run = p < a.len && a.keys[p] == key;
      const int tail = __syncthreads_count(in_run);
      if (tid == 0) s_tail = tail;
    }
    __syncthreads();
    const int64_t e = te * kSpan + s_tail - 1;
    for (int c = 0; c < a.C; ++c) {
      float o1 = 0.f, o2 = 0.f, wo = 0.f, acc = 0.f;
      if (tid == 0) acc = row_start(a, key, c, o1, o2, wo);
      // The run's tiles [th, te] in windows of kThreads: their flags (the
      // head tile's last segment, the others' first).
      for (int64_t w0 = th; w0 <= te; w0 += kThreads) {
        const int64_t t = w0 + tid;
        uint8_t fl = 0;
        if (t <= te) fl = a.seg_flags[(t * 2 + (t == th ? 1 : 0)) * a.C + c];
        const unsigned nzb = __ballot_sync(0xffffffffu, fl & kNonzero);
        const unsigned pzb = __ballot_sync(0xffffffffu, fl & kPlusZero);
        if (lane == 0) {
          s_nz[wib] = nzb;
          s_pz[wib] = pzb;
        }
        __syncthreads();
        const int span = (int)(te - w0 + 1 < kThreads ? te - w0 + 1 : kThreads);
        if (tid == 0) s_cursor = 0;  // the window's first tile not added
        for (;;) {
          // The next kBatch tiles with a nonzero term.
          if (tid == 0) {
            int nb = 0;
            for (int i = s_cursor; i < span && nb < kBatch; ++i)
              if (s_nz[i >> 5] >> (i & 31) & 1u) s_tile[nb++] = w0 + i;
            s_nb = nb;
          }
          __syncthreads();
          const int nb = s_nb;
          if (wib < nb) {  // warp b loads tile s_tile[b]'s terms in the run
            const int64_t t = s_tile[wib];
#pragma unroll
            for (int j = 0; j < kRun; ++j) {
              const int64_t p = t * kSpan + lane * kRun + j;
              s_term[wib][lane * kRun + j] =
                  (p >= h && p <= e) ? term_of(a, p, c, cnt) : 0.f;
            }
          }
          __syncthreads();
          if (tid == 0) {
            // The zero stretch before each loaded tile, then its terms;
            // after the window's last one, the stretch to the window's end.
            for (int b = 0; b <= nb; ++b) {
              if (b == nb && nb == kBatch) break;
              const int upto = b < nb ? (int)(s_tile[b] - w0) : span;
              bool any = false, plus = false;
              for (int i = s_cursor; i < upto; ++i) {
                any = true;
                plus |= (s_pz[i >> 5] >> (i & 31)) & 1u;
              }
              if (any) acc = __fadd_rn(acc, plus ? 0.f : -0.f);
              s_cursor = upto;
              if (b == nb) break;
              const int64_t t = s_tile[b];
              const int64_t p0 = t * kSpan > h ? t * kSpan : h;
              const int64_t p1 =
                  t * kSpan + kSpan - 1 < e ? t * kSpan + kSpan - 1 : e;
              // Sixteen terms (four 16-byte loads) in flight before their
              // sixteen adds.
              const int off = (int)(p0 - t * kSpan);
              const int end = (int)(p1 - t * kSpan) + 1;
              const float* row = s_term[b];
              int q = off;
              for (; q < end && (q & 3); ++q) acc = __fadd_rn(acc, row[q]);
              for (; q + 16 <= end; q += 16) {
                float4 x[4];
#pragma unroll
                for (int u = 0; u < 4; ++u)
                  x[u] = reinterpret_cast<const float4*>(row + q)[u];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  acc = __fadd_rn(acc, x[u].x);
                  acc = __fadd_rn(acc, x[u].y);
                  acc = __fadd_rn(acc, x[u].z);
                  acc = __fadd_rn(acc, x[u].w);
                }
              }
              for (; q < end; ++q) acc = __fadd_rn(acc, row[q]);
              s_cursor = upto + 1;
            }
          }
          __syncthreads();
          if (nb < kBatch) break;
        }
      }
      if (tid == 0) finalize(a, key, c, acc, e, o1, o2, wo);
    }
    __syncthreads();
  }
}

// The settle pass of a SettleFlag (ROADMAP C12): where its slot of the
// last step holds epoch - 1, every element of a row this step does not
// touch that the reference's dense update changes is settled: a zero or
// subnormal becomes +0 ("plus"), else a subnormal becomes its sign's
// zero. The row is looked up in the sorted keys. Nothing to do, and one
// load a block, when the flag is down.
__device__ __forceinline__ bool unsettled(float x, int plus) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x7f800000u) == 0 && (b & (plus ? 0xffffffffu : 0x7fffffu));
}

__global__ void __launch_bounds__(kThreads) lr_settle(Apply a) {
  if (a.epoch < 1 || a.settle[(a.epoch - 1) & 1] != a.epoch - 1) return;
  const int64_t total = a.rows * a.C;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * kThreads) {
    float* parts[2] = {a.ftrl_on ? a.z : a.w, a.ftrl_on ? a.n : nullptr};
    bool any = false;
    for (float* x : parts) any |= x != nullptr && unsettled(x[i], a.plus);
    if (!any) continue;
    const int32_t row = (int32_t)(i / a.C);
    int64_t lo = 0, hi = a.len;  // the first key >= row
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (a.keys[mid] < row) lo = mid + 1; else hi = mid;
    }
    if (lo < a.len && a.keys[lo] == row) continue;  // touched
    for (float* x : parts)
      if (x != nullptr && unsettled(x[i], a.plus))
        x[i] = a.plus ? 0.f
                      : __uint_as_float(__float_as_uint(x[i]) & 0x80000000u);
  }
}

// The touched rows in order and their delta rows (PS push): a warp a
// tile; rows past the U touched ones read R.
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

// lanes: K11's lanes a sample (kernels/logreg.py forward_lanes: 1 to 32
// for C == 1, 32 otherwise); inv_c: float32 1/C.
extern "C" cudaError_t mv_sparse_lr_forward(
    const float* w, const float* z, const float* n, int64_t rows, int C,
    const int32_t* keys, const float* values, int B, int K,
    const int32_t* labels, const float* weights, int act, int ftrl_on,
    float inv_alpha, float beta, float l1, float l2, int lanes, float inv_c,
    float* pred, float* diff, float* loss, int32_t* hit, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  const Fwd a{w,      z,      n,        rows,    C,
              keys,   values, B,        K,       labels,
              weights, act,   ftrl_on,  Ftrl{inv_alpha, beta, l1, l2},
              inv_c,  pred,   diff,     loss,    hit};
  if (C != 1) {
    return lanes == 32 ? launch_forward<32, false>(a, stream)
                       : cudaErrorInvalidValue;
  }
  switch (lanes) {
    case 1: return launch_forward<1, true>(a, stream);
    case 2: return launch_forward<2, true>(a, stream);
    case 4: return launch_forward<4, true>(a, stream);
    case 8: return launch_forward<8, true>(a, stream);
    case 16: return launch_forward<16, true>(a, stream);
    case 32: return launch_forward<32, true>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// logits [B, C]; labels and weights, or neither (pred only); inv_c:
// float32 1/C. Several classes take C floats of shared memory a thread.
extern "C" cudaError_t mv_dense_lr_forward(
    const float* logits, int B, int C, const int32_t* labels,
    const float* weights, int act, float inv_c, float* pred, float* diff,
    float* loss, int32_t* hit, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  const Fwd a{nullptr, nullptr, nullptr, 0,       C,
              nullptr, nullptr, B,       1,       labels,
              weights, act,     0,       Ftrl{1.f, 0.f, 0.f, 0.f},
              inv_c,   pred,    diff,    loss,    hit};
  if (C == 1) {
    lr_dense_forward<true><<<(unsigned)((B + kDenseThreads - 1) /
                                        kDenseThreads),
                             kDenseThreads, 0, stream>>>(a, logits);
    return cudaGetLastError();
  }
  // Threads a block: as many warps as 48 KB of logits hold, at most 4.
  int threads = (int)((48 * 1024) / ((size_t)C * sizeof(float))) / 32 * 32;
  if (threads <= 0) return cudaErrorInvalidValue;
  if (threads > kDenseThreads) threads = kDenseThreads;
  lr_dense_forward<false><<<(unsigned)((B + threads - 1) / threads), threads,
                            (size_t)threads * C * sizeof(float), stream>>>(
      a, logits);
  return cudaGetLastError();
}

// scratch (int32): long_heads [tiles], long_count [1], tile_ends [tiles],
// then seg_flags [tiles][2][C] bytes (tiles = ceil(len / 256)). settle:
// SettleFlag's slots, or null; epoch: this step's; plus: its mode.
// fused: sgd's w -= g * scale as one fused multiply-add (LocalModel),
// else the delta rounded (PSModel). delta_end [len, C], rows_out [len]
// and delta_out [len, C] go together: given, the touched rows and their
// delta rows are written.
extern "C" cudaError_t mv_sparse_lr_apply(
    float* w, float* z, float* n, int C, int64_t rows, const int32_t* keys,
    const int32_t* order, int64_t len, const float* values,
    const float* diff, int K, const float* count, int reg, float coef,
    int ftrl_on, float inv_alpha, float beta, float l1, float l2,
    float scale, int fused, float* dz, float* dn, int32_t* scratch,
    int32_t* settle, int epoch, int plus, float* delta_end,
    int64_t* rows_out, float* delta_out, cudaStream_t stream) {
  const int64_t tiles = (len + kSpan - 1) / kSpan;
  int32_t* long_heads = scratch;
  int32_t* long_count = scratch + tiles;
  int32_t* tile_ends = rows_out != nullptr ? long_count + 1 : nullptr;
  uint8_t* seg_flags = reinterpret_cast<uint8_t*>(long_count + 1 + tiles);
  Apply a{w,       z,        n,         C,          rows,       keys,
          order,   len,      values,    diff,       K,          count,
          reg,     coef,     ftrl_on,   Ftrl{inv_alpha, beta, l1, l2},
          scale,   fused,    delta_end, dz,         dn,         tile_ends,
          long_heads, long_count, seg_flags, settle, epoch, plus};
  cudaError_t err;
  if (settle != nullptr) {
    lr_settle<<<4 * 132, kThreads, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (len <= 0) return cudaSuccess;
  err = cudaMemsetAsync(long_count, 0, sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((tiles * 32 + kThreads - 1) / kThreads);
  lr_runs<<<blocks, kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // At most one run leaves each tile; a block a listed run.
  const unsigned long_blocks = (unsigned)(tiles < 4 * 132 ? tiles : 4 * 132);
  lr_long<<<long_blocks, kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || rows_out == nullptr) return err;
  lr_rows<<<blocks, kThreads, 0, stream>>>(keys, len, rows, C, tile_ends,
                                           tiles, delta_end, rows_out,
                                           delta_out);
  return cudaGetLastError();
}
