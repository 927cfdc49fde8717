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
// The caller sorts the positions by row (torch.sort, stable) into a CSR
// of occurrences and cuts each row's list into tasks of at most `task`
// positions; one warp a task sums values[pos] * diff[b] / count over them.
// A row of one task finishes in that warp; the partial sums of a row of
// several tasks go to scratch and the warp that counts in last (an atomic
// counter per row, after a fence) adds them in task order. So the sums
// are deterministic, and a hot row — the padding key input_size names a
// real row, 25 of every 64 positions at criteo's widths — is summed by
// hundreds of warps instead of serializing atomics on one row. Then
// g = sum + reg(W_old) (L1 coef*sign, L2 coef*w, or 0) and
//   sgd:  w -= scale * g  (scale = lr, or 1 for the default updater),
//         optionally writing the delta rows scale * g for the PS push;
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

__global__ void sparse_lr_apply_kernel(
    float* __restrict__ w, float* __restrict__ z, float* __restrict__ n,
    int C, const int64_t* __restrict__ uniq,
    const int64_t* __restrict__ starts, const int32_t* __restrict__ task_row,
    const int64_t* __restrict__ task_start, int64_t n_tasks, int task,
    const int32_t* __restrict__ occ, const float* __restrict__ values,
    const float* __restrict__ diff, int K, const float* __restrict__ count,
    int reg, float coef, int ftrl_on, Ftrl f, float scale,
    float* __restrict__ delta_rows, float* __restrict__ dz,
    float* __restrict__ dn, float* __restrict__ partial,
    int32_t* __restrict__ arrived) {
  extern __shared__ float smem[];  // [kWarps][C] row sums
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * kWarps + warp;
  if (t >= n_tasks) return;
  float* gs = smem + (size_t)warp * C;
  const int u = task_row[t];
  const int64_t t0 = task_start[u];
  const int64_t tasks = task_start[u + 1] - t0;
  const int64_t lo = starts[u] + (t - t0) * task;
  const int64_t end = starts[u + 1];
  const int64_t hi = lo + task < end ? lo + task : end;
  const float cnt = *count;
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
    for (int64_t i = lo + lane; i < hi; i += 32) {
      const int32_t pos = occ[i];
      const int32_t b = pos / K;
      acc = __fadd_rn(acc, __fdiv_rn(__fmul_rn(values[pos],
                                               diff[(int64_t)b * C + c]),
                                     cnt));
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      gs[c] = acc;
      if (tasks > 1) partial[t * C + c] = acc;
    }
  }
  if (tasks > 1) {
    __threadfence();  // this task's partial sums before its arrival
    int last = 0;
    if (lane == 0) last = atomicAdd(arrived + u, 1) == (int)(tasks - 1);
    last = __shfl_sync(kFull, last, 0);
    if (!last) return;
    __threadfence();
    for (int c = lane; c < C; c += 32) {
      float s = 0.f;
      for (int64_t j = 0; j < tasks; ++j)
        s = __fadd_rn(s, __ldcg(partial + (t0 + j) * C + c));
      gs[c] = s;
    }
  }
  __syncwarp();
  const int64_t row = uniq[u];
  for (int c = lane; c < C; c += 32) {
    const int64_t at = row * C + c;
    if (ftrl_on) {
      const float zo = z[at], no = n[at];
      const float wo = ftrl_weight(zo, no, f);
      const float g = __fadd_rn(gs[c], reg_of(wo, reg, coef));
      const float g2 = __fmul_rn(g, g);
      const float sigma = __fdiv_rn(
          __fsub_rn(__fsqrt_rn(__fadd_rn(no, g2)), __fsqrt_rn(no)), f.alpha);
      const float step = __fsub_rn(g, __fmul_rn(sigma, wo));
      z[at] = __fadd_rn(zo, step);
      n[at] = __fadd_rn(no, g2);
      if (dz != nullptr) {
        dz[at] = step;
        dn[at] = g2;
      }
    } else {
      const float wo = w[at];
      const float g = __fadd_rn(gs[c], reg_of(wo, reg, coef));
      const float d = __fmul_rn(g, scale);
      w[at] = __fsub_rn(wo, d);
      if (delta_rows != nullptr) delta_rows[(int64_t)u * C + c] = d;
    }
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

extern "C" cudaError_t mv_sparse_lr_apply(
    float* w, float* z, float* n, int C, const int64_t* uniq,
    const int64_t* starts, const int32_t* task_row,
    const int64_t* task_start, int64_t n_tasks, int task, const int32_t* occ,
    const float* values, const float* diff, int K, const float* count,
    int reg, float coef, int ftrl_on, float alpha, float beta, float l1,
    float l2, float scale, float* delta_rows, float* dz, float* dn,
    float* partial, int32_t* arrived, cudaStream_t stream) {
  if (n_tasks <= 0) return cudaSuccess;
  const size_t smem = (size_t)kWarps * C * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const Ftrl f{alpha, beta, l1, l2};
  const unsigned blocks = (unsigned)((n_tasks + kWarps - 1) / kWarps);
  sparse_lr_apply_kernel<<<blocks, kThreads, smem, stream>>>(
      w, z, n, C, uniq, starts, task_row, task_start, n_tasks, task, occ,
      values, diff, K, count, reg, coef, ftrl_on, f, scale, delta_rows, dz, dn,
      partial, arrived);
  return cudaGetLastError();
}
