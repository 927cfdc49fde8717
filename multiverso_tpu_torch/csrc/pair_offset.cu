// K8 pair_offset_grad: one window offset's sub-step of the per-pair
// skip-gram quality mode.
//
// Replaces the reference's `_pair_offset_loss_and_grads`
// (multiverso_tpu/models/wordembedding/device_train.py:233-250) as
// `_seq_pair_step` (:253-285) drives it, once for each of the 2W offsets
// against the live tables. For C pairs with center rows v[C, D], context
// rows u_pos[C, D] and each pair's own K negatives u_neg[C*K, D]:
//   pos[c] = clip(v[c] . u_pos[c]),  neg[c, k] = clip(v[c] . u_neg[cK + k])
//   loss = sum m[c] * (xent(pos, 1) + sum_k xent(neg, 0))
// with JAX's clip gradient. Two forms: the delta form writes scale *
// gradient (scale = -lr) into d_v[C, D], d_pos[C, D] and d_neg[C*K, D]
// (the local path scatters them with K3); the in-place form adds them to
// v, u_pos and u_neg themselves (the PS path's local copies), each
// element rounded as `x += scale * g` rounds: a product, then a sum, no
// fused multiply-add. Every row belongs to one pair, so no two warps
// write one address. A pair with m == 0 reads nothing; the delta form
// writes exact zeros for it, the in-place form leaves its rows alone.
//
// Bound on the card: bytes (the K + 2 rows of each valid pair read, and
// written once: ~7.3 MB at C=2048, K=5, D=128). Design: one warp a pair,
// four pairs a block (512 blocks at C=2048: every SM busy). A lane owns
// float4 columns (scalar ones where D % 4 != 0 or a row is not 16-byte
// aligned) and issues the loads of the center row and of the pair's
// K + 1 output rows before it takes a dot product; the K + 1 dot
// products come out of one transposed reduction (N partial sums a lane,
// log2 N halving exchanges, then 5 - log2 N more), not K + 1 serial warp
// sums; N is 8, 16 or 32, the least that holds K + 1 (K <= 31). The
// gradient pass reads the rows again (from L1). The loss and the
// example count: per block in warp order, and
// the last block to arrive (a counter, after a fence) sums the blocks'
// partials in block order and resets the counter: one launch, the same
// bits on every run.

#include "w2v_common.cuh"

namespace {

constexpr int kPairWarps = 4;
constexpr int kPairThreads = kPairWarps * 32;

struct PairArgs {
  float* v;            // [C, D] center rows (written in place when inplace)
  float* u_pos;        // [C, D] context rows
  float* u_neg;        // [C*K, D] negative rows
  const float* m;      // [C]
  int C, K, D;
  float scale;
  float* d_v;          // delta form: [C, D]
  float* d_pos;        // [C, D]
  float* d_neg;        // [C*K, D]
  float* part;         // [2 * blocks] loss, examples of each block
  unsigned* arrived;   // 0 before the launch; the last block resets it
  float* loss_out;
  float* ex_out;
};

template <int N, typename T, bool INPLACE>
__global__ void __launch_bounds__(kPairThreads)
    pair_kernel(PairArgs a) {
  __shared__ float s_coef[kPairWarps][32];
  __shared__ float s_sum[2 * kPairWarps];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kPairWarps + warp;
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int nu = a.D / kPer;  // columns of a row a lane may own
  float wloss = 0.0f, wm = 0.0f;
  if (c < a.C) {
    const float mc = a.m[c];
    wm = mc;
    const int64_t D = a.D;
    float* vr = a.v + c * D;
    float* pr = a.u_pos + c * D;
    float* nr = a.u_neg + (int64_t)c * a.K * D;
    if (mc != 0.0f) {
      const int K1 = a.K + 1;  // <= N
      float part[N];
#pragma unroll
      for (int i = 0; i < N; ++i) part[i] = 0.0f;
      for (int u = lane; u < nu; u += 32) {
        const T x = load_col(vr, u, T());
        T rows[N];
#pragma unroll
        for (int i = 0; i < N; ++i)
          rows[i] = i < K1 ? load_col(i == 0 ? pr : nr + (i - 1) * D, u, T())
                           : zero_col<T>();
#pragma unroll
        for (int i = 0; i < N; ++i) part[i] = dot_col(x, rows[i], part[i]);
      }
      const float dot = transpose_sum<N>(part, lane);
      if (lane < K1) {
        float loss, grad;
        xent_pair(dot, lane == 0 ? 1.0f : 0.0f, loss, grad);
        wloss = loss * mc;
        s_coef[warp][lane] = grad * mc;
      }
      __syncwarp();
      const float* coef = s_coef[warp];
      for (int u = lane; u < nu; u += 32) {
        const T x = load_col(vr, u, T());
        const T up = load_col(pr, u, T());
        T g = scale_col(coef[0], up);
        for (int k = 1; k < K1; ++k)
          g = axpy_col(coef[k], load_col(nr + (k - 1) * D, u, T()), g);
        const T gv = scale_col(a.scale, g);
        const T gp = scale_col(a.scale, scale_col(coef[0], x));
        if (INPLACE) {
          store_col(vr, u, add_col(x, gv));
          store_col(pr, u, add_col(up, gp));
        } else {
          store_col(a.d_v + c * D, u, gv);
          store_col(a.d_pos + c * D, u, gp);
        }
        for (int k = 1; k < K1; ++k) {
          const T gn = scale_col(a.scale, scale_col(coef[k], x));
          if (INPLACE) {
            float* row = nr + (k - 1) * D;
            store_col(row, u, add_col(load_col(row, u, T()), gn));
          } else {
            store_col(a.d_neg + ((int64_t)c * a.K + k - 1) * D, u, gn);
          }
        }
      }
    } else if (!INPLACE) {
      for (int u = lane; u < nu; u += 32) {
        store_col(a.d_v + c * D, u, zero_col<T>());
        store_col(a.d_pos + c * D, u, zero_col<T>());
        for (int k = 0; k < a.K; ++k)
          store_col(a.d_neg + ((int64_t)c * a.K + k) * D, u, zero_col<T>());
      }
    }
  }
  // The loss and the examples: the warps in order, the blocks in order.
  wloss = warp_sum(wloss);
  if (lane == 0) {
    s_sum[2 * warp] = wloss;
    s_sum[2 * warp + 1] = wm;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.0f, e = 0.0f;
    for (int w = 0; w < kPairWarps; ++w) {
      l += s_sum[2 * w];
      e += s_sum[2 * w + 1];
    }
    a.part[2 * blockIdx.x] = l;
    a.part[2 * blockIdx.x + 1] = e;
    __threadfence();  // the partials before the arrival
    s_last = atomicAdd(a.arrived, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || warp != 0) return;
  __threadfence();
  float l = 0.0f, e = 0.0f;
  for (int b = lane; b < (int)gridDim.x; b += 32) {
    l += __ldcg(a.part + 2 * b);
    e += __ldcg(a.part + 2 * b + 1);
  }
  l = warp_sum(l);
  e = warp_sum(e);
  if (lane == 0) {
    *a.loss_out = l;
    *a.ex_out = e;
    *a.arrived = 0u;
  }
}

template <int N, typename T>
cudaError_t launch_pair(const PairArgs& a, bool inplace, unsigned blocks,
                        cudaStream_t stream) {
  if (inplace) {
    pair_kernel<N, T, true><<<blocks, kPairThreads, 0, stream>>>(a);
  } else {
    pair_kernel<N, T, false><<<blocks, kPairThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const PairArgs& a, bool inplace, unsigned blocks,
                         cudaStream_t stream) {
  const int K1 = a.K + 1;
  if (K1 <= 8) return launch_pair<8, T>(a, inplace, blocks, stream);
  if (K1 <= 16) return launch_pair<16, T>(a, inplace, blocks, stream);
  return launch_pair<32, T>(a, inplace, blocks, stream);
}

}  // namespace

// part: scratch [2 * ceil(C / 4)]; arrived: one zeroed counter, left zero.
extern "C" cudaError_t mv_pair_offset_grad(
    float* v, float* u_pos, float* u_neg, const float* m, int C, int K, int D,
    float scale, int inplace, float* d_v, float* d_pos, float* d_neg,
    float* part, unsigned* arrived, float* loss_out, float* ex_out,
    cudaStream_t stream) {
  if (K + 1 > 32) return cudaErrorInvalidValue;
  const unsigned blocks =
      C > 0 ? (unsigned)((C + kPairWarps - 1) / kPairWarps) : 1u;
  PairArgs a{v,   u_pos, u_neg, m,    C,       K,        D,      scale,
             d_v, d_pos, d_neg, part, arrived, loss_out, ex_out};
  auto aligned = [](const void* p) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  const bool vec = D % 4 == 0 && aligned(v) && aligned(u_pos) &&
                   aligned(u_neg) && aligned(d_v) && aligned(d_pos) &&
                   aligned(d_neg);
  return vec ? launch_width<float4>(a, inplace != 0, blocks, stream)
             : launch_width<float>(a, inplace != 0, blocks, stream);
}
