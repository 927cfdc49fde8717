// K19 mesh_allreduce: the sum (or mean) over the slot axis of a mesh of
// n replica slots on one card, written to `copies` output rows.
//
// Replaces the reference's device-mesh collectives (B16): the
// `lax.psum` of allreduce_mesh / psum_scalar and the `lax.pmean` of
// pmean_mesh (multiverso_tpu/parallel/collective.py:30-73), of MASGDStep
// (multiverso_tpu/parallel/ma.py:305-339) and of _ma_group_fn
// (multiverso_tpu/models/wordembedding/device_train.py:439-506). On the
// reference's 8-device CPU mesh a psum is a sequential sum in device
// order; this kernel takes it in slot order with correctly rounded
// adds, then divides once for the mean:
//
//   acc = x[0, i]; acc = __fadd_rn(acc, x[r, i]) for r = 1 .. n-1;
//   mean: acc = __fdiv_rn(acc, n);   out[c, i] = acc for c < copies.
//
// x is float32 [n, m] (row r is slot r), contiguous; out is float32
// [copies, m]: copies 1 is a replicated result (out_specs=P()), copies
// n every slot's shard of the allreduce.
//
// Bound on the card: bytes, (n + copies) * m * 4 (each input read once,
// each output row written once; one add a slot and element). Design: a
// grid-stride loop over float4 vectors of an element column (every
// slot's 16-byte load of the column is independent, so n loads are in
// flight a thread), a scalar loop for the tail, no shared memory and
// no atomics: each element is owned by one thread, so the order is
// the slot order and the result is the same on every run. The vector
// loop runs only when m is a multiple of 4 and both pointers are
// 16-byte aligned (each slot's row then starts aligned); otherwise the
// scalar loop covers the whole row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kMaxSlots = 64;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__global__ void mesh_allreduce_kernel(const float* __restrict__ x, int n,
                                      int64_t m, int64_t m4, int mean,
                                      int copies, float* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  const float fn = (float)n;
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  float4* __restrict__ out4 = reinterpret_cast<float4*>(out);
  for (int64_t i = tid; i < m4; i += stride) {
    float4 acc = x4[i];
    for (int r = 1; r < n; ++r) acc = add4(acc, x4[r * m4 + i]);
    if (mean) {
      acc = make_float4(__fdiv_rn(acc.x, fn), __fdiv_rn(acc.y, fn),
                        __fdiv_rn(acc.z, fn), __fdiv_rn(acc.w, fn));
    }
    for (int c = 0; c < copies; ++c) out4[c * m4 + i] = acc;
  }
  for (int64_t i = 4 * m4 + tid; i < m; i += stride) {
    float acc = x[i];
    for (int r = 1; r < n; ++r) acc = __fadd_rn(acc, x[r * m + i]);
    if (mean) acc = __fdiv_rn(acc, fn);
    for (int c = 0; c < copies; ++c) out[c * m + i] = acc;
  }
}

}  // namespace

extern "C" cudaError_t mv_mesh_allreduce(const float* x, int n, int64_t m,
                                         int mean, int copies, float* out,
                                         cudaStream_t stream) {
  if (n < 1 || n > kMaxSlots || copies < 1 || copies > n || m < 0) {
    return cudaErrorInvalidValue;
  }
  if (m == 0) return cudaSuccess;
  const bool vec = m % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int64_t m4 = vec ? m / 4 : 0;
  const int64_t work = vec ? m4 : m;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  mesh_allreduce_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, n, m, m4, mean, copies, out);
  return cudaGetLastError();
}
