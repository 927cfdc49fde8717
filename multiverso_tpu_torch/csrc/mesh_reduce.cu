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
// each output row written once; one add a slot and element). At the MA
// path's 4 x 1,013,245 x 128 floats that is 2.6 GB, so the design keeps
// the memory system busy and nothing else:
//   - n = 2, 4 and 8 are template instantiations: a thread takes U
//     float4 columns of a tile and issues all n x U 16-byte loads before
//     its first add (128-256 bytes in flight a thread), then sums each
//     column in slot order;
//   - loads and stores are streaming (`__ldcs`, `__stcs`: evict first),
//     since every byte is touched once;
//   - a block a tile of kThreads x U float4 columns: the grid is every
//     tile, and the blocks' turnover keeps the memory system fuller
//     than a persistent grid of the resident blocks striding over the
//     tiles (about 2% slower at ma_mesh4's shape on an H100, PERF.md);
//   - any other n (1 to 64) runs the same tiles with a loop over the
//     slots; m not a multiple of 4, or an unaligned pointer, a block a
//     tile of kThreads single floats.
// No shared memory and no atomics: each element is owned by one thread,
// so the order is the slot order and the result is the same on every
// run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 64;
constexpr int kGenericUnits = 2;  // float4 columns a thread, generic n

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 div4(float4 a, float d) {
  return make_float4(__fdiv_rn(a.x, d), __fdiv_rn(a.y, d),
                     __fdiv_rn(a.z, d), __fdiv_rn(a.w, d));
}

struct Reduce {
  const float* x;
  float* out;
  int n;
  int64_t m;      // floats a slot
  int64_t m4;     // float4 columns a slot (0: the scalar form)
  int mean, copies;
};

__device__ __forceinline__ void store4(const Reduce& r, int64_t i,
                                       float4 acc) {
  float4* out4 = reinterpret_cast<float4*>(r.out);
  for (int c = 0; c < r.copies; ++c) __stcs(out4 + c * r.m4 + i, acc);
}

// N slots (a template argument), U float4 columns a thread a tile.
template <int N, int U>
__global__ void __launch_bounds__(kThreads) mesh_allreduce_slots(Reduce r) {
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(r.x);
  const float fn = (float)N;
  const int64_t base = blockIdx.x * (int64_t)(kThreads * U) + threadIdx.x;
  float4 v[N][U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < r.m4) {
#pragma unroll
      for (int s = 0; s < N; ++s) v[s][u] = __ldcs(x4 + s * r.m4 + i);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < r.m4) {
      float4 acc = v[0][u];
#pragma unroll
      for (int s = 1; s < N; ++s) acc = add4(acc, v[s][u]);
      if (r.mean) acc = div4(acc, fn);
      store4(r, i, acc);
    }
  }
}

// Any n: the same tiles, the slots in a loop (each column's loads are
// still independent of one another, so n are in flight a column).
__global__ void __launch_bounds__(kThreads) mesh_allreduce_any(Reduce r) {
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(r.x);
  const float fn = (float)r.n;
  const int64_t base =
      blockIdx.x * (int64_t)(kThreads * kGenericUnits) + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kGenericUnits; ++u) {
    const int64_t i = base + u * kThreads;
    if (i >= r.m4) continue;
    float4 acc = __ldcs(x4 + i);
    for (int s = 1; s < r.n; ++s) acc = add4(acc, __ldcs(x4 + s * r.m4 + i));
    if (r.mean) acc = div4(acc, fn);
    store4(r, i, acc);
  }
}

// Every element one by one: m not a multiple of 4 or an unaligned
// pointer (a block a tile of kThreads floats).
__global__ void __launch_bounds__(kThreads) mesh_allreduce_scalar(Reduce r) {
  const int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (i >= r.m) return;
  const float fn = (float)r.n;
  float acc = __ldcs(r.x + i);
  for (int s = 1; s < r.n; ++s) acc = __fadd_rn(acc, __ldcs(r.x + s * r.m + i));
  if (r.mean) acc = __fdiv_rn(acc, fn);
  for (int c = 0; c < r.copies; ++c) __stcs(r.out + c * r.m + i, acc);
}

// A block a tile of kThreads x `units` columns (float4 columns, or
// single floats for the scalar form).
template <typename K>
cudaError_t launch_tiles(K kernel, const Reduce& r, int64_t columns,
                         int units, cudaStream_t stream) {
  const int64_t tiles = (columns + (int64_t)kThreads * units - 1) /
                        ((int64_t)kThreads * units);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, kThreads, 0, stream>>>(r);
  return cudaGetLastError();
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
  const Reduce r{x, out, n, m, vec ? m / 4 : 0, mean, copies};
  if (!vec) return launch_tiles(mesh_allreduce_scalar, r, m, 1, stream);
  switch (n) {
    case 2:
      return launch_tiles(mesh_allreduce_slots<2, 4>, r, r.m4, 4, stream);
    case 4:
      return launch_tiles(mesh_allreduce_slots<4, 4>, r, r.m4, 4, stream);
    case 8:
      return launch_tiles(mesh_allreduce_slots<8, 2>, r, r.m4, 2, stream);
    default:
      return launch_tiles(mesh_allreduce_any, r, r.m4, kGenericUnits, stream);
  }
}
