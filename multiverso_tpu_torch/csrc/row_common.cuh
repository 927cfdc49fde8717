// Device pieces shared by the row kernels K2, K3, K14, K15 and K16
// (row_gather.cu, row_scatter_add.cu, row_rules.cu): JAX's rule for a
// row id, the bounded rule of a shard's window, and a warp's atomic add
// of one delta row into one table row (K14's stateless arm).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The row an id reaches, or -1: ids in [-rows, -1] wrap to the end of
// the table as JAX's indexing does; every other out-of-range id (the pad
// sentinel `rows` among them) reaches none — dropped by a scatter
// (mode="drop"), a zero row for a gather (mode="fill").
__device__ __forceinline__ int64_t wrap_id(int32_t raw, int64_t rows) {
  int64_t id = raw;
  if (id < 0) id += rows;
  return (id >= 0 && id < rows) ? id : -1;
}

// The local row of a GLOBAL id in a server shard's window [ofs, ofs + n)
// (K15, K16: the reference's `jnp.where((ids >= ofs) & (ids < ofs + n),
// ids - ofs, padded)`), or -1: an id outside the window is foreign —
// negative ids included, which do NOT wrap here — and reads a zero row
// or is dropped.
__device__ __forceinline__ int64_t bounded_id(int32_t raw, int64_t ofs,
                                              int64_t n) {
  const int64_t id = static_cast<int64_t>(raw) - ofs;
  return (id >= 0 && id < n) ? id : -1;
}

// The row an id reaches under the unbounded rule (wrap_id over `rows`)
// or, with BOUNDED, under the window rule (bounded_id).
template <bool BOUNDED>
__device__ __forceinline__ int64_t row_of(int32_t raw, int64_t rows,
                                          int64_t ofs, int64_t n) {
  return BOUNDED ? bounded_id(raw, ofs, n) : wrap_id(raw, rows);
}

// dst[0:d_cols] += sign * src[0:d_cols] by the 32 lanes of a warp, with
// float atomics. VEC (see rows_vec4): each lane adds a 16-byte float4
// with one vector atomic (sm_90 has atomicAdd on float4 in global
// memory); otherwise one float a lane.
template <bool VEC>
__device__ __forceinline__ void atomic_add_row(float* dst, const float* src,
                                               int d_cols, float sign,
                                               int lane) {
  if (VEC) {
    const int nv = d_cols >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int c = lane; c < nv; c += 32) {
      float4 v = __ldg(s4 + c);
      v.x *= sign;
      v.y *= sign;
      v.z *= sign;
      v.w *= sign;
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
      atomicAdd(d4 + c, v);
#else
      float* d = reinterpret_cast<float*>(d4 + c);
      atomicAdd(d + 0, v.x);
      atomicAdd(d + 1, v.y);
      atomicAdd(d + 2, v.z);
      atomicAdd(d + 3, v.w);
#endif
    }
  } else {
    for (int c = lane; c < d_cols; c += 32) atomicAdd(dst + c, sign * src[c]);
  }
}

// Whether rows of `d_cols` floats, `stride` apart in `data` and packed
// in `delta`, are 16-byte aligned for atomic_add_row<true>.
inline bool rows_vec4(const float* data, int64_t stride, const float* delta,
                      int d_cols) {
  return (d_cols % 4 == 0) && (stride % 4 == 0) &&
         (reinterpret_cast<uintptr_t>(data) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(delta) % 16 == 0);
}

}  // namespace
