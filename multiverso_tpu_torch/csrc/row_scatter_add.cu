// K3 row_scatter_add: data[ids[i], :d_cols] += sign * delta[i, :d_cols].
//
// Replaces the reference's DefaultRule.rows / SGDRule.rows
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
// Bound on the card: bytes. Each delta row is read once and its table
// row read and written once by the atomics. One warp per delta row; at
// 128 columns each lane issues one 16-byte vector atomic (sm_90 has
// atomicAdd on float4 in global memory). Duplicate ids make the order
// of the sums vary from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t wrap_id(int32_t raw, int64_t rows) {
  int64_t id = raw;
  if (id < 0) id += rows;
  return (id >= 0 && id < rows) ? id : -1;
}

__global__ void row_scatter_add_vec4(float* __restrict__ data, int64_t rows,
                                     int64_t stride,
                                     const int32_t* __restrict__ ids,
                                     int64_t k_delta,
                                     const float* __restrict__ delta,
                                     int d_cols, float sign) {
  const int64_t row = (blockIdx.x * (int64_t)kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= k_delta) return;
  const int64_t id = wrap_id(ids[row], rows);
  if (id < 0) return;
  const int nv = d_cols >> 2;
  const float4* src = reinterpret_cast<const float4*>(delta + row * d_cols);
  float4* dst = reinterpret_cast<float4*>(data + id * stride);
  for (int c = lane; c < nv; c += 32) {
    float4 v = __ldg(src + c);
    v.x *= sign;
    v.y *= sign;
    v.z *= sign;
    v.w *= sign;
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
    atomicAdd(dst + c, v);
#else
    float* d = reinterpret_cast<float*>(dst + c);
    atomicAdd(d + 0, v.x);
    atomicAdd(d + 1, v.y);
    atomicAdd(d + 2, v.z);
    atomicAdd(d + 3, v.w);
#endif
  }
}

__global__ void row_scatter_add_scalar(float* __restrict__ data,
                                       int64_t rows, int64_t stride,
                                       const int32_t* __restrict__ ids,
                                       int64_t k_delta,
                                       const float* __restrict__ delta,
                                       int d_cols, float sign) {
  const int64_t row = (blockIdx.x * (int64_t)kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= k_delta) return;
  const int64_t id = wrap_id(ids[row], rows);
  if (id < 0) return;
  const float* src = delta + row * d_cols;
  float* dst = data + id * stride;
  for (int c = lane; c < d_cols; c += 32) atomicAdd(dst + c, sign * src[c]);
}

}  // namespace

extern "C" cudaError_t mv_row_scatter_add(float* data, int64_t rows,
                                          int64_t stride,
                                          const int32_t* ids,
                                          int64_t k_delta,
                                          const float* delta, int d_cols,
                                          float sign, cudaStream_t stream) {
  if (k_delta <= 0 || d_cols <= 0) return cudaSuccess;
  const int64_t blocks = (k_delta * 32 + kThreads - 1) / kThreads;
  const bool vec = (d_cols % 4 == 0) && (stride % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(data) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(delta) % 16 == 0);
  if (vec) {
    row_scatter_add_vec4<<<(unsigned)blocks, kThreads, 0, stream>>>(
        data, rows, stride, ids, k_delta, delta, d_cols, sign);
  } else {
    row_scatter_add_scalar<<<(unsigned)blocks, kThreads, 0, stream>>>(
        data, rows, stride, ids, k_delta, delta, d_cols, sign);
  }
  return cudaGetLastError();
}
