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
// Bound on the card: bytes. Each delta row is read once and its table
// row read and written once by the atomics (a foreign id reads only its
// id). One warp per delta row; at 128 columns each lane makes one
// 16-byte vector atomic (row_common.cuh). Duplicate ids make the order
// of the sums vary from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool VEC, bool BOUNDED>
__global__ void row_scatter_add_kernel(float* __restrict__ data,
                                       int64_t rows, int64_t stride,
                                       const int32_t* __restrict__ ids,
                                       int64_t k_delta,
                                       const float* __restrict__ delta,
                                       int d_cols, float sign, int64_t ofs,
                                       int64_t n) {
  const int64_t row = (blockIdx.x * (int64_t)kThreads + threadIdx.x) >> 5;
  if (row >= k_delta) return;
  const int64_t id = row_of<BOUNDED>(ids[row], rows, ofs, n);
  if (id < 0) return;
  atomic_add_row<VEC>(data + id * stride, delta + row * d_cols, d_cols,
                      sign, threadIdx.x & 31);
}

template <bool BOUNDED>
cudaError_t launch_scatter(float* data, int64_t rows, int64_t stride,
                           const int32_t* ids, int64_t k_delta,
                           const float* delta, int d_cols, float sign,
                           int64_t ofs, int64_t n, cudaStream_t stream) {
  if (k_delta <= 0 || d_cols <= 0) return cudaSuccess;
  const int64_t blocks = (k_delta * 32 + kThreads - 1) / kThreads;
  if (rows_vec4(data, stride, delta, d_cols)) {
    row_scatter_add_kernel<true, BOUNDED>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(
            data, rows, stride, ids, k_delta, delta, d_cols, sign, ofs, n);
  } else {
    row_scatter_add_kernel<false, BOUNDED>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(
            data, rows, stride, ids, k_delta, delta, d_cols, sign, ofs, n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t mv_row_scatter_add(float* data, int64_t rows,
                                          int64_t stride,
                                          const int32_t* ids,
                                          int64_t k_delta,
                                          const float* delta, int d_cols,
                                          float sign, cudaStream_t stream) {
  return launch_scatter<false>(data, rows, stride, ids, k_delta, delta,
                               d_cols, sign, 0, 0, stream);
}

// K16: the window [ofs, ofs + n) of global ids, n <= rows.
extern "C" cudaError_t mv_row_scatter_add_bounded(
    float* data, int64_t rows, int64_t stride, const int32_t* ids,
    int64_t k_delta, const float* delta, int d_cols, float sign, int64_t ofs,
    int64_t n, cudaStream_t stream) {
  return launch_scatter<true>(data, rows, stride, ids, k_delta, delta,
                              d_cols, sign, ofs, n, stream);
}
