// K2 row_gather: out[i, :n_col] = data[ids[i], :n_col], and K15
// row_gather_bounded: the same over a server shard's window of GLOBAL ids.
//
// K2 replaces the reference's MatrixServer._gather
// (multiverso_tpu/tables/matrix_table.py:2760-2764), the jitted
// `data.at[ids].get(mode="fill", fill_value=0)[..., :n_col]`. Ids in
// [-rows, -1] wrap to the end of the table as JAX's indexing does; any
// other out-of-range id (the pad sentinel `rows` among them) reads a
// zero row.
//
// K15 replaces MatrixServer._gather_bounded (matrix_table.py:2777-2796),
// the gather of a device-key Get on a table of several servers: every
// server receives the same global ids, reads row id - ofs for the ids of
// its window [ofs, ofs + n) and zeros for every other id (negative ones
// included: no wrap), and the worker sums the servers' replies.
//
// Bound on the card: bytes. Each output row is one read and one write of
// n_col floats plus a 4-byte id (a foreign id only the write), no
// arithmetic. Two forms. Rows of a warp's width or more: a warp a row,
// so the 32 lanes stay on one contiguous row (at n_col = 128 each lane
// moves exactly one 16-byte float4, so every load and store is a full
// 512-byte coalesced transaction). Rows narrower than a warp
// (lr_sparse_ps's 1-float rows): a thread an output element, flat
// element e taking row e / n_col and column e % n_col, in a grid-stride
// loop over as many threads as the card holds; neighbouring lanes then
// load neighbouring ids and store neighbouring outputs, and read
// neighbouring table elements when the ids ascend (the whole-table dirty
// Get), where a warp a row left 31 of 32 lanes idle.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 rows per block

template <bool BOUNDED>
__global__ void row_gather_vec4(const float* __restrict__ data, int64_t rows,
                                int64_t stride,
                                const int32_t* __restrict__ ids, int64_t k,
                                float* __restrict__ out, int n_col,
                                int64_t ofs, int64_t n) {
  const int64_t row = (blockIdx.x * (int64_t)kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= k) return;
  const int64_t id = row_of<BOUNDED>(ids[row], rows, ofs, n);
  const int nv = n_col >> 2;
  float4* dst = reinterpret_cast<float4*>(out + row * n_col);
  if (id < 0) {
    for (int c = lane; c < nv; c += 32) dst[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float4* src = reinterpret_cast<const float4*>(data + id * stride);
  for (int c = lane; c < nv; c += 32) dst[c] = __ldg(src + c);
}

template <bool BOUNDED>
__global__ void row_gather_scalar(const float* __restrict__ data,
                                  int64_t rows, int64_t stride,
                                  const int32_t* __restrict__ ids, int64_t k,
                                  float* __restrict__ out, int n_col,
                                  int64_t ofs, int64_t n) {
  const int64_t row = (blockIdx.x * (int64_t)kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= k) return;
  const int64_t id = row_of<BOUNDED>(ids[row], rows, ofs, n);
  float* dst = out + row * n_col;
  if (id < 0) {
    for (int c = lane; c < n_col; c += 32) dst[c] = 0.f;
    return;
  }
  const float* src = data + id * stride;
  for (int c = lane; c < n_col; c += 32) dst[c] = __ldg(src + c);
}

template <bool BOUNDED>
__global__ void __launch_bounds__(kThreads)
    row_gather_elems(const float* __restrict__ data, int64_t rows,
                     int64_t stride, const int32_t* __restrict__ ids,
                     int64_t k, float* __restrict__ out, int n_col,
                     int64_t ofs, int64_t n) {
  const int64_t total = k * n_col;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t e = blockIdx.x * (int64_t)kThreads + threadIdx.x; e < total;
       e += step) {
    const int64_t i = n_col == 1 ? e : e / n_col;
    const int c = (int)(e - i * n_col);
    const int64_t id = row_of<BOUNDED>(__ldg(ids + i), rows, ofs, n);
    out[e] = id < 0 ? 0.f : __ldg(data + id * stride + c);
  }
}

// Blocks of a grid-stride kernel: 8 a streaming multiprocessor (2,048
// threads of 256-thread blocks fill an SM), read once from the device.
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0) {
      sms = 132;
    }
    blocks = sms * 8;
  }
  return blocks;
}

template <bool BOUNDED>
cudaError_t launch_gather(const float* data, int64_t rows, int64_t stride,
                          const int32_t* ids, int64_t k, float* out,
                          int n_col, int64_t ofs, int64_t n,
                          cudaStream_t stream) {
  if (k <= 0 || n_col <= 0) return cudaSuccess;
  if (n_col < 32) {
    int64_t blocks = (k * n_col + kThreads - 1) / kThreads;
    if (blocks > resident_blocks()) blocks = resident_blocks();
    row_gather_elems<BOUNDED><<<(unsigned)blocks, kThreads, 0, stream>>>(
        data, rows, stride, ids, k, out, n_col, ofs, n);
    return cudaGetLastError();
  }
  const int64_t blocks = (k * 32 + kThreads - 1) / kThreads;
  const bool vec = (n_col % 4 == 0) && (stride % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(data) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec) {
    row_gather_vec4<BOUNDED><<<(unsigned)blocks, kThreads, 0, stream>>>(
        data, rows, stride, ids, k, out, n_col, ofs, n);
  } else {
    row_gather_scalar<BOUNDED><<<(unsigned)blocks, kThreads, 0, stream>>>(
        data, rows, stride, ids, k, out, n_col, ofs, n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t mv_row_gather(const float* data, int64_t rows,
                                     int64_t stride, const int32_t* ids,
                                     int64_t k, float* out, int n_col,
                                     cudaStream_t stream) {
  return launch_gather<false>(data, rows, stride, ids, k, out, n_col, 0, 0,
                              stream);
}

// K15: the window [ofs, ofs + n) of global ids, n <= rows.
extern "C" cudaError_t mv_row_gather_bounded(const float* data, int64_t rows,
                                             int64_t stride,
                                             const int32_t* ids, int64_t k,
                                             float* out, int n_col,
                                             int64_t ofs, int64_t n,
                                             cudaStream_t stream) {
  return launch_gather<true>(data, rows, stride, ids, k, out, n_col, ofs, n,
                             stream);
}
