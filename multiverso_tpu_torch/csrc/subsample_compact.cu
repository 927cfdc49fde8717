// K1 subsample_compact: word2vec subsampling plus a stable partition.
//
// Replaces the reference's `_prep`
// (multiverso_tpu/models/wordembedding/device_train.py:61-73): token t is
// kept iff u[t] < keep[flat[t]]; kept tokens move to [0, n_kept) and
// dropped tokens to [n_kept, T), both in corpus order (the reference's
// stable argsort of the 0/1 mask); the dropped tail's sentence id is -1.
// The uniforms u are drawn outside (the trainer's generator), so this
// kernel is deterministic and matches its plain version bit for bit.
//
// Bound on the card: bytes — four int32/float reads and two int32 writes
// per token, no arithmetic to speak of. Three launches:
//   1. per-block kept counts (warp ballot + popc, 1024 tokens a block);
//   2. one block scans the block counts (exclusive) and writes n_kept;
//   3. each block recomputes its mask and writes every token to its
//      final slot: a warp ballot's popc below the lane plus the
//      exclusive scan of the block's warp counts give the token's rank
//      among kept (or dropped) tokens of its block.
// No atomics: the result is the same on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // one token per thread, 32 warps
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool kept(const int32_t* __restrict__ flat,
                                     const float* __restrict__ keep,
                                     const float* __restrict__ u,
                                     int64_t t, int64_t n) {
  return t < n && u[t] < keep[flat[t]];
}

__global__ void count_kept(const int32_t* __restrict__ flat,
                           const float* __restrict__ keep,
                           const float* __restrict__ u, int64_t n,
                           int32_t* __restrict__ block_counts) {
  __shared__ int warp_counts[kWarps];
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const unsigned ballot = __ballot_sync(0xffffffffu, kept(flat, keep, u, t, n));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x < 32) {
    int c = warp_counts[threadIdx.x];
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
  }
}

// Exclusive scan of `counts` (nblocks entries) by ONE block of kThreads
// threads, in chunks of kThreads with a running carry; total -> n_kept.
__global__ void scan_counts(const int32_t* __restrict__ counts,
                            int64_t nblocks, int32_t* __restrict__ offsets,
                            int32_t* __restrict__ n_kept) {
  __shared__ int warp_sums[kWarps];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t base = 0; base < nblocks; base += kThreads) {
    const int64_t i = base + threadIdx.x;
    const int v = i < nblocks ? counts[i] : 0;
    int incl = v;  // inclusive warp scan
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
      int wincl = w;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, wincl, o);
        if (lane >= o) wincl += y;
      }
      warp_sums[lane] = wincl - w;  // exclusive prefix of warp sums
    }
    __syncthreads();
    const int excl = carry + warp_sums[warp] + incl - v;
    if (i < nblocks) offsets[i] = excl;
    __syncthreads();
    if (threadIdx.x == kThreads - 1) carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) n_kept[0] = carry;
}

__global__ void write_partition(const int32_t* __restrict__ flat,
                                const int32_t* __restrict__ sent,
                                const float* __restrict__ keep,
                                const float* __restrict__ u, int64_t n,
                                const int32_t* __restrict__ offsets,
                                const int32_t* __restrict__ n_kept,
                                int32_t* __restrict__ kept_out,
                                int32_t* __restrict__ ksent_out) {
  __shared__ int warp_prefix[kWarps];
  const int64_t block_start = (int64_t)blockIdx.x * kThreads;
  const int64_t t = block_start + threadIdx.x;
  const bool k = kept(flat, keep, u, t, n);
  const unsigned ballot = __ballot_sync(0xffffffffu, k);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_prefix[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int w = warp_prefix[lane];
    int incl = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    warp_prefix[lane] = incl - w;
  }
  __syncthreads();
  if (t >= n) return;
  // Kept tokens of this block before this one.
  const int kept_before =
      warp_prefix[warp] + __popc(ballot & ((1u << lane) - 1u));
  const int64_t block_kept_before = offsets[blockIdx.x];
  int64_t pos;
  if (k) {
    pos = block_kept_before + kept_before;
  } else {
    const int64_t dropped_before_block = block_start - block_kept_before;
    const int dropped_before = (int)threadIdx.x - kept_before;
    pos = (int64_t)n_kept[0] + dropped_before_block + dropped_before;
  }
  kept_out[pos] = flat[t];
  ksent_out[pos] = k ? sent[t] : -1;
}

}  // namespace

// block_counts and offsets are scratch of ceil(n / 1024) int32 each;
// n_kept is one int32.
extern "C" cudaError_t mv_subsample_compact(
    const int32_t* flat, const int32_t* sent, const float* keep,
    const float* u, int64_t n, int32_t* block_counts, int32_t* offsets,
    int32_t* n_kept, int32_t* kept_out, int32_t* ksent_out,
    cudaStream_t stream) {
  const int64_t nblocks = (n + kThreads - 1) / kThreads;
  if (nblocks == 0) {
    return cudaMemsetAsync(n_kept, 0, sizeof(int32_t), stream);
  }
  count_kept<<<(unsigned)nblocks, kThreads, 0, stream>>>(flat, keep, u, n,
                                                         block_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_counts<<<1, kThreads, 0, stream>>>(block_counts, nblocks, offsets,
                                          n_kept);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  write_partition<<<(unsigned)nblocks, kThreads, 0, stream>>>(
      flat, sent, keep, u, n, offsets, n_kept, kept_out, ksent_out);
  return cudaGetLastError();
}
