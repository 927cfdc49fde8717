// K17 segment_merge and K18 segment_split: the per-server reassembly and
// re-slicing of the segmented PS pipeline (B11).
//
// They replace the gathers and slices of the reference's
// _segmented_step_fn (multiverso_tpu/models/wordembedding/
// device_train.py:877-920). A group's ids, sorted (order: sorted position
// -> original position; inv: its inverse), are cut at `bounds` [S + 1]
// into one segment a server, server s taking sorted positions
// [bounds[s], bounds[s+1]); each segment travels in a fixed capacity
// cap[s] (static, calibrated once), padded past the ids' end.
//
// K17, the reassembly: out[j] = parts[s][p - bounds[s]] for p = inv[j],
// s the owner of p (bounds[s] <= p < bounds[s+1]), when p - bounds[s] <
// cap[s]; zeros otherwise — the reference's zero buffer overwritten by
// each server's slice in server order, where the last writer of a
// position is its owner and a position past its owner's capacity keeps
// a zero (or an earlier server's slack row, which that server gathered
// as zero: the id is foreign to it).
//
// K18, the re-slicing: seg[s][k] = src[order[bounds[s] + k]] for
// bounds[s] + k < n and `fill` past n, k < cap[s]; the segments lie end
// to end in one buffer. Slack rows past bounds[s+1] are COPIED, as the
// reference's dynamic_slice copies them: their ids are foreign to server
// s, whose bounded scatter (K16) drops them. With 4-byte ids (d = 1) and
// fill = the pad sentinel it cuts the sorted ids themselves.
//
// Both move 4-byte words (float32 rows, int32 ids), 16 bytes a thread
// where the rows allow it. Bound on the card: bytes — each output row
// written once, each source row it copies and its permutation index read
// once; the few bounds are read by every thread from L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegments = 16;

struct Segments {
  const void* part[kMaxSegments];  // K17: server s's reply rows
  int64_t cap[kMaxSegments];       // capacity of segment s (rows)
  int64_t start[kMaxSegments + 1];  // K18: segment s's first output row
  int count;
};

// The owner of sorted position p: the last s with bounds[s] <= p
// (bounds[0] = 0 <= p); empty segments are skipped.
__device__ __forceinline__ int owner_of(const int32_t* bounds, int count,
                                        int64_t p) {
  int s = 0;
  for (int t = 1; t < count; ++t) {
    if (static_cast<int64_t>(__ldg(bounds + t)) <= p) s = t;
  }
  return s;
}

template <typename W>
__global__ void segment_merge_kernel(Segments seg,
                                     const int32_t* __restrict__ bounds,
                                     const int64_t* __restrict__ inv,
                                     int64_t n, int nv, W* __restrict__ out) {
  const int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (i >= n * nv) return;
  const int64_t j = i / nv;
  const int c = static_cast<int>(i - j * nv);
  const int64_t p = __ldg(inv + j);
  const int s = owner_of(bounds, seg.count, p);
  const int64_t local = p - __ldg(bounds + s);
  W v;
  if (local < seg.cap[s]) {
    v = __ldg(reinterpret_cast<const W*>(seg.part[s]) + local * nv + c);
  } else {
    v = W{};
  }
  out[i] = v;
}

template <typename W>
__global__ void segment_split_kernel(Segments seg, const W* __restrict__ src,
                                     const int64_t* __restrict__ order,
                                     const int32_t* __restrict__ bounds,
                                     int64_t n, int nv, W fill,
                                     W* __restrict__ out) {
  const int64_t total = seg.start[seg.count];
  const int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (i >= total * nv) return;
  const int64_t r = i / nv;
  const int c = static_cast<int>(i - r * nv);
  int s = 0;
  for (int t = 1; t < seg.count; ++t) {
    if (seg.start[t] <= r) s = t;
  }
  const int64_t q = static_cast<int64_t>(__ldg(bounds + s)) + (r - seg.start[s]);
  out[i] = q < n ? __ldg(src + __ldg(order + q) * nv + c) : fill;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// K17: parts_host[S] device pointers to [caps_host[s], d] 4-byte words;
// bounds [S + 1] int32 and inv [n] int64 on the card; out [n, d].
extern "C" cudaError_t mv_segment_merge(const void* const* parts_host,
                                        const int64_t* caps_host, int S,
                                        const int32_t* bounds,
                                        const int64_t* inv, int64_t n, int d,
                                        void* out, cudaStream_t stream) {
  if (S < 1 || S > kMaxSegments || d <= 0) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  Segments seg{};
  seg.count = S;
  bool vec = d % 4 == 0 && aligned16(out);
  for (int s = 0; s < S; ++s) {
    seg.part[s] = parts_host[s];
    seg.cap[s] = caps_host[s];
    vec = vec && aligned16(parts_host[s]);
  }
  if (vec) {
    const int nv = d / 4;
    segment_merge_kernel<uint4><<<blocks_for(n * nv), kThreads, 0, stream>>>(
        seg, bounds, inv, n, nv, static_cast<uint4*>(out));
  } else {
    segment_merge_kernel<uint32_t><<<blocks_for(n * d), kThreads, 0, stream>>>(
        seg, bounds, inv, n, d, static_cast<uint32_t*>(out));
  }
  return cudaGetLastError();
}

// K18: src [n, d] 4-byte words, order [n] int64 and bounds [S + 1] int32
// on the card; out [sum(caps_host), d], segment s from row
// caps_host[0] + ... + caps_host[s-1]; `fill` the bits of a padding word.
extern "C" cudaError_t mv_segment_split(const void* src, int64_t n, int d,
                                        const int64_t* order,
                                        const int32_t* bounds, int S,
                                        const int64_t* caps_host,
                                        uint32_t fill, void* out,
                                        cudaStream_t stream) {
  if (S < 1 || S > kMaxSegments || d <= 0) return cudaErrorInvalidValue;
  Segments seg{};
  seg.count = S;
  seg.start[0] = 0;
  for (int s = 0; s < S; ++s) {
    seg.cap[s] = caps_host[s];
    seg.start[s + 1] = seg.start[s] + caps_host[s];
  }
  const int64_t total = seg.start[S];
  if (total <= 0) return cudaSuccess;
  if (d % 4 == 0 && aligned16(src) && aligned16(out)) {
    const int nv = d / 4;
    segment_split_kernel<uint4><<<blocks_for(total * nv), kThreads, 0, stream>>>(
        seg, static_cast<const uint4*>(src), order, bounds, n, nv,
        make_uint4(fill, fill, fill, fill), static_cast<uint4*>(out));
  } else {
    segment_split_kernel<uint32_t><<<blocks_for(total * d), kThreads, 0, stream>>>(
        seg, static_cast<const uint32_t*>(src), order, bounds, n, d, fill,
        static_cast<uint32_t*>(out));
  }
  return cudaGetLastError();
}
