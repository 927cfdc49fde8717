// K20 key_sort: row ids sorted stably by the rows they name, on the card.
//
// It replaces no program of the reference: JAX's `.at[keys].add` and the
// touched-row mask of make_sparse_step (multiverso_tpu/models/logreg/
// objective.py:89-116) need no sort on a TPU. The port sums each row's
// occurrences in an order fixed by the data (ROADMAP C11), which needs
// the flat positions grouped by row in position order: a stable sort by
// row, kept on the card with no host sync. K12 runs on it; the plain
// version is torch.sort(stable=True).
//
// Keys: an id in [-R, -1] wraps to id + R, an id in [0, R) stays, every
// other id becomes R and sorts last (JAX's wrap-then-drop). Output: the
// sorted keys and, for each, its flat position (both int32).
//
// A stable least-significant-digit radix sort over the keys' bits,
// ceil(log2(R + 1)) of them (20 at 1M rows, at most 31), in passes of at
// most 10 bits (two at 1M rows). A pass is three launches over tiles of
// 2048 keys, a block a tile: (1) each block counts its tile's digits in
// shared memory; (2) a warp a digit scans the blocks' counts of that
// digit (exclusive, in block order) and totals them; (3) each block
// ranks its tile's keys stably — a warp owns 256 consecutive keys and
// takes them 32 at a time, `__match_any_sync` naming the lanes that
// share a digit, per-warp counters in shared memory, then the warps'
// counts scanned in warp order — and writes each key and its position
// to the digit's base (the totals scanned) plus the block's offset plus
// its rank. Integer counts only: the result is the same on every run.
//
// Bound on the card: bytes (each key read and written with its
// position once a pass: 16 bytes a key a pass, and the ids read once).
// At 262,144 keys the work is a few MB and the launches' latency rules.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kItems = 8;                       // keys a lane
constexpr int kWarpKeys = 32 * kItems;          // 256 keys a warp
constexpr int kTile = kSortThreads * kItems;    // 2048 keys a block
constexpr int kMaxDigit = 10;
constexpr int kMaxBins = 1 << kMaxDigit;
constexpr unsigned kFull = 0xffffffffu;

struct Pass {
  const int32_t* ids;    // pass 0: the raw ids; else null
  const int32_t* keys;   // later passes: the keys of the pass before
  const int32_t* order;  //   and their positions
  int64_t rows;          // R: the sentinel key
  int64_t n;
  int shift, bits;       // this pass's digit: key bits [shift, shift+bits)
  int32_t* hist;         // [bins * blocks] digit-major counts, then offsets
  int32_t* total;        // [bins]
  int32_t* keys_out;
  int32_t* order_out;
};

// Key i of the pass's input, and its position; -1 past the end.
__device__ __forceinline__ int32_t key_at(const Pass& p, int64_t i,
                                          int32_t& pos) {
  if (i >= p.n) {
    pos = -1;
    return -1;
  }
  if (p.ids != nullptr) {
    pos = (int32_t)i;
    int64_t id = p.ids[i];
    if (id < 0) id += p.rows;
    return (id >= 0 && id < p.rows) ? (int32_t)id : (int32_t)p.rows;
  }
  pos = p.order[i];
  return p.keys[i];
}

__device__ __forceinline__ int digit_of(int32_t key, const Pass& p) {
  return (int)(((uint32_t)key >> p.shift) & ((1u << p.bits) - 1u));
}

// (1) The digits of each block's tile, counted: one shared-memory add a
// digit a warp (the lanes that share a digit found by a ballot), so the
// padding key's many copies do not queue on one counter.
__global__ void __launch_bounds__(kSortThreads) sort_hist(Pass p) {
  __shared__ int32_t counts[kMaxBins];
  const int bins = 1 << p.bits;
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  for (int d = threadIdx.x; d < bins; d += kSortThreads) counts[d] = 0;
  __syncthreads();
  const int64_t lo = (int64_t)blockIdx.x * kTile;
  int32_t key[kItems], pos[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    key[j] = key_at(p, lo + j * kSortThreads + threadIdx.x, pos[j]);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int d = pos[j] >= 0 ? digit_of(key[j], p) : -1;
    const unsigned peers = __match_any_sync(kFull, d);
    if (d >= 0 && (peers & below) == 0) atomicAdd(&counts[d], __popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < bins; d += kSortThreads)
    p.hist[(int64_t)d * gridDim.x + blockIdx.x] = counts[d];
}

// (2) A warp a digit: its blocks' counts scanned (exclusive) in place,
// and its total.
__global__ void __launch_bounds__(kSortThreads) sort_scan(Pass p,
                                                          int blocks) {
  const int lane = threadIdx.x & 31;
  const int d = (blockIdx.x * kSortThreads + threadIdx.x) >> 5;
  if (d >= (1 << p.bits)) return;
  int32_t* h = p.hist + (int64_t)d * blocks;
  const int per = (blocks + 31) / 32;
  const int b0 = lane * per;
  int32_t mine = 0;
  for (int b = b0; b < b0 + per && b < blocks; ++b) mine += h[b];
  int32_t incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  int32_t run = incl - mine;
  for (int b = b0; b < b0 + per && b < blocks; ++b) {
    const int32_t c = h[b];
    h[b] = run;
    run += c;
  }
  if (lane == 31) p.total[d] = incl;
}

// (3) Each block's tile ranked stably and scattered.
__global__ void __launch_bounds__(kSortThreads) sort_scatter(Pass p) {
  __shared__ int32_t base[kMaxBins];
  __shared__ int32_t cnt[kSortWarps][kMaxBins];
  __shared__ int32_t warp_tot[kSortWarps];
  const int bins = 1 << p.bits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The digits' bases: the totals scanned (exclusive) over the digits,
  // kMaxBins / kSortThreads consecutive digits a thread.
  constexpr int kPer = kMaxBins / kSortThreads;
  int32_t t[kPer], sum = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = threadIdx.x * kPer + i;
    t[i] = d < bins ? p.total[d] : 0;
    sum += t[i];
  }
  int32_t incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_tot[warp] = incl;
  for (int d = threadIdx.x; d < kSortWarps * kMaxBins; d += kSortThreads)
    (&cnt[0][0])[d] = 0;
  __syncthreads();
  int32_t run = incl - sum;
  for (int w = 0; w < warp; ++w) run += warp_tot[w];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = threadIdx.x * kPer + i;
    if (d < bins)
      base[d] = run + p.hist[(int64_t)d * gridDim.x + blockIdx.x];
    run += t[i];
  }
  // Rank the warp's 256 keys, 32 at a time, in position order.
  const int64_t lo = (int64_t)blockIdx.x * kTile + warp * kWarpKeys;
  int32_t key[kItems], pos[kItems], rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    key[j] = key_at(p, lo + j * 32 + lane, pos[j]);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int d = pos[j] >= 0 ? digit_of(key[j], p) : -1;
    const unsigned peers = __match_any_sync(kFull, d);
    const int32_t before = d >= 0 ? cnt[warp][d] : 0;
    __syncwarp();
    rank[j] = before + __popc(peers & below);
    if (d >= 0 && (peers & below) == 0) cnt[warp][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // The warps' counts scanned in warp order: each warp's offset a digit.
  for (int d = threadIdx.x; d < bins; d += kSortThreads) {
    int32_t r = 0;
    for (int w = 0; w < kSortWarps; ++w) {
      const int32_t c = cnt[w][d];
      cnt[w][d] = r;
      r += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (pos[j] < 0) continue;
    const int d = digit_of(key[j], p);
    const int32_t at = base[d] + cnt[warp][d] + rank[j];
    p.keys_out[at] = key[j];
    p.order_out[at] = pos[j];
  }
}

// ceil(bits / 10) passes of equal width (the last narrower where the
// bits do not divide).
inline int sort_passes(int bits) {
  return (bits + kMaxDigit - 1) / kMaxDigit;
}

}  // namespace

// Scratch: hist [1024 * blocks], total [1024], tmp_keys/tmp_order [n]
// (blocks = ceil(n / 2048)); keys_out/order_out [n].
extern "C" cudaError_t mv_key_sort(const int32_t* ids, int64_t n,
                                   int64_t rows, int bits, int32_t* keys_out,
                                   int32_t* order_out, int32_t* hist,
                                   int32_t* total, int32_t* tmp_keys,
                                   int32_t* tmp_order, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (bits < 1 || bits > 31 || n > INT32_MAX) return cudaErrorInvalidValue;
  const int passes = sort_passes(bits);
  const int width = (bits + passes - 1) / passes;
  const int blocks = (int)((n + kTile - 1) / kTile);
  const int32_t* in_keys = nullptr;
  const int32_t* in_order = nullptr;
  for (int pass = 0; pass < passes; ++pass) {
    const bool to_out = (passes - 1 - pass) % 2 == 0;
    const int shift = pass * width;
    const int pbits = bits - shift < width ? bits - shift : width;
    Pass p{pass == 0 ? ids : nullptr, in_keys, in_order, rows, n, shift,
           pbits, hist, total, to_out ? keys_out : tmp_keys,
           to_out ? order_out : tmp_order};
    sort_hist<<<blocks, kSortThreads, 0, stream>>>(p);
    const int scan_blocks = ((1 << pbits) * 32 + kSortThreads - 1) /
                            kSortThreads;
    sort_scan<<<scan_blocks, kSortThreads, 0, stream>>>(p, blocks);
    sort_scatter<<<blocks, kSortThreads, 0, stream>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    in_keys = p.keys_out;
    in_order = p.order_out;
  }
  return cudaSuccess;
}
