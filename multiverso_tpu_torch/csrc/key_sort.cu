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
// ceil(log2(R + 1)) of them (20 at 1M rows, at most 31), in passes of
// equal width of at most 10 bits (two at 1M rows), over tiles of 2048
// keys. At the logreg path's 262,144 keys the data is a few MB, which
// L2 holds many times over: what costs is launches and the gaps between
// them (three launches a pass took 0.033 ms). So it is ONE cooperative
// launch of a persistent grid (at most the resident blocks; a block
// takes tiles t = block, block + grid, ...), its phases split by
// grid-wide barriers (four at two passes):
//   H. Each block counts its tiles' digits of pass 0 (the ids wrapped
//      into keys) in shared memory, one atomic a digit a warp
//      (`__match_any_sync` names the lanes that share one), into
//      hist[0][digit][tile], and zeroes the later passes' hist.
//   B. (each pass) A warp a digit scans hist[p][digit][*] over the tiles,
//      exclusive, in place (each tile's offset among the tiles before
//      it), and writes the digit's total.
//   C. (each pass) Each block takes the digits' bases (the totals scanned
//      over the digits) and ranks each of its tiles stably — a warp owns
//      256 consecutive keys and takes them 32 at a time, the lanes that
//      share a digit found by a match, counters a warp in shared memory,
//      the warps' counts scanned in warp order — then sorts the tile by
//      digit in shared memory and writes it out: a digit's keys of a
//      tile go to consecutive places (base + the tile's offset + rank),
//      so the writes coalesce. Before the last pass it also counts the
//      keys' next digits by the tiles of the places they went to, into
//      hist[p + 1] with integer atomics: a warp writes 32 consecutive
//      places of the sorted tile, whose (next digit, tile) pairs repeat
//      in runs, so one atomic a pair a warp keeps a hot row from queuing
//      on one counter, and the next pass needs no counting phase of its
//      own.
// Every digit loop takes digits thread + 256 i, so shared memory serves
// a warp in one pass (no bank conflicts); scans over the digits run on
// those four rows at once. Each thread issues its loads of a phase at
// once (8 keys; its digits' tile offsets before it ranks). Data one
// block wrote and another reads goes through L2 (`__ldcg`). Integer
// counts only, no state kept between launches: the result is the same
// on every run.
//
// Bound on the card: bytes (each key read and written with its position
// once a pass: 16 bytes a key a pass, and the ids read once).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kItems = 8;                       // keys a lane
constexpr int kWarpKeys = 32 * kItems;          // 256 keys a warp
constexpr int kTile = kSortThreads * kItems;    // 2048 keys a tile
constexpr int kMaxDigit = 10;
constexpr int kMaxBins = 1 << kMaxDigit;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;  // devices whose occupancy is cached

struct Sort {
  const int32_t* ids;
  int64_t n;
  int64_t rows;    // R: the sentinel key
  int64_t tiles;
  int passes, width, bits;
  int32_t* hist;   // [passes][kMaxBins][tiles]: tile counts, then offsets
  int32_t* totals; // [kMaxBins]: the pass's digit totals
  int32_t* keys_out;
  int32_t* order_out;
  int32_t* tmp_keys;
  int32_t* tmp_order;
};

__device__ __forceinline__ int pass_bits(const Sort& s, int p) {
  const int left = s.bits - p * s.width;
  return left < s.width ? left : s.width;
}

__device__ __forceinline__ int digit_of(int32_t key, int shift, int bits) {
  return (int)(((uint32_t)key >> shift) & ((1u << bits) - 1u));
}

__device__ __forceinline__ int32_t wrap_key(const Sort& s, int64_t i) {
  int64_t id = s.ids[i];
  if (id < 0) id += s.rows;
  return (id >= 0 && id < s.rows) ? (int32_t)id : (int32_t)s.rows;
}

// Where pass p reads: the ids (pass 0) or the pass before's output.
__device__ __forceinline__ const int32_t* pass_keys(const Sort& s, int p) {
  return ((s.passes - p) % 2 == 0) ? s.keys_out : s.tmp_keys;
}
__device__ __forceinline__ const int32_t* pass_order(const Sort& s, int p) {
  return ((s.passes - p) % 2 == 0) ? s.order_out : s.tmp_order;
}

// Key i of pass p's input and its position; pos -1 past the end.
__device__ __forceinline__ int32_t key_at(const Sort& s, int p, int64_t i,
                                          int32_t& pos) {
  if (i >= s.n) {
    pos = -1;
    return -1;
  }
  if (p == 0) {
    pos = (int32_t)i;
    return wrap_key(s, i);
  }
  pos = __ldcg(pass_order(s, p) + i);
  return __ldcg(pass_keys(s, p) + i);
}

// Add one to counts[digit] for each lane's digit d >= 0: one shared
// atomic a digit a warp (the lanes that share it found by a match).
__device__ __forceinline__ void count_warp(int32_t* counts, int d) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  const unsigned peers = __match_any_sync(kFull, d);
  if (d >= 0 && (peers & below) == 0) atomicAdd(counts + d, __popc(peers));
}

constexpr int kPer = kMaxBins / kSortThreads;  // digits a thread

// pass p's hist: [kMaxBins][tiles].
__device__ __forceinline__ int32_t* hist_of(const Sort& s, int p) {
  return s.hist + (int64_t)p * kMaxBins * s.tiles;
}

// H: pass 0's digits of each of this block's tiles to hist[0], and the
// later passes' hist zeroed. A lane's 8 keys (positions j * 256 +
// thread: coalesced), loaded at once.
__device__ void count_digits(const Sort& s, int32_t* smem) {
  const int pbits = pass_bits(s, 0);
  const int bins = 1 << pbits;
  int32_t* hist = hist_of(s, 0);
  for (int64_t t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    int32_t key[kItems], pos;
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      key[j] = key_at(s, 0, t * kTile + j * kSortThreads + threadIdx.x, pos);
    for (int d = threadIdx.x; d < bins; d += kSortThreads) smem[d] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      count_warp(smem, key[j] >= 0 ? digit_of(key[j], 0, pbits) : -1);
    __syncthreads();
    for (int d = threadIdx.x; d < bins; d += kSortThreads)
      hist[(int64_t)d * s.tiles + t] = smem[d];
    __syncthreads();
  }
  const int64_t later = (int64_t)(s.passes - 1) * kMaxBins * s.tiles;
  int32_t* rest = hist_of(s, 1);
  for (int64_t i = blockIdx.x * (int64_t)kSortThreads + threadIdx.x;
       i < later; i += (int64_t)gridDim.x * kSortThreads)
    rest[i] = 0;
}

// B: a warp a digit, its tiles' counts scanned (exclusive) in place, and
// the digit's total.
__device__ void scan_tiles(const Sort& s, int p) {
  const int bins = 1 << pass_bits(s, p);
  const int lane = threadIdx.x & 31;
  const int64_t warp = (blockIdx.x * (int64_t)kSortThreads + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * kSortThreads) >> 5;
  const int64_t per = (s.tiles + 31) / 32;
  for (int64_t d = warp; d < bins; d += warps) {
    int32_t* h = hist_of(s, p) + d * s.tiles;
    const int64_t b0 = lane * per;
    int32_t mine = 0;
    for (int64_t b = b0; b < b0 + per && b < s.tiles; ++b) mine += __ldcg(h + b);
    int32_t incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += up;
    }
    int32_t run = incl - mine;
    for (int64_t b = b0; b < b0 + per && b < s.tiles; ++b) {
      const int32_t c = __ldcg(h + b);
      h[b] = run;
      run += c;
    }
    if (lane == 31) s.totals[d] = incl;
  }
}

// An exclusive scan over the digits of the values v[i] of digits thread
// + 256 i (the digits in order: row i of 256 after row i - 1): each
// value's offset, in place. `warp_tot`: kSortWarps * kPer ints of shared
// memory; the block synchronizes.
__device__ __forceinline__ void digit_scan(int32_t (&v)[kPer],
                                           int32_t* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t incl[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) incl[i] = v[i];
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int32_t up = __shfl_up_sync(kFull, incl[i], o);
      if (lane >= o) incl[i] += up;
    }
  }
  __syncthreads();  // warp_tot's last readers are done
  if (lane == 31) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) warp_tot[warp * kPer + i] = incl[i];
  }
  __syncthreads();
  int32_t rows = 0;  // the rows before row i
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    int32_t before = 0, row = 0;
    for (int w = 0; w < kSortWarps; ++w) {
      const int32_t c = warp_tot[w * kPer + i];
      if (w < warp) before += c;
      row += c;
    }
    const int32_t x = v[i];
    v[i] = rows + before + incl[i] - x;
    rows += row;
  }
}

// C: pass p's tiles ranked stably, sorted by digit in shared memory and
// written out; before the last pass, the next pass's hist counted.
__device__ void scatter_pass(const Sort& s, int p, int32_t* smem) {
  int32_t* base = smem;                          // [kMaxBins]
  int32_t* dest = smem + kMaxBins;               // [kMaxBins]
  int32_t* cnt = smem + 2 * kMaxBins;            // [kSortWarps][kMaxBins]
  int32_t* warp_tot = cnt + kSortWarps * kMaxBins;  // [kSortWarps * kPer]
  int32_t* stage_key = cnt;                      // [kTile], over cnt
  int32_t* stage_pos = cnt + kTile;              // [kTile]
  const int pbits = pass_bits(s, p), shift = p * s.width;
  const int bins = 1 << pbits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool last = p + 1 == s.passes;
  const int nbits = last ? 0 : pass_bits(s, p + 1);
  const bool to_out = (s.passes - 1 - p) % 2 == 0;
  int32_t* keys_out = to_out ? s.keys_out : s.tmp_keys;
  int32_t* order_out = to_out ? s.order_out : s.tmp_order;
  const int32_t* hist = hist_of(s, p);
  int32_t* next_hist = last ? nullptr : hist_of(s, p + 1);
  {
    int32_t tot[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = threadIdx.x + i * kSortThreads;
      tot[i] = d < bins ? __ldcg(s.totals + d) : 0;
    }
    digit_scan(tot, warp_tot);
#pragma unroll
    for (int i = 0; i < kPer; ++i) base[threadIdx.x + i * kSortThreads] = tot[i];
  }
  const unsigned below = (1u << lane) - 1u;
  for (int64_t t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    // This tile's offsets of the thread's digits and the warp's 256 keys
    // (32 at a time, in position order), loaded at once.
    int32_t off[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = threadIdx.x + i * kSortThreads;
      off[i] = d < bins ? __ldcg(hist + (int64_t)d * s.tiles + t) : 0;
    }
    const int64_t lo = t * kTile + warp * kWarpKeys;
    int32_t key[kItems], pos[kItems], slot[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      key[j] = key_at(s, p, lo + j * 32 + lane, pos[j]);
    for (int d = threadIdx.x; d < kSortWarps * kMaxBins; d += kSortThreads)
      cnt[d] = 0;
    __syncthreads();
    int32_t* wcnt = cnt + warp * kMaxBins;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int d = pos[j] >= 0 ? digit_of(key[j], shift, pbits) : -1;
      const unsigned peers = __match_any_sync(kFull, d);
      const int32_t seen = d >= 0 ? wcnt[d] : 0;
      __syncwarp();
      slot[j] = seen + __popc(peers & below);
      if (d >= 0 && (peers & below) == 0) wcnt[d] = seen + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // Each digit's count in the tile, the warps' counts scanned in warp
    // order, and the digits' places in the tile sorted by digit.
    int32_t local[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = threadIdx.x + i * kSortThreads;
      int32_t r = 0;
      for (int w = 0; w < kSortWarps; ++w) {
        const int32_t c = cnt[w * kMaxBins + d];
        cnt[w * kMaxBins + d] = r;
        r += c;
      }
      local[i] = r;
    }
    digit_scan(local, warp_tot);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = threadIdx.x + i * kSortThreads;
      for (int w = 0; w < kSortWarps; ++w) cnt[w * kMaxBins + d] += local[i];
      // A key at place q of the sorted tile goes to dest[digit] + q.
      dest[d] = base[d] + off[i] - local[i];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (pos[j] >= 0) slot[j] += wcnt[digit_of(key[j], shift, pbits)];
    __syncthreads();  // cnt is read: the staging area takes its place
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (pos[j] < 0) continue;
      stage_key[slot[j]] = key[j];
      stage_pos[slot[j]] = pos[j];
    }
    __syncthreads();
    const int count = (int)(s.n - t * kTile < kTile ? s.n - t * kTile : kTile);
    for (int q0 = 0; q0 < count; q0 += kSortThreads) {
      const int q = q0 + threadIdx.x;
      int32_t next = -1;  // the key's slot of the next pass's hist
      if (q < count) {
        const int32_t k = stage_key[q];
        const int32_t at = dest[digit_of(k, shift, pbits)] + q;
        keys_out[at] = k;
        order_out[at] = stage_pos[q];
        if (!last)
          next = digit_of(k, shift + pbits, nbits) * (int32_t)s.tiles +
                 at / kTile;
      }
      if (!last) {
        const unsigned peers = __match_any_sync(kFull, next);
        if (next >= 0 && (peers & below) == 0)
          atomicAdd(next_hist + next, __popc(peers));
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kSortThreads) key_sort_kernel(Sort s) {
  __shared__ int32_t smem[2 * kMaxBins + kSortWarps * kMaxBins +
                         kSortWarps * kPer];
  cg::grid_group grid = cg::this_grid();
  count_digits(s, smem);
  grid.sync();
  for (int p = 0; p < s.passes; ++p) {
    scan_tiles(s, p);
    grid.sync();
    scatter_pass(s, p, smem);
    if (p + 1 < s.passes) grid.sync();
  }
}

}  // namespace

// Scratch: hist [passes][1024][tiles] (tiles = ceil(n / 2048), passes =
// ceil(bits / 10)), totals [1024], tmp_keys and tmp_order [n];
// keys_out, order_out [n].
extern "C" cudaError_t mv_key_sort(const int32_t* ids, int64_t n,
                                   int64_t rows, int bits, int32_t* keys_out,
                                   int32_t* order_out, int32_t* hist,
                                   int32_t* totals, int32_t* tmp_keys,
                                   int32_t* tmp_order, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (bits < 1 || bits > 31 || n > INT32_MAX) return cudaErrorInvalidValue;
  // The resident blocks of each device, found at its first call.
  static int resident_of[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& resident = resident_of[dev];
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, key_sort_kernel, kSortThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
    resident = per_sm * sms;
  }
  const int passes = (bits + kMaxDigit - 1) / kMaxDigit;
  Sort s{ids, n, rows, (n + kTile - 1) / kTile, passes,
         (bits + passes - 1) / passes, bits, hist, totals, keys_out,
         order_out, tmp_keys, tmp_order};
  const int64_t blocks = s.tiles < resident ? s.tiles : resident;
  void* args[] = {&s};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(key_sort_kernel), dim3((unsigned)blocks),
      dim3(kSortThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
