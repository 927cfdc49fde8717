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
// Bound on the card: bytes. Each token's flat, u and sent are read once
// and its two outputs written once (20 bytes a token), plus the keep
// table's reads; there is no arithmetic to speak of. The design reads
// every token once:
//   1. compact_tiles: a block a tile of kTile = 4096 tokens, as kPer rows
//      of kThreads (thread t holds tokens t, t + kThreads, ...: each load
//      of a warp is 128 contiguous bytes). A ballot a row gives each
//      token its rank; a block scan of the (row, warp) counts gives the
//      tile's kept count, and a decoupled look-back over per-tile status
//      words the kept tokens before the tile (a tile publishes its own
//      count, then its inclusive prefix; a warp reads 32 predecessors at
//      a time back to the nearest prefix). Status words are written by
//      one thread and hold no float data; the outputs are written without
//      atomics. The kept tokens of a warp's row go to consecutive final
//      slots straight from registers. A dropped token's slot, n_kept +
//      (dropped before it), needs the TOTAL kept count, which only the
//      last tile knows: the dropped tokens go, in order, to a scratch list
//      at their rank among the dropped.
//   2. place_dropped: copies that list to [n_kept, T) and writes the -1
//      sentences, a grid-stride loop over the dropped count; it reads 4
//      bytes a dropped token, not the token's flat, u and keep again.
// The other way, holding each tile's tokens in registers across one
// grid-wide barrier, would need the whole corpus resident on the card's
// SMs at once (6M tokens at the bench's corpus: more than the registers
// and shared memory of 132 SMs hold), so its tiles would have to grow
// with T; the second launch costs a launch gap and 12 bytes a dropped
// token instead. (Measured against the variants, on one card in one
// call: staging a tile in shared memory with 16-byte loads lost to
// these rows, by its bank conflicts; 16-byte loads of 4 tokens a lane
// lost by their strided stores.)
// Tiles take their status from blockIdx order (the card starts blocks in
// index order, so every tile's predecessors are running or done when it
// looks back). The status words carry the call's epoch (the wrapper's
// counter), so a word left by an earlier call reads as not ready and the
// words need no clearing between calls.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 8;                  // rows a tile: tokens a thread
constexpr int kTile = kThreads * kPer;   // tokens a tile (TILE)
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kPer * kWarps;     // (row, warp) counts a tile
constexpr int kPlaceThreads = 256;
constexpr unsigned kAggregate = 1, kPrefix = 2;  // a status word's flag
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long status_word(unsigned epoch,
                                                          unsigned flag,
                                                          unsigned count) {
  return ((unsigned long long)((epoch << 2) | flag) << 32) | count;
}

__device__ __forceinline__ void publish(unsigned long long* status,
                                        int64_t tile,
                                        unsigned long long word) {
  *reinterpret_cast<volatile unsigned long long*>(status + tile) = word;
}

// The kept tokens before `tile` (warp 0 of its block; every lane returns
// it). Lane i reads tile top - i of a window of 32, waiting until that
// tile's word of this epoch is there; the window's nearest prefix ends
// the walk, else its counts add up and the window moves down by 32.
__device__ unsigned look_back(const unsigned long long* status, int64_t tile,
                              unsigned epoch) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0;
  for (int64_t top = tile - 1;; top -= 32) {
    const int64_t at = top - lane;
    unsigned flag = kPrefix, count = 0;  // before tile 0: a prefix of 0
    if (at >= 0) {
      unsigned long long word;
      do {
        word = *reinterpret_cast<const volatile unsigned long long*>(status +
                                                                      at);
      } while ((unsigned)(word >> 34) != epoch ||
               ((unsigned)(word >> 32) & 3u) == 0);
      flag = (unsigned)(word >> 32) & 3u;
      count = (unsigned)word;
    }
    const unsigned prefixes = __ballot_sync(kFull, flag == kPrefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    unsigned part = lane <= stop ? count : 0u;
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
    prefix += part;
    if (prefixes) return prefix;
  }
}

__global__ void __launch_bounds__(kThreads) compact_tiles(
    const int32_t* __restrict__ flat, const int32_t* __restrict__ sent,
    const float* __restrict__ keep, const float* __restrict__ u, int64_t n,
    unsigned long long* status, unsigned epoch,
    int32_t* __restrict__ dropped, int32_t* __restrict__ n_kept,
    int32_t* __restrict__ kept_out, int32_t* __restrict__ ksent_out) {
  __shared__ int s_pre[kRows];  // counts, then kept before each (row, warp)
  __shared__ unsigned s_prefix, s_total;
  const int64_t tile = blockIdx.x;
  const int64_t base = tile * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t fl[kPer], se[kPer];
  float uu[kPer], kv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t t = base + i * kThreads + threadIdx.x;
    const bool in = t < n;
    fl[i] = in ? __ldcs(flat + t) : 0;
    uu[i] = in ? __ldcs(u + t) : 2.f;  // past the end: never kept
    se[i] = in ? __ldcs(sent + t) : 0;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    kv[i] = base + i * kThreads + threadIdx.x < n ? __ldg(keep + fl[i]) : 0.f;
  unsigned bal[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    bal[i] = __ballot_sync(kFull, uu[i] < kv[i]);
    if (lane == 0) s_pre[i * kWarps + warp] = __popc(bal[i]);
  }
  __syncthreads();
  if (warp == 0) {
    // Exclusive scan of the kRows counts in (row, warp) order, which is
    // the tokens' order: a lane takes kRows / 32 consecutive ones.
    constexpr int kEach = kRows / 32;
    int c[kEach], sum = 0;
#pragma unroll
    for (int j = 0; j < kEach; ++j) {
      c[j] = s_pre[lane * kEach + j];
      sum += c[j];
    }
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned total = __shfl_sync(kFull, incl, 31);
    int run = incl - sum;
#pragma unroll
    for (int j = 0; j < kEach; ++j) {
      s_pre[lane * kEach + j] = run;
      run += c[j];
    }
    unsigned before = 0;
    if (tile == 0) {
      if (lane == 0) publish(status, 0, status_word(epoch, kPrefix, total));
    } else {
      if (lane == 0)
        publish(status, tile, status_word(epoch, kAggregate, total));
      before = look_back(status, tile, epoch);
      if (lane == 0)
        publish(status, tile, status_word(epoch, kPrefix, before + total));
    }
    if (lane == 0) {
      s_prefix = before;
      s_total = total;
    }
  }
  __syncthreads();
  const int64_t prefix = s_prefix;
  const int64_t dropped_before = base - prefix;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int pos = i * kThreads + threadIdx.x;  // in the tile
    if (base + pos >= n) break;
    const int rank = s_pre[i * kWarps + warp] + __popc(bal[i] & below);
    if (bal[i] >> lane & 1u) {
      kept_out[prefix + rank] = fl[i];
      ksent_out[prefix + rank] = se[i];
    } else {
      dropped[dropped_before + pos - rank] = fl[i];
    }
  }
  if (tile == gridDim.x - 1 && threadIdx.x == 0)
    *n_kept = (int32_t)(prefix + s_total);
}

// The dropped list to [n_kept, T), sentence -1.
__global__ void __launch_bounds__(kPlaceThreads) place_dropped(
    const int32_t* __restrict__ dropped, const int32_t* __restrict__ n_kept,
    int64_t n, int32_t* __restrict__ kept_out,
    int32_t* __restrict__ ksent_out) {
  const int64_t nk = *n_kept;
  const int64_t d = n - nk;
  for (int64_t i = (int64_t)blockIdx.x * kPlaceThreads + threadIdx.x; i < d;
       i += (int64_t)gridDim.x * kPlaceThreads) {
    kept_out[nk + i] = __ldcs(dropped + i);
    ksent_out[nk + i] = -1;
  }
}

}  // namespace

// status: ceil(n / 4096) 64-bit words that hold no word of `epoch` (the
// wrapper's per-device counter, 1 to 2^30 - 1); dropped: n int32 of
// scratch; n_kept: one int32; sms: the card's multiprocessors (the second
// launch takes 4 blocks of each).
extern "C" cudaError_t mv_subsample_compact(
    const int32_t* flat, const int32_t* sent, const float* keep,
    const float* u, int64_t n, unsigned long long* status, unsigned epoch,
    int32_t* dropped, int32_t* n_kept, int32_t* kept_out, int32_t* ksent_out,
    int sms, cudaStream_t stream) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles == 0) return cudaMemsetAsync(n_kept, 0, sizeof(int32_t), stream);
  compact_tiles<<<(unsigned)tiles, kThreads, 0, stream>>>(
      flat, sent, keep, u, n, status, epoch, dropped, n_kept, kept_out,
      ksent_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t most = (n + kPlaceThreads - 1) / kPlaceThreads;
  const int64_t wanted = 4 * (int64_t)(sms > 0 ? sms : 1);
  place_dropped<<<(unsigned)(most < wanted ? most : wanted), kPlaceThreads, 0,
                  stream>>>(dropped, n_kept, n, kept_out, ksent_out);
  return cudaGetLastError();
}
