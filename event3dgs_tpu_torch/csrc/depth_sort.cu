// The depth order of the binning: a stable radix sort of the table
// kernel's depth keys, and the running instance offsets in that order.
//
// Replaces the XLA code of event3dgs_tpu/ops/binning.py `bin_gaussians`
// that orders the Gaussians by depth (`jnp.argsort(depth_eff)`, line 306)
// and scans their instance counts in that order (the gather and
// `associative_scan`, lines 321-327); no Pallas kernel.  Called after the
// table kernel (csrc/expand.cu), which clears the state below at its first
// use; every call leaves it cleared again.
//
// 1. radix_histogram_kernel, eight blocks an SM over the keys, 2,048 at a
//    time: each key mapped to an unsigned word whose order is
//    torch.argsort's (ordered_key), and the counts of its four 8-bit
//    digits, a shared histogram a block (a thread's run of equal digits
//    added at once), added into one of HIST_COPIES copies in the state.
//    The last block to finish turns the counts into each pass's exclusive
//    digit starts and the plan: a pass whose digit is the same for every
//    key is a no-op of a stable LSD sort and does not run (if every pass
//    is one, the last runs, to write the outputs).  The decision is on the
//    device: the sort runs inside the CUDA graph of the train step, where
//    no pass may wait on the host.  The blocks also clear the passes'
//    look-back words for this call.
// 2. radix_pass_kernel, launched once per digit (least significant first),
//    one block a tile of SORT_TILE keys (SORT_TILE_SMALL below SORT_LARGE
//    keys: twice the blocks for a short sort), blocks in index order
//    (onesweep, as CUB's single-pass radix sort): each warp ranks its keys
//    in index order (a ballot per digit bit, as CUB's MatchAny, and a
//    running count per digit), the block adds its warps' counts, thread d
//    publishes the tile's count of digit d and finds the count of the
//    earlier tiles by a decoupled look-back (WINDOW tiles' words read at
//    once; with SORT_TILE keys a tile after the keys' staging, so that its
//    reads overlap those of the Gaussians), and the block writes its keys
//    through shared memory, each digit's run contiguous.  The payload is
//    the Gaussian's int32 index (made from the position by the first pass
//    that runs, so nothing is read for it there).  The last pass that runs
//    writes the order and, beside it, each rank's instance count (read
//    through the order from the table kernel's count column, 4 bytes a
//    Gaussian where its rect rows are 16), and no keys.
// 3. depth_offsets_kernel, OFFSETS_TILE ranks a block: the exclusive
//    prefix of the counts in depth order by a decoupled look-back over
//    blocks (contiguous: no gather), the offsets (through shared memory,
//    so that a warp's stores are contiguous) and, for K4's blocks, the
//    rank holding each segment's first slot (live segments only).  Its
//    blocks clear the sort's words of the state, each a slice; the last
//    block to finish clears its own look-back words, all threads at once.
//
// The order: keys ascending, ties in index order; -0.0 equal to +0.0;
// every NaN, of either sign, after +inf (torch.argsort's order on the CPU;
// see ops/binning.py `ordered_keys` for the card's).  The table kernel
// writes depths and +inf only.
//
// Bound: bytes.  Per Gaussian its key and count read, its order entry and
// offset written; a rank per segment.  The design moves more: each pass
// that runs reads and writes a key and an index (the first reads the key
// alone, the last writes the index and the count), 16 bytes a Gaussian;
// the last pass reads each count through the order, a 32-byte sector
// each; the offsets kernel reads the counts again and writes the offsets.
// What bounds a pass is its ranking and the chain of look-backs across
// tiles, not its bytes (PERF.md, Findings).
//
// Timing-only builds (tools/kernel_probes.py `offsets`); without a macro
// each expands to the shipping code, and the ablated builds write wrong
// orders or offsets and have no plain version:
//   E3D_OFFSETS_NOGATHER    the last pass reads the count at the rank it
//                           writes, not through the order
//   E3D_OFFSETS_NOLOOKBACK  every tile's prefix of a digit or a block's
//                           prefix of the counts taken as 0
//   E3D_OFFSETS_NOCLEAR     the offsets kernel leaves the sort's words

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

#include "segment.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int RADIX_BITS = 8;
constexpr int RADIX = 256;  // 1 << RADIX_BITS
constexpr int PASSES = 4;   // digits of a 32-bit key
constexpr int HIST_THREADS = 256;
constexpr int HIST_ITEMS = 8;
constexpr int HIST_TILE = HIST_THREADS * HIST_ITEMS;
constexpr int HIST_BLOCKS_PER_SM = 8;
// copies of the digit counts that the histogram blocks add into, block b
// into copy b % HIST_COPIES: fewer atomics on one word
constexpr int HIST_COPIES = 4;
constexpr int SORT_THREADS = 256;
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int SORT_BLOCKS_PER_SM = 4;
// keys a thread ranks: 16 from SORT_LARGE keys on, else 8 (twice the
// tiles, each one's chain of loads, ranks and look-back half as long)
constexpr int SORT_ITEMS = 16;
constexpr int SORT_ITEMS_SMALL = 8;
constexpr int SORT_TILE = SORT_THREADS * SORT_ITEMS;
constexpr int SORT_TILE_SMALL = SORT_THREADS * SORT_ITEMS_SMALL;
constexpr int SORT_LARGE = 1048576;  // 2^20
// earlier tiles a look-back reads at once, with SORT_TILE and with
// SORT_TILE_SMALL keys a tile
constexpr int LOOKBACK_WINDOW = 16;
constexpr int LOOKBACK_WINDOW_SMALL = 8;
constexpr int OFFSETS_THREADS = 256;
constexpr int OFFSETS_ITEMS = 8;
constexpr int OFFSETS_TILE = OFFSETS_THREADS * OFFSETS_ITEMS;
static_assert(SORT_THREADS == RADIX, "a thread per digit");
static_assert(HIST_THREADS == RADIX, "a thread per digit");

// The state, 32-bit words (ops/binning.py `lookback_words` mirrors it).
constexpr int ACC = 0;                 // [HIST_COPIES][PASSES][RADIX] counts
constexpr int HIST_DONE = 4096;        // histogram blocks finished
constexpr int OFFSETS_DONE = 4097;     // offsets blocks finished
constexpr int STARTS = 4098;           // [PASSES][RADIX] exclusive starts
constexpr int PLAN = 5122;             // bit p: pass p runs
constexpr int PASS_LOOKBACK = 5124;    // [tiles][RADIX] a pass's look-back
// then the offsets kernel's look-back, a 64-bit word a block

// A pass's look-back word: flag, pass, count (a tile's, or with the
// earlier tiles').  Written whole, so a reader needs no fence; a word of
// another pass (the passes share the words) reads as not yet written.
constexpr unsigned AGGREGATE = 1u << 30;
constexpr unsigned INCLUSIVE = 2u << 30;
constexpr int TAG_SHIFT = 28;
constexpr unsigned VALUE = (1u << TAG_SHIFT) - 1;  // n < 2^28
// the offsets kernel's look-back word: flag in the high half, value low
constexpr unsigned long long HAS_SUM = 1ull << 32;
constexpr unsigned long long HAS_PREFIX = 2ull << 32;
// a look-back wait that outlasts this many reads traps, so a fault shows
// as a launch error and not as a hang
constexpr long long SPIN_LIMIT = 1ll << 22;

// The key as an unsigned word in torch.argsort's order: the float's bits
// with the sign flipped (positive) or all bits flipped (negative); -0.0
// as +0.0; every NaN as the largest word.
__device__ __forceinline__ unsigned ordered_key(float f) {
  if (isnan(f)) return FULL;
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned load_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void store_volatile(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

__global__ void __launch_bounds__(HIST_THREADS)
radix_histogram_kernel(const float* __restrict__ key, int n,
                       unsigned* state, int pass_words) {
  __shared__ unsigned hist[PASSES * RADIX];
  __shared__ int last;
  using Scan = cub::BlockScan<unsigned, HIST_THREADS>;
  __shared__ Scan::TempStorage scan;
  const int tid = threadIdx.x;
  for (int i = tid; i < PASSES * RADIX; i += HIST_THREADS) hist[i] = 0;
  // this call's passes' look-back words, a slice a block
  for (int w = PASS_LOOKBACK + blockIdx.x * HIST_THREADS + tid;
       w < PASS_LOOKBACK + pass_words; w += gridDim.x * HIST_THREADS) {
    state[w] = 0;
  }
  __syncthreads();
  // a thread's run of equal digits is counted in a register and added
  // when the digit changes: the high digits of depths take few values,
  // and equal addresses would serialise the shared atomics
  unsigned run_digit[PASSES], run_count[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) run_digit[p] = run_count[p] = 0;
  for (int base = blockIdx.x * HIST_TILE; base < n;
       base += gridDim.x * HIST_TILE) {
    unsigned k[HIST_ITEMS];
#pragma unroll
    for (int j = 0; j < HIST_ITEMS; ++j) {
      const int i = base + j * HIST_THREADS + tid;
      k[j] = i < n ? ordered_key(key[i]) : 0u;
    }
#pragma unroll
    for (int j = 0; j < HIST_ITEMS; ++j) {
      if (base + j * HIST_THREADS + tid >= n) break;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const unsigned d = (k[j] >> (RADIX_BITS * p)) & (RADIX - 1);
        if (d != run_digit[p]) {
          if (run_count[p] != 0) {
            atomicAdd(&hist[p * RADIX + run_digit[p]], run_count[p]);
          }
          run_digit[p] = d;
          run_count[p] = 0;
        }
        ++run_count[p];
      }
    }
  }
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    if (run_count[p] != 0) {
      atomicAdd(&hist[p * RADIX + run_digit[p]], run_count[p]);
    }
  }
  __syncthreads();
  for (int i = tid; i < PASSES * RADIX; i += HIST_THREADS) {
    if (hist[i] != 0) {
      atomicAdd(state + ACC + (blockIdx.x % HIST_COPIES) * PASSES * RADIX + i,
                hist[i]);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(state + HIST_DONE, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: the counts (read and cleared at once), each pass's
  // exclusive starts, and the passes to run
  __threadfence();
  unsigned c[PASSES] = {};
#pragma unroll
  for (int copy = 0; copy < HIST_COPIES; ++copy) {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      c[p] += atomicExch(
          state + ACC + (copy * PASSES + p) * RADIX + tid, 0u);
    }
  }
  unsigned plan = 0;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    unsigned start;
    Scan(scan).ExclusiveSum(c[p], start);
    state[STARTS + p * RADIX + tid] = start;
    if (!__syncthreads_or(c[p] == (unsigned)n)) plan |= 1u << p;
  }
  if (tid == 0) {
    state[PLAN] = plan != 0 ? plan : 1u << (PASSES - 1);
    state[HIST_DONE] = 0;
  }
}

// The lanes whose digit d equals this lane's, among the lanes ``in`` (a
// ballot a bit, as CUB's MatchAny; __match_any_sync is slower).
__device__ __forceinline__ unsigned match_digit(unsigned d, bool in) {
  unsigned peers = __ballot_sync(FULL, in);
#pragma unroll
  for (int b = 0; b < RADIX_BITS; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned vote = __ballot_sync(FULL, bit);
    peers &= bit ? vote : ~vote;
  }
  return peers;
}

// Digit d's keys in the tiles before ``tile``: the decoupled look-back,
// WINDOW earlier tiles' words read at once, summed back to the nearest
// inclusive one.
template <int WINDOW>
__device__ __forceinline__ unsigned look_back(const unsigned* words,
                                              int tile, int d, int pass) {
  unsigned prefix = 0;
  for (int t = tile - 1; t >= 0; t -= WINDOW) {
    unsigned x[WINDOW];
    long long spins = 0;
    // wait until the words up to the nearest inclusive one are written
    for (bool ready = false; !ready;) {
      ready = true;
      bool seen = false;
#pragma unroll
      for (int q = 0; q < WINDOW; ++q) {
        x[q] = t - q >= 0 ? load_volatile(words + (t - q) * RADIX + d)
                          : INCLUSIVE | ((unsigned)pass << TAG_SHIFT);
        const bool written = (x[q] & (AGGREGATE | INCLUSIVE)) != 0 &&
                             ((x[q] >> TAG_SHIFT) & 3u) == (unsigned)pass;
        if (!seen) {
          ready &= written;
          seen = !written || (x[q] & INCLUSIVE) != 0;
        }
      }
      if (!ready && ++spins > SPIN_LIMIT) __trap();
    }
#pragma unroll
    for (int q = 0; q < WINDOW; ++q) {
      prefix += x[q] & VALUE;
      if (x[q] & INCLUSIVE) return prefix;
    }
  }
  return prefix;
}

template <int ITEMS>
struct PassShared {
  unsigned keys[SORT_THREADS * ITEMS];  // the tile's keys in block order
  int values[SORT_THREADS * ITEMS];     // and their Gaussians
  unsigned warp_count[SORT_WARPS][RADIX];  // per warp and digit
  int local_start[RADIX];               // the block's exclusive starts
  int shift[RADIX];                     // block rank -> output position
  cub::BlockScan<int, SORT_THREADS>::TempStorage scan;
};

template <int ITEMS, int WINDOW>
__global__ void __launch_bounds__(SORT_THREADS, SORT_BLOCKS_PER_SM)
radix_pass_kernel(const float* __restrict__ raw,  // [n] the table's keys
                  unsigned* keys0, unsigned* keys1,  // [n] each
                  int* values0, int* values1,        // [n] each
                  const int* __restrict__ count_in,  // [n] instance counts
                  int n, int pass, unsigned* state,
                  int* __restrict__ order,           // [n]
                  int* __restrict__ counts) {        // [n]
  constexpr int TILE = SORT_THREADS * ITEMS;
  __shared__ PassShared<ITEMS> s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the plan and thread d's digit start, read together
  const unsigned plan = state[PLAN];
  const unsigned start = state[STARTS + pass * RADIX + tid];
  if (!((plan >> pass) & 1u)) return;
  const unsigned before = plan & ((1u << pass) - 1u);
  const bool first = before == 0;
  const bool last = (plan >> (pass + 1)) == 0;
  // the passes that ran before alternate between the two buffers
  const bool odd = __popc(before) & 1;
  const unsigned* keys_in = odd ? keys0 : keys1;
  const int* values_in = odd ? values0 : values1;
  unsigned* keys_out = odd ? keys1 : keys0;
  int* values_out = odd ? values1 : values0;
  const int shift = RADIX_BITS * pass;
  // blocks start in index order, so a block waits in its look-back only on
  // blocks that have started (a wait that outlasts SPIN_LIMIT traps)
  const int tile = blockIdx.x;
  for (int i = tid; i < SORT_WARPS * RADIX; i += SORT_THREADS) {
    (&s.warp_count[0][0])[i] = 0;
  }
  // warp-striped: a warp's 32 * ITEMS keys are contiguous, key j of lane l
  // at j * 32 + l, so (warp, j, lane) is index order; with few keys a
  // thread, their Gaussians are read beside them (else after the ranks)
  constexpr bool EARLY = ITEMS <= SORT_ITEMS_SMALL;
  const int wbase = tile * TILE + warp * 32 * ITEMS;
  unsigned k[ITEMS];
  int v[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = wbase + j * 32 + lane;
    if (first) {
      k[j] = i < n ? ordered_key(raw[i]) : FULL;
    } else {
      k[j] = i < n ? keys_in[i] : FULL;
    }
    if constexpr (EARLY) v[j] = first ? i : (i < n ? values_in[i] : 0);
  }
  __syncthreads();
  // each key's rank among the warp's earlier keys of its digit
  const unsigned lower = (1u << lane) - 1u;
  unsigned* wc = s.warp_count[warp];
  int rank[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool in = wbase + j * 32 + lane < n;
    const unsigned d = (k[j] >> shift) & (RADIX - 1);
    const unsigned peers = match_digit(d, in);
    const int leader = __ffs(peers) - 1;
    unsigned seen = 0;
    if (in && lane == leader) {
      seen = wc[d];
      wc[d] = seen + __popc(peers);
    }
    seen = __shfl_sync(FULL, seen, leader & 31);
    rank[j] = seen + __popc(peers & lower);
    __syncwarp();
  }
  __syncthreads();
  // thread d: the warps' exclusive starts and the tile's count of digit d
  const int d = tid;
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < SORT_WARPS; ++w) {
    const unsigned c = s.warp_count[w][d];
    s.warp_count[w][d] = count;
    count += c;
  }
  const unsigned tag = (unsigned)pass << TAG_SHIFT;
  unsigned* word = state + PASS_LOOKBACK + tile * RADIX + d;
  unsigned prefix = 0;  // digit d's keys in the earlier tiles
#ifndef E3D_OFFSETS_NOLOOKBACK
  store_volatile(word, (tile == 0 ? INCLUSIVE : AGGREGATE) | tag | count);
  // with few keys a thread (short sorts) the look-back starts at once;
  // with many it waits for the keys' staging, and its reads overlap those
  // of the Gaussians
  if (EARLY && tile > 0) {
    prefix = look_back<WINDOW>(state + PASS_LOOKBACK, tile, d, pass);
    store_volatile(word, INCLUSIVE | tag | (prefix + count));
  }
#endif
  int local;
  cub::BlockScan<int, SORT_THREADS>(s.scan).ExclusiveSum((int)count, local);
  s.local_start[d] = local;
  __syncthreads();
  // the keys in block order, each digit's run contiguous; then their
  // Gaussians
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (wbase + j * 32 + lane < n) {
      const unsigned dj = (k[j] >> shift) & (RADIX - 1);
      rank[j] += s.local_start[dj] + (int)wc[dj];
      s.keys[rank[j]] = k[j];
    }
  }
  if constexpr (!EARLY) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = wbase + j * 32 + lane;
      v[j] = first ? i : (i < n ? values_in[i] : 0);
    }
#ifndef E3D_OFFSETS_NOLOOKBACK
    if (tile > 0) {
      prefix = look_back<WINDOW>(state + PASS_LOOKBACK, tile, d, pass);
      store_volatile(word, INCLUSIVE | tag | (prefix + count));
    }
#endif
  }
  s.shift[d] = (int)(start + prefix) - local;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (wbase + j * 32 + lane < n) s.values[rank[j]] = v[j];
  }
  __syncthreads();
  // a thread's stores (and, in the last pass, its count reads) side by side
  const int valid = min(TILE, n - tile * TILE);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int r = tid + j * SORT_THREADS;
    if (r >= valid) break;
    const unsigned kr = s.keys[r];
    const int vr = s.values[r];
#ifdef E3D_OFFSETS_NOLOOKBACK
    // runs of unwritten keys need not fit the digit counts: kept in range
    const int pos = min(s.shift[(kr >> shift) & (RADIX - 1)] + r, n - 1);
#else
    const int pos = s.shift[(kr >> shift) & (RADIX - 1)] + r;
#endif
    if (last) {
      order[pos] = vr;
#if defined(E3D_OFFSETS_NOGATHER)
      counts[pos] = __ldg(count_in + pos);
#elif defined(E3D_OFFSETS_NOLOOKBACK)
      // the tiles' runs overlap here and the order holds unwritten words
      counts[pos] = __ldg(count_in + min((unsigned)vr, (unsigned)n - 1u));
#else
      counts[pos] = __ldg(count_in + vr);
#endif
    } else {
      keys_out[pos] = kr;
      values_out[pos] = vr;
    }
  }
}

using OffsetsScan =
    cub::BlockScan<int, OFFSETS_THREADS, cub::BLOCK_SCAN_WARP_SCANS>;

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long value) {
  *reinterpret_cast<volatile unsigned long long*>(word) = value;
}

// The running instance offsets of the counts in depth order: one pass of
// OFFSETS_TILE ranks a block; block b publishes its tile's sum and then
// its inclusive prefix in its look-back word, and finds its prefix by
// reading the earlier tiles' words, 32 at a time.
__global__ void __launch_bounds__(OFFSETS_THREADS)
depth_offsets_kernel(const int* __restrict__ counts,  // [n] in depth order
                     int n, int segments, unsigned* state,
                     int region_words,  // the passes' look-back words
                     int used_words,    // of which the sort used these
                     int* __restrict__ offsets,       // [n + 1]
                     int* __restrict__ seg_rank) {    // [segments]
  __shared__ OffsetsScan::TempStorage scan;
  __shared__ int s_offsets[OFFSETS_TILE];
  __shared__ int s_prefix, s_last;
  unsigned long long* lookback = reinterpret_cast<unsigned long long*>(
      state + PASS_LOOKBACK + region_words);
  const int tid = threadIdx.x;
  // blocks start in index order (as the passes' look-back assumes)
  const int tile = blockIdx.x;
  // the sort is done with its words: a slice a block
#ifndef E3D_OFFSETS_NOCLEAR
  for (int w = STARTS + blockIdx.x * OFFSETS_THREADS + tid;
       w < PASS_LOOKBACK + used_words; w += gridDim.x * OFFSETS_THREADS) {
    state[w] = 0;
  }
#endif
  const int first = tile * OFFSETS_TILE + tid * OFFSETS_ITEMS;
  int count[OFFSETS_ITEMS], excl[OFFSETS_ITEMS];
  if (first + OFFSETS_ITEMS <= n) {  // 32-byte aligned: two 16-byte loads
    const int4* src = reinterpret_cast<const int4*>(counts + first);
    const int4 a = src[0], b = src[1];
    count[0] = a.x; count[1] = a.y; count[2] = a.z; count[3] = a.w;
    count[4] = b.x; count[5] = b.y; count[6] = b.z; count[7] = b.w;
  } else {
#pragma unroll
    for (int q = 0; q < OFFSETS_ITEMS; ++q) {
      count[q] = first + q < n ? counts[first + q] : 0;
    }
  }
  int sum;
  OffsetsScan(scan).ExclusiveSum(count, excl, sum);
  if (tid < 32) {
    const int lane = tid;
    int prefix = 0;
#ifndef E3D_OFFSETS_NOLOOKBACK
    if (tile > 0) {
      if (lane == 0) publish(lookback + tile, HAS_SUM | (unsigned)sum);
      for (int hi = tile - 1; hi >= 0; hi -= 32) {
        const int k = hi - lane;  // lane 0: the nearest earlier tile
        unsigned long long w = HAS_PREFIX;  // past tile 0: a prefix of 0
        if (k >= 0) {
          long long spins = 0;
          while (((w = *reinterpret_cast<volatile unsigned long long*>(
                       lookback + k)) >> 32) == 0) {
            if (++spins > SPIN_LIMIT) __trap();
          }
        }
        const unsigned has_prefix =
            __ballot_sync(FULL, (w & HAS_PREFIX) != 0);
        // the words of the tiles after the nearest prefix, and that prefix
        const int stop = has_prefix ? __ffs(has_prefix) - 1 : 31;
        int v = lane <= stop ? (int)(unsigned)w : 0;
#pragma unroll
        for (int dd = 16; dd > 0; dd >>= 1) v += __shfl_xor_sync(FULL, v, dd);
        prefix += v;
        if (has_prefix) break;
      }
    }
    if (lane == 0) publish(lookback + tile, HAS_PREFIX | (unsigned)(prefix + sum));
#endif
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const int prefix = s_prefix;
  if (tile == 0 && tid == 0) offsets[0] = 0;
#pragma unroll
  for (int q = 0; q < OFFSETS_ITEMS; ++q) {
    const int e = prefix + excl[q];  // the rank's slots are [e, e + count)
    s_offsets[tid * OFFSETS_ITEMS + q] = e + count[q];
    if (first + q >= n) continue;
    // the rank of each segment's first slot, for the expansion's blocks
#ifdef E3D_OFFSETS_NOLOOKBACK
    // the sort's counts hold unwritten words here: e may be anything
    for (int sg = max((e + SEGMENT - 1) / SEGMENT, 0);
#else
    for (int sg = (e + SEGMENT - 1) / SEGMENT;
#endif
         sg < segments && sg * SEGMENT < e + count[q]; ++sg) {
      seg_rank[sg] = first + q;
    }
  }
  __syncthreads();
  // the offsets, a warp's 32 stores contiguous
  const int tile_first = tile * OFFSETS_TILE;
  for (int r = tid; r < OFFSETS_TILE && tile_first + r < n;
       r += OFFSETS_THREADS) {
    offsets[tile_first + r + 1] = s_offsets[r];
  }
  // the last block to finish clears the look-back words, every thread a
  // share
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(state + OFFSETS_DONE, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  for (int b = tid; b < (int)gridDim.x; b += OFFSETS_THREADS) lookback[b] = 0;
  if (tid == 0) state[OFFSETS_DONE] = 0;
}

// The passes' tile: SORT_TILE keys from SORT_LARGE on, else
// SORT_TILE_SMALL; the state holds look-back words for the smaller.
int sort_tile(int n) { return n >= SORT_LARGE ? SORT_TILE : SORT_TILE_SMALL; }

int tiles_of(int n, int tile) { return (n + tile - 1) / tile; }

// The SMs of the current device; once (a function-local static is
// initialised once).
int multiprocessors() {
  static const int sms = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      return 1;
    }
    return count;
  }();
  return sms;
}

}  // namespace

// The sort: order_out [n] the Gaussians in depth order, counts_out [n]
// their instance counts (count, [n] int32, in Gaussian order) in that
// order; keys and values: [2, n] uint32 and int32 scratch; state as
// ops/binning.py `lookback_words(n)` sizes it, cleared.
extern "C" int e3d_depth_sort(const float* key, const int* count, int n,
                              void* state, void* keys, void* values,
                              int* order_out, int* counts_out,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n > (int)VALUE) return (int)cudaErrorInvalidValue;
  unsigned* st = static_cast<unsigned*>(state);
  const int tile = sort_tile(n), tiles = tiles_of(n, tile);
  const int hist_blocks = min(tiles_of(n, HIST_TILE),
                              HIST_BLOCKS_PER_SM * multiprocessors());
  radix_histogram_kernel<<<hist_blocks, HIST_THREADS, 0, stream>>>(
      key, n, st, tiles * RADIX);
  cudaError_t err = cudaGetLastError();
  unsigned* k = static_cast<unsigned*>(keys);
  int* v = static_cast<int*>(values);
  for (int p = 0; p < PASSES && err == cudaSuccess; ++p) {
    if (tile == SORT_TILE) {
      radix_pass_kernel<SORT_ITEMS, LOOKBACK_WINDOW>
          <<<tiles, SORT_THREADS, 0, stream>>>(key, k, k + n, v, v + n, count,
                                               n, p, st, order_out,
                                               counts_out);
    } else {
      radix_pass_kernel<SORT_ITEMS_SMALL, LOOKBACK_WINDOW_SMALL>
          <<<tiles, SORT_THREADS, 0, stream>>>(key, k, k + n, v, v + n, count,
                                               n, p, st, order_out,
                                               counts_out);
    }
    err = cudaGetLastError();
  }
  return (int)err;
}

// The offsets [n + 1] and, for the live segments of [0, segments), the
// rank holding each segment's first slot, from the counts in depth order
// (e3d_depth_sort's); state as e3d_depth_sort leaves it.
extern "C" int e3d_depth_offsets(const int* counts, int n, int segments,
                                 void* state, int* offsets_out,
                                 int* seg_rank_out, cudaStream_t stream) {
  const int blocks = n > OFFSETS_TILE ? tiles_of(n, OFFSETS_TILE) : 1;
  depth_offsets_kernel<<<blocks, OFFSETS_THREADS, 0, stream>>>(
      counts, n, segments, static_cast<unsigned*>(state),
      tiles_of(n, SORT_TILE_SMALL) * RADIX,
      n > 0 ? tiles_of(n, sort_tile(n)) * RADIX : 0, offsets_out,
      seg_rank_out);
  return (int)cudaGetLastError();
}
