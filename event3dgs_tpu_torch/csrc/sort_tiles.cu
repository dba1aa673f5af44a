// Counting sort of instances by tile id: kernels K5 (tile histogram) and K6
// (stable in-tile rank), as one count -> scan -> rank pass that also writes
// the tile lists.
//
// Replaces the TPU kernels `_hist_kernel_factory` and `_rank_kernel_factory`
// of event3dgs_tpu/ops/sort_tiles.py (the two halves of
// `counting_sort_buckets` there) and, in the fused entry, the glue that
// event3dgs_tpu/ops/binning.py runs around them (the offsets' prefix sum,
// the scatter of the Gaussians into the tile lists).
//
// Semantics.  Ids are tile ids; an id outside [0, n_bins), or at an index
// >= n_live, is a sentinel (n_live is read on the device, so the host never
// waits for it).  For each real id
//     dest[i] = offsets[id] + #{j < i : ids[j] == id},
// and sentinels get drop_dest.  counts are the real ids per tile and, in the
// fused entry, offsets their exclusive prefix; the fused entry also writes
// inst[dest[i]] = gauss[i] for each real id, `fill` into every other slot
// of [0, n_ids), and overflow = max(n_live - n_ids, 0).
//
// Bound: bytes.  Each live id read once, gauss read once per real id, dest
// and inst written once per slot, counts and offsets once per tile: 8 bytes
// per slot of the instance cap and at most 8 per live id, 1.7 us at the
// train view (cap 428,032, 285k live ids) and 2.6 us at the render view
// (cap 800,768) at 3.35 TB/s.
//
// Design: three launches over segments of SEGMENT ids (csrc/segment.cuh).
// On the binning path the expansion kernel (csrc/expand.cu) writes the
// count rows of step 1 as it writes the ids, and the fused entry runs
// steps 2 and 3 only (`counted`).
//   1. segment_count_kernel: one block per segment loads it (SEGMENT /
//      COUNT_THREADS independent coalesced loads a thread, all in flight
//      before the first use) and counts it per tile with shared-memory
//      atomicAdd (integer atomics only form a count, whose value does not
//      depend on their order), then writes the segment's count row.
//      Segments past n_live exit.
//   2. scan_kernel: per tile (32 tiles x 32 groups of segments a block), the
//      exclusive prefix of the count rows over the segments, in place, and
//      the column total: the tile's count (K5's histogram).
//   3. rank_kernel: one block per segment.  Each thread loads its run of
//      ITEMS consecutive ids with 16-byte loads, and the segment's Gaussians
//      are staged in shared memory with 16-byte loads, so no later step
//      waits on a global load.  Meanwhile the block builds, in shared
//      memory, each tile's first slot for this segment: the tile's offset
//      (the exclusive prefix of counts over the tiles, recomputed by every
//      block from the 4 * n_bins bytes of counts; block 0 writes it out as
//      the offsets) plus the segment's prefix row from step 2.  CUB's
//      BlockRadixSort then sorts the segment's items, each one word
//      (tile << INDEX_BITS | index), over only the bits the tile ids use;
//      it is stable and decides no order by atomics.  In the sorted
//      segment the items of a tile are consecutive and in index order, so
//      an item's rank among its tile's earlier ids in the segment is its
//      sorted position less that of the tile's first item: the thread
//      holding each run's head subtracts the head's position from the
//      tile's first slot (one writer per tile).
//      The sort leaves the items striped (item k of thread t at sorted
//      position k * RANK_THREADS + t), so a warp's stores of the Gaussians
//      into the lists fall on consecutive slots; dest goes through shared
//      memory by index and out with 16-byte stores.  The block also fills
//      its part of the lists' tail [live total, n_ids).
// No unordered atomic decides a rank, so the order is stable and a rerun
// repeats bit for bit.
//
// Against the earlier design (per 1,024-id segment a full count row, a scan,
// then a one-warp block per segment whose 32 rounds each waited on a global
// load and ranked with __match_any_sync; a separate histogram with a memset
// and global atomics; ten PyTorch kernels of glue: the offsets' cumsum,
// casts, the lists' fill and scatter, the overflow's clamp): the histogram
// is the scan's column totals, the ranking reads its segment once and ranks
// it in registers and shared memory with a block sort in place of 32 rounds
// of warp matches, its stores are coalesced, the scratch rows are 2,048 ids
// apart (half as many), and the tile lists need no further kernel.
//
// Shared memory: the count kernel 4 * n_bins bytes; the rank kernel its
// static RankShared (at most RANK_STATIC_LIMIT bytes) and 4 * n_bins bytes
// of tile slots.  The opt-in limit above 48 KB is set once per kernel.  The
// caller's launch plan (ops/sort_tiles.py `sort_plan`) mirrors both.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "segment.cuh"  // SEGMENT: ids per block of the count and rank kernels

namespace {

constexpr int COUNT_THREADS = 256;  // SEGMENT / COUNT_THREADS ids per thread
constexpr int RANK_THREADS = 256;   // ITEMS ids per thread
constexpr int ITEMS = SEGMENT / RANK_THREADS;
constexpr int RADIX_BITS = 4;       // key bits per pass of the rank block's sort
constexpr int RANK_WARPS = RANK_THREADS / 32;
constexpr int TILE_ITEMS = 8;       // tiles per rank thread in one pass of tiles
constexpr int CHUNK_TILES = TILE_ITEMS * RANK_THREADS;
constexpr int RANK_STATIC_LIMIT = 48 * 1024;  // bytes of RankShared, at most
constexpr int SCAN_TILES = 32;      // tiles per scan block (threadIdx.x)
constexpr int SCAN_GROUPS = 32;     // segment groups per scan block (threadIdx.y)
static_assert(ITEMS % 4 == 0, "a rank thread loads its ids as int4");
static_assert(SEGMENT / 4 % RANK_THREADS == 0, "int4 copies of a segment");
constexpr int VECS = SEGMENT / 4 / RANK_THREADS;  // int4 per thread a segment
constexpr unsigned FULL = 0xffffffffu;
// a rank item is (tile << INDEX_BITS) | index in the segment: the sort moves
// one word per item and sorts only the tile's bits
constexpr int INDEX_BITS = 11;
static_assert(SEGMENT == 1 << INDEX_BITS, "an index fits INDEX_BITS");

using RankSort = cub::BlockRadixSort<unsigned, RANK_THREADS, ITEMS,
                                     cub::NullType, RADIX_BITS>;
using RankScan = cub::BlockScan<int, RANK_THREADS>;

struct RankShared {
  union {
    RankSort::TempStorage sort;
    RankScan::TempStorage scan;
    alignas(16) int xch[SEGMENT];  // dest by index
  } u;                             // the scan's, the sort's, then xch
  alignas(16) int gauss[SEGMENT];  // the segment's Gaussians, by index
  unsigned warp_last[ITEMS][RANK_WARPS];  // each warp's last sorted tiles
};
static_assert(sizeof(RankShared) <= RANK_STATIC_LIMIT,
              "the launch plan counts at most RANK_STATIC_LIMIT static bytes");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the id at index i as the kernels see it: a tile in [0, n_bins), or the
// sentinel n_bins for anything else and for every index past the live count
__device__ __forceinline__ int as_tile(int id, int i, int n_live, int n_bins) {
  return (i < n_live && id >= 0 && id < n_bins) ? id : n_bins;
}

// 1. per-segment tile counts -> base[seg * n_bins + tile]
__global__ void __launch_bounds__(COUNT_THREADS)
segment_count_kernel(const int* __restrict__ ids, int n_ids,
                     const int* __restrict__ n_live_ptr, int n_bins,
                     int* __restrict__ base) {
  extern __shared__ int bins[];
  constexpr int PER_THREAD = SEGMENT / COUNT_THREADS;
  const int start = blockIdx.x * SEGMENT;
  // the ids are loaded beside the live count, not after it
  int id[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = start + k * COUNT_THREADS + threadIdx.x;
    id[k] = i < n_ids ? ids[i] : n_bins;
  }
  const int n_live = min(*n_live_ptr, n_ids);
  if (start >= n_live) return;  // the scan reads live segments only
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    id[k] = as_tile(id[k], start + k * COUNT_THREADS + threadIdx.x, n_live,
                    n_bins);
  }
  for (int b = threadIdx.x; b < n_bins; b += COUNT_THREADS) bins[b] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    if (id[k] < n_bins) atomicAdd(&bins[id[k]], 1);
  }
  __syncthreads();
  int* row = base + (size_t)blockIdx.x * n_bins;
  for (int b = threadIdx.x; b < n_bins; b += COUNT_THREADS) row[b] = bins[b];
}

// 2. in place: base[seg][t] = sum of the counts of segments < seg; the
// column total into counts[t] (when counts is given).  Block (SCAN_TILES x
// SCAN_GROUPS): x = tile, y = a contiguous group of segments; each thread
// sums its group, one row of threads scans the group sums, then each thread
// rewrites its group as exclusive prefixes.  (Keeping a group's counts in
// registers between the two passes measured slower on the H100: PERF.md.)
__global__ void __launch_bounds__(SCAN_TILES * SCAN_GROUPS)
scan_kernel(const int* __restrict__ n_live_ptr, int n_ids, int n_bins,
            int* __restrict__ base, int* __restrict__ counts) {
  __shared__ int group_sum[SCAN_GROUPS][SCAN_TILES];
  const int t = blockIdx.x * SCAN_TILES + threadIdx.x;
  const int n_live = max(min(*n_live_ptr, n_ids), 0);
  const int n_seg = (n_live + SEGMENT - 1) / SEGMENT;
  const int per_group = (n_seg + SCAN_GROUPS - 1) / SCAN_GROUPS;
  const int s0 = threadIdx.y * per_group;
  const int s1 = min(s0 + per_group, n_seg);
  int sum = 0;
  if (t < n_bins) {
#pragma unroll 4
    for (int s = s0; s < s1; ++s) sum += base[(size_t)s * n_bins + t];
  }
  group_sum[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0) {
    int acc = 0;
#pragma unroll
    for (int g = 0; g < SCAN_GROUPS; ++g) {
      const int v = group_sum[g][threadIdx.x];
      group_sum[g][threadIdx.x] = acc;
      acc += v;
    }
    if (t < n_bins && counts != nullptr) counts[t] = acc;
  }
  __syncthreads();
  if (t < n_bins) {
    int acc = group_sum[threadIdx.y][threadIdx.x];
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      const size_t idx = (size_t)s * n_bins + t;
      const int v = base[idx];
      base[idx] = acc;
      acc += v;
    }
  }
}

// tiles [c0 + tid * TILE_ITEMS, + TILE_ITEMS) of a (0 past n_bins, or
// where a is not given)
__device__ __forceinline__ void load_tiles(const int* __restrict__ a, int c0,
                                           int n_bins,
                                           int (&out)[TILE_ITEMS]) {
  const int t0 = c0 + threadIdx.x * TILE_ITEMS;
#pragma unroll
  for (int k = 0; k < TILE_ITEMS; ++k) {
    out[k] = a != nullptr && t0 + k < n_bins ? __ldg(a + t0 + k) : 0;
  }
}

// slot[t] = tile t's first slot for this segment: its offset (offsets_in,
// or the exclusive prefix of counts over the tiles, which is also written
// to offsets_out when that is given) plus the segment's prefix row (when
// given).  The tiles go in chunks of CHUNK_TILES, TILE_ITEMS consecutive
// ones a thread; cnt and rw hold this thread's tiles of the first chunk of
// (offsets_in or counts) and row, loaded by the caller.  Returns the sum of
// counts (0 with offsets_in).  Every thread of the block calls it; the
// caller synchronises before reading slot.
__device__ int tile_slots(int* slot, RankShared& sh, int n_bins,
                          const int* __restrict__ row,
                          const int* __restrict__ offsets_in,
                          const int* __restrict__ counts,
                          int* __restrict__ offsets_out,
                          int (&cnt)[TILE_ITEMS], int (&rw)[TILE_ITEMS]) {
  int carry = 0;
  for (int c0 = 0;;) {
    int off[TILE_ITEMS];
    if (offsets_in != nullptr) {
#pragma unroll
      for (int k = 0; k < TILE_ITEMS; ++k) off[k] = cnt[k];
    } else {
      int chunk;
      RankScan(sh.u.scan).ExclusiveSum(cnt, off, chunk);
#pragma unroll
      for (int k = 0; k < TILE_ITEMS; ++k) off[k] += carry;
      carry += chunk;
    }
    const int t0 = c0 + threadIdx.x * TILE_ITEMS;
#pragma unroll
    for (int k = 0; k < TILE_ITEMS; ++k) {
      if (t0 + k < n_bins) {
        if (offsets_out != nullptr) offsets_out[t0 + k] = off[k];
        slot[t0 + k] = off[k] + rw[k];
      }
    }
    c0 += CHUNK_TILES;
    if (c0 >= n_bins) return carry;
    __syncthreads();  // the scan's storage is used again
    load_tiles(offsets_in != nullptr ? offsets_in : counts, c0, n_bins, cnt);
    load_tiles(row, c0, n_bins, rw);
  }
}

// 3. one block per segment: stable destinations and, when inst is given,
// the tile lists.  The offsets are offsets_in when given, else computed from
// counts (block 0 writes them to offsets_out).  bits: the bits of n_bins,
// the sort's key width.
__global__ void __launch_bounds__(RANK_THREADS)
rank_kernel(const int* __restrict__ ids, const int* __restrict__ gauss,
            int n_ids, const int* __restrict__ n_live_ptr, int n_bins,
            int bits, const int* __restrict__ base,
            const int* __restrict__ offsets_in,
            const int* __restrict__ counts, int* __restrict__ offsets_out,
            int drop_dest, int fill, int* __restrict__ dest,
            int* __restrict__ inst, int* __restrict__ overflow) {
  __shared__ RankShared sh;
  extern __shared__ int slot[];  // [n_bins]
  const int tid = threadIdx.x;
  const int start = blockIdx.x * SEGMENT;
  const int len = max(min(SEGMENT, n_ids - start), 0);
  // blocked: thread tid holds the segment's indices tid*ITEMS + k, loaded
  // beside the live count
  const int first = start + tid * ITEMS;
  int v[ITEMS];
  if (first + ITEMS <= n_ids && aligned16(ids + first)) {
    const int4* src = reinterpret_cast<const int4*>(ids + first);
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q) {
      const int4 w = __ldg(src + q);
      v[4 * q] = w.x;
      v[4 * q + 1] = w.y;
      v[4 * q + 2] = w.z;
      v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      v[k] = first + k < n_ids ? ids[first + k] : n_bins;
    }
  }
  const int raw_live = *n_live_ptr;
  const int n_live = max(min(raw_live, n_ids), 0);
  const bool live = start < n_live;
  if (blockIdx.x == 0 && tid == 0 && overflow != nullptr) {
    *overflow = max(raw_live - n_ids, 0);
  }

  // every other global load of the block is issued before the first use
  const bool slots = live || (blockIdx.x == 0 && offsets_out != nullptr);
  const int* row = live ? base + (size_t)blockIdx.x * n_bins : nullptr;
  int cnt[TILE_ITEMS], rw[TILE_ITEMS];
  if (slots) {
    load_tiles(offsets_in != nullptr ? offsets_in : counts, 0, n_bins, cnt);
    load_tiles(row, 0, n_bins, rw);
  }
  const bool whole = len == SEGMENT && aligned16(gauss + start);
  int4 g[VECS];
  if (live && inst != nullptr && whole) {
    const int4* src = reinterpret_cast<const int4*>(gauss + start);
#pragma unroll
    for (int q = 0; q < VECS; ++q) g[q] = __ldg(src + q * RANK_THREADS + tid);
  }

  unsigned key[ITEMS];
  if (live) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      key[k] = (unsigned)as_tile(v[k], first + k, n_live, n_bins) << INDEX_BITS
               | (tid * ITEMS + k);
    }
    if (inst != nullptr && whole) {
      int4* dst = reinterpret_cast<int4*>(sh.gauss);
#pragma unroll
      for (int q = 0; q < VECS; ++q) dst[q * RANK_THREADS + tid] = g[q];
    } else if (inst != nullptr) {
      for (int j = tid; j < len; j += RANK_THREADS) {
        sh.gauss[j] = gauss[start + j];
      }
    }
  }
  int total = 0;  // the live total, where the lists end
  if (slots) {
    total = tile_slots(slot, sh, n_bins, row, offsets_in, counts,
                       blockIdx.x == 0 ? offsets_out : nullptr, cnt, rw);
  }

  if (live) {
    __syncthreads();  // slots and Gaussians in place, the scan's storage free
    RankSort(sh.u.sort).SortBlockedToStriped(key, INDEX_BITS,
                                             INDEX_BITS + bits);
    unsigned tile[ITEMS];
    int idx[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      tile[k] = key[k] >> INDEX_BITS;
      idx[k] = key[k] & (SEGMENT - 1);
    }
    // item k of this thread now sits at sorted position k*RANK_THREADS+tid;
    // the item before it is lane-1's item k, or for lane 0 the previous
    // warp's last item k (warp 0: the last warp's item k-1)
    const int lane = tid & 31, warp = tid >> 5;
    if (lane == 31) {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) sh.warp_last[k][warp] = tile[k];
    }
    __syncthreads();  // also frees the sort's storage for xch
    // a run's head makes its tile's slot relative to the sorted position
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      unsigned prev = __shfl_up_sync(FULL, tile[k], 1);
      if (lane == 0) {
        prev = warp > 0 ? sh.warp_last[k][warp - 1]
               : k > 0  ? sh.warp_last[k - 1][RANK_WARPS - 1]
                        : ~0u;
      }
      if ((int)tile[k] < n_bins && tile[k] != prev) {
        slot[tile[k]] -= k * RANK_THREADS + tid;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      int d = drop_dest;
      if ((int)tile[k] < n_bins) {
        d = slot[tile[k]] + k * RANK_THREADS + tid;
        if (inst != nullptr) inst[d] = sh.gauss[idx[k]];
      }
      sh.u.xch[idx[k]] = d;  // padding past n_ids lands past len, unread
    }
    __syncthreads();
    if (len == SEGMENT && aligned16(dest + start)) {
      const int4* src = reinterpret_cast<const int4*>(sh.u.xch);
      int4* dst = reinterpret_cast<int4*>(dest + start);
#pragma unroll
      for (int q = 0; q < VECS; ++q) {
        dst[q * RANK_THREADS + tid] = src[q * RANK_THREADS + tid];
      }
    } else {
      for (int j = tid; j < len; j += RANK_THREADS) {
        dest[start + j] = sh.u.xch[j];
      }
    }
  } else {
    for (int j = tid; j < len; j += RANK_THREADS) dest[start + j] = drop_dest;
  }
  if (inst != nullptr) {
    // a block past the live ids fills its whole range, which lies past the
    // live total
    for (int i = max(start, live ? total : 0) + tid; i < start + len;
         i += RANK_THREADS) {
      inst[i] = fill;
    }
  }
}

// Let the count and rank kernels use the card's opt-in shared memory; once
// (a function-local static is initialised once).
cudaError_t allow_shared_once() {
  static const cudaError_t err = [] {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute((const void*)segment_count_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    }
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, rank_kernel);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        (const void*)rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin - (int)attr.sharedSizeBytes);
  }();
  return err;
}

int segments(int n_ids) {
  return n_ids > SEGMENT ? (n_ids + SEGMENT - 1) / SEGMENT : 1;
}

// launch 2: the count rows' prefixes in place and (if given) counts
cudaError_t scan(int n_ids, const int* n_live, int n_bins, int* base,
                 int* counts, cudaStream_t stream) {
  const int scan_blocks = (n_bins + SCAN_TILES - 1) / SCAN_TILES;
  scan_kernel<<<scan_blocks, dim3(SCAN_TILES, SCAN_GROUPS), 0, stream>>>(
      n_live, n_ids, n_bins, base, counts);
  return cudaGetLastError();
}

// launches 1 and 2: count rows into base, their prefixes and (if given)
// counts
cudaError_t count_and_scan(const int* ids, int n_ids, const int* n_live,
                           int n_bins, int* base, int* counts,
                           cudaStream_t stream) {
  cudaError_t err = allow_shared_once();
  if (err != cudaSuccess) return err;
  segment_count_kernel<<<segments(n_ids), COUNT_THREADS, sizeof(int) * n_bins,
                         stream>>>(ids, n_ids, n_live, n_bins, base);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return scan(n_ids, n_live, n_bins, base, counts, stream);
}

// launch 3
cudaError_t rank(const int* ids, const int* gauss, int n_ids,
                 const int* n_live, int n_bins, const int* base,
                 const int* offsets_in, const int* counts, int* offsets_out,
                 int drop_dest, int fill, int* dest, int* inst, int* overflow,
                 cudaStream_t stream) {
  int bits = 1;
  while ((n_bins >> bits) != 0) ++bits;  // the sentinel n_bins fits
  if (INDEX_BITS + bits > 32) return cudaErrorInvalidValue;
  rank_kernel<<<segments(n_ids), RANK_THREADS, sizeof(int) * n_bins, stream>>>(
      ids, gauss, n_ids, n_live, n_bins, bits, base, offsets_in, counts,
      offsets_out, drop_dest, fill, dest, inst, overflow);
  return cudaGetLastError();
}

}  // namespace

// K5: counts[t] = real ids of tile t.  base: scratch of
// max(ceil(n_ids / SEGMENT), 1) * n_bins ints.
extern "C" int e3d_tile_histogram(const int* ids, int n_ids, const int* n_live,
                                  int n_bins, int* base, int* counts,
                                  cudaStream_t stream) {
  return (int)count_and_scan(ids, n_ids, n_live, n_bins, base, counts, stream);
}

// K6: stable destinations against the given offsets
extern "C" int e3d_stable_tile_rank(const int* ids, int n_ids,
                                    const int* n_live, int n_bins,
                                    const int* offsets, int drop_dest,
                                    int* base, int* dest,
                                    cudaStream_t stream) {
  cudaError_t err = count_and_scan(ids, n_ids, n_live, n_bins, base, nullptr,
                                   stream);
  if (err != cudaSuccess) return (int)err;
  return (int)rank(ids, nullptr, n_ids, n_live, n_bins, base, offsets, nullptr,
                   nullptr, drop_dest, 0, dest, nullptr, nullptr, stream);
}

// K5 and K6 fused: counts, offsets, destinations (drop slot n_ids), the
// tile lists inst (fill past the live total) and the overflow.  counted:
// base already holds the live segments' count rows (the expansion kernel
// writes them, csrc/expand.cu), so the count kernel does not run.
extern "C" int e3d_counting_sort(const int* ids, const int* gauss, int n_ids,
                                 const int* n_live, int n_bins, int fill,
                                 int counted, int* base, int* counts,
                                 int* offsets, int* dest, int* inst,
                                 int* overflow, cudaStream_t stream) {
  cudaError_t err = allow_shared_once();  // the rank kernel's, too
  if (err != cudaSuccess) return (int)err;
  err = counted ? scan(n_ids, n_live, n_bins, base, counts, stream)
                : count_and_scan(ids, n_ids, n_live, n_bins, base, counts,
                                 stream);
  if (err != cudaSuccess) return (int)err;
  return (int)rank(ids, gauss, n_ids, n_live, n_bins, base, nullptr, counts,
                   offsets, n_ids, fill, dest, inst, overflow, stream);
}
