// Per-Gaussian gradient sums from per-instance rows (kernel K3).
//
// Replaces the TPU kernel `_scan_kernel` of event3dgs_tpu/ops/segscan.py
// (an exclusive row prefix scan, launched by `_build_scan` there) together
// with the two boundary gathers, the subtraction and the un-ranking scatter
// that `segment_sums_from_ranges` and the rasterizer's backward wrap around
// it.  Here the per-segment sums are taken directly:
//
//   out[order[s], c] = sum over e in [starts[s], ends[s]) ∩ [0, limit)
//                      of rows[dest[e], c]      (0 where dest[e] >= n_rows)
//
// Each segment's sum runs in expansion order from 0.0f with one writer and
// no atomics, so the sums repeat bit for bit and equal the plain PyTorch
// version (which adds in the same order).  A segment's error is
// eps·|segment| where the TPU scan's was eps·|prefix|.  `order` is a
// permutation of the segments, as the binning's is.
//
// Bound: bytes — each live row is read once, plus the index arrays and the
// output; the adds are few.  On the rasterizer's path the rows lie in tile
// order and are read in expansion order, a random 36-byte read each.
//
// Two orders of work; the wrapper (ops/segscan.py) picks one by size.
// - In rank order (e3d_segment_sums), one thread per (segment, column):
//   segment s's starts, ends and `dest` entries are read coalesced, and its
//   9 column threads write its 36-byte row with one store, at the random
//   place order[s].  Where the [N, 9] sums outgrow the L2 (75 MB at 2M
//   Gaussians against the H100's 50 MB), such a row leaves its two 32-byte
//   sectors part-written, and the memory reads each back and merges it.
// - In output order (e3d_segment_sums_by_output, rows of 9 floats), two
//   launches.  ranges_kernel, one thread per segment, reads starts[s],
//   ends[s] and order[s] coalesced and writes the clipped range to
//   range[order[s]]: 8 bytes into a table of 17 MB at 2M, cleared first so
//   that its sectors sit whole in the L2 and each write merges there.  Then
//   row_sums_kernel, one owner thread per output row: it reads its range
//   coalesced, adds its rows in expansion order, UNROLL rows' `dest` and
//   then their 9 floats in flight together, and the block writes its
//   contiguous output rows whole through shared memory.
//
// E3D_K3_BALANCED (timing only, tools/kernel_timing.py): one owner per
// segment in rank order with warps balanced by instances, exported as
// e3d_segment_sums_balanced.  A first launch gives warp k the segments
// whose key s + starts[s] lies in [k·ITEMS, (k+1)·ITEMS): an equal share
// of segments plus instances, so a run of long segments (near the camera,
// where the depth order puts them together) spreads over many warps and
// the tail of empty ones costs its zero rows only.  Lane l of a warp owns
// its segments l and l + 32, adds their rows straight from device memory,
// and the warp writes each of its rows to out[order[s]] with one store of
// 9 lanes.  Where the ranges do not follow one another (ends[s] !=
// starts[s + 1] after the clip) the first launch raises a flag and each
// warp takes ITEMS segments.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int W = 9;       // the rasterizer's row: output order and owners
constexpr int UNROLL = 4;  // rows of a segment in flight together

__device__ __forceinline__ int clip(int x, int limit) {
  return min(max(x, 0), limit);
}

__global__ void __launch_bounds__(THREADS)
segment_sums_kernel(const float* __restrict__ rows, int n_rows, int width,
                    const int* __restrict__ dest,
                    const int* __restrict__ starts,
                    const int* __restrict__ ends, int n_seg, int limit,
                    const int* __restrict__ order, float* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (tid >= (long long)n_seg * width) return;
  const int seg = (int)(tid / width);
  const int col = (int)(tid % width);
  const int s = clip(starts[seg], limit);
  const int e = max(clip(ends[seg], limit), s);
  float acc = 0.0f;
  for (int i = s; i < e; ++i) {
    const int r = dest[i];
    if (r >= 0 && r < n_rows) acc += rows[(size_t)r * width + col];
  }
  out[(size_t)order[seg] * width + col] = acc;
}

__global__ void __launch_bounds__(THREADS)
ranges_kernel(const int* __restrict__ starts, const int* __restrict__ ends,
              int n_seg, int limit, const int* __restrict__ order,
              int2* __restrict__ range) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= n_seg) return;
  const int lo = clip(starts[s], limit);
  const int g = order[s];
  if (g >= 0 && g < n_seg)
    range[g] = make_int2(lo, max(clip(ends[s], limit), lo));
}

// acc = the sum from 0.0f of rows[dest[e]] over e in [lo, hi), in order;
// UNROLL rows' dest and then their floats in flight together
__device__ __forceinline__ void add_rows(const float* __restrict__ rows,
                                         int n_rows,
                                         const int* __restrict__ dest, int lo,
                                         int hi, float (&acc)[W]) {
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = 0.0f;
  for (int i = lo; i < hi; i += UNROLL) {
    int r[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      r[j] = i + j < hi ? dest[i + j] : -1;
      if (r[j] >= n_rows) r[j] = -1;
    }
    float v[UNROLL][W];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
#pragma unroll
      for (int c = 0; c < W; ++c)
        v[j][c] = r[j] >= 0 ? rows[(size_t)r[j] * W + c] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (r[j] >= 0) {
#pragma unroll
        for (int c = 0; c < W; ++c) acc[c] += v[j][c];
      }
    }
  }
}

// one owner thread per output row; the block's rows leave through shared
// memory, one float per thread per store
__global__ void __launch_bounds__(THREADS)
row_sums_kernel(const float* __restrict__ rows, int n_rows,
                const int* __restrict__ dest, const int2* __restrict__ range,
                int n_seg, int limit, float* __restrict__ out) {
  __shared__ float stage[THREADS * W];
  const int g0 = blockIdx.x * THREADS;
  int lo = 0, hi = 0;
  if (g0 + (int)threadIdx.x < n_seg) {
    const int2 r = range[g0 + threadIdx.x];
    lo = clip(r.x, limit);
    hi = max(clip(r.y, limit), lo);
  }
  float acc[W];
  add_rows(rows, n_rows, dest, lo, hi, acc);
#pragma unroll
  for (int c = 0; c < W; ++c) stage[threadIdx.x * W + c] = acc[c];
  __syncthreads();
  const int n = min(THREADS, n_seg - g0) * W;
  float* dst = out + (size_t)g0 * W;
  for (int k = threadIdx.x; k < n; k += THREADS) dst[k] = stage[k];
}

#ifdef E3D_K3_BALANCED
constexpr int ITEMS = 64;  // segments + instances a warp
constexpr int WARPS = THREADS / 32;

// bound[k] = the first segment of warp k (keys grow by at least one a
// segment, so a warp owns at most ITEMS of them); the warp after the last
// owner gets n_seg.  flag = 1 where the ranges do not chain.
__global__ void __launch_bounds__(THREADS)
partition_kernel(const int* __restrict__ starts, const int* __restrict__ ends,
                 int n_seg, int limit, int* __restrict__ bound,
                 int* __restrict__ flag) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= n_seg) return;
  const int lo = clip(starts[s], limit);
  const int key = s + lo;
  int first = 0;  // the first boundary past the previous segment's key
  if (s > 0) {
    const int prev = clip(starts[s - 1], limit);
    if (max(clip(ends[s - 1], limit), prev) != lo) {
      *flag = 1;
      return;
    }
    first = (s - 1 + prev) / ITEMS + 1;
  }
  for (int k = first; k <= key / ITEMS; ++k) bound[k] = s;
  if (s == n_seg - 1) bound[key / ITEMS + 1] = n_seg;
}

__global__ void __launch_bounds__(THREADS)
balanced_sums_kernel(const float* __restrict__ rows, int n_rows,
                     const int* __restrict__ dest,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends, int n_seg, int limit,
                     const int* __restrict__ order, float* __restrict__ out,
                     const int* __restrict__ bound,
                     const int* __restrict__ flag) {
  __shared__ float stage[WARPS][32 * W];
  const int k = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  float* st = stage[threadIdx.x >> 5];
  int s0, s1;
  if (*flag == 0) {
    const int last = n_seg - 1 + clip(starts[n_seg - 1], limit);
    if ((long long)k * ITEMS > last) return;
    s0 = bound[k];
    s1 = (long long)(k + 1) * ITEMS > last ? n_seg : bound[k + 1];
  } else {
    if ((long long)k * ITEMS >= n_seg) return;
    s0 = k * ITEMS;
    s1 = min(s0 + ITEMS, n_seg);
  }
  for (int base = s0; base < s1; base += 32) {
    const int s = base + lane;
    int lo = 0, hi = 0, o = -1;
    if (s < s1) {
      lo = clip(starts[s], limit);
      hi = max(clip(ends[s], limit), lo);
      o = order[s];
    }
    float acc[W];
    add_rows(rows, n_rows, dest, lo, hi, acc);
#pragma unroll
    for (int c = 0; c < W; ++c) st[lane * W + c] = acc[c];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < W; ++j) {  // float 32j + lane of the warp's rows
      const int f = 32 * j + lane;
      const int row = __shfl_sync(0xffffffffu, o, f / W);
      if (row >= 0) out[(size_t)row * W + f % W] = st[f];
    }
    __syncwarp();
  }
}
#endif

}  // namespace

extern "C" int e3d_segment_sums(const float* rows, int n_rows, int width,
                                const int* dest, const int* starts,
                                const int* ends, int n_seg, int limit,
                                const int* order, float* out,
                                cudaStream_t stream) {
  const long long total = (long long)n_seg * width;
  if (total <= 0) return 0;
  const int blocks = (int)((total + THREADS - 1) / THREADS);
  segment_sums_kernel<<<blocks, THREADS, 0, stream>>>(
      rows, n_rows, width, dest, starts, ends, n_seg, limit, order, out);
  return (int)cudaGetLastError();
}

// rows of 9 floats; range: scratch of n_seg int2 (8-byte aligned)
extern "C" int e3d_segment_sums_by_output(const float* rows, int n_rows,
                                          const int* dest, const int* starts,
                                          const int* ends, int n_seg,
                                          int limit, const int* order,
                                          float* out, int* range,
                                          cudaStream_t stream) {
  if (n_seg <= 0) return 0;
  cudaError_t err = cudaMemsetAsync(range, 0, (size_t)n_seg * 8, stream);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_seg + THREADS - 1) / THREADS;
  int2* r = reinterpret_cast<int2*>(range);
  ranges_kernel<<<blocks, THREADS, 0, stream>>>(starts, ends, n_seg, limit,
                                                order, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_sums_kernel<<<blocks, THREADS, 0, stream>>>(rows, n_rows, dest, r,
                                                  n_seg, limit, out);
  return (int)cudaGetLastError();
}

#ifdef E3D_K3_BALANCED
// rows of 9 floats; scratch of ceil((n_seg + limit) / ITEMS) + 2 ints
extern "C" int e3d_segment_sums_balanced(const float* rows, int n_rows,
                                         const int* dest, const int* starts,
                                         const int* ends, int n_seg,
                                         int limit, const int* order,
                                         float* out, int* scratch,
                                         int scratch_len,
                                         cudaStream_t stream) {
  if (n_seg <= 0) return 0;
  const long long warps =
      ((long long)n_seg + max(limit, 0) + ITEMS - 1) / ITEMS;
  if (scratch_len < warps + 2) return (int)cudaErrorInvalidValue;
  int* flag = scratch;
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  partition_kernel<<<(n_seg + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      starts, ends, n_seg, limit, scratch + 1, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  balanced_sums_kernel<<<(int)((warps + WARPS - 1) / WARPS), THREADS, 0,
                         stream>>>(rows, n_rows, dest, starts, ends, n_seg,
                                   limit, order, out, scratch + 1, flag);
  return (int)cudaGetLastError();
}
#endif
