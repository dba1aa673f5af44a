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
// One thread per (segment, column), adding the segment's rows in expansion
// order from 0.0f.  No atomics: every output element has one writer and one
// fixed order of additions, so the sums repeat bit for bit and equal the
// plain PyTorch version (which adds in the same order).  A segment's error
// is eps·|segment| where the TPU scan's was eps·|prefix|.
//
// Bound: bytes — each live row
// is read once, plus the index arrays and the output; the adds are few.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

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
  const int s = min(max(starts[seg], 0), limit);
  const int e = max(min(max(ends[seg], 0), limit), s);
  float acc = 0.0f;
  for (int i = s; i < e; ++i) {
    const int r = dest[i];
    if (r >= 0 && r < n_rows) acc += rows[(size_t)r * width + col];
  }
  out[(size_t)order[seg] * width + col] = acc;
}

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
