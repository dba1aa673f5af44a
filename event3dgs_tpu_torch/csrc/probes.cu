// A grid whose live size is read from device memory (the dynamic-grid
// probe of tools/kernel_probes.py).
//
// Replaces the TPU probe `kernel`/`run` of experiments/tools_exp_dyngrid.py,
// which asked whether a Pallas grid size may be a traced value: it
// accumulates the first n (8, 128) blocks of an f32 [800, 128] input and
// expects 3·1024, then 7·1024.  On the card the question is whether a
// kernel inside a captured CUDA graph can serve a count that changes
// between replays.  A graph fixes every launch's grid, so this kernel is
// launched at capacity (one block per (8, 128) block of the input) and
// reads n from device memory, clamped to [0, capacity]: blocks at or past
// n return at once, and with n = 0 block 0 writes zeros.
//
// Each live block copies its 1,024 floats into the partials scratch, then
// counts itself in; the last live block to arrive sums the n partials in
// block order into `out` and clears the counter for the next launch, so
// the sum is deterministic (the threadfence reduction of the CUDA
// samples).  Bound: bytes, n·4 KiB read, written and read again.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 8 * 128;  // floats per (8, 128) block
constexpr int THREADS = 256;
constexpr int ITEMS = BLOCK / THREADS;

__global__ void __launch_bounds__(THREADS)
dyngrid_sum_kernel(const float* __restrict__ x, const int* __restrict__ n_ptr,
                   float* __restrict__ partials,
                   unsigned int* __restrict__ arrived,
                   float* __restrict__ out) {
  __shared__ bool last;
  // the live count, clamped to the grid: past it no block would be the
  // last to arrive, `out` would go stale and `arrived` stay set
  const int n = min(*n_ptr, (int)gridDim.x);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (n <= 0) {  // nothing live: block 0 writes the empty sum
    if (b == 0) {
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) out[q * THREADS + tid] = 0.0f;
    }
    return;
  }
  if (b >= n) return;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int e = q * THREADS + tid;
    partials[(size_t)b * BLOCK + e] = x[(size_t)b * BLOCK + e];
  }
  __threadfence();  // the partials are visible before the block counts in
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrived, 1u) == (unsigned)n - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int e = q * THREADS + tid;
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) {
      acc = acc + *reinterpret_cast<volatile float*>(&partials[(size_t)k * BLOCK + e]);
    }
    out[e] = acc;
  }
  if (tid == 0) *arrived = 0u;
}

}  // namespace

// out [1024] = the sum of the first *n (device int, clamped to [0,
// capacity]) blocks of x [capacity, 1024], in block order; a grid of `capacity` blocks.  partials: [capacity,
// 1024] scratch; arrived: one unsigned int, 0 before the first launch.
extern "C" int e3d_dyngrid_sum(const float* x, int capacity, const int* n,
                               float* partials, unsigned int* arrived,
                               float* out, cudaStream_t stream) {
  if (capacity <= 0) return 0;
  dyngrid_sum_kernel<<<capacity, THREADS, 0, stream>>>(x, n, partials,
                                                       arrived, out);
  return (int)cudaGetLastError();
}
