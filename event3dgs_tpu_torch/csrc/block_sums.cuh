// Deterministic scalar sums over a grid, shared by the loss kernels
// (loss.cu, ssim.cu).
//
// Each thread adds its terms in double; block_sum adds a block's threads'
// in a fixed tree; arrive writes the block's row of partials and tells the
// last block to finish (a counter of the kernel's own in device memory,
// which that block sets back to 0) that every row is written; total adds
// the rows in block order.  The grid is fixed by the card and the shapes,
// so the same inputs give the same bits in every run.  Two launches of one
// kernel must not run at once (on two streams): they would share its
// counter.  `tid` is the thread's index in its block, `block` the block's
// in the grid, `blocks` the grid's size.

#pragma once

#include <cuda_runtime.h>

// v summed over the block of THREADS threads in a fixed tree; the sums
// land in thread 0's v
template <int THREADS, int N>
__device__ __forceinline__ void block_sum(double (&v)[N], int tid) {
  constexpr int WARPS = THREADS / 32;
  __shared__ double warp_sums[WARPS][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v[i] += __shfl_down_sync(0xffffffffu, v[i], o);
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) warp_sums[warp][i] = v[i];
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      double s = warp_sums[0][i];
      for (int w = 1; w < WARPS; ++w) s += warp_sums[w][i];
      v[i] = s;
    }
  }
  __syncthreads();  // warp_sums free for the next call
}

// the block's sums (in thread 0's v) into its partials row; true in every
// thread of the last block to get here, which then reads all the rows
template <int N>
__device__ __forceinline__ bool arrive(const double (&v)[N],
                                       double* __restrict__ partials,
                                       unsigned int block, unsigned int blocks,
                                       unsigned int* arrivals, int tid) {
  __shared__ bool last;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) partials[block * N + i] = v[i];
    __threadfence();  // the row is visible before the block counts in
    last = atomicAdd(arrivals, 1u) == blocks - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// the partials rows of `blocks` blocks summed in block order (in thread
// 0's v)
template <int THREADS, int N>
__device__ __forceinline__ void total(const double* __restrict__ partials,
                                      unsigned int blocks, double (&v)[N],
                                      int tid) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.0;
  for (unsigned int b = tid; b < blocks; b += THREADS) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __ldcg(&partials[b * N + i]);
  }
  block_sum<THREADS, N>(v, tid);
}

// torch.sgn of a float: 1, -1, or 0 at 0 and NaN
__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// d log T of one pixel of a render composed as rgb + expf(log T)·bg, from
// its image's gradient g and e = expf(log T): the product's backward g·bg,
// summed over the broadcast channel axis as PyTorch's CUDA sum over 3
// contiguous values adds them (two lanes, each accumulator from +0), then
// the exp's backward (times its result)
__device__ __forceinline__ float logt_grad(const float (&g)[3],
                                           const float (&bg)[3], float e) {
  const float a0 = __fadd_rn(0.0f, __fmul_rn(g[0], bg[0]));
  const float a1 = __fadd_rn(0.0f, __fmul_rn(g[1], bg[1]));
  const float a2 = __fadd_rn(0.0f, __fmul_rn(g[2], bg[2]));
  return __fmul_rn(__fadd_rn(__fadd_rn(a0, a2), a1), e);
}
