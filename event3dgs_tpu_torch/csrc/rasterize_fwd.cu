// Forward compositing of tile-binned Gaussians (kernel K1).
//
// Replaces the TPU kernel `_make_fwd_kernel` of
// event3dgs_tpu/ops/rasterize_tiled.py (launched by `run_forward` there).
//
// One block per 32x32 tile, 256 threads, 4 pixels per thread; each warp owns
// a 16x8 sub-block of the tile (layout, cull and staging: composite.cuh).
// The tile's instances, depth-ordered by the binning, are staged through a
// double buffer in shared memory 256 at a time.  The thread that stages an
// instance tests which of the 8 sub-blocks its alpha >= 1/255 region can
// reach and stores an 8-bit mask beside the row; each warp then ballots its
// bit over the batch and walks only the instances of its own compacted
// list.  Per (pixel, instance), as the TPU kernel and the oracle:
//   power = ca'·dx² + cb'·dx·dy + cc'·dy²   (conic pre-scaled: -ca/2, -cb, -cc/2)
//   skip if power > 0 or opacity·e^power < 1/255
//   alpha = min(0.99, opacity·e^power),  w = alpha·exp(logT)
//   rgb += w·color,  logT += log1p(-alpha)
// with means taken relative to the tile origin like the TPU kernel.  Log T
// is carried (not T) as on the TPU; the backward pass will need it.  A
// culled instance is one every pixel of the warp would skip, so each pixel
// composites the same instances in the same order as without the cull.
//
// Early stop is per pixel: a pixel is done once logT < ln(1e-6)
// (LOG_T_SKIP).  A warp whose pixels are all done stops evaluating; the
// block leaves the batch loop when all its pixels are done.  The TPU kernel
// skipped whole chunks instead; what either drops weighs < 1e-6.  Each
// pixel's stop index (one past the last instance of the tile's list it
// evaluated; the tile's count if it never stopped) is written to
// `stop_out`, the reference CUDA rasterizer's n_contrib: the backward
// kernel (K2, rasterize_bwd.cu) starts each pixel there, so both passes see
// the same (pixel, instance) pairs.
//
// Numerics: expf and log1pf (no fast-math intrinsics), built with
// -fmad=false, so the result rounds like the plain PyTorch version.
// Bound: operations, ~23 FP32 operations and three exponentials or
// logarithms per composited (pixel, instance) pair; each tile reads its
// instance list once and writes its pixels once.  The warp cull removes
// most of the pairs a pixel would only skip.  Launch bounds of 4 blocks per
// SM hold the kernel to 64 registers (a few bytes spill), which measured
// faster than 79 registers at 3 blocks.
//
// Timing-only builds.  tools/kernel_probes.py builds this file with one or
// more of the macros below to see what each cost term of the kernel
// costs, as experiments/tools_exp_kernel.py built ablated copies of the
// TPU kernel.  Without a macro every one of them expands to the shipping
// code.  The ablated builds are not a rasterizer: they composite other
// pairs, or stop elsewhere, and have no plain version.
//   E3D_NOEXP    expf(power) and expf(logt) become (1 + x/8)^8 (0 below
//                x = -8): four FP32 operations, no special function unit
//   E3D_NOLOG    log1pf(-alpha) becomes -alpha (built with E3D_NOEXP)
//   E3D_NOCULL   every warp takes every staged instance (mask 0xff)
//   E3D_NOCOPY   the staging uses plain 16-byte loads, not cp.async
//   E3D_NOSTOP   no per-pixel early stop
//   E3D_NOSPILL  __launch_bounds__(THREADS, 3): up to 80 registers
//   E3D_CLOCK    the shipping arithmetic, plus each block's %globaltimer at
//                entry and exit in an int64 [num_tiles, 2] buffer
//                (e3d_composite_forward_clock)
// Each stand-in still feeds the outputs, so the compiler keeps the loop.

#include <cuda_runtime.h>

#include "composite.cuh"

namespace {

using namespace composite;

#ifdef E3D_NOSPILL
#define E3D_MIN_BLOCKS 3
#else
#define E3D_MIN_BLOCKS 4
#endif

#ifdef E3D_NOEXP
// (1 + x/8)^8 for x >= -8, else 0
__device__ __forceinline__ float exp_stand_in(float x) {
  float y = fmaxf(1.0f + 0.125f * x, 0.0f);
  y = y * y;
  y = y * y;
  return y * y;
}
#define E3D_EXP(x) exp_stand_in(x)
#else
#define E3D_EXP(x) expf(x)
#endif

#ifdef E3D_NOLOG
#define E3D_LOG1M(a) (-(a))
#else
#define E3D_LOG1M(a) log1pf(-(a))
#endif

#ifdef E3D_NOCOPY
// the row's three 16-byte pieces loaded and stored by the thread
__device__ __forceinline__ void stage_plain(float* row, const float* feat,
                                           int g) {
  const float4* src = reinterpret_cast<const float4*>(feat + (size_t)g * FEAT);
  float4* dst = reinterpret_cast<float4*>(row);
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}
#define E3D_STAGE stage_plain
#else
#define E3D_STAGE stage_row
#endif

#ifdef E3D_CLOCK
__device__ __forceinline__ long long global_timer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

constexpr int BATCH = THREADS;  // instances staged per round, one per thread
constexpr float LOG_T_SKIP = -13.8f;

__device__ __forceinline__ bool all_of(const bool (&done)[ROWS]) {
  bool all = true;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) all = all && done[k];
  return all;
}

__global__ void __launch_bounds__(THREADS, E3D_MIN_BLOCKS)
composite_forward_kernel(const int* __restrict__ inst_gauss,
                         const int* __restrict__ tile_offsets,
                         const int* __restrict__ tile_counts,
                         const float* __restrict__ feat, int tiles_x,
                         int width, int height, float* __restrict__ rgb_out,
                         float* __restrict__ logt_out,
                         int* __restrict__ stop_out
#ifdef E3D_CLOCK
                         , long long* __restrict__ clock_out
#endif
                         ) {
#ifdef E3D_CLOCK
  const long long t_entry = global_timer();
#endif
  __shared__ __align__(16) float s_feat[2][BATCH][FEAT];
  __shared__ unsigned char s_mask[BATCH];

  const int tile = blockIdx.x;
  const int ox = (tile % tiles_x) * TILE;
  const int oy = (tile / tiles_x) * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lx = sub_x0(warp) + lane % SUB_W;
  const int ly0 = sub_y0(warp) + lane / SUB_W;  // rows ly0 + 2k
  const float px = (float)lx;

  const int* ids = inst_gauss + tile_offsets[tile];
  const int count = tile_counts[tile];

  float logt[ROWS], cr[ROWS], cg[ROWS], cb[ROWS];
  int stop[ROWS];
  bool done[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    logt[k] = 0.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    // pixels of the padded tile grid outside the image are never written
    done[k] = ox + lx >= width || oy + ly0 + 2 * k >= height;
    stop[k] = count;
  }

  // batch 0 is staged before the loop; batch i + 1 while batch i composites
  if ((int)threadIdx.x < min(BATCH, count))
    E3D_STAGE(s_feat[0][threadIdx.x], feat, ids[threadIdx.x]);
  cp_async_commit();
  int next = BATCH + (int)threadIdx.x;
  int id_next = next < count ? ids[next] : 0;
  for (int batch = 0, buf = 0; batch < count; batch += BATCH, buf ^= 1) {
    const bool all_done = all_of(done);
    // barrier before the other buffer and the masks are overwritten, and
    // block vote
    if (__syncthreads_and(all_done)) break;
    const int n = min(BATCH, count - batch);
    if (next < count) E3D_STAGE(s_feat[buf ^ 1][threadIdx.x], feat, id_next);
    cp_async_commit();
    next += BATCH;
    if (next < count) id_next = ids[next];
    cp_async_wait_prev();
    if ((int)threadIdx.x < n) {
      float* row = s_feat[buf][threadIdx.x];
      row[0] = row[0] - (float)ox;
      row[1] = row[1] - (float)oy;
#ifdef E3D_NOCULL
      const unsigned m = (1u << WARPS) - 1u;
#else
      const Cull c = cull_of(row);
      unsigned m = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        m |= reaches(c, (float)sub_x0(w), (float)sub_y0(w)) ? 1u << w : 0u;
#endif
      s_mask[threadIdx.x] = (unsigned char)m;
    }
    __syncthreads();

    bool warp_done = __all_sync(FULL, all_done);
    for (int g0 = 0; g0 < n && !warp_done; g0 += 32) {
      const int i = g0 + lane;
      unsigned bits = __ballot_sync(FULL, i < n && ((s_mask[i] >> warp) & 1));
      while (bits) {
        const int j = g0 + __ffs(bits) - 1;
        bits &= bits - 1;
        const float4 f0 = *reinterpret_cast<const float4*>(&s_feat[buf][j][0]);
        const float4 f1 = *reinterpret_cast<const float4*>(&s_feat[buf][j][4]);
        const float fb = s_feat[buf][j][8];
        const float dx = f0.x - px;
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          if (done[k]) continue;
          const float dy = f0.y - (float)(ly0 + 2 * k);
          const float power = f0.z * (dx * dx) + f0.w * (dx * dy) + f1.x * (dy * dy);
          if (power > 0.0f) continue;
          const float raw = f1.y * E3D_EXP(power);
          if (raw < ALPHA_MIN) continue;
          const float alpha = fminf(ALPHA_MAX, raw);
          const float w = alpha * E3D_EXP(logt[k]);
          cr[k] = cr[k] + w * f1.z;
          cg[k] = cg[k] + w * f1.w;
          cb[k] = cb[k] + w * fb;
          logt[k] = logt[k] + E3D_LOG1M(alpha);
#ifndef E3D_NOSTOP
          if (logt[k] < LOG_T_SKIP) {
            done[k] = true;
            stop[k] = batch + j + 1;
          }
#endif
        }
        if (__all_sync(FULL, all_of(done))) {
          warp_done = true;
          break;
        }
      }
    }
  }
  cp_async_wait_all();  // no copy may land after the block has left

#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int x = ox + lx, y = oy + ly0 + 2 * k;
    if (x < width && y < height) {
      const size_t p = (size_t)y * width + x;
      rgb_out[3 * p] = cr[k];
      rgb_out[3 * p + 1] = cg[k];
      rgb_out[3 * p + 2] = cb[k];
      logt_out[p] = logt[k];
      stop_out[p] = stop[k];
    }
  }
#ifdef E3D_CLOCK
  __syncthreads();
  if (threadIdx.x == 0 && clock_out != nullptr) {
    clock_out[2 * tile] = t_entry;
    clock_out[2 * tile + 1] = global_timer();
  }
#endif
}

}  // namespace

extern "C" int e3d_composite_forward(const int* inst_gauss,
                                     const int* tile_offsets,
                                     const int* tile_counts, const float* feat,
                                     int num_tiles, int tiles_x, int width,
                                     int height, float* rgb_out,
                                     float* logt_out, int* stop_out,
                                     cudaStream_t stream) {
  if (num_tiles <= 0) return 0;
  composite_forward_kernel<<<num_tiles, THREADS, 0, stream>>>(
      inst_gauss, tile_offsets, tile_counts, feat, tiles_x, width, height,
      rgb_out, logt_out, stop_out
#ifdef E3D_CLOCK
      , nullptr
#endif
      );
  return (int)cudaGetLastError();
}

#ifdef E3D_CLOCK
// e3d_composite_forward that also writes each block's %globaltimer at
// entry and exit (ns) into clock_out [num_tiles, 2]
extern "C" int e3d_composite_forward_clock(
    const int* inst_gauss, const int* tile_offsets, const int* tile_counts,
    const float* feat, int num_tiles, int tiles_x, int width, int height,
    float* rgb_out, float* logt_out, int* stop_out, long long* clock_out,
    cudaStream_t stream) {
  if (num_tiles <= 0) return 0;
  composite_forward_kernel<<<num_tiles, THREADS, 0, stream>>>(
      inst_gauss, tile_offsets, tile_counts, feat, tiles_x, width, height,
      rgb_out, logt_out, stop_out, clock_out);
  return (int)cudaGetLastError();
}
#endif

extern "C" int e3d_composite_forward_occupancy(int* regs, int* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, composite_forward_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, composite_forward_kernel, THREADS, 0);
}
