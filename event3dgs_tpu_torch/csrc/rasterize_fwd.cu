// Forward compositing of tile-binned Gaussians (kernel K1).
//
// Replaces the TPU kernel `_make_fwd_kernel` of
// event3dgs_tpu/ops/rasterize_tiled.py (launched by `run_forward` there).
//
// One block per 32x32 tile, 256 threads, 4 pixels per thread (pixel column
// threadIdx.x % 32, rows threadIdx.x / 32 + 8k).  The tile's instances,
// depth-ordered by the binning, are staged through shared memory 256 at a
// time (each thread gathers one instance's attributes).  Per (pixel,
// instance), as the TPU kernel and the oracle:
//   power = ca'·dx² + cb'·dx·dy + cc'·dy²   (conic pre-scaled: -ca/2, -cb, -cc/2)
//   skip if power > 0 or opacity·e^power < 1/255
//   alpha = min(0.99, opacity·e^power),  w = alpha·exp(logT)
//   rgb += w·color,  logT += log1p(-alpha)
// with means taken relative to the tile origin like the TPU kernel.  Log T
// is carried (not T) as on the TPU; the backward pass will need it.
//
// Early stop is per pixel: a pixel is done once logT < ln(1e-6)
// (LOG_T_SKIP); the block stops when all its pixels are done.  The TPU
// kernel skipped whole chunks instead; what either drops weighs < 1e-6.
// Each pixel's stop index (one past the last instance of the tile's list it
// evaluated; the tile's count if it never stopped) is written to `stop_out`,
// the reference CUDA rasterizer's n_contrib: the backward kernel (K2,
// rasterize_bwd.cu) starts each pixel there, so both passes see the same
// (pixel, instance) pairs.
//
// Numerics: expf and log1pf (no fast-math intrinsics), built with
// -fmad=false, so the result rounds like the plain PyTorch version.
// Bound: operations, ~20 FP32 operations and the exponentials per
// (pixel, instance) pair; each tile reads its instance list once and writes
// its pixels once.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int ROWS = TILE * TILE / THREADS;  // pixels per thread
constexpr int FEAT = 12;  // mx my ca' cb' cc' opacity r g b (+3 pad) per Gaussian
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float LOG_T_SKIP = -13.8f;

__global__ void __launch_bounds__(THREADS)
composite_forward_kernel(const int* __restrict__ inst_gauss,
                         const int* __restrict__ tile_offsets,
                         const int* __restrict__ tile_counts,
                         const float* __restrict__ feat, int tiles_x,
                         int width, int height, float* __restrict__ rgb_out,
                         float* __restrict__ logt_out,
                         int* __restrict__ stop_out) {
  __shared__ float s_mx[THREADS], s_my[THREADS], s_ca[THREADS], s_cb[THREADS],
      s_cc[THREADS], s_op[THREADS], s_r[THREADS], s_g[THREADS], s_b[THREADS];

  const int tile = blockIdx.x;
  const int ox = (tile % tiles_x) * TILE;
  const int oy = (tile / tiles_x) * TILE;
  const int lx = threadIdx.x % TILE;
  const int ly0 = threadIdx.x / TILE;
  const float px = (float)lx;

  const int start = tile_offsets[tile];
  const int count = tile_counts[tile];

  float logt[ROWS], cr[ROWS], cg[ROWS], cb[ROWS];
  int stop[ROWS];
  bool done[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    logt[k] = 0.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    // pixels of the padded tile grid outside the image are never written
    done[k] = ox + lx >= width || oy + ly0 + 8 * k >= height;
    stop[k] = count;
  }
  for (int batch = 0; batch < count; batch += THREADS) {
    bool all_done = true;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) all_done = all_done && done[k];
    // barrier before the staging buffers are overwritten, and block vote
    if (__syncthreads_and(all_done)) break;
    const int n = min(THREADS, count - batch);
    if ((int)threadIdx.x < n) {
      const int g = inst_gauss[start + batch + threadIdx.x];
      const float4* f = reinterpret_cast<const float4*>(feat + (size_t)g * FEAT);
      const float4 a = f[0], b = f[1], c = f[2];
      s_mx[threadIdx.x] = a.x - (float)ox;
      s_my[threadIdx.x] = a.y - (float)oy;
      s_ca[threadIdx.x] = a.z;
      s_cb[threadIdx.x] = a.w;
      s_cc[threadIdx.x] = b.x;
      s_op[threadIdx.x] = b.y;
      s_r[threadIdx.x] = b.z;
      s_g[threadIdx.x] = b.w;
      s_b[threadIdx.x] = c.x;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float mx = s_mx[j], my = s_my[j];
      const float ca = s_ca[j], cbc = s_cb[j], cc = s_cc[j], op = s_op[j];
      const float dx = mx - px;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        if (done[k]) continue;
        const float dy = my - (float)(ly0 + 8 * k);
        const float power = ca * (dx * dx) + cbc * (dx * dy) + cc * (dy * dy);
        if (power > 0.0f) continue;
        const float raw = op * expf(power);
        if (raw < ALPHA_MIN) continue;
        const float alpha = fminf(ALPHA_MAX, raw);
        const float w = alpha * expf(logt[k]);
        cr[k] = cr[k] + w * s_r[j];
        cg[k] = cg[k] + w * s_g[j];
        cb[k] = cb[k] + w * s_b[j];
        logt[k] = logt[k] + log1pf(-alpha);
        if (logt[k] < LOG_T_SKIP) {
          done[k] = true;
          stop[k] = batch + j + 1;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int x = ox + lx, y = oy + ly0 + 8 * k;
    if (x < width && y < height) {
      const size_t p = (size_t)y * width + x;
      rgb_out[3 * p] = cr[k];
      rgb_out[3 * p + 1] = cg[k];
      rgb_out[3 * p + 2] = cb[k];
      logt_out[p] = logt[k];
      stop_out[p] = stop[k];
    }
  }
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
      rgb_out, logt_out, stop_out);
  return (int)cudaGetLastError();
}
