// Backward compositing of tile-binned Gaussians (kernel K2).
//
// Replaces the TPU kernel `_make_bwd_kernel` of
// event3dgs_tpu/ops/rasterize_tiled.py (launched from `rasterize_bwd` there).
//
// One block per 32x32 tile, 256 threads, 4 pixels per thread, the layout of
// the forward kernel K1 (rasterize_fwd.cu).  Each pixel walks its tile's
// depth-ordered instances back to front, starting just below its stop index
// from K1, and rebuilds the transmittance in log space by subtraction from
// K1's final log T, as the TPU kernel does:
//
//   logT_i = logT_{i+1} - log1p(-alpha_i),   T_i = exp(logT_i)
//   dL/dalpha_i = (g·c_i)·T_i - S_i/(1 - alpha_i)
//   S_{i-1} = S_i + alpha_i·T_i·(g·c_i),     S_last = dL/dlogT (the carry
//                                            starts from the log T cotangent)
//
// with g the pixel's rgb cotangent.  alpha <= 0.99, so 1 - alpha >= 0.01.
// The skips are K1's: the same arithmetic (means relative to the tile
// origin, the pre-scaled conic, expf, -fmad=false) decides power > 0 and
// raw < 1/255, and instances at or past the pixel's stop index are never
// visited.  At the 0.99 clamp the slope in opacity and power is zero.
//
// Per (pixel, instance) the nine gradient terms are
//   d mean2d x, y = dpw·(2ca'·dx + cb'·dy), dpw·(2cc'·dy + cb'·dx)
//   d conic a, b, c = -dpw·dx²/2, -dpw·dx·dy, -dpw·dy²/2
//   d opacity = dalpha·exp(power),   d rgb = g·w
// with dpw = dalpha·alpha (dL/dpower) and the conic stored as (ca', cb', cc')
// = (-a/2, -b, -c/2).  They are summed over the tile's pixels in a fixed
// order — each thread's four pixels in order, a shuffle tree inside each
// warp, then the eight warp partials in warp order — and written to the
// instance's slot row.  Each slot belongs to one tile, so there are no
// atomics and the rows repeat bit for bit; kernel K3 (segsum.cu) sums the
// slot rows of each Gaussian.
//
// Bound: operations, ~60 FP32 operations and two exponentials per
// evaluated (pixel, instance) pair plus the shuffle reduction of nine sums
// per instance; each tile reads its instance list and its pixels once.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = TILE * TILE / THREADS;  // pixels per thread
constexpr int FEAT = 12;  // mx my ca' cb' cc' opacity r g b (+3 pad) per Gaussian
constexpr int NGRAD = 9;  // gradient floats per instance slot
constexpr int BATCH = 32;  // instances staged per round
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
composite_backward_kernel(const int* __restrict__ inst_gauss,
                          const int* __restrict__ tile_offsets,
                          const int* __restrict__ tile_counts,
                          const float* __restrict__ feat, int tiles_x,
                          int width, int height,
                          const float* __restrict__ g_rgb,
                          const float* __restrict__ g_logt,
                          const float* __restrict__ logt_final,
                          const int* __restrict__ stop_in,
                          float* __restrict__ rows_out) {
  __shared__ float s_mx[BATCH], s_my[BATCH], s_ca[BATCH], s_cb[BATCH],
      s_cc[BATCH], s_op[BATCH], s_r[BATCH], s_g[BATCH], s_b[BATCH];
  __shared__ float s_part[WARPS][BATCH][NGRAD];
  __shared__ int s_maxstop;

  const int tile = blockIdx.x;
  const int ox = (tile % tiles_x) * TILE;
  const int oy = (tile / tiles_x) * TILE;
  const int lx = threadIdx.x % TILE;
  const int ly0 = threadIdx.x / TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float px = (float)lx;
  const int start = tile_offsets[tile];
  const int count = tile_counts[tile];

  float lt[ROWS], carry[ROWS], gr[ROWS], gg[ROWS], gb[ROWS];
  int stop[ROWS];
  int my_max = 0;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int x = ox + lx, y = oy + ly0 + 8 * k;
    const bool inside = x < width && y < height;
    const size_t p = inside ? (size_t)y * width + x : 0;
    lt[k] = inside ? logt_final[p] : 0.0f;
    carry[k] = inside ? g_logt[p] : 0.0f;
    gr[k] = inside ? g_rgb[3 * p] : 0.0f;
    gg[k] = inside ? g_rgb[3 * p + 1] : 0.0f;
    gb[k] = inside ? g_rgb[3 * p + 2] : 0.0f;
    stop[k] = inside ? min(stop_in[p], count) : 0;
    my_max = max(my_max, stop[k]);
  }
  if (threadIdx.x == 0) s_maxstop = 0;
  __syncthreads();
  atomicMax(&s_maxstop, my_max);
  __syncthreads();
  const int max_stop = s_maxstop;

  // instances no pixel of the tile reached have zero gradient
  for (int i = max_stop + (int)threadIdx.x; i < count; i += THREADS) {
#pragma unroll
    for (int r = 0; r < NGRAD; ++r) rows_out[(size_t)(start + i) * NGRAD + r] = 0.0f;
  }

  for (int b0 = ((max_stop - 1) / BATCH) * BATCH; max_stop > 0 && b0 >= 0;
       b0 -= BATCH) {
    const int nb = min(BATCH, max_stop - b0);
    __syncthreads();  // the previous round's reads of the staging buffers
    if ((int)threadIdx.x < nb) {
      const int g = inst_gauss[start + b0 + threadIdx.x];
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
    for (int jj = nb - 1; jj >= 0; --jj) {
      const int j = b0 + jj;
      const float mx = s_mx[jj], my = s_my[jj];
      const float ca = s_ca[jj], cbc = s_cb[jj], cc = s_cc[jj], op = s_op[jj];
      const float cr = s_r[jj], cgc = s_g[jj], cbl = s_b[jj];
      const float dx = mx - px;
      float v[NGRAD];
#pragma unroll
      for (int r = 0; r < NGRAD; ++r) v[r] = 0.0f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        if (j >= stop[k]) continue;
        const float dy = my - (float)(ly0 + 8 * k);
        const float power = ca * (dx * dx) + cbc * (dx * dy) + cc * (dy * dy);
        if (power > 0.0f) continue;
        const float e = expf(power);
        const float raw = op * e;
        if (raw < ALPHA_MIN) continue;
        const float alpha = fminf(ALPHA_MAX, raw);
        const float lt_in = lt[k] - log1pf(-alpha);
        const float t = expf(lt_in);
        const float w = alpha * t;
        const float gc = gr[k] * cr + gg[k] * cgc + gb[k] * cbl;
        const float dalpha = gc * t - carry[k] / (1.0f - alpha);
        carry[k] = carry[k] + w * gc;
        lt[k] = lt_in;
        any = true;
        if (raw < ALPHA_MAX) {
          const float dpw = dalpha * alpha;
          v[0] += dpw * (2.0f * ca * dx + cbc * dy);
          v[1] += dpw * (2.0f * cc * dy + cbc * dx);
          v[2] += dpw * (-0.5f * (dx * dx));
          v[3] += dpw * (-(dx * dy));
          v[4] += dpw * (-0.5f * (dy * dy));
          v[5] += dalpha * e;
        }
        v[6] += gr[k] * w;
        v[7] += gg[k] * w;
        v[8] += gb[k] * w;
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int r = 0; r < NGRAD; ++r) v[r] = warp_sum(v[r]);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < NGRAD; ++r) s_part[warp][jj][r] = v[r];
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nb * NGRAD; t += THREADS) {
      const int jj = t / NGRAD, r = t % NGRAD;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += s_part[w][jj][r];
      rows_out[(size_t)(start + b0 + jj) * NGRAD + r] = s;
    }
  }
}

}  // namespace

extern "C" int e3d_composite_backward(
    const int* inst_gauss, const int* tile_offsets, const int* tile_counts,
    const float* feat, int num_tiles, int tiles_x, int width, int height,
    const float* g_rgb, const float* g_logt, const float* logt_final,
    const int* stop, float* rows_out, cudaStream_t stream) {
  if (num_tiles <= 0) return 0;
  composite_backward_kernel<<<num_tiles, THREADS, 0, stream>>>(
      inst_gauss, tile_offsets, tile_counts, feat, tiles_x, width, height,
      g_rgb, g_logt, logt_final, stop, rows_out);
  return (int)cudaGetLastError();
}
