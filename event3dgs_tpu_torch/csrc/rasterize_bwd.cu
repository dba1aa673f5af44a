// Backward compositing of tile-binned Gaussians (kernel K2).
//
// Replaces the TPU kernel `_make_bwd_kernel` of
// event3dgs_tpu/ops/rasterize_tiled.py (launched from `rasterize_bwd` there).
//
// One block per 32x32 tile, 256 threads, 4 pixels per thread, each warp on
// a 16x8 sub-block: the layout of the forward kernel K1 (rasterize_fwd.cu;
// layout, cull and staging in composite.cuh).  Each pixel walks its tile's
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
// = (-a/2, -b, -c/2).
//
// Instances are staged 64 at a time (double-buffered with cp.async).  Lane
// l of each warp tests staged instances l and 32 + l against the warp's
// sub-block (the warp cull) and below the warp's largest stop index; two
// ballots give the warp's list, walked back to front, so a warp skips whole
// the instances none of its pixels can composite and starts at its own stop
// index, not the block's.  Per instance the nine sums go over the warp's 32
// lanes by a transposing butterfly (a reduce-scatter: at each step a lane
// keeps half of its partial sums and sends the other half, 12 shuffles for
// nine sums) and, once per batch, over the warps that reached the instance,
// in warp order.  The order of every sum is fixed and each slot belongs to one
// tile, so there are no atomics and the rows repeat bit for bit; kernel K3
// (segsum.cu) sums the slot rows of each Gaussian.
//
// Numerics: the skip decisions and log T round like K1 and the plain
// version (-fmad=false); the gradient products and sums (g·c, dL/dalpha,
// the carry, the nine terms) are explicit __fmaf_rn, which -fmad=false
// leaves alone, so they round once per fused product and sum.
//
// Bound: operations, ~38 FP32 instructions and four exponentials,
// logarithms or divisions per composited (pixel, instance) pair; each tile
// reads its instance list and its pixels once and writes its slot rows.

#include <cuda_runtime.h>

#include "composite.cuh"

namespace {

using namespace composite;

constexpr int NGRAD = 9;  // gradient floats per instance slot
constexpr int BATCH = 64;  // instances staged per round, a multiple of 32
constexpr int GROUPS = BATCH / 32;  // a warp's ballots per round

// The warp total of each of v[0..8] by a transposing butterfly.  Returns the
// total held by this lane and sets `idx` to which of the nine it is, or to
// -1 where the lane holds a pad or its pair's other lane writes it.
__device__ __forceinline__ float warp_sums9(const float (&v)[NGRAD], int lane,
                                            int& idx) {
  // xor 16: ten slots (v and one zero pad) -> five
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4, h1 = lane & 2;
  float u[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float lo = v[i], hi = i + 5 < NGRAD ? v[i + 5] : 0.0f;
    u[i] = (h4 ? hi : lo) + __shfl_xor_sync(FULL, h4 ? lo : hi, 16);
  }
  // xor 8: five (+ a pad) -> three
  float w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float lo = u[i], hi = i + 3 < 5 ? u[i + 3] : 0.0f;
    w[i] = (h3 ? hi : lo) + __shfl_xor_sync(FULL, h3 ? lo : hi, 8);
  }
  // xor 4: three (+ a pad) -> two
  float x[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lo = w[i], hi = i + 2 < 3 ? w[i + 2] : 0.0f;
    x[i] = (h2 ? hi : lo) + __shfl_xor_sync(FULL, h2 ? lo : hi, 4);
  }
  // xor 2: two -> one; xor 1: both lanes of a pair end with the total
  float y = (h1 ? x[1] : x[0]) + __shfl_xor_sync(FULL, h1 ? x[0] : x[1], 2);
  y = y + __shfl_xor_sync(FULL, y, 1);
  const int wi = 2 * h2 + h1, ui = 3 * h3 + wi, vi = 5 * h4 + ui;
  idx = (lane & 1) == 0 && wi < 3 && ui < 5 && vi < NGRAD ? vi : -1;
  return y;
}

__global__ void __launch_bounds__(THREADS, 3)
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
  __shared__ __align__(16) float s_feat[2][BATCH][FEAT];
  __shared__ float s_part[WARPS][BATCH][NGRAD];
  // the instances of the batch each warp summed, a bit each
  __shared__ unsigned s_wrote[WARPS][GROUPS];
  __shared__ int s_maxstop;

  const int tile = blockIdx.x;
  const int ox = (tile % tiles_x) * TILE;
  const int oy = (tile / tiles_x) * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lx = sub_x0(warp) + lane % SUB_W;
  const int ly0 = sub_y0(warp) + lane / SUB_W;  // rows ly0 + 2k
  const float px = (float)lx;
  const int start = tile_offsets[tile];
  const int* ids = inst_gauss + start;
  const int count = tile_counts[tile];

  float lt[ROWS], carry[ROWS], gr[ROWS], gg[ROWS], gb[ROWS];
  int stop[ROWS];
  int my_max = 0;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int x = ox + lx, y = oy + ly0 + 2 * k;
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
  const int warp_max = __reduce_max_sync(FULL, my_max);
  if (threadIdx.x == 0) s_maxstop = 0;
  __syncthreads();
  if (lane == 0) atomicMax(&s_maxstop, warp_max);
  __syncthreads();
  const int max_stop = s_maxstop;

  // instances no pixel of the tile reached have zero gradient
  for (int t = max_stop * NGRAD + (int)threadIdx.x; t < count * NGRAD; t += THREADS)
    rows_out[(size_t)start * NGRAD + t] = 0.0f;
  if (max_stop == 0) return;

  // batches back to front; only the last one (the first walked) is partial
  const int last = (max_stop - 1) / BATCH;
  if ((int)threadIdx.x < max_stop - last * BATCH)
    stage_row(s_feat[0][threadIdx.x], feat, ids[last * BATCH + threadIdx.x]);
  cp_async_commit();
  const bool stager = threadIdx.x < BATCH;  // one row each
  int id_next = stager && last > 0 ? ids[(last - 1) * BATCH + threadIdx.x] : 0;
  for (int b = last, buf = 0; b >= 0; --b, buf ^= 1) {
    const int b0 = b * BATCH;
    const int nb = min(BATCH, max_stop - b0);
    // the other buffer was last read before the previous round's barrier
    if (stager && b > 0) stage_row(s_feat[buf ^ 1][threadIdx.x], feat, id_next);
    cp_async_commit();
    if (stager && b > 1) id_next = ids[(b - 2) * BATCH + threadIdx.x];
    cp_async_wait_prev();
    if ((int)threadIdx.x < nb) {
      float* row = s_feat[buf][threadIdx.x];
      row[0] = row[0] - (float)ox;
      row[1] = row[1] - (float)oy;
    }
    __syncthreads();

    for (int g = GROUPS - 1; g >= 0; --g) {
      // lane l tests instance 32g + l of the batch
      const int i = 32 * g + lane;
      const bool hit = i < nb && b0 + i < warp_max &&
                       reaches(cull_of(s_feat[buf][i]), (float)sub_x0(warp),
                               (float)sub_y0(warp));
      unsigned bits = __ballot_sync(FULL, hit);
      unsigned wrote = 0;
      while (bits) {
        const int jj = 32 * g + 31 - __clz(bits);
        bits &= ~(1u << (jj % 32));
        const int j = b0 + jj;
        const float4 f0 = *reinterpret_cast<const float4*>(&s_feat[buf][jj][0]);
        const float4 f1 = *reinterpret_cast<const float4*>(&s_feat[buf][jj][4]);
        const float mx = f0.x, my = f0.y, ca = f0.z, cbc = f0.w, cc = f1.x;
        const float op = f1.y, cr = f1.z, cgc = f1.w, cbl = s_feat[buf][jj][8];
        const float dx = mx - px;
        float v[NGRAD];
#pragma unroll
        for (int r = 0; r < NGRAD; ++r) v[r] = 0.0f;
        bool any = false;
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          if (j >= stop[k]) continue;
          const float dy = my - (float)(ly0 + 2 * k);
          const float power = ca * (dx * dx) + cbc * (dx * dy) + cc * (dy * dy);
          if (power > 0.0f) continue;
          const float e = expf(power);
          const float raw = op * e;
          if (raw < ALPHA_MIN) continue;
          const float alpha = fminf(ALPHA_MAX, raw);
          const float lt_in = lt[k] - log1pf(-alpha);
          const float t = expf(lt_in);
          const float w = alpha * t;
          const float gc = __fmaf_rn(gb[k], cbl, __fmaf_rn(gg[k], cgc, gr[k] * cr));
          const float dalpha = __fmaf_rn(gc, t, -(carry[k] / (1.0f - alpha)));
          carry[k] = __fmaf_rn(w, gc, carry[k]);
          lt[k] = lt_in;
          any = true;
          if (raw < ALPHA_MAX) {
            const float dpw = dalpha * alpha;
            v[0] = __fmaf_rn(dpw, __fmaf_rn(2.0f * ca, dx, cbc * dy), v[0]);
            v[1] = __fmaf_rn(dpw, __fmaf_rn(2.0f * cc, dy, cbc * dx), v[1]);
            v[2] = __fmaf_rn(dpw, -0.5f * (dx * dx), v[2]);
            v[3] = __fmaf_rn(dpw, -(dx * dy), v[3]);
            v[4] = __fmaf_rn(dpw, -0.5f * (dy * dy), v[4]);
            v[5] = __fmaf_rn(dalpha, e, v[5]);
          }
          v[6] = __fmaf_rn(gr[k], w, v[6]);
          v[7] = __fmaf_rn(gg[k], w, v[7]);
          v[8] = __fmaf_rn(gb[k], w, v[8]);
        }
        if (__any_sync(FULL, any)) {
          int r;
          const float s = warp_sums9(v, lane, r);
          if (r >= 0) s_part[warp][jj][r] = s;
          wrote |= 1u << (jj % 32);
        }
      }
      if (lane == 0) s_wrote[warp][g] = wrote;
    }
    __syncthreads();
    // slot rows of the batch: the warps that summed an instance, in warp
    // order (zero where none did); coalesced over the batch's rows
    for (int t = threadIdx.x; t < nb * NGRAD; t += THREADS) {
      const int jj = t / NGRAD, r = t % NGRAD;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        if ((s_wrote[w][jj / 32] >> (jj % 32)) & 1) s += s_part[w][jj][r];
      rows_out[(size_t)(start + b0) * NGRAD + t] = s;
    }
  }
  cp_async_wait_all();
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

extern "C" int e3d_composite_backward_occupancy(int* regs, int* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, composite_backward_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, composite_backward_kernel, THREADS, 0);
}
