// Layout, warp cull and staging shared by the compositing kernels K1
// (rasterize_fwd.cu) and K2 (rasterize_bwd.cu).
//
// Layout.  One block of 256 threads per 32x32 tile.  Warp w owns one
// contiguous 16x8 sub-block of the tile, at (16·(w % 2), 8·(w / 2)); lane l
// holds pixel column 16·(w % 2) + l % 16 and rows 8·(w / 2) + l / 16 + 2k,
// k = 0..3.  The plain versions in ops/rasterize_tiled.py name the
// sub-block of tile pixel (x, y) the same way: 2·(y / 8) + x / 16.
//
// Warp cull.  For every staged instance and sub-block the kernels decide
// whether the instance's alpha >= 1/255 region can reach the sub-block,
// with the per-tile cull of the binning (ops/expand.py `rect_min_q`,
// csrc/expand.cu): the minimum of Q(d) = a·dx² + 2b·dx·dy + c·dy² over the
// sub-block's pixel box expanded by 1 px, against qthr = 2·ln(255·o).  The
// conic (a, b, c) is recovered exactly from the staged pre-scaled one
// (-a/2, -b, -c/2).  A warp whose sub-block the instance cannot reach skips
// it whole: no exponential, no divergence, no reduction.  The cull must
// never remove a pair the kernels would composite (K1's outputs stay equal
// to the plain version's), so the comparison keeps a margin for float
// rounding: CULL_SLACK·(qthr + 1) for the exponential, the logarithm and
// the alpha threshold, and CULL_EPS times the largest magnitude of the
// terms of Q over the box, (|a| + |b|)·X² + (|b| + |c|)·Y², which bounds
// the rounding of power and of this test's own Q where the terms cancel
// (thin splats).  A NaN keeps the instance.  `warp_cull_mask` in
// ops/rasterize_tiled.py repeats this arithmetic operation for operation.
//
// Staging.  Each instance's 48-byte feature row is gathered through the
// tile's instance list with three 16-byte `cp.async.cg` copies into a
// double buffer, so the gather of the next batch overlaps the compositing
// of the current one.  TMA's tensor copies do not fit: the rows are an
// indirect gather through `inst_gauss`, not a box of a tensor.

#pragma once

#include <cuda_runtime.h>

namespace composite {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;  // pixels per thread
constexpr int SUB_W = 16, SUB_H = 8;  // a warp's sub-block
constexpr int FEAT = 12;  // mx my ca' cb' cc' opacity r g b (+3 pad) per Gaussian
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float CULL_SLACK = 1e-3f;
constexpr float CULL_EPS = 4e-6f;  // ~32 float32 ulps
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int sub_x0(int warp) { return (warp & 1) * SUB_W; }
__device__ __forceinline__ int sub_y0(int warp) { return (warp >> 1) * SUB_H; }

// Per-instance constants of the cull, from the staged (tile-relative) row.
struct Cull {
  float mx, my, a, b, c, nba, nbc, limit, sa, sc;
};

__device__ __forceinline__ Cull cull_of(const float* row) {
  Cull k;
  k.mx = row[0];
  k.my = row[1];
  float a = row[2] * -2.0f, b = row[3] * -1.0f, c = row[4] * -2.0f;
  const bool pd = (a > 1e-12f) && (c > 1e-12f) && (a * c - b * b > 1e-12f);
  k.nba = pd ? -b / a : 0.0f;
  k.nbc = pd ? -b / c : 0.0f;
  // degenerate conics never cull (Q = 0)
  k.a = pd ? a : 0.0f;
  k.b = pd ? b : 0.0f;
  k.c = pd ? c : 0.0f;
  const float qthr = 2.0f * fmaxf(logf(255.0f * fmaxf(row[5], 1e-12f)), 0.0f);
  k.limit = qthr + CULL_SLACK * (qthr + 1.0f);
  k.sa = fabsf(k.a) + fabsf(k.b);
  k.sc = fabsf(k.b) + fabsf(k.c);
  return k;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Whether the instance can reach the sub-block whose top-left pixel is
// (x0, y0) in tile coordinates: rect_min_q's edges, in its operation order.
__device__ __forceinline__ bool reaches(const Cull& k, float x0, float y0) {
  const float lx = x0 - 1.0f - k.mx;
  const float hx = x0 + (float)SUB_W - k.mx;
  const float ly = y0 - 1.0f - k.my;
  const float hy = y0 + (float)SUB_H - k.my;
  const bool inside = (lx <= 0.0f) && (0.0f <= hx) && (ly <= 0.0f) && (0.0f <= hy);
  const float dyl = clampf(k.nbc * lx, ly, hy), dyh = clampf(k.nbc * hx, ly, hy);
  const float dxl = clampf(k.nba * ly, lx, hx), dxh = clampf(k.nba * hy, lx, hx);
  const float q_xl = k.a * lx * lx + 2.0f * k.b * lx * dyl + k.c * dyl * dyl;
  const float q_xh = k.a * hx * hx + 2.0f * k.b * hx * dyh + k.c * dyh * dyh;
  const float q_yl = k.a * dxl * dxl + 2.0f * k.b * dxl * ly + k.c * ly * ly;
  const float q_yh = k.a * dxh * dxh + 2.0f * k.b * dxh * hy + k.c * hy * hy;
  const float qmin = inside ? 0.0f : fminf(fminf(q_xl, q_xh), fminf(q_yl, q_yh));
  const float x = fmaxf(fabsf(lx), fabsf(hx)), y = fmaxf(fabsf(ly), fabsf(hy));
  const float terms = k.sa * (x * x) + k.sc * (y * y);
  return !(qmin > k.limit + CULL_EPS * terms);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group (the one just issued) is in flight
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copy of Gaussian g's feature row into `row` (48 bytes, both
// 16-byte aligned).
__device__ __forceinline__ void stage_row(float* row, const float* feat, int g) {
  const float* src = feat + (size_t)g * FEAT;
  cp_async16(row, src);
  cp_async16(row + 4, src + 4);
  cp_async16(row + 8, src + 8);
}

}  // namespace composite
