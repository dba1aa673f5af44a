// Instance expansion for tile binning (kernel K4), and the table kernel
// that builds its inputs from the projection's outputs.
//
// Replaces the TPU kernel `_expand_kernel_factory` of
// event3dgs_tpu/ops/expand.py (launched by `expand_instances` there) and,
// in the table kernel, the XLA code of event3dgs_tpu/ops/binning.py that
// builds its inputs (tile rects, instance counts, ellipse-cull data, the
// depth sort key, `bin_gaussians` there).  The depth order between the
// two (the sort, the counts' scan) is csrc/depth_sort.cu.
//
// 1. gaussian_table_kernel, one thread per Gaussian, in Gaussian order:
//    the tile rect (the radius rect of ops/binning.py `_tile_rect`
//    intersected with the alpha >= 1/255 box of `_alpha_bbox_half_extents`),
//    its instance count, the cull row of `gaussian_tables_plain` and the
//    sort key (the depth, +inf where the count is 0); the count again as a
//    column of its own, which the depth order reads through its order.
//    Every operation of the plain PyTorch version, in its order, rounded
//    once each (the library is built with -fmad=false and without fast
//    math: logf, sqrtf and `/` are the IEEE ones PyTorch's CUDA kernels
//    use); torch.clamp passes NaN through, and so does `clamp_nan` here.
//    It also clears the depth order's state (csrc/depth_sort.cu), as it
//    runs first.  Bound: bytes, 33 read and 56 written per Gaussian.
// 2. expand_kernel (K4), one block per SEGMENT instance slots (the counting
//    sort's segments, csrc/segment.cuh).  Every slot i < cap in depth order
//    gets its source Gaussian (the depth rank k whose range
//    [offsets[k], offsets[k+1]) holds i), its tile inside that Gaussian's
//    rect (row-major) and the exact per-tile ellipse cull of
//    ops/expand.py `rect_min_q`; dead slots (past the live total, or
//    culled) get the sentinels (num_tiles, n).  When `base` is given the
//    block also writes its segment's tile counts, the row
//    base[segment * num_tiles + tile] that the counting sort's scan reads
//    (csrc/sort_tiles.cu), for live segments only.
//    Design: the block loads the rank of the segment's first slot (the
//    depth offsets kernel wrote it) beside the live total, so the chain of
//    dependent loads before the expansion is three long: those two, each
//    rank's offsets and order entry, its table row.  From that rank, 1,024
//    ranks at a time until one starts past the segment, each rank with
//    instances reads its table row once, through `order`, into shared
//    memory at the position of its first slot in the segment, and marks
//    that position; an inclusive max-scan of the marks gives every slot the
//    position of its rank's row (a load-balancing search: no slot searches,
//    and any rank span works, since a position holds at most one rank).
//    Each thread then
//    expands 4 consecutive slots, repeating the plain version's tile and
//    cull arithmetic, counts them into the segment's shared tile row and
//    stores them with one 16-byte store per output.  A block past the live
//    total writes only its sentinels, with 16-byte stores.
//    Bound: bytes; per live rank its 48-byte table row, its order entry
//    and offset, per slot 8 bytes written, per live segment its count row.
//
// Timing-only builds of K4.  tools/kernel_probes.py builds this file with
// one of the macros below, each removing one cost term of the expansion
// named above, as experiments/tools_r5_expandprobe.py timed copies of the
// TPU kernel with a term isolated.  Without a macro each expands to the
// shipping code.  The ablated builds write wrong instances and have no
// plain version.  (The count-row term is the shipping build called
// without `base`.)
//   E3D_K4_NOCHAIN  the table rows are read at the rank, not through
//                   `order`: one link of the chain of dependent loads fewer
//   E3D_K4_NOSTAGE  no rank staging and no max-scan: every slot expands
//                   the segment's first rank's row
//   E3D_K4_NOCULL   no per-slot tile and cull arithmetic: a slot's tile is
//                   its row's position
//   E3D_K4_NOSTORE  no 16-byte output stores (the outputs are still
//                   consumed, behind a test no slot passes)

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

#include "segment.cuh"

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 32;
constexpr int TABLE_THREADS = 256;
constexpr int EXPAND_THREADS = 512;
constexpr int ITEMS = SEGMENT / EXPAND_THREADS;  // consecutive slots a thread
constexpr int RANK_ITEMS = 2;  // ranks a thread stages per pass
static_assert(ITEMS == 4, "a thread stores its slots as one int4");
constexpr int EXPAND_STATIC_LIMIT = 1024;  // static shared bytes, at most
// 2 * ln(255) rounded once to f32: `2.0 * np.log(255.0)` in
// `_alpha_bbox_half_extents` when there are no opacities
constexpr float T2_NO_OPACITY = 0x1.62a41p+3f;

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// `_tile_rect`'s bound: clamp(floor(v / size), 0, n) as int32 (a NaN
// converts to 0, as PyTorch's cast does on the card)
__device__ __forceinline__ int tile_bound(float v, float size, int n) {
  return (int)clamp_nan(floorf(v / size), 0.0f, (float)n);
}

__global__ void __launch_bounds__(TABLE_THREADS)
gaussian_table_kernel(const float* __restrict__ mean2d,   // [n, 2]
                      const float* __restrict__ conic,    // [n, 3] or null
                      const float* __restrict__ radius,   // [n]
                      const bool* __restrict__ valid,     // [n]
                      const float* __restrict__ opacity,  // [n] or null
                      const float* __restrict__ depth,    // [n]
                      int n, int tiles_x, int tiles_y, float one,
                      int4* __restrict__ rect,    // [n] x0, y0, rw, count
                      float4* __restrict__ cull,  // [n, 2] mx my ca cb | cc nba nbc qthr
                      float* __restrict__ key,    // [n]
                      int* __restrict__ count_out,  // [n]
                      unsigned* __restrict__ state, int state_words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // the depth order's state (csrc/depth_sort.cu), cleared here because
  // this kernel runs before it, every thread a share
  if (state != nullptr) {
    for (int w = i; w < state_words; w += gridDim.x * blockDim.x) state[w] = 0;
  }
  if (i >= n) return;
  const float mx = mean2d[2 * i], my = mean2d[2 * i + 1];
  const float r = radius[i];
  const float tw = (float)TILE_W, th = (float)TILE_H;
  // the radius rect
  int x0 = tile_bound(mx - r, tw, tiles_x);
  int y0 = tile_bound(my - r, th, tiles_y);
  int x1 = tile_bound(mx + r + tw - 1.0f, tw, tiles_x);
  int y1 = tile_bound(my + r + th - 1.0f, th, tiles_y);
  // qthr = 2 * clamp(log(255 * clamp(o, 1e-12)), 0); `one` (1.0f, an
  // argument so that the compiler cannot fold logf) where there are no
  // opacities, as torch.ones_like there
  const float o = opacity != nullptr ? opacity[i] : one;
  const float qthr =
      2.0f * clamp_min_nan(logf(255.0f * clamp_min_nan(o, 1e-12f)), 0.0f);
  float ca = 0.0f, cb = 0.0f, cc = 0.0f, nba = 0.0f, nbc = 0.0f;
  if (conic != nullptr) {
    ca = conic[3 * i];
    cb = conic[3 * i + 1];
    cc = conic[3 * i + 2];
    // the alpha >= 1/255 box: half extents sqrt(t2 * cov) + 1, or the
    // radius where the conic is degenerate
    const float det = ca * cc - cb * cb;
    const bool ok = det > 1e-12f;
    const float safe_det = ok ? det : 1.0f;
    const float t2 = opacity != nullptr ? qthr : T2_NO_OPACITY;
    const float wx = ok ? sqrtf(clamp_min_nan(t2 * cc / safe_det, 0.0f)) + 1.0f
                        : r;
    const float wy = ok ? sqrtf(clamp_min_nan(t2 * ca / safe_det, 0.0f)) + 1.0f
                        : r;
    x0 = max(x0, tile_bound(mx - wx, tw, tiles_x));
    y0 = max(y0, tile_bound(my - wy, th, tiles_y));
    x1 = min(x1, tile_bound(mx + wx + tw - 1.0f, tw, tiles_x));
    y1 = min(y1, tile_bound(my + wy + th - 1.0f, th, tiles_y));
    // the cull data; degenerate conics never cull (Q = 0 <= qthr)
    const bool pd = ca > 1e-12f && cc > 1e-12f && det > 1e-12f;
    nba = pd ? -cb / ca : 0.0f;
    nbc = pd ? -cb / cc : 0.0f;
    ca = pd ? ca : 0.0f;
    cb = pd ? cb : 0.0f;
    cc = pd ? cc : 0.0f;
  }
  const int rw = max(x1 - x0, 0);
  const int rh = max(y1 - y0, 0);
  const int count = valid[i] ? rw * rh : 0;
  rect[i] = make_int4(x0, y0, rw, count);
  count_out[i] = count;
  cull[2 * i] = make_float4(mx, my, ca, cb);
  cull[2 * i + 1] = make_float4(cc, nba, nbc, qthr);
  // zero-count Gaussians sort last
  key[i] = count > 0 ? depth[i] : __int_as_float(0x7f800000);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// The two edge quadratics of rect_min_q, in its operation order:
// on an x-edge e with clamped dy:  ((ca*e)*e + ((2*cb)*e)*dy) + (cc*dy)*dy
// on a y-edge e with clamped dx:   ((ca*dx)*dx + ((2*cb)*dx)*e) + (cc*e)*e
__device__ __forceinline__ float edge_x(float ca, float cb, float cc, float e,
                                        float dy) {
  return ca * e * e + 2.0f * cb * e * dy + cc * dy * dy;
}

__device__ __forceinline__ float edge_y(float ca, float cb, float cc, float e,
                                        float dx) {
  return ca * dx * dx + 2.0f * cb * dx * e + cc * e * e;
}

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

using MarkScan =
    cub::BlockScan<int, EXPAND_THREADS, cub::BLOCK_SCAN_WARP_SCANS>;

struct ExpandStatic {
  MarkScan::TempStorage scan;
  int first_offset;  // offsets[k] of the rank k of the segment's first slot
};
static_assert(sizeof(ExpandStatic) <= EXPAND_STATIC_LIMIT,
              "the launch plan counts at most EXPAND_STATIC_LIMIT static bytes");

// dynamic shared memory: the rows by position (int4 x0 y0 rw gaussian,
// then two float4 of cull data), the marks, and the tile counts
constexpr int ROW_BYTES = 48;
constexpr int MARK_BYTES = 4;
constexpr int SEGMENT_SHARED = SEGMENT * (ROW_BYTES + MARK_BYTES);

__global__ void __launch_bounds__(EXPAND_THREADS, 2)
expand_kernel(const int4* __restrict__ rect,     // [n] x0, y0, rw, count
              const float4* __restrict__ cull,   // [n, 2]
              const int* __restrict__ offsets,   // [n + 1] by depth rank
              const int* __restrict__ order,     // [n] gaussian per rank
              const int* __restrict__ seg_rank,  // [segments] first slots' ranks
              int n, int cap, int tiles_x, int num_tiles,
              int* __restrict__ tile_out, int* __restrict__ gauss_out,
              int* __restrict__ base) {          // count rows, or null
  __shared__ ExpandStatic st;
  extern __shared__ int4 dyn[];
  int4* row_i = dyn;                                           // [SEGMENT]
  float4* row_f = reinterpret_cast<float4*>(dyn + SEGMENT);    // [2 SEGMENT]
  int* mark = reinterpret_cast<int*>(dyn + 3 * SEGMENT);       // [SEGMENT]
  int* bins = mark + SEGMENT;                                  // [num_tiles]

  const int tid = threadIdx.x;
  const int start = blockIdx.x * SEGMENT;
  const int len = min(SEGMENT, cap - start);  // a multiple of 4
  // the live total and the rank of the segment's first slot, loaded
  // together (the rank is written for live segments only)
  const int raw_total = offsets[n];
  const int r0 = seg_rank[blockIdx.x];
  const int total = min(raw_total, cap);
  if (start >= total) {
    const int4 t4 = make_int4(num_tiles, num_tiles, num_tiles, num_tiles);
    const int4 g4 = make_int4(n, n, n, n);
    int4* t = reinterpret_cast<int4*>(tile_out + start);
    int4* g = reinterpret_cast<int4*>(gauss_out + start);
    for (int q = tid; q < len / 4; q += EXPAND_THREADS) {
      t[q] = t4;
      g[q] = g4;
    }
    return;
  }
  const int end = min(start + SEGMENT, total);  // live slots [start, end)
  for (int q = tid; q < SEGMENT; q += EXPAND_THREADS) mark[q] = 0;
  if (base != nullptr) {
    for (int b = tid; b < num_tiles; b += EXPAND_THREADS) bins[b] = 0;
  }
#ifdef E3D_K4_NOSTAGE
  if (tid == 0) {
    const int g0 = order[r0];
    row_i[0] = make_int4(rect[g0].x, rect[g0].y, rect[g0].z, g0);
    row_f[0] = cull[2 * g0];
    row_f[1] = cull[2 * g0 + 1];
    st.first_offset = offsets[r0];
  }
  __syncthreads();
  int pos[ITEMS] = {0, 0, 0, 0};
#else
  __syncthreads();
  // every rank with instances in the segment, RANK_ITEMS * EXPAND_THREADS
  // at a time from the first one until a rank starts past it (one pass for
  // a segment of up to 1,024 ranks): its row at the position of its first
  // slot here (the first rank's range starts at or before the segment,
  // every later one inside it)
  for (int k0 = r0;; k0 += RANK_ITEMS * EXPAND_THREADS) {
    int o[RANK_ITEMS], o1[RANK_ITEMS], g[RANK_ITEMS];
#pragma unroll
    for (int j = 0; j < RANK_ITEMS; ++j) {
      const int k = k0 + j * EXPAND_THREADS + tid;
      const bool in = k < n;
      o[j] = in ? offsets[k] : total;
      o1[j] = in ? offsets[k + 1] : total;
#ifdef E3D_K4_NOCHAIN
      g[j] = in ? k : 0;
#else
      g[j] = in ? order[k] : 0;
#endif
    }
    bool here[RANK_ITEMS];  // the rank has instances in the segment
    int4 ri[RANK_ITEMS];
    float4 c0[RANK_ITEMS], c1[RANK_ITEMS];
#pragma unroll
    for (int j = 0; j < RANK_ITEMS; ++j) {  // the rows' loads side by side
      here[j] = o[j] < end && o1[j] > o[j];
      if (here[j]) {
        ri[j] = rect[g[j]];
        c0[j] = cull[2 * g[j]];
        c1[j] = cull[2 * g[j] + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < RANK_ITEMS; ++j) {
      if (here[j]) {
        const int p = max(o[j], start) - start;
        row_i[p] = make_int4(ri[j].x, ri[j].y, ri[j].z, g[j]);
        row_f[2 * p] = c0[j];
        row_f[2 * p + 1] = c1[j];
        mark[p] = p;
        if (p == 0) st.first_offset = o[j];
      }
    }
    // ranks start in order: the pass's last one says whether more follow
    if (!__syncthreads_or(tid == EXPAND_THREADS - 1 &&
                          o1[RANK_ITEMS - 1] < end)) {
      break;
    }
  }

  // each slot's row: the last mark at or before it
  const int4 m4 = reinterpret_cast<const int4*>(mark)[tid];
  int pos[ITEMS] = {m4.x, m4.y, m4.z, m4.w};
  MarkScan(st.scan).InclusiveScan(pos, pos, MaxOp());
#endif
  const int first_offset = st.first_offset;
  int tile[ITEMS], gauss[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int i = start + ITEMS * tid + q;
    tile[q] = num_tiles;
    gauss[q] = n;
    if (i >= end) continue;
    const int p = pos[q];
    const int4 ri = row_i[p];
#ifdef E3D_K4_NOCULL
    tile[q] = p;
    gauss[q] = ri.w;
    continue;
#endif
    const float4 c0 = row_f[2 * p], c1 = row_f[2 * p + 1];
    const int j = i - (p == 0 ? first_offset : start + p);
    const int rw = max(ri.z, 1);
    const int tx = ri.x + j % rw;
    const int ty = ri.y + j / rw;
    const float mx = c0.x, my = c0.y, ca = c0.z, cb = c0.w;
    const float cc = c1.x, nba = c1.y, nbc = c1.z, qthr = c1.w;
    const float px0 = (float)(tx * TILE_W);
    const float py0 = (float)(ty * TILE_H);
    const float lx = px0 - 1.0f - mx;
    const float hx = px0 + (float)TILE_W - mx;
    const float ly = py0 - 1.0f - my;
    const float hy = py0 + (float)TILE_H - my;
    const bool inside =
        (lx <= 0.0f) && (0.0f <= hx) && (ly <= 0.0f) && (0.0f <= hy);
    const float q_xl = edge_x(ca, cb, cc, lx, clampf(nbc * lx, ly, hy));
    const float q_xh = edge_x(ca, cb, cc, hx, clampf(nbc * hx, ly, hy));
    const float q_yl = edge_y(ca, cb, cc, ly, clampf(nba * ly, lx, hx));
    const float q_yh = edge_y(ca, cb, cc, hy, clampf(nba * hy, lx, hx));
    const float qmin =
        inside ? 0.0f : fminf(fminf(q_xl, q_xh), fminf(q_yl, q_yh));
    if (qmin <= qthr) {
      tile[q] = ty * tiles_x + tx;
      gauss[q] = ri.w;
    }
  }
#ifdef E3D_K4_NOSTORE
  // a slot's tile and Gaussian are never negative: no thread stores
  if ((tile[0] ^ tile[1] ^ tile[2] ^ tile[3] ^ gauss[0] ^ gauss[1] ^ gauss[2] ^
       gauss[3]) == (int)0x80000000 && ITEMS * tid < len) {
    tile_out[start + ITEMS * tid] = gauss[0];
  }
#else
  if (ITEMS * tid < len) {
    reinterpret_cast<int4*>(tile_out + start)[tid] =
        make_int4(tile[0], tile[1], tile[2], tile[3]);
    reinterpret_cast<int4*>(gauss_out + start)[tid] =
        make_int4(gauss[0], gauss[1], gauss[2], gauss[3]);
  }
#endif
  if (base == nullptr) return;
  // integer atomics only form a count, whose value does not depend on
  // their order
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    if ((unsigned)tile[q] < (unsigned)num_tiles) atomicAdd(&bins[tile[q]], 1);
  }
  __syncthreads();
  int* row = base + (size_t)blockIdx.x * num_tiles;
  for (int b = tid; b < num_tiles; b += EXPAND_THREADS) row[b] = bins[b];
}

// Let the expansion kernel use the card's opt-in shared memory and prefer
// shared memory over L1; once (a function-local static is initialised
// once).
cudaError_t allow_shared_once() {
  static const cudaError_t err = [] {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, expand_kernel);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute((const void*)expand_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
    }
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute((const void*)expand_kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  return err;
}

}  // namespace

// The per-Gaussian tables (conic and opacity may be null); state (or
// null): the depth order's state_words words, cleared.
extern "C" int e3d_gaussian_tables(const float* mean2d, const float* conic,
                                   const float* radius, const bool* valid,
                                   const float* opacity, const float* depth,
                                   int n, int tiles_x, int tiles_y,
                                   void* rect_out, void* cull_out,
                                   float* key_out, void* state,
                                   int* count_out, int state_words,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + TABLE_THREADS - 1) / TABLE_THREADS;
  gaussian_table_kernel<<<blocks, TABLE_THREADS, 0, stream>>>(
      mean2d, conic, radius, valid, opacity, depth, n, tiles_x, tiles_y, 1.0f,
      static_cast<int4*>(rect_out), static_cast<float4*>(cull_out), key_out,
      count_out, static_cast<unsigned*>(state), state_words);
  return (int)cudaGetLastError();
}

// K4: (tile, gaussian) per slot of [0, cap) (cap a multiple of 4) and, when
// base is given, each live segment's tile counts into
// base[segment * num_tiles + tile].
extern "C" int e3d_expand_instances(const void* rect, const void* cull,
                                    const int* offsets, const int* order,
                                    const int* seg_rank, int n, int cap,
                                    int tiles_x,
                                    int num_tiles, int* tile_out,
                                    int* gauss_out, int* base,
                                    cudaStream_t stream) {
  if (cap <= 0) return 0;
  if (cap % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_shared_once();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (cap + SEGMENT - 1) / SEGMENT;
  const size_t shared =
      SEGMENT_SHARED + (base != nullptr ? sizeof(int) * (size_t)num_tiles : 0);
  expand_kernel<<<blocks, EXPAND_THREADS, shared, stream>>>(
      static_cast<const int4*>(rect), static_cast<const float4*>(cull),
      offsets, order, seg_rank, n, cap, tiles_x, num_tiles, tile_out,
      gauss_out, base);
  return (int)cudaGetLastError();
}

// (registers per thread, resident blocks per SM) of the expansion kernel
// with the shared memory of a launch over num_tiles tiles (0: without the
// count rows)
extern "C" int e3d_expand_occupancy(int* regs, int* blocks_per_sm,
                                    int num_tiles) {
  cudaError_t err = allow_shared_once();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, expand_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, expand_kernel, EXPAND_THREADS,
      SEGMENT_SHARED + sizeof(int) * (size_t)num_tiles);
}
