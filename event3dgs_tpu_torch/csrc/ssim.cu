// The rgb and gray modes' training loss, (1-λ)·L1 + λ·(1-SSIM), forward
// and backward: one kernel each way.
//
// Replaces no Pallas kernel.  In the JAX package the render's composition
// over the background (event3dgs_tpu/ops/render.py:122), the GT pick
// (event3dgs_tpu/train/step.py:115) and `rgb_total_loss` /
// `gray_total_loss` (event3dgs_tpu/losses/modes.py:16-31, on top of
// losses/basic.py:71-117: five separable Gaussian blurs of two
// convolutions each, then the SSIM map) run inside the jitted train step,
// where XLA fuses the elementwise work around the convolutions.  In plain
// PyTorch the same work is about 100 image-sized launches and 16
// convolutions a step.  Here it is one launch each way.
//
// The operands.  The render comes as its image [P, 3], or as the
// rasterizer's partials rgb [P, 3] and log T [P], which the kernels compose
// over the background bg [3] on load, as `ops/render.composed` does:
// image = rgb + expf(log T)·bg (the product, then the sum).  The GT comes
// as its image [P, C_gt], or as a stack of frames and a [1] int64 device
// index: the kernels read the frame where it lies (an index outside the
// stack traps).  P = H·W pixels, row-major.
//
// The images compared.  rgb mode: x = the image, y = the GT (3 channels
// each, C = 3).  gray mode: the luma of each, (x*w).sum(-1) in PyTorch's
// CUDA order for 3 contiguous values, ((0 + x0·w0) + (0 + x2·w2)) +
// (0 + x1·w1); a one-channel GT is its own luma (C = 1).
//
// The SSIM map (losses/basic.ssim_terms).  B is the separable 11-tap
// Gaussian blur with zero ("same") padding, vertical then horizontal, each
// pass an ordered sum over the taps t = 0..10 of g[t]·z[i + t - 5] (the
// first product, then one sum a tap).  Per channel:
//
//   mx = B(x)   my = B(y)   exx = B(x·x)   eyy = B(y·y)   exy = B(x·y)
//   A1 = 2·(mx·my) + C1          A2 = 2·(exy - mx·my) + C2
//   B1 = (mx·mx + my·my) + C1    B2 = ((exx - mx·mx) + (eyy - my·my)) + C2
//   d  = B1·B2                   m  = (A1·A2) / d
//
// and, where a gradient is wanted, its derivatives by mx, exx and exy,
// written as three maps [3, P, C]:
//
//   D_mu = ((2·my)·(A2 - A1) - ((2·mx)·m)·(B2 - B1)) / d
//   D_xx = -(m / B2)             D_xy = (2·A1) / d
//
// Forward: the sums of |x - y| and of m over the N = P·C values, then
//
//   l1   = Σ|x - y|·(1/N)      ssim = Σm·(1/N)
//   loss = (1-λ)·l1 + λ·(1 - ssim)        (λ = 0: (1-λ)·l1, no SSIM work)
//
// Backward, from the loss's gradient G (a device float): g_l1 =
// (G·(1-λ))·(1/N), g_ssim = (G·λ)·(1/N), and per value
//
//   dx = g_l1·sgn(x - y) - g_ssim·((B(D_mu) + (2·x)·B(D_xx)) + y·B(D_xy))
//
// (sgn 0 at a tie, as torch.sgn; B is its own adjoint: the window is
// symmetric and the padding zero).  gray mode spreads dx over the three
// channels by the luma weights, dx·w_c.  The image's gradient goes to d rgb
// (or d image), and where the render came as partials d log T =
// (((0 + g0·bg0) + (0 + g2·bg2)) + (0 + g1·bg1))·expf(log T)
// (block_sums.cuh's logt_grad, as the event loss writes it).
//
// Every product, quotient, sum and difference is an explicit
// round-to-nearest intrinsic in that order, so nothing fuses into an FMA
// whatever the flags: the maps and the gradients equal the plain version's
// (losses/modes.photometric_loss_plain and photometric_loss_backward_plain)
// bit for bit.  The constants (the window, the luma weights, C1, C2, 1-λ,
// λ, 1/N) come rounded to float32 from the host.  `expf` is the CUDA math
// library's, as PyTorch's `exp`.
//
// The design (the forward's bound is issue slots: at it every FP32 lane
// runs a blur tap each clock, so loads, index arithmetic and selects cost
// on top; the backward's is bytes).  A block per output tile 54 pixels
// wide: 32 rows in the rgb forward (256 threads), 16 in the gray forward
// and in the backward (128 threads).  The block stages the tile and a
// 5-pixel halo, 64 × (rows + 10) pixels, of x and y (forward; composed
// and, in gray mode, converted to luma on load) or of the three maps
// (backward) in dynamic shared memory, zero outside the image, every load
// of a thread issued before any is used.  Then per channel (a kernel
// template instance per channel count, 3 or 1):
//
// - the vertical pass, register-blocked: a thread owns one staged column
//   and a strip of 8 output rows (64 columns × rows / 8 strips), reads
//   the 18 staged values it needs once, forms x², y² and xy once per staged
//   row, and streams them into its 8 × 5 running sums (a staged row s adds
//   tap s - r to output row r, so each sum still runs t = 0..10 in order);
// - the horizontal pass, register-blocked the same way: a thread owns 7
//   adjacent outputs of one row (8 chunks a row; the last chunk's two
//   outputs past the tile read zeros and are not kept) and reads the 17
//   vertical sums of each moment once.  The vertical sums' rows are 72
//   floats apart, so a warp's 4 rows × 8 chunks read 32 banks.
//
// The forward computes every output of a chunk without a branch (the
// divisions of its 7 outputs interleave) and sums |x - y| and the map
// where kept, in float per thread (at most 21 terms), then in double; it
// keeps each channel's three derivative maps of the tile in the shared
// memory that channel's x and y were staged in (free once its horizontal
// pass has read them), counts its sums in, and then writes the maps a warp
// a row, [x0, x0 + 54) × C floats contiguous in each map, so no fence
// waits for them.  The backward keeps each channel's blurred maps where
// that channel's maps were staged, then a warp a row, a lane a value,
// loads the render and the GT, composes and writes d rgb (or d image),
// then d log T a lane a pixel: every global access coalesced.  Shared
// memory: rgb forward 110,736 bytes (2 blocks an SM), backward 73,728
// (3); gray 36,432 and 33,792 (5 each, by registers).  The forward's
// scalar sums are block_sums.cuh's: block partials in double, the last
// block to arrive adds them in block order (its own arrival counter); the
// tile shape sets the partition, so the loss and l1 round as the plain
// version's within 1e-5 and the same in every run.  No host read, no host
// copy: the operands' pointers and the constants go by value in the
// kernels' parameters, so a CUDA graph captures the launches whole.  Two
// launches of the forward must not run at once (on two streams): they
// would share its counter.
//
// Bound (tools/kernel_timing.photometric_bound): the forward reads the
// render and the GT once and writes the maps (16 floats a pixel at 1080p
// rgb from partials), the backward reads them all again and writes the
// gradients (20 floats a pixel); the forward's blurs are most of the
// operations.

#include <cuda_runtime.h>

#include <stdint.h>

#include "block_sums.cuh"

// Timing-only builds (tools/kernel_probes.SSIM_VARIANTS), no plain version:
// E3D_SSIM_NOSTAGE stages zeros (no halo loaded or composed), E3D_SSIM_NOVERT
// and E3D_SSIM_NOHORIZ copy the centre tap instead of summing 11,
// E3D_SSIM_NOSTORE computes the maps (forward) and the gradients (backward)
// but never stores them.
#ifdef E3D_SSIM_NOSTORE
#define E3D_SSIM_STORE(dst, v)                                        \
  do {                                                                \
    const float v_ = (v);                                             \
    if (__float_as_uint(v_) == 0x7fc00001u) (dst) = v_;               \
  } while (0)
#else
#define E3D_SSIM_STORE(dst, v) ((dst) = (v))
#endif

namespace {

constexpr int WIN = 11;  // the window's taps
constexpr int HALO = WIN / 2;
constexpr int TW = 54;                // output tile: TW × TH pixels
constexpr int SW = TW + 2 * HALO;     // staged columns
constexpr int STRIP = 8;              // vertical pass: output rows a thread
constexpr int CHUNK = 7;              // horizontal pass: outputs a thread
constexpr int CHUNKS = (TW + CHUNK - 1) / CHUNK;  // horizontal: a row's
constexpr int VROW = 72;  // floats from one vertical-sum row to the next
constexpr int SKEW = 11;  // channel c's maps start c·SKEW floats into its slot
constexpr int MOMENTS = 5;  // mx, my, exx, eyy, exy
constexpr int MAPS = 3;     // D_mu, D_xx, D_xy
constexpr int N_SUMS = 2;   // |x - y|, m
constexpr int N_CONSTS = WIN + 3 + 5;  // floats of Consts, in its order
constexpr int N_OPERANDS = 5;
constexpr int N_SIZES = 3;
static_assert(N_OPERANDS == 5 && N_SIZES == 3 && N_CONSTS == 19,
              "the host's arrays: losses/modes._photometric_launch");
static_assert(VROW >= CHUNKS * CHUNK + WIN - 1 && VROW % 32 == 8,
              "the horizontal pass's reads: in the row, on 32 banks");

// A tile of TW × R output pixels and the block that works it: SW columns
// of R / STRIP strips in the vertical pass, R rows of CHUNKS chunks in the
// horizontal one, a thread an item of each.
template <int R>
struct Tile {
  static constexpr int TH = R;
  static constexpr int SH = TH + 2 * HALO;  // staged rows
  static constexpr int PLANE = SW * SH;     // floats of one staged plane
  static constexpr int THREADS = SW * (TH / STRIP);
  static constexpr int STAGED = (PLANE + THREADS - 1) / THREADS;  // a thread's
  static_assert(TH % STRIP == 0 && THREADS == TH * CHUNKS && THREADS % 32 == 0,
                "both passes give every thread one item");
  static_assert(MAPS * TH * TW + 2 * SKEW <= 2 * PLANE,
                "a channel's maps fit where its x and y were staged");
  static_assert(MAPS * TH * TW + 2 * SKEW <= MAPS * PLANE,
                "a channel's blurred maps fit where its maps were staged");
  static_assert(TH * TW * 3 <= MAPS * TH * VROW,
                "d rgb fits where the vertical sums were");
};

// The forward's tile: rgb 54 × 32 (256 threads; its shared memory lets 2
// blocks on an SM), gray 54 × 16 (128 threads, 5 blocks); the backward's
// 54 × 16 in both modes (3 blocks in rgb mode, 5 in gray).
template <int C>
using ForwardTile = Tile<C == 3 ? 32 : 16>;
using BackwardTile = Tile<16>;

// floats of dynamic shared memory a launch takes with λ > 0
template <int C>
constexpr int forward_floats() {
  using T = ForwardTile<C>;
  return C * 2 * T::PLANE + MOMENTS * T::TH * VROW;
}
template <int C>
constexpr int backward_floats() {
  using T = BackwardTile;
  return C * MAPS * T::PLANE + MAPS * T::TH * VROW;
}

struct Consts {
  float g[WIN];  // the window
  float w[3];    // the luma weights
  float c1, c2;
  float l1_w;    // 1 - λ
  float lam;     // λ
  float inv_n;   // 1 / N
};
static_assert(sizeof(Consts) == N_CONSTS * sizeof(float), "Consts' floats");

struct Operands {
  const float* rgb;        // [P, 3]: the partial rgb, or the image
  const float* logt;       // [P] log T, or null: rgb is the image
  const float* bg;         // [3], or null without log T
  const float* gt;         // the GT frame, or the stack of frames
  const long long* index;  // [1] on the device, or null: gt is the frame
  long long frames;        // frames in the stack
  long long stride;        // floats from one frame to the next
  int gt_ch;               // 1 or 3 (3 in rgb mode)
  int ch;                  // C: 3 in rgb mode, 1 in gray mode
  int height, width;
};

__device__ unsigned int forward_arrivals = 0;

// the GT frame: its image, or frame *index of its stack (an index outside
// the stack traps: the host cannot read it to refuse it)
__device__ __forceinline__ const float* gt_frame(const Operands& o) {
  if (o.index == nullptr) return o.gt;
  const long long i = *o.index;
  if (i < 0 || i >= o.frames) __trap();
  return o.gt + i * o.stride;
}

// (x * w).sum(-1) of one pixel, in PyTorch's CUDA order
__device__ __forceinline__ float luma(const float (&x)[3], const Consts& k) {
  const float a0 = __fadd_rn(0.0f, __fmul_rn(x[0], k.w[0]));
  const float a1 = __fadd_rn(0.0f, __fmul_rn(x[1], k.w[1]));
  const float a2 = __fadd_rn(0.0f, __fmul_rn(x[2], k.w[2]));
  return __fadd_rn(__fadd_rn(a0, a2), a1);
}

// a pixel's operands as they lie in memory: the render's rgb (or image),
// its log T (0 without), the GT's 1 or 3 channels
struct Raw {
  float rgb[3], logt, gt[3];
};

// the operands of pixels p[0..N) into r, every load issued before any is
// used (the branches are the launch's, the same in every thread)
template <int N>
__device__ __forceinline__ void load_raw(const Operands& o,
                                         const float* __restrict__ gt,
                                         const long long (&p)[N],
                                         Raw (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) r[i].rgb[c] = o.rgb[3 * p[i] + c];
  }
  if (o.logt != nullptr) {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i].logt = o.logt[p[i]];
  }
  if (o.gt_ch == 3) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) r[i].gt[c] = gt[3 * p[i] + c];
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i].gt[0] = gt[p[i]];
  }
}

// the values compared at a pixel from its operands: x (the render's image,
// composed over the background where it comes as partials, with expf(log
// T) in e) and y (the GT), both converted to luma in gray mode (in [0])
__device__ __forceinline__ void compose(const Operands& o, const Raw& r,
                                        const float (&bg)[3],
                                        const Consts& k, float (&x)[3],
                                        float (&y)[3], float& e) {
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = r.rgb[c];
  if (o.logt != nullptr) {
    e = expf(r.logt);
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = __fadd_rn(x[c], __fmul_rn(e, bg[c]));
  }
  if (o.gt_ch == 3) {
#pragma unroll
    for (int c = 0; c < 3; ++c) y[c] = r.gt[c];
  } else {
    y[0] = r.gt[0];
    y[1] = y[2] = 0.0f;
  }
  if (o.ch == 1) {
    x[0] = luma(x, k);
    if (o.gt_ch == 3) y[0] = luma(y, k);
  }
}

__device__ __forceinline__ void load_bg(const Operands& o, float (&bg)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) bg[c] = o.bg != nullptr ? o.bg[c] : 0.0f;
}

struct SsimPixel {
  float m, d_mu, d_xx, d_xy;
};

// the SSIM map and its three derivatives from the blurred moments
__device__ __forceinline__ SsimPixel ssim_pixel(const float (&mo)[MOMENTS],
                                                const Consts& k) {
  const float mx = mo[0], my = mo[1];
  const float mx2 = __fmul_rn(mx, mx), my2 = __fmul_rn(my, my);
  const float mxy = __fmul_rn(mx, my);
  const float sx = __fsub_rn(mo[2], mx2), sy = __fsub_rn(mo[3], my2);
  const float sxy = __fsub_rn(mo[4], mxy);
  const float a1 = __fadd_rn(__fmul_rn(2.0f, mxy), k.c1);
  const float a2 = __fadd_rn(__fmul_rn(2.0f, sxy), k.c2);
  const float b1 = __fadd_rn(__fadd_rn(mx2, my2), k.c1);
  const float b2 = __fadd_rn(__fadd_rn(sx, sy), k.c2);
  const float d = __fmul_rn(b1, b2);
  SsimPixel s;
  s.m = __fdiv_rn(__fmul_rn(a1, a2), d);
  s.d_mu = __fdiv_rn(
      __fsub_rn(__fmul_rn(__fmul_rn(2.0f, my), __fsub_rn(a2, a1)),
                __fmul_rn(__fmul_rn(__fmul_rn(2.0f, mx), s.m),
                          __fsub_rn(b2, b1))),
      d);
  s.d_xx = -__fdiv_rn(s.m, b2);
  s.d_xy = __fdiv_rn(__fmul_rn(2.0f, a1), d);
  return s;
}

// tap t of the ordered blur sum: the first product, then one sum a tap (t
// is known when the loops are unrolled, so the choice costs nothing)
__device__ __forceinline__ float tap(float acc, int t, float g, float z) {
  const float p = __fmul_rn(g, z);
  return t == 0 ? p : __fadd_rn(acc, p);
}

// The vertical pass of N quantities over the staged planes `in` (N planes
// of T::SH × SW, or for the forward's moments the planes x and y, from which
// the five moments are formed per staged row) into `out` [N][T::TH][VROW]: a
// thread one staged column, STRIP output rows.
template <class T, int N, bool MOMENT>
__device__ __forceinline__ void vertical_pass(const float* __restrict__ in,
                                              float* __restrict__ out,
                                              const Consts& k, int tid) {
  const int c = tid % SW, r0 = (tid / SW) * STRIP;
  float acc[STRIP][N] = {};
#pragma unroll
  for (int s = 0; s < STRIP + WIN - 1; ++s) {
    float z[N];
    const int q = (r0 + s) * SW + c;
    if constexpr (MOMENT) {
      const float xv = in[q], yv = in[T::PLANE + q];
      z[0] = xv;
      z[1] = yv;
      z[2] = __fmul_rn(xv, xv);
      z[3] = __fmul_rn(yv, yv);
      z[4] = __fmul_rn(xv, yv);
    } else {
#pragma unroll
      for (int m = 0; m < N; ++m) z[m] = in[m * T::PLANE + q];
    }
#pragma unroll
    for (int r = 0; r < STRIP; ++r) {
      const int t = s - r;
      if (t < 0 || t >= WIN) continue;
#pragma unroll
      for (int m = 0; m < N; ++m) {
#ifdef E3D_SSIM_NOVERT
        if (t == HALO) acc[r][m] = z[m];
#else
        acc[r][m] = tap(acc[r][m], t, k.g[t], z[m]);
#endif
      }
    }
  }
#pragma unroll
  for (int r = 0; r < STRIP; ++r) {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      out[(m * T::TH + r0 + r) * VROW + c] = acc[r][m];
    }
  }
}

// The horizontal pass of N quantities of `in` [N][T::TH][VROW] for CHUNK
// adjacent outputs of row `row` from tile column `c0`: acc[j] = the blurred
// quantities of output c0 + j (the outputs past the tile are garbage)
template <class T, int N>
__device__ __forceinline__ void horizontal_pass(const float* __restrict__ in,
                                                int row, int c0,
                                                const Consts& k,
                                                float (&acc)[CHUNK][N]) {
#pragma unroll
  for (int s = 0; s < CHUNK + WIN - 1; ++s) {
    float z[N];
#pragma unroll
    for (int m = 0; m < N; ++m) z[m] = in[(m * T::TH + row) * VROW + c0 + s];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int t = s - j;
      if (t < 0 || t >= WIN) continue;
#pragma unroll
      for (int m = 0; m < N; ++m) {
#ifdef E3D_SSIM_NOHORIZ
        if (t == HALO) acc[j][m] = z[m];
#else
        acc[j][m] = tap(acc[j][m], t, k.g[t], z[m]);
#endif
      }
    }
  }
}

// Each kernel's resident blocks an SM, which bound its registers: rgb's
// as many as its shared memory lets (2 forward, 3 backward), gray's 5.
// Staging issues the loads of a batch of pixels before it uses any: every
// pixel at once where the registers allow, else two rounds.
template <int C, bool BACKWARD>
constexpr int MIN_BLOCKS = C == 1 ? 5 : (BACKWARD ? 3 : 2);
template <class T, int C, bool BACKWARD>
constexpr int STAGE_BATCH = C == 3 || BACKWARD ? T::STAGED : 7;

// the pixel index of staged pixel q (row-major over SH × SW from (y0 - HALO,
// x0 - HALO)), 0 outside the image (read, then not used), and whether it
// lies in the image
__device__ __forceinline__ long long staged_pixel(const Operands& o, int q,
                                                  int x0, int y0, bool& in) {
  const int gi = y0 - HALO + q / SW, gj = x0 - HALO + q % SW;
  in = gi >= 0 && gi < o.height && gj >= 0 && gj < o.width;
  return in ? static_cast<long long>(gi) * o.width + gj : 0;
}

// the tile's and its halo's x and y (C channels, planes [C][2][SH][SW]),
// composed and converted on load, zero outside the image; every load
// issued before any is used
template <class T, int C>
__device__ __forceinline__ void stage_images(const Operands& o,
                                             const float* __restrict__ gt,
                                             const float (&bg)[3],
                                             const Consts& k, float* st,
                                             int x0, int y0, int tid) {
  constexpr int BATCH = STAGE_BATCH<T, C, false>;
#pragma unroll
  for (int b = 0; b < T::STAGED; b += BATCH) {
    long long p[BATCH];
    bool in[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      p[i] = staged_pixel(o, tid + (b + i) * T::THREADS, x0, y0, in[i]);
    }
    Raw r[BATCH];
#ifndef E3D_SSIM_NOSTAGE
    load_raw(o, gt, p, r);
#endif
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int q = tid + (b + i) * T::THREADS;
      if (b + i >= T::STAGED || (T::PLANE % T::THREADS && q >= T::PLANE)) {
        break;
      }
      float x[3] = {0.0f, 0.0f, 0.0f}, y[3] = {0.0f, 0.0f, 0.0f}, e = 0.0f;
#ifndef E3D_SSIM_NOSTAGE
      if (in[i]) compose(o, r[i], bg, k, x, y, e);
#endif
#pragma unroll
      for (int c = 0; c < C; ++c) {
        st[(2 * c) * T::PLANE + q] = x[c];
        st[(2 * c + 1) * T::PLANE + q] = y[c];
      }
    }
  }
}

// the tile's and its halo's three maps (C channels, planes
// [C][MAPS][SH][SW]), zero outside the image; the loads of BATCH pixels
// issued before any is used
template <class T, int C>
__device__ __forceinline__ void stage_maps(const Operands& o,
                                           const float* __restrict__ maps,
                                           float* st, int x0, int y0,
                                           int tid) {
  constexpr int BATCH = STAGE_BATCH<T, C, true>;
  const long long plane = static_cast<long long>(o.height) * o.width * C;
#pragma unroll
  for (int b = 0; b < T::STAGED; b += BATCH) {
    float v[BATCH][C][MAPS];
    bool in[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const long long p =
          staged_pixel(o, tid + (b + i) * T::THREADS, x0, y0, in[i]) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int m = 0; m < MAPS; ++m) {
#ifdef E3D_SSIM_NOSTAGE
          v[i][c][m] = 0.0f;
#else
          v[i][c][m] = maps[m * plane + p + c];
#endif
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int q = tid + (b + i) * T::THREADS;
      if (b + i >= T::STAGED || (T::PLANE % T::THREADS && q >= T::PLANE)) {
        break;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int m = 0; m < MAPS; ++m) {
          st[(c * MAPS + m) * T::PLANE + q] = in[i] ? v[i][c][m] : 0.0f;
        }
      }
    }
  }
}

// whether output j of this thread's chunk is a pixel of the tile and of
// the image
__device__ __forceinline__ bool kept(const Operands& o, int x0, int gi,
                                     int hc, int j) {
  return hc + j < TW && gi < o.height && x0 + hc + j < o.width;
}

// the pixel indices of this thread's outputs, 0 for those it does not
// keep (read, then not used)
__device__ __forceinline__ void own_pixels(const Operands& o, int x0, int gi,
                                           int hc, long long (&p)[CHUNK]) {
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    p[j] = kept(o, x0, gi, hc, j)
               ? static_cast<long long>(gi) * o.width + x0 + hc + j
               : 0;
  }
}

// the vertical sums' columns past the staged ones, [N][TH][SW, VROW): zero
// (the last chunk's outputs past the tile read them)
template <class T, int N>
__device__ __forceinline__ void zero_padding(float* vs, int tid) {
  constexpr int PAD = VROW - SW;
  for (int i = tid; i < N * T::TH * PAD; i += T::THREADS) {
    vs[(i / PAD) * VROW + SW + i % PAD] = 0.0f;
  }
}

// The forward of one tile with C channels: the sums of |x - y| and of the
// map over this thread's outputs into v, and the tile's derivative maps,
// written to `maps` row by row.
template <int C>
__global__ void __launch_bounds__(ForwardTile<C>::THREADS,
                                  (MIN_BLOCKS<C, false>))
    photometric_loss_forward_kernel(const Operands o, const Consts k,
                                    double* __restrict__ partials,
                                    float* __restrict__ loss_out,
                                    float* __restrict__ l1_out,
                                    float* __restrict__ maps) {
  using T = ForwardTile<C>;
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * T::TH;
  // the horizontal pass's outputs: row hy, columns hc .. hc + CHUNK - 1
  const int hy = tid / CHUNKS, hc = (tid % CHUNKS) * CHUNK;
  const int gi = y0 + hy;
  float bg[3];
  load_bg(o, bg);
  const float* gt = gt_frame(o);
  double v[N_SUMS] = {0.0, 0.0};
  if (k.lam > 0.0f) {
    float* vs = sm + C * 2 * T::PLANE;
    zero_padding<T, MOMENTS>(vs, tid);
    stage_images<T, C>(o, gt, bg, k, sm, x0, y0, tid);
    __syncthreads();
    // this thread's sums, in float (at most 21 terms), then in double
    float s_abs = 0.0f, s_m = 0.0f;
#pragma unroll 1
    for (int ch = 0; ch < C; ++ch) {
      float* st = sm + ch * 2 * T::PLANE;
      vertical_pass<T, MOMENTS, true>(st, vs, k, tid);
      __syncthreads();
      float mo[CHUNK][MOMENTS] = {};
      horizontal_pass<T, MOMENTS>(vs, hy, hc, k, mo);
      // every output, kept or not (no branch: the outputs' divisions
      // interleave), its terms summed where kept
      float d[MAPS][CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const bool keep = kept(o, x0, gi, hc, j);
        const int q = (hy + HALO) * SW + HALO + hc + j;
        const float a = fabsf(__fsub_rn(st[q], st[T::PLANE + q]));
        const SsimPixel s = ssim_pixel(mo[j], k);
        s_abs = __fadd_rn(s_abs, keep ? a : 0.0f);
        s_m = __fadd_rn(s_m, keep ? s.m : 0.0f);
        d[0][j] = s.d_mu;
        d[1][j] = s.d_xx;
        d[2][j] = s.d_xy;
      }
      __syncthreads();  // vs and this channel's x and y read
      if (maps != nullptr) {
        // into the shared memory this channel's x and y were staged in
        float* out = st + ch * SKEW;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          if (hc + j >= TW) continue;
#pragma unroll
          for (int m = 0; m < MAPS; ++m) {
            out[(m * T::TH + hy) * TW + hc + j] = d[m][j];
          }
        }
      }
    }
    v[0] = static_cast<double>(s_abs);
    v[1] = static_cast<double>(s_m);
  } else {
    long long p[CHUNK];
    Raw r[CHUNK];
    own_pixels(o, x0, gi, hc, p);
    load_raw(o, gt, p, r);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (!kept(o, x0, gi, hc, j)) continue;
      float x[3], y[3], e = 0.0f;
      compose(o, r[j], bg, k, x, y, e);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[0] += static_cast<double>(fabsf(__fsub_rn(x[c], y[c])));
      }
    }
  }
  // the block's sums counted in first: its fence then waits for no map
  // store (block_sum's barriers also order the maps' shared writes before
  // the copy below)
  block_sum<T::THREADS, N_SUMS>(v, tid);
  const unsigned int block = blockIdx.y * gridDim.x + blockIdx.x;
  const unsigned int blocks = gridDim.x * gridDim.y;
  const bool last =
      arrive<N_SUMS>(v, partials, block, blocks, &forward_arrivals, tid);
  if (k.lam > 0.0f && maps != nullptr) {
    // the tile's maps, a warp a row of TW pixels × C channels at a time,
    // its shared loads issued before its stores
    constexpr int WARPS = T::THREADS / 32;
    constexpr int ROWS = MAPS * T::TH / WARPS;
    constexpr int VALUES = (TW * C + 31) / 32;  // a lane's of a row
    const int lane = tid % 32, warp = tid / 32;
    const long long plane = static_cast<long long>(o.height) * o.width * C;
    const int n = min(TW, o.width - x0) * C;
    int src[VALUES];  // value lane + 32·u of a row: channel, column
#pragma unroll
    for (int u = 0; u < VALUES; ++u) {
      const int f = lane + 32 * u;
      src[u] = (f % C) * (2 * T::PLANE + SKEW) + f / C;
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = warp + WARPS * i;  // map row / TH, its row row % TH
      const int r = row % T::TH;
      float val[VALUES];
#pragma unroll
      for (int u = 0; u < VALUES; ++u) val[u] = sm[src[u] + row * TW];
      if (y0 + r >= o.height) continue;
      float* dst = maps + (row / T::TH) * plane +
                   (static_cast<long long>(y0 + r) * o.width + x0) * C;
#pragma unroll
      for (int u = 0; u < VALUES; ++u) {
        if (lane + 32 * u < n) E3D_SSIM_STORE(dst[lane + 32 * u], val[u]);
      }
    }
  }
  if (!last) return;
  total<T::THREADS, N_SUMS>(partials, blocks, v, tid);
  if (tid != 0) return;
  const float l1 = __fmul_rn(__double2float_rn(v[0]), k.inv_n);
  float loss = __fmul_rn(k.l1_w, l1);
  if (k.lam > 0.0f) {
    const float ssim = __fmul_rn(__double2float_rn(v[1]), k.inv_n);
    loss = __fadd_rn(loss, __fmul_rn(k.lam, __fsub_rn(1.0f, ssim)));
  }
  *loss_out = loss;
  *l1_out = l1;
  forward_arrivals = 0;  // every block has counted in
}

// bg[c] for a channel known only at run time, without indexing the
// register array by it
__device__ __forceinline__ float channel(const float (&bg)[3], int c) {
  return c == 0 ? bg[0] : (c == 1 ? bg[1] : bg[2]);
}

// The backward of one tile with C channels: the three maps blurred
// (staged, then the two passes per channel, the blurred values kept where
// that channel's maps were staged), then d rgb (or d image) and d log T a
// warp a row, each lane composing its own values: coalesced loads and
// stores.
template <int C>
__global__ void __launch_bounds__(BackwardTile::THREADS,
                                  (MIN_BLOCKS<C, true>))
    photometric_loss_backward_kernel(const Operands o, const Consts k,
                                     const float* __restrict__ grad,
                                     const float* __restrict__ maps,
                                     float* __restrict__ d_rgb,
                                     float* __restrict__ d_logt) {
  using T = BackwardTile;
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * T::TH;
  const int hy = tid / CHUNKS, hc = (tid % CHUNKS) * CHUNK;
  const bool ssim = k.lam > 0.0f;
  float* vs = sm + C * MAPS * T::PLANE;
  // channel c's blurred maps [MAPS][T::TH][TW], where its maps were staged
  const auto blurred = [&](int c) { return sm + c * (MAPS * T::PLANE + SKEW); };
  if (ssim) {
    zero_padding<T, MAPS>(vs, tid);
    stage_maps<T, C>(o, maps, sm, x0, y0, tid);
    __syncthreads();
#pragma unroll 1
    for (int ch = 0; ch < C; ++ch) {
      vertical_pass<T, MAPS, false>(sm + ch * MAPS * T::PLANE, vs, k, tid);
      __syncthreads();
      float b[CHUNK][MAPS] = {};
      horizontal_pass<T, MAPS>(vs, hy, hc, k, b);
      float* bl = blurred(ch);
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        if (hc + j >= TW) continue;
#pragma unroll
        for (int m = 0; m < MAPS; ++m) {
          bl[(m * T::TH + hy) * TW + hc + j] = b[j][m];
        }
      }
      __syncthreads();  // vs read
    }
  }
  float bg[3];
  load_bg(o, bg);
  const float* gt = gt_frame(o);
  const float g = *grad;
  const float g_l1 = __fmul_rn(__fmul_rn(g, k.l1_w), k.inv_n);
  const float g_ssim = __fmul_rn(__fmul_rn(g, k.lam), k.inv_n);
  // dx of value (row, col, c) of the tile from the render's and the GT's
  // value x and y there
  const auto dx_of = [&](float x, float y, int row, int col, int c) {
    float dx = __fmul_rn(g_l1, sgn(__fsub_rn(x, y)));
    if (ssim) {
      const float* bl = blurred(c) + row * TW + col;
      const float s = __fadd_rn(
          __fadd_rn(bl[0], __fmul_rn(__fmul_rn(2.0f, x), bl[T::TH * TW])),
          __fmul_rn(y, bl[2 * T::TH * TW]));
      dx = __fsub_rn(dx, __fmul_rn(g_ssim, s));
    }
    return dx;
  };
  // then a warp its rows (row = warp + WARPS · i), every load of them
  // issued before any is used
  constexpr int WARPS = T::THREADS / 32;
  constexpr int ROWS = T::TH / WARPS;
  constexpr int PIXELS = (TW + 31) / 32;  // a lane's pixels of a row
  const int n = min(TW, o.width - x0);
  const int lane = tid % 32, warp = tid / 32;
  // the pixel index of the lane's pixel i of row `row`, 0 (read, then not
  // used) past the image
  const auto pixel = [&](int row, int i, bool& in) {
    in = y0 + row < o.height && lane + 32 * i < n;
    return in ? static_cast<long long>(y0 + row) * o.width + x0 + lane +
                    32 * i
              : 0;
  };
  if constexpr (C == 1) {
    // a lane a pixel: its luma's dx spread over the channels, d log T
    long long p[ROWS * PIXELS];
    bool in[ROWS * PIXELS];
    Raw r[ROWS * PIXELS];
#pragma unroll
    for (int i = 0; i < ROWS * PIXELS; ++i) {
      p[i] = pixel(warp + WARPS * (i / PIXELS), i % PIXELS, in[i]);
    }
    load_raw(o, gt, p, r);
#pragma unroll
    for (int i = 0; i < ROWS * PIXELS; ++i) {
      if (!in[i]) continue;
      float x[3], y[3], e = 0.0f;
      compose(o, r[i], bg, k, x, y, e);
      const float dx = dx_of(x[0], y[0], warp + WARPS * (i / PIXELS),
                             lane + 32 * (i % PIXELS), 0);
      float d[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        d[c] = __fmul_rn(dx, k.w[c]);
        E3D_SSIM_STORE(d_rgb[3 * p[i] + c], d[c]);
      }
      if (o.logt != nullptr) E3D_SSIM_STORE(d_logt[p[i]], logt_grad(d, bg, e));
    }
  } else {
    // a lane a value of a row's TW · 3 (x composed per value), then a lane
    // a pixel for d log T
    constexpr int VALUES = (3 * TW + 31) / 32;  // a lane's values of a row
    float* out = ssim ? vs : sm;  // the tile's d rgb [T::TH][TW · 3]
    float xr[ROWS][VALUES], yr[ROWS][VALUES], lt[ROWS][VALUES];
    float lt_px[ROWS][PIXELS];
    long long at[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = warp + WARPS * i;
      const bool in_row = y0 + row < o.height;
      at[i] = in_row ? static_cast<long long>(y0 + row) * o.width + x0 : 0;
#pragma unroll
      for (int v = 0; v < VALUES; ++v) {
        const int f = lane + 32 * v;
        const bool in = in_row && f < 3 * n;
        const long long j = in ? 3 * at[i] + f : 0;
        xr[i][v] = o.rgb[j];
        yr[i][v] = gt[j];
        lt[i][v] = o.logt != nullptr ? o.logt[in ? at[i] + f / 3 : 0] : 0.0f;
      }
#pragma unroll
      for (int v = 0; v < PIXELS; ++v) {
        bool in;
        lt_px[i][v] = o.logt != nullptr ? o.logt[pixel(row, v, in)] : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = warp + WARPS * i;
      if (y0 + row >= o.height) continue;
#pragma unroll
      for (int v = 0; v < VALUES; ++v) {
        const int f = lane + 32 * v;
        if (f >= 3 * n) continue;
        const int col = f / 3, c = f - 3 * col;
        float x = xr[i][v];
        if (o.logt != nullptr) {
          x = __fadd_rn(x, __fmul_rn(expf(lt[i][v]), channel(bg, c)));
        }
        const float dx = dx_of(x, yr[i][v], row, col, c);
        E3D_SSIM_STORE(d_rgb[3 * at[i] + f], dx);
        out[row * TW * 3 + f] = dx;
      }
    }
    if (o.logt == nullptr) return;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = warp + WARPS * i;
#pragma unroll
      for (int v = 0; v < PIXELS; ++v) {
        bool in;
        const long long q = pixel(row, v, in);
        if (!in) continue;
        const float* d = out + (row * TW + lane + 32 * v) * 3;
        const float dj[3] = {d[0], d[1], d[2]};
        E3D_SSIM_STORE(d_logt[q], logt_grad(dj, bg, expf(lt_px[i][v])));
      }
    }
  }
}

// the kernels of C channels, forward or backward
const void* kernel(bool backward, int ch) {
  using F = const void*;
  if (backward) {
    return ch == 1 ? reinterpret_cast<F>(photometric_loss_backward_kernel<1>)
                   : reinterpret_cast<F>(photometric_loss_backward_kernel<3>);
  }
  return ch == 1 ? reinterpret_cast<F>(photometric_loss_forward_kernel<1>)
                 : reinterpret_cast<F>(photometric_loss_forward_kernel<3>);
}

// dynamic shared memory bytes of a launch with C channels (λ > 0: the
// staging; the backward at λ = 0 its gradients' rows alone)
size_t shared_bytes(bool backward, int ch, bool ssim) {
  if (!ssim) {
    return backward && ch == 3 ? sizeof(float) * BackwardTile::TH * TW * 3
                               : 0;
  }
  const int floats =
      backward ? (ch == 1 ? backward_floats<1>() : backward_floats<3>())
               : (ch == 1 ? forward_floats<1>() : forward_floats<3>());
  return sizeof(float) * floats;
}

// the output rows of a kernel's tile and its block's threads
int tile_rows(bool backward, int ch) {
  return backward ? BackwardTile::TH
                  : (ch == 1 ? ForwardTile<1>::TH : ForwardTile<3>::TH);
}
int tile_threads(bool backward, int ch) {
  return backward ? BackwardTile::THREADS
                  : (ch == 1 ? ForwardTile<1>::THREADS
                             : ForwardTile<3>::THREADS);
}

// Let each kernel take its shared memory (above the 48 KB a block gets
// without asking); once (a function-local static is initialised once).
cudaError_t allow_shared_once() {
  static const cudaError_t err = [] {
    const int channels[2] = {1, 3};
    for (int backward = 0; backward < 2; ++backward) {
      for (int ch : channels) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel(backward, ch), cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(shared_bytes(backward, ch, true)));
        if (e != cudaSuccess) return e;
      }
    }
    return cudaSuccess;
  }();
  return err;
}

// the launch's operands, or false if one is missing or malformed: an
// empty image, log T without the background, a GT of other than 1 or 3
// channels (3 in rgb mode), an index into an empty stack or over frames
// shorter than the image
bool operands(const void* const* ops, const long long* sizes, int height,
              int width, int gray, Operands& o) {
  if (height < 1 || width < 1) return false;
  o.rgb = static_cast<const float*>(ops[0]);
  o.logt = static_cast<const float*>(ops[1]);
  o.bg = static_cast<const float*>(ops[2]);
  o.gt = static_cast<const float*>(ops[3]);
  o.index = static_cast<const long long*>(ops[4]);
  o.gt_ch = static_cast<int>(sizes[0]);
  o.frames = sizes[1];
  o.stride = sizes[2];
  o.ch = gray ? 1 : 3;
  o.height = height;
  o.width = width;
  if (o.rgb == nullptr || o.gt == nullptr) return false;
  if (o.logt != nullptr && o.bg == nullptr) return false;
  if (o.gt_ch != 3 && !(gray && o.gt_ch == 1)) return false;
  const long long pixels = static_cast<long long>(height) * width;
  if (o.index != nullptr &&
      (o.frames < 1 || o.stride < pixels * o.gt_ch)) {
    return false;
  }
  return true;
}

Consts consts(const float* c) {
  Consts k;
  for (int t = 0; t < WIN; ++t) k.g[t] = c[t];
  for (int i = 0; i < 3; ++i) k.w[i] = c[WIN + i];
  k.c1 = c[WIN + 3];
  k.c2 = c[WIN + 4];
  k.l1_w = c[WIN + 5];
  k.lam = c[WIN + 6];
  k.inv_n = c[WIN + 7];
  return k;
}

// the grid of tiles of `rows` output rows over H × W
dim3 tiles(int height, int width, int rows) {
  return dim3((width + TW - 1) / TW, (height + rows - 1) / rows);
}

}  // namespace

// operands: a host array of N_OPERANDS device pointers (the render's rgb
// or image [P, 3], its log T [P] or null, the background [3] or null, the
// GT image [P, C_gt] or stack, the [1] int64 index or null); sizes: a host
// array of N_SIZES int64 (the GT's channels, the frames of its stack, the
// floats from one frame to the next: both read only with an index); H, W,
// gray (0 or 1), the N_CONSTS constants, the partials scratch (rows of
// N_SUMS doubles, at least e3d_photometric_partials_rows) and its rows,
// the loss and l1 (device floats), the maps [3, P, C] (or null: no
// gradient wanted).
extern "C" int e3d_photometric_loss_forward(
    const void* const* ops, const long long* sizes, int height, int width,
    int gray, const float* constants, void* partials, int rows,
    void* loss_out, void* l1_out, void* maps, cudaStream_t stream) {
  Operands o;
  if (!operands(ops, sizes, height, width, gray, o)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid = tiles(o.height, o.width, tile_rows(false, o.ch));
  if (static_cast<long long>(grid.x) * grid.y > rows || grid.y > 65535) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_shared_once();
  if (err != cudaSuccess) return err;
  const Consts k = consts(constants);
  const size_t shared = shared_bytes(false, o.ch, k.lam > 0.0f);
  auto* f = o.ch == 1 ? photometric_loss_forward_kernel<1>
                      : photometric_loss_forward_kernel<3>;
  f<<<grid, tile_threads(false, o.ch), shared, stream>>>(
      o, k, static_cast<double*>(partials), static_cast<float*>(loss_out),
      static_cast<float*>(l1_out), static_cast<float*>(maps));
  return cudaGetLastError();
}

// the forward's operands, sizes, H, W, gray and constants, the loss's
// gradient (a device float), the forward's maps (null where λ = 0), d rgb
// or d image [P, 3] and d log T [P] (null where the render is an image)
extern "C" int e3d_photometric_loss_backward(
    const void* const* ops, const long long* sizes, int height, int width,
    int gray, const float* constants, const void* grad, const void* maps,
    void* d_rgb, void* d_logt, cudaStream_t stream) {
  Operands o;
  if (!operands(ops, sizes, height, width, gray, o)) {
    return cudaErrorInvalidValue;
  }
  const Consts k = consts(constants);
  if (d_rgb == nullptr || (d_logt == nullptr) != (o.logt == nullptr) ||
      (k.lam > 0.0f && maps == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid = tiles(o.height, o.width, tile_rows(true, o.ch));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = allow_shared_once();
  if (err != cudaSuccess) return err;
  const size_t shared = shared_bytes(true, o.ch, k.lam > 0.0f);
  auto* f = o.ch == 1 ? photometric_loss_backward_kernel<1>
                      : photometric_loss_backward_kernel<3>;
  f<<<grid, tile_threads(true, o.ch), shared, stream>>>(
      o, k, static_cast<const float*>(grad), static_cast<const float*>(maps),
      static_cast<float*>(d_rgb), static_cast<float*>(d_logt));
  return cudaGetLastError();
}

// the rows of N_SUMS doubles the forward's partials scratch needs at H × W
// in rgb (or gray) mode (a block's each)
extern "C" int e3d_photometric_partials_rows(int* rows, int height, int width,
                                             int gray) {
  if (height < 1 || width < 1) return cudaErrorInvalidValue;
  const dim3 grid = tiles(height, width, tile_rows(false, gray ? 1 : 3));
  *rows = static_cast<int>(grid.x * grid.y);
  return cudaSuccess;
}

// registers per thread and resident blocks per SM of the forward (or the
// backward) kernel of rgb (or gray) mode at its shared memory with λ > 0
extern "C" int e3d_photometric_occupancy(int* regs, int* blocks_per_sm,
                                         int backward, int gray) {
  cudaError_t err = allow_shared_once();
  if (err != cudaSuccess) return err;
  const int ch = gray ? 1 : 3;
  const void* f = kernel(backward, ch);
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, f);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, f, tile_threads(backward, ch),
      shared_bytes(backward, ch, true));
}

// the shared memory bytes a block of the forward (or the backward) kernel
// of rgb (or gray) mode holds with λ > 0: its static and its dynamic
extern "C" int e3d_photometric_shared_bytes(int* bytes, int backward,
                                            int gray) {
  const int ch = gray ? 1 : 3;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel(backward, ch));
  if (err != cudaSuccess) return err;
  *bytes = static_cast<int>(a.sharedSizeBytes +
                            shared_bytes(backward, ch, true));
  return cudaSuccess;
}
