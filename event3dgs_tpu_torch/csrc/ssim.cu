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
// The design: a block of 16×16 threads per 16×16-pixel output tile, a
// thread a pixel.  The block stages its tile and a 5-pixel halo of x and y
// (forward; composed and, in gray mode, converted on load) or of the three
// maps (backward) in shared memory, zero outside the image; runs the
// vertical pass of each channel into shared memory (16 rows × 26 columns),
// then the horizontal pass of its own pixel in registers.  The forward's
// scalar sums are block_sums.cuh's: block partials in double, the last
// block to arrive adds them in block order (its own arrival counter).  No
// host read, no host copy: the operands' pointers and the constants go by
// value in the kernels' parameters, so a CUDA graph captures the launches
// whole.  Two launches of the forward must not run at once (on two
// streams): they would share its counter.
//
// Bound (tools/kernel_timing.photometric_bound): the forward reads the
// render and the GT once and writes the maps (16 floats a pixel at 1080p
// rgb from partials), the backward reads them all again and writes the
// gradients (20 floats a pixel); the forward's blurs are most of the
// operations.

#include <cuda_runtime.h>

#include <stdint.h>

#include "block_sums.cuh"

namespace {

constexpr int TILE = 16;              // output tile: TILE × TILE pixels
constexpr int THREADS = TILE * TILE;  // a thread a pixel
constexpr int WIN = 11;               // the window's taps
constexpr int HALO = WIN / 2;
constexpr int SPAN = TILE + 2 * HALO;  // staged rows and columns
constexpr int MOMENTS = 5;             // mx, my, exx, eyy, exy
constexpr int MAPS = 3;                // D_mu, D_xx, D_xy
constexpr int N_SUMS = 2;              // |x - y|, m
constexpr int N_CONSTS = WIN + 3 + 5;  // floats of Consts, in its order
constexpr int N_OPERANDS = 5;
constexpr int N_SIZES = 3;
static_assert(N_OPERANDS == 5 && N_SIZES == 3 && N_CONSTS == 19,
              "the host's arrays: losses/modes._photometric_launch");

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

// the values compared at pixel p: x (the render's image, composed over the
// background where it comes as partials, with expf(log T) in e) and y (the
// GT), both converted to luma in gray mode (in [0])
__device__ __forceinline__ void load_pixel(const Operands& o,
                                           const float* __restrict__ gt,
                                           const float (&bg)[3],
                                           const Consts& k, long long p,
                                           float (&x)[3], float (&y)[3],
                                           float& e) {
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = o.rgb[3 * p + c];
  if (o.logt != nullptr) {
    e = expf(o.logt[p]);
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = __fadd_rn(x[c], __fmul_rn(e, bg[c]));
  }
  if (o.gt_ch == 3) {
#pragma unroll
    for (int c = 0; c < 3; ++c) y[c] = gt[3 * p + c];
  } else {
    y[0] = gt[p];
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

// tap t of the ordered blur sum: the first product, then one sum a tap
__device__ __forceinline__ float tap(float acc, int t, float g, float z) {
  const float p = __fmul_rn(g, z);
  return t == 0 ? p : __fadd_rn(acc, p);
}

__global__ void __launch_bounds__(THREADS)
    photometric_loss_forward_kernel(const Operands o, const Consts k,
                                    double* __restrict__ partials,
                                    float* __restrict__ loss_out,
                                    float* __restrict__ l1_out,
                                    float* __restrict__ maps) {
  __shared__ float xs[3][SPAN][SPAN];
  __shared__ float ys[3][SPAN][SPAN];
  __shared__ float vs[MOMENTS][TILE][SPAN];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TILE + tx;
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const int i = y0 + ty, j = x0 + tx;
  const bool inside = i < o.height && j < o.width;
  const long long p = static_cast<long long>(i) * o.width + j;
  const long long plane = static_cast<long long>(o.height) * o.width * o.ch;
  float bg[3];
  load_bg(o, bg);
  const float* gt = gt_frame(o);
  double s_abs = 0.0, s_m = 0.0;
  if (k.lam > 0.0f) {
    // the tile and its halo of x and y, zero outside the image
    for (int q = tid; q < SPAN * SPAN; q += THREADS) {
      const int r = q / SPAN, c = q % SPAN;
      const int gi = y0 - HALO + r, gj = x0 - HALO + c;
      float x[3] = {0.0f, 0.0f, 0.0f}, y[3] = {0.0f, 0.0f, 0.0f}, e = 0.0f;
      if (gi >= 0 && gi < o.height && gj >= 0 && gj < o.width) {
        load_pixel(o, gt, bg, k,
                   static_cast<long long>(gi) * o.width + gj, x, y, e);
      }
      for (int ch = 0; ch < o.ch; ++ch) {
        xs[ch][r][c] = x[ch];
        ys[ch][r][c] = y[ch];
      }
    }
    __syncthreads();
    for (int ch = 0; ch < o.ch; ++ch) {
      // the vertical pass of the five moments, TILE rows × SPAN columns
      for (int q = tid; q < TILE * SPAN; q += THREADS) {
        const int r = q / SPAN, c = q % SPAN;
        float a[MOMENTS] = {};
#pragma unroll
        for (int t = 0; t < WIN; ++t) {
          const float xv = xs[ch][r + t][c], yv = ys[ch][r + t][c];
          const float g = k.g[t];
          a[0] = tap(a[0], t, g, xv);
          a[1] = tap(a[1], t, g, yv);
          a[2] = tap(a[2], t, g, __fmul_rn(xv, xv));
          a[3] = tap(a[3], t, g, __fmul_rn(yv, yv));
          a[4] = tap(a[4], t, g, __fmul_rn(xv, yv));
        }
#pragma unroll
        for (int m = 0; m < MOMENTS; ++m) vs[m][r][c] = a[m];
      }
      __syncthreads();
      if (inside) {
        // the horizontal pass of this thread's pixel
        float mo[MOMENTS] = {};
#pragma unroll
        for (int t = 0; t < WIN; ++t) {
#pragma unroll
          for (int m = 0; m < MOMENTS; ++m) {
            mo[m] = tap(mo[m], t, k.g[t], vs[m][ty][tx + t]);
          }
        }
        const float xv = xs[ch][ty + HALO][tx + HALO];
        const float yv = ys[ch][ty + HALO][tx + HALO];
        s_abs += static_cast<double>(fabsf(__fsub_rn(xv, yv)));
        const SsimPixel s = ssim_pixel(mo, k);
        s_m += static_cast<double>(s.m);
        if (maps != nullptr) {
          const long long v = p * o.ch + ch;
          maps[v] = s.d_mu;
          maps[plane + v] = s.d_xx;
          maps[2 * plane + v] = s.d_xy;
        }
      }
      __syncthreads();  // vs free for the next channel
    }
  } else if (inside) {
    float x[3], y[3], e = 0.0f;
    load_pixel(o, gt, bg, k, p, x, y, e);
    for (int ch = 0; ch < o.ch; ++ch) {
      s_abs += static_cast<double>(fabsf(__fsub_rn(x[ch], y[ch])));
    }
  }
  double v[N_SUMS] = {s_abs, s_m};
  block_sum<THREADS, N_SUMS>(v, tid);
  const unsigned int block = blockIdx.y * gridDim.x + blockIdx.x;
  const unsigned int blocks = gridDim.x * gridDim.y;
  if (!arrive<N_SUMS>(v, partials, block, blocks, &forward_arrivals, tid)) {
    return;
  }
  total<THREADS, N_SUMS>(partials, blocks, v, tid);
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

__global__ void __launch_bounds__(THREADS)
    photometric_loss_backward_kernel(const Operands o, const Consts k,
                                     const float* __restrict__ grad,
                                     const float* __restrict__ maps,
                                     float* __restrict__ d_rgb,
                                     float* __restrict__ d_logt) {
  __shared__ float ds[MAPS][3][SPAN][SPAN];
  __shared__ float vb[MAPS][TILE][SPAN];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TILE + tx;
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const int i = y0 + ty, j = x0 + tx;
  const bool inside = i < o.height && j < o.width;
  const long long p = static_cast<long long>(i) * o.width + j;
  const long long plane = static_cast<long long>(o.height) * o.width * o.ch;
  const bool ssim = k.lam > 0.0f;
  const float g = *grad;
  const float g_l1 = __fmul_rn(__fmul_rn(g, k.l1_w), k.inv_n);
  const float g_ssim = __fmul_rn(__fmul_rn(g, k.lam), k.inv_n);
  if (ssim) {
    // the tile and its halo of the three maps, zero outside the image
    for (int q = tid; q < SPAN * SPAN; q += THREADS) {
      const int r = q / SPAN, c = q % SPAN;
      const int gi = y0 - HALO + r, gj = x0 - HALO + c;
      const bool in = gi >= 0 && gi < o.height && gj >= 0 && gj < o.width;
      const long long v =
          (static_cast<long long>(gi) * o.width + gj) * o.ch;
      for (int ch = 0; ch < o.ch; ++ch) {
#pragma unroll
        for (int m = 0; m < MAPS; ++m) {
          ds[m][ch][r][c] = in ? maps[m * plane + v + ch] : 0.0f;
        }
      }
    }
    __syncthreads();
  }
  float bg[3];
  load_bg(o, bg);
  float x[3] = {0.0f, 0.0f, 0.0f}, y[3] = {0.0f, 0.0f, 0.0f}, e = 0.0f;
  if (inside) load_pixel(o, gt_frame(o), bg, k, p, x, y, e);
  float dimg[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    if (ch == o.ch) break;  // o.ch is the block's: every thread breaks
    float dx = __fmul_rn(g_l1, sgn(__fsub_rn(x[ch], y[ch])));
    if (ssim) {
      // the vertical pass of the three maps, TILE rows × SPAN columns
      for (int q = tid; q < TILE * SPAN; q += THREADS) {
        const int r = q / SPAN, c = q % SPAN;
        float a[MAPS] = {};
#pragma unroll
        for (int t = 0; t < WIN; ++t) {
#pragma unroll
          for (int m = 0; m < MAPS; ++m) {
            a[m] = tap(a[m], t, k.g[t], ds[m][ch][r + t][c]);
          }
        }
#pragma unroll
        for (int m = 0; m < MAPS; ++m) vb[m][r][c] = a[m];
      }
      __syncthreads();
      if (inside) {
        float b[MAPS] = {};
#pragma unroll
        for (int t = 0; t < WIN; ++t) {
#pragma unroll
          for (int m = 0; m < MAPS; ++m) {
            b[m] = tap(b[m], t, k.g[t], vb[m][ty][tx + t]);
          }
        }
        const float s = __fadd_rn(
            __fadd_rn(b[0], __fmul_rn(__fmul_rn(2.0f, x[ch]), b[1])),
            __fmul_rn(y[ch], b[2]));
        dx = __fsub_rn(dx, __fmul_rn(g_ssim, s));
      }
      __syncthreads();  // vb free for the next channel
    }
    dimg[ch] = dx;
  }
  if (!inside) return;
  if (o.ch == 1) {
    const float d = dimg[0];
#pragma unroll
    for (int c = 0; c < 3; ++c) dimg[c] = __fmul_rn(d, k.w[c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) d_rgb[3 * p + c] = dimg[c];
  if (o.logt != nullptr) d_logt[p] = logt_grad(dimg, bg, e);
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

dim3 tiles(const Operands& o) {
  return dim3((o.width + TILE - 1) / TILE, (o.height + TILE - 1) / TILE);
}

}  // namespace

// operands: a host array of N_OPERANDS device pointers (the render's rgb
// or image [P, 3], its log T [P] or null, the background [3] or null, the
// GT image [P, C_gt] or stack, the [1] int64 index or null); sizes: a host
// array of N_SIZES int64 (the GT's channels, the frames of its stack, the
// floats from one frame to the next: both read only with an index); H, W,
// gray (0 or 1), the N_CONSTS constants, the partials scratch (rows of
// N_SUMS doubles, at least one a 16×16 tile) and its rows, the loss and
// l1 (device floats), the maps [3, P, C] (or null: no gradient wanted).
extern "C" int e3d_photometric_loss_forward(
    const void* const* ops, const long long* sizes, int height, int width,
    int gray, const float* constants, void* partials, int rows,
    void* loss_out, void* l1_out, void* maps, cudaStream_t stream) {
  Operands o;
  if (!operands(ops, sizes, height, width, gray, o)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid = tiles(o);
  if (static_cast<long long>(grid.x) * grid.y > rows || grid.y > 65535) {
    return cudaErrorInvalidValue;
  }
  photometric_loss_forward_kernel<<<grid, dim3(TILE, TILE), 0, stream>>>(
      o, consts(constants), static_cast<double*>(partials),
      static_cast<float*>(loss_out), static_cast<float*>(l1_out),
      static_cast<float*>(maps));
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
  const dim3 grid = tiles(o);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  photometric_loss_backward_kernel<<<grid, dim3(TILE, TILE), 0, stream>>>(
      o, k, static_cast<const float*>(grad), static_cast<const float*>(maps),
      static_cast<float*>(d_rgb), static_cast<float*>(d_logt));
  return cudaGetLastError();
}
