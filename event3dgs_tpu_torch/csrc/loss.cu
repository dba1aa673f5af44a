// The event-mode training loss, forward and backward: one kernel each way.
//
// Replaces no Pallas kernel.  In the JAX package the renders' composition
// over the background (event3dgs_tpu/ops/render.py:122), the picks of the
// GT frames at traced indices (event3dgs_tpu/train/step.py:115,151-152,164),
// `event_mixture_loss` (event3dgs_tpu/losses/event.py:68-104) and, in
// event_deblur mode, `deblur_mix` (event3dgs_tpu/losses/modes.py:59-63) run
// inside the jitted train step, where XLA fuses them into a few elementwise
// passes and reductions and materialises no composed image.  In plain
// PyTorch the same work is some 50 launches forward and 50 backward, most
// of them writing a full-size 1080p temporary.  Here it is one launch each
// way, reading each input once.
//
// The operands.  A render (now, next, main) comes as its image [P, 3], or
// as the rasterizer's partials rgb [P, 3] and log T [P], which the kernels
// compose over the background bg [3] on load, as `ops/render.composed`
// does: image = rgb + expf(log T)·bg (the product, then the sum).  A GT
// operand (gt_now, gt_next, gt_main and, in event_deblur mode, blurry)
// comes as its image [P, 1 or 3], or as a stack of frames and a [1] int64
// device index: the kernels read the frame where it lies (an index outside
// the stack traps).  The host never reads an index, so a CUDA graph holds
// the pick.
//
// Per pixel p of P (the renders' images now, next, main [P, 3]; the GT
// images [P, 1] or [P, 3], a one-channel image broadcast as PyTorch
// broadcasts it):
//
//   L(x)   = (x0*w0 + x2*w2) + x1*w1   (x*w).sum(-1): PyTorch's CUDA
//            reduction over 3 contiguous values, two lanes: (x0 + x2) + x1
//   A_now  = L(now) + eps              A_next = L(next) + eps
//   d      = log(A_next) - log(A_now)  img = d / c
//   gd     = (log(L(gt_next) + eps) - log(L(gt_now) + eps)) * (1/gt_contrast)
//   r      = img - gd
//
// L of a one-channel image is the image itself.  c is the contrast, a 0-d
// device tensor: PyTorch divides by it with a true division.  gt_contrast
// is a Python float: PyTorch's CUDA division by a host scalar is a product
// with its float32 reciprocal, made on the host.  Per value v of the
// [P, 3] renders: r_main = main - gt_main, r_blur = main - blurry.
//
// Forward: the sums of |r|, |r_main| and |r_blur| and the count of gd != 0,
// then, as torch.mean on the card (a sum times the float32 1/N):
//
//   event_l1 = Σ|r|·(1/P)   intensity_l1 = Σ|r_main|·(1/3P)
//   coverage = count·(1/P)  blur_l1 = Σ|r_blur|·(1/3P)
//   loss     = (event_l1·w)·coverage + (intensity_l1·(1-w))·(1-coverage)
//   event_deblur: loss = loss·(1-α) + blur_l1·α
//
// Backward: autograd's chain of the plain version, operation by operation.
// From the device scalars (the loss's gradient G, the coverage, c):
//
//   G_base  = G·(1-α) in event_deblur, else G
//   g_event = ((G_base·coverage)·w)·(1/P)       (mean backward: 1/N on the card)
//   g_int   = ((G_base·(1-coverage))·(1-w))·(1/3P)
//   g_blur  = (G·α)·(1/3P)
//
// and per pixel: g_r = g_event·sgn(r) (sgn 0 at a tie, as torch.sgn),
// g_d = g_r / c, d now = ((-g_d) / A_now)·w_k, d next = (g_d / A_next)·w_k,
// d main = g_int·sgn(r_main) [+ g_blur·sgn(r_blur)], and the contrast's
// term (-g_r)·((d / c) / c), summed over the pixels.  A render given as
// partials gets, from its image's gradient g, autograd's chain through the
// composition: d rgb = g (the sum passes it on), and
//
//   d log T = (((0 + g0·bg0) + (0 + g2·bg2)) + (0 + g1·bg1))·expf(log T)
//
// the product's backward g·bg, summed over the broadcast channel axis as
// PyTorch's CUDA sum over 3 contiguous values adds them (two lanes, each
// accumulator starting at +0, which turns a -0 into +0), then the exp's
// backward (times its result).
//
// Every product, quotient, sum and difference is an explicit
// round-to-nearest intrinsic in that order, so nothing fuses into an FMA
// whatever the flags, and the image gradients equal the plain version's
// bit for bit.  The constants (w_k, eps, 1/gt_contrast, w, 1-w, α, 1-α,
// 1/P, 1/3P) come rounded to float32 from the host, as PyTorch rounds a
// Python float.  `logf` and `expf` are the CUDA math library's, as
// PyTorch's `log` and `exp`.
//
// The sums (block_sums.cuh): each thread adds its pixels' terms in double,
// a block adds its threads' in a fixed tree, and the last block to finish
// (a counter of its own in device memory, set back to 0 by that block)
// adds the blocks' partials in block order.  The grid is fixed by the card
// and P, so the same inputs give the same bits in every run.  No host read,
// no host copy: the constants and the operands' pointers go by value in the
// kernel's parameters, so a CUDA graph captures the launch whole.  Two launches of
// one of these kernels must not run at once (on two streams): they would
// share its counter.
//
// Bound: bytes.  The forward reads the three renders' partials and the GT
// frames once (21 floats a pixel, 174.2 MB at 1080p with three-channel
// GT); the backward reads them again and writes the partials' gradients
// (12 floats a pixel more, 273.7 MB).  Four pixels are three 16-byte loads
// of a three-channel image (one of a one-channel image or of log T) where
// every pointer and frame is 16-byte aligned; a ragged last chunk, or an
// unaligned operand, is read a float at a time.

#include <cuda_runtime.h>

#include <stdint.h>

#include "block_sums.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PIX = 4;          // pixels a chunk
constexpr int N_SUMS = 4;       // forward partials: |r|, |r_main|, |r_blur|, count
constexpr int N_CONSTS = 11;    // floats of Consts, in its order
constexpr int RENDERS = 3;      // now, next, main
constexpr int GTS = 4;          // gt_now, gt_next, gt_main, blurry
// the host's operand pointers: per render its rgb (or image) and log T
// (or null), the background (or null), per GT operand its frame (or
// stack) and index (or null); and per GT operand 3 int64 sizes
constexpr int N_OPERANDS = 2 * RENDERS + 1 + 2 * GTS;
constexpr int N_SIZES = 3 * GTS;
static_assert(N_OPERANDS == 15 && N_SIZES == 12,
              "the host's arrays: losses/event._loss_launch");

struct Consts {
  float w[3];       // the LUV L weights
  float eps;        // LOG_EPS
  float gt_inv;     // 1 / gt_contrast
  float event_w;    // w
  float intens_w;   // 1 - w
  float blur_a;     // α
  float base_w;     // 1 - α
  float inv_pix;    // 1 / P
  float inv_vals;   // 1 / 3P
};
static_assert(sizeof(Consts) == N_CONSTS * sizeof(float), "Consts' floats");

struct Gt {
  const float* base;       // the frame, or the stack of frames
  const long long* index;  // [1] on the device, or null: base is the frame
  long long frames;        // frames in the stack
  long long stride;        // floats from one frame to the next
  int ch;                  // 1 or 3
};

struct Images {
  const float* rgb[RENDERS];   // [P, 3]: the partial rgb, or the image
  const float* logt[RENDERS];  // [P] log T, or null: rgb is the image
  const float* bg;             // [3]; null where no render has log T
  Gt gt[GTS];                  // blurry's base null: event mode
  long long pixels;
  long long chunks;
  int vec;  // every operand 16-byte aligned, every frame too
};

struct Grads {
  float* rgb[RENDERS];   // [P, 3]: d rgb, or d image
  float* logt[RENDERS];  // [P] d log T, or null
};

__device__ unsigned int forward_arrivals = 0;
__device__ unsigned int backward_arrivals = 0;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// pixels [p0, p0 + n) of a one-channel operand; pixels past n read as 0
__device__ __forceinline__ void load1(const float* __restrict__ x,
                                      long long p0, int n, bool vec,
                                      float (&s)[PIX]) {
  const float* src = x + p0;
  if (vec && n == PIX) {
    const float4 a = ld4(src);
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < PIX; ++j) s[j] = j < n ? src[j] : 0.0f;
  }
}

// pixels [p0, p0 + n) of an image of `ch` channels as [PIX][3], a
// one-channel image repeated over the three (PyTorch's broadcast); pixels
// past n read as 0
__device__ __forceinline__ void load3(const float* __restrict__ x, int ch,
                                      long long p0, int n, bool vec,
                                      float (&v)[PIX][3]) {
  if (ch == 3) {
    const float* src = x + p0 * 3;
    if (vec && n == PIX) {
      const float4 a = ld4(src), b = ld4(src + 4), c = ld4(src + 8);
      v[0][0] = a.x; v[0][1] = a.y; v[0][2] = a.z;
      v[1][0] = a.w; v[1][1] = b.x; v[1][2] = b.y;
      v[2][0] = b.z; v[2][1] = b.w; v[2][2] = c.x;
      v[3][0] = c.y; v[3][1] = c.z; v[3][2] = c.w;
    } else {
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
#pragma unroll
        for (int k = 0; k < 3; ++k) v[j][k] = j < n ? src[3 * j + k] : 0.0f;
      }
    }
  } else {
    float s[PIX];
    load1(x, p0, n, vec, s);
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
#pragma unroll
      for (int k = 0; k < 3; ++k) v[j][k] = s[j];
    }
  }
}

// [PIX] into pixels [p0, p0 + n) of a one-channel output
__device__ __forceinline__ void store1(float* __restrict__ x, long long p0,
                                       int n, bool vec,
                                       const float (&s)[PIX]) {
  float* dst = x + p0;
  if (vec && n == PIX) {
    st4(dst, s[0], s[1], s[2], s[3]);
  } else {
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      if (j < n) dst[j] = s[j];
    }
  }
}

// [PIX][3] into pixels [p0, p0 + n) of a three-channel image
__device__ __forceinline__ void store3(float* __restrict__ x, long long p0,
                                       int n, bool vec,
                                       const float (&v)[PIX][3]) {
  float* dst = x + p0 * 3;
  if (vec && n == PIX) {
    st4(dst, v[0][0], v[0][1], v[0][2], v[1][0]);
    st4(dst + 4, v[1][1], v[1][2], v[2][0], v[2][1]);
    st4(dst + 8, v[2][2], v[3][0], v[3][1], v[3][2]);
  } else {
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (j < n) dst[3 * j + k] = v[j][k];
      }
    }
  }
}

// the frame a GT operand reads: its image, or frame *index of its stack
// (an index outside the stack traps: the host cannot read it to refuse it)
__device__ __forceinline__ const float* frame(const Gt& g) {
  if (g.index == nullptr) return g.base;
  const long long i = *g.index;
  if (i < 0 || i >= g.frames) __trap();
  return g.base + i * g.stride;
}

// pixels [p0, p0 + n) of render r's image as [PIX][3]: its rgb composed
// over the background where it comes as partials, rgb + expf(log T)·bg as
// `ops/render.composed` rounds it (the product, then the sum), with
// expf(log T) in e; else its image, e untouched
__device__ __forceinline__ void load_render(const Images& im, int r,
                                            const float (&bg)[3], long long p0,
                                            int n, bool vec,
                                            float (&v)[PIX][3],
                                            float (&e)[PIX]) {
  load3(im.rgb[r], 3, p0, n, vec, v);
  if (im.logt[r] == nullptr) return;
  load1(im.logt[r], p0, n, vec, e);
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    e[j] = expf(e[j]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[j][k] = __fadd_rn(v[j][k], __fmul_rn(e[j], bg[k]));
    }
  }
}

// render r's gradients at pixels [p0, p0 + n) from its image's g: g
// itself into d rgb (or d image), and d log T where it has log T
__device__ __forceinline__ void store_render(const Images& im,
                                             const Grads& out, int r,
                                             const float (&bg)[3],
                                             long long p0, int n, bool vec,
                                             const float (&g)[PIX][3],
                                             const float (&e)[PIX]) {
  store3(out.rgb[r], p0, n, vec, g);
  if (im.logt[r] == nullptr) return;
  float gl[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j) gl[j] = logt_grad(g[j], bg, e[j]);
  store1(out.logt[r], p0, n, vec, gl);
}

// (x * w).sum(-1) of one pixel, in PyTorch's CUDA order
__device__ __forceinline__ float luv_l(const float (&x)[3], const Consts& k) {
  const float p0 = __fmul_rn(x[0], k.w[0]);
  const float p1 = __fmul_rn(x[1], k.w[1]);
  const float p2 = __fmul_rn(x[2], k.w[2]);
  return __fadd_rn(__fadd_rn(p0, p2), p1);
}

// the L channel of pixels [p0, p0 + n) of a GT image: the image itself
// where it has one channel
__device__ __forceinline__ void load_l(const float* __restrict__ x, int ch,
                                       long long p0, int n, bool vec,
                                       const Consts& k, float (&l)[PIX]) {
  float v[PIX][3];
  load3(x, ch, p0, n, vec, v);
#pragma unroll
  for (int j = 0; j < PIX; ++j) l[j] = ch == 3 ? luv_l(v[j], k) : v[j][0];
}

struct EventPixel {
  float a_now, a_next;  // L + eps of the rendered pair
  float img;            // the rendered log difference over c
  float r;              // img - gd
  bool fired;           // gd != 0
};

__device__ __forceinline__ EventPixel event_pixel(const float (&now)[3],
                                                  const float (&next)[3],
                                                  float l_gt_now,
                                                  float l_gt_next, float c,
                                                  const Consts& k) {
  EventPixel e;
  e.a_now = __fadd_rn(luv_l(now, k), k.eps);
  e.a_next = __fadd_rn(luv_l(next, k), k.eps);
  e.img = __fdiv_rn(__fsub_rn(logf(e.a_next), logf(e.a_now)), c);
  const float gd = __fmul_rn(
      __fsub_rn(logf(__fadd_rn(l_gt_next, k.eps)),
                logf(__fadd_rn(l_gt_now, k.eps))),
      k.gt_inv);
  e.r = __fsub_rn(e.img, gd);
  e.fired = gd != 0.0f;
  return e;
}

// the background in registers (zeros where no render has log T)
__device__ __forceinline__ void load_bg(const Images& im, float (&bg)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) bg[k] = im.bg != nullptr ? im.bg[k] : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
    event_loss_forward_kernel(const Images im, const Consts k,
                              const float* __restrict__ contrast,
                              double* __restrict__ partials,
                              float* __restrict__ loss_out,
                              float* __restrict__ aux_out) {
  const float c = *contrast;
  const bool vec = im.vec;
  float bg[3];
  load_bg(im, bg);
  const float* gt_now = frame(im.gt[0]);
  const float* gt_next = frame(im.gt[1]);
  const float* gt_main = frame(im.gt[2]);
  const float* blurry = im.gt[3].base != nullptr ? frame(im.gt[3]) : nullptr;
  double s_event = 0.0, s_main = 0.0, s_blur = 0.0;
  int fired = 0;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long q = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       q < im.chunks; q += step) {
    const long long p0 = q * PIX;
    const int n = static_cast<int>(min(static_cast<long long>(PIX),
                                       im.pixels - p0));
    float e[PIX];
    {
      float now[PIX][3], next[PIX][3], l_now[PIX], l_next[PIX];
      load_render(im, 0, bg, p0, n, vec, now, e);
      load_render(im, 1, bg, p0, n, vec, next, e);
      load_l(gt_now, im.gt[0].ch, p0, n, vec, k, l_now);
      load_l(gt_next, im.gt[1].ch, p0, n, vec, k, l_next);
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
        if (j < n) {
          const EventPixel ev =
              event_pixel(now[j], next[j], l_now[j], l_next[j], c, k);
          s_event += static_cast<double>(fabsf(ev.r));
          fired += ev.fired;
        }
      }
    }
    float m[PIX][3], g[PIX][3];
    load_render(im, 2, bg, p0, n, vec, m, e);
    load3(gt_main, im.gt[2].ch, p0, n, vec, g);
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        if (j < n) s_main += fabsf(__fsub_rn(m[j][ch], g[j][ch]));
      }
    }
    if (blurry != nullptr) {
      load3(blurry, im.gt[3].ch, p0, n, vec, g);
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          if (j < n) s_blur += fabsf(__fsub_rn(m[j][ch], g[j][ch]));
        }
      }
    }
  }
  double v[N_SUMS] = {s_event, s_main, s_blur, static_cast<double>(fired)};
  block_sum<THREADS, N_SUMS>(v, threadIdx.x);
  if (!arrive<N_SUMS>(v, partials, blockIdx.x, gridDim.x, &forward_arrivals,
                      threadIdx.x)) {
    return;
  }
  total<THREADS, N_SUMS>(partials, gridDim.x, v, threadIdx.x);
  if (threadIdx.x != 0) return;
  const float event_l1 = __fmul_rn(__double2float_rn(v[0]), k.inv_pix);
  const float intensity_l1 = __fmul_rn(__double2float_rn(v[1]), k.inv_vals);
  const float coverage = __fmul_rn(__double2float_rn(v[3]), k.inv_pix);
  float loss = __fadd_rn(
      __fmul_rn(__fmul_rn(event_l1, k.event_w), coverage),
      __fmul_rn(__fmul_rn(intensity_l1, k.intens_w),
                __fsub_rn(1.0f, coverage)));
  float blur_l1 = 0.0f;
  if (blurry != nullptr) {
    blur_l1 = __fmul_rn(__double2float_rn(v[2]), k.inv_vals);
    loss = __fadd_rn(__fmul_rn(loss, k.base_w), __fmul_rn(blur_l1, k.blur_a));
  }
  *loss_out = loss;
  aux_out[0] = event_l1;
  aux_out[1] = intensity_l1;
  aux_out[2] = coverage;
  aux_out[3] = blur_l1;
  forward_arrivals = 0;  // every block has counted in
}

__global__ void __launch_bounds__(THREADS)
    event_loss_backward_kernel(const Images im, const Consts k,
                               const float* __restrict__ contrast,
                               const float* __restrict__ grad,
                               const float* __restrict__ coverage_ptr,
                               double* __restrict__ partials,
                               const Grads out,
                               float* __restrict__ g_contrast) {
  const float c = *contrast;
  const float coverage = *coverage_ptr;
  const bool vec = im.vec;
  float bg[3];
  load_bg(im, bg);
  const float* gt_now = frame(im.gt[0]);
  const float* gt_next = frame(im.gt[1]);
  const float* gt_main = frame(im.gt[2]);
  const float* blurry = im.gt[3].base != nullptr ? frame(im.gt[3]) : nullptr;
  const bool deblur = blurry != nullptr;
  // the scalar prefix, in autograd's order
  const float g = *grad;
  const float g_base = deblur ? __fmul_rn(g, k.base_w) : g;
  const float g_event = __fmul_rn(
      __fmul_rn(__fmul_rn(g_base, coverage), k.event_w), k.inv_pix);
  const float g_int = __fmul_rn(
      __fmul_rn(__fmul_rn(g_base, __fsub_rn(1.0f, coverage)), k.intens_w),
      k.inv_vals);
  const float g_blur = deblur ? __fmul_rn(__fmul_rn(g, k.blur_a), k.inv_vals)
                              : 0.0f;
  double s_c = 0.0;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long q = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       q < im.chunks; q += step) {
    const long long p0 = q * PIX;
    const int n = static_cast<int>(min(static_cast<long long>(PIX),
                                       im.pixels - p0));
    {
      float now[PIX][3], next[PIX][3], l_now[PIX], l_next[PIX];
      float e_now[PIX], e_next[PIX];
      load_render(im, 0, bg, p0, n, vec, now, e_now);
      load_render(im, 1, bg, p0, n, vec, next, e_next);
      load_l(gt_now, im.gt[0].ch, p0, n, vec, k, l_now);
      load_l(gt_next, im.gt[1].ch, p0, n, vec, k, l_next);
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
        if (j < n) {
          const EventPixel ev =
              event_pixel(now[j], next[j], l_now[j], l_next[j], c, k);
          const float g_r = __fmul_rn(g_event, sgn(ev.r));
          const float g_d = __fdiv_rn(g_r, c);
          const float g_a_now = __fdiv_rn(-g_d, ev.a_now);
          const float g_a_next = __fdiv_rn(g_d, ev.a_next);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            now[j][ch] = __fmul_rn(g_a_now, k.w[ch]);
            next[j][ch] = __fmul_rn(g_a_next, k.w[ch]);
          }
          s_c += static_cast<double>(__fmul_rn(-g_r, __fdiv_rn(ev.img, c)));
        }
      }
      store_render(im, out, 0, bg, p0, n, vec, now, e_now);
      store_render(im, out, 1, bg, p0, n, vec, next, e_next);
    }
    float m[PIX][3], gt[PIX][3], e_main[PIX];
    load_render(im, 2, bg, p0, n, vec, m, e_main);
    load3(gt_main, im.gt[2].ch, p0, n, vec, gt);
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float d = __fsub_rn(m[j][ch], gt[j][ch]);
        gt[j][ch] = __fmul_rn(g_int, sgn(d));
      }
    }
    if (deblur) {
      // m is read for the blurry term; the main gradient waits in gt
      float b[PIX][3];
      load3(blurry, im.gt[3].ch, p0, n, vec, b);
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          gt[j][ch] = __fadd_rn(
              gt[j][ch],
              __fmul_rn(g_blur, sgn(__fsub_rn(m[j][ch], b[j][ch]))));
        }
      }
    }
    store_render(im, out, 2, bg, p0, n, vec, gt, e_main);
  }
  double v[1] = {s_c};
  block_sum<THREADS, 1>(v, threadIdx.x);
  if (!arrive<1>(v, partials, blockIdx.x, gridDim.x, &backward_arrivals,
                 threadIdx.x)) {
    return;
  }
  total<THREADS, 1>(partials, gridDim.x, v, threadIdx.x);
  if (threadIdx.x != 0) return;
  *g_contrast = __double2float_rn(v[0]);
  backward_arrivals = 0;  // every block has counted in
}

// the kernels' logf and expf over n floats: hooks for the card tests that
// hold them against PyTorch's torch.log and torch.exp (they run on no path)
__global__ void logf_kernel(const float* __restrict__ x, float* __restrict__ y,
                            long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i < n) y[i] = logf(x[i]);
}

__global__ void expf_kernel(const float* __restrict__ x, float* __restrict__ y,
                            long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i < n) y[i] = expf(x[i]);
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the launch's operands (see N_OPERANDS, N_SIZES), or false if one is
// missing or malformed: a channel count not 1 or 3, log T without the
// background, an index into an empty stack or over frames shorter than P
bool images(const void* const* ops, const long long* sizes, int pixels,
            Images& im) {
  if (pixels < 1) return false;
  im.pixels = pixels;
  im.chunks = (static_cast<long long>(pixels) + PIX - 1) / PIX;
  bool vec = true, composed = false;
  for (int r = 0; r < RENDERS; ++r) {
    im.rgb[r] = static_cast<const float*>(ops[2 * r]);
    im.logt[r] = static_cast<const float*>(ops[2 * r + 1]);
    if (im.rgb[r] == nullptr) return false;
    vec = vec && aligned(im.rgb[r]) &&
          (im.logt[r] == nullptr || aligned(im.logt[r]));
    composed = composed || im.logt[r] != nullptr;
  }
  im.bg = static_cast<const float*>(ops[2 * RENDERS]);
  if (composed && im.bg == nullptr) return false;
  for (int i = 0; i < GTS; ++i) {
    Gt& g = im.gt[i];
    g.base = static_cast<const float*>(ops[2 * RENDERS + 1 + 2 * i]);
    g.index = static_cast<const long long*>(ops[2 * RENDERS + 2 + 2 * i]);
    g.ch = static_cast<int>(sizes[3 * i]);
    g.frames = sizes[3 * i + 1];
    g.stride = sizes[3 * i + 2];
    if (g.base == nullptr) {
      if (i < GTS - 1 || g.index != nullptr) return false;
      continue;
    }
    if (g.ch != 1 && g.ch != 3) return false;
    if (g.index != nullptr &&
        (g.frames < 1 || g.stride < static_cast<long long>(pixels) * g.ch)) {
      return false;
    }
    vec = vec && aligned(g.base) && (g.index == nullptr || g.stride % 4 == 0);
  }
  im.vec = vec;
  return true;
}

Consts consts(const float* c) {
  Consts k;
  k.w[0] = c[0];
  k.w[1] = c[1];
  k.w[2] = c[2];
  k.eps = c[3];
  k.gt_inv = c[4];
  k.event_w = c[5];
  k.intens_w = c[6];
  k.blur_a = c[7];
  k.base_w = c[8];
  k.inv_pix = c[9];
  k.inv_vals = c[10];
  return k;
}

// a grid the card holds at once, at most max_blocks (the partials' rows):
// a grid-stride loop's blocks all do the same work
template <typename Kernel>
cudaError_t grid(Kernel kernel, long long chunks, int max_blocks,
                 int& blocks) {
  int device = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return err;
  long long b = (chunks + THREADS - 1) / THREADS;
  b = b < static_cast<long long>(sms) * resident
          ? b : static_cast<long long>(sms) * resident;
  b = b < max_blocks ? b : max_blocks;
  blocks = static_cast<int>(b < 1 ? 1 : b);
  return cudaSuccess;
}

}  // namespace

// operands: a host array of N_OPERANDS device pointers, per render (now,
// next, main) its rgb or image ([P, 3]) and its log T ([P]) or null, the
// background ([3]) or null where no render has log T, per GT operand
// (gt_now, gt_next, gt_main, blurry) its image ([P, 1 or 3]) or stack and
// its [1] int64 index or null (blurry's image null: event mode); sizes: a
// host array of N_SIZES int64, per GT operand its channels (1 or 3), the
// frames of its stack and the floats from one frame to the next (both
// read only with an index); P, the N_CONSTS constants, the contrast (a
// device float), the partials scratch (max_blocks rows of N_SUMS doubles),
// the loss (a device float) and 4 device floats event_l1, intensity_l1,
// coverage, blur_l1 (0 without blurry).
extern "C" int e3d_event_loss_forward(
    const void* const* operands, const long long* sizes, int pixels,
    const float* constants, const void* contrast, void* partials,
    int max_blocks, void* loss_out, void* aux_out, cudaStream_t stream) {
  Images im;
  if (!images(operands, sizes, pixels, im) || max_blocks < 1) {
    return cudaErrorInvalidValue;
  }
  int blocks = 0;
  cudaError_t err = grid(event_loss_forward_kernel, im.chunks, max_blocks,
                         blocks);
  if (err != cudaSuccess) return err;
  event_loss_forward_kernel<<<blocks, THREADS, 0, stream>>>(
      im, consts(constants), static_cast<const float*>(contrast),
      static_cast<double*>(partials), static_cast<float*>(loss_out),
      static_cast<float*>(aux_out));
  return cudaGetLastError();
}

// the forward's operands, sizes, P and constants, the contrast, the loss's
// gradient and the forward's coverage (device floats), the partials
// scratch (max_blocks doubles), a host array of 6 device pointers (per
// render d rgb or d image [P, 3], and d log T [P] where it has log T, else
// null) and the contrast's gradient (a device float).
extern "C" int e3d_event_loss_backward(
    const void* const* operands, const long long* sizes, int pixels,
    const float* constants, const void* contrast, const void* grad,
    const void* coverage, void* partials, int max_blocks,
    void* const* grads_out, void* g_contrast, cudaStream_t stream) {
  Images im;
  if (!images(operands, sizes, pixels, im) || max_blocks < 1) {
    return cudaErrorInvalidValue;
  }
  Grads out;
  for (int r = 0; r < RENDERS; ++r) {
    out.rgb[r] = static_cast<float*>(grads_out[2 * r]);
    out.logt[r] = static_cast<float*>(grads_out[2 * r + 1]);
    if (out.rgb[r] == nullptr || !aligned(out.rgb[r]) ||
        (out.logt[r] == nullptr) != (im.logt[r] == nullptr) ||
        (out.logt[r] != nullptr && !aligned(out.logt[r]))) {
      return cudaErrorInvalidValue;
    }
  }
  int blocks = 0;
  cudaError_t err = grid(event_loss_backward_kernel, im.chunks, max_blocks,
                         blocks);
  if (err != cudaSuccess) return err;
  event_loss_backward_kernel<<<blocks, THREADS, 0, stream>>>(
      im, consts(constants), static_cast<const float*>(contrast),
      static_cast<const float*>(grad), static_cast<const float*>(coverage),
      static_cast<double*>(partials), out, static_cast<float*>(g_contrast));
  return cudaGetLastError();
}

// x, y (n device floats), n: y = logf(x) as the loss kernels compute it
extern "C" int e3d_event_loss_logf(const void* x, void* y, long long n,
                                   cudaStream_t stream) {
  if (n < 1) return n == 0 ? cudaSuccess : cudaErrorInvalidValue;
  const long long blocks = (n + THREADS - 1) / THREADS;
  logf_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return cudaGetLastError();
}

// x, y (n device floats), n: y = expf(x) as the loss kernels compute it
extern "C" int e3d_event_loss_expf(const void* x, void* y, long long n,
                                   cudaStream_t stream) {
  if (n < 1) return n == 0 ? cudaSuccess : cudaErrorInvalidValue;
  const long long blocks = (n + THREADS - 1) / THREADS;
  expf_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return cudaGetLastError();
}
