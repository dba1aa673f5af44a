// Per-Gaussian preprocess: projection to screen space and SH colours,
// forward and backward, over the V views (1 to 3) that a step renders.
//
// Replaces what the JAX package leaves to XLA around the rasterizer:
// `project_gaussians` (event3dgs_tpu/ops/projection.py:51) and
// `gaussian_colors` (event3dgs_tpu/ops/render.py:49), which XLA fuses into a
// few fusions a direction on the TPU, and their autodiff; and, in the train
// step, the feature concatenation (event3dgs_tpu/models/gaussians.py:76),
// the SH mask (event3dgs_tpu/train/step.py:135) and the sums of the three
// renders' gradients.  In plain PyTorch the same work is some 800
// elementwise launches a render and direction.  Here it is one launch
// forward and one backward for all the views, one thread per Gaussian (the
// upstream CUDA rasterizer's preprocessCUDA / BACKWARD::preprocess).
//
// Inputs: the means, activated scales, quaternions (not normalised), the
// optional opacities, the feature leaves features_dc [N, 1, 3] and
// features_rest [N, K-1, 3], each with its own row stride (an [N, K, 3]
// tensor passes as two strided views of itself), the optional [K] SH mask
// and V cameras.  The mask and the cameras are read from device memory: the
// graphed train step picks its cameras and degree on the device.
//
// Forward (e3d_preprocess_forward): for each view it writes what
// ops/projection.project_gaussians and ops/render.gaussian_colors return on
// features * mask: mean2d [N, 2], depth [N], conic [N, 3], radius [N],
// valid [N] (bool) and colours [N, 3] = max(eval_sh + 0.5, 0).  Without
// features it projects only.  The first view's mean2d takes the optional
// [N, 2] tap (mean2d + tap, as the render adds it).  Where a view's packed
// rows are asked for (with features and opacities), it also writes the
// [N, 12] rows the compositing kernels K1 and K2 read, as
// ops/rasterize_tiled.pack_features lays them out: mean2d (tapped), the
// conic times (-0.5, -1, -0.5), the opacity, the colours and three zeros;
// the train step and the render then build no rows of their own.  Every
// operation is the plain version's, one
// rounding each, in its order (the build has -fmad=false), and each
// coefficient is multiplied by its mask entry before the SH sum, as
// features * mask rounds: the outputs equal the plain PyTorch version's bit
// for bit, so the binning's rects from radius and valid do not move.  The
// norms of the quaternion and of the SH direction are summed in index order
// in both.
//
// Backward (e3d_preprocess_backward): from each view's gradients of mean2d,
// conic and colours (any may be null: zero; each a row stride of its own,
// as the rasterizer hands over slices of its [N, 9] sums) it recomputes the
// forward's intermediates and writes the gradients of the means (the
// projection's part and the SH direction's), scales, quaternions and both
// feature leaves, summed over the views: a view's mean gradient is its
// projection's part plus its SH part, the views' gradients are added from
// the last to the first, (g_2 + g_1) + g_0, and the feature rows' sum is
// then multiplied by the mask.  That is the order in which autograd adds
// the gradients of three renders made one after another, each with its
// own preprocess: a step's gradients equal those of the step that renders
// each view on its own.  The feature gradients equal the plain version's
// bit for bit; the others differ by the order of a few sums inside a
// view.  Depth, radius and
// valid take no gradient, nor do the opacities (the forward only culls by
// them).  A Gaussian not valid in a view gets exactly zero from it: the
// rasterizers give it no gradient, and the branches it took (a Gaussian on
// the camera plane, at the camera centre) would give 0·inf.  Each thread
// writes its own rows; there are no atomics and no sums across threads, so
// the gradients repeat bit for bit.
//
// Bound: bytes.  At SH degree 3 the forward reads 236 bytes a Gaussian
// (means, scales, quaternion, opacity, 192 of features) and the tap's 8,
// and writes 41 a view and the packed row's 48; the backward reads 232
// and 33 a view (upstream gradients and valid) and writes 232.  A few
// hundred FP32 operations a Gaussian and view stay below the bytes' time.
// Design for Hopper:
// - A block of 128 threads stages its 128 feature rows in shared memory:
//   the dc rows [128, 3], then the rest rows [128, 3(K-1)], each leaf as
//   it lies.  Where a leaf's rows are contiguous and 16-byte aligned (the
//   train step's leaves), one thread asks the TMA for the block's rows with
//   one 1-D bulk copy (cp.async.bulk) that completes on an mbarrier; what
//   is left past the last 16 bytes, and a strided leaf, go float by float
//   with cp.async.  The copies are issued first and waited for only where
//   the SH part begins, so the projection of every view (in the backward
//   some 350 FP32 operations a view) runs while they are in flight.  A
//   thread's rows lie 3 and 3(K-1) floats apart: odd at K = 16 (45), so a
//   warp reading float j of its rows hits 32 banks.
// - The backward sums over the views in registers (means, scales,
//   quaternions) and in the thread's staged rows (features): the SH part of
//   every view reads the rows first, keeping the view's direction and
//   colour gradient (6 floats), then the rows are overwritten with the
//   feature gradient, each view's basis computed again.  The block then
//   writes the two leaves' gradients as one [N, K, 3] tensor, a warp a
//   row of 3K floats, coalesced and whole.
// - The backward's recompute of the projection takes one reciprocal where
//   the forward divides (the quaternion's norm, the depth, the SH
//   direction's norm): it decides no output of the forward, and the
//   divisions are the longest chains of a view's some 350 operations.
//   The mask multiplies each thread's staged rows once.
// - The packed row of a view (48 bytes, 16-byte aligned) is written whole
//   where the view is coloured, three float4 stores a thread back to back
//   (a warp's three cover 1,536 contiguous bytes); its first 6 floats wait
//   in registers from the projection.  Measured in trial builds on the
//   H100: written as two halves where each is computed (the registers and
//   blocks of the kernel without rows), the sectors that the two halves
//   share reach memory apart and the rows cost far more than their bytes
//   at 2M slots; staged in shared memory (one block fewer an SM), about
//   as fast as this at 2M and a little faster at 100k.
// - No tensor cores: each Gaussian has its own 16 × 3 features, so there is
//   no shared matrix product.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_K = 25;     // SH degree 4
constexpr int MAX_VIEWS = 3;  // the event modes' renders a step
constexpr int FEAT = 12;      // floats of a packed row (pack_features)

// the plain version's Python float constants, rounded to float32 as
// PyTorch rounds a scalar operand
constexpr float NEAR_CULL_Z = static_cast<float>(0.2);
constexpr float PROJ_EPS = static_cast<float>(1e-7);
constexpr float DILATION = static_cast<float>(0.3);
constexpr float RAY_CLAMP = static_cast<float>(1.3);
constexpr float LAMBDA_FLOOR = static_cast<float>(0.1);
constexpr float MIN_OPACITY = static_cast<float>(1.0 / 255.0);

constexpr float C0 = static_cast<float>(0.28209479177387814);
constexpr float C1 = static_cast<float>(0.4886025119029199);
constexpr float NC1 = static_cast<float>(-0.4886025119029199);
constexpr float C2_0 = static_cast<float>(1.0925484305920792);
constexpr float C2_1 = static_cast<float>(-1.0925484305920792);
constexpr float C2_2 = static_cast<float>(0.31539156525252005);
constexpr float C2_3 = static_cast<float>(-1.0925484305920792);
constexpr float C2_4 = static_cast<float>(0.5462742152960396);
constexpr float C3_0 = static_cast<float>(-0.5900435899266435);
constexpr float C3_1 = static_cast<float>(2.890611442640554);
constexpr float C3_2 = static_cast<float>(-0.4570457994644658);
constexpr float C3_3 = static_cast<float>(0.3731763325901154);
constexpr float C3_4 = static_cast<float>(-0.4570457994644658);
constexpr float C3_5 = static_cast<float>(1.445305721320277);
constexpr float C3_6 = static_cast<float>(-0.5900435899266435);
constexpr float C4_0 = static_cast<float>(2.5033429417967046);
constexpr float C4_1 = static_cast<float>(-1.7701307697799304);
constexpr float C4_2 = static_cast<float>(0.9461746957575601);
constexpr float C4_3 = static_cast<float>(-0.6690465435572892);
constexpr float C4_4 = static_cast<float>(0.10578554691520431);
constexpr float C4_5 = static_cast<float>(-0.6690465435572892);
constexpr float C4_6 = static_cast<float>(0.47308734787878004);
constexpr float C4_7 = static_cast<float>(-1.7701307697799304);
constexpr float C4_8 = static_cast<float>(0.6258357354491761);

// the camera: world_view and full_proj (row-vector convention, row-major
// [4, 4]), centre, tan(fov/2), and the focal lengths in pixels
struct Camera {
  float W[16];
  float P[16];
  float C[3];
  float tanx, tany, fx, fy;
};

// One view of a launch: its camera's device pointers and its size; the
// forward's outputs; the backward's inputs (the forward's valid, and the
// gradients of mean2d, conic and colours, each null or with a row stride).
struct View {
  const float* wv;
  const float* fp;
  const float* cc;
  const float* tx;
  const float* ty;
  int width, height;
  float* mean2d;
  float* depth;
  float* conic;
  float* radius;
  bool* valid;
  float* colors;
  float* feat;  // packed rows [N, 12], or null
  const unsigned char* valid_in;
  const float* g_mean2d;
  const float* g_conic;
  const float* g_colors;
  int ld_mean2d, ld_conic, ld_colors;
};

// A launch's arguments, passed by value (a CUDA graph captures them with
// the launch).  Row strides are in floats.
struct Args {
  const float* means;
  const float* scales;
  const float* rots;
  const float* opac;   // forward, or null
  const float* tap;    // forward: the first view's [N, 2] mean2d tap, or null
  const float* dc;     // [N, 1, 3], or null at degree -1
  const float* rest;   // [N, K-1, 3]
  const float* cmask;  // [K], or null
  float* g_means;      // backward
  float* g_scales;
  float* g_rots;
  float* g_feats;      // [N, K, 3]: both leaves' gradients
  long long ld_dc, ld_rest, ld_gfeats;
  int n, K, nviews;
  float smod;
  View view[MAX_VIEWS];
};

// The views' cameras into shared memory (20 floats a view: W, P, C and
// the tangents), and the mask (ones without one).  A view is indexed by a
// constant: a kernel parameter indexed at run time would be copied to
// local memory.
__device__ __forceinline__ void load_views(Camera* cams, float* mask,
                                           const Args& a) {
  for (int e = threadIdx.x; e < 20 * MAX_VIEWS + MAX_K; e += THREADS) {
    const int t = e % 20;
#pragma unroll
    for (int v = 0; v < MAX_VIEWS; ++v) {
      if (e / 20 == v && v < a.nviews) {
        const View& w = a.view[v];
        if (t < 16) {
          cams[v].W[t] = w.wv[t];
          cams[v].P[t] = w.fp[t];
        } else if (t < 19) {
          cams[v].C[t - 16] = w.cc[t - 16];
        } else {
          // fx = width / (2 tan): PyTorch takes the reciprocal, then
          // multiplies
          cams[v].tanx = *w.tx;
          cams[v].tany = *w.ty;
          cams[v].fx = (1.0f / (cams[v].tanx * 2.0f)) * (float)w.width;
          cams[v].fy = (1.0f / (cams[v].tany * 2.0f)) * (float)w.height;
        }
      }
    }
    const int k = e - 20 * MAX_VIEWS;
    if (k >= 0 && k < a.K)
      mask[k] = a.cmask != nullptr ? a.cmask[k] : 1.0f;
  }
}

// torch.clamp (NaN passes through)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_minf(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// x * s as one multiply, as PyTorch's product with a scale tensor rounds
// (the compiler would turn x * -1 into a negation, which may keep a NaN's
// sign where the multiply gives the canonical NaN)
__device__ __forceinline__ float mulf(float x, float s) {
  float r;
  asm("mul.rn.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(s));
  return r;
}

// m0 * M[0, j] + m1 * M[1, j] + m2 * M[2, j] + M[3, j]
__device__ __forceinline__ float xform(const float* M, int j, float m0,
                                       float m1, float m2) {
  return ((m0 * M[j] + m1 * M[4 + j]) + m2 * M[8 + j]) + M[12 + j];
}

// What projection.project_gaussians computes for one Gaussian, in its
// order of operations, with the intermediates the backward reads.
struct Proj {
  float tv0, tv1, tz;
  bool in_front;
  float pc0, pc1, inv_w, mx, my;
  float fx, fy, lim_x, lim_y, safe_tz, rx, ry, cx, cy, txz, tyz;
  float inv_z, inv_z2;
  float u[3], v[3];
  float nq, inv_nq, qn[4], R[3][3];
  float s[3], Tu[3], Tv[3], wu[3], wv[3];
  float a, b, c, det, safe_det;
  bool det_ok;
  float conic[3], radius;
  bool valid;
};

// m, sc, q: the Gaussian's mean, scale and quaternion; the opacity cull is
// the caller's.  EXACT: the forward's operations, each rounding as the plain
// version's; else (the backward's recompute, which decides no output of
// the forward) the quaternion is normalised by one reciprocal and four
// products in place of four divisions.
template <bool EXACT>
__device__ __forceinline__ void project(const Camera& cam, const float* m,
                                        const float* sc, const float* q,
                                        int width, int height, float smod,
                                        Proj& p) {
  const float* W = cam.W;
  const float m0 = m[0], m1 = m[1], m2 = m[2];
  p.tv0 = xform(W, 0, m0, m1, m2);
  p.tv1 = xform(W, 1, m0, m1, m2);
  p.tz = xform(W, 2, m0, m1, m2);
  p.in_front = p.tz > NEAR_CULL_Z;
  p.pc0 = xform(cam.P, 0, m0, m1, m2);
  p.pc1 = xform(cam.P, 1, m0, m1, m2);
  const float pcw = xform(cam.P, 3, m0, m1, m2);
  p.inv_w = 1.0f / (pcw + PROJ_EPS);
  p.mx = ((p.pc0 * p.inv_w + 1.0f) * (float)width - 1.0f) * 0.5f;
  p.my = ((p.pc1 * p.inv_w + 1.0f) * (float)height - 1.0f) * 0.5f;

  p.fx = cam.fx;
  p.fy = cam.fy;
  p.safe_tz = p.in_front ? p.tz : 1.0f;
  p.lim_x = cam.tanx * RAY_CLAMP;
  p.lim_y = cam.tany * RAY_CLAMP;
  p.rx = p.tv0 / p.safe_tz;
  p.ry = p.tv1 / p.safe_tz;
  p.cx = clampf(p.rx, -p.lim_x, p.lim_x);
  p.cy = clampf(p.ry, -p.lim_y, p.lim_y);
  p.txz = p.cx * p.safe_tz;
  p.tyz = p.cy * p.safe_tz;
  p.inv_z = 1.0f / p.safe_tz;
  p.inv_z2 = p.inv_z * p.inv_z;
  const float au = p.fx * p.inv_z;
  const float bu = ((-p.fx) * p.txz) * p.inv_z2;
  const float av = p.fy * p.inv_z;
  const float bv = ((-p.fy) * p.tyz) * p.inv_z2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.u[k] = au * W[4 * k] + bu * W[4 * k + 2];
    p.v[k] = av * W[4 * k + 1] + bv * W[4 * k + 2];
  }

  p.nq = sqrtf(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]);
  p.inv_nq = 1.0f / p.nq;
#pragma unroll
  for (int k = 0; k < 4; ++k) p.qn[k] = EXACT ? q[k] / p.nq : q[k] * p.inv_nq;
  const float qw = p.qn[0], qx = p.qn[1], qy = p.qn[2], qz = p.qn[3];
  p.R[0][0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  p.R[0][1] = 2.0f * (qx * qy - qw * qz);
  p.R[0][2] = 2.0f * (qx * qz + qw * qy);
  p.R[1][0] = 2.0f * (qx * qy + qw * qz);
  p.R[1][1] = 1.0f - 2.0f * (qx * qx + qz * qz);
  p.R[1][2] = 2.0f * (qy * qz - qw * qx);
  p.R[2][0] = 2.0f * (qx * qz - qw * qy);
  p.R[2][1] = 2.0f * (qy * qz + qw * qx);
  p.R[2][2] = 1.0f - 2.0f * (qx * qx + qy * qy);

#pragma unroll
  for (int j = 0; j < 3; ++j) {
    p.s[j] = sc[j] * smod;
    // Python's sum() starts at 0
    p.Tu[j] = ((0.0f + p.u[0] * p.R[0][j]) + p.u[1] * p.R[1][j])
              + p.u[2] * p.R[2][j];
    p.Tv[j] = ((0.0f + p.v[0] * p.R[0][j]) + p.v[1] * p.R[1][j])
              + p.v[2] * p.R[2][j];
    p.wu[j] = p.s[j] * p.Tu[j];
    p.wv[j] = p.s[j] * p.Tv[j];
  }
  p.a = (((0.0f + p.wu[0] * p.wu[0]) + p.wu[1] * p.wu[1]) + p.wu[2] * p.wu[2])
        + DILATION;
  p.b = ((0.0f + p.wu[0] * p.wv[0]) + p.wu[1] * p.wv[1]) + p.wu[2] * p.wv[2];
  p.c = (((0.0f + p.wv[0] * p.wv[0]) + p.wv[1] * p.wv[1]) + p.wv[2] * p.wv[2])
        + DILATION;
  p.det = p.a * p.c - p.b * p.b;
  p.det_ok = p.det > 0.0f;
  p.safe_det = p.det_ok ? p.det : 1.0f;
  p.conic[0] = p.c / p.safe_det;
  p.conic[1] = (-p.b) / p.safe_det;
  p.conic[2] = p.a / p.safe_det;

  const float mid = 0.5f * (p.a + p.c);
  const float lam = mid + sqrtf(clamp_minf(mid * mid - p.det, LAMBDA_FLOOR));
  p.radius = ceilf(3.0f * sqrtf(lam));
  const bool on_screen = (p.mx + p.radius > 0.0f)
                         && (p.mx - p.radius < (float)width)
                         && (p.my + p.radius > 0.0f)
                         && (p.my - p.radius < (float)height);
  p.valid = p.in_front && p.det_ok && on_screen;
}


// The direction from the camera centre, normalised as the plain version
// does: (d0² + d1²) + d2², a square root, three divisions.
__device__ __forceinline__ float direction(const Camera& cam, const float* m,
                                           float* dir) {
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = m[k] - cam.C[k];
  const float nrm = sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) dir[k] = d[k] / nrm;
  return nrm;
}

// core/sh.sh_basis at one unit direction, in its order of operations
template <int D>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* B) {
  B[0] = C0;
  if constexpr (D >= 1) {
    B[1] = NC1 * y;
    B[2] = C1 * z;
    B[3] = NC1 * x;
  }
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  if constexpr (D >= 2) {
    B[4] = C2_0 * xy;
    B[5] = C2_1 * yz;
    B[6] = C2_2 * ((2.0f * zz - xx) - yy);
    B[7] = C2_3 * xz;
    B[8] = C2_4 * (xx - yy);
  }
  if constexpr (D >= 3) {
    B[9] = (C3_0 * y) * (3.0f * xx - yy);
    B[10] = (C3_1 * xy) * z;
    B[11] = (C3_2 * y) * ((4.0f * zz - xx) - yy);
    B[12] = (C3_3 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
    B[13] = (C3_4 * x) * ((4.0f * zz - xx) - yy);
    B[14] = (C3_5 * z) * (xx - yy);
    B[15] = (C3_6 * x) * (xx - 3.0f * yy);
  }
  if constexpr (D >= 4) {
    B[16] = (C4_0 * xy) * (xx - yy);
    B[17] = (C4_1 * yz) * (3.0f * xx - yy);
    B[18] = (C4_2 * xy) * (7.0f * zz - 1.0f);
    B[19] = (C4_3 * yz) * (7.0f * zz - 3.0f);
    B[20] = C4_4 * (zz * (35.0f * zz - 30.0f) + 3.0f);
    B[21] = (C4_5 * xz) * (7.0f * zz - 3.0f);
    B[22] = (C4_6 * (xx - yy)) * (7.0f * zz - 1.0f);
    B[23] = (C4_7 * xz) * (xx - 3.0f * yy);
    B[24] = C4_8 * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
  }
}

// g += dB · ∂B/∂(x, y, z), the basis taken as a function of three free
// coordinates (the direction's normalisation is differentiated apart)
template <int D>
__device__ __forceinline__ void sh_basis_backward(float x, float y, float z,
                                                  const float* dB, float* g) {
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if constexpr (D >= 1) {
    gy += -C1 * dB[1];
    gz += C1 * dB[2];
    gx += -C1 * dB[3];
  }
  const float xx = x * x, yy = y * y, zz = z * z;
  if constexpr (D >= 2) {
    gx += C2_0 * y * dB[4];
    gy += C2_0 * x * dB[4];
    gy += C2_1 * z * dB[5];
    gz += C2_1 * y * dB[5];
    gx += -2.0f * C2_2 * x * dB[6];
    gy += -2.0f * C2_2 * y * dB[6];
    gz += 4.0f * C2_2 * z * dB[6];
    gx += C2_3 * z * dB[7];
    gz += C2_3 * x * dB[7];
    gx += 2.0f * C2_4 * x * dB[8];
    gy += -2.0f * C2_4 * y * dB[8];
  }
  if constexpr (D >= 3) {
    gx += C3_0 * 6.0f * x * y * dB[9];
    gy += C3_0 * 3.0f * (xx - yy) * dB[9];
    gx += C3_1 * y * z * dB[10];
    gy += C3_1 * x * z * dB[10];
    gz += C3_1 * x * y * dB[10];
    gx += C3_2 * -2.0f * x * y * dB[11];
    gy += C3_2 * (4.0f * zz - xx - 3.0f * yy) * dB[11];
    gz += C3_2 * 8.0f * y * z * dB[11];
    gx += C3_3 * -6.0f * x * z * dB[12];
    gy += C3_3 * -6.0f * y * z * dB[12];
    gz += C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * dB[12];
    gx += C3_4 * (4.0f * zz - 3.0f * xx - yy) * dB[13];
    gy += C3_4 * -2.0f * x * y * dB[13];
    gz += C3_4 * 8.0f * x * z * dB[13];
    gx += C3_5 * 2.0f * x * z * dB[14];
    gy += C3_5 * -2.0f * y * z * dB[14];
    gz += C3_5 * (xx - yy) * dB[14];
    gx += C3_6 * 3.0f * (xx - yy) * dB[15];
    gy += C3_6 * -6.0f * x * y * dB[15];
  }
  if constexpr (D >= 4) {
    gx += C4_0 * y * (3.0f * xx - yy) * dB[16];
    gy += C4_0 * x * (xx - 3.0f * yy) * dB[16];
    gx += C4_1 * 6.0f * x * y * z * dB[17];
    gy += C4_1 * 3.0f * z * (xx - yy) * dB[17];
    gz += C4_1 * y * (3.0f * xx - yy) * dB[17];
    gx += C4_2 * y * (7.0f * zz - 1.0f) * dB[18];
    gy += C4_2 * x * (7.0f * zz - 1.0f) * dB[18];
    gz += C4_2 * 14.0f * x * y * z * dB[18];
    gy += C4_3 * z * (7.0f * zz - 3.0f) * dB[19];
    gz += C4_3 * y * (21.0f * zz - 3.0f) * dB[19];
    gz += C4_4 * z * (140.0f * zz - 60.0f) * dB[20];
    gx += C4_5 * z * (7.0f * zz - 3.0f) * dB[21];
    gz += C4_5 * x * (21.0f * zz - 3.0f) * dB[21];
    gx += C4_6 * 2.0f * x * (7.0f * zz - 1.0f) * dB[22];
    gy += C4_6 * -2.0f * y * (7.0f * zz - 1.0f) * dB[22];
    gz += C4_6 * 14.0f * z * (xx - yy) * dB[22];
    gx += C4_7 * 3.0f * z * (xx - yy) * dB[23];
    gy += C4_7 * -6.0f * x * y * z * dB[23];
    gz += C4_7 * x * (xx - 3.0f * yy) * dB[23];
    gx += C4_8 * 4.0f * x * (xx - 3.0f * yy) * dB[24];
    gy += C4_8 * 4.0f * y * (yy - 3.0f * xx) * dB[24];
  }
  g[0] += gx;
  g[1] += gy;
  g[2] += gz;
}

// The projection's part of one view's gradients of a Gaussian valid in it:
// from the view's gradients of conic and mean2d at row i, the gradients of
// the mean (gm), scale (gs) and quaternion (gq).
__device__ __forceinline__ void project_backward(
    const Camera& cam, const View& view, int i, const float* m,
    const float* sc, const float* q, float smod, float* gm, float* gs,
    float* gq) {
  const int width = view.width, height = view.height;
  const float* g_mean2d = view.g_mean2d;
  const float* g_conic = view.g_conic;
  const int ld_mean2d = view.ld_mean2d, ld_conic = view.ld_conic;
  Proj p;
  project<false>(cam, m, sc, q, width, height, smod, p);
  const float* W = cam.W;
  const float* P = cam.P;

  // conic = (c, -b, a) / det
  float gA = 0.0f, gB = 0.0f, gC = 0.0f;
  if (g_conic != nullptr) {
    const float* g = g_conic + (size_t)i * ld_conic;
    gA = g[0];
    gB = g[1];
    gC = g[2];
  }
  const float inv_det = 1.0f / p.det;
  const float ddet = -(gA * p.c - gB * p.b + gC * p.a) * inv_det * inv_det;
  const float da = gC * inv_det + ddet * p.c;
  const float db = -gB * inv_det - 2.0f * p.b * ddet;
  const float dc = gA * inv_det + ddet * p.a;
  // a = |wu|² + 0.3, b = wu·wv, c = |wv|² + 0.3; wu_j = s_j Tu_j
  float dTu[3], dTv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float dwu = 2.0f * p.wu[j] * da + p.wv[j] * db;
    const float dwv = 2.0f * p.wv[j] * dc + p.wu[j] * db;
    gs[j] = (dwu * p.Tu[j] + dwv * p.Tv[j]) * smod;
    dTu[j] = dwu * p.s[j];
    dTv[j] = dwv * p.s[j];
  }
  // Tu_j = Σ_i u_i R_ij
  float du[3], dv[3], dR[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    du[k] = dTu[0] * p.R[k][0] + dTu[1] * p.R[k][1] + dTu[2] * p.R[k][2];
    dv[k] = dTv[0] * p.R[k][0] + dTv[1] * p.R[k][1] + dTv[2] * p.R[k][2];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      dR[k][j] = p.u[k] * dTu[j] + p.v[k] * dTv[j];
  }
  // the rotation's entries from the normalised quaternion, then q/|q|
  const float qw = p.qn[0], qx = p.qn[1], qy = p.qn[2], qz = p.qn[3];
  float dqn[4];
  dqn[0] = 2.0f * (-qz * dR[0][1] + qy * dR[0][2] + qz * dR[1][0]
                   - qx * dR[1][2] - qy * dR[2][0] + qx * dR[2][1]);
  dqn[1] = 2.0f * (qy * dR[0][1] + qz * dR[0][2] + qy * dR[1][0]
                   - 2.0f * qx * dR[1][1] - qw * dR[1][2] + qz * dR[2][0]
                   + qw * dR[2][1] - 2.0f * qx * dR[2][2]);
  dqn[2] = 2.0f * (-2.0f * qy * dR[0][0] + qx * dR[0][1] + qw * dR[0][2]
                   + qx * dR[1][0] + qz * dR[1][2] - qw * dR[2][0]
                   + qz * dR[2][1] - 2.0f * qy * dR[2][2]);
  dqn[3] = 2.0f * (-2.0f * qz * dR[0][0] - qw * dR[0][1] + qx * dR[0][2]
                   + qw * dR[1][0] - 2.0f * qz * dR[1][1] + qy * dR[1][2]
                   + qx * dR[2][0] + qy * dR[2][1]);
  const float dot = dqn[0] * qw + dqn[1] * qx + dqn[2] * qy + dqn[3] * qz;
#pragma unroll
  for (int k = 0; k < 4; ++k) gq[k] = (dqn[k] - p.qn[k] * dot) * p.inv_nq;

  // u_k = au W[k, 0] + bu W[k, 2], v_k = av W[k, 1] + bv W[k, 2]
  float dau = 0.0f, dbu = 0.0f, dav = 0.0f, dbv = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dau += du[k] * W[4 * k];
    dbu += du[k] * W[4 * k + 2];
    dav += dv[k] * W[4 * k + 1];
    dbv += dv[k] * W[4 * k + 2];
  }
  // au = fx/z, bu = -fx txz/z², av = fy/z, bv = -fy tyz/z²
  const float dinv_z2 = -p.fx * p.txz * dbu - p.fy * p.tyz * dbv;
  const float dinv_z = p.fx * dau + p.fy * dav + 2.0f * p.inv_z * dinv_z2;
  const float dtxz = -p.fx * p.inv_z2 * dbu;
  const float dtyz = -p.fy * p.inv_z2 * dbv;
  float dtz = -dinv_z * p.inv_z * p.inv_z + dtxz * p.cx + dtyz * p.cy;
  // txz = clamp(tv0 / z) z: no gradient through the clamp where it clips
  const float drx = (p.rx >= -p.lim_x && p.rx <= p.lim_x) ? dtxz * p.tz
                                                         : 0.0f;
  const float dry = (p.ry >= -p.lim_y && p.ry <= p.lim_y) ? dtyz * p.tz
                                                         : 0.0f;
  // a valid Gaussian lies past the near plane: 1/tz is inv_z
  const float dtv0 = drx * p.inv_z, dtv1 = dry * p.inv_z;
  dtz -= dtv0 * p.rx + dtv1 * p.ry;

  // mean2d = ((pc · inv_w + 1) size - 1) / 2
  float dpc0 = 0.0f, dpc1 = 0.0f, dpcw = 0.0f;
  if (g_mean2d != nullptr) {
    const float* g = g_mean2d + (size_t)i * ld_mean2d;
    const float gx = g[0] * 0.5f * (float)width;
    const float gy = g[1] * 0.5f * (float)height;
    dpc0 = gx * p.inv_w;
    dpc1 = gy * p.inv_w;
    dpcw = -(gx * p.pc0 + gy * p.pc1) * p.inv_w * p.inv_w;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    gm[k] = dtv0 * W[4 * k] + dtv1 * W[4 * k + 1] + dtz * W[4 * k + 2]
            + dpc0 * P[4 * k] + dpc1 * P[4 * k + 1] + dpcw * P[4 * k + 3];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global → shared, asynchronously (completed by cp.async.wait_all)
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// The block's feature rows [base, base + count) into shared memory,
// asynchronously: dc rows [count, 3] at sh, then from degree 1 the rest
// rows [count, 3(K-1)] at sh + 3·THREADS.  A leaf whose rows are
// contiguous and whose block of rows starts 16-byte aligned goes by one
// TMA bulk copy of its whole 16-byte words, issued by thread 0 on the
// block's mbarrier ``bar``; the rest of the floats by cp.async, each
// thread some.  Returns whether the bulk copy is in flight (the same in
// every thread of the block).
template <int D>
__device__ __forceinline__ bool stage_rows(float* sh, const Args& a,
                                          int base, int count,
                                          uint64_t* bar) {
  const int leaves = (D >= 1 && a.K > 1) ? 2 : 1;
  const float* src[2] = {a.dc + base * a.ld_dc,
                         leaves > 1 ? a.rest + base * a.ld_rest : nullptr};
  const long long ld[2] = {a.ld_dc, a.ld_rest};
  const int width[2] = {3, 3 * (a.K - 1)};
  float* dst[2] = {sh, sh + 3 * THREADS};
  int bulk[2] = {0, 0};  // floats of each leaf in the bulk copy
  uint32_t bytes = 0;
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    if (l < leaves && ld[l] == width[l]
        && (reinterpret_cast<uintptr_t>(src[l]) & 15) == 0) {
      bulk[l] = (count * width[l]) & ~3;
      bytes += 4u * bulk[l];
    }
  }
  if (threadIdx.x == 0 && bytes != 0) {
    const uint32_t b = smem_addr(bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 "fence.mbarrier_init.release.cluster;\n"
                 "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(bytes) : "memory");
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (bulk[l] != 0)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n"
            :: "r"(smem_addr(dst[l])), "l"(src[l]), "r"(4 * bulk[l]), "r"(b)
            : "memory");
    }
  }
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    if (l >= leaves) continue;
    const int w = width[l], total = count * w;
    for (int e = bulk[l] + threadIdx.x; e < total; e += THREADS) {
      const int r = e / w;
      copy_async4(dst[l] + e, src[l] + r * ld[l] + (e - r * w));
    }
  }
  return bytes != 0;
}

// Wait for stage_rows' copies; then every thread may read every row.
__device__ __forceinline__ void wait_rows(uint64_t* bar, bool bulk) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (bulk) {
    const uint32_t b = smem_addr(bar);
    uint32_t done = 0;
    while (!done)
      asm volatile("{\n.reg .pred p;\n"
                   "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                   "selp.u32 %0, 1, 0, p;\n}\n"
                   : "=r"(done) : "r"(b) : "memory");
  }
  __syncthreads();
}

// bytes of shared memory for the staged rows of degree D over K
// coefficients
int smem_bytes(int degree, int K) {
  if (degree < 0) return 0;
  return THREADS * (3 + (degree >= 1 ? 3 * (K - 1) : 0)) * (int)sizeof(float);
}

// feature coefficient k, channel c of the thread's staged rows (dc, rest)
__device__ __forceinline__ float& feature(float* fdc, float* frest, int k,
                                          int c) {
  return k == 0 ? fdc[c] : frest[3 * (k - 1) + c];
}

// the first (D + 1)² coefficients of the thread's staged rows times their
// mask entries, as features * mask rounds
template <int D>
__device__ __forceinline__ void mask_rows(float* fdc, float* frest,
                                          const float* mask) {
#pragma unroll
  for (int k = 0; k < (D + 1) * (D + 1); ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      feature(fdc, frest, k, c) = feature(fdc, frest, k, c) * mask[k];
}

template <int D>
__global__ void __launch_bounds__(THREADS) preprocess_forward_kernel(
    const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float sh[];
  __shared__ Camera cams[MAX_VIEWS];
  __shared__ float mask[MAX_K];
  __shared__ __align__(8) uint64_t bar;
  const int base = blockIdx.x * THREADS;
  const int i = base + threadIdx.x;
  const int count = min(THREADS, a.n - base);
  bool bulk = false;
  if constexpr (D >= 0) bulk = stage_rows<D>(sh, a, base, count, &bar);
  load_views(cams, mask, a);
  __syncthreads();

  const bool in = i < a.n;
  float m[3], sc[3], q[4];
  float head[MAX_VIEWS][6];  // each view's packed row, floats 0-5
  if (in) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      m[k] = a.means[3 * (size_t)i + k];
      sc[k] = a.scales[3 * (size_t)i + k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = a.rots[4 * (size_t)i + k];
    const float op = a.opac != nullptr ? a.opac[i] : 0.0f;
    const bool opaque = a.opac == nullptr || op >= MIN_OPACITY;
#pragma unroll
    for (int v = 0; v < MAX_VIEWS; ++v) {
      if (v >= a.nviews) break;
      const View& w = a.view[v];
      Proj p;
      project<true>(cams[v], m, sc, q, w.width, w.height, a.smod, p);
      const bool valid = p.valid && opaque;
      float mx = p.mx, my = p.my;
      if (v == 0 && a.tap != nullptr) {
        mx = mx + a.tap[2 * (size_t)i];
        my = my + a.tap[2 * (size_t)i + 1];
      }
      w.mean2d[2 * (size_t)i] = mx;
      w.mean2d[2 * (size_t)i + 1] = my;
      w.depth[i] = valid ? p.tz : INFINITY;
#pragma unroll
      for (int k = 0; k < 3; ++k) w.conic[3 * (size_t)i + k] = p.conic[k];
      w.radius[i] = valid ? p.radius : 0.0f;
      w.valid[i] = valid;
      if constexpr (D >= 0) {
        head[v][0] = mx;
        head[v][1] = my;
        head[v][2] = mulf(p.conic[0], -0.5f);
        head[v][3] = mulf(p.conic[1], -1.0f);
        head[v][4] = mulf(p.conic[2], -0.5f);
        head[v][5] = op;
      }
    }
  }

  if constexpr (D >= 0) {
    constexpr int NC = (D + 1) * (D + 1);
    wait_rows(&bar, bulk);
    if (!in) return;
    float* fdc = sh + 3 * threadIdx.x;
    float* frest = sh + 3 * THREADS + 3 * (a.K - 1) * threadIdx.x;
    if (a.cmask != nullptr) mask_rows<D>(fdc, frest, mask);
#pragma unroll
    for (int v = 0; v < MAX_VIEWS; ++v) {
      if (v >= a.nviews) break;
      float dir[3];
      direction(cams[v], m, dir);
      float B[NC];
      sh_basis<D>(dir[0], dir[1], dir[2], B);
      float rgb[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float acc = feature(fdc, frest, 0, c) * B[0];
#pragma unroll
        for (int k = 1; k < NC; ++k)
          acc = acc + feature(fdc, frest, k, c) * B[k];
        rgb[c] = clamp_minf(acc + 0.5f, 0.0f);
        a.view[v].colors[3 * (size_t)i + c] = rgb[c];
      }
      if (a.view[v].feat != nullptr) {  // the whole row
        float4* row =
            reinterpret_cast<float4*>(a.view[v].feat + FEAT * (size_t)i);
        const float* h = head[v];
        row[0] = make_float4(h[0], h[1], h[2], h[3]);
        row[1] = make_float4(h[4], h[5], rgb[0], rgb[1]);
        row[2] = make_float4(rgb[2], 0.0f, 0.0f, 0.0f);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) preprocess_backward_kernel(
    const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float sh[];
  __shared__ Camera cams[MAX_VIEWS];
  __shared__ float mask[MAX_K];
  __shared__ __align__(8) uint64_t bar;
  const int base = blockIdx.x * THREADS;
  const int i = base + threadIdx.x;
  const int count = min(THREADS, a.n - base);
  bool bulk = false;
  if constexpr (D >= 0) bulk = stage_rows<D>(sh, a, base, count, &bar);
  load_views(cams, mask, a);
  __syncthreads();

  // the projection's part of each view, while the rows are in flight
  const bool in = i < a.n;
  float m[3] = {0.0f, 0.0f, 0.0f}, sc[3], q[4];
  if (in) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      m[k] = a.means[3 * (size_t)i + k];
      sc[k] = a.scales[3 * (size_t)i + k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = a.rots[4 * (size_t)i + k];
  }
  // the views from the last to the first: the order of the sums
  bool live[MAX_VIEWS];
  float gm[MAX_VIEWS][3], gs[3], gq[4];
#pragma unroll
  for (int v = MAX_VIEWS - 1; v >= 0; --v) {
#pragma unroll
    for (int k = 0; k < 3; ++k) gm[v][k] = 0.0f;
    live[v] = false;
    if (v >= a.nviews) continue;
    live[v] = in && a.view[v].valid_in[i] != 0;
    float gsv[3] = {0.0f, 0.0f, 0.0f}, gqv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (live[v])
      project_backward(cams[v], a.view[v], i, m, sc, q, a.smod, gm[v], gsv,
                       gqv);
    const bool last = v == a.nviews - 1;
#pragma unroll
    for (int k = 0; k < 3; ++k) gs[k] = last ? gsv[k] : gs[k] + gsv[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) gq[k] = last ? gqv[k] : gq[k] + gqv[k];
  }

  if constexpr (D >= 0) {
    constexpr int NC = (D + 1) * (D + 1);
    wait_rows(&bar, bulk);
    float* fdc = sh + 3 * threadIdx.x;
    float* frest = sh + 3 * THREADS + 3 * (a.K - 1) * threadIdx.x;
    const bool masked = a.cmask != nullptr;
    if (in && masked) mask_rows<D>(fdc, frest, mask);
    // the SH part of each view, from the staged rows
    bool col[MAX_VIEWS];
    float dir[MAX_VIEWS][3], drgb[MAX_VIEWS][3];
#pragma unroll
    for (int v = 0; v < MAX_VIEWS; ++v) {
      col[v] = live[v] && a.view[v].g_colors != nullptr;
      if (!col[v]) continue;
      const float nrm = direction(cams[v], m, dir[v]);
      float B[NC];
      sh_basis<D>(dir[v][0], dir[v][1], dir[v][2], B);
      const float* gc = a.view[v].g_colors + (size_t)i * a.view[v].ld_colors;
#pragma unroll
      for (int c = 0; c < 3; ++c) {  // colour = max(rgb + 0.5, 0)
        float acc = feature(fdc, frest, 0, c) * B[0];
#pragma unroll
        for (int k = 1; k < NC; ++k)
          acc = acc + feature(fdc, frest, k, c) * B[k];
        drgb[v][c] = acc + 0.5f >= 0.0f ? gc[c] : 0.0f;
      }
      float dB[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k)
        dB[k] = drgb[v][0] * feature(fdc, frest, k, 0)
                + drgb[v][1] * feature(fdc, frest, k, 1)
                + drgb[v][2] * feature(fdc, frest, k, 2);
      float gd[3] = {0.0f, 0.0f, 0.0f};
      sh_basis_backward<D>(dir[v][0], dir[v][1], dir[v][2], dB, gd);
      // dir = d / |d|
      const float proj = gd[0] * dir[v][0] + gd[1] * dir[v][1]
                         + gd[2] * dir[v][2];
      const float inv_nrm = 1.0f / nrm;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gm[v][k] += (gd[k] - dir[v][k] * proj) * inv_nrm;
    }
    // the rows are this thread's alone: the feature gradient replaces them,
    // (g_2 + g_1) + g_0 of each view's drgb·B, then times the mask
    if (in) {
#pragma unroll
      for (int v = MAX_VIEWS - 1; v >= 0; --v) {
        if (v >= a.nviews) continue;
        float B[NC];
        if (col[v]) sh_basis<D>(dir[v][0], dir[v][1], dir[v][2], B);
#pragma unroll
        for (int k = 0; k < NC; ++k)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float g = col[v] ? drgb[v][c] * B[k] : 0.0f;
            float& f = feature(fdc, frest, k, c);
            f = v == a.nviews - 1 ? g : f + g;
          }
      }
      if constexpr (D >= 1)
        for (int e = 3 * (NC - 1); e < 3 * (a.K - 1); ++e) frest[e] = 0.0f;
      if (masked) mask_rows<D>(fdc, frest, mask);
    }
    __syncthreads();
    // a warp a row: 3K floats written whole, coalesced
    const int w = 3 * a.K;
    for (int r = threadIdx.x / 32; r < count; r += THREADS / 32) {
      float* dst = a.g_feats + (size_t)(base + r) * a.ld_gfeats;
      for (int c = threadIdx.x % 32; c < w; c += 32)
        dst[c] = c < 3 ? sh[3 * r + c]
                       : (D >= 1 ? sh[3 * THREADS + (w - 3) * r + c - 3]
                                 : 0.0f);
    }
  }
  if (!in) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float g = 0.0f;
#pragma unroll
    for (int v = MAX_VIEWS - 1; v >= 0; --v)
      if (v < a.nviews) g = v == a.nviews - 1 ? gm[v][k] : g + gm[v][k];
    a.g_means[3 * (size_t)i + k] = g;
    a.g_scales[3 * (size_t)i + k] = gs[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) a.g_rots[4 * (size_t)i + k] = gq[k];
}

// The arguments common to both launches; false if they are not valid.
bool common_args(Args& a, const float* means, const float* scales,
                 const float* rots, const float* dc, long long ld_dc,
                 const float* rest, long long ld_rest, int K,
                 const float* cmask, int degree, int n, float smod,
                 int nviews, const void* const* cams, const int* sizes,
                 int stride) {
  if (degree > 4 || nviews < 1 || nviews > MAX_VIEWS) return false;
  const bool rest_ok = K == 1 || (rest != nullptr && ld_rest >= 3 * (K - 1));
  if (degree >= 0 && (K < (degree + 1) * (degree + 1) || K > MAX_K
                      || dc == nullptr || ld_dc < 3 || !rest_ok))
    return false;
  a = Args{};
  a.means = means;
  a.scales = scales;
  a.rots = rots;
  a.dc = dc;
  a.rest = rest;
  a.ld_dc = ld_dc;
  a.ld_rest = ld_rest;
  a.cmask = cmask;
  a.n = n;
  a.K = degree >= 0 ? K : 1;
  a.nviews = nviews;
  a.smod = smod;
  for (int v = 0; v < nviews; ++v) {
    const void* const* c = cams + (size_t)v * stride;
    View& w = a.view[v];
    w.wv = static_cast<const float*>(c[0]);
    w.fp = static_cast<const float*>(c[1]);
    w.cc = static_cast<const float*>(c[2]);
    w.tx = static_cast<const float*>(c[3]);
    w.ty = static_cast<const float*>(c[4]);
    w.width = sizes[2 * v];
    w.height = sizes[2 * v + 1];
  }
  return true;
}

}  // namespace

// degree -1: no features (projection only; dc, rest, cmask unread);
// ``tap`` (or null) is added to the first view's mean2d; per view in
// ``views`` 12 pointers: world_view, full_proj, camera_center, tan_fovx,
// tan_fovy, then the outputs mean2d, depth, conic, radius, valid, colors
// (null at degree -1) and the packed rows (null: not written; else
// 16-byte aligned, with features and opacities); in ``sizes`` its width
// and height
extern "C" int e3d_preprocess_forward(
    const float* means, const float* scales, const float* rots,
    const float* opac, const float* tap, const float* dc, long long ld_dc,
    const float* rest,
    long long ld_rest, int K, const float* cmask, int degree, int n,
    float smod, int nviews, const void* const* views, const int* sizes,
    cudaStream_t stream) {
  if (n <= 0) return 0;  // (an empty tensor's pointer may be null)
  Args a;
  if (!common_args(a, means, scales, rots, dc, ld_dc, rest, ld_rest, K,
                   cmask, degree, n, smod, nviews, views, sizes, 12))
    return (int)cudaErrorInvalidValue;
  a.opac = opac;
  a.tap = tap;
  for (int v = 0; v < nviews; ++v) {
    const void* const* c = views + (size_t)v * 12;
    View& w = a.view[v];
    w.mean2d = (float*)c[5];
    w.depth = (float*)c[6];
    w.conic = (float*)c[7];
    w.radius = (float*)c[8];
    w.valid = (bool*)c[9];
    w.colors = (float*)c[10];
    w.feat = (float*)c[11];
    if (degree >= 0 && w.colors == nullptr) return (int)cudaErrorInvalidValue;
    if (w.feat != nullptr
        && (degree < 0 || opac == nullptr
            || (reinterpret_cast<uintptr_t>(w.feat) & 15) != 0))
      return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  const int smem = smem_bytes(degree, a.K);
#define E3D_FWD(D) \
  preprocess_forward_kernel<D><<<blocks, THREADS, smem, stream>>>(a)
  switch (degree) {
    case 0: E3D_FWD(0); break;
    case 1: E3D_FWD(1); break;
    case 2: E3D_FWD(2); break;
    case 3: E3D_FWD(3); break;
    case 4: E3D_FWD(4); break;
    default: E3D_FWD(-1); break;
  }
#undef E3D_FWD
  return (int)cudaGetLastError();
}

// per view in ``views`` 9 pointers: world_view, full_proj, camera_center,
// tan_fovx, tan_fovy, the forward's valid, the gradients of mean2d, conic
// and colours (each may be null: zero); in ``ints`` 5: width, height and
// the three gradients' row strides; the feature gradients (both leaves'
// as one [N, K, 3] tensor, rows ``ld_gfeats`` floats apart) are written at
// degree >= 0 only
extern "C" int e3d_preprocess_backward(
    const float* means, const float* scales, const float* rots,
    const float* dc, long long ld_dc, const float* rest, long long ld_rest,
    int K, const float* cmask, int degree, int n, float smod, int nviews,
    const void* const* views, const int* ints, float* g_means,
    float* g_scales, float* g_rots, float* g_feats, long long ld_gfeats,
    cudaStream_t stream) {
  if (n <= 0) return 0;  // (an empty tensor's pointer may be null)
  int sizes[2 * MAX_VIEWS];
  for (int v = 0; v < nviews && v < MAX_VIEWS; ++v) {
    sizes[2 * v] = ints[5 * v];
    sizes[2 * v + 1] = ints[5 * v + 1];
  }
  Args a;
  if (!common_args(a, means, scales, rots, dc, ld_dc, rest, ld_rest, K,
                   cmask, degree, n, smod, nviews, views, sizes, 9))
    return (int)cudaErrorInvalidValue;
  if (degree >= 0 && (g_feats == nullptr || ld_gfeats < 3 * K))
    return (int)cudaErrorInvalidValue;
  a.g_means = g_means;
  a.g_scales = g_scales;
  a.g_rots = g_rots;
  a.g_feats = g_feats;
  a.ld_gfeats = ld_gfeats;
  for (int v = 0; v < nviews; ++v) {
    const void* const* c = views + (size_t)v * 9;
    View& w = a.view[v];
    w.valid_in = (const unsigned char*)c[5];
    w.g_mean2d = (const float*)c[6];
    w.g_conic = (const float*)c[7];
    w.g_colors = degree >= 0 ? (const float*)c[8] : nullptr;
    w.ld_mean2d = ints[5 * v + 2];
    w.ld_conic = ints[5 * v + 3];
    w.ld_colors = ints[5 * v + 4];
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  const int smem = smem_bytes(degree, a.K);
#define E3D_BWD(D) \
  preprocess_backward_kernel<D><<<blocks, THREADS, smem, stream>>>(a)
  switch (degree) {
    case 0: E3D_BWD(0); break;
    case 1: E3D_BWD(1); break;
    case 2: E3D_BWD(2); break;
    case 3: E3D_BWD(3); break;
    case 4: E3D_BWD(4); break;
    default: E3D_BWD(-1); break;
  }
#undef E3D_BWD
  return (int)cudaGetLastError();
}

// registers a thread and resident blocks an SM of the forward (backward 0)
// or backward kernel at SH degree ``degree`` over K coefficients
extern "C" int e3d_preprocess_occupancy(int* regs, int* blocks_per_sm,
                                        int backward, int degree, int K) {
  if (degree < -1 || degree > 4) return (int)cudaErrorInvalidValue;
  const void* fns[2][6] = {
      {(const void*)preprocess_forward_kernel<-1>,
       (const void*)preprocess_forward_kernel<0>,
       (const void*)preprocess_forward_kernel<1>,
       (const void*)preprocess_forward_kernel<2>,
       (const void*)preprocess_forward_kernel<3>,
       (const void*)preprocess_forward_kernel<4>},
      {(const void*)preprocess_backward_kernel<-1>,
       (const void*)preprocess_backward_kernel<0>,
       (const void*)preprocess_backward_kernel<1>,
       (const void*)preprocess_backward_kernel<2>,
       (const void*)preprocess_backward_kernel<3>,
       (const void*)preprocess_backward_kernel<4>}};
  const void* fn = fns[backward != 0][degree + 1];
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, THREADS, smem_bytes(degree, K));
}
