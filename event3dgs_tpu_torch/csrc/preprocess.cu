// Per-Gaussian preprocess: projection to screen space and SH colours,
// forward and backward.
//
// Replaces what the JAX package leaves to XLA around the rasterizer:
// `project_gaussians` (event3dgs_tpu/ops/projection.py:51) and
// `gaussian_colors` (event3dgs_tpu/ops/render.py:49), which XLA fuses into a
// few fusions a direction on the TPU, and their autodiff.  In plain PyTorch
// the same work is some 800 elementwise launches a render and direction.
// Here it is one launch forward and one backward, one thread per Gaussian
// (the upstream CUDA rasterizer's preprocessCUDA / BACKWARD::preprocess).
//
// Forward (e3d_preprocess_forward): from the means, activated scales,
// quaternions (not normalised), the optional opacities and the optional
// [N, K, 3] SH features, it writes what ops/projection.project_gaussians
// and ops/render.gaussian_colors return: mean2d [N, 2], depth [N], conic
// [N, 3], radius [N], valid [N] (bool) and colours [N, 3] =
// max(eval_sh + 0.5, 0).  Without features it projects only.  Every
// operation is the plain version's, one rounding each, in its order (the
// build has -fmad=false): the outputs equal the plain PyTorch version's bit
// for bit, so the binning's rects from radius and valid do not move.  The
// norms of the quaternion and of the SH direction are summed in index order
// in both.
//
// Backward (e3d_preprocess_backward): from the gradients of mean2d, conic
// and colours (any may be null: zero; each a row stride of its own, as the
// rasterizer hands over slices of its [N, 9] sums) it recomputes the
// forward's intermediates and writes the gradients of the means (the
// projection's part and the SH direction's), scales, quaternions and
// features.  Depth, radius and valid take no gradient, nor do the
// opacities (the forward only culls by them).  A Gaussian that is not
// valid gets exactly zero: the rasterizers give it no gradient, and the
// branches it took (a Gaussian on the camera plane, at the camera centre)
// would give 0·inf.  Each thread writes its own rows; there are no atomics
// and no sums across threads, so the gradients repeat bit for bit.
//
// Bound: bytes.  At SH degree 3 the forward reads 12 + 12 + 16 + 4 + 192
// bytes a Gaussian and writes 41; the backward reads 264 and writes 232;
// a few hundred FP32 operations a Gaussian stay far below the bytes' time.
// The [K, 3] feature rows (up to 300 bytes) are what a warp would read or
// write strided if each thread took its own row: a block stages its 128
// rows through shared memory (row stride made odd against bank conflicts),
// so the loads and the feature-gradient stores are coalesced.  The camera
// (37 floats) is read from device memory into shared memory by each block:
// the graphed train step picks its cameras on the device.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_K = 25;  // SH degree 4

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
// [4, 4]), centre, tan(fov/2)
struct Camera {
  float W[16];
  float P[16];
  float C[3];
  float tanx, tany;
};

__device__ __forceinline__ void load_camera(Camera& cam, const float* wv,
                                            const float* fp, const float* cc,
                                            const float* tx, const float* ty) {
  const int t = threadIdx.x;
  if (t < 16) {
    cam.W[t] = wv[t];
    cam.P[t] = fp[t];
  } else if (t < 19) {
    cam.C[t - 16] = cc[t - 16];
  } else if (t == 19) {
    cam.tanx = *tx;
    cam.tany = *ty;
  }
}

// torch.clamp (NaN passes through)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_minf(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
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
  float nq, qn[4], R[3][3];
  float s[3], Tu[3], Tv[3], wu[3], wv[3];
  float a, b, c, det, safe_det;
  bool det_ok;
  float conic[3], radius;
  bool valid;
};

__device__ __forceinline__ void project(const Camera& cam, const float* m,
                                        const float* sc, const float* q,
                                        const float* opac, int i, int width,
                                        int height, float smod, Proj& p) {
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

  // fx = width / (2 tan): PyTorch takes the reciprocal, then multiplies
  p.fx = (1.0f / (cam.tanx * 2.0f)) * (float)width;
  p.fy = (1.0f / (cam.tany * 2.0f)) * (float)height;
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
#pragma unroll
  for (int k = 0; k < 4; ++k) p.qn[k] = q[k] / p.nq;
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
  if (opac != nullptr) p.valid = p.valid && (opac[i] >= MIN_OPACITY);
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

// stride of a staged [K, 3] row in shared memory: odd, so that the 32
// threads of a warp reading float j of their rows hit 32 banks
__host__ __device__ __forceinline__ int row_stride(int K) {
  return (3 * K) | 1;
}

// the block's feature rows [base, base + count) into shared memory,
// coalesced
__device__ __forceinline__ void stage_rows(float* sh,
                                           const float* __restrict__ feats,
                                           int K, int base, int count) {
  const int w = 3 * K, stride = row_stride(K);
  const float* src = feats + (size_t)base * w;
  for (int e = threadIdx.x; e < count * w; e += THREADS)
    sh[(e / w) * stride + e % w] = src[e];
}

template <int D>
__global__ void __launch_bounds__(THREADS) preprocess_forward_kernel(
    const float* __restrict__ means, const float* __restrict__ scales,
    const float* __restrict__ rots, const float* __restrict__ opac,
    const float* __restrict__ feats, int K, const float* __restrict__ wv,
    const float* __restrict__ fp, const float* __restrict__ cc,
    const float* __restrict__ tx, const float* __restrict__ ty, int n,
    int width, int height, float smod, float* __restrict__ mean2d,
    float* __restrict__ depth, float* __restrict__ conic,
    float* __restrict__ radius, bool* __restrict__ valid,
    float* __restrict__ colors) {
  extern __shared__ float sh[];
  __shared__ Camera cam;
  const int base = blockIdx.x * THREADS;
  const int i = base + threadIdx.x;
  const int count = min(THREADS, n - base);
  load_camera(cam, wv, fp, cc, tx, ty);
  if constexpr (D >= 0) stage_rows(sh, feats, K, base, count);
  __syncthreads();
  if (i >= n) return;

  const float* m = means + 3 * (size_t)i;
  Proj p;
  project(cam, m, scales + 3 * (size_t)i, rots + 4 * (size_t)i, opac, i,
          width, height, smod, p);
  mean2d[2 * (size_t)i] = p.mx;
  mean2d[2 * (size_t)i + 1] = p.my;
  depth[i] = p.valid ? p.tz : INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) conic[3 * (size_t)i + k] = p.conic[k];
  radius[i] = p.valid ? p.radius : 0.0f;
  valid[i] = p.valid;

  if constexpr (D >= 0) {
    constexpr int NC = (D + 1) * (D + 1);
    float dir[3];
    direction(cam, m, dir);
    float B[NC];
    sh_basis<D>(dir[0], dir[1], dir[2], B);
    const float* f = sh + threadIdx.x * row_stride(K);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = f[c] * B[0];
#pragma unroll
      for (int k = 1; k < NC; ++k) acc = acc + f[3 * k + c] * B[k];
      colors[3 * (size_t)i + c] = clamp_minf(acc + 0.5f, 0.0f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) preprocess_backward_kernel(
    const float* __restrict__ means, const float* __restrict__ scales,
    const float* __restrict__ rots, const unsigned char* __restrict__ valid,
    const float* __restrict__ feats, int K, const float* __restrict__ wv,
    const float* __restrict__ fp, const float* __restrict__ cc,
    const float* __restrict__ tx, const float* __restrict__ ty, int n,
    int width, int height, float smod, const float* __restrict__ g_mean2d,
    int ld_mean2d, const float* __restrict__ g_conic, int ld_conic,
    const float* __restrict__ g_colors, int ld_colors,
    float* __restrict__ g_means, float* __restrict__ g_scales,
    float* __restrict__ g_rots, float* __restrict__ g_feats) {
  extern __shared__ float sh[];
  __shared__ Camera cam;
  const int base = blockIdx.x * THREADS;
  const int i = base + threadIdx.x;
  const int count = min(THREADS, n - base);
  load_camera(cam, wv, fp, cc, tx, ty);
  if constexpr (D >= 0) stage_rows(sh, feats, K, base, count);
  __syncthreads();

  const bool live = i < n && valid[i] != 0;
  float gm[3] = {0.0f, 0.0f, 0.0f}, gs[3] = {0.0f, 0.0f, 0.0f};
  float gq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
    const float* m = means + 3 * (size_t)i;
    Proj p;
    project(cam, m, scales + 3 * (size_t)i, rots + 4 * (size_t)i, nullptr, i,
            width, height, smod, p);
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
    for (int k = 0; k < 4; ++k) gq[k] = (dqn[k] - p.qn[k] * dot) / p.nq;

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
    const float dtv0 = drx / p.tz, dtv1 = dry / p.tz;
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

  if constexpr (D >= 0) {
    constexpr int NC = (D + 1) * (D + 1);
    float* f = sh + threadIdx.x * row_stride(K);
    if (live && g_colors != nullptr) {
      const float* m = means + 3 * (size_t)i;
      float dir[3];
      const float nrm = direction(cam, m, dir);
      float B[NC];
      sh_basis<D>(dir[0], dir[1], dir[2], B);
      const float* gc = g_colors + (size_t)i * ld_colors;
      float drgb[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {  // colour = max(rgb + 0.5, 0)
        float acc = f[c] * B[0];
#pragma unroll
        for (int k = 1; k < NC; ++k) acc = acc + f[3 * k + c] * B[k];
        drgb[c] = acc + 0.5f >= 0.0f ? gc[c] : 0.0f;
      }
      float dB[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        dB[k] = drgb[0] * f[3 * k] + drgb[1] * f[3 * k + 1]
                + drgb[2] * f[3 * k + 2];
        // the row is this thread's alone: its gradient replaces it
        f[3 * k] = drgb[0] * B[k];
        f[3 * k + 1] = drgb[1] * B[k];
        f[3 * k + 2] = drgb[2] * B[k];
      }
      for (int e = 3 * NC; e < 3 * K; ++e) f[e] = 0.0f;
      float gd[3] = {0.0f, 0.0f, 0.0f};
      sh_basis_backward<D>(dir[0], dir[1], dir[2], dB, gd);
      // dir = d / |d|
      const float proj = gd[0] * dir[0] + gd[1] * dir[1] + gd[2] * dir[2];
#pragma unroll
      for (int k = 0; k < 3; ++k) gm[k] += (gd[k] - dir[k] * proj) / nrm;
    } else if (i < n) {
      for (int e = 0; e < 3 * K; ++e) f[e] = 0.0f;
    }
    __syncthreads();
    const int w = 3 * K, stride = row_stride(K);
    float* dst = g_feats + (size_t)base * w;
    for (int e = threadIdx.x; e < count * w; e += THREADS)
      dst[e] = sh[(e / w) * stride + e % w];
  }
  if (i >= n) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_means[3 * (size_t)i + k] = gm[k];
    g_scales[3 * (size_t)i + k] = gs[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) g_rots[4 * (size_t)i + k] = gq[k];
}

int smem_bytes(int degree, int K) {
  return degree >= 0 ? THREADS * row_stride(K) * (int)sizeof(float) : 0;
}

}  // namespace

// feats may be null (degree -1: projection only); opac may be null
extern "C" int e3d_preprocess_forward(
    const float* means, const float* scales, const float* rots,
    const float* opac, const float* feats, int K, int degree,
    const float* world_view, const float* full_proj, const float* center,
    const float* tan_fovx, const float* tan_fovy, int n, int width,
    int height, float smod, float* mean2d, float* depth, float* conic,
    float* radius, bool* valid, float* colors, cudaStream_t stream) {
  if (n <= 0) return 0;  // (an empty tensor's pointer may be null)
  if (degree > 4 || (degree >= 0 && (K < (degree + 1) * (degree + 1)
                                     || K > MAX_K || feats == nullptr
                                     || colors == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  const int smem = smem_bytes(degree, K);
#define E3D_FWD(D)                                                          \
  preprocess_forward_kernel<D><<<blocks, THREADS, smem, stream>>>(          \
      means, scales, rots, opac, feats, K, world_view, full_proj, center,   \
      tan_fovx, tan_fovy, n, width, height, smod, mean2d, depth, conic,     \
      radius, valid, colors)
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

// valid: the forward's [N] bool; g_mean2d, g_conic, g_colors may be null
// (zero), each with its row stride in floats; feats, g_colors and g_feats
// are read and written only at degree >= 0
extern "C" int e3d_preprocess_backward(
    const float* means, const float* scales, const float* rots,
    const unsigned char* valid, const float* feats, int K, int degree,
    const float* world_view, const float* full_proj, const float* center,
    const float* tan_fovx, const float* tan_fovy, int n, int width,
    int height, float smod, const float* g_mean2d, int ld_mean2d,
    const float* g_conic, int ld_conic, const float* g_colors,
    int ld_colors, float* g_means, float* g_scales, float* g_rots,
    float* g_feats, cudaStream_t stream) {
  if (n <= 0) return 0;  // (an empty tensor's pointer may be null)
  if (degree > 4 || (degree >= 0 && (K < (degree + 1) * (degree + 1)
                                     || K > MAX_K || feats == nullptr
                                     || g_feats == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  const int smem = smem_bytes(degree, K);
#define E3D_BWD(D)                                                          \
  preprocess_backward_kernel<D><<<blocks, THREADS, smem, stream>>>(         \
      means, scales, rots, valid, feats, K, world_view, full_proj, center,  \
      tan_fovx, tan_fovy, n, width, height, smod, g_mean2d, ld_mean2d,      \
      g_conic, ld_conic, g_colors, ld_colors, g_means, g_scales, g_rots,    \
      g_feats)
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
