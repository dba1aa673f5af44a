// The Adam update of a train step: every trainable leaf and the event
// contrast in one launch.
//
// Replaces no Pallas kernel.  In the JAX package `adam_update`
// (event3dgs_tpu/models/optimizer.py:39) runs inside the jitted train step
// (event3dgs_tpu/train/step.py:181-188), where XLA fuses each leaf's update
// into one elementwise pass.  In plain PyTorch the same update is some 15
// launches a leaf, each writing a full-size temporary: 110 launches a step.
// Here it is one launch over up to 8 segments (the six leaves, and the
// contrast in the event modes), each segment one tensor of parameters with
// its gradient, moments, learning rate and step count.
//
// Per element, with the step count t read from the segment's count (the
// count after this step's increment, made before the launch):
//
//   c1 = 1 - b1^t        c2 = 1 - b2^t        (float32 powf of t)
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + ((1-b2)*g)*g
//   p' = p - (lr*(m'/c1)) / (sqrt(v'/c2) + eps)
//
// which is models/optimizer.adam_update_plain operation for operation, one
// rounding each, in its order: every product, quotient, sum and root is an
// explicit round-to-nearest intrinsic, so nothing is fused into an FMA
// whatever the flags, the divisions are IEEE divisions (PyTorch divides by
// a 0-d CUDA tensor with a true division) and the root is correctly
// rounded.  The Python float constants (b1, 1-b1, b2, 1-b2, eps, a float
// learning rate) come rounded to float32 from the host, as PyTorch rounds a
// scalar operand.  The result equals the plain version bit for bit.
//
// Segments are passed by value in the kernel's parameters: a CUDA graph
// captures them with the launch, and no host copy is made on any call.  A
// learning rate is a float or a device pointer (the graphed step's
// position rate is a slice of its row table); the step count is always a
// device pointer.  An out pointer may equal its in pointer (in place):
// each element is read and then written by the same thread.
//
// Bound: bytes.  Per float the update reads p, g, m, v and writes p, m, v:
// 28 bytes, 1,652 a slot at SH degree 3 (59 floats), and reuses nothing.
// The elements of all segments form one flat space of 4-float chunks that
// a grid-stride loop walks; p, m and v (contiguous, 16-byte aligned) move
// as 16-byte loads and stores.  The feature gradients are strided slices of
// one [C, K, 3] gradient (features_dc 3 floats of each 3K-float row,
// features_rest 3(K-1) at offset 3): g is read where it lies, a float at a
// time, its row and column found once per chunk.  No shared memory, no
// atomics.  The bias corrections (two powf) and the learning rate are
// computed again only where a thread's chunk enters another segment.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int MAX_SEGMENTS = 8;
constexpr int THREADS = 256;
constexpr int VEC = 4;  // floats a chunk

struct Segment {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  float* p_out;
  float* m_out;
  float* v_out;
  const float* lr_ptr;  // null: lr
  const int* count;     // the step count after this step's increment
  float lr;
  int vec;             // p, m, v and the outputs move as float4
  int g_vec;           // g is contiguous and 16-byte aligned
  int width;           // floats a row (p, m, v rows are contiguous)
  long long g_stride;  // floats between g's rows
  long long n;         // floats
  long long begin;     // the segment's first chunk in the flat space
};

struct Table {
  Segment seg[MAX_SEGMENTS];
  int n_segments;
  long long chunks;
  float b1, one_minus_b1, b2, one_minus_b2, eps;
};

struct Consts {
  float b1, omb1, b2, omb2, eps, c1, c2, lr;
};

__device__ __forceinline__ void adam(float& p, float& m, float& v, float g,
                                     const Consts& k) {
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.omb2, g), g));
  const float num = __fmul_rn(k.lr, __fdiv_rn(m, k.c1));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.c2)), k.eps);
  p = __fsub_rn(p, __fdiv_rn(num, den));
}

// (row, column) of element e of a segment whose rows are `width` floats
__device__ __forceinline__ void row_col(long long e, int width, long long& row,
                                        int& col) {
  if (e < 0xffffffffLL) {  // a 32-bit division where it suffices
    row = static_cast<unsigned>(e) / static_cast<unsigned>(width);
  } else {
    row = e / width;
  }
  col = static_cast<int>(e - row * width);
}

__global__ void __launch_bounds__(THREADS)
    adam_update_kernel(const Table t) {
  int cur = -1;
  Segment s;
  Consts k;
  k.b1 = t.b1;
  k.omb1 = t.one_minus_b1;
  k.b2 = t.b2;
  k.omb2 = t.one_minus_b2;
  k.eps = t.eps;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long c = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       c < t.chunks; c += step) {
    int i = 0;
#pragma unroll
    for (int j = 1; j < MAX_SEGMENTS; ++j) {
      if (j < t.n_segments && c >= t.seg[j].begin) i = j;
    }
    if (i != cur) {
      cur = i;
      s = t.seg[i];
      // PyTorch: count.to(float32), then 1.0 - b ** t on 0-d tensors
      const float tt = __int2float_rn(*s.count);
      k.c1 = __fsub_rn(1.0f, powf(t.b1, tt));
      k.c2 = __fsub_rn(1.0f, powf(t.b2, tt));
      k.lr = s.lr_ptr != nullptr ? *s.lr_ptr : s.lr;
    }
    const long long e0 = (c - s.begin) * VEC;
    const int len = static_cast<int>(min(static_cast<long long>(VEC),
                                         s.n - e0));
    float g[VEC];
    if (s.g_vec && len == VEC) {
      const float4 q = *reinterpret_cast<const float4*>(s.g + e0);
      g[0] = q.x;
      g[1] = q.y;
      g[2] = q.z;
      g[3] = q.w;
    } else {
      long long row;
      int col;
      row_col(e0, s.width, row, col);
      long long gi = row * s.g_stride + col;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (j < len) g[j] = s.g[gi];
        if (++col == s.width) {
          col = 0;
          gi += s.g_stride - s.width + 1;
        } else {
          ++gi;
        }
      }
    }
    if (s.vec && len == VEC) {
      float4 p = *reinterpret_cast<const float4*>(s.p + e0);
      float4 m = *reinterpret_cast<const float4*>(s.m + e0);
      float4 v = *reinterpret_cast<const float4*>(s.v + e0);
      adam(p.x, m.x, v.x, g[0], k);
      adam(p.y, m.y, v.y, g[1], k);
      adam(p.z, m.z, v.z, g[2], k);
      adam(p.w, m.w, v.w, g[3], k);
      *reinterpret_cast<float4*>(s.p_out + e0) = p;
      *reinterpret_cast<float4*>(s.m_out + e0) = m;
      *reinterpret_cast<float4*>(s.v_out + e0) = v;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (j < len) {
          float p = s.p[e0 + j], m = s.m[e0 + j], v = s.v[e0 + j];
          adam(p, m, v, g[j], k);
          s.p_out[e0 + j] = p;
          s.m_out[e0 + j] = m;
          s.v_out[e0 + j] = v;
        }
      }
    }
  }
}

bool aligned(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// ptrs: per segment p, g, m, v, p_out, m_out, v_out, lr (or null), count;
// sizes: per segment floats, row width, g's row stride (floats); lrs: per
// segment the learning rate where its pointer is null.
extern "C" int e3d_adam_update(const void* const* ptrs,
                               const long long* sizes, const float* lrs,
                               int n_segments, float b1, float one_minus_b1,
                               float b2, float one_minus_b2, float eps,
                               cudaStream_t stream) {
  if (n_segments < 1 || n_segments > MAX_SEGMENTS) {
    return cudaErrorInvalidValue;
  }
  Table t = {};
  long long chunks = 0;
  for (int i = 0; i < n_segments; ++i) {
    const void* const* q = ptrs + 9 * i;
    Segment& s = t.seg[i];
    s.p = static_cast<const float*>(q[0]);
    s.g = static_cast<const float*>(q[1]);
    s.m = static_cast<const float*>(q[2]);
    s.v = static_cast<const float*>(q[3]);
    s.p_out = static_cast<float*>(const_cast<void*>(q[4]));
    s.m_out = static_cast<float*>(const_cast<void*>(q[5]));
    s.v_out = static_cast<float*>(const_cast<void*>(q[6]));
    s.lr_ptr = static_cast<const float*>(q[7]);
    s.count = static_cast<const int*>(q[8]);
    s.lr = lrs[i];
    s.n = sizes[3 * i];
    s.width = static_cast<int>(sizes[3 * i + 1]);
    s.g_stride = sizes[3 * i + 2];
    if (s.n < 0 || s.width < 1 || s.g_stride < s.width) {
      return cudaErrorInvalidValue;
    }
    s.vec = aligned(s.p) && aligned(s.m) && aligned(s.v) &&
            aligned(s.p_out) && aligned(s.m_out) && aligned(s.v_out);
    s.g_vec = s.g_stride == s.width && aligned(s.g);
    s.begin = chunks;
    chunks += (s.n + VEC - 1) / VEC;
  }
  t.n_segments = n_segments;
  t.chunks = chunks;
  t.b1 = b1;
  t.one_minus_b1 = one_minus_b1;
  t.b2 = b2;
  t.one_minus_b2 = one_minus_b2;
  t.eps = eps;
  if (chunks == 0) return cudaSuccess;
  // a grid the card holds at once: a grid-stride loop's blocks all do the
  // same work, so a last partial wave of blocks would leave SMs idle
  int device = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, adam_update_kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  const long long need = (chunks + THREADS - 1) / THREADS;
  const long long most = static_cast<long long>(sms) * resident;
  const int blocks = static_cast<int>(need < most ? need : most);
  adam_update_kernel<<<blocks, THREADS, 0, stream>>>(t);
  return cudaGetLastError();
}
