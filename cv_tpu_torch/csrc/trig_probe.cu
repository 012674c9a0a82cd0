// The port's elementwise trigonometry kernel: trig.cuh's atan2f, cosf and
// sinf (glibc's, with the bits of cv_tpu's jnp.arctan2/cos/sin on a CPU) at
// any length, one thread an element on a grid-stride loop.  Three entry
// points:
//
//   cv_trig_probe    the four rows of the trigonometry probe of two rows a,
//                    b of N values: atan2(a, b), cos(a), sin(a) and the
//                    floored mod(a + 2pi, 2pi) (fmodf, then + 2pi where the
//                    remainder is nonzero and its sign differs from 2pi's:
//                    numpy's and torch.remainder's rule)
//   cv_trig_angle    the describe's orientation angle, remainder(atan2(y, x)
//                    + 2pi, 2pi) (ops.trig.angle_cv)
//   cv_trig_cos_sin  the describe's cos and sin of the angle (ops.trig.cos_sin)
//   cv_trig_atan2_f32, cv_trig_atan2_f64, cv_trig_cos_sin_f64
//                    atan2 of float32 (so3_log's, no 2pi wrap) and of float64,
//                    cos and sin of float64 (glibc's sin/cos and atan2, as
//                    trig.cuh states them): ops.trig.atan2 and cos_sin by dtype
//
// Replaces experiments/exp_r5_pfused.py::phase_trig, a TPU probe that asked
// whether Mosaic's in-kernel atan2/cos/sin round as XLA's do outside a
// kernel.  Here they round as the plain versions in ops/trig.py do, bit for
// bit, on every device.  The libdevice body the probe had before is kept
// behind TRIG_LIBDEVICE (scripts/time_engine_calls.py --ablations
// trig-libdevice) to show how far the card's own library lies from them.
//
// What bounds it: each call is one launch over a few thousand elements (the
// describe's K x 109 angles, K angles, K cos/sin pairs), so the launch and
// not the arithmetic or the bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "trig.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks an SM of an H100 SXM

#ifdef TRIG_LIBDEVICE
__device__ __forceinline__ float atan2_of(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ float cos_of(float a) { return cosf(a); }
__device__ __forceinline__ float sin_of(float a) { return sinf(a); }
#else
__device__ __forceinline__ float atan2_of(float y, float x) { return cv_trig::atan2f_ref(y, x); }
__device__ __forceinline__ float cos_of(float a) { return cv_trig::cosf_ref(a); }
__device__ __forceinline__ float sin_of(float a) { return cv_trig::sinf_ref(a); }
#endif

// The floored remainder of a by b (torch.remainder for float).
__device__ __forceinline__ float floored_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((m < 0.0f) != (b < 0.0f))) m = __fadd_rn(m, b);
  return m;
}

__global__ void __launch_bounds__(kThreads) trig_probe_kernel(const float* __restrict__ a,
                                                              const float* __restrict__ b,
                                                              float* __restrict__ out, int64_t n, float two_pi) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const float x = a[i];
    out[i] = atan2_of(x, b[i]);
    out[n + i] = cos_of(x);
    out[2 * n + i] = sin_of(x);
    out[3 * n + i] = floored_mod(__fadd_rn(x, two_pi), two_pi);
  }
}

__global__ void __launch_bounds__(kThreads) angle_kernel(const float* __restrict__ y, const float* __restrict__ x,
                                                         float* __restrict__ out, int64_t n, float two_pi) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const float a = __fadd_rn(atan2_of(y[i], x[i]), two_pi);
    out[i] = a >= two_pi ? __fsub_rn(a, two_pi) : a;
  }
}

__global__ void __launch_bounds__(kThreads) cos_sin_kernel(const float* __restrict__ a, float* __restrict__ co,
                                                           float* __restrict__ si, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const float v = a[i];
    co[i] = cos_of(v);
    si[i] = sin_of(v);
  }
}

__global__ void __launch_bounds__(kThreads) atan2_f32_kernel(const float* __restrict__ y, const float* __restrict__ x,
                                                             float* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    out[i] = atan2_of(y[i], x[i]);
  }
}

__global__ void __launch_bounds__(kThreads) atan2_f64_kernel(const double* __restrict__ y, const double* __restrict__ x,
                                                             double* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    out[i] = cv_trig::atan2_64(y[i], x[i]);
  }
}

__global__ void __launch_bounds__(kThreads) cos_sin_f64_kernel(const double* __restrict__ a, double* __restrict__ co,
                                                               double* __restrict__ si, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    cv_trig::cos_sin64(a[i], co + i, si + i);
  }
}

__global__ void empty_kernel() {}

int blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cv_trig_probe(const float* a, const float* b, float* out, int64_t n, float two_pi, void* stream) {
  if (n <= 0) return 0;
  trig_probe_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out, n, two_pi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cv_trig_angle(const float* y, const float* x, float* out, int64_t n, float two_pi, void* stream) {
  if (n <= 0) return 0;
  angle_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(y, x, out, n, two_pi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cv_trig_cos_sin(const float* a, float* co, float* si, int64_t n, void* stream) {
  if (n <= 0) return 0;
  cos_sin_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, co, si, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cv_trig_atan2_f32(const float* y, const float* x, float* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  atan2_f32_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(y, x, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cv_trig_atan2_f64(const double* y, const double* x, double* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  atan2_f64_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(y, x, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cv_trig_cos_sin_f64(const double* a, double* co, double* si, int64_t n, void* stream) {
  if (n <= 0) return 0;
  cos_sin_f64_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, co, si, n);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of one block: the launch floor the trig calls are read
// against.
extern "C" int cv_trig_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
