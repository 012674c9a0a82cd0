// The port's Jacobi eigensolver: cv_tpu/ops/eigen.py::eigh_small (a jitted
// fori_loop of cyclic Jacobi sweeps) bit for bit, one thread a matrix.
//
// Each thread reads its symmetric N x N matrix (row-major, (B, N, N)), runs
// every sweep over the N (N - 1) / 2 pairs (p, q) in order on A and on V
// (I at first), and writes the eigenvalues ascending (B, N) and V's columns
// in that order (B, N, N).  A rotation is the reference's, as XLA's CPU
// backend compiles it: theta = 0.5 atan2(2 apq, aqq - app) with glibc's
// atan2 and its cos and sin of theta (trig.cuh: atan2f/cosf/sinf for
// float32, the double functions for float64), then the columns p and q of
// A, the rows p and q of the new A and the columns of V, each pair of new
// values fma(c, x, -(s y)) and fma(s, x, c y): XLA contracts the product
// with x and rounds the other first.  The sort is torch.sort's stable
// ascending order (a NaN after every number).  XLA's CPU code runs with
// flush-to-zero and denormals-are-zero, so a subnormal input entry, product,
// update, aqq - app or angle is the zero of its sign here too (ftz), as in
// ops/eigen.py.  Built with --fmad=false; every fused operation is an
// explicit fma.
//
// Templates for N = 1..10 (the reference's fully unrolled sweep is meant
// for N <= ~10: 3 in svd3, 4 in the consensus residual and the
// triangulators, 9 in eight-point and five-point).  The matrices live in
// the thread's local memory; what bounds the kernel is the arithmetic of
// the trigonometry and the updates (nothing is coalesced or staged yet).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "trig.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 10;

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
// A subnormal as the zero of its sign (XLA's FTZ and DAZ).
__device__ __forceinline__ double ftz(double v) {
  return (__double_as_longlong(v) & 0x7ff0000000000000ll) == 0 ? __dmul_rn(v, 0.0) : v;
}
__device__ __forceinline__ float ftz(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0 ? __fmul_rn(v, 0.0f) : v;
}

// cos and sin of theta = atan2(2 apq, aqq - app) / 2.
__device__ __noinline__ void angle(double apq, double app, double aqq, double* c, double* s) {
  const double theta = ftz(__dmul_rn(0.5, cv_trig::atan2_64(__dmul_rn(2.0, apq), ftz(__dsub_rn(aqq, app)))));
  cv_trig::cos_sin64(theta, c, s);
}

__device__ __noinline__ void angle(float apq, float app, float aqq, float* c, float* s) {
  const float theta = ftz(__fmul_rn(0.5f, cv_trig::atan2f_ref(__fmul_rn(2.0f, apq), ftz(__fsub_rn(aqq, app)))));
  *c = cv_trig::cosf_ref(theta);
  *s = cv_trig::sinf_ref(theta);
}

// torch.sort's ascending order: a NaN after every number.
template <typename T>
__device__ __forceinline__ bool before(T a, T b) {
  return a < b || (!isnan(a) && isnan(b));
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    jacobi_kernel(const T* __restrict__ in, T* __restrict__ w, T* __restrict__ vout, int64_t batch, int sweeps) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (b >= batch) return;
  T a[N][N], v[N][N];
  const T* src = in + b * N * N;
  for (int i = 0; i < N; ++i) {
    for (int j = 0; j < N; ++j) {
      a[i][j] = sweeps > 0 && N > 1 ? ftz(src[i * N + j]) : src[i * N + j];
      v[i][j] = i == j ? T(1) : T(0);
    }
  }
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll 1
    for (int p = 0; p < N; ++p) {
#pragma unroll 1
      for (int q = p + 1; q < N; ++q) {
        T c, s;
        angle(a[p][q], a[p][p], a[q][q], &c, &s);
        for (int i = 0; i < N; ++i) {  // A <- A G: the columns
          const T x = a[i][p], y = a[i][q];
          a[i][p] = ftz(fma_(c, x, -ftz(mul(s, y))));
          a[i][q] = ftz(fma_(s, x, ftz(mul(c, y))));
        }
        for (int j = 0; j < N; ++j) {  // A <- G^T A: the rows of the new A
          const T x = a[p][j], y = a[q][j];
          a[p][j] = ftz(fma_(c, x, -ftz(mul(s, y))));
          a[q][j] = ftz(fma_(s, x, ftz(mul(c, y))));
        }
        for (int i = 0; i < N; ++i) {  // V <- V G
          const T x = v[i][p], y = v[i][q];
          v[i][p] = ftz(fma_(c, x, -ftz(mul(s, y))));
          v[i][q] = ftz(fma_(s, x, ftz(mul(c, y))));
        }
      }
    }
  }
  int order[N];
  for (int i = 0; i < N; ++i) {  // stable insertion sort of the diagonal
    int j = i;
    while (j > 0 && before(a[i][i], a[order[j - 1]][order[j - 1]])) {
      order[j] = order[j - 1];
      --j;
    }
    order[j] = i;
  }
  for (int k = 0; k < N; ++k) {
    w[b * N + k] = a[order[k]][order[k]];
    for (int i = 0; i < N; ++i) vout[b * N * N + i * N + k] = v[i][order[k]];
  }
}

template <typename T, int N>
int launch(const T* a, T* w, T* v, int64_t batch, int sweeps, cudaStream_t stream) {
  const int64_t blocks = (batch + kThreads - 1) / kThreads;
  jacobi_kernel<T, N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a, w, v, batch, sweeps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* a, T* w, T* v, int64_t batch, int n, int sweeps, void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return launch<T, 1>(a, w, v, batch, sweeps, st);
    case 2: return launch<T, 2>(a, w, v, batch, sweeps, st);
    case 3: return launch<T, 3>(a, w, v, batch, sweeps, st);
    case 4: return launch<T, 4>(a, w, v, batch, sweeps, st);
    case 5: return launch<T, 5>(a, w, v, batch, sweeps, st);
    case 6: return launch<T, 6>(a, w, v, batch, sweeps, st);
    case 7: return launch<T, 7>(a, w, v, batch, sweeps, st);
    case 8: return launch<T, 8>(a, w, v, batch, sweeps, st);
    case 9: return launch<T, 9>(a, w, v, batch, sweeps, st);
    case kMaxN: return launch<T, kMaxN>(a, w, v, batch, sweeps, st);
    default: return -1;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success) or -1 for
// N outside 1..10.
extern "C" int cv_jacobi_f64(const double* a, double* w, double* v, int64_t batch, int n, int sweeps, void* stream) {
  return dispatch(a, w, v, batch, n, sweeps, stream);
}

extern "C" int cv_jacobi_f32(const float* a, float* w, float* v, int64_t batch, int n, int sweeps, void* stream) {
  return dispatch(a, w, v, batch, n, sweeps, stream);
}
