// The port's Jacobi eigensolver, cv_tpu/ops/eigen.py::eigh_small (a jitted
// fori_loop of cyclic Jacobi sweeps) bit for bit, one thread a matrix; and
// the consensus residual, cv_tpu/core/pose.py::camera_to_camera_residual
// under the jit of cv_tpu/consensus/batch.py::_score_stage, one thread a
// (model, match) pair, its 4x4 design built, solved and scored in
// registers.
//
// A rotation is the reference's, as XLA's CPU backend compiles it: theta =
// 0.5 atan2(2 apq, aqq - app) with glibc's atan2 and its cos and sin of
// theta (trig.cuh: atan2f/cosf/sinf for float32, the double functions for
// float64), then the columns p and q of A, the rows p and q of the new A and
// the columns of V, each pair of new values fma(c, x, -(s y)) and fma(s, x,
// c y): XLA contracts the product with x and rounds the other first.  The
// sort is torch.sort's stable ascending order (a NaN after every number).
// XLA's CPU code runs with flush-to-zero and denormals-are-zero, so a
// subnormal input entry, product, update, aqq - app or angle is the zero of
// its sign here too (ftz), as in ops/eigen.py.  Built with --fmad=false;
// every fused operation is an explicit fma.
//
// What bounds it: the float64 operations, mostly the trigonometry.  The
// parent kept A and V in local memory (its pair loops were `#pragma unroll
// 1`, so a[i][p] took a run-time index) and ran at 5.0% of its operations
// bound at a consensus block (4,194,304 4x4 float64, 6 sweeps: 11.8 ms
// against 0.59 ms on an H100 at 700 W).  Here, for N <= kRegN, the sweep
// over pairs is unrolled at compile time, so every index is a constant and
// A and V live in registers (the eigenvalue sort moves V's columns by
// unrolled compare-exchanges for the same reason); the block's matrices are
// staged through shared memory (an odd stride of N^2 + 1 words, so a
// warp's accesses fall in distinct banks), so each global load and store is
// contiguous across the block; and __launch_bounds__(kThreads, kMinBlocks)
// caps a thread at 96 registers for five resident blocks an SM.  That runs
// the block in ~3.5 ms (scripts/jacobi_variants.py; PERF.md).  What is left
// is glibc's atan2, cos and sin in every rotation, whose table and
// polynomial branches diverge within a warp: a shortcut for converged
// rotations (atan2's small-quotient form, cos 1, sin theta) was slower,
// since within nearly every warp of sweeps 2-4 some matrices take it and
// some do not.
//
// Larger N (eight-point's and five-point's 9x9) take jacobi_rolled_kernel:
// the pair loops rolled (A and V, 162 doubles, in local memory, which the
// SM's L1 caches), the sort by an index order (the parent's), and the cap
// of 96 registers (kRolledMinBlocks).  At the main path's 9x9 batches (at
// most 8,192 matrices: under a block an SM, so a thread's latency sets the
// time) that was the fastest form timed, 0.97x the parent's at 8,192 and
// at 65,536 (without the cap: 1.07x and 0.78x; with the compare-exchange
// sort: 1.02x and 0.97x; scripts/jacobi_variants.py, PERF.md).
//
// Templates for N = 1..10 (the reference's fully unrolled sweep is meant
// for N <= ~10: 3 in svd3, 4 in the consensus residual and the
// triangulators, 9 in eight-point and five-point).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "trig.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 10;
constexpr int kRegN = 5;  // the largest N whose sweep is unrolled into registers
constexpr int kMinBlocks = 5;  // __launch_bounds__'s resident blocks an SM (caps registers at 96)
constexpr int kC2cMinBlocks = 5;  // the same for the residual entry
constexpr int kRolledMinBlocks = 5;  // the same for N > kRegN

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
__device__ __forceinline__ void angle(double apq, double app, double aqq, double& c, double& s) {
  const double theta = ftz(__dmul_rn(0.5, cv_trig::atan2_64(__dmul_rn(2.0, apq), ftz(__dsub_rn(aqq, app)))));
  cv_trig::cos_sin64(theta, &c, &s);
}

__device__ __forceinline__ void angle(float apq, float app, float aqq, float& c, float& s) {
  const float theta = ftz(__fmul_rn(0.5f, cv_trig::atan2f_ref(__fmul_rn(2.0f, apq), ftz(__fsub_rn(aqq, app)))));
  c = cv_trig::cosf_ref(theta);
  s = cv_trig::sinf_ref(theta);
}

// The rotation (p, q) of A and V.
template <typename T, int N>
__device__ __forceinline__ void rotate(T (&a)[N][N], T (&v)[N][N], int p, int q) {
  T c, s;
  angle(a[p][q], a[p][p], a[q][q], c, s);
#pragma unroll
  for (int i = 0; i < N; ++i) {  // A <- A G: the columns
    const T x = a[i][p], y = a[i][q];
    a[i][p] = ftz(fma_(c, x, -ftz(mul(s, y))));
    a[i][q] = ftz(fma_(s, x, ftz(mul(c, y))));
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {  // A <- G^T A: the rows of the new A
    const T x = a[p][j], y = a[q][j];
    a[p][j] = ftz(fma_(c, x, -ftz(mul(s, y))));
    a[q][j] = ftz(fma_(s, x, ftz(mul(c, y))));
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {  // V <- V G
    const T x = v[i][p], y = v[i][q];
    v[i][p] = ftz(fma_(c, x, -ftz(mul(s, y))));
    v[i][q] = ftz(fma_(s, x, ftz(mul(c, y))));
  }
}

// Every sweep over the pairs in order, V from I.  For N <= kRegN the pair
// loops unroll, every index is a constant and A and V stay in registers.
template <typename T, int N>
__device__ __forceinline__ void sweep_all(T (&a)[N][N], T (&v)[N][N], int sweeps) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[i][j] = i == j ? T(1) : T(0);
  }
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    if constexpr (N <= kRegN) {
#pragma unroll
      for (int p = 0; p < N; ++p) {
#pragma unroll
        for (int q = p + 1; q < N; ++q) rotate<T, N>(a, v, p, q);
      }
    } else {
#pragma unroll 1
      for (int p = 0; p < N; ++p) {
#pragma unroll 1
        for (int q = p + 1; q < N; ++q) rotate<T, N>(a, v, p, q);
      }
    }
  }
}

// torch.sort's ascending order: a NaN after every number.
template <typename T>
__device__ __forceinline__ bool before(T a, T b) {
  return a < b || (!isnan(a) && isnan(b));
}

// The eigenvalues (A's diagonal) into w, stable ascending, with V's
// columns moved along: adjacent compare-exchanges, unrolled, so that every
// index is a constant (a select by a run-time index would put V in local
// memory).
template <typename T, int N>
__device__ __forceinline__ void sort_columns(const T (&a)[N][N], T (&v)[N][N], T (&w)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = a[i][i];
  // A stable insertion sort written as adjacent swaps.
#pragma unroll
  for (int i = 1; i < N; ++i) {
#pragma unroll
    for (int j = i; j > 0; --j) {
      if (before(w[j], w[j - 1])) {
        const T t = w[j];
        w[j] = w[j - 1];
        w[j - 1] = t;
#pragma unroll
        for (int r = 0; r < N; ++r) {
          const T x = v[r][j];
          v[r][j] = v[r][j - 1];
          v[r][j - 1] = x;
        }
      }
    }
  }
}

// N <= kRegN: a block's matrices staged through shared memory, A and V in
// registers.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    jacobi_kernel(const T* __restrict__ in, T* __restrict__ w, T* __restrict__ vout, int64_t batch, int sweeps) {
  static_assert(N <= kRegN, "jacobi_kernel unrolls the sweep into registers");
  constexpr int kNN = N * N;
  constexpr int kStride = kNN + 1;  // odd: a warp's words in distinct banks
  __shared__ T stage[kThreads * kStride];
  const int64_t first = blockIdx.x * static_cast<int64_t>(kThreads);
  const int64_t b = first + threadIdx.x;
  const int count = batch - first < kThreads ? static_cast<int>(batch - first) : kThreads;
  const bool flush = sweeps > 0 && N > 1;
  T a[N][N], v[N][N];
  for (int e = threadIdx.x; e < count * kNN; e += kThreads) {
    stage[(e / kNN) * kStride + e % kNN] = in[first * kNN + e];
  }
  __syncthreads();
  if (threadIdx.x < count) {
#pragma unroll
    for (int e = 0; e < kNN; ++e) {
      const T x = stage[threadIdx.x * kStride + e];
      a[e / N][e % N] = flush ? ftz(x) : x;
    }
  }
  if (b < batch) {
    sweep_all<T, N>(a, v, sweeps);
  }
  T ws[N];
  // Stage V's sorted columns (then the eigenvalues, after the block's
  // vectors are out), and store both contiguously.
  __syncthreads();
  if (b < batch) {
    sort_columns<T, N>(a, v, ws);
#pragma unroll
    for (int e = 0; e < kNN; ++e) stage[threadIdx.x * kStride + e] = v[e / N][e % N];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < count * kNN; e += kThreads) {
    vout[first * kNN + e] = stage[(e / kNN) * kStride + e % kNN];
  }
  __syncthreads();
  if (b < batch) {
#pragma unroll
    for (int k = 0; k < N; ++k) stage[threadIdx.x * N + k] = ws[k];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < count * N; e += kThreads) w[first * N + e] = stage[e];
}

// N > kRegN: a thread reads and writes its own matrix, the pair loops
// rolled.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, kRolledMinBlocks)
    jacobi_rolled_kernel(const T* __restrict__ in, T* __restrict__ w, T* __restrict__ vout, int64_t batch,
                         int sweeps) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (b >= batch) return;
  T a[N][N], v[N][N];
  const T* src = in + b * N * N;
  for (int i = 0; i < N; ++i) {
    for (int j = 0; j < N; ++j) a[i][j] = sweeps > 0 && N > 1 ? ftz(src[i * N + j]) : src[i * N + j];
  }
  sweep_all<T, N>(a, v, sweeps);
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
  if constexpr (N <= kRegN) {
    jacobi_kernel<T, N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a, w, v, batch, sweeps);
  } else {
    jacobi_rolled_kernel<T, N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a, w, v, batch, sweeps);
  }
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

// ---------------------------------------------------------------------------
// The consensus residual (core/pose.py::c2c_residual_plain)
// ---------------------------------------------------------------------------

// s_j = dot_fused(v, pm[:, j]): v0 pm0j + 0, then fma(v_k, pm_kj, acc).
template <typename T>
__device__ __forceinline__ T dot3(T v0, T v1, T v2, T p0, T p1, T p2) {
  return fma_(v2, p2, fma_(v1, p1, mul(v0, p0) + T(0)));
}

// The rows pm - v (v^T pm) of one bearing's DLT block, each entry
// fma(-v_k, s_j, pm_kj).
template <typename T>
__device__ __forceinline__ void dlt_terms(const T (&pm)[3][4], const T (&v)[3], T (&t)[3][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const T s = dot3(v[0], v[1], v[2], pm[0][j], pm[1][j], pm[2][j]);
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k][j] = fma_(-v[k], s, pm[k][j]);
  }
}

// from_homogeneous: the sign flipped where w < 0, then xyz (and w) over
// the IEEE root of dot_fused(xyz, xyz).
template <typename T>
__device__ __forceinline__ void from_homogeneous(T (&p)[4]) {
  if (p[3] < T(0)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = -p[i];
  }
  const T n = sqrt(dot3(p[0], p[1], p[2], p[0], p[1], p[2]));
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = p[i] / n;
}

__device__ __forceinline__ bool finite(double x) { return isfinite(x); }
__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

// out[i] for i < P * M: the pose p = i / M (rotation row-major, then the
// translation), the match m = paired ? p : i % M.
template <typename T>
__global__ void __launch_bounds__(kThreads, kC2cMinBlocks)
    c2c_residual_kernel(const T* __restrict__ rot, const T* __restrict__ trans, const T* __restrict__ a,
                        const T* __restrict__ b, T* __restrict__ out, int64_t poses, int64_t matches, int paired,
                        int sweeps) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= poses * matches) return;
  const int64_t p = i / matches, m = paired ? p : i - p * matches;
  T pm[3][4], eye[3][4], av[3], bv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      pm[k][j] = rot[p * 9 + k * 3 + j];
      eye[k][j] = k == j ? T(1) : T(0);
    }
    pm[k][3] = trans[p * 3 + k];
    eye[k][3] = T(0);
    av[k] = a[m * 3 + k];
    bv[k] = b[m * 3 + k];
  }
  // The design: fma(t0i, t0j, t1i t1j), then each later row fused in
  // order (a's rows, then b's); the Jacobi reads it flushed.
  T ta[3][4], tb[3][4], d[4][4], v[4][4];
  dlt_terms(eye, av, ta);
  dlt_terms(pm, bv, tb);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = r; c < 4; ++c) {
      T acc = fma_(ta[0][r], ta[0][c], mul(ta[1][r], ta[1][c]));
      acc = fma_(ta[2][r], ta[2][c], acc);
#pragma unroll
      for (int k = 0; k < 3; ++k) acc = fma_(tb[k][r], tb[k][c], acc);
      d[r][c] = d[c][r] = sweeps > 0 ? ftz(acc) : acc;
    }
  }
  sweep_all<T, 4>(d, v, sweeps);
  // The eigenvector of least |eigenvalue| in the sorted order, the first
  // on ties (a NaN first, as torch.argmin takes it), kept column by
  // column with constant indices.
  T w4[4], pt[4];
  sort_columns<T, 4>(d, v, w4);
  T best = fabs(w4[0]);
#pragma unroll
  for (int r = 0; r < 4; ++r) pt[r] = v[r][0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const T e = fabs(w4[k]);
    if (!isnan(best) && (e < best || isnan(e))) {
      best = e;
#pragma unroll
      for (int r = 0; r < 4; ++r) pt[r] = v[r][k];
    }
  }
  from_homogeneous(pt);
  const bool pt_finite = finite(pt[0]) && finite(pt[1]) && finite(pt[2]) && finite(pt[3]);
  T q[4];
#pragma unroll
  for (int r = 0; r < 3; ++r) q[r] = fma_(pm[r][3], pt[3], dot3(pm[r][0], pm[r][1], pm[r][2], pt[0], pt[1], pt[2]));
  q[3] = pt[3];
  from_homogeneous(q);
  const T da = dot3(av[0], av[1], av[2], pt[0], pt[1], pt[2]);
  const T db = dot3(bv[0], bv[1], bv[2], q[0], q[1], q[2]);
  const T res = ((T(2) - da) - db) * T(0.5);
  out[i] = pt_finite && finite(res) ? res : T(2);
}

template <typename T>
int c2c_launch(const T* rot, const T* trans, const T* a, const T* b, T* out, int64_t poses, int64_t matches,
               int paired, int sweeps, void* stream) {
  const int64_t total = poses * matches;
  if (total <= 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  c2c_residual_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rot, trans, a, b, out, poses, matches, paired, sweeps);
  return static_cast<int>(cudaGetLastError());
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

// The residual of `poses` relative poses ((P, 3, 3) rotations, (P, 3)
// translations) against `matches` bearing pairs ((M, 3) each): out (P, M),
// or with `paired` pose i against match i (M = 1).  Returns
// cudaGetLastError().
extern "C" int cv_c2c_residual_f64(const double* rot, const double* trans, const double* a, const double* b,
                                   double* out, int64_t poses, int64_t matches, int paired, int sweeps,
                                   void* stream) {
  return c2c_launch(rot, trans, a, b, out, poses, matches, paired, sweeps, stream);
}

extern "C" int cv_c2c_residual_f32(const float* rot, const float* trans, const float* a, const float* b, float* out,
                                   int64_t poses, int64_t matches, int paired, int sweeps, void* stream) {
  return c2c_launch(rot, trans, a, b, out, poses, matches, paired, sweeps, stream);
}
