// The port's Jacobi eigensolver, cv_tpu/ops/eigen.py::eigh_small (a jitted
// fori_loop of cyclic Jacobi sweeps) bit for bit, one thread a matrix; and
// the consensus residual and its scoring: cv_tpu/core/pose.py::
// camera_to_camera_residual with cv_tpu/ops/eigen.py::eigh4 under the jit of
// cv_tpu/consensus/batch.py::_score_stage (and _prescore_stage), one thread
// a (model, match) pair, its 4x4 design built, solved and scored in
// registers.  The residual entry (cv_c2c_residual_*, core/pose.py::
// c2c_residual, counted on c2c_residual.launches) writes each residual; the
// score entry (cv_c2c_score_*, core/pose.py::c2c_score, counted on
// c2c_score.launches) writes only each model's inlier count and total,
// summed in a fixed order (c2c_score_plain's), so the stages no longer
// materialize residuals and masks: they take the winner from the counts
// and totals and recompute its residual row alone.
//
// What bounds the residual (PERF.md; NVIDIA H100 80GB HBM3, 700 W):
// instruction issue, not the float64 lanes.  A pair executes ~4,460
// DADD / DMUL / DFMA (counted; a division is 22 of them, and each
// rotation's atan2 takes two), ~1.12 ms of the card's 64 float64 lanes an
// SM at 4,194,304 pairs, while the entry takes ~2.85 ms: the integer,
// select, branch and table work of glibc's atan2, cos and sin, their
// branches diverging within warps, is half of its time (a branch-free
// stand-in of the same length halves it), and the flushes of XLA's FTZ
// were a fifth of its first form's.  So the design removes issued work:
// a rotation of the residual decides its flushes once from the exponents
// of c, s and the values it reads (c2c_rotate); every float64 angle (the Jacobi
// entry's too) tests atan2's common case first (atan2_jacobi) and skips
// the argument reduction and, below 2^-27 (the last sweeps), do_sin and
// do_cos (cos_sin_jacobi).  The score entry takes a pair a thread over
// (row, chunk) blocks, as wide a grid as the residual entry's, skips the
// residuals of invalid rows (the padding of the consensus's buckets), and
// joins a row's chunks in the last of its blocks to finish.
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
// What bounds the Jacobi entry: the float64 operations, mostly the
// trigonometry.  An earlier form kept A and V in local memory (its pair loops were `#pragma unroll
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


// cv_trig::cos_sin64 where |a| <= pi/2 or a is a NaN (the Jacobi angle's
// range): the same bits without the argument reduction's branches, and
// below 2^-27, where the results are 1 and a (every rotation of the last
// sweeps), without do_sin and do_cos.
__device__ __forceinline__ void cos_sin_jacobi(double a, double& co, double& si) {
  const int k = __double2hiint(a) & 0x7fffffff;
  if (k >= 0x7ff00000) {
    co = si = __ddiv_rn(a, a);
    return;
  }
  if (k < 0x3e400000) {
    co = 1.0;
    si = a;
    return;
  }
  const bool middle = k >= 0x3feb6000;  // 0.855469 <= |a| <= pi/2
  double sx = a, sdx = 0.0, cx = a, cdx = 0.0;
  if (middle) {
    const double t = __dsub_rn(cv_trig::kHp0, fabs(a));
    sx = __dadd_rn(t, cv_trig::kHp1);
    sdx = __dadd_rn(__dsub_rn(t, sx), cv_trig::kHp1);
    cx = t;
    cdx = cv_trig::kHp1;
  }
  const double ds = cv_trig::do_sin(sx, sdx), dc = cv_trig::do_cos(cx, cdx);
  const double s = middle ? copysign(dc, a) : ds, c = middle ? ds : dc;
  si = k < 0x3e500000 ? a : s;
  co = k < 0x3e400000 ? 1.0 : c;
}

// cv_trig::atan2_64 with its common case tested first: where x and y are
// normal, within [2^-500, 2^500) and less than 2^57 apart, none of its
// special cases, flushes or scalings acts, so its quotient forms run at
// once (one integer test instead of a dozen float64 ones); every other
// pair takes atan2_64.
__device__ __forceinline__ double atan2_jacobi(double y, double x) {
  const unsigned ex = (static_cast<unsigned>(__double2hiint(x)) >> 20) & 0x7ff;
  const unsigned ey = (static_cast<unsigned>(__double2hiint(y)) >> 20) & 0x7ff;
  if (ex - 523u <= 999u && ey - 523u <= 999u && ex - ey + 56u <= 112u) {
    return cv_trig::atan2_quotient(y, x, fabs(x), fabs(y));
  }
  return cv_trig::atan2_64(y, x);
}

// cos and sin of theta = atan2(2 apq, aqq - app) / 2.
__device__ __forceinline__ void angle(double apq, double app, double aqq, double& c, double& s) {
  const double theta = ftz(__dmul_rn(0.5, atan2_jacobi(__dmul_rn(2.0, apq), ftz(__dsub_rn(aqq, app)))));
  cos_sin_jacobi(theta, c, s);
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
// The consensus residual and its score (core/pose.py::c2c_residual_plain,
// c2c_score_plain)
// ---------------------------------------------------------------------------

constexpr int kSweeps = 6;        // eigh4's sweeps: the only count the residual uses
constexpr int kChunkWidth = 128;  // the score entry's widest chunk of a row (its sum order)

__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double div_(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double sqrt_(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }

// A lower bound of |v|'s biased exponent in the top bits of (bits << 1) - 1
// (its own exponent, or one less), and of a zero the largest key: a zero
// operand makes every product exact.
template <typename T>
struct Expo;
template <>
struct Expo<double> {
  // Every product c x and fused sum fma(c, x, -(s y)) of a rotation is a
  // multiple of 2^(e_c + e_x - 104) or of the rounded product's ulp, so it
  // is zero or normal where e_coef + e_operand >= -918: biased, >= 1128.
  static constexpr unsigned kShift = 21, kMinSum = 1128;
  static __device__ __forceinline__ unsigned key(double v) {
    return (static_cast<unsigned>(__double2hiint(v)) << 1) - 1u;
  }
};
template <>
struct Expo<float> {
  static constexpr unsigned kShift = 24, kMinSum = 174;  // e_coef + e_operand >= -80
  static __device__ __forceinline__ unsigned key(float v) { return (__float_as_uint(v) << 1) - 1u; }
};

template <typename T>
__device__ __forceinline__ unsigned key_min(unsigned k, T v) {
  return min(k, Expo<T>::key(v));
}

// Whether every product and fused sum with coefficients of key kc and
// operands of key ko is zero or normal: then no flush can act.
template <typename T>
__device__ __forceinline__ bool no_subnormal(unsigned kc, unsigned ko) {
  return (kc >> Expo<T>::kShift) + (ko >> Expo<T>::kShift) >= Expo<T>::kMinSum;
}

// The pair (x, y) rotated: (fma(c, x, -(s y)), fma(s, x, c y)), each value
// flushed where kFlush.
template <bool kFlush, typename T>
__device__ __forceinline__ void turn(T c, T s, T& x, T& y) {
  const T x0 = x, y0 = y;
  if constexpr (kFlush) {
    x = ftz(fma_(c, x0, -ftz(mul(s, y0))));
    y = ftz(fma_(s, x0, ftz(mul(c, y0))));
  } else {
    x = fma_(c, x0, -mul(s, y0));
    y = fma_(s, x0, mul(c, y0));
  }
}


// One rotation (p, q) of the 4x4 A and V, rotate()'s bits.  The flushes
// are decided once: where the exponents of c, s and the values the
// rotation reads show that no product or fused sum can be subnormal, the
// updates run without them (a flush then returns its argument); else each
// value is flushed as in rotate().  The rows p and q read the block's
// values that the column update writes, so their test follows it.
template <typename T>
__device__ __forceinline__ void c2c_rotate(T (&a)[4][4], T (&v)[4][4], int p, int q) {
  T c, s;
  angle(a[p][q], a[p][p], a[q][q], c, s);
  const unsigned kc = key_min(Expo<T>::key(c), s);
  unsigned ko = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ko = key_min(key_min(key_min(key_min(ko, a[i][p]), a[i][q]), v[i][p]), v[i][q]);
    if (i != p && i != q) ko = key_min(key_min(ko, a[p][i]), a[q][i]);
  }
  const bool fast = no_subnormal<T>(kc, ko);
  if (fast) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      turn<false>(c, s, a[i][p], a[i][q]);
      turn<false>(c, s, v[i][p], v[i][q]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      turn<true>(c, s, a[i][p], a[i][q]);
      turn<true>(c, s, v[i][p], v[i][q]);
    }
  }
  const unsigned kb = key_min(key_min(key_min(Expo<T>::key(a[p][p]), a[p][q]), a[q][p]), a[q][q]);
  if (fast && no_subnormal<T>(kc, kb)) {
#pragma unroll
    for (int j = 0; j < 4; ++j) turn<false>(c, s, a[p][j], a[q][j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) turn<true>(c, s, a[p][j], a[q][j]);
  }
}

template <typename T>
__device__ __forceinline__ void c2c_sweep(T (&a)[4][4], T (&v)[4][4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int q = p + 1; q < 4; ++q) c2c_rotate<T>(a, v, p, q);
  }
}

// eigh4's kSweeps sweeps of the design, V from I.
template <typename T>
__device__ __forceinline__ void c2c_jacobi(T (&a)[4][4], T (&v)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[i][j] = i == j ? T(1) : T(0);
  }
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) c2c_sweep<T>(a, v);
}

// The design and the score flush as XLA's FTZ/DAZ does (the jitted
// scoring's, as its Jacobi does) where kF: every input, product and fused
// sum below the normal range is the zero of its sign.  A pair decides once
// whether any can be subnormal (in_range, pt_in_range below); the flushes
// act only on poses far from unit scale (~1e-155).
template <bool kF, typename T>
__device__ __forceinline__ T fz(T v) {
  if constexpr (kF) {
    return ftz(v);
  } else {
    return v;
  }
}

// s_j = dot_fused(v, pm[:, j]): v0 pm0j + 0, then fma(v_k, pm_kj, acc).
template <bool kF, typename T>
__device__ __forceinline__ T dot3(T v0, T v1, T v2, T p0, T p1, T p2) {
  return fz<kF>(fma_(v2, p2, fz<kF>(fma_(v1, p1, add(fz<kF>(mul(v0, p0)), T(0))))));
}

// The rows pm - v (v^T pm) of one bearing's DLT block, each entry
// fma(-v_k, s_j, pm_kj).
template <bool kF, typename T>
__device__ __forceinline__ void dlt_terms(const T (&pm)[3][4], const T (&v)[3], T (&t)[3][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const T s = dot3<kF>(v[0], v[1], v[2], pm[0][j], pm[1][j], pm[2][j]);
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k][j] = fz<kF>(fma_(-v[k], s, pm[k][j]));
  }
}

// from_homogeneous: the sign flipped where w < 0, then xyz (and w) over
// the IEEE root of dot_fused(xyz, xyz).
template <bool kF, typename T>
__device__ __forceinline__ void from_homogeneous(T (&p)[4]) {
  if (p[3] < T(0)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = -p[i];
  }
  const T n = sqrt_(dot3<kF>(p[0], p[1], p[2], p[0], p[1], p[2]));
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = fz<kF>(div_(p[i], n));
}

__device__ __forceinline__ bool finite(double x) { return isfinite(x); }
__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

// The pose (rotation row-major at rp, translation at tp) and the bearings
// at ap and bp: 12 + 6 values.
template <typename T>
__device__ __forceinline__ void load_pair(const T* rp, const T* tp, const T* ap, const T* bp, T (&pm)[3][4],
                                          T (&av)[3], T (&bv)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) pm[k][j] = rp[k * 3 + j];
    pm[k][3] = tp[k];
    av[k] = ap[k];
    bv[k] = bp[k];
  }
}

// Whether no flush can act in a float64 pair's design: every nonzero input
// in [2^-83, 2^500].  Then each dot3 sum is a multiple of 2^-270, each
// DLT entry of 2^-457 and each design entry of 2^-1018, so every nonzero
// value is normal.  Float32 has no such range: it always flushes.
__device__ __forceinline__ bool in_range(const double (&pm)[3][4], const double (&av)[3], const double (&bv)[3]) {
  unsigned lo = 0xffffffffu;  // Expo's key of the least nonzero magnitude
  int hi = 0;                 // the high word of the largest
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo = key_min(lo, pm[k][j]);
      hi = max(hi, __double2hiint(pm[k][j]) & 0x7fffffff);
    }
    lo = key_min(key_min(lo, av[k]), bv[k]);
    hi = max(hi, max(__double2hiint(av[k]) & 0x7fffffff, __double2hiint(bv[k]) & 0x7fffffff));
  }
  return (lo >> Expo<double>::kShift) >= 1023 - 83 && (hi >> 20) <= 1023 + 500;
}
__device__ __forceinline__ bool in_range(const float (&)[3][4], const float (&)[3], const float (&)[3]) {
  return false;
}

// Whether, in range, no flush can act in the score either: every nonzero
// entry of the eigenvector at least 2^-80 (the entries are at most 1).
// Then the normalized point is a multiple of 2^-133 or zero, the rotated
// one of 2^-268, its normalized form at least 2^-772, the cosines
// multiples of 2^-959 and the residual of 2^-1012.
__device__ __forceinline__ bool pt_in_range(const double (&pt)[4]) {
  return (key_min(key_min(key_min(Expo<double>::key(pt[0]), pt[1]), pt[2]), pt[3]) >> Expo<double>::kShift) >=
         1023 - 80;
}
__device__ __forceinline__ bool pt_in_range(const float (&)[4]) { return false; }

// The design: fma(t0i, t0j, t1i t1j), then each later row fused in order
// (a's rows, then b's).
template <bool kF, typename T>
__device__ __forceinline__ void design(const T (&pm)[3][4], const T (&av)[3], const T (&bv)[3], T (&d)[4][4]) {
  T ta[3][4], tb[3][4];
  const T eye[3][4] = {{T(1), T(0), T(0), T(0)}, {T(0), T(1), T(0), T(0)}, {T(0), T(0), T(1), T(0)}};
  dlt_terms<kF>(eye, av, ta);
  dlt_terms<kF>(pm, bv, tb);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = r; c < 4; ++c) {
      T acc = fz<kF>(fma_(ta[0][r], ta[0][c], fz<kF>(mul(ta[1][r], ta[1][c]))));
      acc = fz<kF>(fma_(ta[2][r], ta[2][c], acc));
#pragma unroll
      for (int k = 0; k < 3; ++k) acc = fz<kF>(fma_(tb[k][r], tb[k][c], acc));
      d[r][c] = d[c][r] = acc;
    }
  }
}

// The score of the eigenvector pt: the point's cosines to both bearings.
template <bool kF, typename T>
__device__ __forceinline__ T score(const T (&pm)[3][4], const T (&av)[3], const T (&bv)[3], T (&pt)[4]) {
  from_homogeneous<kF>(pt);
  const bool pt_finite = finite(pt[0]) && finite(pt[1]) && finite(pt[2]) && finite(pt[3]);
  T q[4];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    q[r] = fz<kF>(fma_(pm[r][3], pt[3], dot3<kF>(pm[r][0], pm[r][1], pm[r][2], pt[0], pt[1], pt[2])));
  }
  q[3] = pt[3];
  from_homogeneous<kF>(q);
  const T da = dot3<kF>(av[0], av[1], av[2], pt[0], pt[1], pt[2]);
  const T db = dot3<kF>(bv[0], bv[1], bv[2], q[0], q[1], q[2]);
  const T res = fz<kF>(mul(sub(fz<kF>(sub(T(2), da)), db), T(0.5)));
  return pt_finite && finite(res) ? res : T(2);
}

// The eigenvector of least |eigenvalue| in the sorted order, the first on
// ties (a NaN first, as torch.argmin takes it), kept column by column with
// constant indices.
template <typename T>
__device__ __forceinline__ void least_vector(T (&d)[4][4], T (&v)[4][4], T (&pt)[4]) {
  T w4[4];
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
}

// A pair's residual with every flush: out of line, and handed only the
// input pointers, since pairs rarely take it and, inlined or handed the
// common path's arrays, it would take that path's registers.
template <typename T>
__device__ __noinline__ T pair_residual_flushed(const T* rp, const T* tp, const T* ap, const T* bp) {
  T pm[3][4], av[3], bv[3], d[4][4], v[4][4], pt[4];
  load_pair(rp, tp, ap, bp, pm, av, bv);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) pm[k][j] = ftz(pm[k][j]);
    av[k] = ftz(av[k]);
    bv[k] = ftz(bv[k]);
  }
  design<true>(pm, av, bv, d);
  c2c_jacobi<T>(d, v);
  least_vector(d, v, pt);
  return score<true>(pm, av, bv, pt);
}

// One (pose, match) pair's residual: without the design's and the score's
// flushes where they cannot act, else pair_residual_flushed.
template <typename T>
__device__ __forceinline__ T pair_residual(const T* rp, const T* tp, const T* ap, const T* bp) {
  // The pose and the bearings are not live in registers across the sweeps:
  // at the register cap the compiler keeps them in local memory (144 bytes
  // in float64) and reads them back for the score.
  T pm[3][4], av[3], bv[3], d[4][4], v[4][4], pt[4];
  load_pair(rp, tp, ap, bp, pm, av, bv);
  if (!in_range(pm, av, bv)) return pair_residual_flushed(rp, tp, ap, bp);
  design<false>(pm, av, bv, d);
  c2c_jacobi<T>(d, v);
  least_vector(d, v, pt);
  if (!pt_in_range(pt)) return pair_residual_flushed(rp, tp, ap, bp);
  return score<false>(pm, av, bv, pt);
}

// out[p * matches + m] for p < poses, m < matches (pose p's rotation
// row-major, then its translation); with `paired` (matches = 1) pose i
// against match i into out[i].  A warp takes consecutive matches of one
// pose (a warp of one match across poses was no faster, PERF.md).
template <typename T>
__global__ void __launch_bounds__(kThreads, kC2cMinBlocks)
    c2c_residual_kernel(const T* __restrict__ rot, const T* __restrict__ trans, const T* __restrict__ a,
                        const T* __restrict__ b, T* __restrict__ out, int64_t poses, int64_t matches, int paired) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= poses * matches) return;
  const int64_t p = paired ? i : i / matches, m = paired ? i : i - p * matches;
  out[i] = pair_residual(rot + p * 9, trans + p * 3, a + m * 3, b + m * 3);
}

// The chunk width of a row of `matches` in the score entry: the least
// power of two >= matches, at most kChunkWidth (c2c_score_plain's order).
__host__ __device__ __forceinline__ int chunk_width(int64_t matches) {
  int r = 1;
  while (r < kChunkWidth && r < matches) r <<= 1;
  return r;
}

// Pose p's inlier count and total over the matches: a pair is an inlier
// where valid[m], res < threshold and res is finite (an invalid row's
// residual is not computed).  A row is cut into chunks of C = chunk_width
// matches and a thread takes one pair, so the grid is as wide as the
// residual entry's: a block holds kThreads / C rows of one chunk each
// (their poses staged in shared memory), the C values of a (row, chunk)
// meet in a halving tree (s[t] + s[t + h] for h = C/2, ..., 1; a pair
// past the row or not an inlier gives +0), and where a row has several
// chunks, each chunk's sum and count go to `part`, and the row's last
// block to finish adds them in chunk order (the first, then each next).
// Only the counts and totals are written.
template <typename T>
__global__ void __launch_bounds__(kThreads, kC2cMinBlocks)
    c2c_score_kernel(const T* __restrict__ rot, const T* __restrict__ trans, const T* __restrict__ a,
                     const T* __restrict__ b, const uint8_t* __restrict__ valid, T threshold, int64_t poses,
                     int64_t matches, long long* __restrict__ counts, T* __restrict__ totals, T* part_sum,
                     long long* part_count, int* arrived) {
  __shared__ T pose_s[kThreads * 12];
  __shared__ T sum_s[kThreads];
  __shared__ long long count_s[kThreads];
  const int cw = chunk_width(matches);
  const int64_t chunks = matches > cw ? (matches + cw - 1) / cw : 1;
  const int rows = kThreads / cw;
  const int r = threadIdx.x % cw, g = threadIdx.x / cw;
  const int64_t chunk = blockIdx.x % chunks, first = blockIdx.x / chunks * rows;
  for (int e = threadIdx.x; e < rows * 12; e += kThreads) {
    const int64_t pg = first + e / 12;
    const int k = e % 12;
    if (pg < poses) pose_s[e] = k < 9 ? rot[pg * 9 + k] : trans[pg * 3 + k - 9];
  }
  __syncthreads();
  const int64_t p = first + g, m = chunk * cw + r;
  T value = T(0);
  long long count = 0;
  if (p < poses && m < matches && valid[m] != 0) {
    const T res = pair_residual(pose_s + g * 12, pose_s + g * 12 + 9, a + m * 3, b + m * 3);
    const bool in = res < threshold && finite(res);
    value = in ? res : T(0);
    count = in;
  }
  sum_s[threadIdx.x] = value;
  count_s[threadIdx.x] = count;
  __syncthreads();
  for (int h = cw / 2; h > 0; h >>= 1) {
    if (r < h) {
      sum_s[threadIdx.x] = add(sum_s[threadIdx.x], sum_s[threadIdx.x + h]);
      count_s[threadIdx.x] += count_s[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (chunks == 1) {
    if (r == 0 && p < poses) {
      counts[p] = count_s[threadIdx.x];
      totals[p] = sum_s[threadIdx.x];
    }
    return;
  }
  // Several chunks (then cw = kThreads: one row a block).
  if (threadIdx.x == 0) {
    part_sum[p * chunks + chunk] = sum_s[0];
    part_count[p * chunks + chunk] = count_s[0];
    __threadfence();
    if (atomicAdd(arrived + p, 1) != chunks - 1) return;
    T total = __ldcg(part_sum + p * chunks);
    long long n = __ldcg(part_count + p * chunks);
    for (int64_t c = 1; c < chunks; ++c) {
      total = add(total, __ldcg(part_sum + p * chunks + c));
      n += __ldcg(part_count + p * chunks + c);
    }
    counts[p] = n;
    totals[p] = total;
  }
}

template <typename T>
int c2c_launch(const T* rot, const T* trans, const T* a, const T* b, T* out, int64_t poses, int64_t matches,
               int paired, void* stream) {
  const int64_t total = poses * matches;
  if (total <= 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  c2c_residual_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rot, trans, a, b, out, poses, matches, paired);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int c2c_score_launch(const T* rot, const T* trans, const T* a, const T* b, const uint8_t* valid, double threshold,
                     int64_t poses, int64_t matches, long long* counts, T* totals, T* part_sum, long long* part_count,
                     int* arrived, void* stream) {
  if (poses <= 0) return 0;
  const int cw = chunk_width(matches);
  const int rows = kThreads / cw;
  const int64_t chunks = matches > cw ? (matches + cw - 1) / cw : 1;
  const int64_t blocks = (poses + rows - 1) / rows * chunks;
  c2c_score_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rot, trans, a, b, valid, static_cast<T>(threshold), poses, matches, counts, totals, part_sum, part_count,
      arrived);
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
                                   double* out, int64_t poses, int64_t matches, int paired, void* stream) {
  return c2c_launch(rot, trans, a, b, out, poses, matches, paired, stream);
}

extern "C" int cv_c2c_residual_f32(const float* rot, const float* trans, const float* a, const float* b, float* out,
                                   int64_t poses, int64_t matches, int paired, void* stream) {
  return c2c_launch(rot, trans, a, b, out, poses, matches, paired, stream);
}

// The score of `poses` relative poses against `matches` bearing pairs
// (valid: M bytes, 0 or 1): counts (P,) int64 and totals (P,) of each
// pose's inliers (res < threshold, valid, finite), the threshold rounded to
// the entry's type.  Where a row has several chunks (more than kChunkWidth
// matches), part_sum and part_count hold P x chunks scratch values and
// arrived P zeros; else they may be null.  Returns cudaGetLastError().
extern "C" int cv_c2c_score_f64(const double* rot, const double* trans, const double* a, const double* b,
                                const uint8_t* valid, double threshold, int64_t poses, int64_t matches,
                                long long* counts, double* totals, double* part_sum, long long* part_count,
                                int* arrived, void* stream) {
  return c2c_score_launch(rot, trans, a, b, valid, threshold, poses, matches, counts, totals, part_sum, part_count,
                          arrived, stream);
}

extern "C" int cv_c2c_score_f32(const float* rot, const float* trans, const float* a, const float* b,
                                const uint8_t* valid, double threshold, int64_t poses, int64_t matches,
                                long long* counts, float* totals, float* part_sum, long long* part_count,
                                int* arrived, void* stream) {
  return c2c_score_launch(rot, trans, a, b, valid, threshold, poses, matches, counts, totals, part_sum, part_count,
                          arrived, stream);
}
