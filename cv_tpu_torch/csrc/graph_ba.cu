// Graph bundle adjustment, cv_tpu/sfm/device_refine.py::graph_ba_core (a
// jitted fori_loop of rounds), in one launch of one block: the port's
// sfm/device_refine.py::graph_ba_core_plain bit for bit, which is cv_tpu's
// jitted loop as XLA's CPU code rounds it.
//
// One block runs every round.  It stages the V poses (and, when they fit,
// the E edges: rotations, translations, to/from, the logs and the incoming
// lists) in shared memory once, builds each view's list of valid incoming
// edges in edge order by scanning the edges (so the call needs no host
// read), and then runs the rounds in two phases separated by
// __syncthreads():
//
//   * a thread an edge: the relative pose Rf Rt^T, tf - Rf Rt^T tt, its
//     product with the expected pose and the se(3) log (the Taylor, generic
//     and near-pi branches of so3_log, glibc's atan2 from trig.cuh), or
//     zeros where the edge's views are removed;
//   * a thread a view: 0 + the logs of its list in edge order, times the
//     rate; if finite, so3_exp (glibc's cos and sin) and the new pose, else
//     the view is removed (a sticky mask).
//
// The rounding is the plain loop's, which is XLA's: every 3-term product
// sum is x0 y0 + 0, then fma(x_k, y_k, acc), each step flushed as XLA's
// FTZ/DAZ flushes (dot3); the Taylor coefficients are fused products with
// the reciprocals of 6 and 24 rounded; the diagonal of hat(w)^2 is
// fma(-a, a, -(b b)); the Rodrigues matrix fma(b, hat2, fma(a, hat, I));
// the translation update fma(sum, rate, dr t); sin / sqrt(t2s) is
// sin * (1 / sqrt(t2s)).  Built with --fmad=false: every other expression
// rounds as written, each fused operation is an explicit fma.
//
// What bounds it: latency.  A round is one edge's dependent chain (three
// 3x3 products, atan2) then one view's (its in-order sum, cos and sin, two
// products), a few microseconds, at a few hundred busy threads of one SM;
// bytes and operations are far below what the card could take.
//
// Shapes: the views' state must fit in shared memory (V up to about 2,000
// in float64); edges that do not fit beside it are read from global memory
// each round, their logs and lists kept in the caller's scratch.  An edge
// whose to or from lies outside [0, V) is left out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "trig.cuh"

// The block's dynamic shared memory.
#ifdef __CUDACC__
static __device__ __forceinline__ unsigned char* dynamic_shared() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}
#else
unsigned char* dynamic_shared();  // the host build's stand-in
#endif

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxShared = 227 * 1024;  // an H100 block's dynamic shared memory

// Per-dtype functions and constants: the plain loop's, rounded to T.
template <typename T>
struct Ops;

template <>
struct Ops<double> {
  static constexpr double kEps = 0x1p-52;
  static constexpr double kQuarterEps = 0x1p-13;  // eps^0.25
  static constexpr double kNearPi = -0x1.fffffffffffep-1;  // -1 + 16 eps
  static constexpr double kSixth = 0x1.5555555555555p-3;  // 1/6 rounded
  static constexpr double kP24 = 0x1.5555555555555p-5;  // 1/24 rounded
  __device__ static double fma(double a, double b, double c) { return __fma_rn(a, b, c); }
  __device__ static double ftz(double v) { return cv_trig::flush64(v); }
  __device__ static double sqrt(double v) { return __dsqrt_rn(v); }
  __device__ static double atan2(double y, double x) { return cv_trig::atan2_64(y, x); }
  __device__ static void cos_sin(double a, double* c, double* s) { cv_trig::cos_sin64(a, c, s); }
};

template <>
struct Ops<float> {
  static constexpr float kEps = 0x1p-23f;
  static constexpr float kQuarterEps = 0x1.306fep-6f;  // eps^0.25 rounded
  static constexpr float kNearPi = -0x1.ffffcp-1f;  // -1 + 16 eps
  static constexpr float kSixth = 0x1.555556p-3f;
  static constexpr float kP24 = 0x1.555556p-5f;
  __device__ static float fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
  __device__ static float ftz(float v) { return cv_trig::flush(v); }
  __device__ static float sqrt(float v) { return __fsqrt_rn(v); }
  __device__ static float atan2(float y, float x) { return cv_trig::atan2f_ref(y, x); }
  __device__ static void cos_sin(float a, float* c, float* s) {
    *c = cv_trig::cosf_ref(a);
    *s = cv_trig::sinf_ref(a);
  }
};

// sum(x * y) over three terms: x0 y0 + 0, then fma(x_k, y_k, acc), each
// step flushed.
template <typename T>
__device__ __forceinline__ T dot3(T x0, T x1, T x2, T y0, T y1, T y2) {
  using O = Ops<T>;
  T acc = O::ftz(O::ftz(x0 * y0) + T(0));
  acc = O::ftz(O::fma(x1, y1, acc));
  return O::ftz(O::fma(x2, y2, acc));
}

template <typename T>
__device__ __forceinline__ bool is_nan(T v) {
  return v != v;
}

// so3_log of a row-major 3x3 rotation into w (graph_ba_core_plain's
// _so3_log_fused).
template <typename T>
__device__ void so3_log(const T* r, T* w) {
  using O = Ops<T>;
  const T trace = (r[0] + r[4]) + r[8];
  T cos_t = (trace - T(1)) * T(0.5);
  cos_t = cos_t < T(-1) ? T(-1) : (cos_t > T(1) ? T(1) : cos_t);
  const T raw[3] = {r[7] - r[5], r[2] - r[6], r[3] - r[1]};
  const T h[3] = {raw[0] * T(0.5), raw[1] * T(0.5), raw[2] * T(0.5)};
  const T sin_t = O::sqrt(dot3(h[0], h[1], h[2], h[0], h[1], h[2]));
  const T theta = O::atan2(sin_t, cos_t);
  const bool near_pi = cos_t < O::kNearPi;
  const bool small = theta < O::kQuarterEps;
  const T safe_sin = sin_t == T(0) ? T(1) : sin_t;
  const T scale = small ? O::fma(theta * theta, O::kSixth, T(1)) : theta / safe_sin;
  const T half = scale * T(0.5);
  // Near pi: the column of R + R^T + (1 - trace) I with the largest
  // diagonal (the first NaN, else the first largest), normalized and
  // signed against h.
  const T omt = T(1) - trace;
  T outer[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) outer[3 * i + j] = (r[3 * i + j] + r[3 * j + i]) + omt * (i == j ? T(1) : T(0));
  int idx = 0;
  T best = outer[0];
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    const T d = outer[4 * k];
    if (!is_nan(best) && (is_nan(d) || d > best)) {
      idx = k;
      best = d;
    }
  }
  const T col[3] = {outer[idx], outer[3 + idx], outer[6 + idx]};
  const T col_norm = O::sqrt(dot3(col[0], col[1], col[2], col[0], col[1], col[2]));
  const T den = col_norm == T(0) ? T(1) : col_norm;
  const T axis[3] = {col[0] / den, col[1] / den, col[2] / den};
  const T dot = dot3(axis[0], axis[1], axis[2], h[0], h[1], h[2]);
  T sign = T(dot > T(0)) - T(dot < T(0));  // torch.sign: a NaN gives 0
  sign = sign == T(0) ? T(1) : sign;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T v = near_pi ? (theta * axis[i]) * sign : raw[i] * half;
    w[i] = is_nan(v) ? T(0) : v;
  }
}

// One edge's se(3) log: [t_d, so3_log(r_d)] of the expected pose er, et
// against world_to_from . to_to_world.
template <typename T>
__device__ void edge_log(const T* rf, const T* tf, const T* rt, const T* tt, const T* er, const T* et, T* out) {
  T rel[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      rel[3 * i + j] = dot3(rf[3 * i], rf[3 * i + 1], rf[3 * i + 2], rt[3 * j], rt[3 * j + 1], rt[3 * j + 2]);
  T t_rel[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) t_rel[i] = tf[i] - dot3(rel[3 * i], rel[3 * i + 1], rel[3 * i + 2], tt[0], tt[1], tt[2]);
  T rd[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      rd[3 * i + j] = dot3(er[3 * i], er[3 * i + 1], er[3 * i + 2], rel[j], rel[3 + j], rel[6 + j]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = dot3(er[3 * i], er[3 * i + 1], er[3 * i + 2], t_rel[0], t_rel[1], t_rel[2]) + et[i];
  so3_log(rd, out + 3);
}

// so3_exp(w) (graph_ba_core_plain's _so3_exp_fused), then the pose
// dr R, fma(total, rate, dr t) in place.
template <typename T>
__device__ void apply_delta(const T* total, T rate, T* rot, T* trans) {
  using O = Ops<T>;
  const T w0 = total[3] * rate, w1 = total[4] * rate, w2 = total[5] * rate;
  const T theta2 = dot3(w0, w1, w2, w0, w1, w2);
  const bool small = theta2 <= O::kEps;
  const T t2s = small ? T(1) : theta2;
  T c, s;
  O::cos_sin(O::sqrt(theta2), &c, &s);
  const T a = small ? O::fma(-theta2, O::kSixth, T(1)) : s * (T(1) / O::sqrt(t2s));
  const T b = small ? O::fma(-theta2, O::kP24, T(0.5)) : (T(1) - c) / t2s;
  const T hat[9] = {T(0), -w2, w1, w2, T(0), -w0, -w1, w0, T(0)};
  const T w01 = w0 * w1, w02 = w0 * w2, w12 = w1 * w2;
  const T hat2[9] = {O::fma(-w1, w1, -(w2 * w2)), w01, w02, w01, O::fma(-w0, w0, -(w2 * w2)), w12,
                     w02, w12, O::fma(-w0, w0, -(w1 * w1))};
  T dr[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) dr[k] = O::fma(b, hat2[k], O::fma(a, hat[k], k % 4 == 0 ? T(1) : T(0)));
  T nr[9], nt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      nr[3 * i + j] = dot3(dr[3 * i], dr[3 * i + 1], dr[3 * i + 2], rot[j], rot[3 + j], rot[6 + j]);
    nt[i] = O::fma(total[i], rate, dot3(dr[3 * i], dr[3 * i + 1], dr[3 * i + 2], trans[0], trans[1], trans[2]));
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) rot[k] = nr[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) trans[k] = nt[k];
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared bytes of the views' state (rot, trans, list starts, flags) and,
// staged, of the edges (rot, t, logs, to, from, lists).
template <typename T>
__host__ __device__ __forceinline__ size_t view_bytes(int v) {
  return align16(sizeof(T) * 12 * v) + align16(sizeof(int) * (v + 1)) + align16(v);
}
template <typename T>
__host__ __device__ __forceinline__ size_t edge_bytes(int e) {
  return align16(sizeof(T) * 18 * e) + align16(sizeof(int) * 3 * e);
}

// Flags of a view: removed, has an incoming valid edge.
constexpr unsigned char kRemoved = 1, kHasEdge = 2;

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
    graph_ba_kernel(const T* __restrict__ rot_in, const T* __restrict__ trans_in, const int64_t* __restrict__ to_in,
                    const int64_t* __restrict__ from_in, const T* __restrict__ erot_in, const T* __restrict__ et_in,
                    const uint8_t* __restrict__ valid_in, int v_count, int e_count, int iterations, T rate,
                    T* __restrict__ rot_out, T* __restrict__ trans_out, uint8_t* __restrict__ removed_out,
                    T* __restrict__ log_scratch, int* __restrict__ int_scratch) {
  const int tid = threadIdx.x, nt = blockDim.x;
  unsigned char* p = dynamic_shared();
  T* rot = reinterpret_cast<T*>(p);
  T* trans = rot + 9 * v_count;
  p += align16(sizeof(T) * 12 * v_count);
  int* start = reinterpret_cast<int*>(p);  // view v's list: list[start[v] .. start[v + 1])
  p += align16(sizeof(int) * (v_count + 1));
  unsigned char* flags = p;
  p += align16(v_count);
  const T* erot = erot_in;
  const T* et = et_in;
  T* logs = log_scratch;
  int* to = int_scratch;
  if (kStaged) {
    T* s_erot = reinterpret_cast<T*>(p);
    T* s_et = s_erot + 9 * e_count;
    for (int k = tid; k < 12 * e_count; k += nt) s_erot[k] = k < 9 * e_count ? erot_in[k] : et_in[k - 9 * e_count];
    erot = s_erot;
    et = s_et;
    logs = s_et + 3 * e_count;
    to = reinterpret_cast<int*>(p + align16(sizeof(T) * 18 * e_count));
  }
  int* from = to + e_count;
  int* list = from + e_count;
  for (int k = tid; k < 9 * v_count; k += nt) rot[k] = rot_in[k];
  for (int k = tid; k < 3 * v_count; k += nt) trans[k] = trans_in[k];
  // An invalid edge (or one outside [0, V)) is in no list: to = -1.
  for (int e = tid; e < e_count; e += nt) {
    const int64_t a = to_in[e], b = from_in[e];
    const bool ok = valid_in[e] != 0 && a >= 0 && a < v_count && b >= 0 && b < v_count;
    to[e] = ok ? static_cast<int>(a) : -1;
    from[e] = ok ? static_cast<int>(b) : 0;
  }
  __syncthreads();
  // Each view's incoming list in edge order: count, prefix, fill.
  for (int v = tid; v < v_count; v += nt) {
    int n = 0;
    for (int e = 0; e < e_count; ++e) n += to[e] == v;
    start[v + 1] = n;
    flags[v] = n > 0 ? kHasEdge : kRemoved;
  }
  __syncthreads();
  if (tid == 0) {
    start[0] = 0;
    for (int v = 0; v < v_count; ++v) start[v + 1] += start[v];
  }
  __syncthreads();
  for (int v = tid; v < v_count; v += nt) {
    int k = start[v];
    for (int e = 0; e < e_count; ++e)
      if (to[e] == v) list[k++] = e;
  }
  __syncthreads();
  for (int round = 0; round < iterations; ++round) {
    for (int e = tid; e < e_count; e += nt) {
      const int a = to[e], b = from[e];
      if (a < 0) continue;
      T* out = logs + 6 * e;
      if ((flags[a] | flags[b]) & kRemoved) {
#pragma unroll
        for (int k = 0; k < 6; ++k) out[k] = T(0);
      } else {
        edge_log(rot + 9 * b, trans + 3 * b, rot + 9 * a, trans + 3 * a, erot + 9 * e, et + 3 * e, out);
      }
    }
    __syncthreads();
    for (int v = tid; v < v_count; v += nt) {
      if (flags[v] & kRemoved) continue;
      T total[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      for (int k = start[v]; k < start[v + 1]; ++k) {
        const T* l = logs + 6 * list[k];
#pragma unroll
        for (int j = 0; j < 6; ++j) total[j] = total[j] + l[j];
      }
      bool finite = true;
#pragma unroll
      for (int j = 0; j < 6; ++j) finite = finite && isfinite(total[j] * rate);
      if (finite) {
        apply_delta(total, rate, rot + 9 * v, trans + 3 * v);
      } else {
        flags[v] |= kRemoved;
      }
    }
    __syncthreads();
  }
  for (int k = tid; k < 9 * v_count; k += nt) rot_out[k] = rot[k];
  for (int k = tid; k < 3 * v_count; k += nt) trans_out[k] = trans[k];
  for (int v = tid; v < v_count; v += nt) removed_out[v] = flags[v] & kRemoved;
}

template <typename T>
int launch(const T* rot, const T* trans, const int64_t* to, const int64_t* from, const T* erot, const T* et,
           const uint8_t* valid, int v_count, int e_count, int iterations, double rate, T* rot_out, T* trans_out,
           uint8_t* removed_out, T* log_scratch, int* int_scratch, void* stream) {
  if (v_count <= 0) return 0;
  const size_t views = view_bytes<T>(v_count);
  if (views > static_cast<size_t>(kMaxShared)) return -1;
  const bool staged = views + edge_bytes<T>(e_count) <= static_cast<size_t>(kMaxShared);
  const size_t bytes = staged ? views + edge_bytes<T>(e_count) : views;
  const int busy = e_count > v_count ? e_count : v_count;
  const int threads = busy >= kMaxThreads ? kMaxThreads : (busy + 31) / 32 * 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T r = static_cast<T>(rate);
  if (staged) {
    cudaFuncSetAttribute(graph_ba_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    graph_ba_kernel<T, true><<<1, threads, bytes, s>>>(rot, trans, to, from, erot, et, valid, v_count, e_count,
                                                       iterations, r, rot_out, trans_out, removed_out, log_scratch,
                                                       int_scratch);
  } else {
    cudaFuncSetAttribute(graph_ba_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    graph_ba_kernel<T, false><<<1, threads, bytes, s>>>(rot, trans, to, from, erot, et, valid, v_count, e_count,
                                                        iterations, r, rot_out, trans_out, removed_out, log_scratch,
                                                        int_scratch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// graph_ba_core of (V, 3, 3) / (V, 3) poses and (E,) edges (to, from int64;
// valid one byte each) for `iterations` rounds at `rate` (rounded to the
// entry's type): rot_out, trans_out and removed_out (V bytes) written once
// at the end.  log_scratch holds 6 E values and int_scratch 3 E ints (used
// where the edges do not fit in shared memory).  Launches one block on
// `stream`; returns cudaGetLastError(), or -1 where the views do not fit in
// shared memory.
extern "C" int cv_graph_ba_f64(const double* rot, const double* trans, const int64_t* to, const int64_t* from,
                               const double* erot, const double* et, const uint8_t* valid, int v_count,
                               int e_count, int iterations, double rate, double* rot_out, double* trans_out,
                               uint8_t* removed_out, double* log_scratch, int* int_scratch, void* stream) {
  return launch(rot, trans, to, from, erot, et, valid, v_count, e_count, iterations, rate, rot_out, trans_out,
                removed_out, log_scratch, int_scratch, stream);
}

extern "C" int cv_graph_ba_f32(const float* rot, const float* trans, const int64_t* to, const int64_t* from,
                               const float* erot, const float* et, const uint8_t* valid, int v_count, int e_count,
                               int iterations, double rate, float* rot_out, float* trans_out, uint8_t* removed_out,
                               float* log_scratch, int* int_scratch, void* stream) {
  return launch(rot, trans, to, from, erot, et, valid, v_count, e_count, iterations, rate, rot_out, trans_out,
                removed_out, log_scratch, int_scratch, stream);
}
