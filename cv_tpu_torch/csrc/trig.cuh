// Float32 atan2, cosine and sine with the reference's bits: glibc 2.36's
// atan2f (fdlibm's float algorithm) and its cosf/sinf (a double reduction by
// pi/2 and polynomials, the x86-64 build with fused multiply-adds, rounded
// once to float), which is what XLA's CPU backend calls for cv_tpu's
// jnp.arctan2/cos/sin.  The same code, operation for operation, as
// cv_tpu_torch/ops/trig.py (the plain versions), so a kernel that includes
// this header gives their bits.
//
// The float64 section is glibc 2.36's double sin, cos (dbl-64/s_sin.c,
// branred.c) and atan2 (dbl-64/e_atan2.c), the x86-64 FMA build that XLA's
// CPU backend calls for jnp.sin/cos/arctan2 of float64, with atan2 under
// the flush-to-zero and denormals-are-zero mode that XLA runs it in; its
// tables are trig64_tables.cuh, copied from libm.so.6.
//
// Every float and double operation is an explicit round-to-nearest
// intrinsic (no contraction under any --fmad setting), and glibc's fused
// multiply-adds are __fma_rn.  libdevice's atan2f/cosf/sinf and its double
// functions round otherwise and are not used.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "trig64_tables.cuh"

namespace cv_trig {

// ---------------------------------------------------------------------------
// atan2f (sysdeps/ieee754/flt-32/e_atan2f.c, s_atanf.c)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bits_f(uint32_t b) { return __uint_as_float(b); }

// __atanf: reductions at 7/16, 11/16, 19/16 and 39/16, the odd and even
// halves of the 11-term polynomial, saturation at |x| >= 2^25.
__device__ __forceinline__ float atanf_ref(float x) {
  const int32_t hx = __float_as_int(x);
  const int32_t ix = hx & 0x7fffffff;
  if (ix >= 0x4c000000) {  // |x| >= 2^25
    if (ix > 0x7f800000) return __fadd_rn(x, x);  // NaN
    const float sat = __fadd_rn(bits_f(0x3fc90fda), bits_f(0x33a22168));
    return hx > 0 ? sat : -sat;
  }
  int id;
  float t;
  if (ix < 0x3ee00000) {  // |x| < 7/16
    if (ix < 0x31000000) return x;  // |x| < 2^-29
    id = -1;
    t = x;
  } else {
    const float ax = fabsf(x);
    if (ix < 0x3f980000) {
      if (ix < 0x3f300000) {  // 7/16 <= |x| < 11/16
        id = 0;
        t = __fdiv_rn(__fsub_rn(__fmul_rn(ax, 2.0f), 1.0f), __fadd_rn(ax, 2.0f));
      } else {  // 11/16 <= |x| < 19/16
        id = 1;
        t = __fdiv_rn(__fsub_rn(ax, 1.0f), __fadd_rn(ax, 1.0f));
      }
    } else if (ix < 0x401c0000) {  // 19/16 <= |x| < 39/16
      id = 2;
      t = __fdiv_rn(__fsub_rn(ax, 1.5f), __fadd_rn(__fmul_rn(ax, 1.5f), 1.0f));
    } else {  // 39/16 <= |x| < 2^25
      id = 3;
      t = -__fdiv_rn(1.0f, ax);
    }
  }
  const float z = __fmul_rn(t, t);
  const float w = __fmul_rn(z, z);
  float s1 = __fadd_rn(__fmul_rn(w, bits_f(0x3c8569d7)), bits_f(0x3d4bda59));
  s1 = __fadd_rn(__fmul_rn(w, s1), bits_f(0x3d886b35));
  s1 = __fadd_rn(__fmul_rn(w, s1), bits_f(0x3dba2e6e));
  s1 = __fadd_rn(__fmul_rn(w, s1), bits_f(0x3e124925));
  s1 = __fmul_rn(z, __fadd_rn(__fmul_rn(w, s1), bits_f(0x3eaaaaab)));
  float s2 = __fadd_rn(__fmul_rn(w, bits_f(0xbd15a221)), bits_f(0xbd6ef16b));
  s2 = __fadd_rn(__fmul_rn(w, s2), bits_f(0xbd9d8795));
  s2 = __fadd_rn(__fmul_rn(w, s2), bits_f(0xbde38e38));
  s2 = __fmul_rn(w, __fadd_rn(__fmul_rn(w, s2), bits_f(0xbe4ccccd)));
  const float ts = __fmul_rn(t, __fadd_rn(s1, s2));
  if (id < 0) return __fsub_rn(t, ts);
  const uint32_t hi[4] = {0x3eed6338u, 0x3f490fdau, 0x3f7b985eu, 0x3fc90fdau};
  const uint32_t lo[4] = {0x31ac3769u, 0x33222168u, 0x33140fb4u, 0x33a22168u};
  const float r = __fsub_rn(bits_f(hi[id]), __fsub_rn(__fsub_rn(ts, bits_f(lo[id])), t));
  return hx < 0 ? -r : r;
}

// A subnormal as the zero of its sign.
__device__ __forceinline__ float flush(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0 ? __fmul_rn(v, 0.0f) : v;
}

// atan2f(y, x), every special case of fdlibm's; a NaN in gives a NaN out.
// The quotient reads and gives subnormals as zero, as the reference's does
// (XLA's CPU code runs with subnormals flushed).
__device__ __forceinline__ float atan2f_ref(float y, float x) {
  const float pi = bits_f(0x40490fdb), pi_o_2 = bits_f(0x3fc90fdb), pi_o_4 = bits_f(0x3f490fdb);
  const float pi_lo = bits_f(0xb3bbbd2e);
  const int32_t hx = __float_as_int(x), hy = __float_as_int(y);
  const int32_t ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return __fadd_rn(x, y);
  if (hx == 0x3f800000) return atanf_ref(y);  // x = 1
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);  // 2 sign(x) + sign(y)
  if (iy == 0) return m < 2 ? y : (m == 2 ? pi : -pi);
  if (ix == 0) return hy < 0 ? -pi_o_2 : pi_o_2;
  if (ix == 0x7f800000) {
    if (iy == 0x7f800000) {
      const float three = __fmul_rn(3.0f, pi_o_4);
      return m == 0 ? pi_o_4 : (m == 1 ? -pi_o_4 : (m == 2 ? three : -three));
    }
    return m == 0 ? 0.0f : (m == 1 ? -0.0f : (m == 2 ? pi : -pi));
  }
  if (iy == 0x7f800000) return hy < 0 ? -pi_o_2 : pi_o_2;
  const int k = (iy - ix) >> 23;
  float z;
  if (k > 60) {
    z = __fadd_rn(pi_o_2, __fmul_rn(0.5f, pi_lo));
  } else if (hx < 0 && k < -60) {
    z = 0.0f;
  } else {
    z = atanf_ref(fabsf(flush(__fdiv_rn(flush(y), flush(x)))));
  }
  switch (m) {
    case 0: return z;
    case 1: return -z;
    case 2: return __fsub_rn(pi, __fsub_rn(z, pi_lo));
    default: return __fsub_rn(__fsub_rn(z, pi_lo), pi);
  }
}

// remainder(atan2f_ref(y, x) + two_pi, two_pi) with two_pi = float32(2 pi):
// atan2 + 2pi lies in [pi, 3pi], where the floored remainder is the sum or
// the sum less 2pi (exact there, Sterbenz); a NaN stays a NaN.
__device__ __forceinline__ float angle_cv(float y, float x, float two_pi) {
  const float a = __fadd_rn(atan2f_ref(y, x), two_pi);
  return a >= two_pi ? __fsub_rn(a, two_pi) : a;
}

// ---------------------------------------------------------------------------
// cosf / sinf (sysdeps/ieee754/flt-32/s_sinf.c, s_cosf.c, sincosf.h)
// ---------------------------------------------------------------------------

// 4/pi in 192 bits, 32 bits a word at every 8-bit offset (__inv_pio4).
__device__ __constant__ uint32_t kInvPio4[24] = {
    0xa2u,       0xa2f9u,     0xa2f983u,   0xa2f9836eu, 0xf9836e4eu, 0x836e4e44u, 0x6e4e4415u, 0x4e441529u,
    0x441529fcu, 0x1529fc27u, 0x29fc2757u, 0xfc2757d1u, 0x2757d1f5u, 0x57d1f534u, 0xd1f534ddu, 0xf534ddc0u,
    0x34ddc0dbu, 0xddc0db62u, 0xc0db6295u, 0xdb629599u, 0x6295993cu, 0x95993c43u, 0x993c4390u, 0x3c439041u};

__device__ __forceinline__ double sin_poly(double xs, double x2) {
  const double x3 = __dmul_rn(xs, x2);
  const double s1 = __fma_rn(x2, -0x1.994eb3774cf24p-13, 0x1.1107605230bc4p-7);
  const double x7 = __dmul_rn(x3, x2);
  const double s = __fma_rn(x3, -0x1.555545995a603p-3, xs);
  return __fma_rn(x7, s1, s);
}

__device__ __forceinline__ double cos_poly(double x2) {
  const double x4 = __dmul_rn(x2, x2);
  const double c2 = __fma_rn(x2, 0x1.99343027bf8c3p-16, -0x1.6c087e89a359dp-10);
  const double c1 = __fma_rn(x2, -0x1.ffffffd0c621cp-2, 1.0);
  const double x6 = __dmul_rn(x4, x2);
  const double c = __fma_rn(x4, 0x1.55553e1068f19p-5, c1);
  return __fma_rn(x6, c2, c);
}

// cosf (cosine) or sinf of a.
__device__ __forceinline__ float sincos_ref(float a, bool cosine) {
  const uint32_t bits = __float_as_uint(a);
  const uint32_t top = (bits >> 20) & 0x7ff;
  if (top >= 0x7f8) return __fsub_rn(a, a);  // inf or NaN: NaN
  if (top < 0x398) return cosine ? 1.0f : a;  // |a| < 2^-12
  const double x = static_cast<double>(a);
  double r;
  int n, q;  // n: the quadrant; q: the quadrant of the signs and tables
  if (top < 0x3f4) {  // |a| < 0.75
    r = x;
    n = q = 0;
  } else if (top < 0x42f) {  // |a| < 120: n by the scaled truncation
    n = (__double2int_rz(__dmul_rn(x, 0x1.45f306dc9c883p+23)) + 0x800000) >> 24;
    r = __fma_rn(static_cast<double>(n), -0x1.921fb54442d18p+0, x);
    q = n;
  } else {  // the 4/pi product modulo 2 as a 2.62 fixed-point integer
    const uint32_t* arr = kInvPio4 + ((bits >> 26) & 15);
    const int shift = (bits >> 23) & 7;
    const uint32_t xi = ((bits & 0xffffff) | 0x800000) << shift;
    uint64_t res0 = xi * arr[0];
    const uint64_t res1 = static_cast<uint64_t>(xi) * arr[4];
    const uint64_t res2 = static_cast<uint64_t>(xi) * arr[8];
    res0 = (res2 >> 32) | (res0 << 32);
    res0 += res1;
    const uint64_t nn = (res0 + (1ull << 61)) >> 62;
    res0 -= nn << 62;
    r = __dmul_rn(__ll2double_rn(static_cast<int64_t>(res0)), 0x1.921fb54442d18p-62);
    n = static_cast<int>(nn);
    q = n + static_cast<int>(bits >> 31);
  }
  const double x2 = __dmul_rn(r, r);
  double out;
  if (((n & 1) == 0) == cosine) {
    out = cos_poly(x2);
    if (q & 2) out = -out;
  } else {
    const int s = q & 3;
    out = sin_poly(s == 1 || s == 2 ? -r : r, x2);
  }
  return __double2float_rn(out);
}

__device__ __forceinline__ float cosf_ref(float a) { return sincos_ref(a, true); }
__device__ __forceinline__ float sinf_ref(float a) { return sincos_ref(a, false); }


// ---------------------------------------------------------------------------
// float64 sin / cos (sysdeps/ieee754/dbl-64/s_sin.c, branred.c)
// ---------------------------------------------------------------------------

// Word i of a table of float64 bits.  A row's words are read as
// tab64(table + row, j), one address a row and an immediate offset a word.
__device__ __forceinline__ double tab64(const uint64_t* table, int i) {
  return __longlong_as_double(static_cast<long long>(__ldg(reinterpret_cast<const unsigned long long*>(table) + i)));
}
__device__ __forceinline__ double bits_d(unsigned long long b) {
  return __longlong_as_double(static_cast<long long>(b));
}

constexpr double kBig = 0x1.8p45, kHp0 = 0x1.921fb54442d18p0, kHp1 = 0x1.1a62633145c07p-54;
constexpr double kSn3 = -0x1.5555555555515p-3, kSn5 = 0x1.11110e829872fp-7;
constexpr double kCs2 = 0.5, kCs4 = -0x1.5555555555535p-5, kCs6 = 0x1.6c16bedd9e239p-10;
constexpr double kTs1 = -0x1.5555555555555p-3, kTs2 = 0x1.1111111110ecep-7, kTs3 = -0x1.a01a019db08b8p-13,
                 kTs4 = 0x1.71de27b9a7ed9p-19, kTs5 = -0x1.addffc2fcdf59p-26;
constexpr double kHpInv = 0x1.45f306dc9c883p-1, kToInt = 0x1.8p52;
constexpr double kMp1 = 0x1.921fb58p0, kMp2 = -0x1.dde973cp-27, kPp3 = -0x1.cb3b398p-55, kPp4 = -0x1.d747f23e32ed7p-83;
constexpr double kSplit = 134217729.0, kTm600 = 0x1p-600, kTm24 = 0x1p-24, kBig1 = 0x1.8p54, kMp2Br = -0x1.dde974p-27;

// TAYLOR_SIN(x^2, x, dx): x + ((P(x^2) x - dx / 2) x^2 + dx).
__device__ __forceinline__ double taylor_sin(double x, double dx) {
  const double xx = __dmul_rn(x, x);
  double poly = __fma_rn(xx, kTs5, kTs4);
  poly = __fma_rn(poly, xx, kTs3);
  poly = __fma_rn(poly, xx, kTs2);
  poly = __fma_rn(poly, xx, kTs1);
  return __dadd_rn(x, __fma_rn(xx, __fma_rn(poly, x, -__dmul_rn(0.5, dx)), dx));
}

// The table point nearest |x| (a multiple of 1/128), the remainder and the
// table's sin, its low part, cos and its low part there.
struct SinCosPoint {
  double xr, sn, ssn, cs, ccs;
};

__device__ __forceinline__ SinCosPoint sincos_point(double x) {
  const double ax = fabs(x);
  const double u = __dadd_rn(ax, kBig);
  const int k = __double2loint(u) << 2;
  const uint64_t* row = kSinCosTab + k;
  return {__dsub_rn(ax, __dsub_rn(u, kBig)), tab64(row, 0), tab64(row, 1), tab64(row, 2), tab64(row, 3)};
}

// do_sin(x, dx): sin(x + dx), the Taylor form below 0.126.
__device__ __forceinline__ double do_sin(double x, double dx) {
  if (fabs(x) < 0.126) return taylor_sin(x, dx);
  const double dxs = x > 0 ? dx : -dx;
  const SinCosPoint t = sincos_point(x);
  const double xx = __dmul_rn(t.xr, t.xr);
  const double s = __dadd_rn(t.xr, __fma_rn(__dmul_rn(t.xr, xx), __fma_rn(xx, kSn5, kSn3), dxs));
  const double c = __fma_rn(t.xr, dxs, __dmul_rn(xx, __fma_rn(xx, __fma_rn(xx, kCs6, kCs4), kCs2)));
  const double cor = __fma_rn(s, t.cs, __fma_rn(-c, t.sn, __fma_rn(s, t.ccs, t.ssn)));
  return copysign(__dadd_rn(t.sn, cor), x);
}

// do_cos(x, dx): cos(x + dx).
__device__ __forceinline__ double do_cos(double x, double dx) {
  const double dxs = x < 0 ? -dx : dx;
  const SinCosPoint t = sincos_point(x);
  const double xr = __dadd_rn(t.xr, dxs);
  const double xx = __dmul_rn(xr, xr);
  const double s = __fma_rn(__dmul_rn(xr, xx), __fma_rn(xx, kSn5, kSn3), xr);
  const double c = __dmul_rn(xx, __fma_rn(xx, __fma_rn(xx, kCs6, kCs4), kCs2));
  return __dadd_rn(t.cs, __fma_rn(-s, t.sn, __fma_rn(-c, t.cs, __fma_rn(-s, t.ssn, t.ccs))));
}

// reduce_sincos (|x| < 105414350): x = n pi/2 + a + da to 136 bits.
__device__ __forceinline__ int reduce_sincos(double x, double* a, double* da) {
  const double t = __fma_rn(x, kHpInv, kToInt);
  const double xn = __dsub_rn(t, kToInt);
  const int n = __double2loint(t) & 3;
  const double y = __fma_rn(-xn, kMp2, __fma_rn(-xn, kMp1, x));
  const double t2 = __fma_rn(-xn, kPp3, y);
  const double db = __fma_rn(-xn, kPp3, __dsub_rn(y, t2));
  const double b = __fma_rn(-xn, kPp4, t2);
  *a = b;
  *da = __dadd_rn(db, __fma_rn(-xn, kPp4, __dsub_rn(t2, b)));
  return n;
}

// One half of __branred: x1 times 2/pi in six 24-bit pieces (toverp), the
// integer part summed apart.
__device__ __forceinline__ void branred_part(double x1, double* sum, double* b, double* bb) {
  int k = ((__double2hiint(x1) >> 20) & 2047) - 450;
  k = k > 0 ? k / 24 : 0;
  double gor = bits_d(static_cast<unsigned long long>(0x63f00000u - static_cast<unsigned>((k * 24) << 20)) << 32);
  double r[6];
  for (int i = 0; i < 6; ++i) {
    r[i] = __dmul_rn(__dmul_rn(x1, tab64(kToverp, k + i)), gor);
    gor = __dmul_rn(gor, kTm24);
  }
  double total = 0.0;
  for (int i = 0; i < 6; ++i) {
    const double s = __dsub_rn(__dadd_rn(r[i], kToInt), kToInt);
    total = __dadd_rn(total, s);
    r[i] = __dsub_rn(r[i], s);
  }
  double t = 0.0;
  for (int i = 0; i < 6; ++i) t = __dadd_rn(t, r[5 - i]);
  double c = __dsub_rn(r[0], t);
  for (int i = 1; i < 6; ++i) c = __dadd_rn(c, r[i]);
  const double s = __dsub_rn(__dadd_rn(t, kToInt), kToInt);
  total = __dadd_rn(total, s);
  t = __dsub_rn(t, s);
  *b = __dadd_rn(t, c);
  *bb = __dadd_rn(__dsub_rn(t, *b), c);
  *sum = __dsub_rn(total, __dsub_rn(__dadd_rn(total, kBig1), kBig1));
}

// __branred (|x| >= 105414350; glibc's generic build, no fused operations).
__device__ __forceinline__ int branred(double x, double* a, double* da) {
  x = __dmul_rn(x, kTm600);
  const double tx = __dmul_rn(x, kSplit);
  const double x1 = __dsub_rn(tx, __dsub_rn(tx, x));
  const double x2 = __dsub_rn(x, x1);
  double sum1, b1, bb1, sum2, b2, bb2;
  branred_part(x1, &sum1, &b1, &bb1);
  branred_part(x2, &sum2, &b2, &bb2);
  double total = __dadd_rn(sum1, sum2);
  double b = __dadd_rn(b1, b2);
  const double bb = fabs(b1) > fabs(b2) ? __dadd_rn(__dsub_rn(b1, b), b2) : __dadd_rn(__dsub_rn(b2, b), b1);
  if (b > 0.5) {
    b = __dsub_rn(b, 1.0);
    total = __dadd_rn(total, 1.0);
  } else if (b < -0.5) {
    b = __dadd_rn(b, 1.0);
    total = __dsub_rn(total, 1.0);
  }
  const double s = __dadd_rn(b, __dadd_rn(__dadd_rn(bb, bb1), bb2));
  const double t = __dadd_rn(__dadd_rn(__dsub_rn(b, s), bb), __dadd_rn(bb1, bb2));
  const double ts = __dmul_rn(s, kSplit);
  const double t1 = __dsub_rn(ts, __dsub_rn(ts, s));
  const double t2 = __dsub_rn(s, t1);
  const double hb = __dmul_rn(s, kHp0);
  const double hbb = __dadd_rn(
      __dadd_rn(__dadd_rn(__dsub_rn(__dmul_rn(t1, kMp1), hb), __dmul_rn(t1, kMp2Br)), __dmul_rn(t2, kMp1)),
      __dadd_rn(__dadd_rn(__dmul_rn(t2, kMp2Br), __dmul_rn(s, kHp1)), __dmul_rn(t, kHp0)));
  const double r = __dadd_rn(hb, hbb);
  *a = r;
  *da = __dadd_rn(__dsub_rn(hb, r), hbb);
  return static_cast<int>(static_cast<long long>(total)) & 3;
}

// cos(a) and sin(a) of glibc: one do_sin and one do_cos at the points that
// a's band names.
__device__ __forceinline__ void cos_sin64(double a, double* co, double* si) {
  const int k = __double2hiint(a) & 0x7fffffff;
  if (k >= 0x7ff00000) {  // inf or NaN: NaN
    *co = *si = __ddiv_rn(a, a);
    return;
  }
  double sx = a, sdx = 0.0, cx = a, cdx = 0.0;
  bool swap = false, neg_s = false, neg_c = false, middle = false;
  if (k >= 0x3feb6000 && k < 0x400368fd) {  // 0.855469 <= |a| < 2.426265
    const double t = __dsub_rn(kHp0, fabs(a));
    sx = __dadd_rn(t, kHp1);
    sdx = __dadd_rn(__dsub_rn(t, sx), kHp1);
    cx = t;
    cdx = kHp1;
    swap = middle = true;
  } else if (k >= 0x400368fd) {
    double r, dr;
    const int n = k < 0x419921fb ? reduce_sincos(a, &r, &dr) : branred(a, &r, &dr);
    sx = cx = r;
    sdx = cdx = dr;
    swap = n & 1;
    neg_s = n & 2;
    neg_c = (n + 1) & 2;
  }
  const double ds = do_sin(sx, sdx), dc = do_cos(cx, cdx);
  double s = swap ? dc : ds, c = swap ? ds : dc;
  if (middle) s = copysign(s, a);
  if (neg_s) s = -s;
  if (neg_c) c = -c;
  *si = k < 0x3e500000 ? a : s;
  *co = k < 0x3e400000 ? 1.0 : c;
}

// ---------------------------------------------------------------------------
// float64 atan2 (sysdeps/ieee754/dbl-64/e_atan2.c) under FTZ and DAZ
// ---------------------------------------------------------------------------

constexpr double kOpi = 0x1.921fb54442d18p1, kOpi1 = 0x1.1a62633145c07p-53;
constexpr double kQpi = 0x1.921fb54442d18p-1, kTqpi = 0x1.2d97c7f3321d2p1;
constexpr double kD3 = -0x1.5555555555555p-2, kD5 = 0x1.99999999997fdp-3, kD7 = -0x1.24924923f7603p-3,
                 kD9 = 0x1.c71c6e5129a3bp-4, kD11 = -0x1.7458022b13c25p-4, kD13 = 0x1.375f08b31cbcep-4;

// A subnormal double as the zero of its sign (XLA's DAZ/FTZ).
__device__ __forceinline__ double flush64(double v) {
  return (__double_as_longlong(v) & 0x7ff0000000000000ll) == 0 ? __dmul_rn(v, 0.0) : v;
}

// atan2_64's quotient forms, where its special cases and scalings have
// passed the arguments on: x (flushed) and |x|, |y| (flushed, scaled)
// nonzero, finite and less than 2^57 apart.
__device__ __forceinline__ double atan2_quotient(double y, double xf, double ax, double ay) {
  // u = min / max and its correction du (EMULV with a fused product).
  const bool lo_y = ay < ax;
  const double num = lo_y ? ay : ax, den = lo_y ? ax : ay;
  const double u = __ddiv_rn(num, den);
  const double v = __dmul_rn(den, u);
  const double du = __ddiv_rn(__dsub_rn(__dsub_rn(num, v), __fma_rn(den, u, -v)), den);
  // (i) x > 0, ay < ax: atan(u); (ii) x > 0: pi/2 - atan(u); (iii) x <= 0,
  // ay > ax: pi/2 + atan(u); (iv) x <= 0, ay <= ax: pi - atan(u).
  const bool pos = xf > 0;
  const bool case1 = pos && lo_y, case4 = !pos && ay <= ax;
  const double sigma = (!pos && !case4) ? 1.0 : -1.0;
  const double base = case4 ? kOpi : kHp0, base1 = case4 ? kOpi1 : kHp1;
  double z;
  if (u < 0.0625) {
    const double vv = __dmul_rn(u, u);
    double poly = __fma_rn(vv, kD13, kD11);
    poly = __fma_rn(poly, vv, kD9);
    poly = __fma_rn(poly, vv, kD7);
    poly = __fma_rn(poly, vv, kD5);
    poly = __fma_rn(poly, vv, kD3);
    const double uv = __dmul_rn(u, vv);
    if (case1) {
      z = __dadd_rn(u, __fma_rn(uv, poly, du));
    } else {
      const double t2 = __dadd_rn(base, __dmul_rn(sigma, u));
      const double cor = __dadd_rn(__dsub_rn(base, t2), __dmul_rn(sigma, u));
      z = __dadd_rn(t2, __dadd_rn(__dadd_rn(__dadd_rn(base1, cor), __dmul_rn(sigma, du)),
                                  __dmul_rn(sigma, __dmul_rn(uv, poly))));
    }
  } else {
    const int i = static_cast<int>(__dsub_rn(__dadd_rn(__dmul_rn(u, 256.0), 0x1p52), 0x1p52)) - 16;
    double c[7];
    const uint64_t* row = kAtanCij + i * 7;
    for (int j = 0; j < 7; ++j) c[j] = tab64(row, j);
    const double t3 = __dsub_rn(u, c[0]);
    const double w = __dadd_rn(t3, du);
    const double dw = fabs(t3) > fabs(du) ? __dadd_rn(__dsub_rn(t3, w), du) : __dadd_rn(__dsub_rn(du, w), t3);
    const double q = __fma_rn(__fma_rn(__fma_rn(c[6], w, c[5]), w, c[4]), w, c[3]);
    if (case1) {
      z = __dadd_rn(__fma_rn(w, c[2], __fma_rn(dw, c[2], __dmul_rn(__dmul_rn(w, w), q))), c[1]);
    } else {
      z = __dadd_rn(__dadd_rn(base, __dmul_rn(sigma, c[1])),
                    __fma_rn(__dmul_rn(sigma, w), __fma_rn(q, w, c[2]), base1));
    }
  }
  return copysign(z, y);
}

__device__ __forceinline__ double atan2_64(double y, double x) {
  const int ux = __double2hiint(x), dx = __double2loint(x), uy = __double2hiint(y), dy = __double2loint(y);
  if (isnan(x)) return __dadd_rn(x, y);
  if (isnan(y)) return __dadd_rn(y, y);
  if ((uy & 0x7fffffff) == 0 && dy == 0) return ux < 0 ? (uy < 0 ? -kOpi : kOpi) : (uy < 0 ? -0.0 : 0.0);
  const double xf = flush64(x), yf = flush64(y);
  const double half = uy < 0 ? -kHp0 : kHp0;
  if (xf == 0.0) return half;
  const bool y_inf = (uy & 0x7fffffff) == 0x7ff00000 && dy == 0;
  if ((ux & 0x7fffffff) == 0x7ff00000 && dx == 0) {
    if (ux < 0) return y_inf ? (uy < 0 ? -kTqpi : kTqpi) : (uy < 0 ? -kOpi : kOpi);
    return y_inf ? (uy < 0 ? -kQpi : kQpi) : (uy < 0 ? -0.0 : 0.0);
  }
  if (y_inf) return half;
  const int de = (uy & 0x7ff00000) - (ux & 0x7ff00000);
  if (de >= (57 << 20)) return yf > 0 ? kHp0 : -kHp0;
  if (de <= -(57 << 20)) {
    if (xf > 0) return copysign(flush64(__ddiv_rn(fabs(yf), fabs(xf))), y);
    return yf > 0 ? kOpi : -kOpi;
  }
  double ax = fabs(xf), ay = fabs(yf);
  if (ax < 0x1p-500 || ay < 0x1p-500) {
    ax = __dmul_rn(ax, 0x1p500);
    ay = __dmul_rn(ay, 0x1p500);
  }
  if (ax > 0x1p500 || ay > 0x1p500) {
    ax = __dmul_rn(ax, 0x1p-500);
    ay = __dmul_rn(ay, 0x1p-500);
  }
  return atan2_quotient(y, xf, ax, ay);
}

}  // namespace cv_trig
