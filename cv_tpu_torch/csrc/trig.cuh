// Float32 atan2, cosine and sine with the reference's bits: glibc 2.36's
// atan2f (fdlibm's float algorithm) and its cosf/sinf (a double reduction by
// pi/2 and polynomials, the x86-64 build with fused multiply-adds, rounded
// once to float), which is what XLA's CPU backend calls for cv_tpu's
// jnp.arctan2/cos/sin.  The same code, operation for operation, as
// cv_tpu_torch/ops/trig.py (the plain versions), so a kernel that includes
// this header gives their bits.
//
// Every float and double operation is an explicit round-to-nearest
// intrinsic (no contraction under any --fmad setting), and glibc's fused
// multiply-adds are __fma_rn.  libdevice's atan2f/cosf/sinf round otherwise
// and are not used.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace cv_trig
