"""Float32 atan2, cosine and sine with the reference's bits on every device.

``cv_tpu`` takes ``jnp.arctan2``, ``jnp.cos`` and ``jnp.sin`` of float32
from XLA, whose CPU backend calls the C library's ``atan2f``, ``cosf`` and
``sinf``: in glibc 2.36, fdlibm's float ``atan2f``/``__atanf``, and for
``cosf``/``sinf`` a double-precision reduction by pi/2 and polynomial,
rounded once to float (the x86-64 build that uses fused multiply-adds).
``torch.atan2``/``torch.cos``/``torch.sin`` round otherwise, and on a CPU
an element's bits even depend on its place in the batch (the vectorised
loop body and its scalar tail round differently).

The plain versions here state those glibc functions in elementwise torch
operations that each round once under IEEE (add, subtract, multiply,
divide, compare, select, integer bit tests), so their bits are the same on
every device, at every shape and at every batch position.  glibc's fused
multiply-adds are written out exactly (:func:`_fma`).  ``csrc/trig.cuh``
is the same code, operation for operation, for the kernels:
``csrc/trig_probe.cu`` (:func:`angle_cv`, :func:`cos_sin`) and
``csrc/select_fused.cu``.

On a CPU tensor :func:`angle_cv` and :func:`cos_sin` run their plain
versions; on a CUDA tensor they launch ``csrc/trig_probe.cu`` or raise.
Each counts its launches on ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import kernels

TWO_PI = float(np.float32(2.0 * np.pi))


def _f32(bits: int) -> float:
    """The float32 with IEEE bits ``bits``, as an exact Python float."""
    return float(np.array(bits, dtype=np.uint32).view(np.float32))


# ---------------------------------------------------------------------------
# atan2f: fdlibm's float algorithm (glibc sysdeps/ieee754/flt-32)
# ---------------------------------------------------------------------------

ATANHI = tuple(_f32(b) for b in (0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA))
ATANLO = tuple(_f32(b) for b in (0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168))
AT = tuple(_f32(b) for b in (0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E, 0xBD9D8795,
                             0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221, 0x3C8569D7))
PI = _f32(0x40490FDB)
PI_O_2 = _f32(0x3FC90FDB)
PI_O_4 = _f32(0x3F490FDB)
PI_LO = _f32(0xB3BBBD2E)
# The constants that fdlibm forms in float at run time, rounded as it does.
ATAN_INF = float(np.float32(ATANHI[3]) + np.float32(ATANLO[3]))  # __atanf(+-inf)
THREE_PI_O_4 = float(np.float32(3.0) * np.float32(PI_O_4))
PI_O_2_SAT = float(np.float32(PI_O_2) + np.float32(0.5) * np.float32(PI_LO))  # |y/x| > 2^60


def _pick(index: torch.Tensor, values) -> torch.Tensor:
    """``values[index]`` for a small table of float32 constants, by selects."""
    out = torch.full_like(index, values[-1], dtype=torch.float32)
    for i in range(len(values) - 2, -1, -1):
        out = torch.where(index == i, values[i], out)
    return out


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``__atanf``: the reduction at 7/16, 11/16, 19/16 and 39/16,
    the odd and even halves of the 11-term polynomial, saturation at
    ``|x| >= 2^25``."""
    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    ax = x.abs()
    one = torch.ones_like(x)
    ident = torch.where(ix < 0x3EE00000, -1, torch.where(ix < 0x3F300000, 0, torch.where(
        ix < 0x3F980000, 1, torch.where(ix < 0x401C0000, 2, 3))))
    t = torch.where(ident == 0, (ax * 2.0 - 1.0) / (ax + 2.0), torch.where(
        ident == 1, (ax - 1.0) / (ax + 1.0), torch.where(
            ident == 2, (ax - 1.5) / (ax * 1.5 + 1.0), -(one / ax))))
    t = torch.where(ident < 0, x, t)
    z = t * t
    w = z * z
    s1 = z * (w * (w * (w * (w * (w * AT[10] + AT[8]) + AT[6]) + AT[4]) + AT[2]) + AT[0])
    s2 = w * (w * (w * (w * (w * AT[9] + AT[7]) + AT[5]) + AT[3]) + AT[1])
    small = t - t * (s1 + s2)
    big = _pick(ident, ATANHI) - ((t * (s1 + s2) - _pick(ident, ATANLO)) - t)
    big = torch.where(hx < 0, -big, big)
    out = torch.where(ident < 0, small, big)
    out = torch.where(ix < 0x31000000, x, out)  # |x| < 2^-29
    sat = torch.full_like(x, ATAN_INF)
    sat = torch.where(hx > 0, sat, -sat)
    return torch.where(ix >= 0x4C000000, torch.where(ix > 0x7F800000, x + x, sat), out)


def _flush(v: torch.Tensor) -> torch.Tensor:
    """A subnormal float32 as the zero of its sign."""
    return torch.where((v.view(torch.int32) & 0x7F800000) == 0, v * 0.0, v)


def atan2_f32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's ``atan2f(y, x)`` of float32 tensors (broadcast), every
    special case included; a NaN in gives a NaN out.

    XLA's CPU code runs with subnormals flushed to zero, as operands and as
    results (the TPU has none either), so the reference's quotient ``y /
    x`` reads a subnormal ``y`` or ``x`` as zero and gives zero for a
    subnormal quotient; the bit tests still see the subnormal.  The
    quotient is the only operation of atan2f that meets a subnormal where
    that changes the result, and it is flushed here in the same way."""
    y, x = torch.broadcast_tensors(y, x)
    y, x = y.contiguous(), x.contiguous()
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)  # 2 sign(x) + sign(y)
    # The general case, from the quotient's exponent.
    k = (iy - ix) >> 23
    z = _atanf(_flush(_flush(y) / _flush(x)).abs())
    z = torch.where(k > 60, PI_O_2_SAT, torch.where((hx < 0) & (k < -60), 0.0, z))
    zl = z - PI_LO
    out = torch.where(m == 0, z, torch.where(m == 1, -z, torch.where(m == 2, PI - zl, zl - PI)))
    # The special cases, lowest precedence first.
    half_pi = torch.full_like(x, PI_O_2)
    half_pi = torch.where(hy < 0, -half_pi, half_pi)
    pi = torch.full_like(x, PI)
    out = torch.where(iy == 0x7F800000, half_pi, out)
    inf_x = torch.where(iy == 0x7F800000, _pick(m, (PI_O_4, -PI_O_4, THREE_PI_O_4, -THREE_PI_O_4)),
                        _pick(m, (0.0, -0.0, PI, -PI)))
    out = torch.where(ix == 0x7F800000, inf_x, out)
    out = torch.where(ix == 0, half_pi, out)
    out = torch.where(iy == 0, torch.where(m < 2, y, torch.where(m == 2, pi, -pi)), out)
    out = torch.where(hx == 0x3F800000, _atanf(y), out)  # x = 1
    return torch.where((ix > 0x7F800000) | (iy > 0x7F800000), x + y, out)


def angle_cv_plain(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The OpenCV angle in [0, 2pi): ``remainder(atan2_f32(y, x) + 2pi,
    2pi)`` with float32 2pi.  ``atan2 + 2pi`` lies in [pi, 3pi], where the
    floored remainder is the sum or the sum less 2pi (exact there)."""
    a = atan2_f32(y, x) + TWO_PI
    return torch.where(a >= TWO_PI, a - TWO_PI, a)


# ---------------------------------------------------------------------------
# cosf / sinf: glibc's double reduction and polynomials (flt-32/s_sinf.c,
# s_cosf.c, sincosf.h, sincosf_data.c), built for x86-64 with FMA
# ---------------------------------------------------------------------------

HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")  # 2/pi * 2^24
HPI = float.fromhex("0x1.921fb54442d18p+0")
PI63 = float.fromhex("0x1.921fb54442d18p-62")  # 2 pi * 2^-64
# cos: c0..c4; sin: s1..s3 (the table of quadrants 0 and 1; quadrants 2
# and 3 negate c0..c4).
C = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"), float.fromhex("0x1.55553e1068f19p-5"),
     float.fromhex("-0x1.6c087e89a359dp-10"), float.fromhex("0x1.99343027bf8c3p-16"))
S = (float.fromhex("-0x1.555545995a603p-3"), float.fromhex("0x1.1107605230bc4p-7"),
     float.fromhex("-0x1.994eb3774cf24p-13"))
# 4/pi in 192 bits, 32 bits a word at every 8-bit offset.
INV_PIO4 = (0xA2, 0xA2F9, 0xA2F983, 0xA2F9836E, 0xF9836E4E, 0x836E4E44, 0x6E4E4415, 0x4E441529,
            0x441529FC, 0x1529FC27, 0x29FC2757, 0xFC2757D1, 0x2757D1F5, 0x57D1F534, 0xD1F534DD, 0xF534DDC0,
            0x34DDC0DB, 0xDDC0DB62, 0xC0DB6295, 0xDB629599, 0x6295993C, 0x95993C43, 0x993C4390, 0x3C439041)
SPLIT = 134217729.0  # 2^27 + 1: Veltkamp's split of a double into two 26-bit halves
LOW32 = 0xFFFFFFFF


def _two_prod(a: torch.Tensor, b):
    """``(p, e)`` with ``p = a * b`` rounded and ``p + e == a * b``
    exactly (Dekker; no overflow in the split).  ``b``: a float64 tensor or
    a Python float (a double: its split is the same arithmetic)."""
    p = a * b
    t = a * SPLIT
    ah = t - (t - a)
    al = a - ah
    t = b * SPLIT
    bh = t - (t - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once, in float64 (the x86 ``vfmadd``).

    The exact product ``p + e`` and the exact sum ``s + t`` of ``c`` and
    ``p``; ``t + e`` is rounded to odd, so the last rounding of ``s + (t +
    e)`` is the single rounding of the exact sum (Boldo and Melquiond)."""
    p, e = _two_prod(a, b)
    s = c + p
    bb = s - c
    t = (c - (s - bb)) + (p - bb)
    u = t + e
    bb = u - t
    err = (t - (u - bb)) + (e - bb)
    bits = u.view(torch.int64)
    inexact_even = (err != 0) & ((bits & 1) == 0)
    # One step away from zero where u and the error have the same sign,
    # toward zero otherwise.
    step = torch.where((err > 0) == (u > 0), 1, -1)
    u = torch.where(inexact_even, (bits + step).view(torch.float64), u)
    return s + u


@lru_cache(maxsize=None)
def _inv_pio4(device: torch.device) -> torch.Tensor:
    return torch.tensor(INV_PIO4, dtype=torch.int64, device=device)


def _reduce_large(bits: torch.Tensor):
    """glibc's ``reduce_large`` of float bits with ``|x| >= 120``: the
    product with 4/pi modulo 2 as a 2.62 fixed-point integer, in 32-bit
    limbs.  Returns the reduced angle (float64) and the quadrant ``n``."""
    table = _inv_pio4(bits.device)
    b = bits.to(torch.int64) & LOW32
    idx = (b >> 26) & 15
    shift = (b >> 23) & 7
    xi = ((b & 0xFFFFFF) | 0x800000) << shift  # < 2^31
    a0, a4, a8 = table[idx], table[idx + 4], table[idx + 8]
    hi = (xi * a0) & LOW32  # the 32-bit product
    res1 = xi * a4  # < 2^63
    lo = ((xi * a8) >> 32) + (res1 & LOW32)
    hi = (hi + (res1 >> 32) + (lo >> 32)) & LOW32
    lo = lo & LOW32
    top = hi + (1 << 29)
    n = (top >> 30) & 3
    signed_hi = (top & ((1 << 30) - 1)) - (1 << 29)
    value = signed_hi * (1 << 32) + lo  # |value| < 2^61
    return value.to(torch.float64) * PI63, n


def _sin_poly(xs, x2):
    x3 = xs * x2
    s1 = _fma(x2, S[2], torch.full_like(x2, S[1]))
    x7 = x3 * x2
    s = _fma(x3, S[0], xs)
    return _fma(x7, s1, s)


def _cos_poly(x2):
    x4 = x2 * x2
    c2 = _fma(x2, C[4], torch.full_like(x2, C[3]))
    c1 = _fma(x2, C[1], torch.full_like(x2, C[0]))
    x6 = x4 * x2
    c = _fma(x4, C[2], c1)
    return _fma(x6, c2, c)


def _sincos(a: torch.Tensor, cosine: bool) -> torch.Tensor:
    a = a.contiguous()
    bits = a.view(torch.int32)
    top = (bits >> 20) & 0x7FF
    small, fast, finite = top < 0x3F4, top < 0x42F, top < 0x7F8
    x = a.to(torch.float64)
    # |a| < 120: n = round(a 2/pi) by the scaled truncation, r = a - n pi/2.
    xm = torch.where(fast, x, 0.0)
    n = ((xm * HPI_INV).to(torch.int32) + 0x800000) >> 24
    r = _fma(n.to(torch.float64), -HPI, xm)
    q = n
    # |a| >= 120: the 4/pi product; the quadrant of the sign and the tables
    # also take the input's sign.
    rl, nl = _reduce_large(torch.where(finite & ~fast, bits, 0))
    r = torch.where(fast, r, rl)
    n = torch.where(fast, n, nl.to(torch.int32))
    q = torch.where(fast, q, n + ((bits >> 31) & 1))
    r = torch.where(small, x, r)
    n = torch.where(small, 0, n)
    q = torch.where(small, 0, q)
    sign = torch.where(((q & 3) == 1) | ((q & 3) == 2), -1.0, 1.0).to(torch.float64)
    x2 = r * r
    c = _cos_poly(x2)
    c = torch.where((q & 2) != 0, -c, c)
    s = _sin_poly(r * sign, x2)
    use_cos = (n & 1) == (0 if cosine else 1)
    out = torch.where(use_cos, c, s).to(torch.float32)
    tiny = top < 0x398  # |a| < 2^-12
    out = torch.where(tiny, torch.ones_like(a) if cosine else a, out)
    return torch.where(finite, out, a - a)  # inf or NaN in: NaN out


def cos_f32(a: torch.Tensor) -> torch.Tensor:
    """glibc's ``cosf`` of a float32 tensor."""
    return _sincos(a, cosine=True)


def sin_f32(a: torch.Tensor) -> torch.Tensor:
    """glibc's ``sinf`` of a float32 tensor."""
    return _sincos(a, cosine=False)


def cos_sin_plain(a: torch.Tensor):
    """``(cos_f32(a), sin_f32(a))``."""
    return cos_f32(a), sin_f32(a)


# ---------------------------------------------------------------------------
# The wrappers of csrc/trig_probe.cu
# ---------------------------------------------------------------------------

_VOID, _I64 = ctypes.c_void_p, ctypes.c_int64


def _checked(name: str, *tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{name}: float32 tensors only, got {[t.dtype for t in tensors]}")
    return dev


def _launch(symbol: str, argtypes, *args):
    err = kernels.function("trig_probe", symbol, argtypes)(*args)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")


def angle_cv(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """:func:`angle_cv_plain` of two float32 tensors of one shape: on a CUDA
    tensor one launch of ``csrc/trig_probe.cu`` (``cv_trig_angle``)."""
    dev = _checked("angle_cv", y, x)
    if dev.type == "cpu":
        return angle_cv_plain(y, x)
    if y.shape != x.shape:
        raise ValueError(f"angle_cv: shapes differ, {tuple(y.shape)} and {tuple(x.shape)}")
    y, x = y.contiguous(), x.contiguous()
    out = torch.empty_like(y)
    _launch("cv_trig_angle", [_VOID] * 3 + [_I64, ctypes.c_float, _VOID], y.data_ptr(), x.data_ptr(),
            out.data_ptr(), y.numel(), ctypes.c_float(TWO_PI), kernels.current_stream(dev))
    angle_cv.launches += 1
    return out


angle_cv.launches = 0  # kernel launches so far (CPU calls do not count)


def cos_sin(a: torch.Tensor):
    """:func:`cos_sin_plain` of a float32 tensor: on a CUDA tensor one
    launch of ``csrc/trig_probe.cu`` (``cv_trig_cos_sin``)."""
    dev = _checked("cos_sin", a)
    if dev.type == "cpu":
        return cos_sin_plain(a)
    a = a.contiguous()
    co, si = torch.empty_like(a), torch.empty_like(a)
    _launch("cv_trig_cos_sin", [_VOID] * 3 + [_I64, _VOID], a.data_ptr(), co.data_ptr(), si.data_ptr(), a.numel(),
            kernels.current_stream(dev))
    cos_sin.launches += 1
    return co, si


cos_sin.launches = 0


def empty_launch(dev: torch.device) -> None:
    """One launch of an empty kernel of ``csrc/trig_probe.cu``: the floor
    that a trig call's time is read against."""
    _launch("cv_trig_empty", [_VOID], kernels.current_stream(dev))
