"""atan2, cosine and sine with the reference's bits on every device.

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
multiply-adds are written out exactly (:func:`fma_f64`).  ``csrc/trig.cuh``
is the same code, operation for operation, for the kernels:
``csrc/trig_probe.cu`` (:func:`angle_cv`, :func:`cos_sin`) and
``csrc/select_fused.cu``.

The float64 section below is glibc's double ``atan2``, ``sin`` and
``cos`` in the same way (the x86-64 FMA build; its tables are
``csrc/trig64_tables.cuh``, copied from ``libm.so.6``), for the Jacobi
eigensolver and the so(3) maps.

On a CPU tensor :func:`angle_cv`, :func:`cos_sin` and :func:`atan2` run
their plain versions (by dtype); on a CUDA tensor they launch
``csrc/trig_probe.cu`` or raise.  Each counts its launches on
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import os
import re
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


def _split(a):
    """Veltkamp's split of a double: ``(hi, lo)``, 26 bits each, ``hi + lo
    == a``; Python floats are split with the same arithmetic."""
    t = a * SPLIT
    hi = t - (t - a)
    return hi, a - hi


def _odd_sum(p, e, q):
    """The exact sum ``s + t`` of ``p`` and ``q``, and ``u``, ``t + e``
    rounded to odd; also the error ``err`` of ``t + e``'s rounding to
    nearest and whether ``u`` moved off it (``stepped``)."""
    s = p + q
    bb = s - p
    t = (p - (s - bb)) + (q - bb)
    u = t + e
    bb = u - t
    err = (t - (u - bb)) + (e - bb)
    bits = u.view(torch.int64)
    # An inexact even u moves one unit toward the exact sum: up in
    # magnitude where the error has u's sign.
    step = ((err.view(torch.int64) ^ bits) >> 63) | 1
    stepped = (err != 0) & ((bits & 1) == 0)
    return s, torch.where(stepped, (bits + step).view(torch.float64), u), err, stepped


def _round_sum(p, e, q):
    """``p + e + q`` rounded once, where ``p + e`` is an exact product
    (Dekker) and ``q`` a double (a tensor or a Python float): the exact
    sum ``s + t`` of ``p`` and ``q``, ``t + e`` rounded to odd, then ``s``
    plus it (Boldo and Melquiond).  A zero sum takes ``p + q``'s sign, as
    the fused operation's does."""
    s, u, _, _ = _odd_sum(p, e, q)
    return torch.where(u == 0, s, s + u)


def fma_f64(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` of float64 rounded once (the x86 ``vfmadd``): ``a`` a
    tensor, ``b`` and ``c`` tensors or Python floats (broadcast).  Dekker's
    exact product with :func:`_round_sum` wherever that is exact (the
    product's error term a normal double, the split and the sum inside the
    range); the few elements outside (tiny or huge products, huge operands)
    are redone by :func:`_fma_scaled`, so the result is correctly rounded
    wherever it is finite, subnormal results included."""
    p = a * b
    out = _fma_dekker(a, b, c, p)
    pa, aa = p.abs(), a.abs()
    ba = b.abs() if isinstance(b, torch.Tensor) else abs(b)
    far = (pa < TINY_PRODUCT) | (pa >= HUGE_PRODUCT) | (aa >= HUGE_OPERAND) | (ba >= HUGE_OPERAND)
    # While a CUDA graph captures (the plain versions are timed so on a
    # card) the repair runs on every element, with no host sync.
    dense = out.is_cuda and torch.cuda.is_current_stream_capturing()
    if dense or bool(far.any()):
        # The fast form is exact where an operand is zero, or the product is
        # below a quarter unit of c (the sum then rounds to c), and the
        # other operand does not overflow the split: those keep it.  With
        # c = +-0 the result is the product, rounded once by the
        # multiplication itself (its zero keeps the product's sign).
        ca = c.abs() if isinstance(c, torch.Tensor) else abs(c)
        fast = ((a == 0) | (b == 0) | ((pa < TINY_PRODUCT) & (ca >= C_ABOVE_TINY))) & (aa < HUGE_OPERAND) \
            & (ba < HUGE_OPERAND)
        far = far & ~fast
        prod = far & (c == 0)
        out = torch.where(prod, p, out)
        far = far & ~prod
        if dense or bool(far.any()):
            out = _fma_scaled(a, b, c, out, far, dense)
    return out


def _fma_dekker(a, b, c, p=None):
    """:func:`fma_f64`'s fast form, Dekker's exact product and
    :func:`_round_sum`: correctly rounded where the product's error term is
    a normal double and the split and the sum stay finite (below), or where
    c swamps a tiny product.  The float32 functions' polynomials call it
    directly: their operands, float32 values and constants, stay there."""
    ah, al = _split(a)
    bh, bl = _split(b)
    p = a * b if p is None else p
    return _round_sum(p, ((ah * bh - p) + ah * bl + al * bh) + al * bl, c)


# Dekker's product is exact where |a b| >= 2^-969 (its error term a normal
# double) and the split and the sum stay finite: |a|, |b| < 2^996.
TINY_PRODUCT = 2.0 ** -960
C_ABOVE_TINY = 2.0 ** -900  # a unit of such a c is 2^-952 or more: a tiny product rounds away
HUGE_PRODUCT = 2.0 ** 990
HUGE_OPERAND = 2.0 ** 995


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """``2^k`` as float64 for integer ``k`` in [-1022, 1023], from its bits."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def _ldexp(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``x 2^k`` for ``|k| <= 3000``, in three exact steps of at most 2^1000
    each: the magnitude moves one way, so only the last step can round (to
    a subnormal or to infinity), as a single scaling would."""
    k = k.to(torch.int64)
    for _ in range(3):
        step = k.clamp(-1000, 1000)
        x = x * _pow2(step)
        k = k - step
    return x


def _round_sum_signed(p, e, q):
    """:func:`_round_sum`'s ``r = RN(p + e + q)`` and the sign of the exact
    ``p + e + q - r`` (-1, 0 or 1): the sign of the last sum's error where
    that is not zero, else of the odd rounding's remainder (below one unit
    of the odd term, so the last error, a multiple of that unit, outweighs
    it)."""
    s, u, err, stepped = _odd_sum(p, e, q)
    rest = torch.where(stepped, -torch.sign(err), torch.sign(err))  # sign of t + e - u
    r = torch.where(u == 0, s, s + u)
    bb = r - s
    err2 = (s - (r - bb)) + (u - bb)
    return r, torch.where(err2 != 0, torch.sign(err2), rest)


def _fma_scaled(a, b, c, out, far, dense: bool = False):
    """:func:`fma_f64` of the elements where ``far`` (all of them, selected
    after, where ``dense``; else only those), by :func:`_fma_scaled_values`;
    infinite and NaN operands keep ``out``."""
    shape = out.shape
    a, b, c = (v.expand(shape) if isinstance(v, torch.Tensor) else torch.full_like(out, v) for v in (a, b, c))
    far = far & torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c)
    if dense:
        return torch.where(far, _fma_scaled_values(a, b, c), out)
    idx = far.nonzero(as_tuple=True)
    if idx[0].numel() == 0:
        return out
    out = out.clone()
    out[idx] = _fma_scaled_values(a[idx], b[idx], c[idx])
    return out


def _fma_scaled_values(a, b, c):
    """``a * b + c`` of finite float64 tensors rounded once, with ``a`` and
    ``b`` scaled to their mantissas in [0.5, 1) and ``c`` by the same power
    of two, where every step is exact; the sum rounded there to 53 bits,
    then scaled back, exactly where the result is normal, else rounded once
    more to the subnormal grid with the sign of the first rounding's
    remainder.  A ``c`` 2^60 times the product or more is the result; one
    below 2^-110 of it only decides ties, so it stands in at 2^-120.  A zero
    ``a`` or ``b`` gives ``a b + c`` (exact)."""
    ma, ea = torch.frexp(a)
    mb, eb = torch.frexp(b)
    mc, ec = torch.frexp(c)
    ea, eb, ec = ea.long(), eb.long(), ec.long()
    eab = ea + eb  # |a b| in [2^(eab - 2), 2^eab)
    rel = ec - eab
    cs = torch.where(rel < -110, torch.copysign(torch.full_like(c, 2.0 ** -120), c), mc * _pow2(rel.clamp(-110, 60)))
    cs = torch.where(c == 0, c, cs)
    mah, mal = _split(ma)
    mbh, mbl = _split(mb)
    p = ma * mb
    r, rest = _round_sum_signed(p, ((mah * mbh - p) + mah * mbl + mal * mbh) + mal * mbl, cs)
    # The result is subnormal where |r| 2^eab < 2^-1022.
    er = torch.frexp(r)[1].long()
    normal = _ldexp(r, eab)
    # Subnormal: r in units of 2^-1074, rounded to an integer; a half-way r
    # goes the way of the remainder, or to even where it is exact.
    y = _ldexp(r, eab + 1074)
    half = (y - torch.trunc(y)).abs() == 0.5
    n = torch.where(half & (rest != 0), torch.where(rest > 0, torch.ceil(y), torch.floor(y)), torch.round(y))
    sub = _ldexp(torch.where(n == 0, r * 0, n), torch.full_like(eab, -1074))
    res = torch.where(er + eab <= -1022, sub, normal)
    res = torch.where((c != 0) & (rel > 60), c, res)
    return torch.where((a == 0) | (b == 0), a * b + c, res)


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 rounded once: the product is exact in
    float64, its sum with ``c`` rounded to odd there, then to float32."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
    q = c.double() if isinstance(c, torch.Tensor) else torch.full_like(p, c)
    t = p + q
    bb = t - p
    err = (p - (t - bb)) + (q - bb)
    bits = t.view(torch.int64)
    step = ((err.view(torch.int64) ^ bits) >> 63) | 1
    return torch.where((err != 0) & ((bits & 1) == 0), (bits + step).view(torch.float64), t).float()


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once, in ``a``'s dtype (float32 or float64):
    what XLA's CPU code computes where it contracts a product into the sum
    that takes it.  A CPU call on at most ``SMALL`` elements takes the C
    library's ``fma``/``fmaf`` where :func:`_libm` found them equal to the
    written-out forms (the pose loops' plain versions call it every step;
    an operand of at most ``SMALL`` elements decides, the others broadcast
    to it)."""
    if a.device.type == "cpu" and max(a.numel(), getattr(b, "numel", int)(), getattr(c, "numel", int)()) <= SMALL \
            and _libm() is not None:
        return _libm_fma(_libm(), a, b, c)
    return fma_f32(a, b, c) if a.dtype == torch.float32 else fma_f64(a, b, c)


def dot_fused(x, y, dim: int = -1, flush: bool = False) -> torch.Tensor:
    """``sum(x * y, dim)`` as a jitted XLA reduction of products sums it on
    a CPU: ``x0 y0 + 0``, then each next product fused into the sum,
    ``fma(x_k, y_k, acc)``, in order along ``dim`` (broadcast).  ``x`` and
    ``y`` may also be sequences of the terms (in ``y``, Python floats).
    ``flush``: each step's subnormal result flushed to zero, as XLA's CPU
    code does (:func:`ftz`)."""
    xs = x.unbind(dim) if isinstance(x, torch.Tensor) else x
    ys = y.unbind(dim) if isinstance(y, torch.Tensor) else y
    keep = ftz if flush else (lambda v: v)
    acc = keep(keep(xs[0] * ys[0]) + 0.0)
    for a, b in zip(xs[1:], ys[1:]):
        acc = keep(fma(a, b, acc))
    return acc


def ftz(v: torch.Tensor) -> torch.Tensor:
    """A subnormal as the zero of its sign, in ``v``'s dtype: XLA's CPU
    code runs with flush-to-zero and denormals-are-zero, so every result it
    computes below the normal range is that zero."""
    return _flush(v) if v.dtype == torch.float32 else _flush64(v)


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
    s1 = _fma_dekker(x2, S[2], S[1])
    x7 = x3 * x2
    s = _fma_dekker(x3, S[0], xs)
    return _fma_dekker(x7, s1, s)


def _cos_poly(x2):
    x4 = x2 * x2
    c2 = _fma_dekker(x2, C[4], C[3])
    c1 = _fma_dekker(x2, C[1], C[0])
    x6 = x4 * x2
    c = _fma_dekker(x4, C[2], c1)
    return _fma_dekker(x6, c2, c)


def _sincos(a: torch.Tensor):
    """``(cosf(a), sinf(a))``: one reduction, both polynomials; the cosine
    and the sine take them by the quadrant's parity."""
    a = a.contiguous()
    bits = a.view(torch.int32)
    top = (bits >> 20) & 0x7FF
    small, fast, finite = top < 0x3F4, top < 0x42F, top < 0x7F8
    x = a.to(torch.float64)
    # |a| < 120: n = round(a 2/pi) by the scaled truncation, r = a - n pi/2.
    xm = torch.where(fast, x, 0.0)
    n = ((xm * HPI_INV).to(torch.int32) + 0x800000) >> 24
    r = _fma_dekker(n.to(torch.float64), -HPI, xm)
    q = n
    # |a| >= 120: the 4/pi product; the quadrant of the sign and the tables
    # also take the input's sign.  On a CPU only where an element needs it
    # (on a card no host read, so that a CUDA graph can capture the call).
    large = finite & ~fast
    if a.device.type != "cpu" or bool(large.any()):
        rl, nl = _reduce_large(torch.where(large, bits, 0))
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
    even = (n & 1) == 0
    cos = torch.where(even, c, s).to(torch.float32)
    sin = torch.where(even, s, c).to(torch.float32)
    tiny = top < 0x398  # |a| < 2^-12
    cos = torch.where(tiny, torch.ones_like(a), cos)
    sin = torch.where(tiny, a, sin)
    nan = a - a  # inf or NaN in: NaN out
    return torch.where(finite, cos, nan), torch.where(finite, sin, nan)


def cos_f32(a: torch.Tensor) -> torch.Tensor:
    """glibc's ``cosf`` of a float32 tensor."""
    return _sincos(a)[0]


def sin_f32(a: torch.Tensor) -> torch.Tensor:
    """glibc's ``sinf`` of a float32 tensor."""
    return _sincos(a)[1]


def cos_sin_plain(a: torch.Tensor):
    """``(cos_f32(a), sin_f32(a))``, one reduction for both."""
    return _sincos(a)


# ---------------------------------------------------------------------------
# Float64: glibc 2.36's sin, cos (dbl-64/s_sin.c, branred.c) and atan2
# (dbl-64/e_atan2.c), the x86-64 FMA build (libm.so.6's __sin_fma,
# __cos_fma, __atan2_fma, read with objdump -d; every vfmadd is an exact
# fused multiply-add here)
# ---------------------------------------------------------------------------

TABLES64 = os.path.join(kernels.CSRC, "trig64_tables.cuh")
# s_sin.c (usncs.h): the table step, pi/2 in two parts, the polynomials of
# do_sin / do_cos and of TAYLOR_SIN.
BIG = float.fromhex("0x1.8p45")
HP0 = float.fromhex("0x1.921fb54442d18p0")
HP1 = float.fromhex("0x1.1a62633145c07p-54")
SN3, SN5 = float.fromhex("-0x1.5555555555515p-3"), float.fromhex("0x1.11110e829872fp-7")
CS2, CS4, CS6 = 0.5, float.fromhex("-0x1.5555555555535p-5"), float.fromhex("0x1.6c16bedd9e239p-10")
TS = tuple(float.fromhex(h) for h in ("-0x1.5555555555555p-3", "0x1.1111111110ecep-7", "-0x1.a01a019db08b8p-13",
                                       "0x1.71de27b9a7ed9p-19", "-0x1.addffc2fcdf59p-26"))  # s1..s5
# reduce_sincos: 2/pi, the rounding constant, pi/2 in four parts.
HPINV, TOINT = float.fromhex("0x1.45f306dc9c883p-1"), float.fromhex("0x1.8p52")
MP1, MP2 = float.fromhex("0x1.921fb58p0"), float.fromhex("-0x1.dde973cp-27")
PP3, PP4 = float.fromhex("-0x1.cb3b398p-55"), float.fromhex("-0x1.d747f23e32ed7p-83")
# branred.c: 2^-600, 2^-24, its rounding constants and pi/2's second part.
TM600, TM24, BIG1 = 2.0 ** -600, 2.0 ** -24, float.fromhex("0x1.8p54")
MP2_BR = float.fromhex("-0x1.dde974p-27")
# e_atan2.c: pi and pi/2 with their low parts, the odd polynomial d3..d13.
OPI, OPI1 = float.fromhex("0x1.921fb54442d18p1"), float.fromhex("0x1.1a62633145c07p-53")
QPI, TQPI = float.fromhex("0x1.921fb54442d18p-1"), float.fromhex("0x1.2d97c7f3321d2p1")
D = tuple(float.fromhex(h) for h in ("-0x1.5555555555555p-2", "0x1.99999999997fdp-3", "-0x1.24924923f7603p-3",
                                      "0x1.c71c6e5129a3bp-4", "-0x1.7458022b13c25p-4", "0x1.375f08b31cbcep-4"))
EXP_MASK = 0x7FF0000000000000
EP, EM = 57 << 20, -(57 << 20)  # atan2's exponent-difference cut-offs (high words)


@lru_cache(maxsize=None)
def _libm_tables():
    """``{name: float64 array}`` of ``csrc/trig64_tables.cuh``."""
    with open(TABLES64) as f:
        text = f.read()
    out = {}
    for name, body in re.findall(r"const uint64_t (\w+)\[\d+\] = \{(.*?)\};", text, re.S):
        words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{16})ull", body)]
        out[name] = np.array(words, np.uint64).view(np.float64)
    return out


@lru_cache(maxsize=None)
def _table64(name: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_libm_tables()[name].copy()).to(device)


def _hi_words(x: torch.Tensor):
    """``(hi, lo)``: the high and low 32-bit words of float64 bits, as
    int64 (``hi`` signed, as glibc's ``int4``)."""
    bits = x.contiguous().view(torch.int64)
    return bits >> 32, bits & LOW32


def _taylor_sin(x, dx):
    """TAYLOR_SIN(x^2, x, dx): ``x + ((P(x^2) x - dx / 2) x^2 + dx)``."""
    xx = x * x
    poly = fma_f64(fma_f64(fma_f64(fma_f64(xx, TS[4], TS[3]), xx, TS[2]), xx, TS[1]), xx, TS[0])
    return x + fma_f64(xx, fma_f64(poly, x, -(0.5 * dx)), dx)


def _lookup(x: torch.Tensor):
    """The table point nearest ``|x|`` (a multiple of 1/128, by adding
    ``BIG``), the remainder and the four table values there."""
    ax = x.abs()
    u = ax + BIG
    k = (u.view(torch.int64) & LOW32) << 2
    tab = _table64("kSinCosTab", x.device)
    return ax - (u - BIG), tab[k], tab[k + 1], tab[k + 2], tab[k + 3]


def _do_sin(x, dx):
    """glibc's ``do_sin(x, dx)``: sin(x + dx), the Taylor form below 0.126."""
    dxs = torch.where(x > 0, dx, -dx)
    xr, sn, ssn, cs, ccs = _lookup(x)
    xx = xr * xr
    s = xr + fma_f64(xr * xx, fma_f64(xx, SN5, SN3), dxs)
    c = fma_f64(xr, dxs, xx * fma_f64(xx, fma_f64(xx, CS6, CS4), CS2))
    cor = fma_f64(s, cs, fma_f64(-c, sn, fma_f64(s, ccs, ssn)))
    return torch.where(x.abs() < 0.126, _taylor_sin(x, dx), torch.copysign(sn + cor, x))


def _do_cos(x, dx):
    """glibc's ``do_cos(x, dx)``: cos(x + dx)."""
    dxs = torch.where(x < 0, -dx, dx)
    xr, sn, ssn, cs, ccs = _lookup(x)
    xr = xr + dxs
    xx = xr * xr
    s = fma_f64(xr * xx, fma_f64(xx, SN5, SN3), xr)
    c = xx * fma_f64(xx, fma_f64(xx, CS6, CS4), CS2)
    return cs + fma_f64(-s, sn, fma_f64(-c, cs, fma_f64(-s, ssn, ccs)))


def _reduce_sincos(x):
    """glibc's ``reduce_sincos`` (|x| < 105414350): ``(a, da, n)`` with x =
    n pi/2 + a + da to 136 bits."""
    t = fma_f64(x, HPINV, TOINT)
    xn = t - TOINT
    n = t.view(torch.int64) & 3
    y = fma_f64(-xn, MP2, fma_f64(-xn, MP1, x))
    t2 = fma_f64(-xn, PP3, y)
    db = fma_f64(-xn, PP3, y - t2)
    b = fma_f64(-xn, PP4, t2)
    return b, db + fma_f64(-xn, PP4, t2 - b), n


def _branred_part(x1, toverp):
    """One half of ``__branred``: ``x1`` times 2/pi in six 24-bit pieces,
    the integer part summed apart; returns (sum, b, bb)."""
    hi, _ = _hi_words(x1)
    k = torch.clamp(((hi >> 20) & 2047) - 450, min=0) // 24
    gor = ((0x63F00000 - ((k * 24) << 20)) << 32).view(torch.float64)
    r = []
    for i in range(6):
        r.append(x1 * toverp[k + i] * gor)
        gor = gor * TM24
    total = torch.zeros_like(x1)
    for i in range(6):  # glibc's order: i = 0..5; each s is an integer, the sum exact
        s = (r[i] + TOINT) - TOINT
        total = total + s
        r[i] = r[i] - s
    t = torch.zeros_like(x1)
    for i in range(6):
        t = t + r[5 - i]
    bb = (((((r[0] - t) + r[1]) + r[2]) + r[3]) + r[4]) + r[5]
    s = (t + TOINT) - TOINT
    total = total + s
    t = t - s
    b = t + bb
    bb = (t - b) + bb
    s = (total + BIG1) - BIG1
    return total - s, b, bb


def _branred(x):
    """glibc's ``__branred`` (|x| >= 105414350, no fused operations: the
    generic build): ``(a, da, n)``."""
    toverp = _table64("kToverp", x.device)
    x = x * TM600
    xh, xl = _split(x)
    sum1, b1, bb1 = _branred_part(xh, toverp)
    sum2, b2, bb2 = _branred_part(xl, toverp)
    total = sum1 + sum2
    b = b1 + b2
    bb = torch.where(b1.abs() > b2.abs(), (b1 - b) + b2, (b2 - b) + b1)
    up, down = b > 0.5, b < -0.5
    b = torch.where(up, b - 1.0, torch.where(down, b + 1.0, b))
    total = torch.where(up, total + 1.0, torch.where(down, total - 1.0, total))
    s = b + ((bb + bb1) + bb2)
    t = ((b - s) + bb) + (bb1 + bb2)
    t1, t2 = _split(s)
    b = s * HP0
    bb = (((t1 * MP1 - b) + t1 * MP2_BR) + t2 * MP1) + ((t2 * MP2_BR + s * HP1) + t * HP0)
    s = b + bb
    return s, (b - s) + bb, total.to(torch.int64) & 3


def cos_sin_f64(a: torch.Tensor):
    """``(cos(a), sin(a))`` of a float64 tensor, glibc's ``cos`` and
    ``sin`` bit for bit, every range (the table forms below 2.426265, the
    136-bit reduction below 105414350, ``__branred`` above) and NaN for an
    infinity or a NaN.  Each element costs one ``do_sin`` and one ``do_cos``
    at the point its branch names; the reductions run only on the elements
    that need them."""
    hi, _ = _hi_words(a)
    k = hi & 0x7FFFFFFF
    finite = k < 0x7FF00000
    nan = a / a
    a = torch.where(finite, a, 0.0)  # keeps the table indices in range
    # |a| < 0.855469: sin = do_sin(a, 0), cos = do_cos(a, 0).  Below
    # 2.426265: sin = copysign(do_cos(pi/2 - |a|, HP1), a) and cos =
    # do_sin of the same angle in two parts.
    zero = torch.zeros_like(a)
    near = (k < 0x3FEB6000) | ~finite  # a non-finite a (now 0) takes the first band
    t = HP0 - a.abs()
    ha = t + HP1
    sin_x = torch.where(near, a, ha)  # do_sin's argument for (sin, cos) in each case
    sin_dx = torch.where(near, zero, (t - ha) + HP1)
    cos_x = torch.where(near, a, t)
    cos_dx = torch.where(near, zero, torch.full_like(a, HP1))
    swap = ~near  # do_sin gives the cosine, do_cos the sine
    neg_s = torch.zeros_like(near)
    neg_c = torch.zeros_like(near)
    far = (k >= 0x400368FD) & (k < 0x7FF00000)
    if bool(far.any()):
        idx = torch.nonzero(far)[:, 0]
        xf = a[idx]
        mid = k[idx] < 0x419921FB
        ra, rda, rn = _reduce_sincos(torch.where(mid, xf, 0.0))
        if bool((~mid).any()):
            big_idx = torch.nonzero(~mid)[:, 0]
            ba, bda, bn = _branred(xf[big_idx])
            ra, rda, rn = ra.index_put((big_idx,), ba), rda.index_put((big_idx,), bda), rn.index_put((big_idx,), bn)
        # n even: sin = do_sin, cos = do_cos; n odd: swapped; the sine is
        # negated where n & 2, the cosine where (n + 1) & 2.
        sin_x, cos_x = sin_x.index_put((idx,), ra), cos_x.index_put((idx,), ra)
        sin_dx, cos_dx = sin_dx.index_put((idx,), rda), cos_dx.index_put((idx,), rda)
        swap = swap.index_put((idx,), (rn & 1) == 1)
        neg_s = neg_s.index_put((idx,), (rn & 2) != 0)
        neg_c = neg_c.index_put((idx,), ((rn + 1) & 2) != 0)
    ds, dc = _do_sin(sin_x, sin_dx), _do_cos(cos_x, cos_dx)
    s = torch.where(swap, dc, ds)
    c = torch.where(swap, ds, dc)
    s = torch.where(near | far, s, torch.copysign(s, a))  # the middle band: copysign(do_cos, a)
    s = torch.where(neg_s, -s, s)
    c = torch.where(neg_c, -c, c)
    s = torch.where(k < 0x3E500000, a, torch.where(finite, s, nan))
    c = torch.where(k < 0x3E400000, 1.0, torch.where(finite, c, nan))
    return c, s


def cos_f64(a: torch.Tensor) -> torch.Tensor:
    """glibc's ``cos`` of a float64 tensor."""
    return cos_sin_f64(a)[0]


def sin_f64(a: torch.Tensor) -> torch.Tensor:
    """glibc's ``sin`` of a float64 tensor."""
    return cos_sin_f64(a)[1]


def _flush64(v: torch.Tensor) -> torch.Tensor:
    """A subnormal float64 as the zero of its sign."""
    return torch.where((v.view(torch.int64) & EXP_MASK) == 0, v * 0.0, v)


def atan2_f64(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's ``atan2(y, x)`` of float64 tensors (broadcast), as the
    reference runs it: XLA's CPU code sets flush-to-zero and
    denormals-are-zero, so every floating-point operation and comparison
    of glibc's reads a subnormal as the zero of its sign and flushes a
    subnormal result (the quotient of the extreme-ratio case), while its
    tests of the bits still see the subnormal.  Every special case
    included; a NaN in gives a NaN out."""
    y, x = torch.broadcast_tensors(y, x)
    y, x = y.contiguous(), x.contiguous()
    ux, dx = _hi_words(x)
    uy, dy = _hi_words(y)
    xf, yf = _flush64(x), _flush64(y)
    ax, ay = xf.abs(), yf.abs()
    # Extreme magnitudes are scaled by 2^+-500 together.
    up = (ax < 2.0 ** -500) | (ay < 2.0 ** -500)
    ax, ay = torch.where(up, ax * 2.0 ** 500, ax), torch.where(up, ay * 2.0 ** 500, ay)
    down = (ax > 2.0 ** 500) | (ay > 2.0 ** 500)
    ax, ay = torch.where(down, ax * 2.0 ** -500, ax), torch.where(down, ay * 2.0 ** -500, ay)
    # u = min / max and its correction du (EMULV with a fused product).
    lo_y = ay < ax
    num, den = torch.where(lo_y, ay, ax), torch.where(lo_y, ax, ay)
    u = num / den
    v = den * u
    du = ((num - v) - fma_f64(den, u, -v)) / den
    # (i) x > 0, ay < ax: atan(u); (ii) x > 0, ay >= ax: pi/2 - atan(u);
    # (iii) x <= 0, ay > ax: pi/2 + atan(u); (iv) x <= 0, ay <= ax: pi -
    # atan(u).
    pos = xf > 0
    case1 = pos & lo_y
    case4 = ~pos & (ay <= ax)
    one = torch.ones_like(u)
    sigma = torch.where(~pos & ~case4, one, -one)
    base = torch.where(case4, OPI, one * HP0)
    base1 = torch.where(case4, OPI1, one * HP1)
    # u < 1/16: the odd polynomial.
    vv = u * u
    poly = fma_f64(fma_f64(fma_f64(fma_f64(fma_f64(vv, D[5], D[4]), vv, D[3]), vv, D[2]), vv, D[1]), vv, D[0])
    uv = u * vv
    z1 = u + fma_f64(uv, poly, du)
    t2 = base + sigma * u
    cor = (base - t2) + sigma * u
    zs = t2 + (((base1 + cor) + sigma * du) + sigma * (uv * poly))
    small = torch.where(case1, z1, zs)
    # u >= 1/16: the table point nearest u (cij, a step of 1/256).
    cij = _table64("kAtanCij", x.device)
    u_tab = torch.where(u >= 0.0625, u, 0.0625).clamp(max=1.0)  # NaN (a special value) to row 0
    i = ((u_tab * 256.0 + float(2 ** 52)) - float(2 ** 52)).to(torch.int64) - 16
    c = [cij[i * 7 + j] for j in range(7)]
    t3 = u - c[0]
    w = t3 + du
    dw = torch.where(t3.abs() > du.abs(), (t3 - w) + du, (du - w) + t3)
    q = fma_f64(fma_f64(fma_f64(c[6], w, c[5]), w, c[4]), w, c[3])
    tz1 = fma_f64(w, c[2], fma_f64(dw, c[2], (w * w) * q)) + c[1]
    tzs = (base + sigma * c[1]) + fma_f64(sigma * w, fma_f64(q, w, c[2]), base1)
    table = torch.where(case1, tz1, tzs)
    out = torch.copysign(torch.where(u < 0.0625, small, table), y)
    # Exponent differences beyond 57 binades.
    de = (uy & 0x7FF00000) - (ux & 0x7FF00000)
    sign_y = torch.where(yf > 0, one, -one)
    out = torch.where(de <= EM, torch.where(pos, torch.copysign(_flush64(yf.abs() / xf.abs()), y), sign_y * OPI),
                      out)
    out = torch.where(de >= EP, sign_y * HP0, out)
    # The special values, lowest precedence first.
    neg_y = uy < 0
    half = torch.where(neg_y, -HP0, one * HP0)
    y_inf = (uy & 0x7FFFFFFF) == 0x7FF00000
    y_inf = y_inf & (dy == 0)
    out = torch.where(y_inf, half, out)
    x_inf = ((ux & 0x7FFFFFFF) == 0x7FF00000) & (dx == 0)
    zero = torch.zeros_like(u)
    inf_pos = torch.where(y_inf, torch.where(neg_y, -QPI, one * QPI), torch.where(neg_y, -zero, zero))
    inf_neg = torch.where(y_inf, torch.where(neg_y, -TQPI, one * TQPI), torch.where(neg_y, -OPI, one * OPI))
    out = torch.where(x_inf, torch.where(ux < 0, inf_neg, inf_pos), out)
    out = torch.where(xf == 0, half, out)
    y_zero = ((uy & 0x7FFFFFFF) == 0) & (dy == 0)
    out = torch.where(y_zero, torch.where(ux < 0, torch.where(neg_y, -OPI, one * OPI), torch.where(neg_y, -zero, zero)),
                      out)
    out = torch.where(torch.isnan(y), y + y, out)
    return torch.where(torch.isnan(x), x + y, out)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cpu":
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))


# A CPU call on at most SMALL elements is evaluated element by element by
# the C library's own functions where they are the ones written out here:
# the written-out forms cost hundreds of tensor operations a call whatever
# its size (1.2 to 1.6 ms in float32, 3.1 to 5.6 ms in float64 on one
# thread), the C library under 2 us an element (scripts/cpu_costs.py), and
# the so(3) maps of the pose optimizers' plain versions call them once a
# step on one or two elements (tens of thousands of calls in the tier-1
# tests).  256 lies below the size where the two costs meet in either
# dtype.
SMALL = 256
_F64_MIN, _F32_MIN = 2.0 ** -1022, 2.0 ** -126


def _libm_sample():
    """Arguments the C library is checked on: 4,096 draws a function, the
    branch bounds of glibc's code and its special values (no subnormal
    atan2 operand: those calls take the written-out form)."""
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.standard_normal(4096) * np.exp(rng.uniform(-30, 30, 4096)), rng.uniform(-2, 2, 4096),
                        [0.0, -0.0, 1e-310, 2.0 ** -27, 0.126, 0.85546875, 2.4262657165527344, 120.0, 105414350.0,
                         1e22, 1e300, np.inf, -np.inf, np.nan]])
    y = rng.standard_normal(4096) * np.exp(rng.uniform(-40, 40, 4096))
    x = rng.standard_normal(4096) * np.exp(rng.uniform(-40, 40, 4096))
    special = np.array([0.0, -0.0, 1.0, -1.0, 2.0 ** 500, 1e300, np.inf, -np.inf, np.nan])
    sy, sx = np.meshgrid(special, special, indexing="ij")
    return a, np.concatenate([y, sy.ravel()]), np.concatenate([x, sx.ravel()])


@lru_cache(maxsize=None)
def _libm():
    """The C library's ``atan2``, ``cos``, ``sin``, ``fma`` and their float
    versions through ctypes, or None unless each gives this module's
    written-out function's bits (a NaN by position) on
    :func:`_libm_sample`, in float64 and in float32: glibc 2.36's x86-64
    build does; another C library keeps the written-out forms."""
    import ctypes.util

    path = ctypes.util.find_library("m")
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    for name, ct in (("atan2", ctypes.c_double), ("cos", ctypes.c_double), ("sin", ctypes.c_double),
                     ("fma", ctypes.c_double), ("atan2f", ctypes.c_float), ("cosf", ctypes.c_float),
                     ("sinf", ctypes.c_float), ("fmaf", ctypes.c_float)):
        fn = getattr(lib, name)
        fn.restype = ct
        fn.argtypes = [ct] * (2 if name.startswith("atan2") else 3 if name.startswith("fma") else 1)
    a, y, x = _libm_sample()
    for dt in (torch.float64, torch.float32):
        ta, ty, tx = (torch.as_tensor(v).to(dt) for v in (a, y, x))
        ok = (ty.abs() >= (_F64_MIN if dt == torch.float64 else _F32_MIN)) | (ty == 0)
        ok &= (tx.abs() >= (_F64_MIN if dt == torch.float64 else _F32_MIN)) | (tx == 0)
        ty, tx = ty[ok], tx[ok]
        fy, fx, fa = ty[:2048], tx[:2048], ta[:2048]
        got = (*_libm_cos_sin(lib, ta), _libm_atan2(lib, ty, tx), _libm_fma(lib, fy, fx, fa))
        want = (*(cos_sin_plain(ta) if dt == torch.float32 else cos_sin_f64(ta)),
                atan2_f32(ty, tx) if dt == torch.float32 else atan2_f64(ty, tx),
                fma_f32(fy, fx, fa) if dt == torch.float32 else fma_f64(fy, fx, fa))
        bits = torch.int32 if dt == torch.float32 else torch.int64
        for g, w in zip(got, want):
            nan = torch.isnan(w)
            if not (torch.equal(torch.isnan(g), nan) and torch.equal(g.view(bits)[~nan], w.view(bits)[~nan])):
                return None
    return lib


def _libm_cos_sin(lib, a: torch.Tensor):
    cos, sin = (lib.cosf, lib.sinf) if a.dtype == torch.float32 else (lib.cos, lib.sin)
    vals = a.reshape(-1).tolist()
    return (torch.tensor([cos(v) for v in vals], dtype=a.dtype).reshape(a.shape),
            torch.tensor([sin(v) for v in vals], dtype=a.dtype).reshape(a.shape))


def _libm_fma(lib, a: torch.Tensor, b, c):
    a, b, c = torch.broadcast_tensors(a, torch.as_tensor(b, dtype=a.dtype), torch.as_tensor(c, dtype=a.dtype))
    fn = lib.fmaf if a.dtype == torch.float32 else lib.fma
    return torch.tensor([fn(x, y, z) for x, y, z in zip(a.reshape(-1).tolist(), b.reshape(-1).tolist(),
                                                        c.reshape(-1).tolist())], dtype=a.dtype).reshape(a.shape)


def _libm_atan2(lib, y: torch.Tensor, x: torch.Tensor):
    fn = lib.atan2f if y.dtype == torch.float32 else lib.atan2
    return torch.tensor([fn(p, q) for p, q in zip(y.reshape(-1).tolist(), x.reshape(-1).tolist())],
                        dtype=y.dtype).reshape(y.shape)


def _small_cpu(*tensors) -> bool:
    return tensors[0].device.type == "cpu" and tensors[0].numel() <= SMALL


def atan2_plain(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """:func:`atan2_f32` or :func:`atan2_f64` by dtype.  A small CPU call
    without a subnormal operand or result takes the C library's atan2
    where :func:`_libm` found it to be the same function (XLA flushes
    subnormals there, the C library does not)."""
    y, x = torch.broadcast_tensors(y, x)
    if _small_cpu(y) and _libm() is not None:
        tiny = _F32_MIN if y.dtype == torch.float32 else _F64_MIN
        out = _libm_atan2(_libm(), y, x)
        if not bool(((y.abs() < tiny) & (y != 0)).any() | ((x.abs() < tiny) & (x != 0)).any()
                    | ((out.abs() < tiny) & (out != 0)).any()):
            return out
    return atan2_f32(y, x) if y.dtype == torch.float32 else atan2_f64(y, x)


def cos_sin_by_dtype(a: torch.Tensor):
    """:func:`cos_sin_plain` (float32) or :func:`cos_sin_f64`; a small CPU
    call takes the C library's cos and sin where :func:`_libm` found them
    to be the same functions."""
    if _small_cpu(a) and _libm() is not None:
        return _libm_cos_sin(_libm(), a)
    return cos_sin_plain(a) if a.dtype == torch.float32 else cos_sin_f64(a)


# ---------------------------------------------------------------------------
# The wrappers of csrc/trig_probe.cu
# ---------------------------------------------------------------------------

_VOID, _I64 = ctypes.c_void_p, ctypes.c_int64


def _checked(name: str, *tensors, dtypes=(torch.float32,)) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if len({t.dtype for t in tensors}) != 1 or tensors[0].dtype not in dtypes:
        raise ValueError(f"{name}: one dtype of {dtypes} only, got {[t.dtype for t in tensors]}")
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


def _cos_sin(a: torch.Tensor):
    dev = a.device
    if dev.type == "cpu":
        return cos_sin_by_dtype(a)
    a = a.contiguous()
    co, si = torch.empty_like(a), torch.empty_like(a)
    symbol = "cv_trig_cos_sin" if a.dtype == torch.float32 else "cv_trig_cos_sin_f64"
    _launch(symbol, [_VOID] * 3 + [_I64, _VOID], a.data_ptr(), co.data_ptr(), si.data_ptr(), a.numel(),
            kernels.current_stream(dev))
    cos_sin.launches += 1
    return co, si


def cos_sin(a: torch.Tensor):
    """``(cos(a), sin(a))``, glibc's: :func:`cos_sin_plain` of float32 (the
    describe's, ``cosf``/``sinf``) or :func:`cos_sin_f64` of float64 on a
    CPU tensor; on a CUDA tensor one launch of ``csrc/trig_probe.cu``
    (``cv_trig_cos_sin`` or ``cv_trig_cos_sin_f64``).  Differentiable
    (:class:`_CosSin`)."""
    _checked("cos_sin", a, dtypes=(torch.float32, torch.float64))
    return _CosSin.apply(a) if _differentiable(a) else _cos_sin(a)


cos_sin.launches = 0


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    dev = y.device
    if dev.type == "cpu":
        return atan2_plain(y, x)
    y, x = (t.contiguous() for t in torch.broadcast_tensors(y, x))
    out = torch.empty_like(y)
    symbol = "cv_trig_atan2_f32" if y.dtype == torch.float32 else "cv_trig_atan2_f64"
    _launch(symbol, [_VOID] * 3 + [_I64, _VOID], y.data_ptr(), x.data_ptr(), out.data_ptr(), y.numel(),
            kernels.current_stream(dev))
    atan2.launches += 1
    return out


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's ``atan2(y, x)`` (broadcast): :func:`atan2_plain` on a CPU
    tensor; on a CUDA tensor one launch of ``csrc/trig_probe.cu``
    (``cv_trig_atan2_f32`` or ``cv_trig_atan2_f64``).  Differentiable
    (:class:`_Atan2`)."""
    _checked("atan2", y, x, dtypes=(torch.float32, torch.float64))
    y, x = torch.broadcast_tensors(y, x)
    return _Atan2.apply(y, x) if _differentiable(y, x) else _atan2(y, x)


atan2.launches = 0


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The IEEE (correctly rounded) square root that XLA's CPU code and the
    card compute.  PyTorch's CPU ``sqrt`` of this build is not: about 0.8%
    of float32 and float64 draws come out an ulp off
    (``tests/test_torch_trig64.py::test_torch_cpu_sqrt_is_not_correctly_rounded``).
    On a CPU tensor NumPy's (the hardware's instruction), on a CUDA tensor
    torch's.  Differentiable (:class:`_Sqrt`)."""
    return _Sqrt.apply(x) if _differentiable(x) else _sqrt(x)


# ---------------------------------------------------------------------------
# Derivatives: the bits above come from integer tests, tables and host
# calls, so autograd and torch.func see each function whole, with its
# analytic derivative (rounded as torch rounds it, not as jax.jacfwd of the
# reference does).  Each is elementwise, so a vmap is one call on the
# batched tensor.
# ---------------------------------------------------------------------------


def _differentiable(*tensors) -> bool:
    """Whether autograd or a ``torch.func`` transform may ask for a
    derivative of a call on ``tensors``: only then does the call go through
    its autograd function, whose dispatch costs about 30 us of host time (a
    graph-BA round calls the trig twice)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return True
    if getattr(torch.autograd.forward_ad, "_current_level", 0) >= 0:  # inside a dual_level
        return True
    wrapped = getattr(torch._C._functorch, "is_functorch_wrapped_tensor", None)
    return wrapped is None or any(wrapped(t) for t in tensors)


class _CosSin(torch.autograd.Function):
    """d cos = -sin da, d sin = cos da."""

    @staticmethod
    def forward(a):
        return _cos_sin(a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*output)
        ctx.save_for_forward(*output)

    @staticmethod
    def backward(ctx, g_cos, g_sin):
        c, s = ctx.saved_tensors
        return g_sin * c - g_cos * s

    @staticmethod
    def jvp(ctx, t):
        c, s = ctx.saved_tensors
        return -s * t, c * t

    @staticmethod
    def vmap(info, in_dims, a):
        return _CosSin.apply(a), (in_dims[0], in_dims[0])


class _Atan2(torch.autograd.Function):
    """d atan2(y, x) = (x dy - y dx) / (x^2 + y^2), of inputs of one shape."""

    @staticmethod
    def forward(y, x):
        return _atan2(y, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, g):
        y, x = ctx.saved_tensors
        r = x * x + y * y
        return g * x / r, -g * y / r

    @staticmethod
    def jvp(ctx, ty, tx):
        y, x = ctx.saved_tensors
        d = torch.zeros_like(x)
        if ty is not None:
            d = d + x * ty
        if tx is not None:
            d = d - y * tx
        return d / (x * x + y * y)

    @staticmethod
    def vmap(info, in_dims, y, x):
        y, x = (t if d is None else t.movedim(d, 0) for t, d in zip((y, x), in_dims))
        return _Atan2.apply(*torch.broadcast_tensors(y, x)), 0


class _Sqrt(torch.autograd.Function):
    """d sqrt(x) = dx / (2 sqrt(x))."""

    @staticmethod
    def forward(x):
        return _sqrt(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)
        ctx.save_for_forward(output)

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g / (2.0 * out)

    @staticmethod
    def jvp(ctx, t):
        (out,) = ctx.saved_tensors
        return t / (2.0 * out)

    @staticmethod
    def vmap(info, in_dims, x):
        return _Sqrt.apply(x), in_dims[0]


def empty_launch(dev: torch.device) -> None:
    """One launch of an empty kernel of ``csrc/trig_probe.cu``: the floor
    that a trig call's time is read against."""
    _launch("cv_trig_empty", [_VOID], kernels.current_stream(dev))
