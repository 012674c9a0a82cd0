"""cv_tpu_torch.ops.trig against cv_tpu's float32 trigonometry.

``cv_tpu``'s ``jnp.arctan2``, ``jnp.cos`` and ``jnp.sin`` of float32 run,
on a CPU, the C library's ``atan2f``, ``cosf`` and ``sinf``; the port's
plain versions write those functions out in elementwise operations that
round once.  They are held bitwise here (a NaN only by position): on
seeded draws, on bands around each branch's bounds and on tables of special
values; and an element's bits are held independent of its place in a
batch.  The exact fused multiply-add that the cosine and sine need
(``trig.fma_f64``) is held to exact rational arithmetic.  The kernel,
``csrc/trig_probe.cu``, runs only on a card: the ``cuda`` tests hold it to
the plain versions there and skip here.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.akaze import descriptors as jdesc
from cv_tpu_torch.ops import trig

F32 = np.float32


def _same_bits(got, want):
    """Equal bits, where a NaN only needs a NaN in the same place."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bad = (got.view(np.uint32) != want.view(np.uint32)) & ~nan
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} differ, first at {np.flatnonzero(bad)[:5]}"


def _draws(seed, n):
    """Normal x e^U(-5, 5) pairs: every quotient range and both signs."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal(n) * np.exp(rng.uniform(-5, 5, n))).astype(F32)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-5, 5, n))).astype(F32)
    return y, x


def _bands(seed, n=20_000):
    """Pairs whose |y/x| lies near 2^25 (__atanf's saturation), around
    2^60 and 2^-60 (atan2f's quotient cut-offs, x of both signs), and on
    each side of __atanf's reduction bounds 7/16, 11/16, 19/16, 39/16."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-3, 3, n))).astype(F32)
    sign = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
    out = [(x * sign * 2.0 ** rng.uniform(lo, hi, n)).astype(F32) for lo, hi in ((24, 26), (58, 62), (-62, -58))]
    for bound in (7 / 16, 11 / 16, 19 / 16, 39 / 16):
        out.append((x * sign * bound * (1 + rng.uniform(-1e-6, 1e-6, n))).astype(F32))
    return np.concatenate(out), np.tile(x, len(out))


def _special_values():
    tiny = np.array([1, 2, 0x00800000, 0x0DA24260, 0x31000000, 0x30FFFFFF], np.uint32).view(F32)
    mags = np.concatenate([[0.0, 1.0, 0.5, 2.0, 2.0 ** 25, 2.0 ** -29, 1e30, 3.4028235e38, np.inf], tiny]).astype(F32)
    vals = np.concatenate([mags, -mags, [np.nan]]).astype(F32)
    y, x = np.meshgrid(vals, vals, indexing="ij")
    return y.ravel(), x.ravel()


ATAN2_CASES = {
    "draws": lambda: _draws(0, 1_000_000),
    "bands": lambda: _bands(1),
    "special": _special_values,
}


@pytest.mark.parametrize("case", sorted(ATAN2_CASES))
def test_atan2_f32_bitwise_to_jnp(case):
    y, x = ATAN2_CASES[case]()
    got = trig.atan2_f32(torch.as_tensor(y), torch.as_tensor(x)).numpy()
    _same_bits(got, np.asarray(jnp.arctan2(jnp.asarray(y), jnp.asarray(x))))


def test_atan2_f32_at_x_one():
    """The ``x == 1`` branch calls __atanf(y) directly."""
    y = np.concatenate([_draws(2, 10_000)[0], [0.0, -0.0, np.inf, -np.inf, np.nan]]).astype(F32)
    x = np.ones_like(y)
    _same_bits(trig.atan2_f32(torch.as_tensor(y), torch.as_tensor(x)).numpy(),
               np.asarray(jnp.arctan2(jnp.asarray(y), jnp.asarray(x))))


@pytest.mark.parametrize("case", sorted(ATAN2_CASES))
def test_angle_cv_bitwise_to_cv_tpu(case):
    """The OpenCV angle in [0, 2pi), on a CPU tensor the plain version."""
    y, x = ATAN2_CASES[case]()
    before = trig.angle_cv.launches
    got = trig.angle_cv(torch.as_tensor(y), torch.as_tensor(x)).numpy()
    assert trig.angle_cv.launches == before
    _same_bits(got, np.asarray(jdesc._atan2_cv(jnp.asarray(y), jnp.asarray(x))))
    finite = ~np.isnan(got)
    assert ((got[finite] >= 0) & (got[finite] < F32(trig.TWO_PI))).all()


def _near(values, span):
    """Every float32 within ``span`` steps of each value."""
    base = np.atleast_1d(np.asarray(values, F32)).view(np.int32)[:, None]
    return (base + np.arange(-span, span + 1, dtype=np.int32)[None, :]).ravel().view(F32)


COS_SIN_CASES = {
    "zero_two_pi": lambda: np.random.default_rng(3).uniform(0, 2 * np.pi, 1_000_000).astype(F32),
    "minus_seven_seven": lambda: np.random.default_rng(4).uniform(-7, 7, 1_000_000).astype(F32),
    # Around every multiple of pi/2 below 120, where the reduction cancels
    # most of the argument: the fused multiply-add's single rounding shows.
    "near_multiples": lambda: np.concatenate([_near(k * np.pi / 2, 1500) for k in range(-76, 77) if k]),
    # The branch bounds: 2^-12 (tiny), 0.75 (the polynomial alone), 120
    # (the 4/pi product), and large arguments.
    "bounds": lambda: np.concatenate([
        _near([2.0 ** -12, -(2.0 ** -12), 0.75, -0.75, 120.0, -120.0], 3000),
        np.random.default_rng(5).uniform(-1e6, 1e6, 200_000).astype(F32),
        np.random.default_rng(6).uniform(-3e38, 3e38, 50_000).astype(F32),
    ]),
    "special": lambda: np.array([0.0, -0.0, 1e-45, -1e-45, 1.1754944e-38, np.inf, -np.inf, np.nan,
                                 3.4028235e38, -3.4028235e38], F32),
}


@pytest.mark.parametrize("fn", ["cos", "sin"])
@pytest.mark.parametrize("case", sorted(COS_SIN_CASES))
def test_cos_sin_f32_bitwise_to_jnp(case, fn):
    a = COS_SIN_CASES[case]()
    got = getattr(trig, f"{fn}_f32")(torch.as_tensor(a)).numpy()
    _same_bits(got, np.asarray(getattr(jnp, fn)(jnp.asarray(a))))


@pytest.mark.slow
@pytest.mark.parametrize("fn", ["cos", "sin"])
@pytest.mark.parametrize("sign", ["+", "-"])
def test_cos_sin_f32_every_float_below_128(sign, fn):
    """Every float32 of one sign with |a| < 128 (the bits below
    0x43000000: the polynomial alone, the fast reduction and the 4/pi
    product's first octave), in chunks of 2^23 (~15 min a case on three
    threads)."""
    step, top = 1 << 23, 0x43000000
    for start in range(0, top, step):
        bits = np.arange(start, min(start + step, top), dtype=np.uint32) | (0x80000000 if sign == "-" else 0)
        a = bits.view(F32)
        got = getattr(trig, f"{fn}_f32")(torch.as_tensor(a)).numpy()
        _same_bits(got, np.asarray(getattr(jnp, fn)(jnp.asarray(a))))


def test_cos_sin_wrapper_on_the_cpu():
    """``cos_sin`` on a CPU tensor: the plain pair, no launch."""
    a = torch.as_tensor(np.random.default_rng(7).uniform(0, 2 * np.pi, 4096).astype(F32))
    before = trig.cos_sin.launches
    co, si = trig.cos_sin(a)
    assert trig.cos_sin.launches == before
    _same_bits(co.numpy(), np.asarray(jnp.cos(jnp.asarray(a.numpy()))))
    _same_bits(si.numpy(), np.asarray(jnp.sin(jnp.asarray(a.numpy()))))


@pytest.mark.parametrize("fn", ["atan2", "angle", "cos", "sin"])
def test_bits_independent_of_batch_position(fn):
    """The same 1003 elements one at a time, as one batch, shuffled, and at
    an odd offset inside a longer batch give the same bits."""
    y, x = _draws(8, 1003)
    call = {
        "atan2": lambda yy, xx: trig.atan2_f32(yy, xx),
        "angle": lambda yy, xx: trig.angle_cv_plain(yy, xx),
        "cos": lambda yy, xx: trig.cos_f32(yy),
        "sin": lambda yy, xx: trig.sin_f32(yy),
    }[fn]
    ty, tx = torch.as_tensor(y), torch.as_tensor(x)
    batch = call(ty, tx).numpy()
    single = np.concatenate([call(ty[i:i + 1], tx[i:i + 1]).numpy() for i in range(len(y))])
    perm = np.random.default_rng(9).permutation(len(y))
    shuffled = np.empty_like(batch)
    shuffled[perm] = call(ty[perm], tx[perm]).numpy()
    pad = torch.as_tensor(_draws(10, 7)[0])
    offset = call(torch.cat([pad, ty]), torch.cat([pad, tx])).numpy()[7:]
    for other in (single, shuffled, offset):
        _same_bits(other, batch)


def _fma_exact(a, b, c):
    """``a * b + c`` in exact rationals, rounded once to float64."""
    return np.array([float(Fraction(p) * Fraction(q) + Fraction(r)) for p, q, r in zip(a, b, c)])


@pytest.mark.parametrize("case", ["random", "cancelling", "reduction"])
def test_fma_rounds_once(case):
    rng = np.random.default_rng({"random": 11, "cancelling": 12, "reduction": 13}[case])
    n = 4000
    if case == "random":
        a, b, c = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n)) for _ in range(3))
    elif case == "cancelling":  # c near -a b: the product's low half decides
        a, b = rng.standard_normal(n), rng.standard_normal(n)
        c = -(a * b) * (1 + rng.uniform(-1e-12, 1e-12, n))
    else:  # the cosine's reduction: n, -pi/2, and a float argument near n pi/2
        q = rng.integers(-76, 77, n).astype(np.float64)
        a, b = q, np.full(n, -trig.HPI)
        c = (q * np.pi / 2).astype(F32).astype(np.float64)
    got = trig.fma_f64(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), _fma_exact(a, b, c).view(np.uint64))


def test_wrappers_reject_other_dtypes():
    """``angle_cv`` takes float32 only; ``cos_sin`` float32 and float64
    (``tests/test_torch_trig64.py``), nothing else."""
    with pytest.raises(ValueError):
        trig.angle_cv(torch.zeros(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError):
        trig.cos_sin(torch.zeros(3, dtype=torch.float16))


# ---------------------------------------------------------------------------
# The kernel, on a card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/trig_probe.cu runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1,), (4096,), (517, 109), (300_001,)])
def test_cuda_trig_kernel_bitwise_to_plain(shape):
    dev = _cuda()
    n = int(np.prod(shape))
    y, x = (torch.as_tensor(v.reshape(shape), device=dev) for v in _draws(14, n))
    before = (trig.angle_cv.launches, trig.cos_sin.launches)
    ang = trig.angle_cv(y, x)
    co, si = trig.cos_sin(ang)
    torch.cuda.synchronize()
    assert (trig.angle_cv.launches, trig.cos_sin.launches) == (before[0] + 1, before[1] + 1)
    _same_bits(ang.cpu().numpy(), trig.angle_cv_plain(y, x).cpu().numpy())
    _same_bits(co.cpu().numpy(), trig.cos_f32(ang).cpu().numpy())
    _same_bits(si.cpu().numpy(), trig.sin_f32(ang).cpu().numpy())
