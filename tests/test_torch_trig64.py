"""cv_tpu_torch.ops.trig's float64 atan2, cosine and sine against cv_tpu's.

``cv_tpu``'s ``jnp.arctan2``, ``jnp.cos`` and ``jnp.sin`` of float64 run,
on a CPU, glibc 2.36's double ``atan2``, ``cos`` and ``sin`` (the x86-64
build with fused multiply-adds), atan2 under XLA's flush-to-zero and
denormals-are-zero mode.  The port's plain versions write those functions
out in elementwise operations that round once; they are held bitwise here
(a NaN only by position) on seeded draws, on bands around every branch
bound of glibc's code, near multiples of pi/2 and on special values, and
an element's bits are held independent of its place in a batch.  The
exact float64 fused multiply-add (``trig.fma_f64``) is held to exact
rational arithmetic, the tables of ``csrc/trig64_tables.cuh`` to the
bytes of the C library, and ``trig.sqrt`` to the correctly rounded square
root.  The kernels (``csrc/trig_probe.cu``'s float64 and float32 atan2 and
float64 cos/sin) run only on a card: the ``cuda`` test skips here.
"""

import ctypes.util
import struct
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu_torch.ops import trig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's tensor work on one thread: parallel test workers share
    the machine's cores, and torch's threads would spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

F64 = np.float64


def _same_bits(got, want):
    """Equal bits, where a NaN only needs a NaN in the same place."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float64
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bad = (got.view(np.uint64) != want.view(np.uint64)) & ~nan
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} differ, first at {np.flatnonzero(bad)[:5]}"


def _near(values, span):
    """Every double within ``span`` steps of each value."""
    base = np.atleast_1d(np.asarray(values, F64)).view(np.int64)[:, None]
    return (base + np.arange(-span, span + 1, dtype=np.int64)[None, :]).ravel().view(F64)


SPECIAL = np.array([0.0, 5e-324, 1e-310, 2.0 ** -1022, 2.0 ** -1000, 2.0 ** -600, 2.0 ** -501, 2.0 ** -500, 1e-200,
                    2.0 ** -27, 2.0 ** -26, 1e-9, 0.5, 1.0, 2.0, 1e22, 2.0 ** 500, 2.0 ** 501, 1e300,
                    np.finfo(F64).max, np.inf])
SPECIAL = np.concatenate([SPECIAL, -SPECIAL, [np.nan, -np.nan]])


def _pairs(seed, n):
    """Normal x e^U(-40, 40) pairs: every quotient range and both signs."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(n) * np.exp(rng.uniform(-40, 40, n)) for _ in range(2))


def _atan2_bands(seed, n=20_000):
    """Pairs around atan2's branch bounds: |y/x| near 1/16 (the table's
    start, both orders), 1 (y against x), the table's 1/256 steps, 2^+-57
    binades of exponent difference (the extreme-ratio cut-offs), and
    magnitudes around 2^+-500 (the scaling), x of both signs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp(rng.uniform(-5, 5, n))
    sx = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
    ys, xs = [], []
    for ratio in (1 / 16, 16.0, 1.0, 2.0 ** 57, 2.0 ** -57, 2.0 ** 56, 2.0 ** -56, 2.0 ** 58, 2.0 ** -58):
        ys.append(x * ratio * (1 + rng.uniform(-1e-9, 1e-9, n)))
        xs.append(x * sx)
    steps = (rng.integers(16, 257, n) + rng.choice([-0.5, 0.5], n) * (1 + rng.uniform(-1e-12, 1e-12, n))) / 256
    ys.append(x * steps)
    xs.append(x * sx)
    for scale in (2.0 ** 500, 2.0 ** -500, 2.0 ** 505, 2.0 ** -505):
        ys.append(rng.standard_normal(n) * scale)
        xs.append(rng.standard_normal(n) * scale * np.exp(rng.uniform(-3, 3, n)))
    return np.concatenate(ys), np.concatenate(xs)


def _atan2_special():
    y, x = np.meshgrid(SPECIAL, SPECIAL, indexing="ij")
    return y.ravel(), x.ravel()


ATAN2_CASES = {
    "draws": lambda: _pairs(0, 1_000_000),
    "unit": lambda: tuple(np.random.default_rng(1).uniform(-1, 1, (2, 500_000))),
    "bands": lambda: _atan2_bands(2),
    "special": _atan2_special,
}


@pytest.mark.parametrize("case", sorted(ATAN2_CASES))
def test_atan2_f64_bitwise_to_jnp(case):
    y, x = ATAN2_CASES[case]()
    got = trig.atan2_f64(torch.as_tensor(y), torch.as_tensor(x)).numpy()
    _same_bits(got, np.asarray(jnp.arctan2(jnp.asarray(y), jnp.asarray(x))))


def test_atan2_f64_subnormals_as_the_reference():
    """XLA runs glibc's atan2 with subnormals read and written as zero:
    ``atan2(5e-324, -1)`` is -pi there (``y > 0`` is false), a subnormal
    x counts as 0 (pi/2 by y's sign) and a subnormal quotient is 0."""
    y = np.array([5e-324, 5e-324, 1e-310, -1e-310, 1e-300, 1.0, -1.0])
    x = np.array([-1.0, 1.0, 5e-324, 1e-310, 1e10, 1e-310, -5e-324])
    got = trig.atan2_f64(torch.as_tensor(y), torch.as_tensor(x)).numpy()
    _same_bits(got, np.asarray(jnp.arctan2(jnp.asarray(y), jnp.asarray(x))))
    np.testing.assert_array_equal(got[:2], [-np.pi, 0.0])


COS_SIN_CASES = {
    "draws": lambda: np.random.default_rng(3).standard_normal(1_000_000) * np.exp(np.random.default_rng(4).uniform(
        -30, 30, 1_000_000)),
    "jacobi_range": lambda: np.random.default_rng(5).uniform(-np.pi / 2, np.pi / 2, 1_000_000),
    # Around every multiple of pi/2 up to 10^5 (the reduction cancels most
    # of the argument) and a few far out.
    "near_multiples": lambda: np.concatenate([_near(k * np.pi / 2, 200) for k in
                                              list(range(-300, 301)) + [10 ** 5, -(10 ** 5) - 1, 10 ** 7] if k]),
    # The branch bounds: 2^-27 and 2^-26 (the tiny returns), 0.126 (the
    # Taylor form), 0.855469 and 2.426265 (the table bands), 105414350
    # (__branred), and huge arguments.
    "bounds": lambda: np.concatenate([
        _near([2.0 ** -27, 2.0 ** -26, 0.126, 0.85546875, 2.4262657165527344, 105414350.0, 105414349.0], 2000),
        -_near([2.0 ** -27, 0.126, 0.85546875, 2.4262657165527344, 105414350.0], 2000),
        np.random.default_rng(6).uniform(-1e9, 1e9, 100_000),
        np.random.default_rng(7).standard_normal(100_000) * np.exp(np.random.default_rng(8).uniform(18, 700, 100_000)),
    ]),
    "special": lambda: SPECIAL,
}


@pytest.mark.parametrize("fn", ["cos", "sin"])
@pytest.mark.parametrize("case", sorted(COS_SIN_CASES))
def test_cos_sin_f64_bitwise_to_jnp(case, fn):
    a = COS_SIN_CASES[case]()
    got = getattr(trig, f"{fn}_f64")(torch.as_tensor(a)).numpy()
    _same_bits(got, np.asarray(getattr(jnp, fn)(jnp.asarray(a))))


@pytest.mark.slow
@pytest.mark.parametrize("fn", ["cos", "sin", "atan2"])
def test_f64_forty_million_draws(fn):
    """40,000,000 draws in chunks (a few minutes a function)."""
    for seed in range(40):
        if fn == "atan2":
            y, x = _pairs(100 + seed, 1_000_000)
            got = trig.atan2_f64(torch.as_tensor(y), torch.as_tensor(x)).numpy()
            want = np.asarray(jnp.arctan2(jnp.asarray(y), jnp.asarray(x)))
        else:
            a = np.random.default_rng(200 + seed).standard_normal(1_000_000) * np.exp(
                np.random.default_rng(300 + seed).uniform(-5, 25, 1_000_000))
            got = getattr(trig, f"{fn}_f64")(torch.as_tensor(a)).numpy()
            want = np.asarray(getattr(jnp, fn)(jnp.asarray(a)))
        _same_bits(got, want)


def test_dispatch_by_dtype_on_the_cpu():
    """``trig.atan2`` and ``trig.cos_sin`` run the float32 or the float64
    plain version on a CPU tensor, with no launch."""
    y, x = _pairs(9, 4096)
    before = (trig.atan2.launches, trig.cos_sin.launches)
    for dt in (np.float32, np.float64):
        ty, tx = torch.as_tensor(y.astype(dt)), torch.as_tensor(x.astype(dt))
        got = trig.atan2(ty, tx).numpy()
        want = np.asarray(jnp.arctan2(ty.numpy(), tx.numpy()))
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
        co, si = trig.cos_sin(torch.as_tensor(got))
        np.testing.assert_array_equal(co.numpy().view(np.uint8), np.asarray(jnp.cos(got)).view(np.uint8))
        np.testing.assert_array_equal(si.numpy().view(np.uint8), np.asarray(jnp.sin(got)).view(np.uint8))
    assert (trig.atan2.launches, trig.cos_sin.launches) == before
    with pytest.raises(ValueError):
        trig.atan2(torch.zeros(3, dtype=torch.float32), torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("fn", ["atan2", "cos", "sin"])
def test_f64_bits_independent_of_batch_position(fn):
    """The same 1003 elements one at a time, as one batch, shuffled, and at
    an odd offset inside a longer batch give the same bits."""
    y, x = _pairs(10, 1003)
    call = {
        "atan2": lambda yy, xx: trig.atan2_f64(yy, xx),
        "cos": lambda yy, xx: trig.cos_f64(yy * 1e-10),
        "sin": lambda yy, xx: trig.sin_f64(yy * 1e-10),
    }[fn]
    ty, tx = torch.as_tensor(y), torch.as_tensor(x)
    batch = call(ty, tx).numpy()
    single = np.concatenate([call(ty[i:i + 1], tx[i:i + 1]).numpy() for i in range(len(y))])
    perm = np.random.default_rng(11).permutation(len(y))
    shuffled = np.empty_like(batch)
    shuffled[perm] = call(ty[perm], tx[perm]).numpy()
    pad = torch.as_tensor(_pairs(12, 7)[0])
    offset = call(torch.cat([pad, ty]), torch.cat([pad, tx])).numpy()[7:]
    for other in (single, shuffled, offset):
        _same_bits(other, batch)


def _fma_exact(a, b, c):
    """``a * b + c`` in exact rationals, rounded once to float64."""
    return np.array([float(Fraction(p) * Fraction(q) + Fraction(r)) for p, q, r in zip(a, b, c)])


@pytest.mark.parametrize("case", ["random", "cancelling", "ties", "zeros", "rotations"])
def test_fma_f64_rounds_once(case):
    rng = np.random.default_rng({"random": 13, "cancelling": 14, "ties": 15, "zeros": 16, "rotations": 17}[case])
    n = 4000
    if case == "random":
        a, b, c = (rng.standard_normal(n) * np.exp(rng.uniform(-60, 60, n)) for _ in range(3))
    elif case == "cancelling":  # c near -a b: the product's low half decides
        a, b = rng.standard_normal(n), rng.standard_normal(n)
        c = -(a * b) * (1 + rng.uniform(-1e-12, 1e-12, n))
    elif case == "ties":  # short mantissas: a b + c often lands on a midpoint
        a = rng.integers(-2 ** 26, 2 ** 26, n) * 2.0 ** rng.integers(-30, 30, n)
        b = rng.integers(-2 ** 27, 2 ** 27, n) * 2.0 ** rng.integers(-30, 30, n)
        c = rng.integers(-2 ** 52, 2 ** 52, n) * 2.0 ** rng.integers(-30, 30, n)
    elif case == "zeros":  # signed zeros: a zero sum keeps (a b + c)'s IEEE sign
        a = rng.choice([0.0, -0.0, 1.5, -2.0], n)
        b = rng.choice([0.0, -0.0, 3.0, -0.5], n)
        c = rng.choice([0.0, -0.0, 4.5, -3.0], n)
    else:  # the Jacobi's: c = cos, s = sin, entries of one scale
        th = rng.uniform(-np.pi / 2, np.pi / 2, n)
        a, b = np.cos(th), rng.standard_normal(n)
        c = -(np.sin(th) * rng.standard_normal(n))
    got = trig.fma_f64(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    want = _fma_exact(a, b, c)
    if case == "zeros":
        want = np.where(want == 0, a * b + c, want)  # Fraction drops the sign of zero; IEEE's rule
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_tables_are_the_c_library_bytes():
    """``csrc/trig64_tables.cuh``'s tables appear byte for byte in the C
    library whose functions the reference calls."""
    ctypes.CDLL(ctypes.util.find_library("m"))
    with open("/proc/self/maps") as maps:  # the file of the C math library this process maps
        path = next(line.split()[-1] for line in maps if "libm.so" in line or "libm-" in line)
    libm = open(path, "rb").read()
    tables = trig._libm_tables()
    assert {k: len(v) for k, v in tables.items()} == {"kSinCosTab": 440, "kToverp": 75, "kAtanCij": 1687}
    for name, values in tables.items():
        assert libm.find(struct.pack(f"<{len(values)}d", *values)) >= 0, name


def test_sqrt_is_correctly_rounded():
    """``trig.sqrt`` against the exact test: y = RN(sqrt(x)) iff x lies
    within half an ulp of y in the square (fractions), and against jnp."""
    rng = np.random.default_rng(18)
    x = rng.uniform(0, 10, 200_000)
    got = trig.sqrt(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.sqrt(jnp.asarray(x))))
    for xi, yi in zip(x[:300], got[:300]):
        lo, hi = np.nextafter(yi, 0), np.nextafter(yi, np.inf)
        fx = Fraction(xi)
        assert (Fraction(lo) + Fraction(yi)) ** 2 / 4 <= fx <= (Fraction(hi) + Fraction(yi)) ** 2 / 4
    x32 = x.astype(np.float32)
    np.testing.assert_array_equal(trig.sqrt(torch.as_tensor(x32)).numpy(), np.asarray(jnp.sqrt(jnp.asarray(x32))))


def test_torch_cpu_sqrt_is_not_correctly_rounded():
    """Why ``trig.sqrt`` exists: on the same draws PyTorch's CPU ``sqrt``
    of this build differs from the correctly rounded square root (jnp's)
    on some, in float64 and float32, where ``trig.sqrt`` differs on none.
    Should a PyTorch build round it correctly, this fails and
    ``trig.sqrt`` can give way to ``torch.sqrt``."""
    rng = np.random.default_rng(20)
    for dtype in (np.float64, np.float32):
        x = rng.uniform(0, 10, 200_000).astype(dtype)
        want = np.asarray(jnp.sqrt(jnp.asarray(x)))
        np.testing.assert_array_equal(trig.sqrt(torch.as_tensor(x)).numpy(), want)
        off = int((torch.sqrt(torch.as_tensor(x)).numpy() != want).sum())
        assert off > 0, f"torch.sqrt is correctly rounded on all {x.size} {np.dtype(dtype).name} draws"


# ---------------------------------------------------------------------------
# The kernels, on a card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/trig_probe.cu runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ATAN2_CASES))
def test_cuda_f64_trig_kernels_bitwise_to_plain(case):
    dev = _cuda()
    y, x = (torch.as_tensor(v, device=dev) for v in ATAN2_CASES[case]())
    before = (trig.atan2.launches, trig.cos_sin.launches)
    ang = trig.atan2(y, x)
    co, si = trig.cos_sin(ang * 7.0)
    a32 = trig.atan2(y.float(), x.float())
    torch.cuda.synchronize()
    assert (trig.atan2.launches, trig.cos_sin.launches) == (before[0] + 2, before[1] + 1)
    _same_bits(ang.cpu().numpy(), trig.atan2_f64(y.cpu(), x.cpu()).numpy())
    pc, ps = trig.cos_sin_f64((ang * 7.0).cpu())
    _same_bits(co.cpu().numpy(), pc.numpy())
    _same_bits(si.cpu().numpy(), ps.numpy())
    want32 = trig.atan2_f32(y.float().cpu(), x.float().cpu()).numpy()
    np.testing.assert_array_equal(np.isnan(a32.cpu().numpy()), np.isnan(want32))
    ok = ~np.isnan(want32)
    np.testing.assert_array_equal(a32.cpu().numpy()[ok].view(np.uint32), want32[ok].view(np.uint32))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_small_cpu_calls_equal_the_written_out_forms(dtype):
    """A CPU call on at most ``trig.SMALL`` elements takes the C library's
    functions (checked once to be the written-out ones): the same bits,
    and the written-out form wherever a subnormal operand or result would
    meet XLA's flush (atan2)."""
    assert trig._libm() is not None  # glibc 2.36 on x86-64 is the written-out function
    rng = np.random.default_rng(19)
    tiny = np.finfo(dtype).tiny
    y = np.concatenate([rng.standard_normal(200) * np.exp(rng.uniform(-20, 20, 200)),
                        [tiny / 4, -tiny / 8, 1.0, 1e-30, 0.0, np.inf, np.nan]]).astype(dtype)
    x = np.concatenate([rng.standard_normal(200), [1.0, 1.0, tiny / 2, 1e30, -0.0, 1.0, 1.0]]).astype(dtype)
    ty, tx = torch.as_tensor(y), torch.as_tensor(x)
    written = trig.atan2_f32 if dtype == np.float32 else trig.atan2_f64
    for sl in (slice(0, 200), slice(200, None), slice(None)):
        got, want = trig.atan2_plain(ty[sl], tx[sl]).numpy(), written(ty[sl], tx[sl]).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got[~np.isnan(got)].view(np.uint8), want[~np.isnan(want)].view(np.uint8))
    a = np.concatenate([y, rng.uniform(-1e6, 1e6, 40)]).astype(dtype)[:trig.SMALL]
    co, si = trig.cos_sin_by_dtype(torch.as_tensor(a))
    wc, ws = (trig.cos_sin_plain if dtype == np.float32 else trig.cos_sin_f64)(torch.as_tensor(a))
    for g, w in ((co, wc), (si, ws)):
        g, w = g.numpy(), w.numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(g[~np.isnan(g)].view(np.uint8), w[~np.isnan(w)].view(np.uint8))
