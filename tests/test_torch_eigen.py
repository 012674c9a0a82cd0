"""cv_tpu_torch.ops.eigen against cv_tpu's jitted Jacobi eigensolver.

``cv_tpu.ops.eigen.eigh_small`` is a jitted ``fori_loop`` of cyclic Jacobi
sweeps: XLA's CPU backend takes each rotation's angle from glibc's
``atan2`` and its cosine and sine from glibc's ``cos``/``sin`` (``atan2f``,
``cosf``, ``sinf`` in float32), and contracts every Givens update into a
fused multiply-add (``fma(c, x, -(s y))``, ``fma(s, x, c y)``).  The
port's plain version computes that function exactly; it is held bit for
bit here (eigenvalues and eigenvectors, a NaN only by position) at N = 3,
4 and 9, at 6 and 8 sweeps, in float32 and float64, on random symmetric
matrices and on zero, diagonal, repeated-eigenvalue, ``apq = 0`` and
graded ones.  The angle's shortcut for converged rotations is held to the
general functions; the unfused sweep (``exact=False`` on a CPU) is held
near cv_tpu's at a stated tolerance, and the kernel (``csrc/jacobi.cu``) runs
only on a card: the ``cuda`` tests skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.ops import eigen as jeig
from cv_tpu_torch.ops import eigen as teig
from cv_tpu_torch.ops import trig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's tensor work on one thread: parallel test workers share
    the machine's cores, and torch's threads would spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bits = np.uint32 if got.dtype == np.float32 else np.uint64
    bad = (got.view(bits) != want.view(bits)) & ~nan
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} differ, first at {np.argwhere(bad)[:3].tolist()}"


def _random(rng, b, n):
    m = rng.standard_normal((b, n, n)) * np.exp(rng.uniform(-3, 3, (b, 1, 1)))
    return (m + np.swapaxes(m, -1, -2)) / 2


def _structured(rng, n):
    """Zero, identity, diagonal (ascending, descending, repeated), a
    repeated eigenvalue in a random basis, an ``apq = 0`` pattern, a
    rank-one matrix, graded scales and a 2x2 block, each a few times."""
    mats = [np.zeros((n, n)), np.eye(n), np.diag(np.arange(n, 0, -1.0)), np.diag(np.arange(n) * 1.0),
            np.diag(np.repeat([2.0, -1.0], [n - n // 2, n // 2]))]
    for _ in range(4):
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        mats.append(q @ np.diag(np.repeat([1.0, 3.0], [n // 2, n - n // 2])) @ q.T)  # repeated eigenvalues
        m = _random(rng, 1, n)[0]
        m[0, 1] = m[1, 0] = 0.0  # the first rotation's apq = 0
        m[n - 2, n - 1] = m[n - 1, n - 2] = 0.0
        mats.append(m)
        v = rng.standard_normal(n)
        mats.append(np.outer(v, v))  # rank one
        d = np.diag(10.0 ** rng.uniform(-8, 8, n))
        mats.append(d @ _random(rng, 1, n)[0] @ d)  # graded
        blk = np.zeros((n, n))
        blk[:2, :2] = _random(rng, 1, 2)[0]
        mats.append(blk)
    return np.stack(mats)


# (N, matrices, sweeps): 32,904 matrices over the four sweep/dtype cells.
SIZES = [(3, 3000), (4, 4000), (9, 700)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("sweeps", [6, 8])
@pytest.mark.parametrize("n,count", SIZES)
def test_eigh_small_bitwise_to_cv_tpu(n, count, sweeps, dtype):
    rng = np.random.default_rng(100 * n + sweeps)
    a = np.concatenate([_random(rng, count, n), _structured(rng, n)]).astype(dtype)
    wj, vj = jeig.eigh_small(jnp.asarray(a), sweeps=sweeps)
    wt, vt = teig.eigh_small(torch.as_tensor(a), sweeps=sweeps)
    _same_bits(wt.numpy(), wj)
    _same_bits(vt.numpy(), vj)


def test_eigh4_and_batch_shapes():
    """``eigh4`` and a (2, 3)-batch of 4x4 matrices: the same bits as the
    flat batch and as cv_tpu's."""
    a = _random(np.random.default_rng(7), 6, 4).reshape(2, 3, 4, 4)
    wt, vt = teig.eigh4(torch.as_tensor(a))
    wj, vj = jeig.eigh4(jnp.asarray(a))
    _same_bits(wt.numpy(), wj)
    _same_bits(vt.numpy(), vj)
    wf, vf = teig.eigh_small(torch.as_tensor(a.reshape(6, 4, 4)))
    _same_bits(wt.numpy().reshape(6, 4), wf.numpy())
    _same_bits(vt.numpy().reshape(6, 4, 4), vf.numpy())


def test_eigh_small_nan_and_inf():
    """A NaN or infinite entry propagates as the reference's does."""
    a = _random(np.random.default_rng(8), 4, 4)
    a[0, 1, 2] = a[0, 2, 1] = np.nan
    a[1, 0, 0] = np.inf
    a[2, 3, 3] = -np.inf
    wj, vj = jeig.eigh_small(jnp.asarray(a))
    wt, vt = teig.eigh_small(torch.as_tensor(a))
    _same_bits(wt.numpy(), wj)
    _same_bits(vt.numpy(), vj)


def test_angle_shortcut_equals_the_general_functions():
    """``_angle_f64``'s converged-rotation form (cos 1, sin theta) gives the
    bits of glibc's atan2 and cos/sin on pairs around its bounds: ratios
    near 2^-28, exponent differences near 57 binades, magnitudes near
    2^+-500, both signs of ``aqq - app``, zeros."""
    rng = np.random.default_rng(9)
    n = 100_000
    d = rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
    ratio = np.exp2(rng.uniform(-60, -20, n)) * rng.choice([-1.0, 1.0], n)
    apq = 0.5 * d * ratio
    d[:1000] = np.abs(d[:1000]) * 2.0 ** rng.uniform(495, 505, 1000)
    d[1000:2000] = np.abs(d[1000:2000]) * 2.0 ** rng.uniform(-505, -495, 1000)
    apq[2000:2100] = 0.0
    app = rng.standard_normal(n)
    aqq = app + d
    t = lambda v: torch.as_tensor(v)
    c, s = teig._angle_f64(t(apq), t(app), t(aqq))
    theta = 0.5 * trig.atan2_f64(2.0 * t(apq), t(aqq) - t(app))
    cg, sg = trig.cos_sin_f64(theta)
    _same_bits(c.numpy(), cg.numpy())
    _same_bits(s.numpy(), sg.numpy())


def test_jacobi_rejects_the_cpu():
    with pytest.raises(ValueError):
        teig.jacobi(torch.zeros(2, 4, 4, dtype=torch.float64))


def test_eigh_small_refuses_a_gradient():
    with pytest.raises(ValueError):
        teig.eigh_small(torch.zeros(2, 4, 4, dtype=torch.float64, requires_grad=True))


# (relative eigenvalue, eigenvector) tolerances of the unfused sweep
UNFUSED_TOL = {"float64": (1e-14, 1e-12), "float32": (1e-5, 1e-4)}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,sweeps", [(3, 8), (4, 6), (9, 8)])
def test_unfused_sweep_near_cv_tpu(n, sweeps, dtype):
    """The CPU's ``exact=False`` sweep (``_eigh_unfused``) against cv_tpu's
    on 2,000 random matrices: eigenvalues within 1e-14 of the matrix's
    largest entry in float64 (measured worst 5.3e-15, N = 9), 1e-5 in
    float32 (3.6e-6); eigenvectors, in the same order and sign, within
    1e-12 (measured worst 2.0e-14) and 1e-4 (2.4e-5)."""
    rng = np.random.default_rng(40 + n)
    a = _random(rng, 2000, n).astype(dtype)
    wj, vj = jeig.eigh_small(jnp.asarray(a), sweeps=sweeps)
    wt, vt = teig._eigh_unfused(torch.as_tensor(a), sweeps)
    rel, vec = UNFUSED_TOL[dtype]
    scale = np.abs(a).max(axis=(1, 2))[:, None]
    assert (np.abs(wt.numpy() - np.asarray(wj)) <= rel * scale).all()
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=vec, rtol=0)


def test_eigh_small_exact_false_takes_the_unfused_sweep_on_a_cpu():
    """``exact=False`` gives the unfused sweep's bits on a CPU; the default,
    cv_tpu's."""
    a = torch.as_tensor(_random(np.random.default_rng(41), 64, 4))
    w, v = teig.eigh_small(a, exact=False)
    wu, vu = teig._eigh_unfused(a, 6)
    _same_bits(w.numpy(), wu.numpy())
    _same_bits(v.numpy(), vu.numpy())
    w, v = teig.eigh4(a)
    wj, vj = jeig.eigh_small(jnp.asarray(a.numpy()))
    _same_bits(w.numpy(), wj)
    _same_bits(v.numpy(), vj)


# ---------------------------------------------------------------------------
# The kernel, on a card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/jacobi.cu runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 9, 10])
def test_cuda_jacobi_bitwise_to_plain(n, dtype):
    dev = _cuda()
    rng = np.random.default_rng(n)
    a = torch.as_tensor(np.concatenate([_random(rng, 3000, n), _structured(rng, n)]), dtype=dtype)
    before = teig.eigh_small.launches
    w, v = teig.eigh_small(a.to(dev), sweeps=8)
    torch.cuda.synchronize()
    assert teig.eigh_small.launches == before + 1
    wp, vp = teig.eigh_small_plain(a, sweeps=8)
    _same_bits(w.cpu().numpy(), wp.numpy())
    _same_bits(v.cpu().numpy(), vp.numpy())
