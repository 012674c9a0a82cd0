"""cv_tpu_torch.core.lie's so(3) maps against eager cv_tpu.core.lie, bit for bit.

``so3_exp`` and ``so3_log`` take their square roots, sines, cosines and
atan2 from ``ops.trig``: glibc's functions and the correctly rounded square
root, as XLA's CPU code computes ``jnp.sqrt``/``sin``/``cos``/``arctan2``.
Each map is held bitwise (a NaN only by position) on 20,000 rows in float32
and in float64: random angles, the Taylor branch (theta^2 <= eps), angles
near and past pi, zeros, and, for the log, rotations a few ulps off
orthogonal, exact half turns and NaN matrices.  Each is run once as one call
(above ``trig.SMALL`` elements: the written-out functions) and once in calls
of 200 rows (the C library's own functions), so both CPU paths are held.
Their derivatives (``trig``'s autograd functions) are held to
``jax.jacfwd`` of the reference at a stated tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from cv_tpu.core import lie as jlie
from cv_tpu_torch.core import lie
from cv_tpu_torch.ops import trig

ROWS = 20_000
CHUNK = 200  # rows a call in the small-call case: at most trig.SMALL elements a trig call


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bits = np.uint32 if got.dtype == np.float32 else np.uint64
    bad = (got.view(bits) != want.view(bits)) & ~nan
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} differ, first at {np.argwhere(bad)[:3].tolist()}"


def _axes(rng, n):
    u = rng.standard_normal((n, 3))
    return u / np.linalg.norm(u, axis=-1, keepdims=True)


def _tangents(rng, dtype):
    """ROWS scaled axes: a fifth each of angles in [0, pi), log-uniform in
    [2e-9, 1], inside the Taylor branch (theta^2 <= eps), within e^-25 to
    e^-2 below pi, and in [pi, 7); three zeros."""
    k = ROWS // 5
    eps = np.finfo(dtype).eps
    angle = np.concatenate([rng.uniform(0, np.pi, k), np.exp(rng.uniform(-20, 0, k)),
                            np.sqrt(eps) * rng.uniform(0, 1.2, k), np.pi - np.exp(rng.uniform(-25, -2, k)),
                            rng.uniform(np.pi, 7.0, ROWS - 4 * k)])
    w = (_axes(rng, ROWS) * angle[:, None]).astype(dtype)
    w[:3] = 0
    return w


def _rotations(rng, dtype):
    """ROWS matrices: the reference's exp of half the tangents, the same a
    few ulps off orthogonal, half turns about random and coordinate axes,
    the identity and a NaN matrix."""
    w = _tangents(rng, dtype)[: ROWS // 2]
    r = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    noisy = r + (rng.standard_normal(r.shape) * 4 * np.finfo(dtype).eps).astype(dtype)
    a = _axes(rng, 64)
    half = 2 * a[:, :, None] * a[:, None, :] - np.eye(3)  # rotation by pi about a
    special = np.stack([np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1]),
                        np.full((3, 3), np.nan)])
    out = np.concatenate([r, noisy, half.astype(dtype), special.astype(dtype)])
    return out[:ROWS]


def _run(fn, x, batch):
    t = torch.as_tensor(x)
    if batch == "one call":
        assert len(x) > trig.SMALL
        return fn(t).numpy()
    assert CHUNK <= trig.SMALL
    return np.concatenate([fn(t[i:i + CHUNK]).numpy() for i in range(0, len(x), CHUNK)])


@pytest.mark.parametrize("batch", ["one call", "calls of 200"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_so3_exp_bitwise_to_cv_tpu(dtype, batch):
    w = _tangents(np.random.default_rng(30), dtype)
    _same_bits(_run(lie.so3_exp, w, batch), jlie.so3_exp(jnp.asarray(w)))


@pytest.mark.parametrize("batch", ["one call", "calls of 200"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_so3_log_bitwise_to_cv_tpu(dtype, batch):
    r = _rotations(np.random.default_rng(31), dtype)
    assert len(r) == ROWS
    _same_bits(_run(lie.so3_log, r, batch), jlie.so3_log(jnp.asarray(r)))


def test_so3_maps_differentiate_as_cv_tpu():
    """``torch.func.jacfwd`` under ``vmap`` (``optimize.lm``'s default
    Jacobian), reverse-mode autograd and ``torch.autograd.forward_ad`` of
    both maps, against ``jax.jacfwd`` of the reference on 64 float64 rows
    away from the branches' bounds: within 1e-12 (measured worst 1.3e-15
    for the log's gradient, 7.2e-16 for its Jacobian, 8.9e-16 and 4.4e-16
    for the exp's; 6.1e-16 and 5.3e-16 forward)."""
    rng = np.random.default_rng(32)
    w = _axes(rng, 64) * rng.uniform(0.1, 3.0, (64, 1))
    r = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    for fn, jfn, x in ((lie.so3_exp, jlie.so3_exp, w), (lie.so3_log, jlie.so3_log, r)):
        want = np.asarray(jax.vmap(jax.jacfwd(jfn))(jnp.asarray(x)))
        got = torch.func.vmap(torch.func.jacfwd(fn))(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
        t = torch.as_tensor(x).requires_grad_()
        fn(t).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), want.reshape(64, -1, *x.shape[1:]).sum(axis=1), atol=1e-12, rtol=0)
        with forward_ad.dual_level():  # forward mode outside torch.func: the tangent of ones
            out = forward_ad.unpack_dual(fn(forward_ad.make_dual(torch.as_tensor(x), torch.ones(x.shape))))
        axes = tuple(range(want.ndim - x.ndim + 1, want.ndim))
        np.testing.assert_allclose(out.tangent.numpy(), want.sum(axis=axes), atol=1e-12, rtol=0)
