"""cv_tpu_torch's L1 (Weiszfeld) pose optimizers and Levenberg-Marquardt
against cv_tpu on the reference tests' problems (tests/test_geom_optimize.py),
float64.

* The L1 loops sum over landmarks left to right and cv_tpu with XLA's
  reductions, so the step sums differ in the last bits: the poses agree
  within 1e-9 (measured worst 6.5e-14 single-view, 4.0e-12 three-view),
  and each reduces its objective as cv_tpu's test requires.
* Levenberg-Marquardt: x within 1e-9 (measured worst 1.9e-15), the cost
  within 1e-12 (4.4e-16), iteration counts and the converged flag equal, on the
  exponential fit, the Rosenbrock valley, a supplied Jacobian and a capped
  run.  cv_tpu batches by ``jax.vmap``; the port takes a leading batch of
  problems (``args`` carries each problem's data), equal to ``jax.vmap``'s
  results within 1e-9 and bitwise equal to solving the problems one at a
  time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu import optimize as jopt
from cv_tpu.core import CameraToCamera as JC2C
from cv_tpu.core import WorldToCamera as JW2C
from cv_tpu_torch import optimize as opt
from cv_tpu_torch.core import CameraToCamera, WorldToCamera, lie, projective, world_to_camera_residual
from cv_tpu_torch.geom import epipolar
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)


def _j(pose, cls):
    return cls(rotation=jnp.asarray(pose.rotation.numpy()), translation=jnp.asarray(pose.translation.numpy()))


def _single_problem(n=64):
    rng = np.random.default_rng(0)
    true = WorldToCamera(rotation=lie.so3_exp(torch.tensor([0.1, -0.2, 0.15], dtype=torch.float64)),
                         translation=torch.tensor([0.2, -0.1, 0.4], dtype=torch.float64))
    wps = projective.from_point(torch.tensor(rng.uniform([-2, -2, 2], [2, 2, 8], (n, 3))))
    bearings = projective.bearing(true.transform(wps))
    init = WorldToCamera(rotation=lie.so3_exp(torch.tensor([0.02, 0.01, -0.02], dtype=torch.float64)) @ true.rotation,
                         translation=true.translation + torch.tensor([0.05, -0.03, 0.04], dtype=torch.float64))
    return true, init, wps, bearings


@pytest.mark.parametrize("iterations", [40, 4000])
def test_single_view_l1_matches_cv_tpu(iterations):
    _, init, wps, bearings = _single_problem()
    valid = torch.ones(64, dtype=torch.bool)
    valid[5] = False  # an invalid row contributes nothing in either package
    got = opt.single_view_simple_optimize_l1(init, bearings, wps, valid, 1e-9, 1e-2, iterations)
    ref = jopt.single_view_simple_optimize_l1(_j(init, JW2C), jnp.asarray(bearings.numpy()), jnp.asarray(wps.numpy()),
                                              jnp.asarray(valid.numpy()), 1e-9, 1e-2, iterations)
    assert type(got) is WorldToCamera
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(ref.rotation), atol=1e-9, rtol=0)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(ref.translation), atol=1e-9, rtol=0)
    if iterations == 4000:
        obj = lambda p: float(world_to_camera_residual(p, bearings, wps).mean())  # noqa: E731
        assert obj(got) < 0.1 * obj(init)


def _three_view_problem(n, perturb):
    rng = np.random.default_rng(0)
    p1 = CameraToCamera(rotation=lie.so3_exp(torch.tensor([0.02, 0.1, 0.0], dtype=torch.float64)),
                        translation=torch.tensor([0.5, 0.05, 0.1], dtype=torch.float64))
    p2 = CameraToCamera(rotation=lie.so3_exp(torch.tensor([-0.05, 0.03, 0.08], dtype=torch.float64)),
                        translation=torch.tensor([-0.3, 0.4, 0.05], dtype=torch.float64))
    pts = projective.from_point(torch.tensor(rng.uniform([-2, -2, 3], [2, 2, 9], (n, 3))))
    obs = torch.stack([projective.bearing(pts), projective.bearing(p1.transform(pts)),
                       projective.bearing(p2.transform(pts))], dim=1)
    if perturb:
        p1 = CameraToCamera(rotation=lie.so3_exp(torch.tensor([0.01, -0.008, 0.012], dtype=torch.float64)) @ p1.rotation,
                            translation=p1.translation + torch.tensor([0.02, -0.01, 0.015], dtype=torch.float64))
        p2 = CameraToCamera(rotation=lie.so3_exp(torch.tensor([-0.01, 0.006, 0.009], dtype=torch.float64)) @ p2.rotation,
                            translation=p2.translation + torch.tensor([-0.015, 0.02, -0.01], dtype=torch.float64))
    return (p1, p2), obs


@pytest.mark.parametrize("n,perturb,iterations", [(32, False, 200), (128, True, 600)])
def test_three_view_l1_matches_cv_tpu(n, perturb, iterations):
    (p1, p2), obs = _three_view_problem(n, perturb)
    valid = torch.ones(n, dtype=torch.bool)
    valid[3] = False
    got = opt.three_view_simple_optimize_l1((p1, p2), obs, valid, 1e-9, 1e-2, iterations)
    ref = jopt.three_view_simple_optimize_l1((_j(p1, JC2C), _j(p2, JC2C)), jnp.asarray(obs.numpy()),
                                             jnp.asarray(valid.numpy()), 1e-9, 1e-2, iterations)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.rotation.numpy(), np.asarray(r.rotation), atol=1e-9, rtol=0)
        np.testing.assert_allclose(g.translation.numpy(), np.asarray(r.translation), atol=1e-9, rtol=0)
        assert bool(torch.isfinite(g.rotation).all())
    if perturb:
        def loss(q1, q2):
            i1, i2 = q1.inverse(), q2.inverse()
            return float(epipolar.loss(i1.translation.expand(n, 3), obs[:, 0], i1.rotate(obs[:, 1])).mean()
                         + epipolar.loss(i2.translation.expand(n, 3), obs[:, 0], i2.rotate(obs[:, 2])).mean())

        assert loss(*got) < loss(p1, p2)


def _exp_fit(lib):
    t = lib.linspace(0.0, 2.0, 32, dtype=lib.float64)
    y = 1.7 * lib.exp(-0.9 * t)
    return lambda p: p[0] * lib.exp(p[1] * t) - y


def _rosenbrock(lib):
    return lambda p: lib.stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]])


def _line_jacobian(lib):
    t = lib.linspace(0.0, 1.0, 16, dtype=lib.float64)
    y = 0.5 * t + 2.0
    return (lambda p: p[0] * t + p[1] - y), (lambda p: lib.stack([t, lib.ones_like(t)], **(
        {"dim": -1} if lib is torch else {"axis": -1})))


def _lm_case(case, lib):
    """(residual, x0, keyword arguments) of one of cv_tpu's LM tests."""
    if case == "exponential":
        return _exp_fit(lib), [1.0, 0.0], {}
    if case.startswith("rosenbrock"):
        return _rosenbrock(lib), [-1.2, 1.0], dict(max_iterations=3 if case.endswith("capped") else 200)
    resid, jac = _line_jacobian(lib)
    return resid, [0.0, 0.0], dict(jacobian=jac) if case == "supplied_jacobian" else {}


@pytest.mark.parametrize("case", ["exponential", "rosenbrock", "rosenbrock_capped", "supplied_jacobian", "autodiff_line"])
def test_levenberg_marquardt_matches_cv_tpu(case):
    resid, x0, kw = _lm_case(case, torch)
    got = opt.levenberg_marquardt(resid, torch.tensor(x0, dtype=torch.float64), **kw)
    resid, x0, kw = _lm_case(case, jnp)
    ref = jopt.levenberg_marquardt(resid, jnp.asarray(x0, jnp.float64), **kw)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=1e-9, rtol=0)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), atol=1e-12, rtol=0)
    assert int(got.iterations) == int(ref.iterations)
    assert bool(got.converged) == bool(ref.converged)
    assert isinstance(got, opt.LMResult) and got.iterations.dtype == torch.int32


def test_levenberg_marquardt_batch_matches_vmap_and_one_at_a_time():
    t_t = torch.linspace(0.0, 1.0, 24, dtype=torch.float64)
    t_j = jnp.linspace(0.0, 1.0, 24)
    slopes = np.array([0.3, -1.1, 2.2, 0.0])

    def solve_one(slope):
        return jopt.levenberg_marquardt(lambda p: p[0] * t_j + p[1] - (slope * t_j + 0.25), jnp.zeros(2))

    ref = jax.jit(jax.vmap(solve_one))(jnp.asarray(slopes))

    def resid(p, slope):
        return p[0] * t_t + p[1] - (slope * t_t + 0.25)

    s = torch.tensor(slopes)
    got = opt.levenberg_marquardt(resid, torch.zeros(4, 2, dtype=torch.float64), args=(s,))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=1e-9, rtol=0)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    for i in range(4):
        one = opt.levenberg_marquardt(resid, torch.zeros(2, dtype=torch.float64), args=(s[i],))
        assert torch.equal(one.x, got.x[i]) and torch.equal(one.cost, got.cost[i])
        assert int(one.iterations) == int(got.iterations[i]) and bool(one.converged) == bool(got.converged[i])
