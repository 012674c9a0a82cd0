"""cv_tpu_torch's SfM geometry against cv_tpu on the same seeded inputs
(float64): the so(3) maps, the epipolar gradients, Linear-Eigen
triangulation, graph BA, the fused BA + observation filter, and the
registration cascade.  Each tolerance has the measured worst case beside
it; masks and counts are held exactly.
"""

import jax.numpy as jnp
import numpy as np
import torch

from cv_tpu.core import lie as jlie
from cv_tpu.core.pose import Isometry3 as JIso
from cv_tpu.geom import epipolar as jepi
from cv_tpu.sfm import device_refine as jdr
from cv_tpu.sfm.se3 import so3_exp as np_so3_exp
from cv_tpu.triangulate import linear_eigen as jle
from cv_tpu_torch.core import lie
from cv_tpu_torch.core.pose import Isometry3
from cv_tpu_torch.geom import epipolar
from cv_tpu_torch.sfm import device_refine
from cv_tpu_torch.triangulate import linear_eigen


def T(a):
    a = np.asarray(a)
    return torch.tensor(a) if a.dtype != bool else torch.tensor(a, dtype=torch.bool)


def N(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _unit(rng, shape):
    v = rng.normal(size=shape + (3,))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_so3_maps():
    """exp/log/hat over random, tiny (Taylor branch) and near-pi angles:
    bit for bit (ops.trig's functions; tests/test_torch_lie.py holds the
    maps on 20,000 rows a dtype)."""
    rng = np.random.default_rng(0)
    w = np.concatenate([
        rng.normal(size=(64, 3)),
        rng.normal(size=(16, 3)) * 1e-9,
        _unit(rng, (16,)) * (np.pi - rng.uniform(0, 1e-6, (16, 1))),
    ])
    r = N(lie.so3_exp(T(w)))
    np.testing.assert_array_equal(r.view(np.uint64), np.asarray(jlie.so3_exp(jnp.asarray(w))).view(np.uint64))
    np.testing.assert_array_equal(N(lie.so3_log(T(r))).view(np.uint64),
                                  np.asarray(jlie.so3_log(jnp.asarray(r))).view(np.uint64))
    np.testing.assert_array_equal(N(lie.so3_hat(T(w))), np.asarray(jlie.so3_hat(jnp.asarray(w))))
    np.testing.assert_array_equal(N(lie.so3_vee(lie.so3_hat(T(w)))), w)


def test_epipolar_functions():
    """three_view_gradients, world_pose_gradient, loss and the sine-L1
    triangulation: within 1e-12 (measured worst 5.6e-17), ok masks exact."""
    rng = np.random.default_rng(1)
    n = 200
    c, f, s = _unit(rng, (n,)), _unit(rng, (n,)), _unit(rng, (n,))
    ftoc, stoc = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    got = epipolar.three_view_gradients(T(c), T(f), T(ftoc), T(s), T(stoc))
    ref = jepi.three_view_gradients(*(jnp.asarray(x) for x in (c, f, ftoc, s, stoc)))
    for g, r in zip((x for pair in got for x in pair), (x for pair in ref for x in pair)):
        np.testing.assert_allclose(N(g), np.asarray(r), atol=1e-12, rtol=0)
    p, ok = epipolar.two_view_same_space_triangulate_sine_l1(T(ftoc), T(c), T(f))
    rp, rok = jepi.two_view_same_space_triangulate_sine_l1(jnp.asarray(ftoc), jnp.asarray(c), jnp.asarray(f))
    np.testing.assert_array_equal(N(ok), np.asarray(rok))
    np.testing.assert_allclose(N(p), np.asarray(rp), atol=1e-12, rtol=0)
    for g, r in zip(epipolar.world_pose_gradient(T(ftoc), T(c)), jepi.world_pose_gradient(jnp.asarray(ftoc), jnp.asarray(c))):
        np.testing.assert_allclose(N(g), np.asarray(r), atol=1e-12, rtol=0)
    np.testing.assert_allclose(
        N(epipolar.loss(T(ftoc), T(c), T(f))), np.asarray(jepi.loss(*(jnp.asarray(x) for x in (ftoc, c, f)))),
        atol=1e-12, rtol=0,
    )


def _views(rng, v):
    rot = np.stack([np_so3_exp(rng.normal(size=3) * 0.05) for _ in range(v)])
    trans = rng.normal(size=(v, 3)) * 0.5
    return rot, trans


def _observe(rng, rot, trans, pts, noise=1e-4):
    cam = np.einsum("vij,lj->lvi", rot, pts) + trans[None]
    b = cam + rng.normal(0, noise, cam.shape)
    return b / np.linalg.norm(b, axis=-1, keepdims=True)


def test_linear_eigen_with_valid_mask():
    """Triangulation of 64 landmarks seen by up to 5 views with a ragged
    valid mask, and the two-view form: points and ok masks bit for bit (the
    4x4 eigensystems are the reference's, ops.eigen)."""
    rng = np.random.default_rng(2)
    rot, trans = _views(rng, 5)
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (64, 3))
    bear = _observe(rng, rot, trans, pts)
    valid = rng.uniform(size=(64, 5)) < 0.7
    valid[:, :2] = True
    rb, tb = np.broadcast_to(rot, (64, 5, 3, 3)), np.broadcast_to(trans, (64, 5, 3))
    p, ok = linear_eigen.triangulate_observations(Isometry3(rotation=T(rb), translation=T(tb)), T(bear), valid=T(valid))
    rp, rok = jle.triangulate_observations(JIso(rotation=jnp.asarray(rb), translation=jnp.asarray(tb)), jnp.asarray(bear), valid=jnp.asarray(valid))
    np.testing.assert_array_equal(N(ok), np.asarray(rok))
    np.testing.assert_array_equal(N(p).view(np.uint64), np.asarray(rp).view(np.uint64))
    rel = Isometry3(rotation=T(rot[1]), translation=T(trans[1]))
    p2, ok2 = linear_eigen.triangulate_relative(rel, T(bear[:, 0]), T(bear[:, 1]))
    rp2, rok2 = jle.triangulate_relative(JIso(rotation=jnp.asarray(rot[1]), translation=jnp.asarray(trans[1])), jnp.asarray(bear[:, 0]), jnp.asarray(bear[:, 1]))
    np.testing.assert_array_equal(N(ok2), np.asarray(rok2))
    np.testing.assert_array_equal(N(p2).view(np.uint64), np.asarray(rp2).view(np.uint64))


def _ba_problem(seed, v=6, e=24):
    rng = np.random.default_rng(seed)
    rot, trans = _views(rng, v)
    edge_to = rng.integers(0, v - 1, e)  # view v-1 has no edge: removed
    edge_from = (edge_to + rng.integers(1, v - 1, e)) % (v - 1)
    # Expected other->view isometries from the true poses, perturbed.
    er, et = [], []
    for a, b in zip(edge_to, edge_from):
        r_rel = rot[a] @ rot[b].T
        er.append(np_so3_exp(rng.normal(size=3) * 0.01) @ r_rel)
        et.append(trans[a] - r_rel @ trans[b] + rng.normal(size=3) * 0.01)
    valid = rng.uniform(size=e) < 0.85
    noisy_rot = np.stack([np_so3_exp(rng.normal(size=3) * 0.02) @ r for r in rot])
    noisy_t = trans + rng.normal(size=trans.shape) * 0.02
    return rng, rot, trans, (noisy_rot, noisy_t, edge_to, edge_from, np.stack(er), np.stack(et), valid)


def test_graph_ba_core():
    """64 rounds on a 6-view graph with invalid edges and one edgeless view:
    poses within 1e-10 (measured worst 7.8e-16), removed mask exact."""
    _, _, _, arrays = _ba_problem(3)
    got = device_refine.graph_ba_core(*(T(a) for a in arrays), iterations=64, rate=0.01)
    ref = jdr.graph_ba_core(*(jnp.asarray(a) for a in arrays), 64, 0.01)
    np.testing.assert_array_equal(N(got[2]), np.asarray(ref[2]))
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(N(g), np.asarray(r), atol=1e-10, rtol=0)


def test_ba_filter():
    """The fused BA + observation filter on 128 landmarks (2-4 observations,
    some outliers): poses within 1e-10 (measured worst 6.7e-16); kill,
    bad_obs, removed and the robust count exact."""
    rng, rot, trans, arrays = _ba_problem(4)
    v = rot.shape[0]
    lmax, omax = 128, 4
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (lmax, 3))
    bear_all = _observe(rng, rot, trans, pts)
    lm_view = np.zeros((lmax, omax), np.int64)
    lm_bear = np.zeros((lmax, omax, 3))
    lm_bear[..., 2] = 1.0
    lm_mask = np.zeros((lmax, omax), bool)
    for i in range(lmax):
        k = rng.integers(2, omax + 1)
        views = rng.choice(v - 1, size=k, replace=False)
        lm_view[i, :k] = views
        lm_bear[i, :k] = bear_all[i, views]
        lm_mask[i, :k] = True
        if rng.uniform() < 0.2:  # an outlier observation
            lm_bear[i, 0] = _unit(rng, ())
    lm_valid = np.ones(lmax, bool)
    lm_valid[-8:] = False
    args = (lm_view, lm_bear, lm_mask, lm_valid)
    got = device_refine.ba_filter(*(T(a) for a in arrays), *(T(a) for a in args), 0.1, 1e-5, 1e-3, 3, iterations=32, rate=0.01)
    ref = jdr.ba_filter(*(jnp.asarray(a) for a in arrays), *(jnp.asarray(a) for a in args), 0.1, 1e-5, 1e-3, jnp.int32(3), iterations=32, rate=0.01)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(N(g), np.asarray(r), atol=1e-10, rtol=0)
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(N(g), np.asarray(r))
    assert 0 < int(got[5]) < lmax


def test_register_refine():
    """The registration cascade (5 filter rounds, patience 300) on 96
    candidate matches, some wrong: poses within 1e-9 (measured worst
    3.3e-16); the consistency mask, the per-round counts, c0 and the final
    counts exact."""
    rng = np.random.default_rng(5)
    rot, trans = _views(rng, 4)
    m, o = 96, 4
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (m, 3))
    bear_all = _observe(rng, rot, trans, pts, noise=1e-5)
    new_bear = bear_all[:, 3].copy()
    new_bear[:10] = _unit(rng, (10,))  # wrong matches
    obs_rot = np.zeros((m, o, 3, 3))
    obs_rot[:] = np.eye(3)
    obs_trans = np.zeros((m, o, 3))
    obs_bear = np.zeros((m, o, 3))
    obs_mask = np.zeros((m, o), bool)
    for i in range(m):
        k = 1 if i % 7 == 0 else rng.integers(2, 4)
        views = rng.choice(3, size=k, replace=False)
        obs_rot[i, :k], obs_trans[i, :k], obs_bear[i, :k] = rot[views], trans[views], bear_all[i, views]
        obs_mask[i, :k] = True
    hp = np.concatenate([pts, np.ones((m, 1))], axis=1)
    hp = hp / np.linalg.norm(hp[:, :3], axis=1, keepdims=True)
    point_ok = rng.uniform(size=m) < 0.9
    points = np.where(point_ok[:, None], hp, 0.0)
    match_valid = np.ones(m, bool)
    match_valid[-6:] = False
    positions = np.maximum(np.cumsum(point_ok) - 1, 0)
    inlier = rng.uniform(size=m) < 0.95
    rot0 = np_so3_exp(rng.normal(size=3) * 0.01) @ rot[3]
    t0 = trans[3] + rng.normal(size=3) * 0.01
    arrays = (rot0, t0, new_bear, points, point_ok, match_valid, obs_rot, obs_trans, obs_bear, obs_mask, inlier, positions)
    kw = dict(filter_iterations=5, cap=48, rate=1e-3, patience=300)
    got = device_refine.register_refine(*(T(a) for a in arrays), 0.1, 1e-3, **kw)
    ref = jdr.register_refine(*(jnp.asarray(a) for a in arrays), 0.1, 1e-3, **kw)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(N(g), np.asarray(r), atol=1e-9, rtol=0)
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(N(g), np.asarray(r))
    assert int(got[4]) > 0
