"""cv_tpu_torch's geometry and consensus against cv_tpu's, in float64.

Both run the same cyclic Jacobi sweeps and formulas; they differ only in
rounding order (XLA:CPU against torch's CPU kernels), so eigen-solutions,
essential matrices and residuals agree within 1e-9 on well-conditioned
inputs, and the consensus picks the same model with the same inlier count
when both get the same minimal sets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.camera import CameraIntrinsics as JIntrinsics
from cv_tpu.camera import essential as jess
from cv_tpu.consensus import BatchConsensus as JConsensus
from cv_tpu.consensus import Estimator as JEstimator
from cv_tpu.core import Isometry3 as JIso
from cv_tpu.core import camera_to_camera_residual as j_residual
from cv_tpu.core import lie as jlie
from cv_tpu.ops import eigen as jeig
from cv_tpu.solvers import eight_point as j8
from cv_tpu_torch.camera import CameraIntrinsics as TIntrinsics
from cv_tpu_torch.camera import essential as tess
from cv_tpu_torch.consensus import BatchConsensus as TConsensus
from cv_tpu_torch.consensus import Estimator as TEstimator
from cv_tpu_torch.core import Isometry3 as TIso
from cv_tpu_torch.core import camera_to_camera_residual as t_residual
from cv_tpu_torch.core import lie as tlie
from cv_tpu_torch.ops import eigen as teig
from cv_tpu_torch.solvers import eight_point as t8
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)

TOL = 1e-9


def _sym(rng, shape, n):
    a = rng.normal(size=shape + (n, n))
    return a + np.swapaxes(a, -1, -2)


def _scene(seed, n=40, outliers=0, noise=1e-4, spread=2.0, depth=(4.0, 10.0)):
    """Bearings of random points seen from two poses (A at the origin), with
    a little noise: exact bearings make every eight-point essential matrix
    exactly rank 2, where the SVD's last left vector is a completion chosen
    by a threshold that rounding noise straddles."""
    rng = np.random.default_rng(seed)
    rot = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(scale=0.1, size=3))))
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    pts = rng.uniform([-spread, -spread, depth[0]], [spread, spread, depth[1]], (n, 3))
    a = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    pb = pts @ rot.T + t
    b = pb / np.linalg.norm(pb, axis=1, keepdims=True) + rng.normal(scale=noise, size=(n, 3))
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    if outliers:
        b[:outliers] = rng.normal(size=(outliers, 3)) + [0, 0, 4]
        b[:outliers] /= np.linalg.norm(b[:outliers], axis=1, keepdims=True)
    return a, b


@pytest.fixture(autouse=True, scope="module")
def _cheap_consensus():
    """On a CPU the exact forms of this module's consensus runs and solver
    batches cost tens of times the cheap ones (``scripts/cpu_costs.py``):
    the module opts into the cheap CPU forms (``ops.eigen.cheap_on_cpu``,
    within a few ulps of cv_tpu's bits), which every CPU caller took before
    the exact forms became the default."""
    with teig.cheap_on_cpu():
        yield


@pytest.mark.parametrize("n", [3, 4, 9])
def test_eigh_small_matches_reference(n):
    a = _sym(np.random.default_rng(n), (50,), n)
    wj, vj = jeig.eigh_small(jnp.asarray(a), sweeps=8)
    wt, vt = teig.eigh_small(torch.as_tensor(a), sweeps=8)
    # bit for bit: glibc's trigonometry and XLA's fused updates (tests/test_torch_eigen.py)
    np.testing.assert_array_equal(wt.numpy().view(np.uint64), np.asarray(wj).view(np.uint64))
    np.testing.assert_array_equal(vt.numpy().view(np.uint64), np.asarray(vj).view(np.uint64))
    # and a true decomposition, as torch.linalg computes it
    np.testing.assert_allclose(wt.numpy(), torch.linalg.eigvalsh(torch.as_tensor(a)).numpy(), atol=1e-9)


@pytest.mark.parametrize("rank2", [False, True])
def test_svd3_matches_reference(rank2):
    rng = np.random.default_rng(1)
    e = rng.normal(size=(40, 3, 3))
    if rank2:
        # The essential-matrix case.  The smallest singular value's left
        # vector is then a cross-product completion chosen by a threshold
        # that rounding noise straddles, so only the factorization is held.
        e = e @ np.diag([1.0, 1.0, 0.0])
    uj, sj, vj = jeig.svd3(jnp.asarray(e))
    ut, st, vt = teig.svd3(torch.as_tensor(e))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-7)
    if not rank2:
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-6)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6)
    recon = (ut * st[..., None, :]) @ vt
    np.testing.assert_allclose(recon.numpy(), e, atol=1e-7)


def test_isometry():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(10, 3))
    rot, tr = np.asarray(jlie.so3_exp(jnp.asarray(w))), rng.normal(size=(10, 3))
    p = rng.normal(size=(10, 4))
    ji = JIso(rotation=jnp.asarray(rot), translation=jnp.asarray(tr))
    ti = TIso.from_numpy(rot, tr)
    np.testing.assert_allclose(ti.transform(torch.as_tensor(p)).numpy(), np.asarray(ji.transform(jnp.asarray(p))), atol=TOL)
    inv_t, inv_j = ti.inverse().to_numpy(), ji.inverse()
    np.testing.assert_allclose(inv_t[0], np.asarray(inv_j.rotation), atol=TOL)
    np.testing.assert_allclose(inv_t[1], np.asarray(inv_j.translation), atol=TOL)
    comp = ti.compose(ti.inverse()).to_numpy()
    np.testing.assert_allclose(comp[0], np.broadcast_to(np.eye(3), (10, 3, 3)), atol=TOL)


def test_calibrate():
    vals = (9.842439e2, 9.808141e2, 6.9e2, 2.331966e2)
    ji, ti = JIntrinsics.from_values(*vals), TIntrinsics.from_values(*vals)
    px = np.random.default_rng(3).uniform([0, 0], [1392, 512], (30, 2))
    bj = np.asarray(ji.calibrate(jnp.asarray(px)))
    bt = ti.calibrate(torch.as_tensor(px))
    np.testing.assert_allclose(bt.numpy(), bj, atol=TOL)
    np.testing.assert_allclose(torch.linalg.vector_norm(bt, dim=-1).numpy(), 1.0, atol=1e-15)
    for a, b in zip(TIntrinsics.from_numpy(*ti.to_numpy()).to_numpy(), ti.to_numpy()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_eight_point_models_match(seed):
    """The essential matrices (the nullspace vectors) within 1e-9.  The
    four poses decomposed from them only within 1e-6: an essential matrix
    has two equal singular values, so the SVD's first two left vectors are
    fixed only up to rounding, and rounding differences reach the poses
    amplified (measured up to 5e-7 on near-exact data)."""
    a, b = _scene(seed, noise=1e-2, spread=4.0, depth=(3.0, 6.0))
    idx = _minimal_sets(seed, len(a), 64)
    ej = np.asarray(j8.essential_from_matches(jnp.asarray(a[idx]), jnp.asarray(b[idx])))
    et = t8.essential_from_matches(torch.as_tensor(a[idx]), torch.as_tensor(b[idx])).numpy()
    np.testing.assert_allclose(et, ej, atol=TOL)
    mj = j8.estimate(jnp.asarray(a[idx]), jnp.asarray(b[idx]))
    mt = t8.estimate(torch.as_tensor(a[idx]), torch.as_tensor(b[idx]))
    assert tuple(mt.rotation.shape) == (64, 4, 3, 3)
    np.testing.assert_allclose(mt.rotation.numpy(), np.asarray(mj.rotation), atol=1e-6)
    np.testing.assert_allclose(mt.translation.numpy(), np.asarray(mj.translation), atol=1e-6)


def test_essential_decomposition():
    a, b = _scene(4)
    e = np.asarray(j8.essential_from_matches(jnp.asarray(a[:12]), jnp.asarray(b[:12])))
    pj = jess.possible_unscaled_poses(jnp.asarray(e))
    pt = tess.possible_unscaled_poses(torch.tensor(e))
    np.testing.assert_allclose(pt.rotation.numpy(), np.asarray(pj.rotation), atol=TOL)
    np.testing.assert_allclose(pt.translation.numpy(), np.asarray(pj.translation), atol=TOL)


def test_camera_to_camera_residual():
    a, b = _scene(5, n=30, outliers=5)
    idx = _minimal_sets(5, 30, 16)
    mj = j8.estimate(jnp.asarray(a[idx]), jnp.asarray(b[idx]))
    rot, tr = np.asarray(mj.rotation)[..., None, :, :], np.asarray(mj.translation)[..., None, :]
    rj = np.asarray(j_residual(JIso(jnp.asarray(rot), jnp.asarray(tr)), jnp.asarray(a), jnp.asarray(b)))
    rt = t_residual(TIso.from_numpy(rot, tr), torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert rt.shape == (16, 4, 30)
    np.testing.assert_allclose(rt, rj, atol=TOL)


def _minimal_sets(seed, n_rows, n_sets):
    """Minimal sets of 8 distinct rows."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n_rows)[:8] for _ in range(n_sets)])


def _estimators():
    def residual(mod_iso, fn):
        return lambda m, d: fn(
            mod_iso(m.rotation[..., None, :, :], m.translation[..., None, :]), d[0], d[1]
        )

    je = JEstimator(8, 4, lambda s: j8.estimate(s[0], s[1]), residual(JIso, j_residual))
    te = TEstimator(8, 4, lambda s: t8.estimate(s[0], s[1]), residual(TIso, t_residual))
    return je, te


@pytest.mark.parametrize("seed", [0, 3])
def test_score_stage_same_best(seed):
    """Given the same minimal sets, the lexicographic scoring picks the same
    model with the same inlier count and mask."""
    a, b = _scene(seed, n=40, outliers=12)
    idx = _minimal_sets(seed, 40, 128)
    je, te = _estimators()
    jc, tc = JConsensus(threshold=1e-6, hypotheses=128), TConsensus(threshold=1e-6, hypotheses=128, device="cpu")
    valid = np.arange(40) < 36  # the last 4 rows are padding
    jm = je.estimate((jnp.asarray(a[idx]), jnp.asarray(b[idx])))
    mj, maskj, cj, totj = jc._score_stage(je, jm, (jnp.asarray(a), jnp.asarray(b)), jnp.asarray(valid))
    tm = tc._estimate_stage(te, (torch.as_tensor(a), torch.as_tensor(b)), torch.as_tensor(idx))
    mt, maskt, ct, tott = tc._score_stage(te, tm, (torch.as_tensor(a), torch.as_tensor(b)), torch.as_tensor(valid))
    assert int(ct) == int(cj) >= 8
    np.testing.assert_array_equal(maskt.numpy(), np.asarray(maskj))
    np.testing.assert_allclose(mt.rotation.numpy(), np.asarray(mj.rotation), atol=TOL)
    np.testing.assert_allclose(float(tott), float(totj), atol=TOL)


def test_prescore_stage_same_survivors():
    a, b = _scene(6, n=40, outliers=10)
    idx = _minimal_sets(6, 40, 96)
    je, te = _estimators()
    jc = JConsensus(threshold=1e-6, hypotheses=96, prescore_matches=16, prescore_keep=32)
    tc = TConsensus(threshold=1e-6, hypotheses=96, prescore_matches=16, prescore_keep=32, device="cpu")
    valid = np.ones(40, bool)
    key = jax.random.key(7)
    # The reference draws its block from the key inside the stage; hand the
    # port the same block.
    g = jax.random.gumbel(key, (40,))
    _, block = jax.lax.top_k(jnp.where(jnp.asarray(valid), g, -jnp.inf), 16)
    jm = je.estimate((jnp.asarray(a[idx]), jnp.asarray(b[idx])))
    kept_j = jc._prescore_stage(key, je, jm, (jnp.asarray(a), jnp.asarray(b)), jnp.asarray(valid))
    tm = te.estimate((torch.as_tensor(a[idx]), torch.as_tensor(b[idx])))
    kept_t = tc._prescore_stage(
        te, tm, (torch.as_tensor(a), torch.as_tensor(b)), torch.as_tensor(valid),
        torch.tensor(np.asarray(block)),
    )
    assert tuple(kept_t.rotation.shape) == (32, 1, 3, 3)
    np.testing.assert_allclose(kept_t.rotation.numpy(), np.asarray(kept_j.rotation), atol=TOL)


def test_model_inliers_recovers_motion():
    """The port's own draws (explicit generator) find every inlier of a
    scene with outliers, as the reference does with its key."""
    a, b = _scene(8, n=40, outliers=8)
    _, te = _estimators()
    g = torch.Generator().manual_seed(0)
    model, mask, count = TConsensus(threshold=1e-6, hypotheses=256, device="cpu").model_inliers(
        g, te, (torch.as_tensor(a), torch.as_tensor(b))
    )
    assert int(count) == 32
    assert not mask[:8].any() and mask[8:].all()
    je, _ = _estimators()
    _, _, count_j = JConsensus(threshold=1e-6, hypotheses=256).model_inliers(
        jax.random.key(0), je, (jnp.asarray(a), jnp.asarray(b))
    )
    assert int(count_j) == int(count)


LEFTOVER_TOL = 1e-12


def _poses(seed, n=10):
    rng = np.random.default_rng(seed)
    rot = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(scale=0.5, size=(n, 3)))))
    tr = rng.normal(size=(n, 3))
    return rng, rot, tr


def test_so3_bracket_se3_homogeneous():
    rng, rot, tr = _poses(11)
    a, b = rng.normal(size=(2, 10, 3))
    np.testing.assert_allclose(tlie.so3_bracket(torch.tensor(a), torch.tensor(b)).numpy(),
                               np.asarray(jlie.so3_bracket(jnp.asarray(a), jnp.asarray(b))), atol=LEFTOVER_TOL, rtol=0)
    ji, ti = JIso(rotation=jnp.asarray(rot), translation=jnp.asarray(tr)), TIso.from_numpy(rot, tr)
    np.testing.assert_allclose(ti.se3().numpy(), np.asarray(ji.se3()), atol=LEFTOVER_TOL, rtol=0)
    np.testing.assert_allclose(ti.homogeneous().numpy(), np.asarray(ji.homogeneous()), atol=LEFTOVER_TOL, rtol=0)


def test_transform_jacobians():
    rng, rot, tr = _poses(12)
    hp = rng.normal(size=(10, 4))
    ji, ti = JIso(rotation=jnp.asarray(rot), translation=jnp.asarray(tr)), TIso.from_numpy(rot, tr)
    got = ti.transform_jacobians(torch.tensor(hp))
    want = ji.transform_jacobians(jnp.asarray(hp))
    assert [tuple(g.shape) for g in got] == [(10, 4), (10, 4, 4), (10, 4, 6)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LEFTOVER_TOL, rtol=0)


@pytest.mark.parametrize("k1", [0.0, -0.28052513, 0.1])
def test_uncalibrate_round_trip(k1):
    """Both intrinsics' ``uncalibrate`` on the bearings of pixels (and on
    bearings behind the camera and at z = 0), against cv_tpu's."""
    from cv_tpu.camera import CameraIntrinsicsK1Distortion as JK1
    from cv_tpu_torch.camera import CameraIntrinsicsK1Distortion as TK1

    vals = (893.39010814, 898.32648616, 951.1310043, 555.13350077, 0.5)
    ji, ti = JIntrinsics.from_values(*vals), TIntrinsics.from_values(*vals)
    px = np.random.default_rng(13).uniform([0, 0], [1920, 1080], (40, 2))
    models = ((ji, ti), (JK1.new(ji, k1), TK1.new(ti, k1)))
    for jm, tm in models:
        bearing = np.array(jm.calibrate(jnp.asarray(px)))
        bearing[:3, 2] *= -1.0
        bearing[3, 2] = 0.0
        pj, vj = jm.uncalibrate(jnp.asarray(bearing))
        pt, vt = tm.uncalibrate(torch.tensor(bearing))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=LEFTOVER_TOL, rtol=0)
        if k1 == 0.0 or tm is ti:
            np.testing.assert_allclose(pt.numpy()[4:], px[4:], atol=1e-9)


def test_pose_reprojection_error():
    from cv_tpu.camera.pinhole import pose_reprojection_error as j_error
    from cv_tpu_torch.camera.pinhole import pose_reprojection_error as t_error

    rng, rot, tr = _poses(14, n=1)
    rot, tr = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.05, 0.01]))), np.array([-0.6, 0.05, 0.1])
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (30, 3))
    pts[:4, 2] *= -1.0  # behind camera A
    a = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    pb = pts @ rot.T + tr + rng.normal(scale=1e-3, size=pts.shape)
    b = pb / np.linalg.norm(pb, axis=1, keepdims=True)
    pose_j = JIso(rotation=jnp.asarray(rot), translation=jnp.asarray(tr))
    pose_t = TIso.from_numpy(rot, tr)
    ej, okj = j_error(pose_j, jnp.asarray(a), jnp.asarray(b))
    et, okt = t_error(pose_t, torch.tensor(a), torch.tensor(b))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert 0 < np.asarray(okj).sum() < len(a)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=LEFTOVER_TOL, rtol=0)


def test_recondition_and_bearing_poses():
    a, b = _scene(15, noise=1e-2)
    e = np.asarray(j8.essential_from_matches(jnp.asarray(a[:12]), jnp.asarray(b[:12])))
    e = e + np.random.default_rng(15).normal(scale=1e-2, size=e.shape)
    np.testing.assert_allclose(tess.recondition(torch.tensor(e)).numpy(), np.asarray(jess.recondition(jnp.asarray(e))),
                               atol=LEFTOVER_TOL, rtol=0)
    pj = jess.possible_unscaled_poses_bearing(jnp.asarray(e))
    pt = tess.possible_unscaled_poses_bearing(torch.tensor(e))
    assert tuple(pt.rotation.shape) == tuple(pj.rotation.shape)
    np.testing.assert_allclose(pt.rotation.numpy(), np.asarray(pj.rotation), atol=LEFTOVER_TOL, rtol=0)
    np.testing.assert_allclose(pt.translation.numpy(), np.asarray(pj.translation), atol=LEFTOVER_TOL, rtol=0)
