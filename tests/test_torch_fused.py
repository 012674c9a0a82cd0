"""The contractions of XLA's CPU code and the IEEE square root in the port,
against cv_tpu on a CPU.

Where ``cv_tpu`` runs under a jit, XLA's CPU backend contracts a product
into the sum that takes it (one rounding, the x86 ``vfmadd``): the first
product of a pair, or the next product of a reduction.  The port writes
those fused operations out (``ops.trig.fma``, ``dot_fused``) in:

* the consensus residual's design, point and bearings
  (``core.pose.c2c_residual_plain``, under the jit of
  ``cv_tpu/consensus/batch.py::_score_stage``);
* ``svd3``'s ``E^T E``, ``E V``, cross products and norms, eight-point's
  and five-point's normal matrices (``ops.eigen.gram_fused``);
* the resident pose kernels' Rodrigues and pose update in interpret mode
  (``optimize.optimizers._apply_tangent_l2``);

and takes the correctly rounded square root (``ops.trig.sqrt``) where
PyTorch's CPU ``sqrt`` is an ulp off.  Each test
states the share of outputs that were bitwise before the repair (the
parent commit's code, on an x86-64 CPU with FMA) and after it.  Inputs are made with NumPy from
seeds and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.camera.pinhole import CameraIntrinsics as JIntrinsics
from cv_tpu.camera.pinhole import CameraIntrinsicsK1Distortion as JK1
from cv_tpu.consensus.batch import BatchConsensus as JConsensus
from cv_tpu.core import Isometry3 as JIso
from cv_tpu.core import projective as jproj
from cv_tpu.core import smallmat
from cv_tpu.ops import eigen as jeig
from cv_tpu.optimize import pallas_loop
from cv_tpu.sfm.engine import DEFAULT_ESSENTIAL_ESTIMATOR as JEST
from cv_tpu.sfm.se3 import so3_exp
from cv_tpu.solvers import eight_point as j8
from cv_tpu.solvers import nister_stewenius as j5
from cv_tpu_torch.camera.pinhole import CameraIntrinsics as TIntrinsics
from cv_tpu_torch.camera.pinhole import CameraIntrinsicsK1Distortion as TK1
from cv_tpu_torch.consensus import BatchConsensus as TConsensus
from cv_tpu_torch.consensus import Estimator as TEstimator
from cv_tpu_torch.core import Isometry3 as TIso
from cv_tpu_torch.core import camera_to_camera_residual, projective
from cv_tpu_torch.ops import eigen, trig
from cv_tpu_torch.optimize import optimizers
from cv_tpu_torch.solvers import eight_point, nister_stewenius
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bits = np.uint32 if got.dtype == np.float32 else np.uint64
    bad = (got.view(bits) != want.view(bits)) & ~nan
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} differ, first at {np.argwhere(bad)[:3].tolist()}"


# ---------------------------------------------------------------------------
# The consensus residual
# ---------------------------------------------------------------------------

# The 11 KITTI matches' calibrated bearings (the port's CPU pipeline of
# tests/test_torch_kitti.py: Akaze.sparse(), 512 features, the Lowes ratio
# 0.5, KITTI_INTRINSICS), recorded as exact hexadecimal doubles.
KITTI_A = [
    ["-0x1.54f86c0ac86f7p-9", "-0x1.9bcd4b1ed7e94p-5", "0x1.ff59d84bf5774p-1"],
    ["-0x1.af5aab02da31fp-5", "-0x1.68b9aa5cd4b77p-4", "0x1.fd4c2d486908dp-1"],
    ["-0x1.008094913c216p-4", "-0x1.6ecd77a7cee89p-4", "0x1.fcef14c6d661bp-1"],
    ["-0x1.f5e72deab6da7p-5", "-0x1.6bc0d3049ab99p-4", "0x1.fd02e74682d8bp-1"],
    ["-0x1.2c852c3164ac2p-5", "-0x1.2f0e61b27bfefp-4", "0x1.fe404718e6d64p-1"],
    ["0x1.09297415c7c50p-5", "-0x1.705c99949791cp-5", "0x1.ff36ac1dc5758p-1"],
    ["-0x1.62bfa89bb2adcp-7", "-0x1.973f2838ec47dp-5", "0x1.ff563f09147f8p-1"],
    ["-0x1.9088d71e36297p-7", "-0x1.369a5eee41794p-6", "0x1.ffdea6969f61fp-1"],
    ["-0x1.3a835fa337b1dp-7", "-0x1.4e88bfea5fc55p-11", "0x1.fff9ef8801bf3p-1"],
    ["-0x1.3c604490d9cb6p-3", "-0x1.016638eb6c2c6p-3", "0x1.f5be838f64cc7p-1"],
    ["-0x1.5afe99c025e2bp-6", "-0x1.7c6fa979c6f6ep-5", "0x1.ff55273f97b2ap-1"],
]
KITTI_B = [
    ["-0x1.3ec9dfecfad2ep-6", "-0x1.0621ccfa6f692p-4", "0x1.feda73027e48ap-1"],
    ["-0x1.3b8405932d707p-4", "-0x1.b1d8db161a0a3p-4", "0x1.fb9705d1f4482p-1"],
    ["-0x1.6682d1f1c7bacp-4", "-0x1.b7ee2643f46a3p-4", "0x1.fb0fd284e3b05p-1"],
    ["-0x1.60f3749b4ed82p-4", "-0x1.b4d66ec65ad5fp-4", "0x1.fb2a1e0a7fcbbp-1"],
    ["-0x1.e8bd6744333cep-5", "-0x1.715af22e70988p-4", "0x1.fcff93651daf8p-1"],
    ["0x1.289a76aad34d3p-6", "-0x1.c643454f5d182p-5", "0x1.ff20d0572124ap-1"],
    ["-0x1.ae793773bc47dp-6", "-0x1.05c37edf369fcp-4", "0x1.fec6ba3c1c6e0p-1"],
    ["-0x1.0132224d8f839p-5", "-0x1.bfb9c91e74376p-6", "0x1.ff8e695489e97p-1"],
    ["-0x1.df83911b30ab9p-6", "-0x1.2666f2b0ed152p-7", "0x1.ffc28f33fdd91p-1"],
    ["-0x1.a9f2590b0cbddp-3", "-0x1.46ff06e2d8e8bp-3", "0x1.ee1632fd0330dp-1"],
    ["-0x1.3303709101ddep-5", "-0x1.f22a8394acc39p-5", "0x1.feb12bd8ad048p-1"],
]


def _kitti():
    return tuple(np.array([[float.fromhex(x) for x in row] for row in rows]) for rows in (KITTI_A, KITTI_B))


def _scene(seed, n=12):
    """``n`` bearing pairs of a two-view scene: inliers, outliers, and the
    degenerate rows (a == b, a zero bearing, a NaN, an infinite entry)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-3, -2, 4], [3, 2, 10], (n, 3))
    rot, t = so3_exp(rng.uniform(-0.1, 0.1, 3)), rng.uniform(-0.5, 0.5, 3)
    cam = pts @ rot.T + t
    a = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    b = cam / np.linalg.norm(cam, axis=1, keepdims=True)
    b[1::4] = rng.standard_normal((len(b[1::4]), 3))
    b[1::4] /= np.linalg.norm(b[1::4], axis=1, keepdims=True)
    b[2] = a[2]
    a[3] = 0.0
    b[5, 1] = np.nan
    a[6, 0] = np.inf
    return a, b


def _models(a, b, seed, sets):
    """cv_tpu's jitted eight-point on ``sets`` minimal sets of the finite
    rows, plus a zero translation and a NaN rotation: ``(sets, 4)`` poses."""
    rng = np.random.default_rng(seed + 100)
    ok = np.flatnonzero(np.isfinite(a).all(1) & np.isfinite(b).all(1) & (np.abs(a).sum(1) > 0))
    idx = np.stack([rng.choice(ok, 8, replace=False) for _ in range(sets)])
    m = jax.jit(j8.estimate)(jnp.asarray(a[idx]), jnp.asarray(b[idx]))
    rot, tr = np.array(m.rotation), np.array(m.translation)
    tr[0, 1] = 0.0
    rot[1, 2, 0, 0] = np.nan
    return rot, tr


_JIT_RESIDUAL = jax.jit(lambda r, t, a, b: JEST.residual(JIso(rotation=r, translation=t), (a, b)))


def _port_residual(rot, tr, a, b, dtype=torch.float64):
    t = lambda x: torch.as_tensor(x, dtype=dtype)  # noqa: E731
    pose = TIso(t(rot)[..., None, :, :], t(tr)[..., None, :])
    return camera_to_camera_residual(pose, t(a), t(b)).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_residual_bitwise_to_the_jitted_scoring(seed):
    """The residual of 8 x 4 models against 12 rows (384 pairs, degenerate
    and non-finite ones among them) with the exact Jacobi: bitwise to
    ``cv_tpu``'s as its scoring jit computes it.  Before (the parent's
    design and square roots, its Jacobi made exact): 69.5% (seed 0) and
    65.6% (seed 1) of the pairs; after: 100%."""
    a, b = _scene(seed)
    rot, tr = _models(a, b, seed, 8)
    want = np.asarray(_JIT_RESIDUAL(rot, tr, a, b))
    got = _port_residual(rot, tr, a, b)
    assert (want == 2.0).any() and (want < 2.0).any()
    _same_bits(got, want)


def test_residual_bitwise_on_the_kitti_consensus():
    """The KITTI pair's 11 matches against 128 x 4 eight-point models (5,632
    pairs): bitwise to the jitted scoring.  Before: 71.9%; after: 100%.
    The scoring stage then keeps the same model, mask and count."""
    a, b = _kitti()
    rot, tr = _models(a, b, 7, 128)
    rot, tr = rot[2:], tr[2:]  # the finite models: the scoring's sums need them
    want = np.asarray(_JIT_RESIDUAL(rot, tr, a, b))
    _same_bits(_port_residual(rot, tr, a, b), want)
    valid = np.ones(len(a), bool)
    jm, jmask, jcount, _ = JConsensus(threshold=1e-3, hypotheses=1)._score_stage(
        JEST, JIso(rotation=jnp.asarray(rot), translation=jnp.asarray(tr)), (jnp.asarray(a), jnp.asarray(b)),
        jnp.asarray(valid))
    est = TEstimator(8, 4, None, lambda m, d: camera_to_camera_residual(
        TIso(m.rotation[..., None, :, :], m.translation[..., None, :]), d[0], d[1]))
    tm, tmask, tcount, _ = TConsensus(threshold=1e-3, hypotheses=1, device="cpu")._score_stage(
        est, TIso(torch.as_tensor(rot), torch.as_tensor(tr)), (torch.as_tensor(a), torch.as_tensor(b)),
        torch.as_tensor(valid))
    assert int(tcount) == int(jcount) == 11
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    _same_bits(tm.rotation.numpy(), np.asarray(jm.rotation))


@pytest.mark.parametrize("scale", [1e-155, 3e-160])
def test_residual_bitwise_on_poses_near_underflow(scale):
    """Poses scaled to ~1e-155 put the design's products and the rotated
    points' squares below the normal range, where the jitted scoring runs
    under XLA's flush-to-zero and denormals-are-zero: the plain residual
    flushes at the same steps (and its fused operations are exact there,
    ``trig.fma_f64``), bitwise to cv_tpu's on 10 x 4 models against 40
    rows.  Without the flushes 86 to 135 of 1,600 pairs differed on four
    such scenes at 1e-155."""
    a, b = _scene(4, n=40)
    rot, tr = _models(a, b, 4, 12)
    rot, tr = rot[2:] * scale, tr[2:] * scale
    want = np.asarray(_JIT_RESIDUAL(rot, tr, a, b))
    assert (want < 2.0).sum() > 1000
    _same_bits(_port_residual(rot, tr, a, b), want)


def test_residual_float32_bitwise_to_the_jitted_scoring():
    """The same in float32 (the round-to-odd form of each fused operation).
    Before: 62.5%; after: 100%."""
    a, b = _scene(3)
    rot, tr = _models(a, b, 3, 8)
    f = np.float32
    want = np.asarray(_JIT_RESIDUAL(rot.astype(f), tr.astype(f), a.astype(f), b.astype(f)))
    _same_bits(_port_residual(rot, tr, a, b, torch.float32), want)


def test_residual_plain_on_an_expanded_broadcast():
    """A pose batch broadcast against matches of its own batch shape: the
    same bits as the (models, 1) x (rows,) layout."""
    a, b = _scene(4)
    rot, tr = _models(a, b, 4, 3)
    grid = _port_residual(rot, tr, a, b)  # (3, 4, 12)
    t = torch.as_tensor
    pose = TIso(t(rot)[:, :, None].expand(3, 4, 12, 3, 3), t(tr)[:, :, None].expand(3, 4, 12, 3))
    paired = camera_to_camera_residual(pose, t(a).expand(3, 4, 12, 3), t(b).expand(3, 4, 12, 3))
    _same_bits(paired.numpy(), grid)


# ---------------------------------------------------------------------------
# svd3, eight-point and five-point
# ---------------------------------------------------------------------------


def _essential_like(rng, k):
    e = rng.standard_normal((k, 3, 3))
    u, _, vt = np.linalg.svd(rng.standard_normal((k, 3, 3)))
    rank2 = u @ np.diag([1.0, 0.7, 0.0]) @ vt
    rank1 = u[:4] @ np.diag([1.0, 0.0, 0.0]) @ vt[:4]
    return np.concatenate([e, rank2, rank1, np.zeros((2, 3, 3))])


def test_svd3_bitwise_to_cv_tpu():
    """``E^T E`` by ``gram_fused`` and ``svd3``'s u, s, vt with the exact
    Jacobi on 1,000 general, 1,000 rank-2, 4 rank-1 and 2 zero matrices:
    bitwise to cv_tpu's jitted ``svd3``.  Before (the parent's matmul and
    square root, its Jacobi made exact): ``E^T E`` 69.5%, u 39.9%, s 64.2%,
    vt 54.1%; after: 100%."""
    e = _essential_like(np.random.default_rng(11), 1000)
    want = jax.jit(lambda m: jnp.sum(m[..., :, :, None] * m[..., :, None, :], axis=-3))(jnp.asarray(e))
    _same_bits(eigen.gram_fused(torch.as_tensor(e)).numpy(), want)
    got = eigen.svd3(torch.as_tensor(e))
    for g, ref in zip(got, jeig.svd3(jnp.asarray(e))):
        _same_bits(g.numpy(), ref)


def test_exact_on_cpu_is_scoped():
    """The CPU callers are exact by default; the one opt-in into their
    cheap forms, ``eigen.cheap_on_cpu``, holds only inside its block, an
    exception included, and only for CPU tensors.  ``exact_on_cpu`` is
    gone."""
    cpu, meta = torch.zeros(1), torch.zeros(1, device="meta")
    assert not hasattr(eigen, "exact_on_cpu")
    assert eigen._exact(cpu) and not eigen._cheap(cpu) and not eigen._exact(meta)
    with eigen.cheap_on_cpu():
        assert eigen._cheap(cpu) and not eigen._exact(cpu) and not eigen._cheap(meta)
        with eigen.cheap_on_cpu():
            pass
        assert eigen._cheap(cpu)
    with pytest.raises(RuntimeError):
        with eigen.cheap_on_cpu():
            raise RuntimeError
    assert eigen._exact(cpu) and not eigen._cheap(cpu)


def test_eight_point_normal_matrix_and_essential_bitwise():
    """Eight-point's 9x9 normal matrix (``gram_fused`` against
    ``smallmat.matmul_tn``) and its essential matrices with the exact
    Jacobi, on 200 minimal sets: bitwise to cv_tpu's jitted ones.  Before:
    the parent's matmul gave 100% of the normal matrices on this CPU (its
    BLAS accumulates with fused operations in the same order; the order is
    now the port's own), its unfused sweep 0% of the essential matrices
    (ROADMAP); after: 100%, the CPU default since ``eigen.exact_on_cpu``
    went."""
    rng = np.random.default_rng(12)
    a, b = rng.standard_normal((200, 8, 3)), rng.standard_normal((200, 8, 3))
    rows = j8.encode_epipolar_equation(jnp.asarray(a), jnp.asarray(b))
    want = jax.jit(lambda r: smallmat.matmul_tn(r, r))(rows)
    got = eigen.gram_fused(eight_point.encode_epipolar_equation(torch.as_tensor(a), torch.as_tensor(b)))
    _same_bits(got.numpy(), want)
    want_e = jax.jit(j8.essential_from_matches)(jnp.asarray(a), jnp.asarray(b))
    got_e = eight_point.essential_from_matches(torch.as_tensor(a), torch.as_tensor(b))
    _same_bits(got_e.numpy(), want_e)


def test_five_point_nullspace_bitwise():
    """Five-point's float64 nullspace basis (the Gram by ``gram_fused``, the
    exact Jacobi) on 200 sets: bitwise to cv_tpu's jitted one, the same
    ``ok``.  Before: 100% with the parent's matmul and its Jacobi made
    exact (as for eight-point), 0% with its unfused sweep; after: 100%, the
    CPU default."""
    rng = np.random.default_rng(13)
    a, b = rng.standard_normal((200, 5, 3)), rng.standard_normal((200, 5, 3))
    jb, jok = jax.jit(j5.nullspace_basis)(jnp.asarray(a), jnp.asarray(b))
    tb, tok = nister_stewenius.nullspace_basis(torch.as_tensor(a), torch.as_tensor(b))
    _same_bits(tb.numpy(), jb)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


# ---------------------------------------------------------------------------
# The resident pose kernels' Rodrigues and update
# ---------------------------------------------------------------------------


def _tangents(seed, k=20_000):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, k)) * np.exp(rng.uniform(-8, 0, k))).astype(np.float32)


def test_pose_update_contractions():
    """Given the same exp(dr), the update's products (``_m3_mul``,
    ``_m3_vec``) fused as interpret mode fuses them: bitwise on 20,000
    poses.  Before (the parent's matmul and sums): 78.1% of the entries;
    after: 100%."""
    rng = np.random.default_rng(22)
    k = 20_000
    d = np.stack([np.asarray(x) for x in jax.jit(lambda v: pallas_loop._rodrigues(tuple(v)))(_tangents(23, k))])
    r = np.stack([so3_exp(v) for v in rng.uniform(-1, 1, (k, 3))], -1).reshape(9, k).astype(np.float32)
    t, dt = (rng.standard_normal((3, k)).astype(np.float32) for _ in range(2))
    rj, tj = jax.jit(lambda d, r, t, dt: (pallas_loop._m3_mul(tuple(d), tuple(r)), tuple(
        x + y for x, y in zip(pallas_loop._m3_vec(tuple(d), tuple(t)), pallas_loop._m3_vec(tuple(d), tuple(dt))))))(
        d, r, t, dt)
    dd = torch.as_tensor(d.T)
    vecs = torch.as_tensor(np.stack([r[0::3], r[1::3], r[2::3], t, dt]).transpose(2, 0, 1))  # (k, 5, 3)
    out = optimizers._m3_vec_fused(dd, vecs)
    _same_bits(out[:, :3].transpose(-1, -2).reshape(k, 9).numpy().T, np.stack([np.asarray(x) for x in rj]))
    _same_bits((out[:, 3] + out[:, 4]).numpy().T, np.stack([np.asarray(x) for x in tj]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pose_update_scalar_form_bitwise_to_the_tensor_form(dtype):
    """``_apply_tangent_scalar`` (one pose in Python floats through the C
    library, what the plain loops take for a single pose) against the tensor
    form ``_apply_tangent_l2``, on 3,000 tangents of log-uniform size (about
    a third in Rodrigues' Taylor branch, a zero among them): bitwise,
    with the batch in one call (the written-out fused operations and trig)
    and pose by pose as batches of one (the C library's small-call path)."""
    lib = trig._libm()
    assert lib is not None
    rng = np.random.default_rng(41)
    k = 3000
    r = rng.standard_normal((k, 3)) * np.exp(rng.uniform(-30 if dtype == torch.float64 else -13, 1, (k, 1)))
    r[0] = 0.0
    rot = np.stack([so3_exp(v) for v in rng.uniform(-2, 2, (k, 3))])
    t, tr = (rng.standard_normal((k, 3)) for _ in range(2))
    r, rot, t, tr = (torch.as_tensor(x, dtype=dtype) for x in (r, rot, t, tr))
    theta2 = (r.double() ** 2).sum(-1)
    taylor = float((theta2 <= torch.finfo(dtype).eps).double().mean())
    assert 0.2 < taylor < 0.5, taylor
    batch = optimizers._apply_tangent_l2(t, r, TIso(rot, tr))
    ones = [optimizers._apply_tangent_l2(t[i:i + 1], r[i:i + 1], TIso(rot[i:i + 1], tr[i:i + 1]))
            for i in range(0, k, 15)]
    scalar = [optimizers._apply_tangent_scalar(t[i], r[i], TIso(rot[i], tr[i]), lib) for i in range(k)]
    for name in ("rotation", "translation"):
        want = torch.stack([getattr(p, name) for p in scalar])
        _same_bits(getattr(batch, name).numpy(), want.numpy())
        _same_bits(torch.cat([getattr(p, name) for p in ones]).numpy(), want[::15].numpy())


# Bitwise shares of the plain loops against the interpret-mode kernels, in
# float32 over four problems a kind (tests/test_torch_optimize.py's, other
# seeds and starting poses), after 1 and 10 steps: (before, after) as
# measured on an x86-64 CPU with FMA (truncated).  What is left: XLA writes ``sin / sqrt(t2s)`` as
# ``sin * rsqrt(t2s)``, lowered to the x86 estimate and Newton steps (bits
# of the processor), and moves Rodrigues' ``b`` into the products it
# scales, in a way that depends on the fusion around it.
KERNEL_SHARES = {
    "single_view": ((0.7708, 0.4583), (0.9583, 0.8125)),
    "three_view": ((0.7604, 0.7083), (0.9791, 0.9166)),
    "adaptive": ((0.6771, 0.5104), (0.7447, 0.6302)),
}


def _kernel_problems(kind, n=4):
    from test_torch_optimize import _single_view_problem, _three_view_problem

    out = []
    for s in range(n):
        rng = np.random.default_rng(100 + s)
        if kind == "single_view":
            p = _single_view_problem(m=64, seed=s)
            p["rot"] = so3_exp(rng.uniform(-0.2, 0.2, 3))
            p["t"] = p["t"] + rng.uniform(-0.1, 0.1, 3)
        elif kind == "three_view":
            p = _three_view_problem(n=32, seed=s, translating=1 if s % 2 else 0)
        else:
            a = _three_view_problem(n=32, seed=2 * s, translating=4 if s % 2 else 0)
            b = _three_view_problem(n=32, seed=2 * s + 1)
            p = {k: np.stack([a[k], b[k]]) for k in a}
        out.append(p)
    return out


# The margin below the measured share that the test allows: about one
# entry of the 48 of the single-view problems.
SHARE_MARGIN = 0.025


@pytest.mark.parametrize("kind", list(KERNEL_SHARES))
def test_plain_loops_nearer_the_interpret_mode_kernels(kind):
    """The plain A, B and C loops (``_apply_tangent_l2``: the contracted
    Rodrigues and update) against the interpret-mode kernels: a bitwise
    share of the pose entries at least the measured one less
    ``SHARE_MARGIN`` after 1 and 10 steps, and above the parent's
    (``KERNEL_SHARES``; the ``rsqrt`` estimate's bits, and with them the
    exact shares, are the processor's)."""
    from test_torch_optimize import _port, _reference

    for steps, (before, after) in zip((1, 10), zip(*KERNEL_SHARES[kind])):
        eq = tot = 0
        for prob in _kernel_problems(kind):
            got = _port(kind, prob, steps, torch.float32)
            ref = _reference(kind, prob, steps, jnp.float32, resident_kernel=True)
            eq += int((got.view(np.uint32) == ref.view(np.uint32)).sum())
            tot += got.size
        assert eq / tot >= max(after - SHARE_MARGIN, before + 1e-9), (kind, steps, eq / tot, before, after)


# ---------------------------------------------------------------------------
# The IEEE square root
# ---------------------------------------------------------------------------


def test_square_roots_are_correctly_rounded():
    """``CameraIntrinsicsK1Distortion.uncalibrate`` (a ``jnp.sqrt``, eager in
    cv_tpu) on 100,000 bearings, among them those where PyTorch's CPU
    ``sqrt`` is an ulp off: bitwise to cv_tpu.  Before (``torch.sqrt``):
    98.82% of the pixels; after (``trig.sqrt``): 100%.  The norms stay
    ``torch.linalg.vector_norm``'s: on a CPU it sums the squares as the
    jitted ``jnp.linalg.norm`` does (``trig.dot_fused``) and takes the IEEE
    root, bit for bit (held here), so ``projective.from_homogeneous`` and
    ``CameraIntrinsics.calibrate`` are bitwise on 100,000 draws each (they
    were before too)."""
    rng = np.random.default_rng(32)
    bear = rng.standard_normal((100_000, 3))
    bear[:, 2] = np.abs(bear[:, 2]) + 0.5
    vals = (718.856, 718.856, 607.1928, 185.2157)
    jc = JK1.new(JIntrinsics.from_values(*vals), -0.05)
    tc = TK1.new(TIntrinsics.from_values(*vals), -0.05)
    (jpx, jvalid), (tpx, tvalid) = jc.uncalibrate(jnp.asarray(bear)), tc.uncalibrate(torch.as_tensor(bear))
    _same_bits(tpx.numpy(), jpx)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    u2 = torch.as_tensor((bear[:, 0] / bear[:, 2]) ** 2 + (bear[:, 1] / bear[:, 2]) ** 2)
    arg = 1.0 + 0.2 * u2
    assert (torch.sqrt(arg).numpy() != np.sqrt(arg.numpy())).any()  # the draws meet torch's misrounding
    rng = np.random.default_rng(30)
    p = rng.standard_normal((100_000, 4)) * np.exp(rng.uniform(-5, 5, (100_000, 1)))
    _same_bits(projective.from_homogeneous(torch.as_tensor(p)).numpy(), jproj.from_homogeneous(jnp.asarray(p)))
    px = rng.uniform(0, 1400, (100_000, 2))
    want = np.asarray(JIntrinsics.from_values(*vals).calibrate(jnp.asarray(px)))
    _same_bits(TIntrinsics.from_values(*vals).calibrate(torch.as_tensor(px)).numpy(), want)
    x = torch.as_tensor(p[:, :3])
    _same_bits(torch.linalg.vector_norm(x, dim=-1).numpy(), trig.sqrt(trig.dot_fused(x, x)).numpy())
