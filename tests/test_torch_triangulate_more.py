"""cv_tpu_torch's remaining triangulators (Sine-L1, relative DLT,
mean-mean, angular L1 / L-infinity) against cv_tpu on seeded float64
inputs, and the reference tests' doc-test tolerances
(tests/test_geom_optimize.py::TestTriangulators).

Points within 1e-9 of cv_tpu's (measured worst 4.4e-16; the Jacobi eigen
solve and the Sine-L1 descent round like cv_tpu's up to last bits), ok
masks equal, including points behind a camera, a flipped observation and
invalid observations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu import triangulate as jtri
from cv_tpu.core import CameraToCamera as JC2C
from cv_tpu.core import Isometry3 as JIso
from cv_tpu_torch import triangulate as tri
from cv_tpu_torch.core import CameraToCamera, Isometry3, lie, projective


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's tensor work on one thread: parallel test workers share
    the machine's cores, and torch's threads would spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _doc_case():
    point = projective.from_point(torch.tensor([0.3, 0.1, 2.0], dtype=torch.float64))
    pose = CameraToCamera(rotation=lie.so3_exp(torch.tensor([0.1, 0.1, 0.1], dtype=torch.float64)),
                          translation=torch.tensor([0.1, 0.1, 0.1], dtype=torch.float64))
    return pose, projective.bearing(point), projective.bearing(pose.transform(point))


def _j(pose, cls=JIso):
    return cls(rotation=jnp.asarray(pose.rotation.numpy()), translation=jnp.asarray(pose.translation.numpy()))


def _two_view(pose, a, b):
    """The two-view case as world-to-camera observations (camera A at the
    origin)."""
    shape = tuple(pose.batch_shape) or tuple(a.shape[:-1])
    eye = Isometry3.identity(batch_shape=shape, dtype=a.dtype)
    poses = Isometry3(rotation=torch.stack([eye.rotation, pose.rotation.expand(shape + (3, 3))], dim=-3),
                      translation=torch.stack([eye.translation, pose.translation.expand(shape + (3,))], dim=-2))
    return poses, torch.stack([a, b], dim=-2)


def test_doc_tolerances():
    """Each triangulator recovers the doc-test point within its published
    tolerance (triangulation.rs doc-tests)."""
    pose, a, b = _doc_case()
    poses, bearings = _two_view(pose, a, b)
    true = np.array([0.3, 0.1, 2.0])
    cases = {
        "sine_l1": (tri.sine_l1(poses, bearings), 1e-6),
        "relative_dlt": (tri.relative_dlt(pose, a, b), 1e-6),
        "mean_mean": (tri.mean_mean(poses, bearings), 1e-2),
        "angular_l1": (tri.angular_l1(pose, a, b), 1e-6),
        "angular_linf": (tri.angular_linf(pose, a, b), 1e-6),
    }
    for name, ((pt, ok), tol) in cases.items():
        assert bool(ok), name
        assert float(np.linalg.norm(projective.point(pt).numpy() - true)) < tol, name


def _random_case(seed, n=64):
    rng = np.random.default_rng(seed)
    pose = CameraToCamera(rotation=lie.so3_exp(torch.tensor(rng.normal(size=3) * 0.2)),
                          translation=torch.tensor(rng.normal(size=3)))
    pts = rng.uniform([-1, -1, 1.5], [1, 1, 6], (n, 3))
    pts[:4, 2] *= -1.0  # behind camera A: cheirality fails
    hp = projective.from_point(torch.tensor(pts))
    a, b = projective.bearing(hp), projective.bearing(pose.transform(hp))
    b = b + torch.tensor(rng.normal(0.0, 1e-3, b.shape))
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    b[5] = -b[5]  # a flipped observation
    return pose, a, b


@pytest.mark.parametrize("name", ["relative_dlt", "angular_l1", "angular_linf"])
def test_two_view_triangulators_match_cv_tpu(name):
    pose, a, b = _random_case(1)
    got, ok = getattr(tri, name)(pose, a, b)
    ref, rok = getattr(jtri, name)(_j(pose, JC2C), jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    assert not bool(ok[5]) and bool(ok[8:].all())
    fin = np.isfinite(np.asarray(ref)).all(axis=-1)
    np.testing.assert_array_equal(np.isfinite(got.numpy()).all(axis=-1), fin)
    np.testing.assert_allclose(got.numpy()[fin], np.asarray(ref)[fin], atol=1e-9, rtol=0)
    if name == "relative_dlt":  # its 4x4 eigensystem is the reference's bit for bit (ops.eigen)
        np.testing.assert_array_equal(got.numpy()[fin].view(np.uint64), np.asarray(ref)[fin].view(np.uint64))


def _multi_view(seed, n=32, v=4):
    """``n`` points seen by ``v`` cameras (world-to-camera), some
    observations invalid."""
    rng = np.random.default_rng(seed)
    rot = lie.so3_exp(torch.tensor(rng.normal(size=(v, 3)) * 0.1))
    trans = torch.tensor(rng.normal(size=(v, 3)) * 0.5)
    pts = torch.tensor(rng.uniform([-1, -1, 3], [1, 1, 7], (n, 3)))
    poses = Isometry3(rotation=rot.expand(n, v, 3, 3), translation=trans.expand(n, v, 3))
    cam = (rot[None] @ pts[:, None, :, None])[..., 0] + trans[None]
    bearings = cam / torch.linalg.vector_norm(cam, dim=-1, keepdim=True)
    bearings = bearings + torch.tensor(rng.normal(0.0, 1e-3, bearings.shape))
    valid = torch.tensor(rng.uniform(size=(n, v)) < 0.85)
    valid[:, :2] = True
    return poses, bearings, valid


@pytest.mark.parametrize("name", ["sine_l1", "mean_mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_multi_view_triangulators_match_cv_tpu(name, masked):
    poses, bearings, valid = _multi_view(2)
    kw_t = dict(valid=valid) if masked else {}
    kw_j = dict(valid=jnp.asarray(valid.numpy())) if masked else {}
    got, ok = getattr(tri, name)(poses, bearings, **kw_t)
    ref, rok = getattr(jtri, name)(_j(poses), jnp.asarray(bearings.numpy()), **kw_j)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    assert bool(ok.all())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-9, rtol=0)


def test_sine_l1_two_view_and_infinity_match_cv_tpu():
    """Sine-L1 on the two-view set, where some elements start at infinity or
    fail the init's cheirality (both returned as the init gives them)."""
    pose, a, b = _random_case(3)
    a[6] = b[6] = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)  # parallel rays: a point at infinity
    poses, bearings = _two_view(pose, a, b)
    got, ok = tri.sine_l1(poses, bearings, max_iterations=200)
    ref, rok = jtri.sine_l1(_j(poses), jnp.asarray(bearings.numpy()), max_iterations=200)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    fin = np.isfinite(np.asarray(ref)).all(axis=-1)
    np.testing.assert_array_equal(np.isfinite(got.numpy()).all(axis=-1), fin)
    np.testing.assert_allclose(got.numpy()[fin], np.asarray(ref)[fin], atol=1e-9, rtol=0)


def test_flipped_observation_rejected():
    pose, a, b = _doc_case()
    _, ok = tri.angular_l1(pose, a, -b)
    assert not bool(ok)
