"""cv_tpu_torch's Lambda-Twist P3P against the reference's test pose and
against cv_tpu on the same seeded samples (float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.core import projective as ref_projective
from cv_tpu.solvers import lambda_twist as ref_lt
from cv_tpu.sfm.se3 import so3_exp
from cv_tpu_torch.core import projective
from cv_tpu_torch.solvers import lambda_twist
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)


def _euler(r, p, y):
    """nalgebra from_euler_angles (roll, pitch, yaw) = Rz Ry Rx."""
    return so3_exp(np.array([0.0, 0.0, y])) @ so3_exp(np.array([0.0, p, 0.0])) @ so3_exp(np.array([r, 0.0, 0.0]))


def _samples(cam_pts, rot, t):
    """Bearings and world points of camera points under pose (rot, t)."""
    world = (cam_pts - t[..., None, :]) @ rot  # R^T (c - t), row-wise
    bearings = cam_pts / np.linalg.norm(cam_pts, axis=-1, keepdims=True)
    return bearings, world


def _port(bearings, world):
    poses, valid = lambda_twist.estimate(
        torch.tensor(bearings), projective.from_point(torch.tensor(world))
    )
    return poses.rotation.numpy(), poses.translation.numpy(), valid.numpy()


def test_reference_case_recovers_pose():
    """lambda-twist/tests/consensus.rs:19-66: the exact pose from 3 points
    to 1e-6 (as tests/test_solvers_p3p_5pt.py holds cv_tpu)."""
    rot = _euler(0.1, 0.2, 0.3)
    t = np.array([0.1, 0.2, 0.3])
    cam = np.array([[-0.228125, -0.061458334, 1.0], [0.41875, -0.58125, 2.0], [1.128125, 0.878125, 3.0]])
    r, tt, valid = _port(*_samples(cam, rot, t))
    errs = [(np.linalg.norm(r[i] - rot), np.linalg.norm(tt[i] - t)) for i in range(4) if valid[i]]
    assert errs
    best = min(errs)
    assert best[0] < 1e-6 and best[1] < 1e-6


def test_matches_cv_tpu_on_random_batch():
    """Same seeded 200 samples through both packages: the same validity
    mask, and the valid poses within 1e-9 (measured worst 1.5e-11)."""
    rng = np.random.default_rng(0)
    n = 200
    rots = np.stack([so3_exp(w) for w in rng.normal(size=(n, 3)) * 0.5])
    ts = rng.normal(size=(n, 3))
    cam = rng.uniform([-1, -1, 1], [1, 1, 6], (n, 3, 3))
    bearings, world = _samples(cam, rots, ts)
    r, t, valid = _port(bearings, world)
    ref_poses, ref_valid = ref_lt.estimate(
        jnp.asarray(bearings), ref_projective.from_point(jnp.asarray(world))
    )
    ref_valid = np.asarray(ref_valid)
    np.testing.assert_array_equal(valid, ref_valid)
    np.testing.assert_allclose(r[valid], np.asarray(ref_poses.rotation)[valid], atol=1e-9, rtol=0)
    np.testing.assert_allclose(t[valid], np.asarray(ref_poses.translation)[valid], atol=1e-9, rtol=0)
    # And the truth is among each sample's solutions.
    err = np.linalg.norm(r - rots[:, None], axis=(-1, -2)) + np.linalg.norm(t - ts[:, None], axis=-1)
    best = np.where(valid, err, np.inf).min(axis=-1)
    assert np.mean(best < 1e-6) > 0.99


def test_infinite_point_gives_no_pose():
    bearings = np.eye(3)
    wp = projective.from_point(torch.eye(3, dtype=torch.float64))
    wp[0, 3] = 0.0
    _, valid = lambda_twist.estimate(torch.tensor(bearings), wp)
    assert not bool(valid.any())


@pytest.mark.parametrize("dtype", [torch.float64])
def test_pose_type_and_shapes(dtype):
    rng = np.random.default_rng(1)
    cam = rng.uniform([-1, -1, 1], [1, 1, 6], (5, 3, 3))
    bearings, world = _samples(cam, np.tile(np.eye(3), (5, 1, 1)), np.zeros((5, 3)))
    poses, valid = lambda_twist.estimate(
        torch.tensor(bearings, dtype=dtype), projective.from_point(torch.tensor(world, dtype=dtype))
    )
    assert type(poses).__name__ == "WorldToCamera"
    assert tuple(poses.rotation.shape) == (5, 4, 3, 3) and tuple(valid.shape) == (5, 4)
