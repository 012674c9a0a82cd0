"""Host-side (NumPy) SE(3) helpers for the SfM engine's control flow.

The engine stores poses as ``(R (3,3) float64, t (3,) float64)`` NumPy pairs:
its control flow is inherently sequential/data-dependent (slotmap mutation,
rejection cascades), so small per-pose ops run on host with zero dispatch
latency, while the batched device kernels (consensus, optimizers, bundle
adjustment) consume stacked arrays of these poses.

Math mirrors :mod:`cv_tpu_torch.core.lie` / :mod:`cv_tpu_torch.core.pose`.
Carried over unchanged from ``cv_tpu/sfm/se3.py`` (pure NumPy).
"""

from __future__ import annotations

import numpy as np


def identity():
    return (np.eye(3), np.zeros(3))


def from_arrays(rotation, translation):
    return (np.asarray(rotation, np.float64), np.asarray(translation, np.float64))


def compose(a, b):
    """a after b."""
    ra, ta = a
    rb, tb = b
    return (ra @ rb, ra @ tb + ta)


def inverse(p):
    r, t = p
    return (r.T, -(r.T @ t))


def scale(p, s):
    r, t = p
    return (r, t * s)


def apply(p, x):
    r, t = p
    return x @ r.T + t


def rotate(p, v):
    return v @ p[0].T


def transform_homogeneous(p, hp):
    """Transform projective points (..., 4), renormalized."""
    r, t = p
    xyz = hp[..., :3] @ r.T + t * hp[..., 3:4]
    out = np.concatenate([xyz, hp[..., 3:4] + np.zeros_like(xyz[..., :1])], axis=-1)
    out = np.where(out[..., 3:4] < 0, -out, out)
    return out / np.linalg.norm(out[..., :3], axis=-1, keepdims=True)


def so3_log(r):
    """Scaled-axis log (mirrors lie.so3_log; NaN guard -> zeros)."""
    trace = np.trace(r)
    cos_theta = np.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    axis_sin = 0.5 * np.array(
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]
    )
    sin_theta = np.linalg.norm(axis_sin)
    theta = np.arctan2(sin_theta, cos_theta)
    if sin_theta < 1e-12:
        if cos_theta > 0:
            return axis_sin * (1.0 + theta * theta / 6.0)
        # Near pi: extract axis from the symmetric part.
        outer = r + r.T + (1.0 - trace) * np.eye(3)
        col = outer[:, np.argmax(np.diag(outer))]
        n = np.linalg.norm(col)
        if n == 0:
            return np.zeros(3)
        return theta * col / n
    w = axis_sin * (theta / sin_theta)
    return np.where(np.isnan(w), 0.0, w)


def so3_exp(w):
    theta2 = float(w @ w)
    if theta2 <= 1e-30:
        a, b = 1.0 - theta2 / 6.0, 0.5 - theta2 / 24.0
    else:
        theta = np.sqrt(theta2)
        a = np.sin(theta) / theta
        b = (1.0 - np.cos(theta)) / theta2
    wx, wy, wz = w
    hat = np.array([[0, -wz, wy], [wz, 0, -wx], [-wy, wx, 0]], np.float64)
    return np.eye(3) + a * hat + b * (hat @ hat)


def se3_vec(p):
    """Reference se(3) vector [t, log R] (pose.rs:55-60)."""
    r, t = p
    return np.concatenate([t, so3_log(r)])


def from_se3(v):
    return (so3_exp(v[3:6]), v[0:3].copy())


def mirror_bearing(p, b):
    """Rotate bearings by the pose rotation only."""
    return b @ p[0].T
