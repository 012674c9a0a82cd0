"""Host (NumPy) geometry used by the engine's per-landmark control flow.

Batched-NumPy mirrors of the device kernels for the *small, latency-bound*
call sites: triangulating handfuls of observations inside data-dependent
rejection cascades.  The throughput-bound math (matching, consensus,
optimizers, graph BA) stays on device.  Carried over unchanged from
``cv_tpu/sfm/host_geom.py`` (pure NumPy).
"""

from __future__ import annotations

import numpy as np

from . import se3


def triangulate_observations(pose_list, bearing_list):
    """Linear-Eigen triangulation of ONE landmark from >= 2 observations
    (cv-geom/src/triangulation.rs:83-130). Returns homogeneous (4,) point or
    None (finite/cheirality failures)."""
    if len(pose_list) < 2:
        return None
    a = np.zeros((4, 4))
    for (r, t), bearing in zip(pose_list, bearing_list):
        pm = np.concatenate([r, t[:, None]], axis=1)  # 3x4
        term = pm - np.outer(bearing, bearing) @ pm
        a += term.T @ term
    _, vecs = np.linalg.eigh(a)
    point = vecs[:, 0]
    if point[3] < 0:
        point = -point
    n = np.linalg.norm(point[:3])
    point = point / n
    if not np.all(np.isfinite(point)):
        return None
    for (r, t), bearing in zip(pose_list, bearing_list):
        world_bearing = r.T @ bearing
        if float(world_bearing @ point[:3]) < 0.0:
            return None
    return point


def point_of(hp):
    """Euclidean point of a homogeneous (4,), or None at infinity."""
    if hp is None or hp[3] == 0 or not np.isfinite(1.0 / hp[3]):
        return None
    return hp[:3] / hp[3]


def bearing_of(hp):
    return hp[:3]


def epipolar_loss(translation, a, b):
    """Sine epipolar loss with NaN/cheirality fallback (epipolar.rs:197-233)."""
    cross_a = np.cross(a, translation)
    ca2 = float(cross_a @ cross_a)
    cross_b = np.cross(b, translation)
    cb2 = float(cross_b @ cross_b)
    if ca2 < cb2:
        with np.errstate(invalid="ignore", divide="ignore"):
            residual = abs(float(a @ cross_b) / np.sqrt(cb2))
    else:
        with np.errstate(invalid="ignore", divide="ignore"):
            residual = abs(float(b @ cross_a) / np.sqrt(ca2))
    if np.isnan(residual) or float(a @ b) < 0:
        return 1.0
    return residual


def transform_bearing(pose, hp):
    """bearing of pose.transform(point) for homogeneous hp."""
    out = se3.transform_homogeneous(pose, hp)
    return out[:3]
