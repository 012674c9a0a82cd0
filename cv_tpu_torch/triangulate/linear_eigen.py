"""Linear-Eigen (Hartley & Sturm) triangulation, batched.

Port of ``cv_tpu/triangulate/linear_eigen.py`` (reference
cv-geom/src/triangulation.rs:40-130): per-landmark 4x4 normal matrices and
the symmetric eigen solve, batched over landmarks, with masks in place of
the reference's Option returns.
"""

from __future__ import annotations

import torch

from ..core import projective
from ..core.pose import Isometry3
from ..ops.eigen import eigh4


def triangulate_observations(poses: Isometry3, bearings: torch.Tensor, valid: torch.Tensor | None = None):
    """One world point per batch element from >= 2 observations.

    ``poses``: world-to-camera with batch shape ``(..., V)``; ``bearings``:
    ``(..., V, 3)`` unit bearings; ``valid``: optional ``(..., V)`` mask of
    real observations.  Returns ``(point (..., 4), ok (...,))`` where ``ok``
    combines the finite and cheirality checks (triangulation.rs:108-129).
    """
    pm = poses.matrix3x4()  # (..., V, 3, 4)
    # b (b^T pm) == (b b^T) pm for unit b, in the reference's elementwise form.
    s = (bearings[..., :, None] * pm).sum(dim=-2)  # (..., V, 4)
    term = pm - bearings[..., :, None] * s[..., None, :]  # (..., V, 3, 4)
    if valid is not None:
        term = torch.where(valid[..., None, None], term, torch.zeros_like(term))
    design = (term[..., :, :, None] * term[..., :, None, :]).sum(dim=(-4, -3))
    _, vecs = eigh4(design)
    point = projective.from_homogeneous(vecs[..., :, 0])
    finite = projective.is_finite(point)
    # Cheirality: each bearing rotated to world must face the point.
    world_bearing = (poses.rotation * bearings[..., :, None]).sum(dim=-2)  # R^T b
    cheir = (world_bearing * point[..., None, :3]).sum(dim=-1) >= 0.0
    if valid is not None:
        cheir = cheir | ~valid
    return point, finite & cheir.all(dim=-1)


def triangulate_relative(pose: Isometry3, a: torch.Tensor, b: torch.Tensor):
    """Two-view case (triangulation.rs:52-67): camera A is the world frame
    and ``pose`` maps A -> B.  Returns ``(point (..., 4), ok)`` in A's frame."""
    eye = Isometry3.identity(batch_shape=tuple(pose.batch_shape), dtype=a.dtype, device=a.device)
    poses = Isometry3(
        rotation=torch.stack([eye.rotation, pose.rotation], dim=-3),
        translation=torch.stack([eye.translation, pose.translation], dim=-2),
    )
    return triangulate_observations(poses, torch.stack([a, b], dim=-2))
