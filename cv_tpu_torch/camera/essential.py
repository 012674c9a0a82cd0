"""Essential matrix: reconditioning and the pose decompositions.

Port of ``cv_tpu/camera/essential.py`` (reference
cv-pinhole/src/essential.rs) over batched ``(..., 3, 3)`` essential
matrices, decomposed with the Jacobi :func:`~cv_tpu_torch.ops.eigen.svd3`.
"""

from __future__ import annotations

import torch

from ..core.pose import CameraToCamera
from ..ops.eigen import svd3


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of ``(..., 3, 3)`` by the triple product (only its sign
    is read below)."""
    return (torch.linalg.cross(m[..., 0, :], m[..., 1, :]) * m[..., 2, :]).sum(dim=-1)


def recondition(e: torch.Tensor) -> torch.Tensor:
    """Closest true essential matrix: average the two large singular values,
    zero the third (essential.rs:64-77)."""
    u, s, vt = svd3(e)
    avg = 0.5 * (s[..., 0] + s[..., 1])
    s_new = torch.stack([avg, avg, torch.zeros_like(avg)], dim=-1)
    return (u * s_new[..., None, :]) @ vt


def possible_rotations_unscaled_translation(e: torch.Tensor):
    """Two candidate rotations + unscaled translation (essential.rs:114-162).

    Returns ``(rot_a (..., 3, 3), rot_b (..., 3, 3), t (..., 3))``.
    """
    w = torch.tensor(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
        dtype=e.dtype,
        device=e.device,
    )
    u, _, vt = svd3(e)
    # Force positive determinants (handedness): flip last column of U / last
    # row of Vt (essential.rs:139-153).
    u = u.clone()
    vt = vt.clone()
    u[..., :, 2] *= torch.where(_det3(u) < 0, -1.0, 1.0)[..., None]
    vt[..., 2, :] *= torch.where(_det3(vt) < 0, -1.0, 1.0)[..., None]
    rot_a = u @ w @ vt
    rot_b = u @ w.T @ vt
    return rot_a, rot_b, u[..., :, 2]


def possible_unscaled_poses(e: torch.Tensor) -> CameraToCamera:
    """The 4-fold pose ambiguity as a batched pose with a trailing batch
    axis of 4 (essential.rs:217-231): (t, Ra), (t, Rb), (-t, Ra), (-t, Rb)."""
    rot_a, rot_b, t = possible_rotations_unscaled_translation(e)
    rots = torch.stack([rot_a, rot_b, rot_a, rot_b], dim=-3)
    ts = torch.stack([t, t, -t, -t], dim=-2)
    return CameraToCamera(rotation=rots, translation=ts)


def possible_unscaled_poses_bearing(e: torch.Tensor) -> CameraToCamera:
    """The 2-fold variant that ignores the translation's sign
    (essential.rs:237-249): (t, Ra), (t, Rb)."""
    rot_a, rot_b, t = possible_rotations_unscaled_translation(e)
    return CameraToCamera(rotation=torch.stack([rot_a, rot_b], dim=-3), translation=torch.stack([t, t], dim=-2))
