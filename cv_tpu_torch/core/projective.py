"""Homogeneous projective 3d points (port of ``cv_tpu/core/projective.py``).

A projective point is a homogeneous 4-vector whose xyz part is unit-norm
and whose ``w`` is the (non-negative) reciprocal distance — ``w == 0``
encodes a point at infinity (reference cv-core/src/point.rs).
"""

from __future__ import annotations

import torch


def from_homogeneous(point: torch.Tensor) -> torch.Tensor:
    """Flip sign so ``w`` is non-negative, then scale so xyz is unit-norm
    (point.rs:19-25)."""
    point = torch.where(point[..., 3:4] < 0, -point, point)
    norm = torch.linalg.vector_norm(point[..., :3], dim=-1, keepdim=True)
    return point / norm


def from_point(p: torch.Tensor) -> torch.Tensor:
    """Euclidean ``(..., 3)`` point -> projective ``(..., 4)``."""
    return from_homogeneous(torch.cat([p, torch.ones_like(p[..., :1])], dim=-1))


def point(hp: torch.Tensor) -> torch.Tensor:
    """Projective -> euclidean ``(..., 3)``; infinite points yield inf."""
    return hp[..., :3] / hp[..., 3:4]


def bearing(hp: torch.Tensor) -> torch.Tensor:
    """Unit bearing of the point (its xyz part, already unit-norm)."""
    return hp[..., :3]


def is_finite(hp: torch.Tensor) -> torch.Tensor:
    """Mask of points whose components are all finite."""
    return torch.isfinite(hp).all(dim=-1)
