"""Batched eight-point essential-matrix estimation.

Port of ``cv_tpu/solvers/eight_point.py`` (reference
eight-point/src/lib.rs): constraint encoding and the 9x9 symmetric-eigen
nullspace over a leading hypothesis batch.
"""

from __future__ import annotations

import torch

from ..camera import essential
from ..core.pose import CameraToCamera
from ..ops import eigen

MIN_SAMPLES = 8
MODELS_PER_SAMPLE = 4


def encode_epipolar_equation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Constraint rows for matches ``a``/``b`` of shape ``(..., K, 3)``.

    Mirrors the reference encoding (eight-point/src/lib.rs:11-24) including
    its quirk of normalizing *both* bearings by ``a.z``; row layout is
    ``row[3j + i] = ap[j] * bp[i]`` so the flattened nullspace vector maps to
    ``E[i, j] = v[3j + i]``.
    """
    ap = a / a[..., 2:3]
    bp = b / a[..., 2:3]
    return (ap[..., :, None] * bp[..., None, :]).reshape(a.shape[:-1] + (9,))


def essential_from_matches(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least-squares essential matrix from >= 8 matches ``(..., K, 3)``:
    the smallest eigenvector of the 9x9 normal matrix (lib.rs:44-60).  On
    a CPU the matrix is summed as the reference's jitted code sums it
    (``eigen.gram_fused``) and the Jacobi is the exact one: ``cv_tpu``'s
    bits; within ``eigen.cheap_on_cpu`` a matmul and the unfused sweep."""
    rows = encode_epipolar_equation(a, b)  # (..., K, 9)
    _, vecs = eigen._eigh_for_caller(eigen.gram(rows), 8)  # ascending
    v = vecs[..., :, 0]
    # E[i, j] = v[3j + i]
    return v.reshape(v.shape[:-1] + (3, 3)).transpose(-1, -2)


def estimate(a: torch.Tensor, b: torch.Tensor) -> CameraToCamera:
    """Estimator::estimate (lib.rs:70-84): minimal sets ``(..., 8, 3)`` ->
    4 candidate relative poses per set, with batch shape ``(..., 4)``."""
    return essential.possible_unscaled_poses(essential_from_matches(a, b))
