"""Epipolar gradient/loss functions — the analytic heart of the optimizers.

Port of ``cv_tpu/geom/epipolar.py`` (reference cv-geom/src/epipolar.rs).
Every Option of the reference becomes zeros plus a mask: a failed
triangulation contributes a zero gradient (epipolar.rs:121-160).

A se(3) tangent is a pair ``(translation (..., 3), rotation (..., 3))``;
the NaN guard of ``Se3TangentSpace::new`` (so3.rs:23-29) is
:func:`tangent_new`.
"""

from __future__ import annotations

import torch

from ..ops import trig


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting 3-vector cross product over the last axis."""
    return torch.linalg.cross(a, b)


def _nan_to_zero_vec(v: torch.Tensor) -> torch.Tensor:
    """Zero the whole 3-vector when any component is NaN (so3.rs:23-29)."""
    bad = torch.isnan(v).any(dim=-1, keepdim=True)
    return torch.where(bad, torch.zeros_like(v), v)


def tangent_new(translation: torch.Tensor, rotation: torch.Tensor):
    """``Se3TangentSpace::new`` with its NaN guards."""
    return _nan_to_zero_vec(translation), _nan_to_zero_vec(rotation)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def two_view_same_space_triangulate_sine_l1(t, a, b):
    """Angular-L1-corrected midpoint triangulation (epipolar.rs:9-53).

    ``t``: translation from B to A; ``a``/``b``: unit bearings with A as the
    origin.  Returns ``(point (..., 3), ok (...,))``.
    """
    cross_a = cross(a, t)
    cross_a_norm = torch.linalg.vector_norm(cross_a, dim=-1)
    na = cross_a / cross_a_norm[..., None]
    cross_b = cross(b, t)
    cross_b_norm = torch.linalg.vector_norm(cross_b, dim=-1)
    nb = cross_b / cross_b_norm[..., None]
    use_a = (cross_a_norm < cross_b_norm)[..., None]
    new_a = _normalize(a - _dot(a, nb)[..., None] * nb)
    new_b = _normalize(b - _dot(b, na)[..., None] * na)
    a_c = torch.where(use_a, new_a, a)
    b_c = torch.where(use_a, b, new_b)

    z = cross(a_c, b_c)
    w = _dot(z, z) / _dot(z, cross(t, b_c))
    hp = torch.cat([a_c, w[..., None]], dim=-1)
    hp = torch.where(hp[..., 3:4] < 0, -hp, hp)  # sign flip so w >= 0
    bearing = _normalize(hp[..., :3])
    finite = torch.isfinite(hp).all(dim=-1)
    cheir = (_dot(bearing, a_c) >= 0) & (_dot(bearing, b_c) >= 0)
    w_safe = torch.where(hp[..., 3] == 0, torch.full_like(hp[..., 3], torch.inf), hp[..., 3])
    point = bearing / w_safe[..., None]
    ok = finite & cheir & torch.isfinite(point).all(dim=-1)
    return torch.where(ok[..., None], point, torch.zeros_like(point)), ok


def two_view_rotation_gradient(t, a, b):
    """Cross of the normalized epipolar-plane normals (epipolar.rs:56-71)."""
    return cross(_normalize(cross(b, t)), _normalize(cross(a, t)))


def three_view_gradients(c, f, ftoc, s, stoc):
    """The three-view BA gradient (epipolar.rs:85-166).

    Bearings ``c``/``f``/``s`` and translations ``ftoc``/``stoc`` (center
    camera to first/second) are in the center camera's frame.  Returns
    ``((t1, r1), (t2, r2))`` with the reference's 2/3-1/3 edge weighting.
    """
    stof = stoc - ftoc
    # The three rotation gradients, and the three triangulations, each run
    # as one call over a leading axis of 3: the functions are elementwise
    # over their batch, so the values are those of three calls.
    ftoc_b, stoc_b, stof_b, c_b, f_b, s_b = torch.broadcast_tensors(ftoc, stoc, stof, c, f, s)
    ccf = torch.stack([c_b, c_b, f_b])

    rot_cf, rot_cs, rot_fs = two_view_rotation_gradient(
        torch.stack([ftoc_b, stoc_b, stof_b]), ccf, torch.stack([f_b, s_b, s_b])
    )
    rot_sf = -rot_fs

    first_rotation = rot_cf * (2.0 / 3.0) + rot_sf * (1.0 / 3.0)
    second_rotation = rot_cs * (2.0 / 3.0) + rot_fs * (1.0 / 3.0)

    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    (p_f, p_s, p_c), (ok_f, ok_s, ok_c) = two_view_same_space_triangulate_sine_l1(
        -torch.stack([stoc_b, ftoc_b, stof_b]), ccf, torch.stack([s_b, f_b, s_b])
    )
    pf = p_f - ftoc
    trans_f = torch.where(ok_f[..., None], pf - _dot(pf, f)[..., None] * f, zero)

    ps = p_s - stoc
    trans_s = torch.where(ok_s[..., None], ps - _dot(ps, s)[..., None] * s, zero)

    pc = p_c + ftoc
    trans_c = torch.where(ok_c[..., None], _dot(pc, c)[..., None] * c - pc, zero)

    first_translation = trans_f * (2.0 / 3.0) + trans_c * (1.0 / 3.0)
    second_translation = trans_s * (2.0 / 3.0) + trans_c * (1.0 / 3.0)
    return (
        tangent_new(first_translation, first_rotation),
        tangent_new(second_translation, second_rotation),
    )


def point_gradient(translation, b):
    """Gradient translating a point towards a camera ray (epipolar.rs:174-179)."""
    return translation - _dot(translation, b)[..., None] * b


def world_pose_gradient(translation, b):
    """PnP pose tangent for one landmark (epipolar.rs:188-193): ``translation``
    runs from the optical center to the point in the camera frame, ``b`` is
    the observed bearing.  Returns ``(translation_grad, rotation_grad)``."""
    projected = _dot(translation, b)[..., None] * b
    return tangent_new(projected - translation, cross(_normalize(translation), b))


def loss(translation, a, b):
    """|sine| of the angle between the two epipolar planes, with the NaN /
    cheirality fallback to 1.0 (epipolar.rs:197-233)."""
    cross_a = cross(a, translation)
    ca2 = _dot(cross_a, cross_a)
    cross_b = cross(b, translation)
    cb2 = _dot(cross_b, cross_b)
    res_a = (_dot(a, cross_b) / trig.sqrt(cb2)).abs()
    res_b = (_dot(b, cross_a) / trig.sqrt(ca2)).abs()
    residual = torch.where(ca2 < cb2, res_a, res_b)
    bad = torch.isnan(residual) | (_dot(a, b) < 0)
    return torch.where(bad, torch.ones_like(residual), residual)
