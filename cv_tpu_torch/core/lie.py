"""so(3) / se(3) Lie-algebra primitives.

Port of ``cv_tpu/core/lie.py`` (reference cv-core/src/so3.rs): batched
functions over trailing ``(..., 3)`` / ``(..., 3, 3)`` dimensions in any
float dtype.

* ``so3_exp`` is Rodrigues with the reference's Taylor branch at
  ``theta^2 <= eps``.
* ``so3_log`` returns the scaled axis, zeros where the result is NaN.
* Their sine, cosine and atan2 are ``ops.trig``'s: glibc's, as ``cv_tpu``'s
  ``jnp.sin``/``cos``/``arctan2`` are on a CPU, in float32 and float64; on
  the card one trig kernel launch each (``so3_exp`` its cos and sin
  together).  ``so3_exp``'s square roots are ``trig.sqrt``: correctly
  rounded, as the reference's are.  Those functions carry their analytic
  derivatives (``torch.autograd`` and ``torch.func``, as ``optimize.lm``'s
  default Jacobian takes them), rounded as torch rounds them: the maps'
  derivatives are within an ulp or so of ``jax.jacfwd``'s, not bitwise.
* An se(3) tangent is ``(translation, rotation)``; its isometry is
  ``(R, R @ translation)`` with ``R = exp(rotation)`` (so3.rs:52-60), not
  the textbook SE(3) exponential.
"""

from __future__ import annotations

import torch

from ..ops import trig
from ..ops.precision import full_f32


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m * v[..., None, :]).sum(dim=-1)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (cross-product) matrix: ``hat(w) @ v == w x v``."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_vee(mat: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`so3_hat` (no symmetry check, so3.rs:169-174)."""
    return torch.stack([mat[..., 2, 1], mat[..., 0, 2], mat[..., 1, 0]], dim=-1)


def so3_hat2(w: torch.Tensor) -> torch.Tensor:
    """``hat(w) @ hat(w)``, computed directly (so3.rs:181-196)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    w11, w22, w33 = wx * wx, wy * wy, wz * wz
    w12, w13, w23 = wx * wy, wx * wz, wy * wz
    return torch.stack(
        [
            torch.stack([-w22 - w33, w12, w13], dim=-1),
            torch.stack([w12, -w11 - w33, w23], dim=-1),
            torch.stack([w13, w23, -w11 - w22], dim=-1),
        ],
        dim=-2,
    )


@full_f32
def so3_bracket(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lie bracket ``[a, b] = vee(hat(a) hat(b) - hat(b) hat(a))``."""
    ha, hb = so3_hat(a), so3_hat(b)
    return so3_vee(ha @ hb - hb @ ha)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from a scaled axis (Rodrigues), with the Taylor
    coefficients at ``theta^2 <= eps`` (so3.rs:243-256)."""
    theta2 = (w * w).sum(dim=-1)
    theta = trig.sqrt(theta2)
    small = theta2 <= torch.finfo(w.dtype).eps
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    cos, sin = trig.cos_sin(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, sin / trig.sqrt(t2s))
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos) / t2s)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(w.shape[:-1] + (3, 3))
    return eye + a[..., None, None] * so3_hat(w) + b[..., None, None] * so3_hat2(w)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Scaled axis from a rotation matrix: atan2 of the antisymmetric part
    against the trace (well conditioned at 0 and pi), a Taylor scale for
    small angles, the diagonal extraction near pi, and zeros for NaN."""
    dtype = r.dtype
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    axis_sin = (
        torch.stack(
            [r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1]],
            dim=-1,
        )
        * 0.5
    )
    sin_theta = torch.linalg.vector_norm(axis_sin, dim=-1)
    theta = trig.atan2(sin_theta, cos_theta)
    eps = torch.finfo(dtype).eps
    near_pi = cos_theta < -1.0 + 16.0 * eps
    small = theta < eps**0.25

    safe_sin = torch.where(sin_theta == 0, torch.ones_like(sin_theta), sin_theta)
    scale = torch.where(small, 1.0 + theta * theta / 6.0, theta / safe_sin)
    w_generic = scale[..., None] * axis_sin

    # Near pi: R + R^T + (1 - trace) I = 2 (1 - cos theta) a a^T; take the
    # column with the largest diagonal and sign it against axis_sin.
    eye = torch.eye(3, dtype=dtype, device=r.device)
    outer = r + r.transpose(-1, -2) + (1.0 - trace)[..., None, None] * eye
    diag = torch.diagonal(outer, dim1=-2, dim2=-1)
    col_idx = torch.argmax(diag, dim=-1)
    col = torch.gather(outer, -1, col_idx[..., None, None].expand(outer.shape[:-1] + (1,)))[..., 0]
    col_norm = torch.linalg.vector_norm(col, dim=-1, keepdim=True)
    axis_pi = col / torch.where(col_norm == 0, torch.ones_like(col_norm), col_norm)
    sign = torch.sign((axis_pi * axis_sin).sum(dim=-1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    w_pi = theta[..., None] * axis_pi * sign

    w = torch.where(near_pi[..., None], w_pi, w_generic)
    return torch.where(torch.isnan(w), torch.zeros_like(w), w)


def tangent_isometry(translation: torch.Tensor, rotation: torch.Tensor):
    """``Se3TangentSpace.isometry`` (so3.rs:52-60): ``(R, R @ translation)``."""
    r = so3_exp(rotation)
    return r, _mv(r, translation)


def tangent_l1(translation: torch.Tensor, rotation: torch.Tensor):
    """``Se3TangentSpace.l1`` (so3.rs:121-125): both parts normalized, NaN
    (a zero part) mapped to zeros."""

    def _norm(v):
        out = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return torch.where(torch.isnan(out), torch.zeros_like(out), out)

    return _norm(translation), _norm(rotation)
