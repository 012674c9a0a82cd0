"""Batched Lambda-Twist P3P (Persson & Nordberg, ECCV 2018).

Port of ``cv_tpu/solvers/lambda_twist.py`` (reference
lambda-twist/src/lib.rs): a closed-form, branch-free batched solver.  Every
data-dependent branch of the reference (cubic-root initialization cases,
quadratic root validity, the Gauss-Newton early exit, degenerate
configurations) is a masked ``where``, so a consensus pass solves all its
P3P problems in one vectorized call.  The engine runs it in float64.

Returns up to 4 ``WorldToCamera`` poses per problem with a validity mask.
"""

from __future__ import annotations

import torch

from ..core import projective
from ..core.pose import WorldToCamera
from ..geom.epipolar import cross
from ..ops.eigen import svd3
from ..ops.precision import full_f32

MIN_SAMPLES = 3
MODELS_PER_SAMPLE = 4
GAUSS_NEWTON_ITERATIONS = 5


def _cube_root(b, c, d):
    """Most stable real root of r^3 + b r^2 + c r + d (lib.rs:458-506)."""
    diff = b * b - 3.0 * c
    has_stationary = diff >= 0.0
    v = torch.sqrt(torch.clamp(diff, min=0.0))
    t1 = (-b - v) / 3.0
    k1 = ((t1 + b) * t1 + c) * t1 + d
    r_t1 = t1 - torch.sqrt(torch.clamp(-k1 / (3.0 * t1 + b), min=0.0))
    t2 = (-b + v) / 3.0
    k2 = ((t2 + b) * t2 + c) * t2 + d
    r_t2 = t2 + torch.sqrt(torch.clamp(-k2 / (3.0 * t2 + b), min=0.0))
    r_stat = torch.where(k1 > 0.0, r_t1, r_t2)
    # Monotonic case: start at the inflection point, nudged off a flat spot.
    r_mono = -b / 3.0
    flat = ((3.0 * r_mono + 2.0 * b) * r_mono + c).abs() < 1e-4
    r_mono = torch.where(flat, r_mono + 1.0, r_mono)
    r0 = torch.where(has_stationary, r_stat, r_mono)
    # 7 unconditional Newton steps, then up to 43 guarded ones (:491-505).
    for i in range(50):
        fx = ((r0 + b) * r0 + c) * r0 + d
        fpx = (3.0 * r0 + 2.0 * b) * r0 + c
        step = fx / fpx
        if i >= 7:
            step = torch.where(fx.abs() > 1e-13, step, torch.zeros_like(step))
        r0 = r0 - step
    return r0


def _root2real(b, c):
    """Real roots of r^2 + b r + c in the stable form (lib.rs:423-435);
    returns ``(real, r1, r2)``."""
    disc = b * b - 4.0 * c
    real = disc >= 0.0
    y = torch.sqrt(torch.clamp(disc, min=0.0))
    neg = b < 0.0
    r1 = torch.where(neg, 0.5 * (-b + y), 2.0 * c / (-b + y))
    r2 = torch.where(neg, 0.5 * (-b - y), 2.0 * c / (-b - y))
    half = 0.5 * b
    return real, torch.where(real, r1, half), torch.where(real, r2, half)


def _eigen_singular(m):
    """Closed-form eigen decomposition of a singular symmetric 3x3
    (lib.rs:510-554): ``(vectors (..., 3, 3) in columns, values (..., 2))``."""
    m11, m12, m13 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m22, m23, m33 = m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]
    m21, m31, m32 = m[..., 1, 0], m[..., 2, 0], m[..., 2, 1]
    v3 = torch.stack([m21 * m32 - m31 * m22, m31 * m12 - m32 * m11, m22 * m11 - m21 * m12], dim=-1)
    v3 = v3 / torch.linalg.vector_norm(v3, dim=-1, keepdim=True)

    x12_sqr = m12 * m12
    b = -m11 - m22 - m33
    c = -x12_sqr - m13 * m13 - m23 * m23 + m11 * (m22 + m33) + m22 * m33
    _, e1, e2 = _root2real(b, c)
    swap = e1.abs() < e2.abs()
    e1, e2 = torch.where(swap, e2, e1), torch.where(swap, e1, e2)

    mx0011 = -m11 * m22
    prec_0 = m12 * m23 - m13 * m22
    prec_1 = m12 * m13 - m11 * m23

    def vec(e):
        tmp = 1.0 / (e * (m11 + m22) + mx0011 - e * e + x12_sqr)
        a1 = -(e * m13 + prec_0) * tmp
        a2 = -(e * m23 + prec_1) * tmp
        rnorm = 1.0 / torch.sqrt(a1 * a1 + a2 * a2 + 1.0)
        return torch.stack([a1 * rnorm, a2 * rnorm, rnorm], dim=-1)

    vectors = torch.stack([vec(e1), vec(e2), v3], dim=-1)  # columns
    return vectors, torch.stack([e1, e2], dim=-1)


def _gauss_newton_refine(lmbda, a12, a13, a23, b12, b13, b23):
    """Depth refinement with the residual-increase guard (lib.rs:361-412)."""

    def residual(l1, l2, l3):
        r1 = l1 * l1 + l2 * l2 + b12 * l1 * l2 - a12
        r2 = l1 * l1 + l3 * l3 + b13 * l1 * l3 - a13
        r3 = l2 * l2 + l3 * l3 + b23 * l2 * l3 - a23
        return r1, r2, r3

    l1, l2, l3 = lmbda[..., 0], lmbda[..., 1], lmbda[..., 2]
    r1, r2, r3 = residual(l1, l2, l3)
    l1n = r1.abs() + r2.abs() + r3.abs()
    # ``stopped`` latches the small-residual and residual-increase breaks.
    stopped = l1n < 1e-10
    for _ in range(GAUSS_NEWTON_ITERATIONS):
        dr1dl1 = 2.0 * l1 + b12 * l2
        dr1dl2 = 2.0 * l2 + b12 * l1
        dr2dl1 = 2.0 * l1 + b13 * l3
        dr2dl3 = 2.0 * l3 + b13 * l1
        dr3dl2 = 2.0 * l2 + b23 * l3
        dr3dl3 = 2.0 * l3 + b23 * l2
        det = 1.0 / (-dr1dl1 * dr2dl3 * dr3dl2 - dr1dl2 * dr2dl1 * dr3dl3)
        n1 = -dr2dl3 * dr3dl2 * r1 + -dr1dl2 * dr3dl3 * r2 + dr1dl2 * dr2dl3 * r3
        n2 = -dr2dl1 * dr3dl3 * r1 + dr1dl1 * dr3dl3 * r2 + -dr1dl1 * dr2dl3 * r3
        n3 = dr2dl1 * dr3dl2 * r1 + -dr1dl1 * dr3dl2 * r2 + -dr1dl2 * dr2dl1 * r3
        l1_new, l2_new, l3_new = l1 - det * n1, l2 - det * n2, l3 - det * n3
        r1n, r2n, r3n = residual(l1_new, l2_new, l3_new)
        l1n_new = r1n.abs() + r2n.abs() + r3n.abs()
        worse = l1n_new > l1n
        accept = ~stopped & ~worse
        l1 = torch.where(accept, l1_new, l1)
        l2 = torch.where(accept, l2_new, l2)
        l3 = torch.where(accept, l3_new, l3)
        r1 = torch.where(accept, r1n, r1)
        r2 = torch.where(accept, r2n, r2)
        r3 = torch.where(accept, r3n, r3)
        l1n = torch.where(accept, l1n_new, l1n)
        stopped = stopped | worse | (l1n < 1e-10)
    return torch.stack([l1, l2, l3], dim=-1)


def _det3(m):
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def _inv3(m):
    """3x3 inverse by the adjugate (the reference takes nalgebra's inverse)."""
    c0 = cross(m[..., :, 1], m[..., :, 2])
    c1 = cross(m[..., :, 2], m[..., :, 0])
    c2 = cross(m[..., :, 0], m[..., :, 1])
    return torch.stack([c0, c1, c2], dim=-2) / _det3(m)[..., None, None]


@full_f32
def _closest_rotation(m):
    """Nearest proper rotation (SVD polar factor; the reference iterates
    ``Rotation3::from_matrix_eps`` to the same point, lib.rs:307-315)."""
    u, _, vt = svd3(m)
    det = _det3(u @ vt)
    fix = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (u * fix[..., None, :]) @ vt


@full_f32
def estimate(bearings: torch.Tensor, world_points: torch.Tensor):
    """Solve P3P for batches of 3-point samples.

    ``bearings``: (..., 3, 3) unit bearings (one row per correspondence);
    ``world_points``: (..., 3, 4) projective world points.  Returns
    ``(WorldToCamera with batch (..., 4), valid (..., 4))``.
    """
    finite = projective.is_finite(world_points) & (world_points[..., 3].abs() > 0)
    sample_ok = finite.all(dim=-1)
    wps = projective.point(world_points)
    wps = torch.where(sample_ok[..., None, None], wps, torch.zeros_like(wps))
    y1, y2, y3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    x1, x2, x3 = wps[..., 0, :], wps[..., 1, :], wps[..., 2, :]

    d12, d13, d23 = x1 - x2, x1 - x3, x2 - x3
    d12xd13 = cross(d12, d13)
    a12 = (d12 * d12).sum(dim=-1)
    a13 = (d13 * d13).sum(dim=-1)
    a23 = (d23 * d23).sum(dim=-1)
    c12 = (y1 * y2).sum(dim=-1)
    c23 = (y2 * y3).sum(dim=-1)
    c31 = (y3 * y1).sum(dim=-1)
    blob = c12 * c23 * c31 - 1.0
    s12_sqr, s23_sqr, s31_sqr = 1.0 - c12 * c12, 1.0 - c23 * c23, 1.0 - c31 * c31
    b12, b13, b23 = -2.0 * c12, -2.0 * c31, -2.0 * c23

    p3 = a13 * (a23 * s31_sqr - a13 * s23_sqr)
    p2 = 2.0 * blob * a23 * a13 + a13 * (2.0 * a12 + a13) * s23_sqr + a23 * (a23 - a12) * s31_sqr
    p1 = a23 * (a13 - a23) * s12_sqr - a12 * a12 * s23_sqr - 2.0 * a12 * (blob * a23 + a13 * s23_sqr)
    p0 = a12 * (a12 * s23_sqr - a23 * s12_sqr)
    g = _cube_root(p2 / p3, p1 / p3, p0 / p3)

    d0_00 = a23 * (1.0 - g)
    d0_01 = -(a23 * c12)
    d0_02 = a23 * c31 * g
    d0_11 = a23 - a12 + a13 * g
    d0_12 = -c23 * (a13 * g - a12)
    d0_22 = g * (a13 - a23) - a12
    d0 = torch.stack(
        [
            torch.stack([d0_00, d0_01, d0_02], dim=-1),
            torch.stack([d0_01, d0_11, d0_12], dim=-1),
            torch.stack([d0_02, d0_12, d0_22], dim=-1),
        ],
        dim=-2,
    )
    ev, eig_values = _eigen_singular(d0)
    eigen_ratio = torch.sqrt(torch.clamp(-eig_values[..., 1] / eig_values[..., 0], min=0.0))

    def lambdas_for_ratio(ratio):
        # Quadratic coefficients, eq. (15) (lib.rs:206-216).
        w2 = 1.0 / (ratio * ev[..., 0, 1] - ev[..., 0, 0])
        w0 = w2 * (ev[..., 1, 0] - ratio * ev[..., 1, 1])
        w1 = w2 * (ev[..., 2, 0] - ratio * ev[..., 2, 1])
        a = 1.0 / ((a13 - a12) * w1 * w1 - a12 * b13 * w1 - a12)
        bq = a * (a13 * b12 * w1 - a12 * b13 * w0 - 2.0 * w0 * w1 * (a12 - a13))
        cq = a * ((a13 - a12) * w0 * w0 + a13 * b12 * w0 + a13)
        disc_ok = bq * bq - 4.0 * cq >= 0.0
        _, tau1, tau2 = _root2real(bq, cq)

        def depths(tau):
            # eq. (16) (lib.rs:220-231).
            d = a23 / (tau * (b23 + tau) + 1.0)
            l2 = torch.sqrt(torch.clamp(d, min=0.0))
            l3 = tau * l2
            l1 = w0 * l2 + w1 * l3
            ok = disc_ok & (tau > 0.0) & (d > 0.0) & (l1 >= 0.0)
            return torch.stack([l1, l2, l3], dim=-1), ok

        return depths(tau1), depths(tau2)

    (lam_a, ok_a), (lam_b, ok_b) = lambdas_for_ratio(eigen_ratio)
    (lam_c, ok_c), (lam_d, ok_d) = lambdas_for_ratio(-eigen_ratio)
    lambdas = torch.stack([lam_a, lam_b, lam_c, lam_d], dim=-2)  # (..., 4, 3)
    lam_ok = torch.stack([ok_a, ok_b, ok_c, ok_d], dim=-1)  # (..., 4)

    x_mat = torch.stack([d12, d13, d12xd13], dim=-1)  # (..., 3, 3) columns
    x_ok = _det3(x_mat).abs() > 0
    eye = torch.eye(3, dtype=x_mat.dtype, device=x_mat.device)
    x_inv = _inv3(torch.where(x_ok[..., None, None], x_mat, eye))

    lam = _gauss_newton_refine(
        lambdas, a12[..., None], a13[..., None], a23[..., None],
        b12[..., None], b13[..., None], b23[..., None],
    )
    ry1 = lam[..., 0:1] * y1[..., None, :]
    ry2 = lam[..., 1:2] * y2[..., None, :]
    ry3 = lam[..., 2:3] * y3[..., None, :]
    yd1, yd2 = ry1 - ry2, ry1 - ry3
    y_mat = torch.stack([yd1, yd2, cross(yd1, yd2)], dim=-1)  # (..., 4, 3, 3)
    rot = _closest_rotation(y_mat @ x_inv[..., None, :, :])
    trans = ry1 - (rot * x1[..., None, None, :]).sum(dim=-1)

    valid = lam_ok & x_ok[..., None] & sample_ok[..., None]
    valid &= torch.isfinite(rot).all(dim=-1).all(dim=-1) & torch.isfinite(trans).all(dim=-1)
    return WorldToCamera(rotation=rot, translation=trans), valid
