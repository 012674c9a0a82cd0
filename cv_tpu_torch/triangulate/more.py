"""The remaining triangulator family (cv-geom/src/triangulation.rs).

Port of ``cv_tpu/triangulate/more.py``:

* :func:`sine_l1`: Linear-Eigen init, then epipolar gradient descent
  (triangulation.rs:164-276);
* :func:`relative_dlt`: the two-view DLT, H&Z algorithm 12 (:280-363);
* :func:`mean_mean`: the skew-line average (:365-442);
* :func:`angular_l1` / :func:`angular_linf`: closed-form optimal two-view
  triangulation on angular errors (:470-606).

All batched; each returns ``(point, ok)``: homogeneous ``(..., 4)`` points
in the invariant form and the finite/cheirality mask that stands in for the
reference's Options.
"""

from __future__ import annotations

import torch

from ..core import projective
from ..core.pose import Isometry3
from ..geom import epipolar
from ..ops import eigen, trig
from ..ops.precision import full_f32
from .linear_eigen import triangulate_observations as linear_eigen_observations


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def sine_l1(
    poses: Isometry3,
    bearings: torch.Tensor,
    valid: torch.Tensor | None = None,
    epsilon: float = 1e-12,
    max_iterations: int = 1000,
    optimization_rate: float = 1.0,
):
    """Linear-Eigen init, then gradient descent on the epipolar point
    gradient (triangulation.rs:229-276): each element steps until its step
    is below ``epsilon`` of its distance from the origin (a per-element
    mask), all of them for at most ``max_iterations`` steps.  Points at
    infinity skip the refinement and come back as the init gives them.
    ``poses``: world-to-camera, batch ``(..., V)``; ``bearings`` ``(..., V,
    3)``; ``valid`` ``(..., V)``.  One flag a step is read to the host."""
    init, ok = linear_eigen_observations(poses, bearings, valid)
    at_inf = init[..., 3] == 0.0
    zero = torch.zeros((), dtype=init.dtype, device=init.device)
    point = torch.where(at_inf[..., None], zero, projective.point(init))

    inv = poses.inverse()
    centers = inv.translation  # (..., V, 3) camera centers in world
    world_bearings = inv.rotate(bearings)
    if valid is None:
        count = torch.full(point.shape[:-1], bearings.shape[-2], dtype=point.dtype, device=point.device)
        vmask = torch.ones(bearings.shape[:-1], dtype=torch.bool, device=point.device)
    else:
        count = valid.sum(dim=-1).to(point.dtype)
        vmask = valid
    scale = optimization_rate / count
    eps2 = epsilon * epsilon
    done = at_inf | ~ok
    it = 0
    while it < max_iterations and not bool(done.all()):
        grad = epipolar.point_gradient(centers - point[..., None, :], world_bearings)
        grad = torch.where(vmask[..., None], grad, zero)
        delta = scale[..., None] * grad.sum(dim=-2)
        new_point = point + delta
        converged = _dot(delta, delta) / _dot(new_point, new_point) < eps2
        point = torch.where(done[..., None], point, new_point)
        done = done | converged
        it += 1
    return torch.where(at_inf[..., None], init, projective.from_point(point)), ok


@full_f32
def relative_dlt(pose: Isometry3, a: torch.Tensor, b: torch.Tensor):
    """Two-view DLT, H&Z algorithm 12 (triangulation.rs:322-363): the right
    null vector of the 4x4 design (the smallest eigenvector of its normal
    matrix, Jacobi).  ``pose``: CameraToCamera A->B; returns the point in
    A's frame."""
    h = pose.homogeneous()  # (..., 4, 4)
    zero = torch.zeros_like(a[..., 0])
    row0 = torch.stack([-a[..., 2], zero, a[..., 0], zero], dim=-1)
    row1 = torch.stack([zero, -a[..., 2], a[..., 1], zero], dim=-1)
    row2 = b[..., 0:1] * h[..., 2, :] - b[..., 2:3] * h[..., 0, :]
    row3 = b[..., 1:2] * h[..., 2, :] - b[..., 2:3] * h[..., 1, :]
    row0, row1, row2, row3 = torch.broadcast_tensors(row0, row1, row2, row3)
    design = torch.stack([row0, row1, row2, row3], dim=-2)
    _, v = eigen.eigh4(design.transpose(-1, -2) @ design)  # ascending eigenvalues
    point = projective.from_homogeneous(v[..., :, 0])
    finite = projective.is_finite(point)
    bearing = projective.bearing(point)
    b_in_a = (pose.rotation * b[..., :, None]).sum(dim=-2)  # R^T b
    cheir = (_dot(bearing, a) >= 0) & (_dot(bearing, b_in_a) >= 0)
    return point, finite & cheir


def mean_mean(poses: Isometry3, bearings: torch.Tensor, valid: torch.Tensor | None = None):
    """Mean-camera / mean-bearing skew-line average
    (triangulation.rs:390-442)."""
    inv = poses.inverse()
    centers = inv.translation  # (..., V, 3)
    wb = inv.rotate(bearings)
    zero = torch.zeros((), dtype=centers.dtype, device=centers.device)
    if valid is None:
        total = torch.full(centers.shape[:-2], centers.shape[-2], dtype=centers.dtype, device=centers.device)
        vmask = torch.ones(centers.shape[:-1], dtype=torch.bool, device=centers.device)
    else:
        total = valid.sum(dim=-1).to(centers.dtype)
        vmask = valid
    msk = vmask[..., None]
    avg_center = torch.where(msk, centers, zero).sum(dim=-2) / total[..., None]
    avg_bearing = _normalize(torch.where(msk, wb, zero).sum(dim=-2))

    trans = avg_center[..., None, :] - centers
    q = _cross(avg_bearing[..., None, :], wb)
    d = _dot(q / _dot(q, q)[..., None], _cross(wb, trans))
    avg_proj = torch.where(vmask, d, zero).sum(dim=-1) / total

    w = 1.0 / avg_proj
    point = projective.from_homogeneous(torch.cat([avg_bearing + avg_center * w[..., None], w[..., None]], dim=-1))
    finite = projective.is_finite(point)
    cheir = (_dot(wb, point[..., None, :3]) >= 0) | ~vmask
    return point, finite & cheir.all(dim=-1)


def _angular_common(a_c, b_c, translation):
    """Shared tail of the angular triangulators (triangulation.rs:508-530)."""
    z = _cross(b_c, a_c)
    w = _dot(z, z) / _dot(z, _cross(translation, a_c))
    point = projective.from_homogeneous(torch.cat([b_c, w[..., None]], dim=-1))
    finite = projective.is_finite(point)
    bearing = projective.bearing(point)
    cheir = (_dot(bearing, a_c) >= 0) & (_dot(bearing, b_c) >= 0)
    return point, finite & cheir


def angular_l1(pose: Isometry3, a: torch.Tensor, b: torch.Tensor):
    """Closed-form optimal two-view L1 angular triangulation
    (triangulation.rs:470-530), in the paper's frame (the second camera of
    the inverted pose, :489-492): the bearing with the smaller sine to the
    baseline is corrected onto the other's epipolar plane.  Returns the
    point in camera A's frame."""
    inv = pose.inverse()
    a_p, b_p = b, a
    a_t = inv.rotate(a_p)
    translation = inv.translation
    nt = _normalize(translation)
    cross_a = _cross(a_t, nt)
    ca = torch.linalg.vector_norm(cross_a, dim=-1)
    na = cross_a / ca[..., None]
    cross_b = _cross(b_p, nt)
    cb = torch.linalg.vector_norm(cross_b, dim=-1)
    nb = cross_b / cb[..., None]
    use_a = (ca < cb)[..., None]
    new_a = _normalize(a_t - _dot(a_t, nb)[..., None] * nb)
    new_b = _normalize(b_p - _dot(b_p, na)[..., None] * na)
    a_c = torch.where(use_a, new_a, a_t)
    b_c = torch.where(use_a, b_p, new_b)
    return _angular_common(a_c, b_c, translation)


def angular_linf(pose: Isometry3, a: torch.Tensor, b: torch.Tensor):
    """The L-infinity variant: both bearings corrected onto one common
    plane through the baseline (triangulation.rs:556-606)."""
    inv = pose.inverse()
    a_p, b_p = b, a
    a_t = inv.rotate(a_p)
    translation = inv.translation
    nt = _normalize(translation)
    na = _cross(a_t + b_p, nt)
    na2 = _dot(na, na)
    nb = _cross(a_t - b_p, nt)
    nb2 = _dot(nb, nb)
    n = torch.where((na2 > nb2)[..., None], na / trig.sqrt(na2)[..., None], nb / trig.sqrt(nb2)[..., None])
    a_c = _normalize(a_t - _dot(a_t, n)[..., None] * n)
    b_c = _normalize(b_p - _dot(b_p, n)[..., None] * n)
    return _angular_common(a_c, b_c, translation)
