"""Pose optimizers: single-view (PnP refine) and three-view gradient descent.

Port of ``cv_tpu/optimize/optimizers.py`` (reference cv-optimize/src/).
These are the plain PyTorch versions of the three hand-written kernels in
:mod:`cv_tpu_torch.optimize.resident`: Python loops over tensor ops, in the
dtype they are given.  The per-landmark tangents are masked tensors; the
patience rule is the reference's (stop after ``PATIENCE`` steps in which no
sum norm improved; the stabilizing step is not applied, every other step
is).  A patience loop reads one flag per step back to the host.

Sums over the landmark axis run in a fixed sequential order
(:func:`_landmark_sum`) and the single-problem loops drop invalid rows
before they start, so padding a problem with invalid rows changes no bit
of the result.
"""

from __future__ import annotations

import torch

from ..core import projective
from ..core.pose import Isometry3
from ..geom import epipolar

PATIENCE = 50  # single_view_optimizer.rs:116


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _landmark_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the landmark axis (-2) of ``(..., N, 3)``, left to right:
    trailing zero rows leave the result's bits unchanged."""
    if x.shape[-2] == 0:
        return x.sum(dim=-2)
    return x.cumsum(dim=-2)[..., -1, :]


def _inv_len(valid: torch.Tensor, dtype) -> torch.Tensor:
    return 1.0 / torch.clamp(valid.sum(dim=-1).to(dtype), min=1.0)


def _apply_tangent(t, r, pose: Isometry3) -> Isometry3:
    """``delta.isometry() * pose`` (single_view_optimizer.rs:72), keeping
    the pose's frame type."""
    out = Isometry3.from_tangent(t, r).compose(pose)
    return type(pose)(rotation=out.rotation, translation=out.translation)


def landmark_deltas(pose: Isometry3, bearings, world_points, valid):
    """Per-landmark se(3) tangents for PnP (single_view_optimizer.rs:4-14);
    landmarks whose camera point lies at infinity contribute nothing."""
    cam = pose.transform(world_points)  # (N, 4)
    finite_point = cam[..., 3] != 0.0
    pt = projective.point(cam)
    t, r = epipolar.world_pose_gradient(pt, bearings)
    contrib = valid & finite_point & torch.isfinite(pt).all(dim=-1)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.where(contrib[..., None], t, zero), torch.where(contrib[..., None], r, zero), contrib


def single_view_simple_optimize_l2(
    pose: Isometry3, bearings, world_points, valid, optimization_rate: float, iterations: int, steps_out=None
) -> Isometry3:
    """Mean-gradient descent with patience (single_view_optimizer.rs:80-135).

    ``bearings``: (N, 3); ``world_points``: (N, 4) homogeneous; ``valid``:
    (N,) bool.  Returns the pose in its own type and dtype.  ``steps_out``,
    a one-element int32 tensor on any device, gets the number of steps
    taken (calls of :func:`landmark_deltas`).
    """
    inv_len = _inv_len(valid, pose.dtype)
    # Invalid rows never contribute: drop them once (same sums, same bits).
    bearings, world_points, valid = bearings[valid], world_points[valid], valid[valid]
    best_t = best_r = float("inf")
    stale = 0
    it = 0
    while it < iterations and stale < PATIENCE:
        t, r, _ = landmark_deltas(pose, bearings, world_points, valid)
        l2_t, l2_r = _landmark_sum(t), _landmark_sum(r)
        nt, nr = (float(x) for x in torch.stack([_norm(l2_t), _norm(l2_r)]).tolist())
        stale = 0 if (best_t > nt or best_r > nr) else stale + 1
        best_t, best_r = min(best_t, nt), min(best_r, nr)
        if stale < PATIENCE:  # the stabilizing step is not applied
            pose = _apply_tangent(l2_t * inv_len * optimization_rate, l2_r * inv_len * optimization_rate, pose)
        it += 1
    if steps_out is not None:
        steps_out.fill_(it)
    return pose


def _three_view_landmark_gradients(ftoc: Isometry3, stoc: Isometry3, observations):
    """Per-landmark tangents of both non-center poses
    (three_view_optimizer.rs:7-21).  ``observations``: (..., N, 3, 3)
    bearings (center, first, second); poses have batch shape ``(...)``."""
    c = observations[..., 0, :]
    f = (ftoc.rotation[..., None, :, :] * observations[..., 1, None, :]).sum(dim=-1)
    s = (stoc.rotation[..., None, :, :] * observations[..., 2, None, :]).sum(dim=-1)
    return epipolar.three_view_gradients(
        c, f, ftoc.translation[..., None, :], s, stoc.translation[..., None, :]
    )


def _masked(valid, *vs):
    zero = torch.zeros((), dtype=vs[0].dtype, device=vs[0].device)
    return tuple(torch.where(valid[..., None], v, zero) for v in vs)


def three_view_simple_optimize_l2(
    poses: tuple, observations, valid, optimization_rate: float, iterations: int, steps_out=None
):
    """Mean-gradient three-view optimization with patience over the four sum
    norms (three_view_optimizer.rs:126-200).

    ``poses``: (center->first, center->second) camera-to-camera isometries;
    ``observations``: (N, 3, 3); ``valid``: (N,).  Returns the pose pair.
    ``steps_out``, a one-element int32 tensor on any device, gets the number
    of steps taken (calls of the per-landmark tangents).
    """
    ftoc, stoc = poses[0].inverse(), poses[1].inverse()
    inv_len = _inv_len(valid, ftoc.dtype)
    scale = inv_len * optimization_rate
    # Invalid rows never contribute: drop them once (same sums, same bits).
    observations, valid = observations[valid], valid[valid]
    bests = [float("inf")] * 4
    stale = 0
    it = 0
    while it < iterations and stale < PATIENCE:
        (t1, r1), (t2, r2) = _three_view_landmark_gradients(ftoc, stoc, observations)
        t1, r1, t2, r2 = _masked(valid, t1, r1, t2, r2)
        sums = [_landmark_sum(x) for x in (t1, r1, t2, r2)]
        norms = torch.stack([_norm(x) for x in sums]).tolist()
        stale = 0 if any(b > n for b, n in zip(bests, norms)) else stale + 1
        bests = [min(b, n) for b, n in zip(bests, norms)]
        if stale < PATIENCE:  # the stabilizing step is not applied
            ftoc = _apply_tangent(sums[0] * scale, sums[1] * scale, ftoc)
            stoc = _apply_tangent(sums[2] * scale, sums[3] * scale, stoc)
        it += 1
    if steps_out is not None:
        steps_out.fill_(it)
    return ftoc.inverse(), stoc.inverse()


def three_view_adaptive_optimize_l2(poses: tuple, observations, valid, iterations: int):
    """L2 with the adaptive signal-to-noise rate |mean| / mean norm, for a
    fixed number of iterations (three_view_optimizer.rs:203-272).

    Batched over leading dimensions: poses with batch shape ``(K,)``,
    ``observations`` (K, N, 3, 3), ``valid`` (K, N) run K independent
    problems (the engine's constraint batch); unbatched inputs work too.
    """
    ftoc, stoc = poses[0].inverse(), poses[1].inverse()
    inv_len = _inv_len(valid, ftoc.dtype)[..., None]
    zero = torch.zeros((), dtype=ftoc.dtype, device=ftoc.translation.device)
    for _ in range(iterations):
        (t1, r1), (t2, r2) = _three_view_landmark_gradients(ftoc, stoc, observations)
        t1, r1, t2, r2 = _masked(valid, t1, r1, t2, r2)
        new = []
        for pose, t, r in ((ftoc, t1, r1), (stoc, t2, r2)):
            mean_t = _landmark_sum(t) * inv_len
            mean_r = _landmark_sum(r) * inv_len
            tstd = _landmark_sum(torch.where(valid, _norm(t), zero)[..., None])[..., 0] * inv_len[..., 0]
            rstd = _landmark_sum(torch.where(valid, _norm(r), zero)[..., None])[..., 0] * inv_len[..., 0]
            trate = _norm(mean_t) / tstd
            rrate = _norm(mean_r) / rstd
            trate = torch.where(torch.isfinite(trate), trate, zero)
            rrate = torch.where(torch.isfinite(rrate), rrate, zero)
            new.append(_apply_tangent(mean_t * trate[..., None], mean_r * rrate[..., None], pose))
        ftoc, stoc = new
    return ftoc.inverse(), stoc.inverse()
