"""The engine's device passes: graph bundle adjustment, the fused BA +
observation filter, and the single-view registration cascade.

Port of ``cv_tpu/sfm/device_refine.py`` (reference cv-sfm/src/lib.rs:
1452-1812 registration, 1892-1936 and 2382-2414 graph BA, 2657-2757 the
observation filter, 2937-2967 the consistency predicate).  Each pass runs
over padded ``(match, observation)`` or ``(landmark, observation)`` tensors
on the engine's device, and its verdicts come back to the host in one
copy.  The registration cascade's pose optimizer is kernel A
(:func:`cv_tpu_torch.optimize.single_view_l2`): on a CUDA tensor each of
its ``filter_iterations + 1`` calls is one launch of the whole patience
loop.
"""

from __future__ import annotations

import torch

from ..core import projective
from ..core.lie import so3_exp, so3_log
from ..core.pose import Isometry3
from ..geom import epipolar
from ..optimize import single_view_l2
from ..ops.precision import full_f32
from ..triangulate import linear_eigen


def _mv(m, v):
    return (m * v[..., None, :]).sum(dim=-1)


def _mtv(m, v):
    """``m^T @ v``."""
    return (m * v[..., :, None]).sum(dim=-2)


def incoming_edges(edge_to: torch.Tensor, edge_valid: torch.Tensor, v_count: int) -> torch.Tensor:
    """``(V, D)`` int64 table of each view's valid incoming edges in edge
    order, D the largest such in-degree; a view's unused slots hold ``E``
    (the index of an appended zero row).  An invalid edge only ever adds an
    exact zero, so leaving it out changes no bit.  One host read (D)."""
    e = edge_to.shape[0]
    to = torch.where(edge_valid, edge_to, v_count)  # invalid edges to a dropped extra row
    counts = torch.bincount(to, minlength=v_count + 1)
    depth = int(counts[:v_count].max()) if e else 0
    order = torch.argsort(to, stable=True)
    to_sorted = to[order]
    rank = torch.arange(e, device=edge_to.device) - (torch.cumsum(counts, 0) - counts)[to_sorted]
    table = torch.full((v_count + 1, max(depth, 1)), e, dtype=torch.int64, device=edge_to.device)
    keep = rank < table.shape[1]
    table[to_sorted[keep], rank[keep]] = order[keep]
    return table[:v_count, :depth]


def per_view_sum(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``out[v] = 0 + rows[table[v, 0]] + rows[table[v, 1]] + ...``, left to
    right: ``cv_tpu``'s ``.at[edge_to].add`` order, the same on every
    device (``Tensor.index_add_`` adds with atomics on CUDA).  One
    ``cumsum`` along the slots: a scan over a dimension that is not the
    last runs each column sequentially from 0 on the CPU and on CUDA, so in
    float64 (the engine's dtype) it rounds as the elementwise adds would (a
    CPU accumulates float32 in float64).  Padding slots add an exact
    zero."""
    flat = rows.reshape(rows.shape[0], -1)
    if table.shape[1] == 0:
        return rows.new_zeros((table.shape[0],) + rows.shape[1:])
    padded = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
    total = torch.cumsum(padded[table], dim=1)[:, -1]  # (V, C): the scan runs along the slots
    return total.reshape((table.shape[0],) + rows.shape[1:])


@full_f32
def graph_ba_core(rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid, iterations: int, rate: float):
    """Graph bundle adjustment (lib.rs:1892-1936, 2382-2414, 2543-2567).

    ``rot``/``trans``: (V, 3, 3)/(V, 3) world-to-view poses; ``edge_*``:
    (E,) directed constraints with the expected other->view isometries.
    Each of ``iterations`` rounds sums, per view, the se(3) logs of
    ``expected_other_to_view . world_to_other . view_to_world^-1`` over its
    incident edges in edge order (:func:`per_view_sum`, so the card gives
    the same bits from run to run), scales by ``rate`` and left-applies the
    result.  Views whose delta goes non-finite are removed (a sticky mask)
    with their edges.  Returns ``(rot, trans, removed)``.
    """
    v_count = rot.shape[0]
    edge_to = edge_to.long()
    edge_from = edge_from.long()
    incoming = incoming_edges(edge_to, edge_valid, v_count)
    has_edge = torch.zeros(v_count, dtype=torch.int32, device=rot.device).scatter_reduce(
        0, edge_to, edge_valid.to(torch.int32), reduce="amax"
    ) > 0
    removed = ~has_edge
    zero = torch.zeros((), dtype=rot.dtype, device=rot.device)
    for _ in range(iterations):
        r_from, t_from = rot[edge_from], trans[edge_from]
        r_to, t_to = rot[edge_to], trans[edge_to]
        # world_to_other . view_to_world: R = Rf Rt^T, t = tf - Rf Rt^T tt
        r_rel = r_from @ r_to.transpose(-1, -2)
        t_rel = t_from - _mv(r_rel, t_to)
        r_d = edge_rot @ r_rel
        t_d = _mv(edge_rot, t_rel) + edge_t
        se3_log = torch.cat([t_d, so3_log(r_d)], dim=-1)  # (E, 6)
        ok_edge = edge_valid & ~removed[edge_from] & ~removed[edge_to]
        se3_log = torch.where(ok_edge[:, None], se3_log, zero)
        net = per_view_sum(se3_log, incoming) * rate
        finite = torch.isfinite(net).all(dim=-1) & has_edge & ~removed
        dr = so3_exp(net[:, 3:6])
        new_rot = dr @ rot
        new_trans = _mv(dr, trans) + net[:, 0:3]
        rot = torch.where(finite[:, None, None], new_rot, rot)
        trans = torch.where(finite[:, None], new_trans, trans)
        removed = removed | ~finite
    return rot, trans, removed


@full_f32
def ba_filter(
    rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid,
    lm_view,  # (L, O) int indices into the view arrays
    lm_bear,  # (L, O, 3) observation bearings
    lm_mask,  # (L, O) real observations (front-packed per row)
    lm_valid,  # (L,) real landmark rows
    max_sine: float,
    max_cos: float,
    incidence_thresh: float,
    needed_obs: int,
    iterations: int,
    rate: float,
):
    """Graph BA chained with the observation filter (lib.rs:2343-2355,
    2657-2757): after BA, each landmark's verdict depends only on the
    post-BA poses and its own observations.

    Returns ``(rot, trans, removed (V,), kill (L,), bad_obs (L, O),
    robust_count)``: ``kill`` splits the whole landmark (2-observation
    epipolar failure or untriangulatable), ``bad_obs`` kicks single
    observations (cosine gate), ``robust_count`` counts the landmarks
    ``is_landmark_robust`` keeps after the splits.
    """
    rot, trans, removed = graph_ba_core(
        rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid, iterations, rate
    )
    lm_view = lm_view.long()
    ro, to = rot[lm_view], trans[lm_view]  # (L, O, 3, 3), (L, O, 3)
    m = lm_mask & lm_valid[:, None]
    n_obs = m.sum(dim=1)
    # 2-observation rows: epipolar gate on the first two slots under
    # pose1 . inverse(pose0) (lib.rs:2680-2695).
    r_rel = ro[:, 1] @ ro[:, 0].transpose(-1, -2)
    t_rel = to[:, 1] - _mv(r_rel, to[:, 0])
    two_ok = epipolar.loss(t_rel, _mv(r_rel, lm_bear[:, 0]), lm_bear[:, 1]) < max_sine
    # >= 3-observation rows: triangulate and kick cosine outliers.
    poses = Isometry3(rotation=ro, translation=to)
    point, tri_ok = linear_eigen.triangulate_observations(poses, lm_bear, valid=m)
    cam = poses.transform(point[:, None, :])  # (L, O, 4)
    cosd = 1.0 - (projective.bearing(cam) * lm_bear).sum(dim=-1)
    bad = (cosd > max_cos) & m
    two = n_obs == 2
    many = n_obs >= 3
    kill = lm_valid & ((two & ~two_ok) | (many & ~tri_ok))
    bad_obs = bad & (many & tri_ok)[:, None]
    # Post-split robust recount (lib.rs:2907-2934 over the survivors).
    remaining = m & ~bad_obs & ~kill[:, None]
    wb = _mtv(ro, lm_bear)  # world bearings R^T b
    dots = 1.0 - (wb[:, :, None, :] * wb[:, None, :, :]).sum(dim=-1)
    pair = remaining[:, :, None] & remaining[:, None, :]
    o = lm_mask.shape[1]
    iu = torch.triu(torch.ones((o, o), dtype=torch.bool, device=rot.device), 1)
    any_pair = ((dots > incidence_thresh) & pair & iu).any(dim=2).any(dim=1)
    robust = (remaining.sum(dim=1) >= needed_obs) & any_pair & lm_valid & ~kill
    return rot, trans, removed, kill, bad_obs, robust.sum(dtype=torch.int32)


def _optimize_l2(pose, bearings, points, active, rate, patience):
    """The cascade's pose optimizer: kernel A on a CUDA tensor, its plain
    version on a CPU tensor (single_view_optimizer.rs:80-135)."""
    return single_view_l2(pose, bearings, points, active, rate, patience)


@full_f32
def _consistency_mask(pose: Isometry3, bearings, n_others, obs_rot, obs_trans, all_bear, all_mask,
                      max_sine, max_cos):
    """``is_observation_consistent`` (lib.rs:2937-2967) for every match."""
    m = bearings.shape[0]
    # Several other observations: triangulate them with the new one and
    # require every reprojection under the cosine gate.
    all_rot = torch.cat([obs_rot, pose.rotation.expand(m, 1, 3, 3)], dim=1)
    all_t = torch.cat([obs_trans, pose.translation.expand(m, 1, 3)], dim=1)
    poses = Isometry3(rotation=all_rot, translation=all_t)
    point, ok = linear_eigen.triangulate_observations(poses, all_bear, valid=all_mask)
    cam = poses.transform(point[:, None, :])  # (M, O+1, 4)
    cosd = 1.0 - (projective.bearing(cam) * all_bear).sum(dim=-1)
    multi_ok = ok & ((cosd < max_cos) | ~all_mask).all(dim=-1)
    # One other observation: bi-landmark robustness under other . pose^-1
    # (lib.rs:2940-2951, 1306-1317).
    r_rel = obs_rot[:, 0] @ pose.rotation.transpose(-1, -2)
    t_rel = obs_trans[:, 0] - _mv(r_rel, pose.translation)
    bi_ok = epipolar.loss(t_rel, _mv(r_rel, bearings), all_bear[:, 0]) < max_sine
    return torch.where(n_others == 1, bi_ok, multi_ok)


def register_refine(
    rot0,  # (3, 3) consensus pose
    t0,  # (3,)
    bearings,  # (M, 3) new-frame bearing per candidate match
    points,  # (M, 4) robust landmark points (zeros when not robust)
    point_ok,  # (M,) robust_point(landmarks) is not None
    match_valid,  # (M,) real (non-padded) match
    obs_rot,  # (M, O, 3, 3) landmark observations ("others")
    obs_trans,  # (M, O, 3)
    obs_bear,  # (M, O, 3)
    obs_mask,  # (M, O)
    inlier_mask,  # (NB,) consensus inliers over the compacted point_ok rows
    ok_positions,  # (M,) row i's index into the compacted rows (cumsum - 1)
    max_sine: float,
    max_cos: float,
    filter_iterations: int,
    cap: int,
    rate: float,
    patience: int,
):
    """The registration filter cascade: ``filter_iterations`` rounds of
    (optimize the pose over the active matches, recompute the consistency
    of every candidate, cap the active set in match order), then a final
    optimize and consistency pass.

    Returns ``(rotation, translation, final_consistent (M,), counts
    (filter_iterations,), final_count, final_robust, c0)``; ``counts[i]``
    is the active count after round ``i`` and ``c0`` the initial capped
    active-set size, so the host can replay the reference's early outs
    (lib.rs:1619-1704) from one copy.
    """
    pose = Isometry3(rotation=rot0, translation=t0)
    inlier_full = point_ok & inlier_mask[ok_positions.long()]
    active = inlier_full & (torch.cumsum(inlier_full, dim=0) <= cap)
    c0 = active.sum(dtype=torch.int32)
    m = bearings.shape[0]
    n_others = obs_mask.sum(dim=1)
    all_bear = torch.cat([obs_bear, bearings[:, None, :]], dim=1)
    all_mask = torch.cat([obs_mask, torch.ones((m, 1), dtype=torch.bool, device=obs_mask.device)], dim=1)

    def consistent(pose):
        return _consistency_mask(pose, bearings, n_others, obs_rot, obs_trans, all_bear, all_mask, max_sine, max_cos)

    counts = []
    for _ in range(filter_iterations):
        pose = _optimize_l2(pose, bearings, points, active, rate, patience)
        c = consistent(pose) & point_ok & match_valid
        active = c & (torch.cumsum(c, dim=0) <= cap)
        counts.append(active.sum(dtype=torch.int32))
    pose = _optimize_l2(pose, bearings, points, active, rate, patience)
    fmask = consistent(pose) & match_valid
    counts = torch.stack(counts) if counts else torch.zeros(0, dtype=torch.int32, device=rot0.device)
    return (
        pose.rotation,
        pose.translation,
        fmask,
        counts,
        fmask.sum(dtype=torch.int32),
        (fmask & point_ok).sum(dtype=torch.int32),
        c0,
    )
