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
loop.  Graph BA (:func:`graph_ba_core`) is on a CUDA tensor one launch of
``csrc/graph_ba.cu`` for all its rounds.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..core import projective
from ..core.pose import Isometry3
from ..geom import epipolar
from ..optimize import single_view_l2
from ..ops import trig
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
    device (``Tensor.index_add_`` adds with atomics on CUDA).  In float64
    (the engine's dtype) one ``cumsum`` along the slots: a scan over a
    dimension that is not the last runs each column sequentially from 0 on
    the CPU and on CUDA, so it rounds as the elementwise adds would; a CPU
    accumulates a float32 scan in float64, so float32 adds the slots one
    by one.  Padding slots add an exact zero; the leading zero is added
    last (a sum that starts from +0 is never -0, so ``x + 0`` there gives
    its bits whatever the order)."""
    flat = rows.reshape(rows.shape[0], -1)
    if table.shape[1] == 0:
        return rows.new_zeros((table.shape[0],) + rows.shape[1:])
    padded = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
    if rows.dtype == torch.float64:
        total = torch.cumsum(padded[table], dim=1)[:, -1]  # (V, C): the scan runs along the slots
    else:
        total = padded[table[:, 0]]
        for k in range(1, table.shape[1]):
            total = total + padded[table[:, k]]
    return (total + 0.0).reshape((table.shape[0],) + rows.shape[1:])


# The graph BA loop as cv_tpu's jitted fori_loop computes it on a CPU
# (XLA's optimized HLO and its x86 code): every 3-term product sum is
# x0 y0 + 0, then fma(x_k, y_k, acc), each step flushed as XLA's FTZ/DAZ
# flushes (trig.dot_fused); divisions by 6 and 24 are products by their
# rounded reciprocals, fused into the sum that takes them; the diagonal of
# hat(w)^2 is fma(-a, a, -(b b)); the Rodrigues matrix is
# fma(b, hat2, fma(a, hat, I)); the translation update fuses the rate,
# fma(sum, rate, dr t).  XLA writes sin / sqrt(t2s) as sin * rsqrt(t2s):
# on a CPU with AVX-512 its float64 rsqrt is the processor's vrsqrt14pd
# estimate and two Newton steps (the float32 one x86's vrsqrtps with
# Newton steps on any x86), bits that the processor defines; without
# AVX-512 (XLA's --xla_cpu_max_isa=AVX2) it is 1 / sqrt, which is what
# this form computes.


def _dot3(x, y):
    """``sum(x * y, -1)`` over the last dimension (3), in XLA's fused
    order with its flushes."""
    return trig.dot_fused(x, y, -1, flush=True)


def _mm3(a, b):
    """``a @ b`` of ``(..., 3, 3)`` matrices, each entry :func:`_dot3`."""
    return _dot3(a[..., :, None, :], b.transpose(-1, -2)[..., None, :, :])


def _mv3(m, v):
    """``m @ v`` of ``(..., 3, 3)`` and ``(..., 3)``, each entry :func:`_dot3`."""
    return _dot3(m, v[..., None, :])


def _so3_log_fused(r):
    """``core.lie.so3_log`` as the jitted loop computes it: the norms and
    the sign's dot product in :func:`_dot3`'s order, the Taylor scale
    ``fma(theta theta, 1/6, 1)`` and the generic vector ``raw (scale
    0.5)``."""
    dtype = r.dtype
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    raw = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1]], dim=-1)
    axis_sin = raw * 0.5
    sin_theta = trig.sqrt(_dot3(axis_sin, axis_sin))
    theta = trig.atan2(sin_theta, cos_theta)
    eps = torch.finfo(dtype).eps
    near_pi = cos_theta < -1.0 + 16.0 * eps
    small = theta < eps**0.25
    safe_sin = torch.where(sin_theta == 0, torch.ones_like(sin_theta), sin_theta)
    scale = torch.where(small, trig.fma(theta * theta, _recip(6.0, dtype), 1.0), theta / safe_sin)
    w_generic = raw * (scale * 0.5)[..., None]
    # Near pi: the column of R + R^T + (1 - trace) I with the largest
    # diagonal, normalized and signed against axis_sin.
    eye = torch.eye(3, dtype=dtype, device=r.device)
    outer = r + r.transpose(-1, -2) + (1.0 - trace)[..., None, None] * eye
    col_idx = torch.argmax(torch.diagonal(outer, dim1=-2, dim2=-1), dim=-1)
    col = torch.gather(outer, -1, col_idx[..., None, None].expand(outer.shape[:-1] + (1,)))[..., 0]
    col_norm = trig.sqrt(_dot3(col, col))[..., None]
    axis_pi = col / torch.where(col_norm == 0, torch.ones_like(col_norm), col_norm)
    sign = torch.sign(_dot3(axis_pi, axis_sin))[..., None]
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    w_pi = theta[..., None] * axis_pi * sign
    w = torch.where(near_pi[..., None], w_pi, w_generic)
    return torch.where(torch.isnan(w), torch.zeros_like(w), w)


def _so3_exp_fused(w):
    """``core.lie.so3_exp`` as the jitted loop computes it (see above):
    ``theta^2`` in :func:`_dot3`'s order, the Taylor coefficients fused,
    ``sin * (1 / sqrt(t2s))``, the fused diagonal of ``hat(w)^2`` and the
    fused Rodrigues sum."""
    dtype = w.dtype
    f = trig.fma
    theta2 = _dot3(w, w)
    small = theta2 <= torch.finfo(dtype).eps
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    cos, sin = trig.cos_sin(trig.sqrt(theta2))
    a = torch.where(small, f(-theta2, _recip(6.0, dtype), 1.0), sin * (1.0 / trig.sqrt(t2s)))[..., None, None]
    b = torch.where(small, f(-theta2, _recip(24.0, dtype), 0.5), (1.0 - cos) / t2s)[..., None, None]
    w0, w1, w2 = w.unbind(-1)
    zero = torch.zeros_like(w0)
    hat = torch.stack([torch.stack([zero, -w2, w1], -1), torch.stack([w2, zero, -w0], -1),
                       torch.stack([-w1, w0, zero], -1)], -2)
    diag = f(-torch.stack([w1, w0, w0], -1), torch.stack([w1, w0, w0], -1), -torch.stack([w2 * w2, w2 * w2, w1 * w1], -1))
    w01, w02, w12 = w0 * w1, w0 * w2, w1 * w2
    hat2 = torch.stack([torch.stack([diag[..., 0], w01, w02], -1), torch.stack([w01, diag[..., 1], w12], -1),
                        torch.stack([w02, w12, diag[..., 2]], -1)], -2)
    eye = torch.eye(3, dtype=dtype, device=w.device).expand(hat.shape)
    return f(b, hat2, f(a, hat, eye))


def _recip(k: float, dtype) -> float:
    """``1 / k`` rounded to ``dtype``, as XLA writes a division by ``k``."""
    return float(torch.tensor(1.0 / k, dtype=dtype))


def graph_ba_core_plain(rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid, iterations: int, rate: float):
    """Graph bundle adjustment (lib.rs:1892-1936, 2382-2414, 2543-2567) in
    tensor operations on any device: a Python loop over the rounds.

    ``rot``/``trans``: (V, 3, 3)/(V, 3) world-to-view poses; ``edge_*``:
    (E,) directed constraints with the expected other->view isometries.
    Each of ``iterations`` rounds sums, per view, the se(3) logs of
    ``expected_other_to_view . world_to_other . view_to_world^-1`` over its
    incident edges in edge order (:func:`per_view_sum`, so the card gives
    the same bits from run to run), scales by ``rate`` and left-applies the
    result.  Views whose delta goes non-finite are removed (a sticky mask)
    with their edges; a view without a valid incoming edge is removed from
    the start.  Every product, sum and so(3) map rounds as ``cv_tpu``'s
    jitted loop rounds on a CPU (the comment above), so the result is its
    bits wherever its ``rsqrt`` is ``1 / sqrt``.  Returns ``(rot, trans,
    removed)``.
    """
    edge_to, edge_from = edge_to.long(), edge_from.long()
    incoming, removed = graph_ba_setup(edge_to, edge_valid, rot.shape[0])
    return graph_ba_rounds(rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid, incoming, removed,
                           iterations, rate)


def graph_ba_setup(edge_to: torch.Tensor, edge_valid: torch.Tensor, v_count: int):
    """:func:`graph_ba_core_plain`'s set-up from int64 ``edge_to``: the
    incoming-edge table (:func:`incoming_edges`, its one host read) and
    the initial removed mask (the views without a valid incoming edge)."""
    has_edge = torch.zeros(v_count, dtype=torch.int32, device=edge_to.device).scatter_reduce(
        0, edge_to, edge_valid.to(torch.int32), reduce="amax"
    ) > 0
    return incoming_edges(edge_to, edge_valid, v_count), ~has_edge


def graph_ba_rounds(rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid, incoming, removed,
                    iterations: int, rate: float):
    """The rounds of :func:`graph_ba_core_plain` from its incoming-edge
    table (:func:`incoming_edges`, int64 ``edge_to``/``edge_from``) and
    initial removed mask; no host read, so a CUDA graph can capture them."""
    zero = torch.zeros((), dtype=rot.dtype, device=rot.device)
    rate = float(torch.tensor(rate, dtype=rot.dtype))  # as the product with a tensor rounds it
    for _ in range(iterations):
        # world_to_other . view_to_world: R = Rf Rt^T, t = tf - Rf Rt^T tt
        r_rel = _mm3(rot[edge_from], rot[edge_to].transpose(-1, -2))
        t_rel = trans[edge_from] - _mv3(r_rel, trans[edge_to])
        r_d = _mm3(edge_rot, r_rel)
        t_d = _mv3(edge_rot, t_rel) + edge_t
        se3_log = torch.cat([t_d, _so3_log_fused(r_d)], dim=-1)  # (E, 6)
        ok_edge = edge_valid & ~removed[edge_from] & ~removed[edge_to]
        se3_log = torch.where(ok_edge[:, None], se3_log, zero)
        total = per_view_sum(se3_log, incoming)
        net = total * rate
        finite = torch.isfinite(net).all(dim=-1) & ~removed  # removed covers the views without an edge
        dr = _so3_exp_fused(net[:, 3:6])
        new_rot = _mm3(dr, rot)
        new_trans = trig.fma(total[:, 0:3], rate, _mv3(dr, trans))
        rot = torch.where(finite[:, None, None], new_rot, rot)
        trans = torch.where(finite[:, None], new_trans, trans)
        removed = removed | ~finite
    return rot, trans, removed


def graph_ba_core(rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid, iterations: int, rate: float):
    """:func:`graph_ba_core_plain`'s function: on CUDA tensors one launch
    of ``csrc/graph_ba.cu`` that runs every round (:func:`graph_ba_kernel`,
    counted on ``graph_ba_core.launches``), on CPU tensors the plain
    loop.  Returns ``(rot, trans, removed)``."""
    if rot.device.type == "cpu":
        return graph_ba_core_plain(rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid, iterations, rate)
    return graph_ba_kernel(rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid, iterations, rate)


graph_ba_core.launches = 0  # graph_ba.cu launches so far (CPU calls do not count)

_VOID, _I32 = ctypes.c_void_p, ctypes.c_int


def graph_ba_kernel(rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid, iterations: int, rate: float):
    """``csrc/graph_ba.cu`` on CUDA tensors: :func:`graph_ba_core_plain`'s
    function, bit for bit, in one launch of one block, with no host read.
    The poses and edges are staged in shared memory when they fit (else
    read from global memory each round); each view's incoming list is
    built in the kernel.  Float32 or float64 poses and edges, int64 edge
    indices, each in ``[0, V)`` (an edge outside is the caller's error;
    the kernel leaves it out rather than read outside the poses), a bool
    ``edge_valid``."""
    dev = rot.device
    if dev.type != "cuda":
        raise ValueError(f"graph_ba_kernel: CUDA tensors, got {dev}")
    if rot.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"graph_ba_kernel: float32 or float64, got {rot.dtype}")
    v_count, e_count = rot.shape[0], edge_to.shape[0]
    shapes = ((rot, (v_count, 3, 3)), (trans, (v_count, 3)), (edge_to, (e_count,)), (edge_from, (e_count,)),
              (edge_rot, (e_count, 3, 3)), (edge_t, (e_count, 3)), (edge_valid, (e_count,)))
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"graph_ba_kernel: shape {tuple(t.shape)}, expected {shape}")
        if t.device != dev:
            raise ValueError(f"graph_ba_kernel: tensors on {t.device} and {dev}")
    if max(v_count, e_count) >= 2**30 or iterations < 0:
        raise ValueError(f"graph_ba_kernel: V = {v_count}, E = {e_count}, {iterations} rounds")
    if edge_rot.dtype != rot.dtype or edge_t.dtype != rot.dtype or trans.dtype != rot.dtype:
        raise ValueError("graph_ba_kernel: poses and edges of one dtype")
    if edge_to.dtype != torch.int64 or edge_from.dtype != torch.int64 or edge_valid.dtype != torch.bool:
        raise ValueError(f"graph_ba_kernel: int64 edge indices and a bool mask, got {edge_to.dtype}, "
                         f"{edge_from.dtype}, {edge_valid.dtype}")
    rot, trans, edge_to, edge_from, edge_rot, edge_t, valid = (
        t.contiguous() for t in (rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid))
    out_rot, out_trans = torch.empty_like(rot), torch.empty_like(trans)
    removed = torch.empty(v_count, dtype=torch.bool, device=dev)
    # Where the edges do not fit in shared memory beside the views: their
    # logs (6 E) and to, from and incoming lists (3 E) in global memory.
    log_scratch = torch.empty(max(6 * e_count, 1), dtype=rot.dtype, device=dev)
    int_scratch = torch.empty(max(3 * e_count, 1), dtype=torch.int32, device=dev)
    symbol = "cv_graph_ba_f32" if rot.dtype == torch.float32 else "cv_graph_ba_f64"
    err = kernels.function("graph_ba", symbol, [_VOID] * 7 + [_I32, _I32, _I32, ctypes.c_double] + [_VOID] * 6)(
        rot.data_ptr(), trans.data_ptr(), edge_to.data_ptr(), edge_from.data_ptr(), edge_rot.data_ptr(),
        edge_t.data_ptr(), valid.data_ptr(), v_count, e_count, int(iterations), float(rate), out_rot.data_ptr(),
        out_trans.data_ptr(), removed.data_ptr(), log_scratch.data_ptr(), int_scratch.data_ptr(),
        kernels.current_stream(dev))
    if err == -1:
        raise ValueError(f"graph_ba_kernel: {v_count} views do not fit in a block's shared memory")
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")
    if v_count > 0:
        graph_ba_core.launches += 1
    return out_rot, out_trans, removed


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
