"""Batched landmark geometry for the engine's rejection cascades.

Vectorized (landmark x observation) mirrors of :mod:`cv_tpu_torch.sfm.host_geom`:
one call processes EVERY landmark of a padded ``(L, O)`` observation tensor
instead of one landmark per Python iteration.  Semantics follow the
reference's per-landmark routines (``cv-sfm/src/lib.rs:2657-2757``
observation filtering, ``lib.rs:2874-3052`` robustness + triangulation) —
each landmark's result is identical to the scalar `host_geom` path because
every matrix is reduced independently in observation order.

The engine packs the observations of interest once per pass (O(total
observations) host work) and gets all triangulations/predicates from a
handful of BLAS calls, replacing thousands of tiny per-landmark NumPy
dispatches.  The same math runs on the device in the torch twins in
:mod:`cv_tpu_torch.triangulate` / :mod:`cv_tpu_torch.sfm.device_refine`.

Carried over unchanged from ``cv_tpu/sfm/batch_geom.py`` (pure NumPy).
"""

from __future__ import annotations

import numpy as np


def view_caches(data, reconstruction):
    """Per-view ``pose`` / frame ``bearings`` lookups (views repeat across
    landmarks, so cache once per pass)."""
    rec = data.reconstructions[reconstruction]
    view_pose = {}
    view_bearings = {}
    for v, view in rec.views.items():
        view_pose[v] = view.pose
        view_bearings[v] = data.frames[view.frame].bearings
    return view_pose, view_bearings


def _pack_flat(obs_lists, o_max=None):
    """Flatten per-row observation lists; everything downstream of the two
    ``fromiter`` passes is vectorized NumPy (the old per-observation Python
    loop walled reference-scale frames at ~10^5 observations per pass).

    Returns ``(o, i_flat, j_flat, vs, fs, uniq_v, inv)``: padded width,
    flat row/slot indices, flat view keys / feature indices, the unique
    view keys, and each flat observation's index into ``uniq_v``.
    """
    n = len(obs_lists)
    counts = np.fromiter((len(x) for x in obs_lists), np.int64, count=n)
    total = int(counts.sum())
    o = int(counts.max()) if n else 0
    if o_max is not None:
        o = max(o, o_max)
    o = max(o, 1)
    vs = np.fromiter(
        (v for obs in obs_lists for v, _ in obs), np.int64, count=total
    )
    fs = np.fromiter(
        (f for obs in obs_lists for _, f in obs), np.int64, count=total
    )
    i_flat = np.repeat(np.arange(n, dtype=np.int64), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    j_flat = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
    uniq_v, inv = np.unique(vs, return_inverse=True)
    return o, i_flat, j_flat, vs, fs, uniq_v, inv


def _gather_bearings(view_bearings, vs, fs, uniq_v, inv):
    """bear_flat[k] = view_bearings[vs[k]][fs[k]] via one vectorized gather
    per distinct view."""
    bear_flat = np.empty((len(vs), 3))
    order = np.argsort(inv, kind="stable")
    bounds = np.searchsorted(inv[order], np.arange(len(uniq_v) + 1))
    for u, v in enumerate(uniq_v):
        sel = order[bounds[u] : bounds[u + 1]]
        bear_flat[sel] = view_bearings[v][fs[sel]]
    return bear_flat


def pack_observations(obs_lists, view_pose, view_bearings, o_max=None):
    """Pack per-row observation lists into padded arrays.

    ``obs_lists``: list of ``[(view, feature), ...]`` per row.  Returns
    ``(rot (L, O, 3, 3), trans (L, O, 3), bearings (L, O, 3), mask (L, O),
    views (L, O) int64, features (L, O) int64)`` where ``O`` is the maximum
    observation count (or ``o_max``).  Slots beyond a row's observation
    count are masked with identity poses / +z bearings.
    """
    n = len(obs_lists)
    o, i_flat, j_flat, vs, fs, uniq_v, inv = _pack_flat(obs_lists, o_max)
    rot = np.tile(np.eye(3), (n, o, 1, 1))
    trans = np.zeros((n, o, 3))
    bear = np.zeros((n, o, 3))
    bear[:, :, 2] = 1.0
    mask = np.zeros((n, o), bool)
    views = np.zeros((n, o), np.int64)
    feats = np.zeros((n, o), np.int64)
    if len(vs):
        rot_table = np.stack([view_pose[v][0] for v in uniq_v])
        trans_table = np.stack([view_pose[v][1] for v in uniq_v])
        rot[i_flat, j_flat] = rot_table[inv]
        trans[i_flat, j_flat] = trans_table[inv]
        bear[i_flat, j_flat] = _gather_bearings(view_bearings, vs, fs, uniq_v, inv)
        mask[i_flat, j_flat] = True
        views[i_flat, j_flat] = vs
        feats[i_flat, j_flat] = fs
    return rot, trans, bear, mask, views, feats


def pack_observation_indices(obs_lists, view_index, view_bearings, o_max=None):
    """Pose-free variant for fused device programs that gather poses ON
    DEVICE from a BA output (see ``device_refine.ba_filter``): returns
    ``(view_idx (L, O) int32 rows into the program's view arrays, bearings
    (L, O, 3) with +z padding, mask (L, O), views (L, O) int64, features
    (L, O) int64)``.  ``view_index``: view key -> row index mapping."""
    n = len(obs_lists)
    o, i_flat, j_flat, vs, fs, uniq_v, inv = _pack_flat(obs_lists, o_max)
    view_idx = np.zeros((n, o), np.int32)
    bear = np.zeros((n, o, 3))
    bear[:, :, 2] = 1.0
    mask = np.zeros((n, o), bool)
    views = np.zeros((n, o), np.int64)
    feats = np.zeros((n, o), np.int64)
    if len(vs):
        idx_table = np.fromiter((view_index[v] for v in uniq_v), np.int32,
                                count=len(uniq_v))
        view_idx[i_flat, j_flat] = idx_table[inv]
        bear[i_flat, j_flat] = _gather_bearings(view_bearings, vs, fs, uniq_v, inv)
        mask[i_flat, j_flat] = True
        views[i_flat, j_flat] = vs
        feats[i_flat, j_flat] = fs
    return view_idx, bear, mask, views, feats


def pack_landmarks(data, reconstruction, landmarks, o_max=None):
    """``pack_observations`` over the observation dicts of ``landmarks``."""
    rec = data.reconstructions[reconstruction]
    obs_lists = [list(rec.landmarks[lm].observations.items()) for lm in landmarks]
    vp, vb = view_caches(data, reconstruction)
    return pack_observations(obs_lists, vp, vb, o_max=o_max)


def triangulate_batch(rot, trans, bearings, mask):
    """Batched LinearEigen triangulation (triangulation.rs:83-130).

    ``rot (L, O, 3, 3)``, ``trans (L, O, 3)``, ``bearings (L, O, 3)``,
    ``mask (L, O)``.  Returns ``(points (L, 4) homogeneous unit-normalized,
    ok (L,))`` where ``ok`` matches host_geom.triangulate_observations
    returning non-None: >= 2 observations, finite, and every observation's
    world bearing has non-negative dot with the point.
    """
    m = mask[..., None, None].astype(float)
    pm = np.concatenate([rot, trans[..., None]], axis=-1)  # (L, O, 3, 4)
    outer = bearings[..., :, None] * bearings[..., None, :]  # (L, O, 3, 3)
    term = pm - outer @ pm  # (L, O, 3, 4)
    a = np.einsum("loki,lokj->lij", term * m, term, optimize=True)  # (L, 4, 4)
    n_obs = mask.sum(axis=1)
    # eigh of the padded (masked-to-zero) matrices; zero matrices are fine.
    with np.errstate(all="ignore"):
        _, vecs = np.linalg.eigh(a)
    point = vecs[..., 0]  # (L, 4)
    point = np.where(point[:, 3:4] < 0, -point, point)
    norm = np.linalg.norm(point[:, :3], axis=1, keepdims=True)
    with np.errstate(all="ignore"):
        point = point / norm
    finite = np.all(np.isfinite(point), axis=1)
    # Cheirality: world bearing = R^T b; require dot(point.xyz) >= 0.
    world_b = np.einsum("lokj,lok->loj", rot, bearings)
    cheir = (world_b @ point[:, :3, None])[..., 0]  # (L, O)
    cheir_ok = np.all((cheir >= 0.0) | ~mask, axis=1)
    ok = (n_obs >= 2) & finite & cheir_ok
    return point, ok


def world_bearings_batch(rot, bearings):
    """R^T @ b for every (landmark, observation)."""
    return np.einsum("lokj,lok->loj", rot, bearings)


def incidence_robust_batch(rot, bearings, mask, thresh, min_obs):
    """Batched ``are_observations_robust`` (lib.rs:2907-2934): true when the
    landmark has >= ``min_obs`` observations and ANY pair of world bearings
    has cosine distance above ``thresh``."""
    wb = world_bearings_batch(rot, bearings)
    dots = 1.0 - np.einsum("loj,lpj->lop", wb, wb)
    pair = mask[:, :, None] & mask[:, None, :]
    iu = np.triu(np.ones(dots.shape[1:], bool), 1)
    any_pair = np.any((dots > thresh) & pair & iu, axis=(1, 2))
    return (mask.sum(axis=1) >= min_obs) & any_pair


def reproject_cosine_batch(rot, trans, bearings, mask, points):
    """1 - dot(bearing_of(pose * point), observed bearing) for every
    masked observation; padded slots get 0."""
    # transform_homogeneous: [R p3 + t*p_w] normalized to unit bearing
    p3 = points[:, None, :3]
    pw = points[:, None, 3:4]
    cam = np.einsum("loij,loj->loi", rot, np.broadcast_to(p3, rot.shape[:2] + (3,)))
    cam = cam + trans * pw
    with np.errstate(all="ignore"):
        cam = cam / np.linalg.norm(cam, axis=-1, keepdims=True)
    cosd = 1.0 - np.einsum("loi,loi->lo", cam, bearings)
    return np.where(mask, cosd, 0.0)


def epipolar_loss_batch(translation, a, b):
    """Batched host_geom.epipolar_loss (epipolar.rs:197-233).

    ``translation (N, 3)``, ``a (N, 3)``, ``b (N, 3)`` -> (N,) sine loss with
    the NaN/cheirality fallback to 1.0.
    """
    cross_a = np.cross(a, translation)
    cross_b = np.cross(b, translation)
    ca2 = np.einsum("ni,ni->n", cross_a, cross_a)
    cb2 = np.einsum("ni,ni->n", cross_b, cross_b)
    with np.errstate(invalid="ignore", divide="ignore"):
        res_a = np.abs(np.einsum("ni,ni->n", a, cross_b) / np.sqrt(cb2))
        res_b = np.abs(np.einsum("ni,ni->n", b, cross_a) / np.sqrt(ca2))
    residual = np.where(ca2 < cb2, res_a, res_b)
    bad = np.isnan(residual) | (np.einsum("ni,ni->n", a, b) < 0)
    return np.where(bad, 1.0, residual)


def bi_robust_batch(rel_rot, rel_trans, a, b, maximum_sine_distance):
    """Batched ``is_bi_landmark_robust`` (lib.rs:1306-1317) for N landmark
    pairs under N relative poses ``(rel_rot (N,3,3), rel_trans (N,3))``."""
    a_in_b = np.einsum("nij,nj->ni", rel_rot, a)
    return epipolar_loss_batch(rel_trans, a_in_b, b) < maximum_sine_distance


def relative_pose_batch(rot1, trans1, rot2, trans2):
    """``pose2 . inverse(pose1)`` for N pose pairs: R = R2 R1^T,
    t = t2 - R t1."""
    rrel = rot2 @ np.swapaxes(rot1, -1, -2)
    trel = trans2 - np.einsum("nij,nj->ni", rrel, trans1)
    return rrel, trel
