"""Versioned, schema'd VSlamData checkpoints.

Port of ``cv_tpu/sfm/serialize.py`` (the reference bincodes a serde data
model, ``vslam-sandbox/src/main.rs:81-89, 166-175``): the map state is
flattened into typed NumPy arrays with explicit ragged offsets and saved as
one ``.npz`` with a format-version field.  The keys, dtypes and offsets are
``cv_tpu``'s, so a checkpoint written by either package loads in the other.
Loading never executes stored code.

Ragged collections use the (flat, offsets) encoding; every SlotMap's
allocation counter is kept, so key allocation continues identically after a
round trip.  A feed's intrinsics are stored as one float64 row; loading
builds the port's torch intrinsics on the device the caller names.
"""

from __future__ import annotations

import numpy as np

FORMAT_VERSION = 1

_KIND_K1 = 0  # CameraIntrinsicsK1Distortion over CameraIntrinsics
_KIND_PLAIN = 1  # CameraIntrinsics
_KIND_NONE = 2  # bearings-only feed (no camera model attached)


def _offsets(lists):
    off = np.zeros(len(lists) + 1, np.int64)
    for i, x in enumerate(lists):
        off[i + 1] = off[i] + len(x)
    return off


def _intrinsics_row(intrinsics):
    """``(kind, [fx, fy, cx, cy, skew, k1])`` of a feed's camera model."""
    from ..camera import CameraIntrinsics, CameraIntrinsicsK1Distortion

    if intrinsics is None:
        # Bearings-only feeds (features added via add_frame_features) have
        # no camera model; the checkpoint stores the absence.
        return _KIND_NONE, [0.0] * 6
    if isinstance(intrinsics, CameraIntrinsicsK1Distortion):
        si = intrinsics.simple_intrinsics
        kind = _KIND_K1
        k1 = float(intrinsics.k1.cpu())
    elif isinstance(intrinsics, CameraIntrinsics):
        si = intrinsics
        kind = _KIND_PLAIN
        k1 = 0.0
    else:
        raise TypeError(
            f"schema'd checkpoints support the built-in pinhole camera "
            f"models; got {type(intrinsics).__name__}"
        )
    focals, pp, skew = (np.asarray(a, np.float64) for a in si.to_numpy())
    return kind, [focals[0], focals[1], pp[0], pp[1], float(skew), k1]


def _intrinsics_from_row(kind, row, device="cuda"):
    """The camera model of a stored row, its tensors on ``device``."""
    from ..camera import CameraIntrinsics, CameraIntrinsicsK1Distortion

    if kind == _KIND_NONE:
        return None
    si = CameraIntrinsics.from_values(
        float(row[0]), float(row[1]), float(row[2]), float(row[3]), skew=float(row[4]), device=device
    )
    if kind == _KIND_K1:
        return CameraIntrinsicsK1Distortion.new(si, float(row[5]))
    return si


def save_npz(data, path):
    """Serialize ``VSlamData`` to a versioned npz checkpoint."""
    out = {"version": np.int64(FORMAT_VERSION)}

    # -- feeds --------------------------------------------------------------
    feed_keys = list(data.feeds)
    kinds, params, feed_frames = [], [], []
    for k in feed_keys:
        feed = data.feeds[k]
        kind, row = _intrinsics_row(feed.intrinsics)
        kinds.append(kind)
        params.append(row)
        feed_frames.append(feed.frames)
    out["feed_keys"] = np.asarray(feed_keys, np.int64)
    out["feed_next"] = np.int64(data.feeds._next)
    out["feed_kind"] = np.asarray(kinds, np.int64)
    out["feed_params"] = np.asarray(params, np.float64).reshape(len(feed_keys), 6)
    out["feed_frames_flat"] = np.concatenate(
        [np.asarray(x, np.int64) for x in feed_frames] or [np.zeros(0, np.int64)]
    )
    out["feed_frames_off"] = _offsets(feed_frames)

    # -- frames -------------------------------------------------------------
    frame_keys = list(data.frames)
    frames = [data.frames[k] for k in frame_keys]
    out["frame_keys"] = np.asarray(frame_keys, np.int64)
    out["frame_next"] = np.int64(data.frames._next)
    out["frame_feed"] = np.asarray([f.feed for f in frames], np.int64)
    out["frame_feed_frame"] = np.asarray([f.feed_frame for f in frames], np.int64)
    out["frame_view"] = np.asarray(
        [f.view if f.view is not None else (-1, -1) for f in frames], np.int64
    ).reshape(len(frames), 2)
    out["frame_sketch"] = (
        np.stack([f.sketch for f in frames])
        if frames
        else np.zeros((0, 16), np.uint32)
    )
    descs = [np.asarray(f.descriptors, np.uint32) for f in frames]
    out["frame_desc_off"] = _offsets(descs)
    out["frame_desc_flat"] = (
        np.concatenate(descs) if descs else np.zeros((0, 16), np.uint32)
    )
    out["frame_bearings_flat"] = (
        np.concatenate([np.asarray(f.bearings, np.float64) for f in frames])
        if frames
        else np.zeros((0, 3))
    )
    out["frame_responses_flat"] = (
        np.concatenate([np.asarray(f.responses, np.float32) for f in frames])
        if frames
        else np.zeros(0, np.float32)
    )
    out["frame_colors_flat"] = (
        np.concatenate([np.asarray(f.colors) for f in frames])
        if frames
        else np.zeros((0, 3), np.uint8)
    )
    out["sketch_frames"] = np.asarray(data.sketch_frames, np.int64)

    # -- reconstructions ----------------------------------------------------
    rec_keys = list(data.reconstructions)
    out["rec_keys"] = np.asarray(rec_keys, np.int64)
    out["rec_next"] = np.int64(data.reconstructions._next)

    view_rows, view_lms = [], []
    lm_rows, lm_obs = [], []
    con_rows, con_poses = [], []
    rec_counters = []
    for rk in rec_keys:
        rec = data.reconstructions[rk]
        rec_counters.append((rec.views._next, rec.landmarks._next, rec.constraints._next))
        for vk, view in rec.views.items():
            view_rows.append(
                (rk, vk, view.frame, *np.asarray(view.pose[0]).ravel(),
                 *np.asarray(view.pose[1]).ravel())
            )
            view_lms.append(view.landmarks)
        for lk, lm in rec.landmarks.items():
            lm_rows.append((rk, lk))
            lm_obs.append([(v, f) for v, f in lm.observations.items()])
        for ck, con in rec.constraints.items():
            con_rows.append((rk, ck, *con.views))
            con_poses.append(
                np.concatenate(
                    [
                        np.asarray(con.poses[0][0]).ravel(),
                        np.asarray(con.poses[0][1]).ravel(),
                        np.asarray(con.poses[1][0]).ravel(),
                        np.asarray(con.poses[1][1]).ravel(),
                    ]
                )
            )
    out["rec_counters"] = np.asarray(rec_counters, np.int64).reshape(len(rec_keys), 3)
    vr = np.asarray(view_rows, np.float64).reshape(len(view_rows), 15)
    out["view_meta"] = vr[:, :3].astype(np.int64)
    out["view_rot"] = vr[:, 3:12].reshape(-1, 3, 3)
    out["view_trans"] = vr[:, 12:15]
    out["view_lms_flat"] = np.concatenate(
        [np.asarray(x, np.int64) for x in view_lms] or [np.zeros(0, np.int64)]
    )
    out["view_lms_off"] = _offsets(view_lms)
    out["lm_meta"] = np.asarray(lm_rows, np.int64).reshape(len(lm_rows), 2)
    out["lm_obs_flat"] = np.asarray(
        [p for obs in lm_obs for p in obs], np.int64
    ).reshape(sum(len(o) for o in lm_obs), 2)
    out["lm_obs_off"] = _offsets(lm_obs)
    out["con_meta"] = np.asarray(con_rows, np.int64).reshape(len(con_rows), 5)
    out["con_poses"] = (
        np.stack(con_poses) if con_poses else np.zeros((0, 24))
    )
    # np.savez appends ".npz" to bare string paths; the CLI contract is the
    # exact user-given filename (vslam-sandbox/src/main.rs:166-175 writes
    # `vslam.cvr` verbatim), so hand it an open file object instead.
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **out)


def load_npz(path, device="cuda"):
    """Rebuild a ``VSlamData`` from a schema'd checkpoint; the feeds'
    intrinsics are built on ``device``."""
    from .data import (
        Feed,
        Frame,
        Landmark,
        Reconstruction,
        ThreeViewConstraint,
        View,
        VSlamData,
    )

    # Each array read once: indexing an NpzFile decompresses the member
    # again on every access.
    with np.load(path, allow_pickle=False) as npz:
        z = {k: npz[k] for k in npz.files}
    version = int(z["version"])
    if version > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format v{version} is newer than supported v{FORMAT_VERSION}"
        )
    data = VSlamData()

    fo = z["feed_frames_off"]
    for i, k in enumerate(z["feed_keys"]):
        data.feeds[int(k)] = Feed(
            intrinsics=_intrinsics_from_row(int(z["feed_kind"][i]), z["feed_params"][i], device),
            frames=[int(x) for x in z["feed_frames_flat"][fo[i] : fo[i + 1]]],
        )
    data.feeds._next = int(z["feed_next"])

    do = z["frame_desc_off"]
    for i, k in enumerate(z["frame_keys"]):
        lo, hi = do[i], do[i + 1]
        view = tuple(int(x) for x in z["frame_view"][i])
        data.frames[int(k)] = Frame(
            feed=int(z["frame_feed"][i]),
            feed_frame=int(z["frame_feed_frame"][i]),
            descriptors=z["frame_desc_flat"][lo:hi],
            bearings=z["frame_bearings_flat"][lo:hi],
            responses=z["frame_responses_flat"][lo:hi],
            colors=z["frame_colors_flat"][lo:hi],
            view=None if view[0] < 0 else view,
            sketch=z["frame_sketch"][i],
        )
    data.frames._next = int(z["frame_next"])
    data.sketch_frames = [int(x) for x in z["sketch_frames"]]
    data.frame_sketches = [data.frames[f].sketch for f in data.sketch_frames]

    for i, k in enumerate(z["rec_keys"]):
        rec = Reconstruction()
        nv, nl, nc = z["rec_counters"][i]
        rec.views._next = int(nv)
        rec.landmarks._next = int(nl)
        rec.constraints._next = int(nc)
        data.reconstructions[int(k)] = rec
    data.reconstructions._next = int(z["rec_next"])

    vo = z["view_lms_off"]
    for i, (rk, vk, frame) in enumerate(z["view_meta"]):
        data.reconstructions[int(rk)].views[int(vk)] = View(
            frame=int(frame),
            pose=(z["view_rot"][i].copy(), z["view_trans"][i].copy()),
            landmarks=[int(x) for x in z["view_lms_flat"][vo[i] : vo[i + 1]]],
        )
    oo = z["lm_obs_off"]
    for i, (rk, lk) in enumerate(z["lm_meta"]):
        obs = {int(v): int(f) for v, f in z["lm_obs_flat"][oo[i] : oo[i + 1]]}
        data.reconstructions[int(rk)].landmarks[int(lk)] = Landmark(observations=obs)
    for i, row in enumerate(z["con_meta"]):
        rk, ck = int(row[0]), int(row[1])
        p = z["con_poses"][i]
        data.reconstructions[rk].constraints[ck] = ThreeViewConstraint(
            views=tuple(int(x) for x in row[2:5]),
            poses=(
                (p[0:9].reshape(3, 3), p[9:12]),
                (p[12:21].reshape(3, 3), p[21:24]),
            ),
        )
    return data
