"""The vSLAM mapping data model.

Port of ``cv_tpu/sfm/data.py`` (reference cv-sfm/src/lib.rs:45-721,
``VSlamData`` and its containers).  The reference's slotmaps are
insert-ordered dicts with increasing integer keys; per-frame feature data
lives in dense NumPy arrays (descriptors as uint32 words, bearings,
colors, responses).  Frame sketches come from :mod:`cv_tpu_torch.matching.lsh`.
Checkpoints (``save``/``load``) are :mod:`cv_tpu_torch.sfm.serialize`'s npz
format, which ``cv_tpu`` reads and writes too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..matching import lsh

# Byte-popcount lookup for host-side sketch Hamming distances.
_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def canonical_view_order(views):
    """Sorted 3-tuple (lib.rs:54-57)."""
    return tuple(sorted(views))


@dataclasses.dataclass
class Frame:
    """One processed image (lib.rs:68-98)."""

    feed: int
    feed_frame: int
    descriptors: np.ndarray  # (N, 16) uint32
    bearings: np.ndarray  # (N, 3) f64
    responses: np.ndarray  # (N,) f32
    colors: np.ndarray  # (N, 3) uint8
    view: Optional[tuple] = None  # (reconstruction_key, view_key)
    sketch: np.ndarray = None  # (16,) uint32 LSH sketch

    def __len__(self):
        return len(self.descriptors)


@dataclasses.dataclass
class Landmark:
    """observations: view_key -> feature index (lib.rs:101-106)."""

    observations: dict


@dataclasses.dataclass
class View:
    """frame key + pose + per-feature landmark keys (lib.rs:109-118)."""

    frame: int
    pose: object  # WorldToCamera (host numpy R 3x3, t 3 tuple)
    landmarks: list


@dataclasses.dataclass
class Feed:
    intrinsics: object
    frames: list


@dataclasses.dataclass
class ThreeViewConstraint:
    """Three views + two relative isometries (lib.rs:155-181)."""

    views: tuple  # canonical (v0, v1, v2)
    poses: tuple  # two (R, t) numpy isometries: first->second/third from views[0]

    def edge_constraints(self):
        """Expand into 6 directed edges (lib.rs:167-181).

        Yields (to_view, (from_view, (R, t))) where the isometry transforms
        from_view's camera space to to_view's camera space.
        """
        from .se3 import compose, inverse

        v = self.views
        first, second = self.poses
        first_to_second = compose(second, inverse(first))
        yield (v[0], (v[2], inverse(second)))
        yield (v[0], (v[1], inverse(first)))
        yield (v[1], (v[0], first))
        yield (v[1], (v[2], inverse(first_to_second)))
        yield (v[2], (v[1], first_to_second))
        yield (v[2], (v[0], second))


class SlotMap(dict):
    """Insert-ordered integer-keyed map with slotmap-style allocation."""

    def __init__(self):
        super().__init__()
        self._next = 0

    def insert(self, value) -> int:
        key = self._next
        self._next += 1
        self[key] = value
        return key


@dataclasses.dataclass
class Reconstruction:
    views: SlotMap = dataclasses.field(default_factory=SlotMap)
    landmarks: SlotMap = dataclasses.field(default_factory=SlotMap)
    constraints: SlotMap = dataclasses.field(default_factory=SlotMap)


class VSlamData:
    """All mapping state (lib.rs:195-220)."""

    def __init__(self):
        self.feeds = SlotMap()
        self.reconstructions = SlotMap()
        self.frames = SlotMap()
        self.frame_sketches: list = []  # aligned with frame keys for retrieval
        self.sketch_frames: list = []

    # -- accessors (lib.rs:229-372) ----------------------------------------
    def frame(self, frame: int) -> Frame:
        return self.frames[frame]

    def bearing(self, frame: int, feature: int) -> np.ndarray:
        return self.frames[frame].bearings[feature]

    def view(self, reconstruction: int, view: int) -> View:
        return self.reconstructions[reconstruction].views[view]

    def view_frame(self, reconstruction: int, view: int) -> Frame:
        return self.frames[self.view(reconstruction, view).frame]

    def pose(self, reconstruction: int, view: int):
        return self.view(reconstruction, view).pose

    def landmark(self, reconstruction: int, landmark: int) -> Landmark:
        return self.reconstructions[reconstruction].landmarks[landmark]

    def observation_landmark(self, reconstruction: int, view: int, feature: int) -> int:
        return self.view(reconstruction, view).landmarks[feature]

    def observation_bearing(self, reconstruction: int, view: int, feature: int):
        return self.bearing(self.view(reconstruction, view).frame, feature)

    def observation_color(self, reconstruction: int, view: int, feature: int):
        return self.frames[self.view(reconstruction, view).frame].colors[feature]

    def landmark_observations(self, reconstruction: int, landmark: int):
        return list(self.landmark(reconstruction, landmark).observations.items())

    def landmark_pose_bearings(self, reconstruction: int, landmark: int):
        return [
            (self.pose(reconstruction, view), self.observation_bearing(reconstruction, view, feature))
            for view, feature in self.landmark(reconstruction, landmark).observations.items()
        ]

    def landmark_pose_bearings_without_view(self, reconstruction, landmark, without_view):
        return [
            (self.pose(reconstruction, v), self.observation_bearing(reconstruction, v, f))
            for v, f in self.landmark(reconstruction, landmark).observations.items()
            if v != without_view
        ]

    # -- mutation (lib.rs:377-721) ------------------------------------------
    def add_frame_features(
        self, feed: int, descriptors, bearings, responses, colors, sketch=None
    ) -> int:
        if sketch is None:
            sketch = _hash_bag(descriptors)
        else:
            sketch = np.asarray(sketch)
        frame = self.frames.insert(
            Frame(
                feed=feed,
                feed_frame=len(self.feeds[feed].frames),
                descriptors=np.asarray(descriptors),
                bearings=np.asarray(bearings),
                responses=np.asarray(responses),
                colors=np.asarray(colors),
                view=None,
                sketch=sketch,
            )
        )
        self.frame_sketches.append(sketch)
        self.sketch_frames.append(frame)
        self.feeds[feed].frames.append(frame)
        return frame

    def add_landmark(self, reconstruction: int, view: int, feature: int) -> int:
        return self.reconstructions[reconstruction].landmarks.insert(
            Landmark(observations={view: feature})
        )

    def add_view(self, reconstruction: int, frame: int, pose, existing_landmark) -> int:
        """Insert a view; ``existing_landmark(feature)`` returns None, a
        landmark key, or a pair to merge (lib.rs:432-483)."""
        rec = self.reconstructions[reconstruction]
        view = rec.views.insert(View(frame=frame, pose=pose, landmarks=[]))
        self.frames[frame].view = (reconstruction, view)
        for feature in range(len(self.frames[frame])):
            found = existing_landmark(feature)
            if found is not None:
                if isinstance(found, (list, tuple)):
                    if len(found) == 2:
                        landmark = self.merge_landmarks(reconstruction, found[0], found[1])
                    else:
                        landmark = found[0]
                else:
                    landmark = found
                self.landmark(reconstruction, landmark).observations[view] = feature
            else:
                landmark = self.add_landmark(reconstruction, view, feature)
            rec.views[view].landmarks.append(landmark)
        return view

    def remove_view(self, reconstruction: int, view: int):
        rec = self.reconstructions[reconstruction]
        self.frames[rec.views[view].frame].view = None
        landmarks = rec.views[view].landmarks
        rec.views[view].landmarks = []
        for landmark in landmarks:
            obs = rec.landmarks[landmark].observations
            if len(obs) <= 1:
                del rec.landmarks[landmark]
            else:
                del obs[view]
        for key in [k for k, c in rec.constraints.items() if view in c.views]:
            del rec.constraints[key]
        del rec.views[view]

    def remove_reconstruction(self, reconstruction: int):
        for view in self.reconstructions[reconstruction].views.values():
            self.frames[view.frame].view = None
        del self.reconstructions[reconstruction]

    def split_observation(self, reconstruction: int, view: int, feature: int) -> bool:
        """Split one observation into its own landmark (lib.rs:552-588)."""
        rec = self.reconstructions[reconstruction]
        old_landmark = rec.views[view].landmarks[feature]
        if len(rec.landmarks[old_landmark].observations) >= 2:
            removed = rec.landmarks[old_landmark].observations.pop(view)
            assert removed == feature
            new_landmark = rec.landmarks.insert(Landmark(observations={view: feature}))
            rec.views[view].landmarks[feature] = new_landmark
            return True
        return False

    def merge_landmarks(self, reconstruction: int, landmark_a: int, landmark_b: int) -> int:
        """Merge b into a unconditionally (lib.rs:699-721).

        Requires the landmarks to share no view — callers with possible
        duplicates must use ``VSlam.merge_landmarks_dedup`` (lib.rs:2818),
        which resolves shared views by splitting off the worse observation
        first (the reference's HashMap insert would silently corrupt the
        view backlink on a duplicate; we raise instead).
        """
        rec = self.reconstructions[reconstruction]
        old = rec.landmarks.pop(landmark_b)
        for view, feature in old.observations.items():
            rec.views[view].landmarks[feature] = landmark_a
            if view in rec.landmarks[landmark_a].observations:
                raise ValueError(
                    "merge_landmarks on landmarks sharing a view; use "
                    "VSlam.merge_landmarks_dedup"
                )
            rec.landmarks[landmark_a].observations[view] = feature
        return landmark_a

    def add_reconstruction(
        self,
        center: int,
        first: int,
        second: int,
        first_pose,
        second_pose,
        combined_matches,
        first_matches,
        second_matches,
    ) -> int:
        """Bootstrap a reconstruction from a three-view init (lib.rs:377-427)."""
        from .se3 import identity

        reconstruction = self.reconstructions.insert(Reconstruction())
        center_view = self.add_view(reconstruction, center, identity(), lambda _: None)
        center_landmarks = self.reconstructions[reconstruction].views[center_view].landmarks

        first_landmarks = {}
        for c, f in [(c, f) for c, f in first_matches] + [
            (c, f) for c, f, _ in combined_matches
        ]:
            first_landmarks[f] = center_landmarks[c]
        first_view = self.add_view(
            reconstruction, first, first_pose, lambda feat: first_landmarks.get(feat)
        )

        second_landmarks = {}
        for c, s in [(c, s) for c, s in second_matches] + [
            (c, s) for c, _, s in combined_matches
        ]:
            second_landmarks[s] = center_landmarks[c]
        second_view = self.add_view(
            reconstruction, second, second_pose, lambda feat: second_landmarks.get(feat)
        )

        self.reconstructions[reconstruction].constraints.insert(
            ThreeViewConstraint(
                views=canonical_view_order([center_view, first_view, second_view]),
                poses=(first_pose, second_pose),
            )
        )
        return reconstruction

    def find_visually_similar_and_recent_frames(
        self,
        frame: int,
        num_similar_frames: int,
        num_recent_frames: int,
        similar_recent_threshold: int,
        similar_frames_search_num: int,
    ):
        """LSH + recency frame retrieval (lib.rs:597-668)."""
        feed = self.frames[frame].feed
        frame_feed_ix = self.frames[frame].feed_frame
        recent_frames = [
            f
            for ix, f in enumerate(self.feeds[feed].frames)
            if f != frame and abs(frame_feed_ix - ix) < num_recent_frames
        ]
        similar_frames = []
        if num_similar_frames > 0 and len(self.sketch_frames) > 1:
            # A sketch table is a few KB of uint32 — Hamming distances via a
            # host popcount table beat a device dispatch (the retrieval is
            # latency-bound, one call per frame; lib.rs:597-613).
            stack = np.stack(self.frame_sketches)
            x = (stack ^ self.frames[frame].sketch[None, :]).view(np.uint8)
            d = _POPCOUNT8[x].sum(axis=1, dtype=np.int32)
            order = np.argsort(d, kind="stable")[:similar_frames_search_num]
            # Collect a pool of eligible candidates in sketch order, then
            # rerank the pool by exact descriptor similarity before keeping
            # the top num_similar_frames: the 512-bit sketch is a lossy
            # shortlist (held-out recall@1 0.80), the descriptor score is
            # near-perfect (oracle 1.00; see lsh.descriptor_rerank_score).
            pool_cap = max(4 * num_similar_frames, 8)
            pool = []
            for ix in order:
                found = self.sketch_frames[ix]
                found_feed = self.frames[found].feed
                too_close = (
                    found_feed == feed
                    and abs(frame_feed_ix - self.frames[found].feed_frame)
                    < similar_recent_threshold
                )
                if found == frame or found in recent_frames or too_close:
                    continue
                pool.append(found)
                if len(pool) >= pool_cap:
                    break
            if len(pool) > num_similar_frames:
                q_words = self.frames[frame].descriptors
                scores = [
                    lsh.descriptor_rerank_score(
                        q_words, self.frames[f].descriptors
                    )
                    for f in pool
                ]
                pool = [pool[i] for i in np.argsort(scores, kind="stable")]
            similar_frames = pool[:num_similar_frames]

        reconstruction_frames: dict = {}
        free_frames: list = []
        for found in recent_frames + similar_frames:
            if self.frames[found].view is not None:
                rec, view = self.frames[found].view
                reconstruction_frames.setdefault(rec, []).append(view)
            else:
                free_frames.append(found)
        return reconstruction_frames, free_frames

    # -- persistence (vslam-sandbox/src/main.rs:81-89, 166-175) -------------
    def save(self, path):
        """Write a versioned, schema'd npz checkpoint (no pickled code;
        see :mod:`cv_tpu_torch.sfm.serialize`)."""
        from .serialize import save_npz

        save_npz(self, path)

    @staticmethod
    def load(path, device="cuda") -> "VSlamData":
        """Load a schema'd npz checkpoint, the feeds' intrinsics on
        ``device``.

        ``cv_tpu``'s legacy pickle format is refused: unpickling it would
        build ``cv_tpu``'s classes.  Frame sketches are recomputed from the
        stored descriptors rather than trusted from the file, as in
        ``cv_tpu``: a sketch is a function of the descriptors, the codebook
        and the hashing scheme, and the writer's may differ from this
        process's."""
        with open(path, "rb") as f:
            magic = f.read(2)
        if magic != b"PK":  # npz = zip container
            raise ValueError(
                f"{path}: not an npz checkpoint (format v1 of cv_tpu_torch.sfm.serialize); "
                "cv_tpu's legacy pickle checkpoints are not read"
            )
        from .serialize import load_npz

        data = load_npz(path, device)
        data.rehash_sketches(device)
        return data

    def rehash_sketches(self, device="cuda"):
        """Recompute every frame's LSH sketch with the current codebook, on
        ``device``."""
        self.frame_sketches = []
        self.sketch_frames = []
        for key, frame in self.frames.items():
            if len(frame.descriptors):
                sketch = _hash_bag(frame.descriptors, device)
            else:
                sketch = np.zeros(lsh.SKETCH_WORDS, np.uint32)
            frame.sketch = sketch
            self.frame_sketches.append(sketch)
            self.sketch_frames.append(key)


def _hash_bag(descriptors, device="cpu") -> np.ndarray:
    """Host (16,) uint32 sketch of (N, 16) uint32 descriptor words, hashed
    on ``device``."""
    words = torch.as_tensor(np.ascontiguousarray(descriptors, np.uint32).view(np.int32), device=device)
    return lsh.hash_bag(words).cpu().numpy().view(np.uint32)
