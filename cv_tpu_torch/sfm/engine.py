"""The incremental vSLAM/SfM engine.

Port of ``cv_tpu/sfm/engine.py`` (reference cv-sfm/src/lib.rs:724-3149,
``VSlam``).  The control flow — registration cascades, constraint
generation, rollback on failure — is host Python over the NumPy data model
(:mod:`cv_tpu_torch.sfm.data`); the dense work runs on the engine's device
(``device``, the CPU or a CUDA card) as tensors in float64:

* feature extraction: :class:`cv_tpu_torch.akaze.AkazeExtractor` (the
  exact extractor, as in cv_tpu) unless another is injected, e.g.
  :class:`cv_tpu_torch.akaze.FastAkazeExtractor`
* descriptor matching: Hamming distances (:mod:`cv_tpu_torch.matching`)
* pose estimation: batched consensus with eight-point / Lambda-Twist
* pose refinement: the three optimizer loops of
  :mod:`cv_tpu_torch.optimize`, each one CUDA kernel launch on a card
  (kernel A in registration, B in three-view init, C in the three-view
  constraints) and the plain loops on the CPU
* graph bundle adjustment + the observation filter: one device pass
  (:func:`cv_tpu_torch.sfm.device_refine.ba_filter`).

The reference's injected generics (Consensus/Estimator/Triangulator) are
constructor arguments with the same roles.
"""

from __future__ import annotations

import inspect
import itertools
import logging

import numpy as np
import torch

from ..akaze import Akaze, AkazeExtractor
from ..camera import CameraIntrinsics, CameraIntrinsicsK1Distortion
from ..consensus import BatchConsensus, Estimator
from ..core import CameraToCamera, Isometry3, camera_to_camera_residual, world_to_camera_residual
from ..core import pose as pose_mod
from ..matching import PAD_DISTANCE, distance_matrix, knn, symmetric_matches
from ..optimize import single_view_l2, three_view_adaptive, three_view_l2
from ..solvers import eight_point, lambda_twist
from . import batch_geom, device_refine, host_geom, se3
from .bicubic import bicubic_colors
from .data import Feed, ThreeViewConstraint, View, VSlamData, _hash_bag, canonical_view_order
from .settings import VSlamSettings

log = logging.getLogger("cv_tpu_torch.sfm")


def _bucket(n, minimum=64):
    b = minimum
    while b < n:
        b *= 2
    return b


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fetch(*tensors):
    """Device tensors -> NumPy arrays (one synchronizing copy each)."""
    return tuple(_host(t) for t in tensors)


def _calibrate_host(intrinsics, pts: np.ndarray):
    """NumPy mirror of ``CameraIntrinsics(K1Distortion).calibrate``
    (pinhole.rs:108-116, 191-202) for the built-in camera models, else
    None.  Exact type checks: a subclass overriding ``calibrate`` gets its
    own method."""
    if type(intrinsics) is CameraIntrinsicsK1Distortion:
        si = intrinsics.simple_intrinsics
        if type(si) is not CameraIntrinsics:
            return None
        k1 = float(_host(intrinsics.k1))
    elif type(intrinsics) is CameraIntrinsics:
        si, k1 = intrinsics, 0.0
    else:
        return None
    pp = _host(si.principal_point).astype(np.float64)
    focals = _host(si.focals).astype(np.float64)
    skew = float(_host(si.skew))
    centered = np.asarray(pts, np.float64) - pp
    y = centered[..., 1] / focals[1]
    x = (centered[..., 0] - skew * y) / focals[0]
    f = 1.0 + k1 * (x * x + y * y)
    v = np.stack([x / f, y / f, np.ones_like(x)], axis=-1)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


class _PrefetchedFrame:
    """Token from :meth:`VSlam.prefetch_extract`: the source image plus the
    unfetched tensors of its already-enqueued extraction."""

    __slots__ = ("image", "handle")

    def __init__(self, image, handle):
        self.image = image
        self.handle = handle


def graph_ba_device(rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid, iterations, rate):
    """Graph bundle adjustment on the tensors' device (lib.rs:1892-1936,
    2382-2414, 2543-2567): ``iterations`` rounds of
    :func:`device_refine.graph_ba_core` over ``(V, 3, 3)``/``(V, 3)``
    world-to-view poses and ``(E,)`` directed edges.  Returns device
    tensors ``(rot, trans, removed)``."""
    return device_refine.graph_ba_core(rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid, iterations, rate)


def _essential_estimate(s):
    return eight_point.estimate(s[0], s[1])


def _essential_residual(m, d):
    return camera_to_camera_residual(
        Isometry3(rotation=m.rotation[..., None, :, :], translation=m.translation[..., None, :]),
        d[0],
        d[1],
    )


def _essential_score(m, d, valid, threshold):
    """The essential estimator's counts and totals without its residuals
    (``core.pose.c2c_score``: the score entry of ``csrc/jacobi.cu`` on a
    card; looked up at each call, where a recorder may have bound it)."""
    return pose_mod.c2c_score(
        Isometry3(rotation=m.rotation[..., None, :, :], translation=m.translation[..., None, :]),
        d[0],
        d[1],
        valid,
        threshold,
    )


def _p3p_estimate(s):
    poses, valid = lambda_twist.estimate(s[0], s[1])
    # Zero-poisoning: a zero pose maps every point to the zero vector, whose
    # bearing is NaN, so consensus scoring's isfinite() rejects it.
    bad = ~valid
    zero = torch.zeros((), dtype=poses.rotation.dtype, device=poses.rotation.device)
    return type(poses)(
        rotation=torch.where(bad[..., None, None], zero, poses.rotation),
        translation=torch.where(bad[..., None], zero, poses.translation),
    )


def _p3p_residual(m, d):
    return world_to_camera_residual(
        Isometry3(rotation=m.rotation[..., None, :, :], translation=m.translation[..., None, :]),
        d[0],
        d[1],
    )


# Shared default estimators (the reference keeps them module-level so every
# engine uses the same objects).
DEFAULT_ESSENTIAL_ESTIMATOR = Estimator(
    min_samples=8, models_per_sample=4, estimate=_essential_estimate, residual=_essential_residual,
    score=_essential_score,
)
DEFAULT_POSE_ESTIMATOR = Estimator(
    min_samples=3, models_per_sample=4, estimate=_p3p_estimate, residual=_p3p_residual
)


def _takes_device(cls) -> bool:
    """Whether an extractor class (or factory) takes a ``device`` keyword."""
    try:
        params = inspect.signature(cls).parameters
    except (TypeError, ValueError):
        return False
    return "device" in params or any(p.kind is p.VAR_KEYWORD for p in params.values())


class VSlam:
    """The reconstruction engine (lib.rs:724-790) on ``device``: the CUDA
    card unless the caller asks for the CPU."""

    def __init__(
        self,
        data: VSlamData | None = None,
        settings: VSlamSettings | None = None,
        seed: int = 0,
        single_view_hypotheses: int = 1024,
        two_view_hypotheses: int = 2048,
        extractor_cls=AkazeExtractor,
        pose_estimator: Estimator | None = None,
        essential_estimator: Estimator | None = None,
        triangulator=None,
        single_view_consensus: BatchConsensus | None = None,
        two_view_consensus: BatchConsensus | None = None,
        device="cuda",
    ):
        """The roles of ``VSlam<C1, C2, PE, EE, T, R>`` (lib.rs:724-774):
        ``single_view_consensus``/``two_view_consensus`` (C1/C2),
        ``pose_estimator`` (PE, default Lambda-Twist P3P),
        ``essential_estimator`` (EE, default eight-point), ``triangulator``
        (T, ``(pose_list, bearing_list) -> homogeneous point | None``,
        default Linear-Eigen); the seeded NumPy RNG and ``torch.Generator``
        play R.  ``extractor_cls`` builds the extractor from the AKAZE
        config (default: :class:`AkazeExtractor`, as in cv_tpu), on the
        engine's device when it takes ``device``."""
        self.device = torch.device(device)
        self.dtype = torch.float64
        self.data = data or VSlamData()
        self.settings = settings or VSlamSettings()
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # One inlier-refit round of 256 and ARRSAC-style preemptive scoring,
        # as in the reference engine.
        self.single_view_consensus = single_view_consensus or BatchConsensus(
            threshold=self.settings.single_view_consensus_threshold,
            hypotheses=single_view_hypotheses,
            refit_rounds=1,
            refit_hypotheses=256,
            prescore_matches=64,
            prescore_keep=512,
            device=self.device,
        )
        self.two_view_consensus = two_view_consensus or BatchConsensus(
            threshold=self.settings.two_view_consensus_threshold,
            hypotheses=two_view_hypotheses,
            refit_rounds=1,
            refit_hypotheses=256,
            prescore_matches=64,
            prescore_keep=512,
            device=self.device,
        )
        self.triangulator = triangulator or host_geom.triangulate_observations
        config = Akaze(
            detector_threshold=self.settings.akaze_threshold,
            maximum_features=self.settings.tracking_features,
        )
        if _takes_device(extractor_cls):
            self._extractor = extractor_cls(config, device=self.device)
        else:
            self._extractor = extractor_cls(config)
        self.essential_estimator = essential_estimator or DEFAULT_ESSENTIAL_ESTIMATOR
        self.pose_estimator = pose_estimator or DEFAULT_POSE_ESTIMATOR
        # In-flight async BA+filter record (settings.async_optimize); every
        # engine entry point finalizes it via _flush_pending before touching
        # reconstruction state.
        self._pending_opt = None
        for feed in self.data.feeds.values():
            self._check_device(feed.intrinsics)

    def _tensor(self, a, dtype=None):
        a = np.asarray(a)
        if a.dtype == bool:
            return torch.as_tensor(a, device=self.device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a, dtype=dtype or torch.int64, device=self.device)
        return torch.as_tensor(a, dtype=dtype or self.dtype, device=self.device)

    def _words(self, w: np.ndarray) -> torch.Tensor:
        """uint32 descriptor words -> int32 bit-pattern tensor on device."""
        return torch.as_tensor(np.ascontiguousarray(w, np.uint32).view(np.int32), device=self.device)

    def _pose(self, p, cls=Isometry3):
        return cls(rotation=self._tensor(p[0]), translation=self._tensor(p[1]))

    # -- feeds / frames ------------------------------------------------------
    def _check_device(self, intrinsics):
        """Raise unless a feed's camera model lives on the engine's device
        (a loaded checkpoint's models are built on the device its caller
        names): a model elsewhere would take the calibration off the card
        unnoticed.  Models without ``focals`` are not checked."""
        si = getattr(intrinsics, "simple_intrinsics", intrinsics)
        focals = getattr(si, "focals", None)
        if not isinstance(focals, torch.Tensor):
            return
        dev = focals.device
        if dev.type != self.device.type or (self.device.index is not None and dev.index != self.device.index):
            raise ValueError(
                f"camera intrinsics on {dev}, the engine on {self.device}: build or load them on the "
                "engine's device (VSlamData.load(path, device=...))"
            )

    def add_feed(self, intrinsics: CameraIntrinsicsK1Distortion) -> int:
        self._check_device(intrinsics)
        return self.data.feeds.insert(Feed(intrinsics=intrinsics, frames=[]))

    def prefetch_extract(self, feed: int, image: np.ndarray):
        """Enqueue ``image``'s extraction now and return a token that
        :meth:`add_frame` accepts in place of the image; extractors without
        a dispatch/fetch split get a deferred-image token."""
        if hasattr(self._extractor, "dispatch_extract"):
            return _PrefetchedFrame(image, self._extractor.dispatch_extract(image))
        return _PrefetchedFrame(image, None)

    def add_frame(self, feed: int, image) -> int:
        """Extract features, add the frame, and attempt localization
        (lib.rs:790-809).  ``image``: an array, or a token from
        :meth:`prefetch_extract`."""
        descriptors, bearings, responses, colors, sketch = self.kps_descriptors(
            self.data.feeds[feed].intrinsics, image
        )
        frame = self.data.add_frame_features(feed, descriptors, bearings, responses, colors, sketch=sketch)
        reconstruction_frames, free_frames = self.data.find_visually_similar_and_recent_frames(
            frame,
            self.settings.tracking_similar_frames,
            self.settings.tracking_recent_frames,
            self.settings.tracking_similar_frame_recent_threshold,
            self.settings.tracking_similar_frame_search_num,
        )
        # Finalize any in-flight BA+filter after the extract fetch above.
        self._flush_pending()
        self.try_localize(frame, reconstruction_frames, free_frames)
        return frame

    def kps_descriptors(self, intrinsics, image):
        """AKAZE extraction + bicubic color sampling + calibration
        (lib.rs:2195-2236).  ``image`` may be a :meth:`prefetch_extract`
        token."""
        if isinstance(image, _PrefetchedFrame):
            token, image = image, image.image
            if token.handle is not None:
                kp, words, sketch = self._extractor.fetch_extract(token.handle)
            elif hasattr(self._extractor, "extract_with_sketch"):
                kp, words, sketch = self._extractor.extract_with_sketch(image)
            else:
                kp, words = self._extractor.extract(image)
                sketch = None
        elif hasattr(self._extractor, "extract_with_sketch"):
            kp, words, sketch = self._extractor.extract_with_sketch(image)
        else:
            kp, words = self._extractor.extract(image)
            sketch = None
        if sketch is None:
            # The frame's LSH sketch on the engine's device, as cv_tpu's
            # add_frame_features hashes it on its default device.
            sketch = _hash_bag(words, self.device)
        pts = kp["point"]
        colors = bicubic_colors(image, pts)
        bearings = _calibrate_host(intrinsics, pts)
        if bearings is None:
            bearings = _host(intrinsics.calibrate(self._tensor(pts))).astype(np.float64)
        # Already sorted by response descending (extractor contract).
        return words, bearings, kp["response"], colors, sketch

    # -- localization cascade (lib.rs:847-958) -------------------------------
    def try_localize(self, frame, reconstruction_frames, free_frames):
        recs = sorted(reconstruction_frames.items(), key=lambda kv: -len(kv[1]))
        for dest_reconstruction, view_matches in recs:
            # The previous round may have left a BA+filter pass pending;
            # its verdicts can remove views or whole reconstructions, so
            # finish it before reading the frame's view and the view counts
            # (cv_tpu reads them first, engine.py:404-410).
            self._flush_pending()
            if dest_reconstruction not in self.data.reconstructions:
                continue
            if self.data.frames[frame].view is not None:
                src_reconstruction, view = self.data.frames[frame].view
                if (
                    src_reconstruction != dest_reconstruction
                    and len(self.data.reconstructions[src_reconstruction].views) >= 3
                    and len(self.data.reconstructions[dest_reconstruction].views) >= 3
                ):
                    if (
                        self.try_merge_reconstructions(src_reconstruction, view, dest_reconstruction, view_matches)
                        is not None
                    ):
                        self.optimize_reconstruction(dest_reconstruction)
            else:
                if self.incorporate_frame(dest_reconstruction, frame, view_matches) is not None:
                    self.optimize_reconstruction(dest_reconstruction)

        if self.data.frames[frame].view is None:
            self.try_init(frame, free_frames)

        if self.data.frames[frame].view is not None:
            reconstruction, _ = self.data.frames[frame].view
            for found in free_frames:
                if self.data.frames[found].view is not None:
                    continue
                self.try_localize_and_incorporate(reconstruction, found)
                if reconstruction not in self.data.reconstructions:
                    return None
        return self.data.frames[frame].view

    def try_localize_and_incorporate(self, reconstruction, frame):
        view_matches = self.data.find_visually_similar_and_recent_frames(
            frame,
            self.settings.tracking_similar_frames,
            self.settings.tracking_recent_frames,
            self.settings.tracking_similar_frame_recent_threshold,
            self.settings.tracking_similar_frame_search_num,
        )[0].get(reconstruction)
        if not view_matches:
            log.info("no similar frames in the reconstruction")
            return None
        view = self.incorporate_frame(reconstruction, frame, view_matches)
        if view is None:
            return None
        if self.optimize_reconstruction(reconstruction) is None:
            return None
        return view

    def try_init(self, center, options):
        out = self.init_reconstruction(center, options)
        if out is None:
            log.info("failed to initialize reconstruction")
            return None
        (first, first_pose), (second, second_pose), combined, fm, sm = out
        return self.data.add_reconstruction(center, first, second, first_pose, second_pose, combined, fm, sm)

    # -- two-view init (lib.rs:1365-1432) -------------------------------------
    def _padded_words(self, descriptors):
        n = len(descriptors)
        w = np.zeros((_bucket(n), descriptors.shape[1]), np.uint32)
        w[:n] = descriptors
        return self._words(w)

    def symmetric_matching(self, frame_a, frame_b):
        """Mutual-best Hamming matching with margin (lib.rs:3097-3133)."""
        a = self.data.frames[frame_a]
        b = self.data.frames[frame_b]
        if len(a) < 2 or len(b) < 2:
            return []
        na, nb = len(a), len(b)
        idx, keep = symmetric_matches(
            self._padded_words(a.descriptors),
            self._padded_words(b.descriptors),
            better_by=self.settings.two_view_match_better_by,
            n_valid_a=na,
            n_valid_b=nb,
        )
        keep, idx = _fetch(keep, idx)
        return [[int(i), int(idx[i])] for i in np.nonzero(keep[:na])[0]]

    def _knn(self, queries, words, n_valid, k):
        """k-NN ``(distances, indices)`` over bucket-padded word tensors."""
        d = distance_matrix(queries, words)
        cols = torch.arange(words.shape[0], device=d.device)[None, :]
        return knn(torch.where(cols < n_valid, d, PAD_DISTANCE), k)

    def init_two_view(self, a, b):
        matches = self.symmetric_matching(a, b)
        log.info("two-view: %d symmetric matches", len(matches))
        if len(matches) < self.essential_estimator.min_samples:
            return None
        self.rng.shuffle(matches)
        fa = self.data.frames[a]
        fb = self.data.frames[b]
        ia = np.array([m[0] for m in matches])
        ib = np.array([m[1] for m in matches])
        n = len(matches)
        pad = _bucket(n) - n
        bear_a = np.pad(fa.bearings[ia], ((0, pad), (0, 0)))
        bear_b = np.pad(fb.bearings[ib], ((0, pad), (0, 0)))
        model, mask, count = self.two_view_consensus.model_inliers(
            self.generator,
            self.essential_estimator,
            (self._tensor(bear_a), self._tensor(bear_b)),
            n_valid=n,
        )
        count, mask, rot_h, t_h = _fetch(count, mask, model.rotation, model.translation)
        if int(count) < self.settings.two_view_minimum_robust_matches:
            log.info("two-view inliers %d < %d; rejecting", int(count), self.settings.two_view_minimum_robust_matches)
            return None
        pose = (np.asarray(rot_h, np.float64), np.asarray(t_h, np.float64))
        return pose, [m for m, ok in zip(matches, mask[:n]) if ok]

    # -- robustness predicates -------------------------------------------------
    def is_bi_landmark_robust(self, pose, a, b, maximum_sine_distance):
        """(lib.rs:1306-1317)"""
        return host_geom.epipolar_loss(pose[1], se3.rotate(pose, a), b) < maximum_sine_distance

    def is_tri_landmark_robust(self, first_pose, second_pose, c, f, s, maximum_cosine_distance,
                               incidence_minimum_cosine_distance):
        """(lib.rs:1319-1360)"""
        point = self.triangulator([se3.identity(), first_pose, second_pose], [c, f, s])
        if point is None:
            return False
        f_in_c = se3.inverse(first_pose)[0] @ f
        s_in_c = se3.inverse(second_pose)[0] @ s
        cos_ok = (
            1.0 - float(host_geom.bearing_of(point) @ c) < maximum_cosine_distance
            and 1.0 - float(host_geom.transform_bearing(first_pose, point) @ f) < maximum_cosine_distance
            and 1.0 - float(host_geom.transform_bearing(second_pose, point) @ s) < maximum_cosine_distance
        )
        inc = incidence_minimum_cosine_distance
        incidence_ok = (
            1.0 - float(c @ f_in_c) > inc or 1.0 - float(c @ s_in_c) > inc or 1.0 - float(f_in_c @ s_in_c) > inc
        )
        return cos_ok and incidence_ok

    def _tri_robust_batch_init(self, first_pose, second_pose, bc, bf, bs, max_cos, inc):
        """Vectorized :meth:`is_tri_landmark_robust` over N common triples
        (the batch_geom kernels, same math)."""
        n = len(bc)
        rot = np.broadcast_to(np.stack([np.eye(3), first_pose[0], second_pose[0]]), (n, 3, 3, 3))
        trans = np.broadcast_to(np.stack([np.zeros(3), first_pose[1], second_pose[1]]), (n, 3, 3))
        bear = np.stack([bc, bf, bs], axis=1)  # (N, 3, 3)
        mask = np.ones((n, 3), bool)
        pts, ok = batch_geom.triangulate_batch(rot, trans, bear, mask)
        cosd = batch_geom.reproject_cosine_batch(rot, trans, bear, mask, pts)
        cos_ok = np.all(cosd < max_cos, axis=1)
        # f_in_c = R1^T f, s_in_c = R2^T s (lib.rs:1341-1356).
        f_in_c = bf @ first_pose[0]
        s_in_c = bs @ second_pose[0]
        incidence_ok = (
            (1.0 - np.sum(bc * f_in_c, axis=1) > inc)
            | (1.0 - np.sum(bc * s_in_c, axis=1) > inc)
            | (1.0 - np.sum(f_in_c * s_in_c, axis=1) > inc)
        )
        return pts, ok & cos_ok & incidence_ok

    # -- three-view init (lib.rs:966-1304) --------------------------------------
    def _optimize_init(self, fp, sp, triples):
        """Three-view L2 patience loop (kernel B on a card) over the robust
        triples, padded to the landmark bucket."""
        s = self.settings
        n = len(triples)
        npad = _bucket(n, s.three_view_optimization_landmarks)
        obs = np.zeros((npad, 3, 3))
        obs[:n] = np.asarray(triples)
        valid = np.zeros(npad, bool)
        valid[:n] = True
        o1, o2 = three_view_l2(
            (self._pose(fp, CameraToCamera), self._pose(sp, CameraToCamera)),
            self._tensor(obs),
            self._tensor(valid),
            0.001,
            s.three_view_patience,
        )
        r1, t1, r2, t2 = _fetch(o1.rotation, o1.translation, o2.rotation, o2.translation)
        return (r1.astype(np.float64), t1.astype(np.float64)), (r2.astype(np.float64), t2.astype(np.float64))

    def init_reconstruction(self, center, options):
        two_views = []
        for option in options:
            res = self.init_two_view(center, option)
            if res is not None:
                pose, matches = res
                two_views.append((option, pose, matches))
        settings = self.settings

        for (first, first_pose, first_matches), (second, second_pose, second_matches) in itertools.combinations(
            two_views, 2
        ):
            second_map = {c: s for c, s in second_matches}
            common = [(c, f, second_map[c]) for c, f in first_matches if c in second_map]
            self.rng.shuffle(common)
            fc = self.data.frames[center]
            ff = self.data.frames[first]
            fs = self.data.frames[second]

            use_batch = self.triangulator is host_geom.triangulate_observations
            if use_batch and common:
                bc_all = np.stack([fc.bearings[c] for c, _, _ in common])
                bf_all = np.stack([ff.bearings[f] for _, f, _ in common])
                bs_all = np.stack([fs.bearings[s] for _, _, s in common])

            scales = []
            if use_batch and common:
                # One robustness batch + two 2-observation triangulation
                # batches over all common triples.
                _, rob = self._tri_robust_batch_init(
                    first_pose, second_pose, bc_all, bf_all, bs_all, 1.0,
                    settings.robust_observation_incidence_minimum_cosine_distance,
                )
                n_c = len(common)
                eye_rot = np.broadcast_to(np.eye(3), (n_c, 3, 3))
                zero_t = np.zeros((n_c, 3))
                pts_f, ok_f = batch_geom.triangulate_batch(
                    np.stack([eye_rot, np.broadcast_to(first_pose[0], (n_c, 3, 3))], axis=1),
                    np.stack([zero_t, np.broadcast_to(first_pose[1], (n_c, 3))], axis=1),
                    np.stack([bc_all, bf_all], axis=1),
                    np.ones((n_c, 2), bool),
                )
                pts_s, ok_s = batch_geom.triangulate_batch(
                    np.stack([eye_rot, np.broadcast_to(second_pose[0], (n_c, 3, 3))], axis=1),
                    np.stack([zero_t, np.broadcast_to(second_pose[1], (n_c, 3))], axis=1),
                    np.stack([bc_all, bs_all], axis=1),
                    np.ones((n_c, 2), bool),
                )
                with np.errstate(all="ignore"):
                    fp_e = pts_f[:, :3] / pts_f[:, 3:4]
                    sp_e = pts_s[:, :3] / pts_s[:, 3:4]
                    ratio = np.sum(fp_e * fp_e, axis=1) / np.sum(sp_e * sp_e, axis=1)
                pt_ok = (
                    ok_f & ok_s
                    & (pts_f[:, 3] != 0) & (pts_s[:, 3] != 0)
                    & np.isfinite(fp_e).all(axis=1) & np.isfinite(sp_e).all(axis=1)
                )
                good = rob & pt_ok & np.isfinite(ratio) & (ratio > 0)
                scales = [float(r) for r in ratio[good]]
            else:
                for c, f, s in common:
                    bc, bf, bs = fc.bearings[c], ff.bearings[f], fs.bearings[s]
                    if not self.is_tri_landmark_robust(
                        first_pose, second_pose, bc, bf, bs, 1.0,
                        settings.robust_observation_incidence_minimum_cosine_distance,
                    ):
                        continue
                    fp = host_geom.point_of(self.triangulator([se3.identity(), first_pose], [bc, bf]))
                    sp = host_geom.point_of(self.triangulator([se3.identity(), second_pose], [bc, bs]))
                    if fp is None or sp is None:
                        continue
                    ratio = float(fp @ fp) / float(sp @ sp)
                    if not np.isfinite(ratio) or ratio <= 0:
                        continue
                    scales.append(ratio)
            if len(scales) < settings.three_view_minimum_relative_scales:
                log.info("not enough relative scales (%d)", len(scales))
                continue
            scales.sort()
            median_scale = float(np.sqrt(scales[len(scales) // 2]))
            cur_first = first_pose
            cur_second = se3.scale(second_pose, median_scale)

            def robust_triples(fp, sp, max_cos, inc):
                cap = settings.three_view_optimization_landmarks
                if use_batch and common:
                    _, rob = self._tri_robust_batch_init(fp, sp, bc_all, bf_all, bs_all, max_cos, inc)
                    return [(bc_all[i], bf_all[i], bs_all[i]) for i in np.nonzero(rob)[0][:cap]]
                out = []
                for c, f, s in common:
                    bc, bf, bs = fc.bearings[c], ff.bearings[f], fs.bearings[s]
                    if self.is_tri_landmark_robust(fp, sp, bc, bf, bs, max_cos, inc):
                        out.append((bc, bf, bs))
                        if len(out) >= cap:
                            break
                return out

            opti = robust_triples(
                cur_first, cur_second, 1.0, settings.robust_observation_incidence_minimum_cosine_distance
            )
            # Robust bearing-pair check (lib.rs:1085-1106).
            num_robust_pairs = 0
            thresh = settings.robust_view_bearing_pair_minimum_cosine_distance
            arr = np.asarray(opti)  # (n, 3, 3)
            if len(arr):
                diffs = 1.0 - np.einsum("imk,jmk->ijm", arr, arr)
                pair_ok = np.all(diffs > thresh, axis=-1)
                num_robust_pairs = int(np.sum(np.triu(pair_ok, 1)))
            if num_robust_pairs < settings.robust_view_num_robust_bearing_pair:
                log.info("not enough robust bearing pairs")
                return None
            robust_minimum_matches = len(opti) // 2

            failed = False
            for _ in range(settings.three_view_filter_loop_iterations):
                if len(opti) < 32 or len(opti) <= robust_minimum_matches:
                    log.info("three-view: insufficient robust matches mid-loop")
                    failed = True
                    break
                cur_first, cur_second = self._optimize_init(cur_first, cur_second, opti)
                opti = robust_triples(
                    cur_first, cur_second, settings.maximum_cosine_distance,
                    settings.robust_observation_incidence_minimum_cosine_distance,
                )
            if failed:
                continue
            if len(opti) < 32 or len(opti) <= robust_minimum_matches:
                log.info("three-view: insufficient robust matches at end")
                continue
            cur_first, cur_second = self._optimize_init(cur_first, cur_second, opti)

            first_map = {c: f for c, f in first_matches}
            combined_matches = [
                (c, f, s)
                for c, f, s in common
                if self.is_tri_landmark_robust(
                    cur_first, cur_second, fc.bearings[c], ff.bearings[f], fs.bearings[s],
                    settings.maximum_cosine_distance, 0.0,
                )
            ]
            first_only = [
                [c, f]
                for c, f in first_matches
                if c not in second_map
                and self.is_bi_landmark_robust(cur_first, fc.bearings[c], ff.bearings[f], settings.maximum_sine_distance)
            ]
            second_only = [
                [c, s]
                for c, s in second_matches
                if c not in first_map
                and self.is_bi_landmark_robust(cur_second, fc.bearings[c], fs.bearings[s], settings.maximum_sine_distance)
            ]
            num_robust_matches = sum(
                1
                for c, f, s in common
                if self.is_tri_landmark_robust(
                    cur_first, cur_second, fc.bearings[c], ff.bearings[f], fs.bearings[s],
                    settings.maximum_cosine_distance,
                    settings.robust_observation_incidence_minimum_cosine_distance,
                )
            )
            log.info(
                "three-view: %d combined, %d robust, %d first-only, %d second-only",
                len(combined_matches), num_robust_matches, len(first_only), len(second_only),
            )
            if num_robust_matches <= robust_minimum_matches:
                continue
            if num_robust_matches < settings.three_view_minimum_robust_matches:
                continue
            return (first, cur_first), (second, cur_second), combined_matches, first_only, second_only
        log.info("no three-view match found")
        return None

    # -- landmark helpers (lib.rs:2874-3052) -------------------------------------
    def triangulate_landmark(self, reconstruction, landmark):
        if len(self.data.landmark(reconstruction, landmark).observations) < 2:
            return None
        pb = self.data.landmark_pose_bearings(reconstruction, landmark)
        return self.triangulator([p for p, _ in pb], [b for _, b in pb])

    def _world_bearings(self, reconstruction, observations):
        return [
            se3.inverse(self.data.pose(reconstruction, v))[0] @ self.data.observation_bearing(reconstruction, v, f)
            for v, f in observations
        ]

    @staticmethod
    def _any_incident_pair(wb, thresh) -> bool:
        """Some bearing pair with incidence cosine distance above ``thresh``
        (lib.rs:2907-2934), from one Gram product."""
        if len(wb) < 2:
            return False
        w = np.stack(wb)
        g = w @ w.T
        iu = np.triu_indices(len(wb), 1)
        return bool(((1.0 - g[iu]) > thresh).any())

    def are_observations_robust(self, reconstruction, observations):
        """(lib.rs:2907-2934)"""
        s = self.settings
        needed = min(s.robust_minimum_observations, len(self.data.reconstructions[reconstruction].views))
        if len(observations) < needed:
            return False
        return self._any_incident_pair(
            self._world_bearings(reconstruction, observations),
            s.robust_observation_incidence_minimum_cosine_distance,
        )

    def is_landmark_robust(self, reconstruction, landmark):
        return self.are_observations_robust(reconstruction, self.data.landmark_observations(reconstruction, landmark))

    def triangulate_landmark_robust(self, reconstruction, landmark):
        if not self.is_landmark_robust(reconstruction, landmark):
            return None
        pb = self.data.landmark_pose_bearings(reconstruction, landmark)
        return self.triangulator([p for p, _ in pb], [b for _, b in pb])

    def is_merged_landmark_robust(self, reconstruction, landmarks):
        obs = [ob for lm in landmarks for ob in self.data.landmark_observations(reconstruction, lm)]
        return self.are_observations_robust(reconstruction, obs)

    def triangulate_merged_landmark_robust(self, reconstruction, landmarks):
        if not self.is_merged_landmark_robust(reconstruction, landmarks):
            return None
        pb = [x for lm in landmarks for x in self.data.landmark_pose_bearings(reconstruction, lm)]
        return self.triangulator([p for p, _ in pb], [b for _, b in pb])

    def observation_loss(self, reconstruction, view, feature):
        """Cosine-distance loss of one observation against its landmark
        (lib.rs:2570-2620): 2.0 for singleton landmarks, epipolar sine
        converted to cosine distance for 2-observation landmarks, and the
        triangulated-point cosine distance (2.0 on failure) otherwise."""
        self._flush_pending()
        landmark = self.data.observation_landmark(reconstruction, view, feature)
        pose = self.data.pose(reconstruction, view)
        bearing = self.data.observation_bearing(reconstruction, view, feature)
        observations = self.data.landmark_observations(reconstruction, landmark)
        if len(observations) == 0:
            raise AssertionError("landmark with 0 observations shouldnt exist ever")
        if len(observations) == 1:
            return 2.0
        if len(observations) == 2:
            (fv, ff), (sv, sf) = observations
            first_pose = self.data.pose(reconstruction, fv)
            first_bearing = self.data.observation_bearing(reconstruction, fv, ff)
            second_pose = self.data.pose(reconstruction, sv)
            second_bearing = self.data.observation_bearing(reconstruction, sv, sf)
            total = se3.compose(second_pose, se3.inverse(first_pose))
            first_in_b = total[0] @ first_bearing
            sine = host_geom.epipolar_loss(total[1], first_in_b, second_bearing)
            return 1.0 - float(np.cos(np.arcsin(min(sine, 1.0))))
        point = self.triangulate_landmark(reconstruction, landmark)
        if point is None:
            return 2.0
        return 1.0 - float(host_geom.transform_bearing(pose, point) @ bearing)

    def merge_landmarks_dedup(self, reconstruction, landmark_a, landmark_b):
        """Merge two landmarks that may share views (lib.rs:2818-2872):
        for every shared view, split off the observation with the worse
        ``observation_loss``; abort (returning None) if any split would
        empty a landmark, else merge unconditionally."""
        self._flush_pending()
        obs_a = self.data.landmark(reconstruction, landmark_a).observations
        obs_b = self.data.landmark(reconstruction, landmark_b).observations
        dups = [(v, (fa, obs_b[v])) for v, fa in obs_a.items() if v in obs_b]
        success = True
        for view, observations in dups:
            # The reference's max_by_key keeps the last maximum on ties.
            loss0 = self.observation_loss(reconstruction, view, observations[0])
            loss1 = self.observation_loss(reconstruction, view, observations[1])
            worst = observations[1] if loss1 >= loss0 else observations[0]
            if not self.data.split_observation(reconstruction, view, worst):
                # Splitting would empty the landmark: keep splitting the
                # remaining dups for consistency but abort the merge.
                success = False
        if success:
            return self.data.merge_landmarks(reconstruction, landmark_a, landmark_b)
        return None

    def is_landmark_robust_without_view(self, reconstruction, landmark, without_view):
        """Robustness predicate ignoring one view (lib.rs:3003-3027): any
        pair of remaining observations with incidence cosine distance above
        the minimum."""
        self._flush_pending()
        obs = [o for o in self.data.landmark_observations(reconstruction, landmark) if o[0] != without_view]
        return self._any_incident_pair(
            self._world_bearings(reconstruction, obs),
            self.settings.robust_observation_incidence_minimum_cosine_distance,
        )

    def triangulate_landmark_robust_without_view(self, reconstruction, landmark, without_view):
        """(lib.rs:3029-3044)"""
        if not self.is_landmark_robust_without_view(reconstruction, landmark, without_view):
            return None
        pb = self.data.landmark_pose_bearings_without_view(reconstruction, landmark, without_view)
        return self.triangulator([p for p, _ in pb], [b for _, b in pb])

    def is_observation_consistent(self, pose, bearing, others):
        """(lib.rs:2937-2967)"""
        if len(others) == 1:
            other_pose, other_bearing = others[0]
            total = se3.compose(other_pose, se3.inverse(pose))
            return self.is_bi_landmark_robust(total, bearing, other_bearing, self.settings.maximum_sine_distance)
        all_obs = others + [(pose, bearing)]
        point = self.triangulator([p for p, _ in all_obs], [b for _, b in all_obs])
        if point is None:
            return False
        return all(
            1.0 - float(host_geom.transform_bearing(p, point) @ b) < self.settings.maximum_cosine_distance
            for p, b in all_obs
        )

    def are_landmarks_sharing_view(self, reconstruction, a, b):
        views_a = set(self.data.landmark(reconstruction, a).observations)
        return any(v in views_a for v in self.data.landmark(reconstruction, b).observations)

    # -- frame registration (lib.rs:1452-1812) -----------------------------------
    def register_frame(self, reconstruction, frame, view_matches):
        original_matches = []
        n_features = len(self.data.frames[frame])
        end = min(self.settings.single_view_initial_features, n_features)
        start = 0
        while True:
            success = self.register_frame_subset(reconstruction, frame, view_matches, range(start, end), original_matches)
            if success is not None:
                return success
            if end == n_features:
                return None
            start, end = end, min(end * 2, n_features)

    def register_frame_subset(self, reconstruction_key, frame_key, view_matches, add_features, original_matches):
        s = self.settings
        rec = self.data.reconstructions[reconstruction_key]
        new_frame = self.data.frames[frame_key]
        feat_range = list(add_features)
        if feat_range:
            # 3-NN of each new feature against each matched view's frame,
            # then landmark-level dedup + margins.  Both sides are
            # bucket-padded; padded columns get sentinel distances.
            nq = len(feat_range)
            self_desc = self._padded_words(new_frame.descriptors[feat_range])
            pending = []
            for view_match in view_matches:
                vframe = self.data.frames[rec.views[view_match].frame]
                nv = len(vframe)
                d, idx = self._knn(self_desc, self._padded_words(vframe.descriptors), nv, min(3, nv))
                pending.append((view_match, d, idx))
            # Per row: pool all (landmark, distance) pairs across views, keep
            # each landmark's min distance, rank the distinct landmarks.
            lm_cols, d_cols = [], []
            for vm, d, idx in pending:
                d, idx = _fetch(d, idx)
                view_lms = np.asarray(rec.views[vm].landmarks, np.int64)
                lm_cols.append(view_lms[idx[:nq]])  # (nq, k)
                d_cols.append(d[:nq])
            lm_all = np.concatenate(lm_cols, axis=1)  # (nq, V*k)
            d_all = np.concatenate(d_cols, axis=1).astype(np.int64)
            order = np.argsort(d_all, axis=1, kind="stable")
            lm_sorted = np.take_along_axis(lm_all, order, axis=1)
            d_sorted = np.take_along_axis(d_all, order, axis=1)
            # First occurrence of each landmark in distance order is its min
            # distance; later duplicates are suppressed.
            dup = np.zeros_like(lm_sorted, bool)
            for j in range(1, lm_sorted.shape[1]):
                dup[:, j] = (lm_sorted[:, :j] == lm_sorted[:, j : j + 1]).any(1)
            rank = np.cumsum(~dup, axis=1) - 1
            n_distinct = (~dup).sum(axis=1)
            top_d = np.full((nq, 3), np.iinfo(np.int64).max, np.int64)
            top_l = np.zeros((nq, 3), np.int64)
            for r in range(3):
                rows, cols = np.nonzero((~dup) & (rank == r))
                top_d[rows, r] = d_sorted[rows, cols]
                top_l[rows, r] = lm_sorted[rows, cols]
            enough = n_distinct >= 3
            single = enough & (top_d[:, 0] + s.single_view_match_better_by <= top_d[:, 1])
            pair = enough & ~single & (top_d[:, 1] + s.single_view_match_better_by <= top_d[:, 2])
            for row, self_feature in enumerate(feat_range):
                if single[row]:
                    original_matches.append(([int(top_l[row, 0])], self_feature))
                elif pair[row]:
                    if not self.are_landmarks_sharing_view(reconstruction_key, int(top_l[row, 0]), int(top_l[row, 1])):
                        original_matches.append(([int(top_l[row, 0]), int(top_l[row, 1])], self_feature))

        # Deduplicate: a landmark matched by two features is always wrong.
        counts = {}
        for landmarks, _ in original_matches:
            for lm in landmarks:
                counts[lm] = counts.get(lm, 0) + 1
        matches = [(lms, f) for lms, f in original_matches if all(counts[lm] == 1 for lm in lms)]
        matches.sort(key=lambda m: -sum(len(self.data.landmark(reconstruction_key, lm).observations) for lm in m[0]))
        log.info("register: %d deduplicated matches", len(matches))

        use_batch = self.triangulator is host_geom.triangulate_observations
        if use_batch:
            # One batched triangulation + robustness pass for every match
            # (lib.rs:2971-3000); robust points are pose-independent.
            pts, ok = self._robust_points_batch(reconstruction_key, [lms for lms, _ in matches])

            def robust_point(i):
                return pts[i] if ok[i] else None

        else:

            def robust_point(i):
                landmarks = matches[i][0]
                if len(landmarks) == 1:
                    return self.triangulate_landmark_robust(reconstruction_key, landmarks[0])
                return self.triangulate_merged_landmark_robust(reconstruction_key, landmarks)

        matches_3d = []
        for i, (landmarks, feature) in enumerate(matches):
            point = robust_point(i)
            if point is not None:
                matches_3d.append((new_frame.bearings[feature], point))
        if len(matches_3d) < s.single_view_minimum_landmarks:
            log.info("register: only %d robust landmarks", len(matches_3d))
            return None

        if use_batch:
            # Consensus stays on the device and the whole filter cascade
            # chains behind it; one copy at the end.
            n = len(matches_3d)
            nb = _bucket(n)
            bear = np.zeros((nb, 3))
            wp = np.zeros((nb, 4))
            for i, (b, p) in enumerate(matches_3d):
                bear[i] = b
                wp[i] = p
            model, mask_dev, count_dev = self.single_view_consensus.model_inliers(
                self.generator, self.pose_estimator, (self._tensor(bear), self._tensor(wp)), n_valid=n
            )
            return self._register_refine_device(
                reconstruction_key, new_frame, matches, pts, ok, mask_dev,
                (model.rotation, model.translation), count_dev,
            )

        pose, inlier_mask = self._single_view_consensus(matches_3d)
        if pose is None:
            return None
        matches_3d = [m for m, keep in zip(matches_3d, inlier_mask) if keep][: s.single_view_optimization_num_matches]
        robust_minimum_matches = len(matches_3d) // 2

        def optimize(pose, m3d):
            n = len(m3d)
            npad = _bucket(n)
            bear = np.zeros((npad, 3))
            wp = np.zeros((npad, 4))
            for i, (b, p) in enumerate(m3d):
                bear[i] = b
                wp[i] = p
            valid = np.zeros(npad, bool)
            valid[:n] = True
            out = single_view_l2(
                self._pose(pose), self._tensor(bear), self._tensor(wp), self._tensor(valid),
                s.single_view_optimization_rate, s.single_view_patience,
            )
            r, t = _fetch(out.rotation, out.translation)
            return r.astype(np.float64), t.astype(np.float64)

        def consistent_matches(pose):
            out = []
            for i, (landmarks, feature) in enumerate(matches):
                bearing = new_frame.bearings[feature]
                others = [x for lm in landmarks for x in self.data.landmark_pose_bearings(reconstruction_key, lm)]
                if not self.is_observation_consistent(pose, bearing, others):
                    continue
                point = robust_point(i)
                if point is None:
                    continue
                out.append((bearing, point))
                if len(out) >= s.single_view_optimization_num_matches:
                    break
            return out

        for _ in range(s.single_view_filter_loop_iterations):
            if len(matches_3d) <= robust_minimum_matches:
                log.info("register: lost too many matches mid-loop")
                return None
            pose = optimize(pose, matches_3d)
            matches_3d = consistent_matches(pose)
        if len(matches_3d) <= robust_minimum_matches:
            return None
        pose = optimize(pose, matches_3d)

        final_robust = 0
        final_matches = {}
        for i, (landmarks, feature) in enumerate(matches):
            bearing = new_frame.bearings[feature]
            others = [x for lm in landmarks for x in self.data.landmark_pose_bearings(reconstruction_key, lm)]
            if not self.is_observation_consistent(pose, bearing, others):
                continue
            final_matches[feature] = landmarks
            if robust_point(i) is not None:
                final_robust += 1
        if final_robust <= robust_minimum_matches:
            return None
        if len(final_matches) < s.single_view_minimum_robust_landmarks:
            log.info("register: only %d final matches", len(final_matches))
            return None
        return pose, final_matches

    def _register_refine_device(self, reconstruction_key, new_frame, matches, pts, ok, inlier_mask_dev,
                                pose0_dev, count_dev):
        """Finish ``register_frame_subset`` with the device cascade
        (:func:`device_refine.register_refine`) behind the consensus result,
        which is still on the device; the reference's early outs
        (lib.rs:1619-1704) are replayed on the host from one copy."""
        s = self.settings
        rec = self.data.reconstructions[reconstruction_key]
        m = len(matches)
        mb = _bucket(m)
        obs_lists = [
            [o for lm in lms for o in rec.landmarks[lm].observations.items()] for lms, _ in matches
        ] + [[] for _ in range(mb - m)]
        vp, vb = batch_geom.view_caches(self.data, reconstruction_key)
        o_max = _bucket(max(len(x) for x in obs_lists), minimum=4)
        rot_o, trans_o, bear_o, mask_o, _, _ = batch_geom.pack_observations(obs_lists, vp, vb, o_max=o_max)
        bearings = np.zeros((mb, 3))
        for i, (_, f) in enumerate(matches):
            bearings[i] = new_frame.bearings[f]
        points = np.zeros((mb, 4))
        points[:m][ok] = pts[ok]
        point_ok = np.zeros(mb, bool)
        point_ok[:m] = ok
        match_valid = np.zeros(mb, bool)
        match_valid[:m] = True
        # Row i of the consensus problem is the i-th ok row of ``matches``.
        positions = np.zeros(mb, np.int64)
        positions[:m] = np.maximum(np.cumsum(ok) - 1, 0)
        out = device_refine.register_refine(
            pose0_dev[0], pose0_dev[1],
            self._tensor(bearings), self._tensor(points), self._tensor(point_ok), self._tensor(match_valid),
            self._tensor(rot_o), self._tensor(trans_o), self._tensor(bear_o), self._tensor(mask_o),
            inlier_mask_dev, self._tensor(positions),
            s.maximum_sine_distance, s.maximum_cosine_distance,
            filter_iterations=s.single_view_filter_loop_iterations,
            cap=s.single_view_optimization_num_matches,
            rate=s.single_view_optimization_rate,
            patience=s.single_view_patience,
        )
        consensus_count, rot, t, fmask, counts, _, final_robust, c0 = _fetch(count_dev, *out)
        if int(consensus_count) == 0:
            log.info("single-view consensus found no model")
            return None
        c0 = int(c0)
        robust_minimum_matches = c0 // 2
        c_prev = c0
        for i in range(s.single_view_filter_loop_iterations):
            if c_prev <= robust_minimum_matches:
                log.info("register: lost too many matches mid-loop")
                return None
            c_prev = int(counts[i])
        if c_prev <= robust_minimum_matches:
            return None
        if int(final_robust) <= robust_minimum_matches:
            return None
        final_matches = {}
        for i in np.nonzero(fmask[:m])[0]:
            lms, feature = matches[i]
            final_matches[feature] = lms
        if len(final_matches) < s.single_view_minimum_robust_landmarks:
            log.info("register: only %d final matches", len(final_matches))
            return None
        return (np.asarray(rot, np.float64), np.asarray(t, np.float64)), final_matches

    def _single_view_consensus(self, matches_3d):
        n = len(matches_3d)
        nb = _bucket(n)
        bear = np.zeros((nb, 3))
        wp = np.zeros((nb, 4))
        for i, (b, p) in enumerate(matches_3d):
            bear[i] = b
            wp[i] = p
        model, mask, count = self.single_view_consensus.model_inliers(
            self.generator, self.pose_estimator, (self._tensor(bear), self._tensor(wp)), n_valid=n
        )
        count, mask, rot_h, t_h = _fetch(count, mask, model.rotation, model.translation)
        if int(count) == 0:
            log.info("single-view consensus found no model")
            return None, None
        return (np.asarray(rot_h, np.float64), np.asarray(t_h, np.float64)), mask[:n]

    # -- incorporation (lib.rs:2067-2113) -----------------------------------------
    def incorporate_frame(self, reconstruction, frame, view_matches):
        self._flush_pending()
        if reconstruction not in self.data.reconstructions:
            # A deferred BA+filter pass removed the reconstruction: the
            # synchronous path's contract is None, not a KeyError.
            log.info("reconstruction removed by the pending optimize pass")
            return None
        result = self.register_frame(reconstruction, frame, view_matches)
        if result is None:
            log.info("failed to register frame")
            return None
        pose, matches = result
        view = self.data.add_view(reconstruction, frame, pose, lambda feature: matches.get(feature))
        if self.record_view_constraints(reconstruction, view):
            return view
        self.data.remove_view(reconstruction, view)
        return None

    def record_view_constraints(self, reconstruction, view):
        constraints = self.generate_view_constraints(reconstruction, view)
        if (
            len(constraints) < self.settings.optimization_minimum_new_constraints
            and len(constraints) + 1 < len(self.data.reconstructions[reconstruction].views)
        ):
            return False
        for c in constraints:
            self.data.reconstructions[reconstruction].constraints.insert(c)
        return True

    # -- constraint generation (lib.rs:2438-2567) -----------------------------------
    def view_covisibilities(self, reconstruction, view):
        covis = {}
        view_landmarks = self.data.reconstructions[reconstruction].views[view].landmarks
        if self.triangulator is host_geom.triangulate_observations:
            unique = list(dict.fromkeys(view_landmarks))
            _, ok = self._robust_points_batch(reconstruction, unique)
            robust = {lm for lm, good in zip(unique, ok) if good}
            iterate = (lm for lm in view_landmarks if lm in robust)
        else:
            iterate = (
                lm for lm in view_landmarks if self.triangulate_landmark_robust(reconstruction, lm) is not None
            )
        for landmark in iterate:
            for coview in self.data.landmark(reconstruction, landmark).observations:
                if coview != view:
                    covis.setdefault(coview, []).append(landmark)
        return covis

    def generate_view_constraints(self, reconstruction, view):
        s = self.settings
        covis = {
            k: v
            for k, v in self.view_covisibilities(reconstruction, view).items()
            if len(v) >= s.optimization_robust_covisibility_minimum_landmarks
        }
        candidates = list(covis)
        landmark_views = {}
        for coview, landmarks in covis.items():
            for lm in landmarks:
                landmark_views.setdefault(lm, set()).add(coview)

        robust = []
        for a, b in itertools.combinations(candidates, 2):
            covisible = [lm for lm in covis[a] if b in landmark_views[lm]]
            if len(covisible) >= s.optimization_robust_covisibility_minimum_landmarks:
                robust.append((canonical_view_order([view, a, b]), covisible))
        robust.sort(key=lambda x: -len(x[1]))

        visited = set()
        unique = []
        for views, lms in robust:
            if any(v not in visited for v in views):
                visited.update(views)
                unique.append((views, lms))
            if len(unique) >= s.optimization_maximum_three_view_constraints:
                break
        rest = [(v, l) for v, l in robust if all(v != u for u, _ in unique)]
        ordered = unique + rest
        out = []
        max_c = s.optimization_maximum_three_view_constraints
        i = 0
        while i < len(ordered) and len(out) < max_c:
            # One batched device call per chunk of candidate triples (each
            # triple is independent, lib.rs:2520-2534).
            chunk = ordered[i : i + max_c]
            i += len(chunk)
            for c in self._optimize_three_view_chunk(reconstruction, chunk):
                if c is not None:
                    out.append(c)
                if len(out) >= max_c:
                    break
        return out

    def _optimize_three_view_chunk(self, reconstruction, items):
        """Batched :meth:`optimize_three_view` over candidate triples: host
        pre-checks, then the K adaptive optimizations as one call (kernel C
        on a card, one block per problem), then the scale post-check
        (lib.rs:1939-2062)."""
        s = self.settings
        results = [None] * len(items)
        problems = []
        for i, (views, lms) in enumerate(items):
            prep = self._prep_three_view(reconstruction, views, list(lms))
            if prep is not None:
                problems.append((i, views, prep))
        if not problems:
            return results
        n = _bucket(s.optimization_maximum_landmarks, minimum=8)
        k = _bucket(len(problems), minimum=4)
        rot1 = np.tile(np.eye(3), (k, 1, 1))
        t1 = np.zeros((k, 3))
        rot2 = np.tile(np.eye(3), (k, 1, 1))
        t2 = np.zeros((k, 3))
        obs = np.zeros((k, n, 3, 3))
        valid = np.zeros((k, n), bool)
        for j, (_, _, (first_pose, second_pose, arr, _)) in enumerate(problems):
            rot1[j], t1[j] = first_pose
            rot2[j], t2[j] = second_pose
            obs[j, : len(arr)] = arr
            valid[j, : len(arr)] = True
        o1, o2 = three_view_adaptive(
            (self._pose((rot1, t1), CameraToCamera), self._pose((rot2, t2), CameraToCamera)),
            self._tensor(obs),
            self._tensor(valid),
            s.constraint_patience,
        )
        o1r, o1t, o2r, o2t = _fetch(o1.rotation, o1.translation, o2.rotation, o2.translation)
        for j, (i, views, (first_pose, second_pose, _, original_scale)) in enumerate(problems):
            fp = (np.asarray(o1r[j], np.float64), np.asarray(o1t[j], np.float64))
            sp = (np.asarray(o2r[j], np.float64), np.asarray(o2t[j], np.float64))
            final_scale = float(np.linalg.norm(fp[1]) + np.linalg.norm(sp[1]))
            if final_scale == 0 or not np.isfinite(final_scale):
                continue
            rel = original_scale / final_scale
            results[i] = ThreeViewConstraint(views=tuple(views), poses=(se3.scale(fp, rel), se3.scale(sp, rel)))
        return results

    def _prep_three_view(self, reconstruction, views, landmarks):
        """Host preamble of ``optimize_three_view`` (lib.rs:1939-2010):
        ``(first_pose, second_pose, bearings (n, 3, 3), original_scale)`` or
        None when the candidate fails the pre-checks."""
        s = self.settings
        if len(landmarks) < s.optimization_minimum_landmarks:
            return None
        poses = [self.data.pose(reconstruction, v) for v in views]
        first_pose = se3.compose(poses[1], se3.inverse(poses[0]))
        second_pose = se3.compose(poses[2], se3.inverse(poses[0]))
        original_scale = float(np.linalg.norm(first_pose[1]) + np.linalg.norm(second_pose[1]))
        self.rng.shuffle(landmarks)
        landmarks.sort(key=lambda lm: -len(self.data.landmark(reconstruction, lm).observations))
        opti = []
        for lm in landmarks[: s.optimization_maximum_landmarks]:
            obs = self.data.landmark(reconstruction, lm).observations
            opti.append([self.data.view_frame(reconstruction, v).bearings[obs[v]] for v in views])
        arr = np.asarray(opti)
        thresh = s.robust_view_bearing_pair_minimum_cosine_distance
        diffs = 1.0 - np.einsum("imk,jmk->ijm", arr, arr)
        pair_ok = np.all(diffs > thresh, axis=-1)
        if int(np.sum(np.triu(pair_ok, 1))) < s.robust_view_num_robust_bearing_pair:
            return None
        return first_pose, second_pose, arr, original_scale

    def optimize_three_view(self, reconstruction, views, landmarks):
        """(lib.rs:1939-2062)"""
        return self._optimize_three_view_chunk(reconstruction, [(views, landmarks)])[0]

    # -- reconstruction merging (lib.rs:1817-1887, 2116-2193) -----------------------
    def try_merge_reconstructions(self, src_reconstruction, src_view, dest_reconstruction, dest_view_matches):
        """Register the frame of ``src_view`` in ``dest_reconstruction`` and,
        when its constraints hold, move the whole source reconstruction
        over (lib.rs:1817-1887).  Returns ``dest_reconstruction`` or None."""
        self._flush_pending()
        frame = self.data.view(src_reconstruction, src_view).frame
        src_pose = self.data.view(src_reconstruction, src_view).pose
        result = self.register_frame(dest_reconstruction, frame, dest_view_matches)
        if result is None:
            return None
        dest_pose, matches = result
        dest_view = self.data.add_view(dest_reconstruction, frame, dest_pose, lambda f: matches.get(f))
        if not self.record_view_constraints(dest_reconstruction, dest_view):
            self.data.remove_view(dest_reconstruction, dest_view)
            self.data.frames[frame].view = (src_reconstruction, src_view)
            return None
        dest_pose = self.data.view(dest_reconstruction, dest_view).pose
        src_landmarks = self.data.view(src_reconstruction, src_view).landmarks
        landmark_map = {src_landmarks[f]: lms[0] for f, lms in matches.items()}
        del self.data.reconstructions[src_reconstruction].views[src_view]
        # WorldToWorld from the frame's pose in both (pose.rs:322-324).
        world_transform = se3.compose(se3.inverse(dest_pose), src_pose)
        self.incorporate_reconstruction(src_reconstruction, dest_reconstruction, world_transform, landmark_map)
        return dest_reconstruction

    def incorporate_reconstruction(self, src_reconstruction, dest_reconstruction, world_transform, landmark_map):
        """Move every view of ``src_reconstruction`` into
        ``dest_reconstruction`` through ``world_transform``, mapping source
        landmarks by ``landmark_map`` (extended as new ones are made), then
        delete the source (lib.rs:2116-2193)."""
        dest_to_src = se3.inverse(world_transform)
        rec = self.data.reconstructions[dest_reconstruction]
        dest_views = []
        for src_view in list(self.data.reconstructions[src_reconstruction].views):
            frame = self.data.view(src_reconstruction, src_view).frame
            pose = se3.compose(self.data.view(src_reconstruction, src_view).pose, dest_to_src)
            dest_view = rec.views.insert(View(frame=frame, pose=pose, landmarks=[]))
            dest_views.append(dest_view)
            self.data.frames[frame].view = (dest_reconstruction, dest_view)
            for feature in range(len(self.data.frames[frame])):
                src_landmark = self.data.observation_landmark(src_reconstruction, src_view, feature)
                if src_landmark in landmark_map:
                    dest_landmark = landmark_map[src_landmark]
                    self.data.landmark(dest_reconstruction, dest_landmark).observations[dest_view] = feature
                else:
                    dest_landmark = self.data.add_landmark(dest_reconstruction, dest_view, feature)
                    landmark_map[src_landmark] = dest_landmark
                rec.views[dest_view].landmarks.append(dest_landmark)
        for view in dest_views:
            if not self.record_view_constraints(dest_reconstruction, view):
                self.data.remove_view(dest_reconstruction, view)
        del self.data.reconstructions[src_reconstruction]

    # -- bundle adjustment (lib.rs:2343-2435) ----------------------------------------
    def optimize_reconstruction(self, reconstruction):
        self._flush_pending()
        use_batch = self.triangulator is host_geom.triangulate_observations
        if use_batch and self.settings.async_optimize and self.settings.reconstruction_optimization_iterations == 1:
            # Async path: enqueue the BA+filter pass now, finish it at the
            # next engine entry.  Correct by the flush discipline: every
            # reader/mutator of reconstruction state flushes first.
            pending = self._dispatch_ba_filter(reconstruction)
            if pending is None:
                return None
            self._pending_opt = pending
            return reconstruction
        for _ in range(self.settings.reconstruction_optimization_iterations):
            if use_batch:
                # BA + observation filter as one device pass; the exact host
                # filter runs only when BA removed a view.
                r = self._apply_constraints_and_filter_device(reconstruction)
                if r is None:
                    return None
                if r is True:
                    continue
            elif self.apply_constraints(reconstruction) is None:
                log.info("failed to bundle adjust reconstruction")
                return None
            if self.filter_non_robust_observations(reconstruction) is None:
                return None
        return reconstruction

    def flush_pending(self):
        """Finalize any in-flight async BA+filter pass; call it before
        reading reconstruction state directly off ``engine.data``."""
        self._flush_pending()

    def _flush_pending(self):
        if self._pending_opt is None:
            return
        pending = self._pending_opt
        self._pending_opt = None
        reconstruction = pending["reconstruction"]
        if reconstruction not in self.data.reconstructions:
            log.info("pending optimize for a removed reconstruction; dropped")
            return
        if self._finish_ba_filter(pending) is False:
            # BA removed views: run the exact host filter.
            self.filter_non_robust_observations(reconstruction)

    def _build_ba_arrays(self, rec, view_keys):
        """Bucket-padded pose + edge arrays for the BA passes; padded views
        have no edges, so the device loop marks them removed."""
        index = {v: i for i, v in enumerate(view_keys)}
        edges = []
        for constraint in rec.constraints.values():
            for to_view, (from_view, pose) in constraint.edge_constraints():
                if to_view in index and from_view in index:
                    edges.append((index[to_view], index[from_view], pose))
        nv = len(view_keys)
        vb = _bucket(nv, minimum=8)
        rot = np.tile(np.eye(3), (vb, 1, 1))
        trans = np.zeros((vb, 3))
        rot[:nv] = np.stack([rec.views[v].pose[0] for v in view_keys])
        trans[:nv] = np.stack([rec.views[v].pose[1] for v in view_keys])
        eb = _bucket(max(len(edges), 1))
        edge_to = np.zeros(eb, np.int64)
        edge_from = np.zeros(eb, np.int64)
        edge_rot = np.tile(np.eye(3), (eb, 1, 1))
        edge_t = np.zeros((eb, 3))
        edge_valid = np.zeros(eb, bool)
        for i, (t, f, pose) in enumerate(edges):
            edge_to[i] = t
            edge_from[i] = f
            edge_rot[i] = pose[0]
            edge_t[i] = pose[1]
            edge_valid[i] = True
        return index, (rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid)

    def _apply_ba_result(self, reconstruction, rec, view_keys, removed, out_rot, out_trans):
        """Write back BA poses and remove non-finite views (lib.rs:2358-2375);
        None when the reconstruction dies."""
        out_rot = np.asarray(out_rot, np.float64)
        out_trans = np.asarray(out_trans, np.float64)
        updated = 0
        for i, v in enumerate(view_keys):
            if removed[i]:
                continue
            rec.views[v].pose = (out_rot[i], out_trans[i])
            updated += 1
        if updated < 3:
            self.data.remove_reconstruction(reconstruction)
            return None
        for i, v in enumerate(view_keys):
            if removed[i] and v in rec.views:
                log.info("removing view from reconstruction")
                self.data.remove_view(reconstruction, v)
        return reconstruction

    def graph_ba_device(self, arrays):
        """Graph bundle adjustment over ``_build_ba_arrays`` output on the
        engine's device; returns host ``(rot, trans, removed)``."""
        rot, trans, removed = graph_ba_device(
            *(self._tensor(a) for a in arrays),
            iterations=self.settings.optimization_iterations,
            rate=self.settings.graph_optimization_rate,
        )
        return _fetch(rot, trans, removed)

    def apply_constraints(self, reconstruction):
        rec = self.data.reconstructions[reconstruction]
        view_keys = list(rec.views)
        if not view_keys:
            self.data.remove_reconstruction(reconstruction)
            return None
        _, arrays = self._build_ba_arrays(rec, view_keys)
        out_rot, out_trans, removed = self.graph_ba_device(arrays)
        return self._apply_ba_result(reconstruction, rec, view_keys, removed, out_rot, out_trans)

    def _apply_constraints_and_filter_device(self, reconstruction):
        """``apply_constraints`` + ``filter_non_robust_observations`` as one
        device pass (:func:`device_refine.ba_filter`).  Returns None (the
        reconstruction died), True (done) or False (BA removed views; the
        caller runs the exact host filter)."""
        pending = self._dispatch_ba_filter(reconstruction)
        if pending is None:
            return None
        return self._finish_ba_filter(pending)

    def _dispatch_ba_filter(self, reconstruction):
        """Build the snapshot arrays and enqueue the BA+filter pass; returns
        the record for :meth:`_finish_ba_filter` (None if the reconstruction
        was empty and removed)."""
        s = self.settings
        data = self.data
        rec = data.reconstructions[reconstruction]
        view_keys = list(rec.views)
        if not view_keys:
            data.remove_reconstruction(reconstruction)
            return None
        index, arrays = self._build_ba_arrays(rec, view_keys)
        landmarks = [lm for lm in rec.landmarks if len(rec.landmarks[lm].observations) >= 2]
        _, view_bearings = batch_geom.view_caches(data, reconstruction)
        obs_lists = [list(rec.landmarks[lm].observations.items()) for lm in landmarks]
        n = len(landmarks)
        lb = _bucket(max(n, 1))
        vi, bear_n, mask_n, views_h, feats_h = batch_geom.pack_observation_indices(obs_lists, index, view_bearings)
        o = vi.shape[1]
        ob = _bucket(max(o, 2), minimum=4)
        lm_view = np.zeros((lb, ob), np.int64)
        lm_bear = np.zeros((lb, ob, 3))
        lm_bear[:, :, 2] = 1.0
        lm_mask = np.zeros((lb, ob), bool)
        lm_valid = np.zeros(lb, bool)
        lm_view[:n, :o] = vi
        lm_bear[:n, :o] = bear_n
        lm_mask[:n, :o] = mask_n
        lm_valid[:n] = True
        out = device_refine.ba_filter(
            *(self._tensor(a) for a in arrays),
            self._tensor(lm_view), self._tensor(lm_bear), self._tensor(lm_mask), self._tensor(lm_valid),
            s.maximum_sine_distance,
            s.maximum_cosine_distance,
            s.robust_observation_incidence_minimum_cosine_distance,
            min(s.robust_minimum_observations, len(view_keys)),
            iterations=s.optimization_iterations,
            rate=s.graph_optimization_rate,
        )
        return {
            "reconstruction": reconstruction,
            "rec": rec,
            "view_keys": view_keys,
            "landmarks": landmarks,
            "views_h": views_h,
            "feats_h": feats_h,
            "n": n,
            "out": out,
        }

    def _finish_ba_filter(self, pending):
        """Copy back and apply a :meth:`_dispatch_ba_filter` record; same
        return contract as :meth:`_apply_constraints_and_filter_device`."""
        s = self.settings
        data = self.data
        reconstruction = pending["reconstruction"]
        view_keys = pending["view_keys"]
        landmarks = pending["landmarks"]
        views_h, feats_h, n = pending["views_h"], pending["feats_h"], pending["n"]
        out_rot, out_trans, removed, kill, bad_obs, robust = _fetch(*pending["out"])
        if self._apply_ba_result(reconstruction, pending["rec"], view_keys, removed, out_rot, out_trans) is None:
            log.info("failed to bundle adjust reconstruction")
            return None
        if any(removed[i] for i in range(len(view_keys))):
            return False
        for i in np.nonzero(kill[:n])[0]:
            self.split_landmark(reconstruction, landmarks[int(i)])
        bad_rows, bad_cols = np.nonzero(bad_obs[:n] & ~kill[:n, None])
        for i, j in zip(bad_rows, bad_cols):
            data.split_observation(reconstruction, int(views_h[i, j]), int(feats_h[i, j]))
        robust = int(robust)
        log.info("filtering left %d robust landmarks", robust)
        if robust < s.minimum_robust_landmarks:
            data.remove_reconstruction(reconstruction)
            return None
        return True

    # -- observation filtering (lib.rs:2657-2757) --------------------------------------
    def filter_non_robust_observations(self, reconstruction):
        """Split non-robust observations and drop the reconstruction when too
        few robust landmarks remain (lib.rs:2657-2757)."""
        if self.triangulator is host_geom.triangulate_observations:
            return self._filter_non_robust_observations_batched(reconstruction)
        return self._filter_non_robust_observations_scalar(reconstruction)

    def _filter_non_robust_observations_batched(self, reconstruction):
        s = self.settings
        data = self.data
        rec = data.reconstructions[reconstruction]
        landmarks = [lm for lm in rec.landmarks if len(rec.landmarks[lm].observations) >= 2]
        if landmarks:
            rot, trans, bear, mask, views, feats = batch_geom.pack_landmarks(data, reconstruction, landmarks)
            n_obs = mask.sum(axis=1)
            two = n_obs == 2
            if np.any(two):
                idx = np.nonzero(two)[0]
                rrel, trel = batch_geom.relative_pose_batch(rot[idx, 0], trans[idx, 0], rot[idx, 1], trans[idx, 1])
                ok = batch_geom.bi_robust_batch(rrel, trel, bear[idx, 0], bear[idx, 1], s.maximum_sine_distance)
                for i, good in zip(idx, ok):
                    if not good:
                        self.split_landmark(reconstruction, landmarks[i])
            many = n_obs >= 3
            if np.any(many):
                idx = np.nonzero(many)[0]
                pts, ok = batch_geom.triangulate_batch(rot[idx], trans[idx], bear[idx], mask[idx])
                cosd = batch_geom.reproject_cosine_batch(rot[idx], trans[idx], bear[idx], mask[idx], pts)
                bad_obs = (cosd > s.maximum_cosine_distance) & mask[idx]
                for row, i in enumerate(idx):
                    if not ok[row]:
                        self.split_landmark(reconstruction, landmarks[i])
                        continue
                    for j in np.nonzero(bad_obs[row])[0]:
                        data.split_observation(reconstruction, int(views[i, j]), int(feats[i, j]))
        robust = int(np.sum(self._robust_mask_batch(reconstruction, list(rec.landmarks))))
        log.info("filtering left %d robust landmarks", robust)
        if robust < s.minimum_robust_landmarks:
            self.data.remove_reconstruction(reconstruction)
            return None
        return reconstruction

    def _observation_lists(self, reconstruction, landmark_lists):
        rec = self.data.reconstructions[reconstruction]
        out = []
        for lms in landmark_lists:
            if isinstance(lms, (list, tuple)):
                out.append([o for lm in lms for o in rec.landmarks[lm].observations.items()])
            else:
                out.append(list(rec.landmarks[lms].observations.items()))
        return out

    def _robust_mask_batch(self, reconstruction, landmark_lists):
        """Batched ``are_observations_robust`` over landmarks (or lists of
        landmarks whose observations merge), lib.rs:2907-2934."""
        if not landmark_lists:
            return np.zeros(0, bool)
        rec = self.data.reconstructions[reconstruction]
        vp, vb = batch_geom.view_caches(self.data, reconstruction)
        rot, trans, bear, mask, _, _ = batch_geom.pack_observations(
            self._observation_lists(reconstruction, landmark_lists), vp, vb
        )
        needed = min(self.settings.robust_minimum_observations, len(rec.views))
        return batch_geom.incidence_robust_batch(
            rot, bear, mask, self.settings.robust_observation_incidence_minimum_cosine_distance, needed
        )

    def _robust_points_batch(self, reconstruction, landmark_lists):
        """Batched ``triangulate_landmark_robust`` /
        ``triangulate_merged_landmark_robust`` (lib.rs:2971-3000): ``(points
        (N, 4), ok (N,))``, ``ok`` meaning robust and triangulated."""
        if not landmark_lists:
            return np.zeros((0, 4)), np.zeros(0, bool)
        rec = self.data.reconstructions[reconstruction]
        vp, vb = batch_geom.view_caches(self.data, reconstruction)
        rot, trans, bear, mask, _, _ = batch_geom.pack_observations(
            self._observation_lists(reconstruction, landmark_lists), vp, vb
        )
        needed = min(self.settings.robust_minimum_observations, len(rec.views))
        robust = batch_geom.incidence_robust_batch(
            rot, bear, mask, self.settings.robust_observation_incidence_minimum_cosine_distance, needed
        )
        pts, tri_ok = batch_geom.triangulate_batch(rot, trans, bear, mask)
        return pts, robust & tri_ok

    def _filter_non_robust_observations_scalar(self, reconstruction):
        rec = self.data.reconstructions[reconstruction]
        for landmark in list(rec.landmarks):
            obs = self.data.landmark_observations(reconstruction, landmark)
            if len(obs) <= 1:
                continue
            if len(obs) == 2:
                (v1, f1), (v2, f2) = obs
                p1 = self.data.pose(reconstruction, v1)
                b1 = self.data.observation_bearing(reconstruction, v1, f1)
                p2 = self.data.pose(reconstruction, v2)
                b2 = self.data.observation_bearing(reconstruction, v2, f2)
                total = se3.compose(p2, se3.inverse(p1))
                if not self.is_bi_landmark_robust(total, b1, b2, self.settings.maximum_sine_distance):
                    self.split_landmark(reconstruction, landmark)
            else:
                point = self.triangulate_landmark(reconstruction, landmark)
                if point is None:
                    self.split_landmark(reconstruction, landmark)
                    continue
                for view, feature in obs:
                    pose = self.data.pose(reconstruction, view)
                    bearing = self.data.observation_bearing(reconstruction, view, feature)
                    if 1.0 - float(host_geom.transform_bearing(pose, point) @ bearing) > self.settings.maximum_cosine_distance:
                        self.data.split_observation(reconstruction, view, feature)
        robust = sum(1 for lm in rec.landmarks if self.is_landmark_robust(reconstruction, lm))
        log.info("filtering left %d robust landmarks", robust)
        if robust < self.settings.minimum_robust_landmarks:
            self.data.remove_reconstruction(reconstruction)
            return None
        return reconstruction

    def split_landmark(self, reconstruction, landmark):
        obs = self.data.landmark_observations(reconstruction, landmark)
        for view, feature in obs[1:]:
            self.data.split_observation(reconstruction, view, feature)

    def regenerate_reconstruction(self, reconstruction):
        """Clear and regenerate every view's constraints, then re-optimize
        (lib.rs:2417-2435).  The pending BA pass is finished first, so the
        constraints are generated from its poses."""
        self._flush_pending()
        rec = self.data.reconstructions[reconstruction]
        rec.constraints.clear()
        for view in list(rec.views):
            self.record_view_constraints(reconstruction, view)
        return self.optimize_reconstruction(reconstruction)

    # -- sanity check (lib.rs:3060-3094) -----------------------------------------------
    def sanity_check(self, reconstruction) -> list:
        """Invariant audit of view<->landmark backreferences; returns the
        violations (the reference logs them as errors)."""
        self._flush_pending()
        problems = []
        rec = self.data.reconstructions[reconstruction]
        for view_key, view in rec.views.items():
            if len(view.landmarks) != len(self.data.frames[view.frame]):
                problems.append(
                    f"view {view_key}: {len(view.landmarks)} landmark refs vs "
                    f"{len(self.data.frames[view.frame])} features"
                )
            for feature, lm in enumerate(view.landmarks):
                if lm not in rec.landmarks:
                    problems.append(f"view {view_key} feature {feature}: dangling landmark {lm}")
                    continue
                obs = rec.landmarks[lm].observations
                if obs.get(view_key) != feature:
                    problems.append(
                        f"view {view_key} feature {feature}: landmark {lm} observation backref is {obs.get(view_key)}"
                    )
        for lm_key, lm in rec.landmarks.items():
            if not lm.observations:
                problems.append(f"landmark {lm_key} has zero observations")
            for view_key, feature in lm.observations.items():
                if view_key not in rec.views:
                    problems.append(f"landmark {lm_key}: dangling view {view_key}")
                elif rec.views[view_key].landmarks[feature] != lm_key:
                    problems.append(
                        f"landmark {lm_key}: view {view_key} feature {feature} points to "
                        f"{rec.views[view_key].landmarks[feature]}"
                    )
        for p in problems:
            log.error("sanity: %s", p)
        return problems

    # -- normalization + export (lib.rs:2241-2340) ----------------------------------------
    def normalize_reconstruction(self, reconstruction):
        """Move the first view to the origin and scale the reconstruction
        so that the first view's robust landmarks lie at a mean distance of
        1."""
        self._flush_pending()
        rec = self.data.reconstructions[reconstruction]
        if not rec.views:
            return
        first_view = next(iter(rec.views.values()))
        distances = []
        for landmark in first_view.landmarks:
            point = self.triangulate_landmark_robust(reconstruction, landmark)
            p = host_geom.point_of(point) if point is not None else None
            if p is None:
                continue
            cam = se3.apply(first_view.pose, p)
            distances.append(float(np.linalg.norm(cam)))
        if not distances:
            return
        mean_distance = float(np.mean(distances))
        if not np.isfinite(mean_distance) or mean_distance <= 0:
            return
        rescale = 1.0 / mean_distance
        transform = se3.inverse(first_view.pose)
        for view in rec.views.values():
            r, t = se3.compose(view.pose, transform)
            view.pose = (r, t * rescale)
        for constraint in rec.constraints.values():
            constraint.poses = tuple((r, t * rescale) for r, t in constraint.poses)

    def export_reconstruction(self, reconstruction, path, camera_faces: bool = True):
        """Write the reconstruction's robust landmarks (colored by their
        first observation) and its cameras as an ASCII PLY file."""
        from .export import export_ply

        self._flush_pending()
        rec = self.data.reconstructions[reconstruction]
        points, colors = [], []
        for landmark in rec.landmarks:
            hp = self.triangulate_landmark_robust(reconstruction, landmark)
            p = host_geom.point_of(hp) if hp is not None else None
            if p is None:
                continue
            view, feature = next(iter(self.data.landmark(reconstruction, landmark).observations.items()))
            points.append(p)
            colors.append(self.data.observation_color(reconstruction, view, feature))
        cameras = []
        for view in rec.views.values():
            c2w = se3.inverse(view.pose)
            cameras.append(
                dict(
                    optical_center=se3.apply(c2w, np.zeros(3)),
                    up_direction=se3.rotate(c2w, np.array([0.0, -1.0, 0.0])),
                    forward_direction=se3.rotate(c2w, np.array([0.0, 0.0, 1.0])),
                    focal_length=0.05,
                )
            )
        export_ply(path, points, colors, cameras, camera_faces)
