"""cv_tpu_torch's SfM engine on the CPU (the kernels' plain versions) against
cv_tpu's, on the 5-camera bearing scene of tests/test_sfm.py.

Both engines see the same scene and settings (test_sfm's ``test_settings``,
crossed over by JSON).  They draw different random minimal sets (a
``torch.Generator`` is not a JAX key), so their landmark structures differ
in detail; the gates are the reference's own: one reconstruction holding
all five views, relative poses within test_sfm.py's bounds, and counts of
landmarks with three or more observations within 10% of each other
(measured: equal, 400 and 400).  Async optimize on and off must leave the
port in an identical final state.

One module-scoped fixture builds the three engines: 215 s on one core
with ``CV_TPU_TEST_CACHE_DIR`` set to an empty directory (a cold JAX
compile cache), about 75 s of it per port run.
"""

import dataclasses

import numpy as np
import pytest

from cv_tpu.sfm import VSlam as RefVSlam
from cv_tpu.sfm import VSlamSettings as RefSettings
from cv_tpu.sfm.data import Feed as RefFeed
from cv_tpu_torch.ops import eigen
from cv_tpu_torch.sfm import VSlam, VSlamSettings, se3
from cv_tpu_torch.sfm.data import Feed
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)

N_CAMERAS = 5


def make_scene(rng, n_landmarks=400, n_cameras=N_CAMERAS):
    """tests/test_sfm.py's scene: random landmarks, a smooth trajectory,
    exact unique descriptors; per camera (pose, bearings)."""
    points = rng.uniform([-4, -3, 6], [4, 3, 14], (n_landmarks, 3))
    descriptors = rng.integers(0, 2**32, (n_landmarks, 16), dtype=np.uint64).astype(np.uint32)
    descriptors[:, -1] &= np.uint32((1 << (486 - 15 * 32)) - 1)
    poses = []
    for i in range(n_cameras):
        r = se3.so3_exp(np.array([0.0, 0.03 * i, 0.01 * i]))
        poses.append((r, -r @ np.array([0.4 * i, 0.05 * i, 0.3 * i])))
    frames = []
    for pose in poses:
        cam = se3.apply(pose, points)
        frames.append(cam / np.linalg.norm(cam, axis=-1, keepdims=True))
    return points, descriptors, poses, frames


REF_SETTINGS = RefSettings(
    two_view_minimum_robust_matches=128,
    three_view_patience=2000,
    single_view_patience=2000,
    constraint_patience=500,
    optimization_iterations=128,
    tracking_recent_frames=8,
)


def _run(engine, feed_cls, scene):
    _, descriptors, _, frames = scene
    feed = engine.data.feeds.insert(feed_cls(intrinsics=None, frames=[]))
    n = len(descriptors)
    for bearings in frames:
        frame = engine.data.add_frame_features(
            feed, descriptors, bearings, np.linspace(1.0, 0.5, n, dtype=np.float32), np.zeros((n, 3), np.uint8)
        )
        rec_frames, free_frames = engine.data.find_visually_similar_and_recent_frames(
            frame, 0, engine.settings.tracking_recent_frames, 0, 512
        )
        engine.try_localize(frame, rec_frames, free_frames)
    engine.flush_pending()
    return engine


@pytest.fixture(autouse=True, scope="module")
def _cheap_consensus():
    """On a CPU the exact forms of this module's consensus runs and solver
    batches cost tens of times the cheap ones (``scripts/cpu_costs.py``):
    the module opts into the cheap CPU forms (``ops.eigen.cheap_on_cpu``,
    within a few ulps of cv_tpu's bits), which every CPU caller took before
    the exact forms became the default."""
    with eigen.cheap_on_cpu():
        yield


@pytest.fixture(scope="module")
def engines():
    scene = make_scene(np.random.default_rng(42))
    settings = VSlamSettings.from_json(REF_SETTINGS.to_json())
    ref = _run(RefVSlam(settings=REF_SETTINGS, seed=7), RefFeed, scene)
    port = _run(VSlam(settings=settings, seed=7, device="cpu"), Feed, scene)
    port_sync = _run(VSlam(settings=settings.replace(async_optimize=False), seed=7, device="cpu"), Feed, scene)
    return scene, ref, port, port_sync


def test_settings_round_trip():
    port = VSlamSettings.from_json(REF_SETTINGS.to_json())
    assert dataclasses.asdict(port) == dataclasses.asdict(REF_SETTINGS)
    assert RefSettings.from_json(port.to_json()) == REF_SETTINGS


def _view_poses(engine):
    rec = next(iter(engine.data.reconstructions.values()))
    return {engine.data.frames[v.frame].feed_frame: v.pose for v in rec.views.values()}


def _robust_landmarks(engine):
    rec = next(iter(engine.data.reconstructions.values()))
    return sum(1 for lm in rec.landmarks.values() if len(lm.observations) >= 3)


def test_one_reconstruction_with_all_views(engines):
    _, ref, port, _ = engines
    for engine in (ref, port):
        assert len(engine.data.reconstructions) == 1
        assert len(_view_poses(engine)) == N_CAMERAS
    assert port.sanity_check(next(iter(port.data.reconstructions))) == []


@pytest.mark.parametrize("pair", [(0, 1), (0, 2), (1, 3), (2, 4)])
def test_relative_poses_match_ground_truth(engines, pair):
    """test_sfm.py:86-101's bounds: rotation error < 1e-2 rad, unit
    translation direction within 5e-2, for the port and for cv_tpu."""
    scene, ref, port, _ = engines
    poses = scene[2]
    i, j = pair
    true_rel = se3.compose(poses[j], se3.inverse(poses[i]))
    for engine in (port, ref):
        vp = _view_poses(engine)
        est_rel = se3.compose(vp[j], se3.inverse(vp[i]))
        rot_err = np.linalg.norm(se3.so3_log(est_rel[0].T @ true_rel[0]))
        assert rot_err < 1e-2, rot_err
        t_est = est_rel[1] / np.linalg.norm(est_rel[1])
        t_true = true_rel[1] / np.linalg.norm(true_rel[1])
        assert np.linalg.norm(t_est - t_true) < 5e-2


def test_landmark_counts_close_to_cv_tpu(engines):
    _, ref, port, _ = engines
    a, b = _robust_landmarks(port), _robust_landmarks(ref)
    assert b > 0 and abs(a - b) <= 0.1 * b, (a, b)


def test_async_and_sync_identical(engines):
    """The flush discipline makes the deferred BA+filter path leave exactly
    the state of the synchronous path."""
    _, _, a, b = engines
    assert list(a.data.reconstructions) == list(b.data.reconstructions)
    for key in a.data.reconstructions:
        ra, rb = a.data.reconstructions[key], b.data.reconstructions[key]
        assert list(ra.views) == list(rb.views)
        for v in ra.views:
            assert ra.views[v].landmarks == rb.views[v].landmarks
            np.testing.assert_array_equal(ra.views[v].pose[0], rb.views[v].pose[0])
            np.testing.assert_array_equal(ra.views[v].pose[1], rb.views[v].pose[1])
        assert {k: lm.observations for k, lm in ra.landmarks.items()} == {
            k: lm.observations for k, lm in rb.landmarks.items()
        }


def test_pending_pass_that_removes_the_reconstruction_returns_none(engines):
    """With async optimize on, a deferred BA+filter pass that removes the
    reconstruction must make the next ``incorporate_frame`` return None,
    as the synchronous path does (cv_tpu raises KeyError there).  It
    removes the port engine's reconstruction, so it stays the file's last
    test."""
    _, _, port, _ = engines
    rec = next(iter(port.data.reconstructions))
    frame = next(iter(port.data.reconstructions[rec].views.values())).frame
    view_matches = list(port.data.reconstructions[rec].views)
    strict = port.settings
    port.settings = strict.replace(minimum_robust_landmarks=10**9)
    try:
        assert port.optimize_reconstruction(rec) == rec  # dispatched, pending
        assert port._pending_opt is not None
        assert port.incorporate_frame(rec, frame, view_matches) is None
        assert rec not in port.data.reconstructions
    finally:
        port.settings = strict
