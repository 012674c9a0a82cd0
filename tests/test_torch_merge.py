"""Reconstruction merging in cv_tpu_torch's SfM engine against cv_tpu's.

* Bookkeeping: one mapping state with two reconstructions, built in both
  packages from the same NumPy arrays; ``incorporate_reconstruction`` with
  ``record_view_constraints`` patched (every view accepted, or one
  rejected) leaves the same views (frames, poses within 1e-12, landmark
  lists) and the same landmarks' observations in both.
* The scenario of tests/test_sfm.py:465-501 through both engines with that
  file's settings, the patience loops cut to 250 steps and the consensus
  to ``CONSENSUS``'s budgets: feed A sees cameras 0-2, feed B cameras 4-6 (two
  reconstructions), camera 3 bridges them and the cascade merges them.  Each
  engine ends with one reconstruction of 7 views, the relative rotation of
  cameras 0 and 6 (across the seam) within 5e-2 rad of the truth, and counts
  of landmarks with three or more observations within 10% of each other
  (measured: 400 and 400); the port's ``sanity_check`` is empty.
* cv_tpu's ``try_localize`` reads the view counts of both reconstructions
  before it finishes a pending BA+filter pass (cv_tpu/sfm/engine.py:404-410),
  which can remove one of them.  The port finishes the pass first: with a
  pending pass that removes the frame's reconstruction, or the one it
  matched, ``try_localize`` neither raises nor attempts a merge on the
  stale counts.

The scenario fixture runs both engines once (module scope): ~1.6 min on one
core with JAX's compile cache warm, ~3.2 min cold, a little over half of it
cv_tpu's run.
"""

import numpy as np
import pytest

from cv_tpu.consensus import BatchConsensus as RefConsensus
from cv_tpu.sfm import VSlam as RefVSlam
from cv_tpu.sfm import VSlamSettings as RefSettings
from cv_tpu.sfm import data as ref_data
from cv_tpu_torch.consensus import BatchConsensus
from cv_tpu_torch.ops import eigen
from cv_tpu_torch.sfm import VSlam, VSlamSettings, se3
from cv_tpu_torch.sfm import data as port_data
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)

REF_SETTINGS = RefSettings(
    two_view_minimum_robust_matches=128,
    three_view_patience=250,
    single_view_patience=250,
    constraint_patience=500,
    optimization_iterations=128,
    tracking_recent_frames=8,
)
PORT_SETTINGS = VSlamSettings.from_json(REF_SETTINGS.to_json())
# The scenario's consensus budgets, the same in both engines (their defaults
# draw 2048 / 1024 hypotheses and score 512 in full).  The bearings are
# exact, so these find the same models; the defaults' consensus was most of
# the fixture's time.
CONSENSUS = dict(hypotheses=256, refit_rounds=1, refit_hypotheses=128, prescore_matches=64, prescore_keep=64)


def _consensus(cls, settings, **kw):
    """Both engines' consensus roles at ``CONSENSUS``."""
    return dict(two_view_consensus=cls(threshold=settings.two_view_consensus_threshold, **CONSENSUS, **kw),
                single_view_consensus=cls(threshold=settings.single_view_consensus_threshold, **CONSENSUS, **kw))


def _pose(rng):
    return se3.so3_exp(rng.normal(0.0, 0.3, 3)), rng.normal(0.0, 1.0, 3)


def _state_arrays(seed=3, n_frames=6, n_features=24):
    """Per frame (descriptors, bearings), per view a pose, and the
    reconstructions' layout: views 0-2 in the first, 3-5 in the second."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n_frames):
        desc = rng.integers(0, 2**32, (n_features, 16), dtype=np.uint64).astype(np.uint32)
        bear = rng.normal(0.0, 1.0, (n_features, 3)) + np.array([0.0, 0.0, 3.0])
        frames.append((desc, bear / np.linalg.norm(bear, axis=1, keepdims=True)))
    poses = [_pose(rng) for _ in range(n_frames)]
    return frames, poses, _pose(rng)


def _build(mod, frames, poses):
    """The two-reconstruction state in package ``mod``'s data model; returns
    (data, src, dest).  A view after the first shares every feature whose
    index is not a multiple of 3 with the reconstruction's first view."""
    data = mod.VSlamData()
    feed = data.feeds.insert(mod.Feed(intrinsics=None, frames=[]))
    n = len(frames[0][0])
    keys = [data.add_frame_features(feed, d, b, np.linspace(1.0, 0.5, n, dtype=np.float32), np.zeros((n, 3), np.uint8))
            for d, b in frames]
    recs = []
    for views in ((0, 1, 2), (3, 4, 5)):
        rec = data.reconstructions.insert(mod.Reconstruction())
        first = data.add_view(rec, keys[views[0]], poses[views[0]], lambda f: None)
        shared = data.view(rec, first).landmarks
        for v in views[1:]:
            data.add_view(rec, keys[v], poses[v], lambda f: shared[f] if f % 3 else None)
        recs.append(rec)
    return data, recs[0], recs[1]


def _snapshot(data, rec_key):
    rec = data.reconstructions[rec_key]
    views = {k: (v.frame, v.pose, list(v.landmarks)) for k, v in rec.views.items()}
    return views, {k: dict(lm.observations) for k, lm in rec.landmarks.items()}


@pytest.fixture(autouse=True, scope="module")
def _cheap_consensus():
    """On a CPU the exact forms of this module's consensus runs and solver
    batches cost tens of times the cheap ones (``scripts/cpu_costs.py``):
    the module opts into the cheap CPU forms (``ops.eigen.cheap_on_cpu``,
    within a few ulps of cv_tpu's bits), which every CPU caller took before
    the exact forms became the default."""
    with eigen.cheap_on_cpu():
        yield


@pytest.mark.parametrize("reject", [None, 1], ids=["all_accepted", "second_view_rejected"])
def test_incorporate_reconstruction_bookkeeping(monkeypatch, reject):
    frames, poses, world = _state_arrays()
    out = []
    for engine_cls, mod, kw in ((RefVSlam, ref_data, {}), (VSlam, port_data, {"device": "cpu"})):
        data, src, dest = _build(mod, frames, poses)
        engine = engine_cls(data=data, **kw)
        seen = []

        def record(reconstruction, view, _seen=seen):
            _seen.append(view)
            return reject is None or len(_seen) != reject + 1

        monkeypatch.setattr(engine, "record_view_constraints", record)
        src_lms = data.view(src, next(iter(data.reconstructions[src].views))).landmarks
        dest_lms = data.view(dest, next(iter(data.reconstructions[dest].views))).landmarks
        landmark_map = {src_lms[f]: dest_lms[f] for f in range(0, len(src_lms), 2)}
        engine.incorporate_reconstruction(src, dest, world, landmark_map)
        assert src not in data.reconstructions and len(seen) == 3
        out.append((data, dest))
    (ref, ref_dest), (port, port_dest) = out
    ref_views, ref_lms = _snapshot(ref, ref_dest)
    port_views, port_lms = _snapshot(port, port_dest)
    assert list(port_views) == list(ref_views) and len(port_views) == (6 if reject is None else 5)
    for k, (frame, pose, lms) in port_views.items():
        rf, rp, rl = ref_views[k]
        assert frame == rf and lms == rl
        np.testing.assert_allclose(pose[0], rp[0], atol=1e-12, rtol=0)
        np.testing.assert_allclose(pose[1], rp[1], atol=1e-12, rtol=0)
        assert port.frames[frame].view == (port_dest, k) and ref.frames[frame].view == (ref_dest, k)
    assert port_lms == ref_lms
    assert VSlam(data=port, device="cpu").sanity_check(port_dest) == []


def _scene(rng, n_landmarks=400, n_cameras=7):
    """tests/test_sfm.py's scene (make_scene)."""
    points = rng.uniform([-4, -3, 6], [4, 3, 14], (n_landmarks, 3))
    descriptors = rng.integers(0, 2**32, (n_landmarks, 16), dtype=np.uint64).astype(np.uint32)
    descriptors[:, -1] &= np.uint32((1 << (486 - 15 * 32)) - 1)
    poses = []
    for i in range(n_cameras):
        r = se3.so3_exp(np.array([0.0, 0.03 * i, 0.01 * i]))
        poses.append((r, -r @ np.array([0.4 * i, 0.05 * i, 0.3 * i])))
    frames = [se3.apply(p, points) for p in poses]
    return descriptors, poses, [f / np.linalg.norm(f, axis=-1, keepdims=True) for f in frames]


def _merge_scenario(engine, feed_cls, scene):
    """tests/test_sfm.py:465-482: returns (engine, feed A, feed B, the
    number of reconstructions before the bridge frame)."""
    descriptors, _, frames = scene
    feed_a = engine.data.feeds.insert(feed_cls(intrinsics=None, frames=[]))
    feed_b = engine.data.feeds.insert(feed_cls(intrinsics=None, frames=[]))
    n = len(descriptors)

    def add(feed, bearings, similar=0):
        frame = engine.data.add_frame_features(
            feed, descriptors, bearings, np.linspace(1.0, 0.5, n, dtype=np.float32), np.zeros((n, 3), np.uint8))
        rec_frames, free = engine.data.find_visually_similar_and_recent_frames(
            frame, similar, engine.settings.tracking_recent_frames,
            engine.settings.tracking_similar_frame_recent_threshold, engine.settings.tracking_similar_frame_search_num)
        engine.try_localize(frame, rec_frames, free)

    for i in range(3):
        add(feed_a, frames[i])
    for i in range(4, 7):
        add(feed_b, frames[i])
    before = len(engine.data.reconstructions)
    add(feed_a, frames[3], similar=6)
    engine.flush_pending()
    return engine, feed_a, feed_b, before


@pytest.fixture(scope="module")
def merged():
    scene = _scene(np.random.default_rng(11))
    ref = _merge_scenario(RefVSlam(settings=REF_SETTINGS, seed=5, **_consensus(RefConsensus, REF_SETTINGS)),
                          ref_data.Feed, scene)
    port = _merge_scenario(
        VSlam(settings=PORT_SETTINGS, seed=5, device="cpu", **_consensus(BatchConsensus, PORT_SETTINGS, device="cpu")),
        port_data.Feed, scene)
    return scene, ref, port


def _only_reconstruction(engine):
    assert len(engine.data.reconstructions) == 1
    key = next(iter(engine.data.reconstructions))
    return key, engine.data.reconstructions[key]


def test_scenario_merges_into_one_reconstruction(merged):
    _, ref, port = merged
    for engine, _, _, before in (ref, port):
        assert before == 2
        _, rec = _only_reconstruction(engine)
        assert len(rec.views) == 7
    key, _ = _only_reconstruction(port[0])
    assert port[0].sanity_check(key) == []


def test_rotation_across_the_seam(merged):
    scene, ref, port = merged
    poses = scene[1]
    want = se3.compose(poses[6], se3.inverse(poses[0]))
    for engine, feed_a, feed_b, _ in (ref, port):
        _, rec = _only_reconstruction(engine)
        by_feed = {}
        for v in rec.views.values():
            f = engine.data.frames[v.frame]
            by_feed[(f.feed, f.feed_frame)] = v.pose
        got = se3.compose(by_feed[(feed_b, 2)], se3.inverse(by_feed[(feed_a, 0)]))  # camera 6 against camera 0
        assert np.linalg.norm(se3.so3_log(got[0] @ want[0].T)) < 5e-2


def test_robust_landmark_counts_close_to_cv_tpu(merged):
    _, ref, port = merged
    counts = [sum(1 for lm in _only_reconstruction(e)[1].landmarks.values() if len(lm.observations) >= 3)
              for e, _, _, _ in (ref, port)]
    assert counts[0] > 0 and abs(counts[1] - counts[0]) <= 0.1 * counts[0], counts


@pytest.mark.parametrize("removed", ["frame_reconstruction", "matched_reconstruction"])
def test_try_localize_finishes_the_pending_pass_first(monkeypatch, removed):
    """A pending BA+filter pass on a reconstruction without constraints
    removes it (every view loses its edges).  try_localize must finish it
    before reading the frame's view or either view count: no KeyError, and
    no merge attempted on counts read before the pass."""
    frames, poses, _ = _state_arrays()
    data, src, dest = _build(port_data, frames, poses)
    engine = VSlam(data=data, settings=VSlamSettings(), device="cpu")
    frame = data.view(src, next(iter(data.reconstructions[src].views))).frame
    calls = {"merge": [], "incorporate": [], "init": []}
    monkeypatch.setattr(engine, "try_merge_reconstructions", lambda *a: calls["merge"].append(a))
    monkeypatch.setattr(engine, "incorporate_frame", lambda *a: calls["incorporate"].append(a))
    monkeypatch.setattr(engine, "try_init", lambda *a: calls["init"].append(a))
    target = src if removed == "frame_reconstruction" else dest
    assert engine.optimize_reconstruction(target) == target and engine._pending_opt is not None
    assert len(data.reconstructions[src].views) == 3 and len(data.reconstructions[dest].views) == 3

    engine.try_localize(frame, {dest: list(data.reconstructions[dest].views)}, [])
    assert target not in data.reconstructions and engine._pending_opt is None
    assert calls["merge"] == []
    if removed == "frame_reconstruction":
        # The frame is free after the pass: the cascade registers it in the
        # matched reconstruction instead.
        assert data.frames[frame].view is None
        assert [a[:2] for a in calls["incorporate"]] == [(dest, frame)]
    else:
        assert data.frames[frame].view[0] == src and calls["incorporate"] == []
