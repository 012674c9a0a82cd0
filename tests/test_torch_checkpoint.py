"""cv_tpu_torch's checkpoints, PLY export and the engine's landmark helpers
against cv_tpu's, on one mapping state built in both packages.

The state (``_build``): five views of 60 points, bearings projected from the
points with every seventh observation of the last three views turned by a
random rotation (0.05 rad a component), a sixth of the later views'
features their own landmarks, two three-view constraints from the true
relative poses, one split observation, a second reconstruction whose second
view was removed again (so its key counters run ahead of its maps), and
three feeds (K1, plain pinhole, bearings only).  Both packages build it from the
same NumPy arrays through the same calls.

* Checkpoints: a ``.cvr`` saved by cv_tpu loads in the port and one saved by
  the port loads in cv_tpu; every array of a re-save is equal (key counters
  and sketches included), and equal to the other package's save.  A file
  that is not an npz raises in the port; a checkpoint loads on the device
  named (the CPU here; the default is the card), and an engine refuses a
  camera model on another device.
* Export: ``export_ply`` and ``export_reconstruction`` write equal bytes.
* Helpers: ``observation_loss`` on every observation within 1e-12;
  ``merge_landmarks_dedup`` (tests/test_sfm.py:217-308's cases) with the
  same splits and the same merged key; both ``*_without_view`` helpers;
  ``normalize_reconstruction`` (poses within 1e-12, the first view at
  identity); ``regenerate_reconstruction`` (the same constraints' views,
  their poses within ``REGEN_TOL``, the views' poses after graph BA within
  ``REGEN_TOL``).
"""

import copy

import numpy as np
import pytest
import torch

import cv_tpu.camera as ref_camera
from cv_tpu.sfm import VSlam as RefVSlam
from cv_tpu.sfm import VSlamSettings as RefSettings
from cv_tpu.sfm import data as ref_data
from cv_tpu.sfm.export import export_ply as ref_export_ply
import cv_tpu_torch.camera as port_camera
from cv_tpu_torch.ops import eigen
from cv_tpu_torch.sfm import VSlam, VSlamSettings, se3
from cv_tpu_torch.sfm import data as port_data
from cv_tpu_torch.sfm.export import export_ply

N_POINTS = 60
N_VIEWS = 5
INTRINSICS = (893.39010814, 898.32648616, 951.1310043, 555.13350077, 0.0, -0.28052513)
# Small budgets for the graph BA and the three-view optimizations, the same
# in both engines.
SETTINGS = dict(optimization_iterations=64, constraint_patience=200, minimum_robust_landmarks=16)
# regenerate_reconstruction: cv_tpu optimizes the three-view problems and the
# graph in XLA, the port in torch, each in float64, in other summation
# orders; measured max |difference| 6.1e-15 (the 30 constraints' poses) and
# 1.2e-15 (the views' poses after graph BA).
REGEN_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _cheap_consensus():
    """On a CPU the exact forms of this module's consensus runs and solver
    batches cost tens of times the cheap ones (``scripts/cpu_costs.py``):
    the module opts into the cheap CPU forms (``ops.eigen.cheap_on_cpu``,
    within a few ulps of cv_tpu's bits), which every CPU caller took before
    the exact forms became the default."""
    with eigen.cheap_on_cpu():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of small tensor ops,
    which stall when several test processes' thread pools share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pose(i):
    r = se3.so3_exp(np.array([0.01 * i, 0.04 * i, 0.015 * i]))
    return r, -r @ np.array([0.45 * i, 0.06 * i, 0.25 * i])


def _arrays(seed=11):
    """Points, per view (pose, bearings), descriptors, colors."""
    rng = np.random.default_rng(seed)
    points = rng.uniform([-3, -2, 7], [3, 2, 11], (N_POINTS, 3))
    views = []
    for i in range(N_VIEWS):
        pose = _pose(i)
        cam = se3.apply(pose, points)
        bearings = cam / np.linalg.norm(cam, axis=1, keepdims=True)
        if i >= 2:
            turn = se3.so3_exp(rng.normal(0.0, 0.05, 3))
            bearings[::7] = bearings[::7] @ turn.T
        views.append((pose, bearings))
    descriptors = [rng.integers(0, 2**32, (N_POINTS, 16), dtype=np.uint64).astype(np.uint32) for _ in views]
    colors = [rng.integers(0, 256, (N_POINTS, 3), dtype=np.uint8) for _ in views]
    return points, views, descriptors, colors


def _intrinsics(cam, **kw):
    fx, fy, cx, cy, skew, k1 = INTRINSICS
    si = cam.CameraIntrinsics.from_values(fx, fy, cx, cy, skew=skew, **kw)
    return cam.CameraIntrinsicsK1Distortion.new(si, k1), si


def _build(mod, cam, **kw):
    """The mapping state in package ``mod``'s data model (``cam`` its camera
    module); returns (data, main reconstruction key)."""
    _, views, descriptors, colors = _arrays()
    data = mod.VSlamData()
    k1, plain = _intrinsics(cam, **kw)
    feed = data.feeds.insert(mod.Feed(intrinsics=k1, frames=[]))
    other = data.feeds.insert(mod.Feed(intrinsics=plain, frames=[]))
    data.feeds.insert(mod.Feed(intrinsics=None, frames=[]))
    responses = np.linspace(1.0, 0.5, N_POINTS, dtype=np.float32)
    frames = [data.add_frame_features(feed, d, b, responses, c) for (_, b), d, c in zip(views, descriptors, colors)]
    rec = data.reconstructions.insert(mod.Reconstruction())
    first = data.add_view(rec, frames[0], views[0][0], lambda f: None)
    shared = data.view(rec, first).landmarks
    view_keys = [first]
    for i in range(1, N_VIEWS):
        view_keys.append(
            data.add_view(rec, frames[i], views[i][0], lambda f, i=i: shared[f] if (f + i) % 6 else None))
    for a, b, c in ((0, 1, 2), (1, 2, 3)):
        pa = views[a][0]
        data.reconstructions[rec].constraints.insert(mod.ThreeViewConstraint(
            views=(view_keys[a], view_keys[b], view_keys[c]),
            poses=(se3.compose(views[b][0], se3.inverse(pa)), se3.compose(views[c][0], se3.inverse(pa)))))
    data.split_observation(rec, view_keys[3], 5)
    # A second reconstruction on two frames of the other feed, its second
    # view removed again: its key counters run ahead of its maps.
    rec2 = data.reconstructions.insert(mod.Reconstruction())
    extra = [data.add_frame_features(other, descriptors[j][:8], views[j][1][:8], responses[:8], colors[j][:8])
             for j in (0, 1)]
    first2 = data.add_view(rec2, extra[0], _pose(7), lambda f: None)
    shared2 = data.view(rec2, first2).landmarks
    data.remove_view(rec2, data.add_view(rec2, extra[1], _pose(8), lambda f: shared2[f] if f % 2 == 0 else None))
    return data, rec


def _engines(ref_data_, port_data_):
    ref = RefVSlam(data=ref_data_, settings=RefSettings(**SETTINGS), seed=0)
    port = VSlam(data=port_data_, settings=VSlamSettings(**SETTINGS), seed=0, device="cpu")
    return ref, port


@pytest.fixture
def states():
    (ref, rec), (port, rec_p) = _build(ref_data, ref_camera), _build(port_data, port_camera, device="cpu")
    assert rec == rec_p
    return ref, port, rec


def _arrays_of(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _assert_same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_saves_are_equal_in_both_packages(states, tmp_path):
    ref, port, _ = states
    ref.save(tmp_path / "ref.cvr")
    port.save(tmp_path / "port.cvr")
    _assert_same_arrays(_arrays_of(tmp_path / "ref.cvr"), _arrays_of(tmp_path / "port.cvr"))
    arrays = _arrays_of(tmp_path / "port.cvr")
    assert arrays["rec_counters"][1].tolist() == [2, 12, 0] and len(port.reconstructions[1].landmarks) == 8
    assert arrays["feed_kind"].tolist() == [0, 1, 2]
    assert (arrays["frame_view"][-1] == -1).all()


@pytest.mark.parametrize("writer", ["cv_tpu", "port"])
def test_checkpoint_cross_loads(states, tmp_path, writer):
    """A checkpoint written by one package loads in the other; a re-save
    from there has every array of the original."""
    ref, port, _ = states
    src = tmp_path / "vslam.cvr"
    if writer == "cv_tpu":
        ref.save(src)
        loaded = port_data.VSlamData.load(src, device="cpu")
        fx, fy, cx, cy, skew, k1 = INTRINSICS
        intr = loaded.feeds[0].intrinsics
        assert type(intr) is port_camera.CameraIntrinsicsK1Distortion and intr.k1.device.type == "cpu"
        assert intr.simple_intrinsics.focals.tolist() == [fx, fy] and float(intr.k1) == k1
        assert type(loaded.feeds[1].intrinsics) is port_camera.CameraIntrinsics
        assert loaded.feeds[2].intrinsics is None
    else:
        port.save(src)
        loaded = ref_data.VSlamData.load(src)
        assert type(loaded.feeds[0].intrinsics) is ref_camera.CameraIntrinsicsK1Distortion
    loaded.save(tmp_path / "resaved.cvr")
    _assert_same_arrays(_arrays_of(src), _arrays_of(tmp_path / "resaved.cvr"))


def test_load_rehashes_sketches(states, tmp_path):
    _, port, _ = states
    path = tmp_path / "vslam.cvr"
    stale = copy.deepcopy(port)
    for frame in stale.frames.values():
        frame.sketch = np.zeros_like(frame.sketch)
    stale.save(path)
    loaded = port_data.VSlamData.load(path, device="cpu")
    for key, frame in loaded.frames.items():
        np.testing.assert_array_equal(frame.sketch, port.frames[key].sketch)
    assert loaded.sketch_frames == port.sketch_frames
    assert [s.tolist() for s in loaded.frame_sketches] == [s.tolist() for s in port.frame_sketches]


def test_non_npz_checkpoint_raises(states, tmp_path):
    import pickle

    _, port, _ = states
    path = tmp_path / "legacy.cvr"
    with open(path, "wb") as f:
        pickle.dump({"frames": len(port.frames)}, f)
    with pytest.raises(ValueError, match="npz"):
        port_data.VSlamData.load(path, device="cpu")


def test_checkpoint_loads_on_the_card_by_default(states, tmp_path):
    _, port, _ = states
    port.save(tmp_path / "vslam.cvr")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default load would run on it")
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        port_data.VSlamData.load(tmp_path / "vslam.cvr")


def test_engine_refuses_intrinsics_on_another_device(states):
    _, port, _ = states
    meta, _ = _intrinsics(port_camera, device="meta")
    with pytest.raises(ValueError, match="device"):
        VSlam(data=port, device="cpu").add_feed(meta)
    port.feeds[0].intrinsics = meta
    with pytest.raises(ValueError, match="device"):
        VSlam(data=port, device="cpu")


def test_export_ply_bytes_equal(tmp_path):
    rng = np.random.default_rng(3)
    points = rng.normal(0.0, 3.0, (25, 3))
    colors = rng.integers(0, 256, (25, 3), dtype=np.uint8)
    cameras = [dict(optical_center=rng.normal(size=3), up_direction=rng.normal(size=3),
                    forward_direction=rng.normal(size=3), focal_length=0.05) for _ in range(3)]
    for faces in (True, False):
        ref_export_ply(tmp_path / "ref.ply", points, colors, cameras, faces)
        export_ply(tmp_path / "port.ply", points, colors, cameras, faces)
        assert (tmp_path / "ref.ply").read_bytes() == (tmp_path / "port.ply").read_bytes()


@pytest.mark.parametrize("faces", [True, False], ids=["faces", "no_faces"])
def test_export_reconstruction_bytes_equal(states, tmp_path, faces):
    ref, port, rec = _engines(*states[:2]) + (states[2],)
    ref.export_reconstruction(rec, tmp_path / "ref.ply", camera_faces=faces)
    port.export_reconstruction(rec, tmp_path / "port.ply", camera_faces=faces)
    text = (tmp_path / "port.ply").read_bytes()
    assert text == (tmp_path / "ref.ply").read_bytes()
    n_vertices = int(text.split(b"element vertex ")[1].split(b"\n")[0])
    robust = sum(port.triangulate_landmark_robust(rec, lm) is not None for lm in port.data.reconstructions[rec].landmarks)
    assert n_vertices == robust + 5 * N_VIEWS and robust > N_POINTS // 2


def test_observation_loss_matches_cv_tpu(states):
    ref, port, rec = _engines(*states[:2]) + (states[2],)
    losses = []
    for view_key, view in port.data.reconstructions[rec].views.items():
        for feature in range(len(view.landmarks)):
            a = port.observation_loss(rec, view_key, feature)
            b = ref.observation_loss(rec, view_key, feature)
            assert abs(a - b) <= 1e-12, (view_key, feature, a, b)
            losses.append(a)
    losses = np.asarray(losses)
    # Singletons score 2.0, exact observations ~0, the turned ones between.
    assert (losses == 2.0).any() and (losses < 1e-9).sum() > len(losses) // 2
    assert ((losses > 1e-6) & (losses < 2.0)).any()


def _snapshot(data, rec):
    r = data.reconstructions[rec]
    return ({k: list(v.landmarks) for k, v in r.views.items()},
            {k: dict(lm.observations) for k, lm in r.landmarks.items()}, r.landmarks._next)


def _shared_view_landmarks(data, rec, min_obs=2):
    """Two landmarks with at least ``min_obs`` observations that share a view."""
    by_view = {}
    for key, lm in data.reconstructions[rec].landmarks.items():
        if len(lm.observations) >= min_obs:
            for view in lm.observations:
                by_view.setdefault(view, []).append(key)
    view, lms = next((v, lms) for v, lms in by_view.items() if len(lms) >= 2)
    return view, lms[0], lms[1]


def _singleton_in_view(data, rec, view):
    return next(k for k, lm in data.reconstructions[rec].landmarks.items() if list(lm.observations) == [view])


def _mergeable_shared_pair(engine, rec):
    """Two multi-observation landmarks that share views and whose dedup
    merge succeeds (tried on a copy)."""
    lms = [k for k, lm in engine.data.reconstructions[rec].landmarks.items() if len(lm.observations) >= 2]
    for a in lms:
        for b in lms:
            if a != b:
                trial = copy.deepcopy(engine)
                if trial.merge_landmarks_dedup(rec, a, b) is not None:
                    return a, b
    raise AssertionError("no mergeable pair of landmarks sharing views")


@pytest.mark.parametrize("case", ["shared_views", "would_empty", "disjoint"])
def test_merge_landmarks_dedup_matches_cv_tpu(states, case):
    ref, port, rec = _engines(*states[:2]) + (states[2],)
    data = port.data
    landmarks = data.reconstructions[rec].landmarks
    if case == "shared_views":
        a, b = _mergeable_shared_pair(port, rec)
    elif case == "would_empty":
        # A singleton against a landmark seen in its view: the singleton's
        # observation scores 2.0, is the worse one, and cannot be split off.
        a = _singleton_in_view(data, rec, 1)
        b = next(k for k, lm in landmarks.items() if len(lm.observations) >= 2 and 1 in lm.observations)
    else:
        a = _singleton_in_view(data, rec, 1)
        b = next(k for k, lm in landmarks.items() if len(lm.observations) >= 2 and 1 not in lm.observations)
    before = _snapshot(data, rec)
    got, want = port.merge_landmarks_dedup(rec, a, b), ref.merge_landmarks_dedup(rec, a, b)
    assert got == want
    assert _snapshot(port.data, rec) == _snapshot(ref.data, rec)
    obs_a, obs_b = before[1][a], before[1][b]
    dups = [v for v in obs_a if v in obs_b]
    if case == "would_empty":
        assert got is None and b in landmarks and dups == [1]
    else:
        assert got == a and b not in landmarks
        obs = data.reconstructions[rec].landmarks[a].observations
        for v in dups:
            # Each shared view keeps one of its two observations; the other
            # is split into a singleton landmark.
            assert obs[v] in (obs_a[v], obs_b[v])
            worse = obs_b[v] if obs[v] == obs_a[v] else obs_a[v]
            split = data.reconstructions[rec].views[v].landmarks[worse]
            assert split != a and data.reconstructions[rec].landmarks[split].observations == {v: worse}
        assert len(obs) + len(dups) == len(obs_a) + len(obs_b)
        assert (len(dups) > 0) == (case == "shared_views")
    assert port.sanity_check(rec) == []


def test_plain_merge_rejects_a_shared_view(states):
    _, port, rec = states
    _, a, b = _shared_view_landmarks(port, rec)
    with pytest.raises(ValueError, match="merge_landmarks_dedup"):
        port.merge_landmarks(rec, a, b)
    assert hasattr(VSlam, "merge_landmarks_dedup")


def test_without_view_helpers_match_cv_tpu(states):
    ref, port, rec = _engines(*states[:2]) + (states[2],)
    checked = robust = 0
    for lm_key, lm in port.data.reconstructions[rec].landmarks.items():
        for view in list(lm.observations) + [10**6]:
            a = port.is_landmark_robust_without_view(rec, lm_key, view)
            assert a == ref.is_landmark_robust_without_view(rec, lm_key, view)
            p = port.triangulate_landmark_robust_without_view(rec, lm_key, view)
            q = ref.triangulate_landmark_robust_without_view(rec, lm_key, view)
            assert (p is None) == (q is None)
            if not a:
                assert p is None
            if p is not None:
                np.testing.assert_allclose(p, q, atol=1e-12, rtol=0)
                robust += 1
            checked += 1
    assert robust > N_POINTS and checked > robust


def test_normalize_reconstruction_matches_cv_tpu(states):
    ref, port, rec = _engines(*states[:2]) + (states[2],)
    port.normalize_reconstruction(rec)
    ref.normalize_reconstruction(rec)
    views = port.data.reconstructions[rec].views
    first = next(iter(views.values()))
    assert np.allclose(first.pose[0], np.eye(3), atol=1e-9) and np.allclose(first.pose[1], 0.0, atol=1e-9)
    for key, view in views.items():
        want = ref.data.reconstructions[rec].views[key].pose
        np.testing.assert_allclose(view.pose[0], want[0], atol=1e-12, rtol=0)
        np.testing.assert_allclose(view.pose[1], want[1], atol=1e-12, rtol=0)
    for key, con in port.data.reconstructions[rec].constraints.items():
        want = ref.data.reconstructions[rec].constraints[key].poses
        for (r, t), (wr, wt) in zip(con.poses, want):
            np.testing.assert_allclose(r, wr, atol=1e-12, rtol=0)
            np.testing.assert_allclose(t, wt, atol=1e-12, rtol=0)


def test_regenerate_reconstruction_matches_cv_tpu(states):
    ref, port, rec = _engines(*states[:2]) + (states[2],)
    assert port.regenerate_reconstruction(rec) == ref.regenerate_reconstruction(rec) == rec
    port.flush_pending()
    ref.flush_pending()
    got, want = port.data.reconstructions[rec], ref.data.reconstructions[rec]
    assert [c.views for c in got.constraints.values()] == [c.views for c in want.constraints.values()]
    assert list(got.constraints) == list(want.constraints) and len(got.constraints) >= 2
    for key, con in got.constraints.items():
        for (r, t), (wr, wt) in zip(con.poses, want.constraints[key].poses):
            np.testing.assert_allclose(r, wr, atol=REGEN_TOL, rtol=0)
            np.testing.assert_allclose(t, wt, atol=REGEN_TOL, rtol=0)
    assert list(got.views) == list(want.views)
    for key, view in got.views.items():
        np.testing.assert_allclose(view.pose[0], want.views[key].pose[0], atol=REGEN_TOL, rtol=0)
        np.testing.assert_allclose(view.pose[1], want.views[key].pose[1], atol=REGEN_TOL, rtol=0)
    assert _snapshot(port.data, rec)[1] == _snapshot(ref.data, rec)[1]
    assert port.sanity_check(rec) == []
