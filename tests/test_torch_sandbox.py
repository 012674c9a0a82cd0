"""The vslam-sandbox path of cv_tpu_torch on the CPU: frame sources, the PNG
writer, the prefetch loader and the app, against cv_tpu where it has one.

* Sources: ``ImageSequenceSource`` on the KITTI pair (a glob and an explicit
  order) gives cv_tpu.video's frames bitwise; ``VideoFileSource`` on a GIF
  gives cv_tpu's frames; ``_to_gray_u8`` equals cv_tpu's.
* PNG: ``write_png`` -> ``read_png`` round-trips every filter type (each
  forced on every row, and libpng's per-row choice) in grayscale and RGB,
  and PIL reads the files as written; the compiled unfilter
  (``csrc/png_unfilter.cu``) is held to the plain walk on the card only.
* Loader: ``PrefetchLoader.get`` returns ``load_gray``'s frames in any order.
* The app: ``vslam_sandbox.main(..., device="cpu")`` on ``FRAMES`` rendered
  frames (``APP_RENDER``) with a settings file that shrinks only the
  engine's budgets (``APP_SETTINGS``): run 1 maps the first frames, writes a
  PLY file per new reconstruction (vertices = robust landmarks + 5 a
  camera) and ``vslam.cvr``, which cv_tpu's ``VSlamData.load`` reads with
  every array equal; run 2 resumes from the checkpoint and keeps run 1's
  frames and reconstructions.
* ``pose_spread`` (not a test; run the file as a script): the app's engine
  set-up in both packages, each with its default (exact) extractor, against
  the rendered poses over three seeds, on which chip_smoke's
  ``SANDBOX_POSE_GATES`` rest.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import cv_tpu.video as ref_video
from cv_tpu.sfm import VSlamData as RefVSlamData
from cv_tpu_torch import video
from cv_tpu_torch.akaze import load_gray
from cv_tpu_torch.apps import vslam_sandbox
from cv_tpu_torch.apps.synth import render_sequence
from cv_tpu_torch.ops import eigen
from cv_tpu_torch.sfm import se3
from cv_tpu_torch.utils import fixture_path, kitti_pair, read_png
from cv_tpu_torch.utils.loader import PrefetchLoader, load_gray_compiled
from cv_tpu_torch.utils.png import _filtered, unfilter, unfilter_plain, write_png

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# The app's run on the CPU: small frames of the star field, the engine's
# budgets cut by the settings file (its thresholds as they are) and the
# app's consensus budgets divided by CONSENSUS_CUT (16,384 / 8,192
# hypotheses would take minutes a call on a CPU core).
FRAMES = (4, 2)
CONSENSUS_CUT = 64
APP_RENDER = dict(height=384, width=512, n_points=700, seed=0, fx=416.0, fy=416.0)
APP_SETTINGS = dict(tracking_features=1024, single_view_patience=500, three_view_patience=500,
                    two_view_patience=500, constraint_patience=200, optimization_iterations=64)


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


def test_image_sequence_glob_matches_cv_tpu():
    pattern = os.path.join(os.path.dirname(fixture_path("0000000000.png")), "*.png")
    src, ref = video.ImageSequenceSource(pattern), ref_video.ImageSequenceSource(pattern)
    assert len(src) == len(ref) == 2 and src.paths == ref.paths
    for got, want in zip(src, ref, strict=True):
        assert got.dtype == np.uint8 and got.shape == (512, 1392)
        np.testing.assert_array_equal(got, want)


def test_image_sequence_keeps_order():
    paths = list(reversed(kitti_pair()))
    src = video.ImageSequenceSource(paths)
    assert [p.name for p in src.paths] == ["0000000014.png", "0000000000.png"]
    for got, want in zip(src, ref_video.ImageSequenceSource(paths), strict=True):
        np.testing.assert_array_equal(got, want)


def test_video_file_source_matches_cv_tpu(tmp_path):
    iio = pytest.importorskip("imageio.v3")
    rng = np.random.default_rng(0)
    path = tmp_path / "clip.gif"
    iio.imwrite(path, rng.integers(0, 255, (6, 32, 48, 3), dtype=np.uint8), duration=100)
    got = list(video.VideoFileSource(path, step=2, limit=2))
    want = list(ref_video.VideoFileSource(path, step=2, limit=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (32, 48)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32])
def test_to_gray_matches_cv_tpu(dtype):
    rng = np.random.default_rng(1)
    top = 255 if dtype == np.uint8 else 60000
    for shape in ((5, 7), (5, 7, 3), (5, 7, 4)):
        frame = rng.integers(0, top, shape).astype(dtype)
        np.testing.assert_array_equal(video._to_gray_u8(frame), ref_video._to_gray_u8(frame))


def test_camera_source_missing_device_raises():
    pytest.importorskip("cv2")
    with pytest.raises(RuntimeError, match="camera"):
        video.CameraSource(device=99).open()


@pytest.mark.parametrize("channels", [1, 3], ids=["gray", "rgb"])
@pytest.mark.parametrize("filters", [None, 0, 1, 2, 3, 4], ids=["libpng", "none", "sub", "up", "average", "paeth"])
def test_write_png_round_trips(tmp_path, channels, filters):
    rng = np.random.default_rng(2)
    shape = (23, 31) if channels == 1 else (23, 31, 3)
    # Smooth ramps with noise: every filter wins some rows of libpng's choice.
    ramp = np.add.outer(np.arange(23), np.arange(31)) * 4
    img = ((ramp if channels == 1 else ramp[..., None] * [1, 2, 3]) + rng.integers(0, 9, shape)) % 256
    img = img.astype(np.uint8)
    path = tmp_path / "img.png"
    used = write_png(path, img, filters)
    assert used.shape == (23,) and ((used == filters).all() if filters is not None else True)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_write_png_chooses_filters_per_row(tmp_path):
    img = render_sequence(n_frames=1, height=96, width=128, n_points=60, seed=1)[0][0]
    used = write_png(tmp_path / "frame.png", img)
    assert {0, 3, 4} <= set(used.tolist())  # flat rows take None; blob rows Average or Paeth
    raw = read_png(tmp_path / "frame.png")
    np.testing.assert_array_equal(raw, img)


def test_unfilter_plain_on_every_filter():
    """The plain walk undoes the encoder's vectorized filters, every filter
    type on rows of three-byte pixels."""
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, (40, 3 * 9), dtype=np.uint8)
    rows = np.empty((40, 1 + 3 * 9), np.uint8)
    rows[:, 0] = np.arange(40) % 5
    rows[:, 1:] = _filtered(image, 3)[rows[:, 0], np.arange(40)]
    np.testing.assert_array_equal(unfilter_plain(rows, 3), image)
    rows[7, 0] = 5
    with pytest.raises(ValueError, match="filter type 5"):
        unfilter_plain(rows, 3)


@pytest.mark.cuda
def test_compiled_unfilter_matches_plain(tmp_path):
    """The compiled walk of csrc/png_unfilter.cu, bitwise to the plain walk
    on every filter, and the loader's compiled decode equal to load_gray
    (needs nvcc: chip_smoke.py holds it on the card's machine)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: csrc/ is built with nvcc on the card's machine")
    rng = np.random.default_rng(4)
    for bpp in (1, 3):
        rows = rng.integers(0, 256, (64, 1 + bpp * 50), dtype=np.uint8)
        rows[:, 0] = rng.integers(0, 5, 64)
        np.testing.assert_array_equal(unfilter(rows, bpp), unfilter_plain(rows, bpp))
    path = tmp_path / "rgb.png"
    write_png(path, rng.integers(0, 256, (30, 40, 3), dtype=np.uint8))
    np.testing.assert_array_equal(load_gray_compiled(path), load_gray(path))


def test_prefetch_loader_order(tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    for i in range(7):
        paths.append(tmp_path / f"f{i}.png")
        write_png(paths[-1], rng.integers(0, 256, (9 + i, 11), dtype=np.uint8))
    want = [load_gray(p) for p in paths]
    with PrefetchLoader(paths, threads=2) as loader:
        assert len(loader) == 7
        for i in (0, 1, 5, 2, 6, 3, 4, 4):
            np.testing.assert_array_equal(loader.get(i), want[i])
        with pytest.raises(IndexError):
            loader.get(7)


@pytest.fixture(scope="module")
def app_runs(tmp_path_factory):
    """Both runs of the app on the CPU, with chip_smoke.py's hooks: (work
    dir, per run (engine, hooks, checkpoint arrays after the run), the
    consensus budgets the app asked for)."""
    import cv_tpu_torch.consensus as consensus

    work = tmp_path_factory.mktemp("sandbox")
    images, (fx, fy, cx, cy), _ = render_sequence(n_frames=sum(FRAMES), **APP_RENDER)
    paths = []
    for i, img in enumerate(images):
        paths.append(str(work / f"frame-{i:03d}.png"))
        write_png(paths[-1], img)
    (work / "settings.json").write_text(json.dumps(APP_SETTINGS))
    real, asked = consensus.BatchConsensus, []

    def cut(**kw):
        asked.append(dict(kw))
        return real(**dict(kw, hypotheses=kw["hypotheses"] // CONSENSUS_CUT,
                           refit_hypotheses=kw["refit_hypotheses"] // CONSENSUS_CUT))

    runs = []
    consensus.BatchConsensus = cut
    try:
        for run, frames in enumerate((paths[:FRAMES[0]], paths[FRAMES[0]:])):
            out = work / f"out-{run}"
            out.mkdir()
            argv = ["-d", str(work / "vslam.cvr"), "-s", str(work / "settings.json"), "-o", str(out),
                    "--x-focal", repr(fx), "--y-focal", repr(fy), "--x-center", repr(cx), "--y-center", repr(cy),
                    "--radial-distortion", "0", *frames]
            with chip_smoke.sandbox_hooks(torch.device("cpu")) as hooks:
                engine = vslam_sandbox.main(argv, device="cpu")
            engine.data.save(work / f"live-{run}.cvr")
            runs.append((engine, hooks, _arrays_of(work / "vslam.cvr")))
    finally:
        consensus.BatchConsensus = real
    return work, runs, asked


def _arrays_of(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _assert_same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_app_parser_keeps_cv_tpu_flags():
    from cv_tpu.apps import vslam_sandbox as ref_app

    def flags(parser):
        return {(a.dest, tuple(a.option_strings), a.default) for a in parser._actions}

    assert flags(vslam_sandbox.build_parser()) == flags(ref_app.build_parser())


def test_app_asks_for_the_reference_consensus_budgets(app_runs):
    _, _, asked = app_runs
    assert len(asked) == 4  # single- and two-view, in each run
    for kw in asked:
        assert kw["refit_rounds"] == 2 and kw["refit_hypotheses"] == 1024 and kw["device"] == torch.device("cpu")
    assert [kw["hypotheses"] for kw in asked] == [16384, 8192] * 2


def test_app_maps_exports_and_saves(app_runs):
    work, ((engine, hooks, saved), _), _ = app_runs
    recs = engine.data.reconstructions
    assert len(recs) >= 1 and engine.settings.tracking_features == APP_SETTINGS["tracking_features"]
    for key, rec in recs.items():
        assert engine.sanity_check(key) == [] and len(rec.views) >= 3
    new = {key for key, _ in hooks["normalized"]}
    assert new and all(dev < 1e-9 for _, dev in hooks["normalized"])  # the first view at identity
    assert sorted(os.listdir(work / "out-0")) == sorted(f"reconstruction-{k}.ply" for k in new)
    assert hooks["exports"]
    for key, vertices, robust, views in hooks["exports"]:
        assert vertices == robust + 5 * views and robust > 0
    # vslam.cvr holds the final live state, and cv_tpu reads it.
    _assert_same_arrays(saved, _arrays_of(work / "live-0.cvr"))


def test_app_resumes_from_the_checkpoint(app_runs):
    work, ((first, _, _), (second, hooks, saved)), _ = app_runs
    (arrays, devices), = hooks["loaded"]
    _assert_same_arrays(arrays, _arrays_of(work / "live-0.cvr"))
    assert devices == ["cpu"]
    assert len(second.data.frames) == sum(FRAMES) and len(second.data.feeds) == 2
    for key, frame in first.data.frames.items():
        np.testing.assert_array_equal(second.data.frames[key].descriptors, frame.descriptors)
    for key in second.data.reconstructions:
        assert second.sanity_check(key) == []
    _assert_same_arrays(saved, _arrays_of(work / "live-1.cvr"))


def test_app_checkpoint_loads_in_cv_tpu(app_runs, tmp_path):
    work, _, _ = app_runs
    loaded = RefVSlamData.load(work / "vslam.cvr")
    loaded.save(tmp_path / "resaved.cvr")
    _assert_same_arrays(_arrays_of(work / "vslam.cvr"), _arrays_of(tmp_path / "resaved.cvr"))


def test_consensus_scores_in_blocks_as_in_one(monkeypatch):
    """The scoring stage takes its residuals in blocks of hypotheses
    (``SCORE_BLOCK`` pairs; the app's budgets need it on a card): the same
    model, inliers and count as one block."""
    from cv_tpu_torch.consensus import batch
    from cv_tpu_torch.sfm.engine import DEFAULT_ESSENTIAL_ESTIMATOR, DEFAULT_POSE_ESTIMATOR

    rng = np.random.default_rng(6)
    points = rng.uniform([-3, -2, 6], [3, 2, 10], (200, 3))
    rot, trans = se3.so3_exp(np.array([0.0, 0.05, 0.01])), np.array([-0.5, 0.02, 0.1])
    cam = points @ rot.T + trans
    a = points / np.linalg.norm(points, axis=1, keepdims=True)
    b = cam / np.linalg.norm(cam, axis=1, keepdims=True)
    b[::5] = np.roll(b[::5], 1, axis=0)
    cases = ((DEFAULT_ESSENTIAL_ESTIMATOR, (torch.tensor(a), torch.tensor(b))),
             (DEFAULT_POSE_ESTIMATOR, (torch.tensor(b), torch.tensor(np.c_[points, np.ones(len(points))]))))
    for estimator, data in cases:
        outs = []
        for block in (1 << 40, 8000):
            monkeypatch.setattr(batch, "SCORE_BLOCK", block)
            consensus = batch.BatchConsensus(threshold=1e-6, hypotheses=32, refit_rounds=2, refit_hypotheses=12,
                                             device="cpu")
            outs.append(consensus.model_inliers(torch.Generator().manual_seed(0), estimator, data, n_valid=190))
        (m0, mask0, c0), (m1, mask1, c1) = outs
        assert torch.equal(mask0, mask1) and int(c0) == int(c1) >= 100
        assert torch.equal(m0.rotation, m1.rotation) and torch.equal(m0.translation, m1.translation)


def pose_spread(seeds=(0, 1, 2), n_frames=8):
    """Not a test: the poses of the app's engine set-up against the rendered
    ones in both packages, per engine seed.  ``n_frames`` ``APP_RENDER``
    frames, ``APP_SETTINGS``, the app's consensus budgets divided by
    ``CONSENSUS_CUT``; each engine takes its package's default extractor,
    the exact ``AkazeExtractor``.  Returns ``{(package, seed): (views, landmarks, ATE / extent, worst
    consecutive rotation in degrees)}`` of the reconstruction.  Run
    ``PYTHONPATH=. python tests/test_torch_sandbox.py`` (CPU, ~20 min)."""
    from cv_tpu.camera import CameraIntrinsics as RefIntrinsics
    from cv_tpu.camera import CameraIntrinsicsK1Distortion as RefK1
    from cv_tpu.consensus import BatchConsensus as RefConsensus
    from cv_tpu.sfm import VSlam as RefVSlam
    from cv_tpu.sfm import VSlamSettings as RefSettings
    from cv_tpu_torch.camera import CameraIntrinsics, CameraIntrinsicsK1Distortion
    from cv_tpu_torch.consensus import BatchConsensus
    from cv_tpu_torch.sfm import VSlam, VSlamSettings

    images, (fx, fy, cx, cy), true_poses = render_sequence(n_frames=n_frames, **APP_RENDER)
    packages = {
        "port": (VSlam, VSlamSettings, BatchConsensus, dict(device="cpu"),
                 CameraIntrinsicsK1Distortion.new(CameraIntrinsics.from_values(fx, fy, cx, cy, device="cpu"), 0.0)),
        "cv_tpu": (RefVSlam, RefSettings, RefConsensus, {},
                   RefK1.new(RefIntrinsics.from_values(fx, fy, cx, cy), 0.0)),
    }
    out = {}
    for name, (engine_cls, settings_cls, consensus_cls, dev, intrinsics) in packages.items():
        settings = settings_cls(**APP_SETTINGS)
        for seed in seeds:
            consensus = {
                f"{kind}_consensus": consensus_cls(threshold=getattr(settings, f"{kind}_consensus_threshold"),
                                                   hypotheses=budget // CONSENSUS_CUT, refit_rounds=2,
                                                   refit_hypotheses=1024 // CONSENSUS_CUT, **dev)
                for kind, budget in (("single_view", 16384), ("two_view", 8192))}
            engine = engine_cls(settings=settings, seed=seed, **consensus, **dev)
            feed = engine.add_feed(intrinsics)
            for image in images:
                engine.add_frame(feed, image)
            engine.flush_pending()
            rec = max(engine.data.reconstructions.values(), key=lambda r: len(r.views))
            est = {engine.data.frames[v.frame].feed_frame: tuple(np.asarray(x, np.float64) for x in v.pose)
                   for v in rec.views.values()}
            out[(name, seed)] = (len(rec.views), len(rec.landmarks), *chip_smoke.trajectory_errors(est, true_poses))
            print(name, seed, out[(name, seed)], flush=True)
    return out


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    pose_spread()
