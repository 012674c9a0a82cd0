"""The port's main path on the KITTI fixtures, on the CPU: the reference's
golden gates (akaze/tests/estimate_pose.rs) through cv_tpu_torch alone —
399/343 keypoints at full resolution, 11 Lowes-ratio matches, and 11
eight-point consensus inliers in float64."""

import numpy as np
import pytest
import torch

from cv_tpu_torch.akaze import Akaze, DeviceExtractor, load_gray, to_gray_f32
from cv_tpu_torch.camera import CameraIntrinsics
from cv_tpu_torch.consensus import BatchConsensus, Estimator
from cv_tpu_torch.core import Isometry3, camera_to_camera_residual
from cv_tpu_torch.matching import PAD_DISTANCE, distance_matrix, knn2, lowes_ratio_matches
from cv_tpu_torch.ops import eigen
from cv_tpu_torch.solvers import eight_point
from cv_tpu_torch.utils import KITTI_INTRINSICS, kitti_pair
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)


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
def kitti_features():
    images = np.stack([to_gray_f32(load_gray(p)) for p in kitti_pair()])
    extractor = DeviceExtractor(Akaze.sparse(), candidate_budget=256, max_features=512, device="cpu")
    return extractor.extract(images)


@pytest.fixture(scope="module")
def kitti_matches(kitti_features):
    fs = kitti_features
    d = distance_matrix(fs.words[0], fs.words[1])
    d = torch.where(fs.valid[0][:, None] & fs.valid[1][None, :], d, PAD_DISTANCE)
    idx, dd = knn2(d)
    keep = (dd[:, 0].float() < dd[:, 1].float() * 0.5) & fs.valid[0]
    ia = torch.nonzero(keep)[:, 0]
    return ia, idx[ia, 0]


def test_keypoint_counts(kitti_features):
    assert kitti_features.count.tolist() == [399, 343]


def test_features_well_formed(kitti_features):
    fs = kitti_features
    assert tuple(fs.words.shape) == (2, 512, 16) and fs.words.dtype == torch.int32
    v = fs.valid
    assert torch.isfinite(fs.point[v]).all() and torch.isfinite(fs.angle[v]).all()
    assert ((fs.angle[v] >= 0) & (fs.angle[v] < 2 * np.pi)).all()
    # sorted by response, strongest first, as the reference truncates
    r = fs.response[0][fs.valid[0]]
    assert (r[:-1] >= r[1:]).all()


def test_eleven_matches(kitti_features, kitti_matches):
    ia, _ = kitti_matches
    assert len(ia) == 11
    # the same through lowes_ratio_matches on the valid rows
    fs = kitti_features
    b_idx, keep = lowes_ratio_matches(fs.words[0][fs.valid[0]], fs.words[1][fs.valid[1]])
    assert int(keep.sum()) == 11


def test_eleven_inliers(kitti_features, kitti_matches):
    fs = kitti_features
    ia, ib = kitti_matches
    intr = CameraIntrinsics.from_values(*KITTI_INTRINSICS)
    a = intr.calibrate(fs.point[0][ia].double())
    b = intr.calibrate(fs.point[1][ib].double())
    est = Estimator(
        min_samples=8,
        models_per_sample=4,
        estimate=lambda s: eight_point.estimate(s[0], s[1]),
        residual=lambda m, d: camera_to_camera_residual(
            Isometry3(m.rotation[..., None, :, :], m.translation[..., None, :]), d[0], d[1]
        ),
    )
    g = torch.Generator().manual_seed(42)
    model, mask, count = BatchConsensus(threshold=0.1, hypotheses=512, device="cpu").model_inliers(g, est, (a, b))
    assert int(count) == 11 and bool(mask.all())
    rot = model.rotation
    torch.testing.assert_close(rot @ rot.T, torch.eye(3, dtype=torch.float64), atol=1e-6, rtol=0)
