"""cv_tpu_torch.parallel: data-parallel extraction and hypothesis-sharded
consensus must give the unsharded answers bitwise, as tests/test_parallel.py
holds cv_tpu's on its 8-device CPU mesh.  Here a mesh is a tuple of
devices: one CPU device, and the same device named twice and three times
(the split-and-join path on one device).  The extractor's batch is split
into contiguous shares; the consensus draws its minimal sets once on its
own device, each mesh device solves and scores a contiguous share of the
hypotheses, a multiple of 64 (prescore and refit rounds included; 128 and
96 hypotheses split 64 + 64 and 64 + 32), and the selection runs on the
consensus's device.  The extraction setting is cv_tpu's test's
(threshold 1e-4, 32 candidates an evolution, 64 features, 96x128 frames);
its counts are held to cv_tpu's sharded run too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.akaze import Akaze as JAkaze
from cv_tpu.akaze.fast import DeviceExtractor as JDeviceExtractor
from cv_tpu.parallel import make_mesh as j_make_mesh
from cv_tpu.parallel import sharded_extract as j_sharded_extract
from cv_tpu_torch.akaze import Akaze, DeviceExtractor
from cv_tpu_torch.consensus import BatchConsensus, Estimator
from cv_tpu_torch.core import Isometry3, camera_to_camera_residual, lie, projective
from cv_tpu_torch.ops import eigen
from cv_tpu_torch.parallel import make_mesh, sharded_consensus, sharded_extract
from cv_tpu_torch.solvers import eight_point
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


CPU = torch.device("cpu")
MESHES = {"one device": (CPU,), "one device twice": (CPU, CPU), "one device three times": (CPU, CPU, CPU)}


def _images(b=8):
    return np.random.default_rng(0).random((b, 96, 128)).astype(np.float32)


@pytest.mark.parametrize("mesh", ["one device", "one device twice"])
def test_sharded_extract_matches_single_device(mesh):
    ex = DeviceExtractor(Akaze(detector_threshold=0.0001), candidate_budget=32, max_features=64, device="cpu")
    images = torch.as_tensor(_images())
    ref = ex.extract(images)
    out = sharded_extract(ex, images, MESHES[mesh])
    for name in ref.__dataclass_fields__:
        a, b = getattr(out, name), getattr(ref, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert ex.device == CPU  # the caller's extractor is left as it was


def test_sharded_extract_counts_match_cv_tpu_s_sharded_run():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    images = _images()
    jex = JDeviceExtractor(JAkaze(detector_threshold=0.0001), candidate_budget=32, max_features=64)
    ref = j_sharded_extract(jex, jnp.asarray(images), j_make_mesh(8))
    ex = DeviceExtractor(Akaze(detector_threshold=0.0001), candidate_budget=32, max_features=64, device="cpu")
    out = sharded_extract(ex, torch.as_tensor(images), MESHES["one device twice"])
    np.testing.assert_array_equal(out.count.numpy(), np.asarray(ref.count))


def test_sharded_extract_rejects_an_uneven_batch():
    ex = DeviceExtractor(Akaze(detector_threshold=0.0001), candidate_budget=32, max_features=64, device="cpu")
    with pytest.raises(ValueError):
        sharded_extract(ex, torch.as_tensor(_images(3)), MESHES["one device twice"])


def _consensus_problem(seed=0, n=64):
    rng = np.random.default_rng(seed)
    pose = Isometry3(rotation=lie.so3_exp(torch.tensor([0.05, -0.1, 0.04], dtype=torch.float64)),
                     translation=torch.tensor([0.3, -0.1, 0.05], dtype=torch.float64))
    pts = torch.tensor(rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3)))
    a_h = projective.from_point(pts)
    b = projective.bearing(pose.transform(a_h))
    b[: n // 8] = b[: n // 8].flip(0)  # some outliers
    est = Estimator(
        min_samples=8,
        models_per_sample=4,
        estimate=lambda s: eight_point.estimate(s[0], s[1]),
        residual=lambda m, d: camera_to_camera_residual(
            Isometry3(rotation=m.rotation[..., None, :, :], translation=m.translation[..., None, :]), d[0], d[1]),
    )
    return (projective.bearing(a_h), b), est


@pytest.fixture(scope="module")
def unsharded():
    """Per prescore setting: the consensus, its problem and the unsharded
    answer."""
    data, est = _consensus_problem()
    out = {}
    for prescore in (0, 24):
        cons = BatchConsensus(threshold=1e-4, hypotheses=128, refit_rounds=1, refit_hypotheses=96,
                              prescore_matches=prescore, prescore_keep=96, device="cpu")
        out[prescore] = (cons, data, est, cons.model_inliers(torch.Generator().manual_seed(3), est, data, n_valid=60))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("prescore", [0, 24])
def test_sharded_consensus_matches_unsharded(unsharded, mesh, prescore):
    cons, data, est, ref = unsharded[prescore]
    scons = sharded_consensus(cons, MESHES[mesh])
    assert scons.hypothesis_sharding == MESHES[mesh] and cons.hypothesis_sharding is None
    got = scons.model_inliers(torch.Generator().manual_seed(3), est, data, n_valid=60)
    assert int(got[2]) == int(ref[2]) > 40
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0].rotation, ref[0].rotation) and torch.equal(got[0].translation, ref[0].translation)


def test_make_mesh_takes_the_visible_cuda_devices():
    if torch.cuda.is_available():
        mesh = make_mesh()
        assert mesh == tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
        with pytest.raises(ValueError):
            make_mesh(torch.cuda.device_count() + 1)
    else:
        with pytest.raises(RuntimeError):
            make_mesh()
