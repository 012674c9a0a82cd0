"""The dense, engine-budget extraction path: the default threshold (0.001)
at 2048 or more features, which takes the group describe.

On a 256x384 crop of a KITTI fixture, cv_tpu_torch's ``DeviceExtractor``
against cv_tpu's on the CPU under test_torch_extract's gates: counts
equal, every point within 1e-3 px of a partner, angles within 1e-4 rad, at
least 99% of word rows bitwise equal and none more than 16 of 486 bits off
(the planes and the orientation sums differ from XLA:CPU in the last
bits).  The port's describe modes against each other: counts, points,
angles and words bitwise equal (their angles' atan2, cos and sin,
``cv_tpu_torch.ops.trig``, give an element the same bits at any place in
any batch).

The full KITTI pair at this configuration (bench.py's ``dense_anchor``:
3425 / 2908 keypoints) is held by ``chip_smoke.py`` on the card: its
(B, E, 2048, 2048) conflict prefilter and the plain dedup loop are too
large for a CPU test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.akaze import Akaze as JAkaze
from cv_tpu.akaze import fast as jfast
from cv_tpu.akaze import load_gray as j_load_gray
from cv_tpu.akaze import to_gray_f32 as j_to_gray
from cv_tpu.utils.fixtures import fixture_path
from cv_tpu_torch.akaze import Akaze, DeviceExtractor, FastAkazeExtractor, from_numpy_config
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)

BUDGETS = dict(candidate_budget=512, max_features=2048, dedup_scan_cap=2048)


def _crop():
    return j_to_gray(j_load_gray(fixture_path("0000000000.png"))[128:384, 400:784])


@pytest.fixture(scope="module")
def crop():
    return _crop()


@pytest.fixture(scope="module")
def dense(crop):
    """The port's default (group) describe and cv_tpu's, on the crop."""
    jcfg = JAkaze()
    ref = jfast.DeviceExtractor(jcfg, onehot_mode="highest", **BUDGETS).extract(jnp.asarray(crop)[None])
    ref = {k: np.asarray(getattr(ref, k)) for k in ("point", "angle", "words", "valid")}
    ref["words"] = ref["words"].view(np.uint32)
    ex = DeviceExtractor(from_numpy_config(jcfg), device="cpu", **BUDGETS)
    return ex, ex.extract(crop[None]).to_numpy(), ref


def _gates(got, ref, angle_tol):
    vg, vr = got["valid"][0], ref["valid"][0]
    assert vg.sum() == vr.sum() > 100
    pg, pr = got["point"][0][vg], ref["point"][0][vr]
    dist = np.abs(pr[:, None, :] - pg[None, :, :]).max(-1)
    near = dist.argmin(1)
    assert dist.min(1).max() < 1e-3
    da = np.abs(got["angle"][0][vg][near] - ref["angle"][0][vr])
    assert np.minimum(da, 2 * np.pi - da).max() < angle_tol
    wg, wr = got["words"][0][vg][near], ref["words"][0][vr]
    assert (wg == wr).all(axis=1).mean() >= 0.99
    assert np.unpackbits((wg ^ wr).view(np.uint8), axis=1).sum(axis=1).max() <= 16


def test_dense_default_takes_group_describe(dense, crop):
    ex, _, _ = dense
    assert ex.describe_mode(*crop.shape) == "pgroups"


def test_dense_crop_matches_cv_tpu(dense):
    _, got, ref = dense
    _gates(got, ref, 1e-4)


@pytest.mark.parametrize("mode", ["pgather", "pfused", "pallas", "pgroups4"])
def test_dense_modes_agree(dense, crop, mode):
    ex, base, _ = dense
    other = DeviceExtractor(ex.config, device="cpu", onehot_mode=mode, **BUDGETS).extract(crop[None]).to_numpy()
    _gates(other, base, 1e-6)
    np.testing.assert_array_equal(other["point"], base["point"])
    np.testing.assert_array_equal(other["valid"], base["valid"])
    v = base["valid"]
    np.testing.assert_array_equal(other["angle"][v].view(np.uint32), base["angle"][v].view(np.uint32))
    np.testing.assert_array_equal(other["words"][v], base["words"][v])


def test_engine_budget_adapter():
    """``FastAkazeExtractor`` as the engine builds it (tracking_features =
    8192): candidate budget 2048, dedup cap 8192, the group describe on a
    KITTI frame."""
    fx = FastAkazeExtractor(Akaze(maximum_features=8192), device="cpu")
    dev = fx._dev
    assert (dev.candidate_budget, dev.max_features, dev.dedup_scan_cap) == (2048, 8192, 8192)
    assert dev.describe_mode(512, 1392) == "pgroups"


def test_fast_extractor_group_path_equals_device_extractor(crop):
    """The adapter at 2048 features returns exactly the device extractor's
    valid rows, in response order."""
    kp, words = FastAkazeExtractor(Akaze(maximum_features=2048), device="cpu").extract(crop)
    fs = DeviceExtractor(Akaze(), device="cpu", **BUDGETS).extract(crop[None]).to_numpy()
    valid = fs["valid"][0]
    np.testing.assert_array_equal(kp["point"], fs["point"][0][valid])
    np.testing.assert_array_equal(words, fs["words"][0][valid])
    assert (np.diff(kp["response"]) <= 0).all()


def _dedup_batch(seed, b, c, dev):
    rng = np.random.default_rng(seed)
    cls = np.sort(rng.integers(0, 13, (b, c)), axis=1)
    px = rng.uniform(0, 1392, (b, c)).astype(np.float32)
    py = rng.uniform(0, 512, (b, c)).astype(np.float32)
    shift = rng.uniform(0, 1.5, (b, c)).astype(np.float32)
    size2 = ((2.0 * 2.0 ** (cls / 4.0)) ** 2 * 4.0).astype(np.float32)
    arrays = [px, py, px + shift, py + shift, rng.uniform(0.01, 1, (b, c)).astype(np.float32), cls, size2,
              rng.uniform(size=(b, c)) < 0.95, np.array([c, c * 5 // 6])]
    return [torch.as_tensor(a, device=dev) for a in arrays]


@pytest.mark.cuda
# The cache in shared memory; forced to global memory; above the card's
# shared memory (20 B a slot: 12288 slots are 240 KB, over an H100's 227 KB).
@pytest.mark.parametrize("cap, max_shared_slots", [(8192, None), (8192, 0), (12288, None)])
def test_cuda_dedup_matches_plain(cap, max_shared_slots):
    from cv_tpu_torch.akaze import extrema

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dedup kernel runs only there")
    args = _dedup_batch(cap, 2, cap, "cuda")
    before = extrema.dedup_scan_device.launches
    got = extrema.dedup_scan_device(*args, max_shared_slots=max_shared_slots)
    torch.cuda.synchronize()
    assert extrema.dedup_scan_device.launches == before + 1
    assert torch.equal(got, extrema.dedup_scan_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("max_shared_slots", [None, 0])
def test_cuda_dedup_adversarial_matches_plain(max_shared_slots):
    """The kernel on chip_smoke's adversarial set (chains through the
    classes, classes that return, no order, classes past its class table),
    with the cache in shared and in global memory."""
    import chip_smoke
    from cv_tpu_torch.akaze import extrema

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dedup kernel runs only there")
    args = [torch.as_tensor(a, device="cuda") for a in chip_smoke.dedup_adversarial(0)]
    got = extrema.dedup_scan_device(*args, max_shared_slots=max_shared_slots)
    torch.cuda.synchronize()
    assert torch.equal(got, extrema.dedup_scan_plain(*args))


@pytest.mark.cuda
def test_cuda_select_fused_matches_plain():
    """The fused describe against its plain two-pass version on the card:
    ok flags equal, angles within 1e-5 rad, >= 99% of word rows equal."""
    from cv_tpu_torch.akaze import descriptors as desc
    from cv_tpu_torch.akaze import fused

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused describe kernel runs only there")
    gen = torch.Generator(device="cuda").manual_seed(0)
    k, hp, wp = 8192, 512, 1408
    planes = torch.randn((26, 3, hp, wp), generator=gen, device="cuda")
    lvl = torch.randint(0, 26, (k,), generator=gen, device="cuda", dtype=torch.int32)
    xf = torch.rand((k,), generator=gen, device="cuda") * 1392
    yf = torch.rand((k,), generator=gen, device="cuda") * 512
    scale = torch.randint(1, 5, (k,), generator=gen, device="cuda").float()
    width = torch.full((k,), 1392, dtype=torch.int32, device="cuda")
    height = torch.full((k,), 512, dtype=torch.int32, device="cuda")
    y0, x0 = desc.patch_anchor(xf, yf, hp, wp)
    orel = desc.orientation_offsets(xf, yf, scale, width, height, x0, y0, 128)
    args = (planes, lvl, y0, x0, *orel, xf, yf, scale, width, height)
    (vk, mk), (vp, mp) = fused.select_fused(*args), fused.select_fused_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(mk[:, 3], mp[:, 3])
    da = (mk[:, 0] - mp[:, 0]).abs()
    assert float(torch.minimum(da, 2 * np.pi - da).max()) <= 1e-5
    wk = desc._mldb_pack(vk[:, 0], vk[:, 1], vk[:, 2], mk[:, 1:2], mk[:, 2:3], 10)
    wp_ = desc._mldb_pack(vp[:, 0], vp[:, 1], vp[:, 2], mp[:, 1:2], mp[:, 2:3], 10)
    assert float((wk == wp_).all(dim=1).float().mean()) >= 0.99
