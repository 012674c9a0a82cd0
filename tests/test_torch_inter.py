"""The '+inter' describe modes: the select kernel and the patch-form select
on the pixel-interleaved stack (lane ``3 * x + channel``), against cv_tpu.

``cv_tpu``'s ``DeviceExtractor(onehot_mode='pgather+inter')`` and
``('pallas+inter')`` build the interleaved stack, cut one ``(128, 384)``
slice a keypoint, de-interleave it and select through Pallas kernels #1
(``select_samples_gather``) and #2 (``select_samples_batched``), here in
interpret mode.  On the same stack and keypoints the port's describe gives
cv_tpu's flags, words and angles bitwise.  The port's whole extract on the
CPU gives cv_tpu's valid flags and words bitwise and its own ``'pgather'``'s
angles bitwise; against cv_tpu's angles it keeps the tolerance of every
describe mode, ``'pgather'`` included (6 of the 70 angles here differ by
at most 16 ulps: the scale space's float order, ROADMAP's north star).
The port reads the interleaved stack directly
(``select.select_samples_interleaved``, ``csrc/select_samples.cu``'s
interleaved entry on a card; its plain version here), which must equal the
channel-major select on the same planes, NaN where an index leaves the
stack.  The kernel itself runs only on a card (the ``cuda`` test skips
here; ``chip_smoke.py`` holds it there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.akaze import Akaze as JAkaze
from cv_tpu.akaze import fast as jfast
from cv_tpu_torch.akaze import DeviceExtractor, from_numpy_config
from cv_tpu_torch.akaze import descriptors as tdesc
from cv_tpu_torch.akaze import fast as tfast
from cv_tpu_torch.akaze import select as tselect
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)

MODES = ("pgather+inter", "pallas+inter")


def _image():
    return np.random.default_rng(6).uniform(0, 1, (128, 160)).astype(np.float32)


@pytest.fixture(scope="module")
def cv_tpu_runs():
    """cv_tpu's extract of the seeded image in each '+inter' mode (its
    Pallas kernels in interpret mode), 64 candidates and 128 features."""
    img = jnp.asarray(_image())[None]
    cfg = JAkaze(detector_threshold=0.001)
    out = {}
    for mode in MODES:
        fs = jfast.DeviceExtractor(cfg, candidate_budget=64, max_features=128, onehot_mode=mode).extract(img)
        out[mode] = dict(valid=np.asarray(fs.valid), words=np.asarray(fs.words).view(np.uint32),
                         angle=np.asarray(fs.angle))
    return cfg, out


def _port(cfg, mode):
    ex = DeviceExtractor(from_numpy_config(cfg), candidate_budget=64, max_features=128, device="cpu",
                         onehot_mode=mode)
    return ex.extract(_image()[None]).to_numpy()


@pytest.mark.parametrize("mode", MODES)
def test_inter_modes_match_cv_tpu(cv_tpu_runs, mode):
    cfg, ref = cv_tpu_runs
    ref = ref[mode]
    got = _port(cfg, mode)
    assert ref["valid"].sum() > 40
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    v = ref["valid"]
    np.testing.assert_array_equal(got["words"][v], ref["words"][v])
    da = np.abs(got["angle"][v] - ref["angle"][v])
    assert np.minimum(da, 2 * np.pi - da).max() < 1e-4


@pytest.fixture(scope="module")
def describe_inputs():
    """A seeded interleaved stack (3 levels, 256 x 256) and 40 keypoints,
    some on planes narrower than the stack; cv_tpu's describe of them in
    each '+inter' mode."""
    from cv_tpu.akaze import descriptors as jdesc

    rng = np.random.default_rng(23)
    n_levels, hp, wp, k = 3, 256, 256, 40
    planes = rng.normal(size=(n_levels, 3, hp, wp)).astype(np.float32)
    stack = np.ascontiguousarray(planes.transpose(0, 2, 3, 1).reshape(n_levels, hp, 3 * wp))
    lvl = rng.integers(0, n_levels, k).astype(np.int32)
    width = np.where(lvl % 2, wp - 40, wp).astype(np.int32)
    height = np.where(lvl % 2, hp - 30, hp).astype(np.int32)
    xf = (rng.uniform(0, 1, k) * width).astype(np.float32)
    yf = (rng.uniform(0, 1, k) * height).astype(np.float32)
    scale = rng.integers(1, 4, k).astype(np.float32)
    args = (stack, lvl, width, height, xf, yf, scale)
    ref = {mode: [np.asarray(x) for x in jdesc.orient_mldb_onehot(
        *(jnp.asarray(a) for a in args), pattern_size=10, chunk=16, mode=mode.removesuffix("+inter"),
        interleaved=True)] for mode in MODES}
    return args, ref


@pytest.mark.parametrize("mode", MODES)
def test_describe_bitwise_to_cv_tpu(describe_inputs, mode):
    args, ref = describe_inputs
    w_j, ok_j, a_j = ref[mode]
    w_t, ok_t, a_t = (x.numpy() for x in tdesc.orient_mldb(
        *(torch.as_tensor(a) for a in args), pattern_size=10, mode=mode.removesuffix("+inter"), interleaved=True))
    assert 0 < ok_j.sum() < len(ok_j)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(w_t.view(np.uint32), w_j.view(np.uint32))
    np.testing.assert_array_equal(a_t.view(np.uint32), a_j.view(np.uint32))


@pytest.mark.parametrize("mode", MODES)
def test_inter_modes_equal_pgather(cv_tpu_runs, mode):
    """The port's '+inter' extract equals its own 'pgather', keypoints,
    words and angles bitwise, and builds only the interleaved stack."""
    cfg, _ = cv_tpu_runs
    built = []
    real = tfast.padded_plane_stack
    tfast.padded_plane_stack = lambda *a, **k: built.append(1) or real(*a, **k)
    try:
        got = _port(cfg, mode)
    finally:
        tfast.padded_plane_stack = real
    assert not built
    base = _port(cfg, "pgather")
    for key in ("valid", "point", "words"):
        np.testing.assert_array_equal(got[key], base[key])
    np.testing.assert_array_equal(got["angle"].view(np.uint32), base["angle"].view(np.uint32))


def _draw(seed, c0, edges):
    """A seeded stack (as channel-major planes and interleaved) and sample
    indices: on the window edges (offsets 0 and 127, anchors at the stack's
    borders), or some leaving the stack on every axis (NaN rows)."""
    g = torch.Generator().manual_seed(seed)
    n_levels, hp, wp, k, ns = 6, 160, 192, 40, 109 if c0 else 441
    planes = torch.randn((n_levels, 3, hp, wp), generator=g)
    stack = planes.permute(0, 2, 3, 1).reshape(n_levels, hp, 3 * wp).contiguous()
    lvl = torch.randint(0, n_levels, (k,), generator=g, dtype=torch.int32)
    y0 = torch.randint(0, hp - 127, (k,), generator=g, dtype=torch.int32)
    x0 = torch.randint(0, wp - 127, (k,), generator=g, dtype=torch.int32)
    rel_x = torch.randint(0, 128, (k, ns), generator=g, dtype=torch.int32)
    rel_y = torch.randint(0, 128, (k, ns), generator=g, dtype=torch.int32)
    if edges:
        y0[::3], x0[1::3], y0[2::5], x0[2::5] = 0, 0, hp - 128, wp - 128
        rel_x[:, ::7], rel_y[:, 1::7], rel_x[:, 2::9], rel_y[:, 2::9] = 0, 0, 127, 127
    else:
        lvl[0], lvl[1], y0[2], x0[3], x0[4] = -1, n_levels, -5, -1, wp - 100
        rel_y[5, ::4], rel_x[6, ::5] = hp, 200
    return planes, stack, (lvl, y0, x0, rel_x, rel_y)


@pytest.mark.parametrize("edges", [True, False], ids=["edges", "out_of_stack"])
@pytest.mark.parametrize("c0", [0, 1])
def test_interleaved_plain_equals_channel_major(c0, edges):
    planes, stack, idx = _draw(40 + 2 * c0 + edges, c0, edges)
    got = tselect.select_samples_interleaved_plain(stack, *idx, c0)
    want = tselect.select_samples_plain(planes, *idx, c0)
    assert got.shape == (40, 3 - c0, 109 if c0 else 441)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    nan_rows = torch.isnan(want).any(dim=-1).any(dim=-1)
    assert bool(nan_rows.any()) != edges
    if not edges:  # exactly the samples outside, every channel
        lvl, y0, x0, rel_x, rel_y = idx
        y, x = y0[:, None] + rel_y, x0[:, None] + rel_x
        out = ((lvl < 0) | (lvl >= 6))[:, None] | (y < 0) | (y >= 160) | (x < 0) | (x >= 192)
        assert torch.equal(torch.isnan(want), out[:, None, :].expand(want.shape))


def test_interleaved_wrapper_on_the_cpu_is_the_plain_version():
    _, stack, idx = _draw(50, 0, True)
    tselect.select_samples_interleaved.launches = 0
    got = tselect.select_samples_interleaved(stack, *idx, 0)
    assert torch.equal(got, tselect.select_samples_interleaved_plain(stack, *idx, 0))
    assert tselect.select_samples_interleaved.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tselect.select_samples_interleaved(*(t.to("meta") for t in (stack, *idx)), 0)
    with pytest.raises(ValueError, match="several devices"):
        tselect.select_samples_interleaved(stack.to("meta"), *idx, 0)


def test_patch_cut_from_the_interleaved_stack():
    """'pallas+inter''s route: the patches cut from the interleaved stack
    and selected in patch form equal the interleaved select."""
    planes, stack, (lvl, y0, x0, rel_x, rel_y) = _draw(51, 1, True)
    patches = tdesc.cut_patches_interleaved(stack, lvl, y0, x0).contiguous()
    assert torch.equal(patches, tselect.cut_patches(planes, lvl, y0, x0))
    got = tselect.select_samples_patch(patches, rel_x, rel_y, 1)
    assert torch.equal(got, tselect.select_samples_interleaved_plain(stack, lvl, y0, x0, rel_x, rel_y, 1))


@pytest.mark.cuda
def test_interleaved_kernel_bitwise_on_the_card():
    """The kernel against its plain version on the card, out-of-stack
    indices included (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the interleaved select kernel runs only there")
    for c0, edges in ((0, True), (1, False)):
        _, stack, idx = _draw(52 + c0, c0, edges)
        dev = [t.cuda() for t in (stack, *idx)]
        got = tselect.select_samples_interleaved(*dev, c0).cpu()
        want = tselect.select_samples_interleaved_plain(stack, *idx, c0)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("mode", ["pepatch+inter", "ptiles+inter", "pgroups4+inter"])
def test_modes_cv_tpu_fails_on_raise(mode):
    """'+inter' on the kernel modes whose cv_tpu describe fails (an assert
    or an IndexError there) is refused by name, with the reason."""
    with pytest.raises(ValueError, match="cv_tpu itself fails"):
        DeviceExtractor(device="cpu", onehot_mode=mode)
