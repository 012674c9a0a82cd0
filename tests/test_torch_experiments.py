"""cv_tpu_torch/experiments against the JAX experiments' TPU kernels.

The retired selects of ``experiments/pallas_mldb_losers.py`` run in
interpret mode (as ``tests/test_fast_extractor.py`` runs them) and are held
bitwise: they are pure selects.  The retired describe modes go through both
packages' ``DeviceExtractor`` under the describe gates of
``tests/test_torch_groups.py`` (counts equal, points within 1e-3 px, angles
within 1e-4 rad, >= 99% of valid word rows bitwise equal and none more than
16 of 486 bits off), and the port's ``'pepatch'`` and ``'ptiles'`` are held
bitwise to its ``'pgather'``.

The probes' Pallas bodies run through ``pl.pallas_call(...,
interpret=True)`` built here from each module's own kernel body and a copy
of its runner's grid spec at K=16, in 32-bit mode as on the TPU (the int8x4
body's integer sums widen to int64 under x64).  Selects are held bitwise;
sums, which XLA orders otherwise, within ``probes.SUM_ATOL`` (three times
the largest difference measured here on six seeds); the trigonometry
bitwise (``cv_tpu_torch.ops.trig`` computes the C library's atan2f, cosf
and sinf, which XLA's CPU backend calls).  Two bodies do not compute what their scripts meant:
``exp_select_kernels.py``'s bf16x3 body sums its (split, channel, row,
sample) product over the channel axis (``:121``), so it returns the
channel sums of the three bf16 splits, not the sample (6.19 off on these
inputs); it is held bitwise to that function.  ``exp_r3_mxu_probe.py``'s
``k_split`` does not trace at its own NS=512 (``:108-112`` adds a (512,
128) and a (128, 128) array); it is held at NS=128.  The window, column
and row sums' order mirrors (``probes.bisect_window_ordered``,
``probes.bisect_matmul_ordered``, ``probes.mxu_rows_ordered``), which their
kernels equal bit for bit, are held bitwise to the same order written in
NumPy.  Where a sample's row (``k_vpu_rowstage``) or column
(``k_matmul_dyn_oh``) leaves the window the JAX bodies' one-hot matches
nothing and they give +0: the port too, held bitwise.

The probe scripts call ``jax.config.update("jax_compilation_cache_dir",
...)`` when imported; they are imported with that call stubbed, so this
worker keeps ``tests/conftest.py``'s cache.  The kernels run only on a
CUDA card; the tests marked ``cuda`` hold them to their plain versions
there and skip here.
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cv_tpu.akaze import Akaze as JAkaze
from cv_tpu.akaze import load_gray as j_load_gray
from cv_tpu.akaze import to_gray_f32 as j_to_gray
from cv_tpu.akaze.fast import DeviceExtractor as JDeviceExtractor
from cv_tpu.utils.fixtures import fixture_path
from cv_tpu_torch.akaze import Akaze, DeviceExtractor, from_numpy_config, load_gray, to_gray_f32
from cv_tpu_torch.akaze import descriptors as tdesc
from cv_tpu_torch.akaze import select as tselect
from cv_tpu_torch.experiments import mldb_losers, probes, runs
from cv_tpu_torch.utils import kitti_pair

G = 8
K = 16
PROBE_MODULES = ("exp_select_kernels", "exp_bisect", "exp_r3_mxu_probe", "exp_r3_gather_probe", "exp_r5_pfused")
CACHE_DIR = jax.config.jax_compilation_cache_dir


@pytest.fixture(scope="module")
def exp():
    """The JAX experiments modules, imported with ``jax.config.update``
    stubbed (they set the persistent cache dir at import)."""
    real = jax.config.update
    jax.config.update = lambda *a, **kw: None
    try:
        mods = {name: importlib.import_module(f"experiments.{name}") for name in PROBE_MODULES}
        losers = importlib.import_module("experiments.pallas_mldb_losers")
    finally:
        jax.config.update = real
    return types.SimpleNamespace(losers=losers, **mods)


@pytest.fixture
def registered(monkeypatch):
    """The retired modes registered for this test only."""
    monkeypatch.setitem(tdesc.EXTERNAL_MODES, "pepatch", mldb_losers.epatch_select)
    monkeypatch.setitem(tdesc.EXTERNAL_MODES, "ptiles", mldb_losers.orient_mldb_ptiles)


def test_experiment_imports_keep_the_cache_dir(exp):
    assert jax.config.jax_compilation_cache_dir == CACHE_DIR
    assert exp.exp_bisect.K_TOTAL == 512 and exp.exp_select_kernels.K_TOTAL == 4096


def test_importing_registers_the_retired_modes():
    assert tdesc.EXTERNAL_MODES["pepatch"] is mldb_losers.epatch_select
    assert tdesc.EXTERNAL_MODES["ptiles"] is mldb_losers.orient_mldb_ptiles


# ---------------------------------------------------------------------------
# The retired selects and describe modes
# ---------------------------------------------------------------------------


def _select_inputs(seed, ns, tiles):
    rng = np.random.default_rng(seed)
    l, hp, wp = 2, 256, 384
    planes = rng.normal(size=(l, 3, hp, wp)).astype(np.float32)
    lvl = rng.integers(0, l, K).astype(np.int32)
    if tiles:
        a = rng.integers(0, hp // 128 - 1, K).astype(np.int32)
        b = rng.integers(0, wp // 128 - 1, K).astype(np.int32)
        hi = 256
    else:
        a = rng.integers(0, hp - 128 + 1, K).astype(np.int32)
        b = rng.integers(0, wp - 128 + 1, K).astype(np.int32)
        hi = 128
    rel_x = rng.integers(0, hi, (K, ns)).astype(np.int32)
    rel_y = rng.integers(0, hi, (K, ns)).astype(np.int32)
    return planes, lvl, a, b, rel_x, rel_y


@pytest.mark.parametrize("ns", [128, 256])
@pytest.mark.parametrize("name", ["select_samples_epatch", "select_samples_tiles", "select_samples_tiles8"])
def test_retired_selects_match_jax(exp, name, ns):
    args = _select_inputs(3 + ns, ns, tiles=name != "select_samples_epatch")
    for c0 in (0, 1):
        ref = np.asarray(getattr(exp.losers, name)(*(jnp.asarray(a) for a in args), interpret=True, c0=c0))
        got = getattr(mldb_losers, name)(*(torch.as_tensor(a) for a in args), c0=c0).numpy()
        assert got.shape == ref.shape == (K, 3 - c0, ns)
        np.testing.assert_array_equal(got, ref)


def _gates(w_t, ok_t, a_t, w_j, ok_j, a_j, angle_tol=1e-4):
    np.testing.assert_array_equal(ok_t, ok_j)
    da = np.abs(a_t - a_j)
    assert np.minimum(da, 2 * np.pi - da).max() < angle_tol
    w_t, w_j = w_t.view(np.uint32), w_j.view(np.uint32)
    assert (w_t == w_j).all(axis=1).mean() >= 0.99
    assert np.unpackbits((w_t ^ w_j).view(np.uint8), axis=1).sum(axis=1).max() <= 16


def _extract_both(img, mode, jcfg, cb, mf):
    """Both packages' ``DeviceExtractor`` with describe ``mode`` on one image."""
    jfs = JDeviceExtractor(jcfg, candidate_budget=cb, max_features=mf, onehot_mode=mode).extract(jnp.asarray(img)[None])
    tfs = DeviceExtractor(from_numpy_config(jcfg), cb, mf, device="cpu", onehot_mode=mode).extract(img[None]).to_numpy()
    return {k: np.asarray(getattr(jfs, k))[0] for k in ("valid", "point", "angle", "words")}, {
        k: v[0] for k, v in tfs.items()
    }


def _hold_to_cv_tpu(j, t):
    vj, vt = j["valid"], t["valid"]
    assert vj.sum() == vt.sum() > 20
    pj, pt = j["point"][vj], t["point"][vt]
    dist = np.abs(pt[:, None, :] - pj[None, :, :]).max(-1)
    near = dist.argmin(1)
    assert dist.min(1).max() < 1e-3
    ok = np.ones(len(near), bool)
    _gates(t["words"][vt], ok, t["angle"][vt], j["words"][vj][near], ok, j["angle"][vj][near])


def test_ptiles_matches_cv_tpu(exp, registered):
    """The 'ptiles' describe of both packages on a 256x384 KITTI crop at the
    default threshold."""
    img = j_to_gray(j_load_gray(fixture_path("0000000000.png"))[128:384, 400:784])
    j, t = _extract_both(img, "ptiles", JAkaze(), 256, 512)
    _hold_to_cv_tpu(j, t)


def test_pepatch_matches_cv_tpu(exp, registered):
    """``TestEpatchCut``'s settings (tests/test_fast_extractor.py:239-253)."""
    img = to_gray_f32(np.random.default_rng(3).uniform(0, 255, (192, 256)).astype(np.uint8))
    j, t = _extract_both(img, "pepatch", JAkaze(detector_threshold=0.001), 128, 256)
    _hold_to_cv_tpu(j, t)


@pytest.mark.parametrize("mode", ["pepatch", "ptiles"])
def test_retired_modes_equal_pgather(registered, mode):
    """The port's retired modes give its 'pgather' bits (on the CPU both
    run the plain select on the same batch)."""
    img = np.ascontiguousarray(to_gray_f32(load_gray(kitti_pair()[1]))[200:456, 300:684])
    base = DeviceExtractor(Akaze(), 256, 512, device="cpu").extract(img[None]).to_numpy()
    got = DeviceExtractor(Akaze(), 256, 512, device="cpu", onehot_mode=mode).extract(img[None]).to_numpy()
    assert base["valid"].sum() > 20
    for key in ("valid", "point", "words", "angle"):
        np.testing.assert_array_equal(got[key], base[key], err_msg=key)


def test_explicit_ptiles_on_small_stack_raises(registered):
    """A stack with no 256x256 window: the JAX version clips the tile to -1
    there (pallas_mldb_losers.py:373-374); the port raises."""
    img = np.random.default_rng(8).uniform(0, 1, (96, 200)).astype(np.float32)
    with pytest.raises(ValueError, match="pallas_mldb_losers.py:373-374"):
        DeviceExtractor(candidate_budget=64, max_features=256, device="cpu", onehot_mode="ptiles").extract(img[None])


def test_orient_mldb_ptiles_unsorted_keypoints():
    """The describe on shuffled keypoints of one stack: the tile sort and
    its inverse put every row back in keypoint order."""
    rng = np.random.default_rng(11)
    n_levels, hp, wp, k = 3, 256, 384, 40
    planes = torch.as_tensor(rng.normal(size=(n_levels, 3, hp, wp)).astype(np.float32))
    lvl = torch.as_tensor(rng.integers(0, n_levels, k).astype(np.int32))
    width = torch.full((k,), wp, dtype=torch.int32)
    height = torch.full((k,), hp, dtype=torch.int32)
    xf = torch.as_tensor(rng.uniform(20, wp - 20, k).astype(np.float32))
    yf = torch.as_tensor(rng.uniform(20, hp - 20, k).astype(np.float32))
    scale = torch.as_tensor(rng.integers(1, 3, k).astype(np.float32))
    words, ok, angle = mldb_losers.orient_mldb_ptiles(planes, lvl, width, height, xf, yf, scale)
    ref = tdesc.orient_mldb(planes, lvl, width, height, xf, yf, scale)
    for got, want in zip((words, ok), ref[:2]):
        assert torch.equal(got, want)
    torch.testing.assert_close(angle, ref[2], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The probes
# ---------------------------------------------------------------------------


def _window_inputs(seed, ns=1280):
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(2, 3, 272, 384)).astype(np.float32)
    lvl = rng.integers(0, 2, K).astype(np.int32)
    y0 = rng.integers(0, 272 - 136, K).astype(np.int32)
    x0 = rng.integers(0, 384 - 128, K).astype(np.int32)
    rel_y = rng.integers(0, 136, (K, ns)).astype(np.int32)
    rel_x = rng.integers(0, 128, (K, ns)).astype(np.int32)
    return planes, lvl, y0, x0, rel_y, rel_x


def _window_runner(mod, kernel, ns=1280):
    """``mod._make_runner(kernel)`` at K=16, in interpret mode."""
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3,
        grid=(K // mod.G,),
        in_specs=[
            pl.BlockSpec((mod.G, ns), lambda i, *_: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((mod.G, ns), lambda i, *_: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((mod.G, 3 * ns), lambda i, *_: (i, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((mod.G, 3, mod.PH, mod.PW), jnp.float32), pltpu.SemaphoreType.DMA((mod.G,))],
    )

    def run(planes, lvl, y0, x0, rel_y, rel_x):
        call = pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((K, 3 * ns), jnp.float32), grid_spec=spec, interpret=True
        )
        with jax.enable_x64(False):
            return np.asarray(call(*(jnp.asarray(a) for a in (lvl, y0, x0, rel_y, rel_x, planes))))

    return run


def _close(body, got, ref):
    torch.testing.assert_close(torch.as_tensor(np.array(got)), torch.as_tensor(np.array(ref)), rtol=0,
                               atol=probes.SUM_ATOL[body])


@pytest.mark.parametrize("body", ["_kernel_int8", "_kernel_taa"])
def test_select_window_matches_exp_select_kernels(exp, body):
    args = _window_inputs(5)
    ref = _window_runner(exp.exp_select_kernels, getattr(exp.exp_select_kernels, body))(*args)
    got = probes.select_window_plain(*(torch.as_tensor(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, ref)
    k_check = 4
    host = exp.exp_select_kernels.host_reference(*args, k_check=k_check)
    np.testing.assert_array_equal(got[:k_check].reshape(host.shape), host)


def test_exp_select_kernels_bf16_body_sums_channels(exp):
    """The bf16x3 body returns, per split j, the sum over channels of split
    j of the sample: not the sample."""
    args = _window_inputs(6)
    ref = _window_runner(exp.exp_select_kernels, exp.exp_select_kernels._kernel_bf16)(*args)
    sel = probes.select_window_plain(*(torch.as_tensor(a) for a in args)).reshape(K, 3, -1)
    splits = torch.stack(probes._split3(sel), dim=1)  # (K, split, channel, NS)
    np.testing.assert_array_equal(splits.sum(dim=2).reshape(K, -1).numpy(), ref)
    assert np.abs(ref - sel.reshape(K, -1).numpy()).max() > 1.0


@pytest.mark.parametrize("body", probes.BISECT_BODIES)
def test_bisect_plain_matches_exp_bisect(exp, body):
    args = _window_inputs(7)
    ref = _window_runner(exp.exp_bisect, getattr(exp.exp_bisect, f"k_{body}"))(*args)
    got = probes.bisect_plain(body, *(torch.as_tensor(a) for a in args)).numpy()
    if body in probes.SUM_ATOL:
        _close(body, got, ref)
    else:
        np.testing.assert_array_equal(got, ref)


def _np_bf16(x):
    """float32 rounded to bfloat16 (nearest even) and back, on the bits;
    finite inputs."""
    u = x.view(np.uint32).astype(np.uint64)
    return (((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16).astype(np.uint32).view(np.float32)


def _kernel_order_sums(planes, lvl, y0, x0):
    """The column-sum kernels' (K, 128) sums in their order, in NumPy:
    for rep, c, y one float32 add of the bf16 row (in-stack windows)."""
    win = np.stack([planes[lv, :, y:y + 136, x:x + 128] for lv, y, x in zip(lvl, y0, x0)])
    b = _np_bf16(np.ascontiguousarray(win))
    acc = np.zeros((len(lvl), 128), np.float32)
    for _ in range(3):
        for c in range(3):
            for y in range(136):
                acc = acc + b[:, c, y]
    return acc


@pytest.mark.parametrize("seed", [21, 22, 23])
@pytest.mark.parametrize("align_x", [False, True])
@pytest.mark.parametrize("body", probes.MATMUL_BODIES)
def test_bisect_matmul_ordered_matches_exp_bisect(exp, body, align_x, seed):
    """The kernels' order mirror against the JAX body (x0 unaligned, and
    128-aligned as ``exp_bisect.make_inputs(align_x=True)`` makes it) and
    against ``bisect_plain``, within ``SUM_ATOL``; bitwise against the
    same order written in NumPy."""
    planes, lvl, y0, x0, rel_y, rel_x = _window_inputs(seed)
    if align_x:
        x0 = x0 & ~127
    args = (planes, lvl, y0, x0, rel_y, rel_x)
    ref = _window_runner(exp.exp_bisect, getattr(exp.exp_bisect, f"k_{body}"))(*args)
    targs = [torch.as_tensor(a) for a in args]
    got = probes.bisect_matmul_ordered(body, *targs).numpy()
    _close(body, got, ref)
    _close(body, got, probes.bisect_plain(body, *targs).numpy())
    cols = np.arange(rel_x.shape[1]) % 128 if body == "matmul_static" else rel_x
    sums = _kernel_order_sums(planes, lvl, y0, x0)
    want = np.take_along_axis(sums, np.broadcast_to(cols, rel_x.shape), axis=1).repeat(3, axis=1)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("body", probes.MATMUL_BODIES)
def test_bisect_matmul_nan_where_windows_leave_zero_where_columns_leave(body):
    """Windows that leave the stack (past either edge, or an absent level)
    give rows of the kernels' quiet NaN (the JAX body's DMA cannot take
    such a window); dynamic columns outside [0, 128) +0, bitwise (the JAX
    body's one-hot matches nothing there); the rest as ``bisect_plain``."""
    planes, lvl, y0, x0, rel_y, rel_x = _window_inputs(24, ns=256)
    x0[0], y0[1], lvl[2], x0[3], y0[4] = 384 - 127, -1, 2, -3, 272 - 135
    rel_x[5, :4] = [-1, 128, 300, -200]
    rel_x[6, 100] = 128
    targs = [torch.as_tensor(a) for a in (planes, lvl, y0, x0, rel_y, rel_x)]
    got = probes.bisect_matmul_ordered(body, *targs).numpy()
    plain = probes.bisect_plain(body, *targs).numpy()
    nan_rows = np.zeros(rel_x.shape, bool)
    nan_rows[:5] = True
    zero = np.zeros(rel_x.shape, bool)
    if body == "matmul_dyn_oh":
        zero[5, :4] = zero[6, 100] = True
    for out in (got, plain):
        np.testing.assert_array_equal(np.isnan(out), nan_rows.repeat(3, axis=1))
        assert np.all(out.view(np.int32)[np.isnan(out)] == 0x7FC00000)  # the kernels' quiet NaN
        assert np.all(out.view(np.int32)[zero.repeat(3, axis=1)] == 0)
    _close(body, got[~np.isnan(got)], plain[~np.isnan(plain)])


@pytest.mark.parametrize("body", ["vpu_rowstage", "matmul_dyn_oh"])
def test_bisect_rows_and_columns_outside_the_window_give_zero(exp, monkeypatch, body):
    """A sample whose row (``k_vpu_rowstage``) or column (``k_matmul_dyn_oh``)
    lies at -1, the window's edge or 300 matches no one-hot entry: the JAX
    body, in interpret mode, gives +0 there, and so do ``bisect_plain`` and,
    for the column sum, ``bisect_matmul_ordered``, bitwise; elsewhere the
    row select is bitwise and the column sum within ``SUM_ATOL``."""
    ns = 256
    monkeypatch.setattr(exp.exp_bisect, "NS", ns)
    args = _window_inputs(41, ns=ns)
    idx, edge = (args[4], probes.PH) if body == "vpu_rowstage" else (args[5], probes.PW)
    idx[5, :3] = [-1, edge, 300]
    idx[9, 200] = edge
    left = np.zeros((K, ns), bool)
    left[5, :3] = left[9, 200] = True
    # out[k, c NS + s] (the row select) or out[k, 3 s + r] (the column sums)
    left = np.tile(left, 3) if body == "vpu_rowstage" else left.repeat(3, axis=1)
    ref = _window_runner(exp.exp_bisect, getattr(exp.exp_bisect, f"k_{body}"), ns)(*args)
    assert np.all(ref.view(np.int32)[left] == 0)
    targs = [torch.as_tensor(a) for a in args]
    ports = [probes.bisect_plain] + ([probes.bisect_matmul_ordered] if body == "matmul_dyn_oh" else [])
    for port in ports:
        got = port(body, *targs).numpy()
        np.testing.assert_array_equal(got.view(np.int32)[left], ref.view(np.int32)[left])
        if body == "vpu_rowstage":
            np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
        else:
            _close(body, got[~left], ref[~left])


def _window_order_sums(planes, lvl, y0, x0, body):
    """The window-sum kernels' (K,) sums in their order, in NumPy, as a
    thread a strided sample states it: thread t < 256 adds the flat window
    elements t, t + 256, ... into a float32 from 0; in each warp, lane l
    adds lane l + off's value (its own past lane 31) for off = 16 .. 1;
    warps 0 .. 7's lane 0 are added in order.  ``'split_nomm'``: one such
    sum for each bf16 split, then (s1 + s2) + s3 (in-stack windows)."""
    win = np.stack([planes[lv, :, y:y + 136, x:x + 128] for lv, y, x in zip(lvl, y0, x0)]).reshape(len(lvl), -1)
    if body == "dma_only":
        parts = [win]
    else:
        p1 = _np_bf16(win)
        r1 = win - p1
        p2 = _np_bf16(r1)
        parts = [p1, p2, _np_bf16(r1 - p2)]
    lane = np.arange(32)
    sums = []
    for part in parts:
        v = np.zeros((len(lvl), 256), np.float32)
        for m in range(part.shape[1] // 256):
            v = v + part[:, 256 * m:256 * (m + 1)]
        v = v.reshape(len(lvl), 8, 32)
        for off in (16, 8, 4, 2, 1):
            v = v + v[..., np.where(lane + off < 32, lane + off, lane)]
        s = v[:, 0, 0]
        for w in range(1, 8):
            s = s + v[:, w, 0]
        sums.append(s)
    return sums[0] if body == "dma_only" else (sums[0] + sums[1]) + sums[2]


@pytest.mark.parametrize("align_x", [False, True])
@pytest.mark.parametrize("body", probes.WINDOW_SUM_BODIES)
def test_bisect_window_ordered_matches_exp_bisect(exp, body, align_x):
    """The window sums' order mirror against the JAX body (x0 unaligned,
    and 128-aligned as ``exp_bisect.make_inputs(align_x=True)`` makes it)
    and against ``bisect_plain``, within ``SUM_ATOL``; bitwise against the
    same order written in NumPy."""
    planes, lvl, y0, x0, rel_y, rel_x = _window_inputs(26)
    if align_x:
        x0 = x0 & ~127
    args = (planes, lvl, y0, x0, rel_y, rel_x)
    ref = _window_runner(exp.exp_bisect, getattr(exp.exp_bisect, f"k_{body}"))(*args)
    targs = [torch.as_tensor(a) for a in args]
    got = probes.bisect_window_ordered(body, *targs).numpy()
    assert got.shape == ref.shape == (K, 3 * rel_x.shape[1])
    _close(body, got, ref)
    _close(body, got, probes.bisect_plain(body, *targs).numpy())
    want = np.repeat(_window_order_sums(planes, lvl, y0, x0, body)[:, None], got.shape[1], axis=1)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("body", probes.WINDOW_SUM_BODIES)
def test_bisect_window_nan_where_windows_leave(body):
    """Windows that leave the stack (past either edge, or an absent level)
    give rows of the kernels' quiet NaN; the other rows are bitwise the
    NumPy order and within ``SUM_ATOL`` of ``bisect_plain``, which has NaN
    at the same rows.  (The JAX body's DMA cannot take such a window.)"""
    planes, lvl, y0, x0, rel_y, rel_x = _window_inputs(27, ns=256)
    x0[0], y0[1], lvl[2], x0[3], y0[4] = 384 - 127, -1, 2, -3, 272 - 135
    targs = [torch.as_tensor(a) for a in (planes, lvl, y0, x0, rel_y, rel_x)]
    got = probes.bisect_window_ordered(body, *targs).numpy()
    plain = probes.bisect_plain(body, *targs).numpy()
    bad = np.zeros(K, bool)
    bad[:5] = True
    np.testing.assert_array_equal(np.isnan(got), np.repeat(bad[:, None], got.shape[1], axis=1))
    np.testing.assert_array_equal(np.isnan(plain), np.isnan(got))
    assert np.all(got[bad].view(np.int32) == 0x7FC00000)  # the kernels' quiet NaN
    _close(body, got[~bad], plain[~bad])
    want = np.repeat(_window_order_sums(planes, lvl[~bad], y0[~bad], x0[~bad], body)[:, None], got.shape[1], axis=1)
    np.testing.assert_array_equal(got[~bad].view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("case", ["unaligned", "aligned", "leaving"])
def test_bisect_windows_read_counts_each_float_once(case):
    """The byte bound of the window and column sums counts the floats the
    windows cover once each (``chip_smoke.bisect_windows_read``): the union
    of each level's windows, every channel, as a NumPy mask states it; a
    window that leaves the stack reads nothing."""
    import chip_smoke

    planes, lvl, y0, x0, _, _ = _window_inputs(30, ns=8)
    if case == "aligned":
        x0 = x0 & ~127
    elif case == "leaving":
        x0[0], y0[1], lvl[2], x0[3], y0[4] = 384 - 127, -1, 2, -3, 272 - 135
    mask = np.zeros(planes.shape[:1] + planes.shape[2:], bool)
    for lv, y, x in zip(lvl, y0, x0):
        if 0 <= lv < planes.shape[0] and 0 <= y <= 272 - 136 and 0 <= x <= 384 - 128:
            mask[lv, y:y + 136, x:x + 128] = True
    got = chip_smoke.bisect_windows_read(*(torch.as_tensor(a) for a in (planes, lvl, y0, x0)))
    assert got == 3 * int(mask.sum())
    assert got < 3 * 136 * 128 * (K - 5 if case == "leaving" else K)  # the windows overlap
    nbytes, _ = chip_smoke.bisect_work("dma_only", K, 8, got)
    assert nbytes == K * 12 + 4 * got + K * 3 * 8 * 4


@pytest.mark.parametrize("case", ["unaligned", "aligned", "leaving"])
def test_rowstage_sectors_read_counts_each_sector_once(case):
    """The row select's byte bound counts each 32-byte sector of the stack
    that an in-range sample of an in-stack window names once
    (``chip_smoke.rowstage_sectors_read``): a Python set of the sectors of
    ``planes[lvl, c, y0 + row, x0]``, every channel; leaving windows and
    rows outside the window name none."""
    import chip_smoke

    planes, lvl, y0, x0, rel_y, _ = _window_inputs(42, ns=64)
    if case == "aligned":
        x0 = x0 & ~127
    elif case == "leaving":
        x0[0], y0[1], lvl[2], x0[3], y0[4] = 384 - 127, -1, 2, -3, 272 - 135
        rel_y[5, :3] = [-1, 136, 300]
    n_levels, channels, height, width = planes.shape
    sectors = set()
    for k in range(K):
        if not (0 <= lvl[k] < n_levels and 0 <= y0[k] <= height - 136 and 0 <= x0[k] <= width - 128):
            continue
        for row in rel_y[k]:
            if 0 <= row < 136:
                for c in range(channels):
                    sectors.add(((((int(lvl[k]) * channels + c) * height + int(y0[k] + row)) * width + int(x0[k]))
                                 >> 3))
    got = chip_smoke.rowstage_sectors_read(*(torch.as_tensor(a) for a in (planes, lvl, y0, x0, rel_y)))
    assert got == len(sectors) > 0
    named = 3 * 64 * (K - 5 if case == "leaving" else K) - (9 if case == "leaving" else 0)
    assert got < named  # samples share rows
    nbytes, flops = chip_smoke.bisect_work("vpu_rowstage", K, 64, got)
    assert (nbytes, flops) == (K * 12 + 32 * got + K * 64 * 4 + K * 3 * 64 * 4, 0)


def test_bisect_window_ordered_takes_only_the_window_sums():
    args = [torch.as_tensor(a) for a in _window_inputs(28, ns=8)]
    for body in set(probes.BISECT_BODIES) - set(probes.WINDOW_SUM_BODIES):
        with pytest.raises(ValueError, match="not a window-sum body"):
            probes.bisect_window_ordered(body, *args)


def _mxu_runner(mod, kernel, ns):
    """``mod.run``'s pallas_call at K=16 and ``ns`` samples, in interpret mode."""
    p, c = mod.P, mod.C
    call = pl.pallas_call(
        kernel,
        grid=(K // mod.G,),
        in_specs=[
            pl.BlockSpec((mod.G, ns), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((mod.G, ns), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((mod.G, c, p, p), lambda i: (i, 0, 0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((mod.G, c, ns), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((K, c, ns), jnp.float32),
        interpret=True,
    )

    def run(*args):
        with jax.enable_x64(False):
            return np.asarray(call(*(jnp.asarray(a) for a in args)))

    return run


def _mxu_inputs(seed, ns):
    rng = np.random.default_rng(seed)
    patches = rng.normal(size=(K, 3, 128, 128)).astype(np.float32)
    return rng.integers(0, 128, (K, ns)).astype(np.int32), rng.integers(0, 128, (K, ns)).astype(np.int32), patches


@pytest.mark.parametrize("body", probes.MXU_BODIES)
def test_mxu_plain_matches_exp_r3_mxu_probe(exp, monkeypatch, body):
    """Each body at the script's NS=512; ``'split'`` at NS=128 (the body
    reads the module's NS when traced)."""
    ns = 128 if body == "split" else exp.exp_r3_mxu_probe.NS
    monkeypatch.setattr(exp.exp_r3_mxu_probe, "NS", ns)
    args = _mxu_inputs(9, ns)
    ref = _mxu_runner(exp.exp_r3_mxu_probe, getattr(exp.exp_r3_mxu_probe, f"k_{body}"), ns)(*args)
    got = probes.mxu_plain(body, *(torch.as_tensor(a) for a in args)).numpy()
    if body in probes.SUM_ATOL:
        _close(body, got, ref)
    else:
        np.testing.assert_array_equal(got, ref)


def _row_inputs(seed, k=K, ns=512, p=128):
    """Row-sum inputs whose leader rows (keypoints 0 and 8) leave the patch
    at three samples each; keypoint 3's out-of-range value is never read
    (only a group's first keypoint's rows are)."""
    rng = np.random.default_rng(seed)
    patches = rng.normal(size=(k, 3, p, p)).astype(np.float32)
    rel_x, rel_y = (rng.integers(0, p, (k, ns)).astype(np.int32) for _ in range(2))
    rel_y[0, :3] = [-1, p, 300]
    rel_y[8, 100:103] = [300, -1, p]
    rel_y[3, 7] = -5
    left = np.zeros((k, ns), bool)
    left[0:8, :3] = left[8:16, 100:103] = True
    return rel_x, rel_y, patches, left[:, None, :].repeat(3, axis=1)


def _row_sums_in_order(body, rel_y, patches, g=G):
    """The row-sum kernels' (K, C, NS) output in their order, in NumPy: per
    bf16 value its term (nine adds from 0, or (v + v) + v), one float32 add
    a column for x = 0 .. P - 1, then the leader's rows (0 outside)."""
    k, c, p, _ = patches.shape
    b = _np_bf16(np.ascontiguousarray(patches[:, 0]))
    if body == "dots":
        term = np.zeros_like(b)
        for _ in range(9):
            term = term + b
    else:
        term = (b + b) + b
    tot = np.zeros((k, p), np.float32)
    for x in range(p):
        tot = tot + term[:, :, x]
    rows = rel_y[np.arange(k) // g * g]
    ok = (rows >= 0) & (rows < p)
    vals = np.where(ok, np.take_along_axis(tot, np.clip(rows, 0, p - 1), axis=1), np.float32(0))
    return np.repeat(vals[:, None, :], c, axis=1)


def _mxu_jax(exp, monkeypatch, body, rel_x, rel_y, patches):
    """The JAX body at these inputs' NS and patch side, in interpret mode."""
    mod = exp.exp_r3_mxu_probe
    ns, p = rel_y.shape[1], patches.shape[2]
    monkeypatch.setattr(mod, "NS", ns)
    monkeypatch.setattr(mod, "P", p)
    return _mxu_runner(mod, getattr(mod, f"k_{body}"), ns)(rel_x, rel_y, patches)


@pytest.mark.parametrize("body", probes.ROW_SUM_BODIES)
def test_mxu_plain_zero_where_rows_leave_the_patch(exp, monkeypatch, body):
    """A leader's row outside [0, 128) matches no one-hot column: 0, as in
    the JAX body, bitwise; the other samples within ``SUM_ATOL``; a
    non-leader's out-of-range row changes nothing."""
    rel_x, rel_y, patches, left = _row_inputs(35)
    ref = _mxu_jax(exp, monkeypatch, body, rel_x, rel_y, patches)
    got = probes.mxu_plain(body, *(torch.as_tensor(a) for a in (rel_x, rel_y, patches))).numpy()
    np.testing.assert_array_equal(got.view(np.int32)[left], ref.view(np.int32)[left])
    assert np.all(got[left] == 0)
    _close(body, got[~left], ref[~left])
    rel_y[3, 7] = 5
    again = probes.mxu_plain(body, *(torch.as_tensor(a) for a in (rel_x, rel_y, patches))).numpy()
    np.testing.assert_array_equal(again.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("seed,p", [(31, 128), (32, 128), (33, 128), (34, 64)])
@pytest.mark.parametrize("body", probes.ROW_SUM_BODIES)
def test_mxu_rows_ordered_matches_exp_r3_mxu_probe(exp, monkeypatch, body, seed, p):
    """The row-sum kernels' order mirror: bitwise against the same order
    written in NumPy, within ``SUM_ATOL`` of the JAX body and of
    ``mxu_plain``, 0 where a leader's row leaves the patch.  On the CPU it
    takes any patch side (the kernels only 128)."""
    rel_x, rel_y, patches, left = _row_inputs(seed, p=p)
    targs = [torch.as_tensor(a) for a in (rel_x, rel_y, patches)]
    got = probes.mxu_rows_ordered(body, *targs).numpy()
    want = _row_sums_in_order(body, rel_y, patches)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.all(got.view(np.int32)[left] == 0)
    _close(body, got, _mxu_jax(exp, monkeypatch, body, rel_x, rel_y, patches))
    _close(body, got, probes.mxu_plain(body, *targs).numpy())
    assert torch.equal(probes.MXU[body](*targs), probes.mxu_plain(body, *targs))


def test_mxu_rows_ordered_takes_only_the_row_sums():
    rel_x, rel_y, patches = (torch.as_tensor(a) for a in _mxu_inputs(36, 16))
    with pytest.raises(ValueError, match="not a row-sum body"):
        probes.mxu_rows_ordered("onehot", rel_x, rel_y, patches)


def test_mxu_split_nonfinite_column_zero(exp, monkeypatch):
    """``mxu_plain('split')`` against the JAX ``k_split`` (interpret mode,
    NS=128) with an inf, a -inf or a NaN in column 0 or 1 of a few rows in
    several channels: NaN at the same places (column 0 passes its NaN on
    through ``* 0``), every other output bitwise."""
    rel_x, rel_y, patches = _mxu_inputs(43, 128)
    inf = np.float32(np.inf)
    for k, c, y, x, v in ((0, 0, 3, 0, inf), (1, 1, 5, 1, -inf), (2, 2, 7, 0, np.nan), (3, 0, 9, 1, np.nan),
                          (4, 1, 0, 0, -inf), (12, 2, 127, 1, inf)):
        patches[k, c, y, x] = v
    ref = _mxu_jax(exp, monkeypatch, "split", rel_x, rel_y, patches)
    got = probes.mxu_plain("split", *(torch.as_tensor(a) for a in (rel_x, rel_y, patches))).numpy()
    nan = np.isnan(ref)
    assert nan.sum() == 6 * 3
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.int32)[~nan], ref.view(np.int32)[~nan])


def test_mxu_split_fails_at_its_own_shape(exp):
    mod = exp.exp_r3_mxu_probe
    assert mod.NS > mod.P
    args = _mxu_inputs(10, mod.NS)
    with pytest.raises(TypeError, match="incompatible shapes"):
        _mxu_runner(mod, mod.k_split, mod.NS)(*args)
    with pytest.raises(ValueError, match="exp_r3_mxu_probe.py:108-112"):
        probes.mxu_plain("split", *(torch.as_tensor(a) for a in args))


def test_gather_probe_select_matches(exp):
    """``phase_select``'s body against the patch-form select."""
    mod = exp.exp_r3_gather_probe
    rel_x, rel_y, patches = _mxu_inputs(12, mod.NS)
    ref = _mxu_runner(mod, mod._kern_select, mod.NS)(rel_x, rel_y, patches)
    got = tselect.select_samples_patch(*(torch.as_tensor(a) for a in (patches, rel_x, rel_y))).numpy()
    np.testing.assert_array_equal(got, ref)


def _nested(fn, name):
    """The kernel body defined inside ``fn`` (a closure-free nested def)."""
    code = next(c for c in fn.__code__.co_consts if isinstance(c, types.CodeType) and c.co_name == name)
    return types.FunctionType(code, fn.__globals__)


@pytest.mark.parametrize("phase,axis", [("phase_lane", 1), ("phase_sublane", 0)])
def test_take_along_matches_gather_probe(exp, phase, axis):
    mod = exp.exp_r3_gather_probe
    rng = np.random.default_rng(13)
    x = rng.normal(size=(128, 512)).astype(np.float32)
    idx = rng.integers(0, x.shape[axis], (128, 512)).astype(np.int32)
    call = pl.pallas_call(
        _nested(getattr(mod, phase), "kern"),
        out_shape=jax.ShapeDtypeStruct((128, 512), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    ref = np.asarray(call(jnp.asarray(x), jnp.asarray(idx)))
    got = probes.take_along(torch.as_tensor(x), torch.as_tensor(idx), axis).numpy()
    np.testing.assert_array_equal(got, ref)


def test_trig_probe_matches_pfused_probe(exp):
    x = np.random.default_rng(14).uniform(-7, 7, (8, 128)).astype(np.float32)
    call = pl.pallas_call(
        _nested(exp.exp_r5_pfused.phase_trig, "body"),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True,
    )
    ref = np.asarray(call(jnp.asarray(x)))[:4]
    got = probes.trig_probe(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_cpu_probe_wrappers_launch_nothing():
    wrappers = [probes.take_along, probes.trig_probe, *probes.BISECT.values(), *probes.MXU.values()]
    before = [fn.launches for fn in wrappers]
    args = [torch.as_tensor(a) for a in _window_inputs(15, ns=16)]
    for body, fn in probes.BISECT.items():
        torch.testing.assert_close(fn(*args), probes.bisect_plain(body, *args), rtol=0, atol=0)
    rel_x, rel_y, patches = (torch.as_tensor(a) for a in _mxu_inputs(16, 16))
    for body, fn in probes.MXU.items():
        torch.testing.assert_close(fn(rel_x, rel_y, patches), probes.mxu_plain(body, rel_x, rel_y, patches))
    probes.take_along(patches[0, 0], rel_x[:, :8].contiguous().repeat(8, 1), 1)
    probes.trig_probe(patches[0, 0])
    assert [fn.launches for fn in wrappers] == before


def test_runs_on_the_cpu():
    """The composed runs at toy shapes on the CPU: the selects agree."""
    cpu = torch.device("cpu")
    assert runs.epatch_kernel(cpu, l=3, hp=256, wp=384, k=16, ns=128, iters=1)["equal"]
    assert runs.tiles_kernel(cpu, l=3, hp=256, wp=384, k=16, ns=64, iters=1)["equal"]
    assert runs.select_kernels_run(cpu, k=16, ns=32, n_levels=2, hmax=272, wmax=256, k_check=4)["exact"]
    g = runs.gather_probe_run(cpu, k=8, ns=32)
    assert g["lane"]["exact"] and g["sublane"]["exact"] and g["select"]["exact"]
    assert runs.bisect_run(cpu, k=8, ns=16, n_levels=2, hmax=272, wmax=256)["finite"]
    assert runs.mxu_probe_run(cpu, k=8, ns=32)["finite"]
    trig = runs.trig_run(cpu)
    assert all(trig[f]["bit_equal"] for f in ("atan2", "cos", "sin", "mod"))


# ---------------------------------------------------------------------------
# The kernels, on a card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_cuda_take_along_matches_plain(axis):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(axis)
    x = torch.randn((128, 512), generator=gen, device=dev)
    idx = torch.randint(0, x.shape[axis], (128, 512), generator=gen, device=dev, dtype=torch.int32)
    before = probes.take_along.launches
    got = probes.take_along(x, idx, axis)
    torch.cuda.synchronize()
    assert probes.take_along.launches == before + 1
    assert torch.equal(got, probes.take_along_plain(x, idx, axis))


@pytest.mark.cuda
def test_cuda_trig_probe_bitwise():
    dev = _cuda()
    x = torch.rand((8, 128), generator=torch.Generator(device=dev).manual_seed(0), device=dev) * 14 - 7
    got, ref = probes.trig_probe(x), probes.trig_probe_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("body", probes.BISECT_BODIES)
def test_cuda_bisect_matches_plain(body):
    dev = _cuda()
    args = [torch.as_tensor(a, device=dev) for a in _window_inputs(17)]
    got = probes.BISECT[body](*args)
    ref = probes.bisect_plain(body, *args)
    torch.cuda.synchronize()
    if body in probes.SUM_ATOL:
        torch.testing.assert_close(got, ref, rtol=0, atol=probes.SUM_ATOL[body])
    else:
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unaligned", "aligned", "leaving"])
@pytest.mark.parametrize("body", probes.MATMUL_BODIES)
def test_cuda_bisect_matmul_equals_its_order_mirror(body, case):
    dev = _cuda()
    planes, lvl, y0, x0, rel_y, rel_x = _window_inputs(25)
    if case == "aligned":
        x0 = x0 & ~127
    elif case == "leaving":
        x0[0], y0[1], lvl[2] = 384 - 127, -1, 2
        rel_x[3, :3] = [-1, 128, 500]
    args = [torch.as_tensor(a, device=dev) for a in (planes, lvl, y0, x0, rel_y, rel_x)]
    got = probes.BISECT[body](*args)
    ref = probes.bisect_matmul_ordered(body, *args)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unaligned", "aligned", "leaving"])
@pytest.mark.parametrize("body", probes.WINDOW_SUM_BODIES)
def test_cuda_bisect_window_sums_equal_their_order_mirror(body, case):
    dev = _cuda()
    planes, lvl, y0, x0, rel_y, rel_x = _window_inputs(29, ns=1279)  # a ragged output row: head, quads, tail
    if case == "aligned":
        x0 = x0 & ~127
    elif case == "leaving":
        x0[0], y0[1], lvl[2] = 384 - 127, -1, 2
    args = [torch.as_tensor(a, device=dev) for a in (planes, lvl, y0, x0, rel_y, rel_x)]
    before = probes.BISECT[body].launches
    got = probes.BISECT[body](*args)
    ref = probes.bisect_window_ordered(body, *args)
    torch.cuda.synchronize()
    assert probes.BISECT[body].launches == before + 1
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("body", probes.MXU_BODIES)
def test_cuda_mxu_matches_plain(body):
    dev = _cuda()
    args = [torch.as_tensor(a, device=dev) for a in _mxu_inputs(18, 128 if body == "split" else 512)]
    got = probes.MXU[body](*args)
    ref = probes.mxu_plain(body, *args)
    torch.cuda.synchronize()
    if body in probes.SUM_ATOL:
        torch.testing.assert_close(got, ref, rtol=0, atol=probes.SUM_ATOL[body])
    else:
        assert torch.equal(got, ref)


def _cuda_row_inputs(dev, case):
    """Row-sum inputs on the card: ``exp_r3_mxu_probe.py``'s K=4096, NS=512
    (``'full'``), K=12 (a last group of four), or K=16 with leader rows that
    leave the patch (``'leaving'``)."""
    if case == "leaving":
        return [torch.as_tensor(a, device=dev) for a in _row_inputs(37)[:3]]
    k = 4096 if case == "full" else 12
    gen = torch.Generator(device=dev).manual_seed(38)
    patches = torch.randn((k, 3, 128, 128), generator=gen, device=dev)
    rel_x, rel_y = (torch.randint(0, 128, (k, 512), generator=gen, device=dev, dtype=torch.int32) for _ in range(2))
    return [rel_x, rel_y, patches]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full", "k12", "leaving"])
@pytest.mark.parametrize("body", probes.ROW_SUM_BODIES)
def test_cuda_mxu_row_sums_equal_their_order_mirror(body, case):
    dev = _cuda()
    args = _cuda_row_inputs(dev, case)
    before = probes.MXU[body].launches
    got = probes.MXU[body](*args)
    ref = probes.mxu_rows_ordered(body, *args)
    torch.cuda.synchronize()
    assert probes.MXU[body].launches == before + 1
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("body", probes.ROW_SUM_BODIES)
def test_cuda_mxu_row_sums_reject_other_patch_sides(body):
    dev = _cuda()
    rel_x, rel_y, patches = (torch.as_tensor(a, device=dev) for a in _row_inputs(39, p=64)[:3])
    with pytest.raises(ValueError, match="128x128 patches"):
        probes.MXU[body](rel_x, rel_y, patches)


def _cuda_rowstage_inputs(dev, case):
    """Row-select inputs on the card: ``exp_bisect.py``'s shapes (K=512,
    NS=1280, x0 unaligned or 128-aligned), NS=1279 (rows not 16-byte
    aligned) or ``chip_smoke.bisect_leaving``'s 16 keypoints."""
    import chip_smoke

    from cv_tpu_torch.experiments import runs

    args = runs._window_inputs(dev, 44, 16, 544, 1408, 512, 1280, align_x=case == "aligned")
    if case == "ns1279":
        return [*args[:4], *(t[:, :1279].contiguous() for t in args[4:])]
    if case == "leaving":
        return list(chip_smoke.bisect_leaving(*args))
    return list(args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unaligned", "aligned", "ns1279", "leaving"])
def test_cuda_bisect_rowstage_equals_plain(case):
    """The row select's kernel bitwise equal to ``bisect_plain`` (NaN by its
    bits: the quiet NaN where windows leave, +0 where rows leave)."""
    dev = _cuda()
    args = _cuda_rowstage_inputs(dev, case)
    fn = probes.BISECT["vpu_rowstage"]
    before = fn.launches
    got = fn(*args)
    ref = probes.bisect_plain("vpu_rowstage", *args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _cuda_split_inputs(dev, case):
    """Split inputs on the card: ``exp_r3_mxu_probe.py``'s K=4096 patches at
    NS=128, NS=100, or ``chip_smoke.split_nonfinite``'s 16 keypoints."""
    import chip_smoke

    gen = torch.Generator(device=dev).manual_seed(45)
    patches = torch.randn((4096, 3, 128, 128), generator=gen, device=dev)
    ns = 100 if case == "ns100" else 128
    rel_x, rel_y = (torch.randint(0, 128, (4096, ns), generator=gen, device=dev, dtype=torch.int32) for _ in range(2))
    if case == "nonfinite":
        return list(chip_smoke.split_nonfinite(rel_x, rel_y, patches)[0])
    return [rel_x, rel_y, patches]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full", "ns100", "nonfinite"])
def test_cuda_mxu_split_equals_plain(case):
    """The split select's kernel bitwise equal to ``mxu_plain('split')``, NaN
    by its bits where column 0 or 1 holds an inf or a NaN."""
    dev = _cuda()
    args = _cuda_split_inputs(dev, case)
    fn = probes.MXU["split"]
    before = fn.launches
    got = fn(*args)
    ref = probes.mxu_plain("split", *args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
def test_cuda_mxu_split_rejects_other_channels():
    dev = _cuda()
    rel_x, rel_y, patches = (torch.as_tensor(a, device=dev) for a in _mxu_inputs(46, 128))
    with pytest.raises(ValueError, match="3-channel patches"):
        probes.MXU["split"](rel_x, rel_y, patches[:, :2].contiguous())


@pytest.mark.cuda
def test_cuda_mxu_split_rejects_misaligned_patches():
    dev = _cuda()
    rel_x, rel_y, patches = (torch.as_tensor(a, device=dev) for a in _mxu_inputs(47, 128))
    flat = torch.zeros(patches.numel() + 1, device=dev)
    flat[1:] = patches.reshape(-1)
    shifted = flat[1:].view(patches.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 8 != 0
    with pytest.raises(ValueError, match="8-byte aligned"):
        probes.MXU["split"](rel_x, rel_y, shifted)


@pytest.mark.cuda
def test_cuda_retired_selects_launch_the_select_kernel():
    dev = _cuda()
    args = [torch.as_tensor(a, device=dev) for a in _select_inputs(19, 441, tiles=True)]
    before = tselect.select_samples.launches
    got = mldb_losers.select_samples_tiles8(*args)
    torch.cuda.synchronize()
    assert tselect.select_samples.launches == before + 1
    planes, lvl, ty, tx, rel_x, rel_y = args
    assert torch.equal(got, tselect.select_samples_plain(planes, lvl, 128 * ty, 128 * tx, rel_x, rel_y))


def _ragged_gather(axis, seed, rows=37, cols=130, other=61):
    """``x`` and int32 ``idx`` with ``cols % 4 != 0`` and indices outside
    ``x`` (-1, the axis length, 2^31 - 1) in every row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, other) if axis == 1 else (other, cols)).astype(np.float32)
    idx = rng.integers(0, x.shape[axis], (rows, cols)).astype(np.int32)
    idx[:, 3] = -1
    idx[:, 5] = x.shape[axis]
    idx[::2, 7] = 2**31 - 1
    return x, idx


@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_plain_out_of_range_is_nan(axis):
    x, idx = _ragged_gather(axis, 20 + axis)
    got = probes.take_along(torch.as_tensor(x), torch.as_tensor(idx), axis).numpy()
    ok = (idx >= 0) & (idx < x.shape[axis])
    assert np.isnan(got[~ok]).all() and not np.isnan(got[ok]).any()
    np.testing.assert_array_equal(got[ok], np.take_along_axis(x, np.where(ok, idx, 0), axis)[ok])


def test_kernel_functions_are_bound_once(monkeypatch):
    """``kernels.function`` resolves and types a C function once and hands
    back the same object; the library is loaded once per source."""
    from cv_tpu_torch import kernels

    class FakeFunction:
        def __init__(self):
            self.typed = 0

        def __setattr__(self, name, value):
            if name in ("argtypes", "restype"):
                object.__setattr__(self, "typed", self.typed + 1)
            object.__setattr__(self, name, value)

    class FakeLibrary:
        def __init__(self):
            self.resolved = []

        def __getattr__(self, symbol):
            self.resolved.append(symbol)
            return FakeFunction()

    lib = FakeLibrary()
    loads = []
    monkeypatch.setattr(kernels, "_FUNCTIONS", {})
    monkeypatch.setattr(kernels, "load", lambda name: loads.append(name) or lib)
    argtypes = [kernels.ctypes.c_void_p, kernels.ctypes.c_int]
    first = kernels.function("take_along", "cv_take_along", argtypes)
    for _ in range(3):
        assert kernels.function("take_along", "cv_take_along", argtypes) is first
    assert lib.resolved == ["cv_take_along"] and loads == ["take_along"]
    assert first.typed == 2 and first.argtypes == argtypes and first.restype is kernels.ctypes.c_int
    other = kernels.function("trig_probe", "cv_trig_probe", argtypes)
    assert other is not first and lib.resolved == ["cv_take_along", "cv_trig_probe"]


def test_take_along_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 8))
    idx = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="axis"):
        probes.take_along(x, idx, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        probes.take_along(x.to("meta"), idx.to("meta"), 1)
    with pytest.raises(ValueError, match="several devices"):
        probes.take_along(x, idx.to("meta"), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("layout", ["ragged", "misaligned"])
def test_cuda_take_along_ragged_and_out_of_range(axis, layout):
    """The kernel's scalar paths (``cols % 4 != 0``, or ``idx`` not on a
    16-byte boundary) with out-of-range indices: bitwise equal to the plain
    version (NaN there) and to ``torch.take_along_dim`` where in range."""
    dev = _cuda()
    x_np, idx_np = _ragged_gather(axis, 30 + axis, cols=130 if layout == "ragged" else 128)
    x = torch.as_tensor(x_np, device=dev)
    idx = torch.as_tensor(idx_np, device=dev)
    if layout == "misaligned":
        flat = torch.zeros(idx.numel() + 1, dtype=torch.int32, device=dev)
        flat[1:] = idx.reshape(-1)
        idx = flat[1:].view(idx.shape)
        assert idx.is_contiguous() and idx.data_ptr() % 16 != 0
    before = probes.take_along.launches
    got = probes.take_along(x, idx, axis)
    ref = probes.take_along_plain(x, idx, axis)
    torch.cuda.synchronize()
    assert probes.take_along.launches == before + 1
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    ok = (idx >= 0) & (idx < x.shape[axis])
    lib = torch.take_along_dim(x, torch.where(ok, idx, 0).long(), dim=axis)
    assert torch.equal(got[ok], lib[ok]) and bool(got[~ok].isnan().all())


@pytest.mark.cuda
@pytest.mark.parametrize("x_shape,idx_shape", [((1, 130), (5, 130)), ((2, 1), (7, 1))])
def test_cuda_take_along_thin_x_on_axis_0(x_shape, idx_shape):
    """One or two rows of ``x`` on axis 0 with a width that is not a
    multiple of 4: the lanes past a row's end read nothing (a read there
    would fall outside ``x``); bitwise equal to the plain version."""
    dev = _cuda()
    rng = np.random.default_rng(40 + x_shape[1])
    x = torch.as_tensor(rng.normal(size=x_shape).astype(np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(-1, x_shape[0] + 1, idx_shape).astype(np.int32), device=dev)
    got = probes.take_along(x, idx, 0)
    ref = probes.take_along_plain(x, idx, 0)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
