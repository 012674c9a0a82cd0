"""The describe stage's other modes: cv_tpu_torch's group tables, group
select, patch-form select and fused describe against cv_tpu's, with the
Pallas kernels in interpret mode (as tests/test_pallas_mldb.py runs them),
and the describe-mode rule.

Tables and selects are exact, so they are held bitwise.  The describes
are held to cv_tpu's under the describe gates: ok flags equal, angles
within 1e-4 rad, at least 99% of word rows bitwise equal and none more
than 16 of 486 bits off; the orientation window sums run in torch's and
XLA's own orders (measured here: angles within 4.8e-7 rad, every word row
equal).  Against the port's own select-kernel describe, ``'pallas'`` and
``'pfused'`` are held bitwise (on the CPU they run the same plain code on
the same batch); the group describe is held to 1e-6 rad, because on the
CPU torch's vectorized atan2 and its scalar tail loop round differently,
so a keypoint's place in the batch can move an angle by one ulp (measured:
two angles of 44 one ulp apart, every word row equal).

The kernels themselves run only on a CUDA card; the tests marked ``cuda``
hold them to their plain versions there and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.akaze import descriptors as jdesc
from cv_tpu.akaze import pallas_mldb
from cv_tpu_torch.akaze import DeviceExtractor, fast
from cv_tpu_torch.akaze import descriptors as tdesc
from cv_tpu_torch.akaze import extrema as textrema
from cv_tpu_torch.akaze import fused as tfused
from cv_tpu_torch.akaze import select as tselect

G = 8


def _keypoints(seed, k, n_levels, hp, wp, valid_share=0.8, cluster=False):
    """Keypoint slots on an (n_levels, 3, hp, wp) stack; ``cluster`` puts
    most of them in a few windows, so segments run longer than 8."""
    rng = np.random.default_rng(seed)
    lvl = rng.integers(0, n_levels, k).astype(np.int32)
    if cluster:
        lvl[: k // 2] = 1
        xf = np.where(np.arange(k) < k // 2, rng.uniform(70, 120, k), rng.uniform(0, wp, k))
        yf = np.where(np.arange(k) < k // 2, rng.uniform(70, 120, k), rng.uniform(0, hp, k))
    else:
        xf = rng.uniform(0, wp, k)
        yf = rng.uniform(0, hp, k)
    valid = rng.uniform(size=k) < valid_share
    return lvl, xf.astype(np.float32), yf.astype(np.float32), valid


def _windows(xf, yf, hp, wp):
    """The tile of the 256x256 window of each slot, as both packages compute it."""
    ht, wt = hp // 128, wp // 128
    y0 = np.clip(yf.astype(np.int32) - 64, 0, hp - 128)
    x0 = np.clip(xf.astype(np.int32) - 64, 0, wp - 128)
    return np.clip(y0 // 128, 0, ht - 2).astype(np.int32), np.clip(x0 // 128, 0, wt - 2).astype(np.int32)


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("seed,cluster", [(0, False), (1, True), (2, True)])
def test_group_tables_equal(seed, cluster, w):
    n_levels, hp, wp, k = 6, 512, 640, 200
    lvl, xf, yf, valid = _keypoints(seed, k, n_levels, hp, wp, cluster=cluster)
    ty, tx = _windows(xf, yf, hp, wp)
    ht, wt = hp // 128, wp // 128
    ng_cap = -(-k // G) + n_levels * (ht - 1) * (wt - 1) + 1
    ref = jdesc._group_tables(
        jnp.asarray(lvl), jnp.asarray(ty), jnp.asarray(tx), jnp.asarray(valid), ht, wt, G, ng_cap, w
    )
    got = tdesc.group_tables(
        torch.as_tensor(lvl), torch.as_tensor(ty), torch.as_tensor(tx), torch.as_tensor(valid),
        n_levels, ht, wt, G, ng_cap, w,
    )
    names = ("perm", "win_lvl", "win_ty", "win_tx", "n_active", "src_of", "p_of")
    for name, r, t in zip(names, ref, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r), err_msg=name)
    n_active = got[4].numpy()
    assert n_active.sum() == valid.sum()
    if cluster:  # a window holds more than 8 slots: its segment spans groups
        keys = (lvl * ht + ty) * wt + tx
        assert np.bincount(keys[valid]).max() > G


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("c0", [0, 1])
def test_select_groups_plain_matches_pallas(w, c0):
    """The shapes of tests/test_pallas_mldb.py::test_select_groups_matches_gather."""
    rng = np.random.default_rng(17 + w + c0)
    l, c, ng, ns = 4, 3, 12, 128
    hp = wp = 384
    planes = rng.normal(size=(l, c, hp, wp)).astype(np.float32)
    win_lvl = rng.integers(0, l, ng).astype(np.int32)
    win_ty = rng.integers(0, 2, ng).astype(np.int32)
    win_tx = rng.integers(0, 2, ng).astype(np.int32)
    n_active = rng.integers(0, G + 1, ng).astype(np.int32)
    n_active[:2] = (0, G)
    rel_x = rng.integers(0, 256, (ng // w, w * G, ns)).astype(np.int32)
    rel_y = rng.integers(0, 256, (ng // w, w * G, ns)).astype(np.int32)
    args = (planes, win_lvl, win_ty, win_tx, n_active, rel_x, rel_y)
    ref = np.asarray(
        pallas_mldb.select_samples_groups(*(jnp.asarray(a) for a in args), interpret=True, c0=c0, w=w)
    )
    got = tselect.select_groups_plain(*(torch.as_tensor(a) for a in args), c0=c0).numpy()
    assert got.shape == ref.shape == (ng * G, c - c0, ns)
    np.testing.assert_array_equal(got, ref)
    live = np.arange(G)[None, :] < n_active[:, None]
    assert (got.reshape(ng, G, c - c0, ns)[~live] == 0).all()


@pytest.mark.parametrize("fn", [pallas_mldb.select_samples, pallas_mldb.select_samples_batched])
def test_select_samples_patch_matches_pallas(fn):
    rng = np.random.default_rng(5)
    k, c, ns = 16, 3, 128
    patches = rng.normal(size=(k, c, 128, 128)).astype(np.float32)
    rel_x = rng.integers(0, 128, (k, ns)).astype(np.int32)
    rel_y = rng.integers(0, 128, (k, ns)).astype(np.int32)
    ref = np.asarray(fn(jnp.asarray(patches), jnp.asarray(rel_x), jnp.asarray(rel_y), interpret=True))
    got = tselect.select_samples_patch(*(torch.as_tensor(a) for a in (patches, rel_x, rel_y))).numpy()
    np.testing.assert_array_equal(got, ref)
    # The orientation pass selects channels 1: of the same patches.
    got1 = tselect.select_samples_patch(*(torch.as_tensor(a) for a in (patches, rel_x, rel_y)), c0=1).numpy()
    np.testing.assert_array_equal(got1, ref[:, 1:])


def test_cut_patches():
    rng = np.random.default_rng(2)
    planes = rng.normal(size=(3, 3, 256, 384)).astype(np.float32)
    lvl, y0, x0 = np.array([0, 2, 1], np.int32), np.array([0, 128, 40], np.int32), np.array([256, 0, 77], np.int32)
    got = tselect.cut_patches(*(torch.as_tensor(a) for a in (planes, lvl, y0, x0))).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], planes[lvl[i], :, y0[i]:y0[i] + 128, x0[i]:x0[i] + 128])


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors every wrapper runs its plain version and counts no launch."""
    counters = (tselect.select_groups, tselect.select_samples, tfused.select_fused, textrema.dedup_scan_device)
    before = [fn.launches for fn in counters]
    rng = np.random.default_rng(1)
    planes = torch.as_tensor(rng.normal(size=(2, 3, 256, 256)).astype(np.float32))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))  # noqa: E731
    rel = i32(rng.integers(0, 256, (G, 5)))
    torch.testing.assert_close(
        tselect.select_groups(planes, i32([1]), i32([0]), i32([0]), i32([3]), rel, rel),
        tselect.select_groups_plain(planes, i32([1]), i32([0]), i32([0]), i32([3]), rel, rel), rtol=0, atol=0,
    )
    tselect.select_samples_patch(planes[:, :, :128, :128].contiguous(), rel[:2] // 2, rel[:2] // 2)
    orel = i32(rng.integers(0, 128, (2, 109)))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    kp = (planes, i32([0, 1]), i32([0, 64]), i32([0, 100]), orel, orel, f32([60, 170]), f32([70, 130]),
          f32([1, 2]), i32([256, 250]), i32([256, 240]))
    for a, b in zip(tfused.select_fused(*kp), tfused.select_fused_plain(*kp)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    z = torch.zeros((1, 4))
    textrema.dedup_scan_device(z, z, z, z, z + 1, z.long(), z + 1, z > -1, torch.tensor([4]))
    assert [fn.launches for fn in counters] == before


def _describe_gates(w_t, ok_t, a_t, w_j, ok_j, a_j, angle_tol=1e-4):
    """The describe gates between two describes' outputs."""
    np.testing.assert_array_equal(ok_t, ok_j)
    da = np.abs(a_t - a_j)
    assert np.minimum(da, 2 * np.pi - da).max() < angle_tol
    w_t, w_j = w_t.view(np.uint32), w_j.view(np.uint32)
    assert (w_t == w_j).all(axis=1).mean() >= 0.99
    assert np.unpackbits((w_t ^ w_j).view(np.uint8), axis=1).sum(axis=1).max() <= 16


def _describe_inputs(seed, n_levels, hp, wp, k):
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(n_levels, 3, hp, wp)).astype(np.float32)
    lvl = rng.integers(0, n_levels, k).astype(np.int32)
    width = np.where(lvl % 2, wp - 40, wp).astype(np.int32)
    height = np.where(lvl % 2, hp - 30, hp).astype(np.int32)
    xf = (rng.uniform(0, 1, k) * width).astype(np.float32)
    yf = (rng.uniform(0, 1, k) * height).astype(np.float32)
    scale = rng.integers(1, 4, k).astype(np.float32)
    return planes, lvl, width, height, xf, yf, scale


@pytest.mark.parametrize("w", [1, 4])
def test_orient_mldb_groups_matches_cv_tpu(w):
    """The group describe on one plane stack, against cv_tpu's (Pallas in
    interpret mode), on the valid slots; and against the port's own
    select-kernel describe."""
    n_levels, hp, wp, k = 4, 256, 384, 61  # K not a multiple of 8: padded
    args = _describe_inputs(23, n_levels, hp, wp, k)
    valid = np.random.default_rng(4).uniform(size=k) < 0.8
    ng_cap = -(-k // G) + n_levels * (hp // 128 - 1) * (wp // 128 - 1) + 1
    w_j, ok_j, a_j = (
        np.asarray(x)
        for x in jdesc.orient_mldb_groups(
            *(jnp.asarray(a) for a in args), jnp.asarray(valid), pattern_size=10, ng_cap=ng_cap, w=w
        )
    )
    targs = [torch.as_tensor(a) for a in args]
    w_t, ok_t, a_t = tdesc.orient_mldb_groups(*targs, torch.as_tensor(valid), pattern_size=10, ng_cap=ng_cap, w=w)
    assert 0 < ok_j[valid].sum() < valid.sum()  # in-bounds and border keypoints
    _describe_gates(w_t.numpy()[valid], ok_t.numpy()[valid], a_t.numpy()[valid],
                    w_j[valid], ok_j[valid], a_j[valid])
    w_g, ok_g, a_g = (x.numpy()[valid] for x in tdesc.orient_mldb(*targs, pattern_size=10))
    _describe_gates(w_t.numpy()[valid], ok_t.numpy()[valid], a_t.numpy()[valid], w_g, ok_g, a_g, 1e-6)


@pytest.mark.parametrize("mode", ["pallas", "pfused"])
def test_patch_and_fused_modes_match_cv_tpu(mode):
    """``'pallas'`` and ``'pfused'`` against cv_tpu's modes of the same name
    (Pallas in interpret mode), on every slot."""
    args = _describe_inputs(29, 3, 256, 256, 32)
    w_j, ok_j, a_j = (
        np.asarray(x)
        for x in jdesc.orient_mldb_onehot(*(jnp.asarray(a) for a in args), pattern_size=10, chunk=16, mode=mode)
    )
    targs = [torch.as_tensor(a) for a in args]
    if mode == "pfused":
        w_t, ok_t, a_t = tfused.orient_mldb_fused(*targs, pattern_size=10)
    else:
        w_t, ok_t, a_t = tdesc.orient_mldb(*targs, pattern_size=10, mode=mode)
    assert 0 < ok_j.sum() < len(ok_j)
    _describe_gates(w_t.numpy(), ok_t.numpy(), a_t.numpy(), w_j, ok_j, a_j)
    w_g, ok_g, a_g = tdesc.orient_mldb(*targs, pattern_size=10)
    for got, want in ((w_t, w_g), (ok_t, ok_g), (a_t, a_g)):
        assert torch.equal(got, want)


def test_select_fused_plain_meta():
    """The fused plain version's meta rows: the describe's angle, its cos
    and sin, and the bounds flag."""
    planes, lvl, width, height, xf, yf, scale = (
        torch.as_tensor(a) for a in _describe_inputs(31, 3, 256, 256, 24)
    )
    words, ok, angle = tdesc.orient_mldb(planes, lvl, width, height, xf, yf, scale)
    y0, x0 = tdesc.patch_anchor(xf, yf, 256, 256)
    orel = tdesc.orientation_offsets(xf, yf, scale, width, height, x0, y0, 128)
    vals, meta = tfused.select_fused_plain(planes, lvl, y0, x0, *orel, xf, yf, scale, width, height)
    assert vals.shape == (24, 3, 441) and meta.shape == (24, 4)
    torch.testing.assert_close(meta[:, 0], angle, rtol=0, atol=0)
    torch.testing.assert_close(meta[:, 1], torch.cos(angle), rtol=0, atol=0)
    torch.testing.assert_close(meta[:, 2], torch.sin(angle), rtol=0, atol=0)
    assert torch.equal(meta[:, 3] > 0.5, ok)


@pytest.mark.parametrize("mode", ["highest", "bf16x3", "bf16x3k", "pgather+inter", "highest+fused"])
def test_xla_only_modes_raise(mode):
    with pytest.raises(ValueError, match="XLA-only"):
        DeviceExtractor(device="cpu", onehot_mode=mode)


@pytest.mark.parametrize("mode", ["ptiles8", "pgroups0", "gather"])
def test_unknown_modes_raise(mode):
    with pytest.raises(ValueError, match="unknown describe mode"):
        DeviceExtractor(device="cpu", onehot_mode=mode)


@pytest.mark.parametrize("mode", ["pepatch", "ptiles"])
def test_retired_modes_raise_until_registered(monkeypatch, mode):
    """The retired modes are accepted by name but their describe lives in
    cv_tpu_torch/experiments/mldb_losers.py: unregistered, an extract raises
    ``KeyError`` naming that module."""
    monkeypatch.delitem(tdesc.EXTERNAL_MODES, mode, raising=False)
    img = np.random.default_rng(6).uniform(0, 1, (128, 160)).astype(np.float32)
    ex = DeviceExtractor(candidate_budget=64, max_features=128, device="cpu", onehot_mode=mode)
    with pytest.raises(KeyError, match="cv_tpu_torch/experiments/mldb_losers.py"):
        ex.extract(img[None])


@pytest.mark.parametrize("mode", ["pgather", "pgroups", "pgroups4", "pfused", "pallas", "pepatch", "ptiles"])
def test_kernel_modes_accepted(mode):
    assert DeviceExtractor(device="cpu", onehot_mode=mode).describe_mode(100, 100) == mode


def test_default_mode_rule():
    big = DeviceExtractor(max_features=2048, device="cpu")
    assert big.describe_mode(512, 1392) == "pgroups"
    assert big.describe_mode(200, 1392) == "pgroups"  # padded to 256 rows
    assert big.describe_mode(128, 1392) == "pgather"  # no 256x256 window
    assert big.describe_mode(512, 100) == "pgather"
    assert DeviceExtractor(max_features=2047, device="cpu").describe_mode(512, 1392) == "pgather"


def test_explicit_pgroups_on_small_stack_raises():
    """An explicit group describe on a stack with no 256x256 window raises
    (cv_tpu asserts at descriptors.py:623); the default takes 'pgather'."""
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 1, (96, 200)).astype(np.float32)
    with pytest.raises(ValueError, match="descriptors.py:623"):
        DeviceExtractor(candidate_budget=64, max_features=2048, device="cpu", onehot_mode="pgroups").extract(img[None])
    ex = DeviceExtractor(candidate_budget=64, max_features=2048, device="cpu")
    assert ex.describe_mode(96, 200) == "pgather"
    fs = ex.extract(img[None])
    assert fs.words.shape[0] == 1 and fs.words.shape[-1] == 16 and fs.valid.any()


def test_window_catalog_size_equal():
    from cv_tpu.akaze import Akaze as JAkaze
    from cv_tpu.akaze.config import allocate_evolutions as j_alloc

    from cv_tpu_torch.akaze import Akaze, allocate_evolutions

    for h, w in ((512, 1392), (256, 384), (200, 300)):
        hp, wp = fast.padded_shape(h, w)
        ref = jdesc.window_catalog_size(j_alloc(JAkaze(), w, h), 2, hp, wp)
        assert tdesc.window_catalog_size(allocate_evolutions(Akaze(), w, h), 2, hp, wp) == ref


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("c0,ns", [(1, 109), (0, 441)])
def test_cuda_select_groups_matches_plain(w, c0, ns):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the group select kernel runs only there")
    n_levels, hp, wp, k = 26, 512, 1408, 8192
    lvl, xf, yf, valid = _keypoints(3, k, n_levels, hp, wp)
    ty, tx = _windows(xf, yf, hp, wp)
    ht, wt = hp // 128, wp // 128
    ng_cap = -(-k // G) + n_levels * (ht - 1) * (wt - 1) + 1
    dev = torch.device("cuda")
    tables = tdesc.group_tables(*(torch.as_tensor(a, device=dev) for a in (lvl, ty, tx, valid)),
                                n_levels, ht, wt, G, ng_cap, w)
    ng = tables[1].shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    planes = torch.randn((n_levels, 3, hp, wp), generator=gen, device=dev)
    rel = [torch.randint(0, 256, (ng * G, ns), generator=gen, device=dev, dtype=torch.int32) for _ in range(2)]
    before = tselect.select_groups.launches
    got = tselect.select_groups(planes, *tables[1:5], *rel, c0=c0)
    torch.cuda.synchronize()
    assert tselect.select_groups.launches == before + 1
    torch.testing.assert_close(got, tselect.select_groups_plain(planes, *tables[1:5], *rel, c0=c0), rtol=0, atol=0)
