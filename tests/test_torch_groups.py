"""The describe stage's other modes: cv_tpu_torch's group tables, group
select, patch-form select and fused describe against cv_tpu's, with the
Pallas kernels in interpret mode (as tests/test_pallas_mldb.py runs them),
and the describe-mode rule.

Tables and selects are exact, so they are held bitwise.  The describes
are held to cv_tpu's under the describe gates: ok flags equal, angles
within 1e-4 rad, at least 99% of word rows bitwise equal and none more
than 16 of 486 bits off; the orientation window sums run in torch's and
XLA's own orders (measured here: angles within 4.8e-7 rad, every word row
equal).  Against the port's own select-kernel describe, ``'pallas'``,
``'pfused'`` and the group describe are held bitwise: on the CPU they run
the same plain code, and the angles' atan2, cos and sin
(``cv_tpu_torch.ops.trig``) give an element the same bits at any place in
any batch.

The kernels themselves run only on a CUDA card; the tests marked ``cuda``
hold them to their plain versions there and skip here.  What of the fused
describe kernel's arithmetic can be held here is held on NumPy models of
its rules: a window's sum as ``csrc/select_fused.cu`` forms it across a
warp's lanes, bitwise to ``descriptors.tree_sum``; its first-max scan, to
``_orientation_from_samples``; its angle wrap, to ``torch.remainder``.
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
from cv_tpu_torch.ops import trig
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)

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
    for got, want in ((w_t, w_g), (ok_t, ok_g), (a_t, a_g)):
        np.testing.assert_array_equal(got.numpy()[valid], want)
    np.testing.assert_array_equal(a_t.numpy()[valid].view(np.uint32), a_g.view(np.uint32))


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
    torch.testing.assert_close(meta[:, 1], trig.cos_f32(angle), rtol=0, atol=0)
    torch.testing.assert_close(meta[:, 2], trig.sin_f32(angle), rtol=0, atol=0)
    assert torch.equal(meta[:, 3] > 0.5, ok)


@pytest.mark.parametrize("mode", ["highest", "bf16x3", "bf16x3k", "pfused+inter", "pgroups+inter", "highest+fused"])
def test_xla_only_modes_raise(mode):
    """cv_tpu's XLA-only describe modes: ``'highest'`` is ported (a float32
    one-hot product, held to cv_tpu's in test_torch_extract.py); its TPU
    matrix-unit workarounds raise, and so does ``'+inter'`` on the kernel
    modes where cv_tpu fails (``'pfused'``, ``'pgroups'``; ``'pgather+inter'``
    and ``'pallas+inter'`` are ported, tests/test_torch_inter.py)."""
    if mode == "highest":
        assert DeviceExtractor(device="cpu", onehot_mode=mode).describe_mode(256, 256) == "highest"
        return
    with pytest.raises(ValueError, match="not ported"):
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


@pytest.mark.parametrize("mode", ["pgather", "pgroups", "pgroups4", "pfused", "pallas", "pepatch", "ptiles",
                                  "pgather+inter", "pallas+inter"])
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


def _warp_tree_sums(rows):
    """``csrc/select_fused.cu``'s window sum as a NumPy model: each row
    (float32, at most 128 samples) zero-padded to 128; lane ``l`` holds
    samples ``l, l+32, l+64, l+96`` and forms ``(v[l] + v[l+64]) + (v[l+32]
    + v[l+96])``; then five butterfly steps in which lane ``l`` adds lane
    ``l ^ d``'s partial sum, ``d`` = 16, 8, 4, 2, 1.  Returns every lane's
    sum, (N, 32) float32."""
    v = np.zeros((rows.shape[0], 128), np.float32)
    v[:, : rows.shape[1]] = rows
    lane = v.reshape(-1, 4, 32)  # lane[:, i, l] = v[l + 32 i]
    s = (lane[:, 0] + lane[:, 2]) + (lane[:, 1] + lane[:, 3])
    for d in (16, 8, 4, 2, 1):
        s = s + s[:, np.arange(32) ^ d]
    return s


def _tree_rows(case, seed=0, n=256, no=109):
    """Rows of orientation samples: normal values; magnitudes from 1e-38
    (denormals) to 1e30 of both signs; signed zeros; one live sample in a
    row of zeros."""
    rng = np.random.default_rng(seed)
    if case == "normal":
        return rng.normal(size=(n, no)).astype(np.float32)
    if case == "magnitudes":
        mag = 10.0 ** rng.uniform(-45, 30, (n, no))
        return (rng.choice([-1.0, 1.0], (n, no)) * mag).astype(np.float32)
    if case == "signed_zeros":
        rows = rng.choice(np.array([0.0, -0.0, 1e-3, -1e-3], np.float32), (n, no))
        rows[: n // 2] = np.where(rng.uniform(size=(n // 2, no)) < 0.5, np.float32(-0.0), np.float32(0.0))
        return rows
    rows = np.zeros((n, no), np.float32)
    rows[np.arange(n), rng.integers(0, no, n)] = rng.normal(size=n).astype(np.float32)
    if case == "one_negative_zero":
        rows[:] = np.float32(-0.0)
    return rows


@pytest.mark.parametrize("case", ["normal", "magnitudes", "signed_zeros", "one_live", "one_negative_zero"])
def test_warp_tree_sum_is_tree_sum(case):
    """Every lane of the fused kernel's window sum ends with the bits of
    ``descriptors.tree_sum`` (signed zeros and denormals included)."""
    rows = _tree_rows(case)
    lanes = _warp_tree_sums(rows)
    want = tdesc.tree_sum(torch.as_tensor(rows)).numpy()
    np.testing.assert_array_equal(lanes.view(np.uint32), np.repeat(want.view(np.uint32)[:, None], 32, axis=1))


def test_angle_wrap_fast_path():
    """The fused kernel wraps ``atan2 + 2pi`` (in [pi, 3pi]) into [0, 2pi)
    as ``a - 2pi if a >= 2pi else a`` (exact there, Sterbenz) instead of
    ``fmodf``: bitwise ``torch.remainder`` on every float32 of [pi, 3pi]
    near 2pi and on a million more spread over the range."""
    two_pi = np.float32(tdesc.TWO_PI)
    near = two_pi.view(np.int32) + np.arange(-50_000, 50_001, dtype=np.int32)
    spread = np.random.default_rng(0).uniform(np.pi, 3 * np.pi, 1_000_000).astype(np.float32)
    a = np.concatenate([near.view(np.float32), spread, np.float32([np.pi, 3 * np.pi])])
    got = np.where(a >= two_pi, a - two_pi, a)
    want = torch.remainder(torch.as_tensor(a), float(two_pi)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _warp_orientation(res_x, res_y):
    """The fused kernel's steps 2-3 as a model on (K, 109) float32 weighted
    samples: per window the masked rows summed by :func:`_warp_tree_sums`,
    ``val = sx * sx + sy * sy``, then the scan ``w == 0 or val > top`` over
    the windows in order, the angle of the chosen sums, 0 unless ``top >
    0``.  Returns ``(angle, chosen window)``."""
    t = tdesc._orientation_device_tables(torch.device("cpu"))
    ang = trig.angle_cv(torch.as_tensor(res_y), torch.as_tensor(res_x)).numpy()[:, None, :]
    a1, a2 = t["ang1s"].numpy()[None, :, None], t["ang2s"].numpy()[None, :, None]
    two_pi = np.float32(tdesc.TWO_PI)
    inw = ((a1 < a2) & (a1 < ang) & (ang < a2)) | (
        (a2 < a1) & (((ang > 0) & (ang < a2)) | ((ang > a1) & (ang < two_pi)))
    )
    k, nw = res_x.shape[0], a1.shape[1]
    sx = _warp_tree_sums(np.where(inw, res_x[:, None, :], np.float32(0)).reshape(k * nw, -1))[:, 0].reshape(k, nw)
    sy = _warp_tree_sums(np.where(inw, res_y[:, None, :], np.float32(0)).reshape(k * nw, -1))[:, 0].reshape(k, nw)
    val = sx * sx + sy * sy
    top, best = val[:, 0].copy(), np.zeros(k, np.int64)
    for w in range(1, nw):
        up = val[:, w] > top
        top, best = np.where(up, val[:, w], top), np.where(up, w, best)
    rows = np.arange(k)
    angle = trig.angle_cv(torch.as_tensor(sy[rows, best]), torch.as_tensor(sx[rows, best]))
    return torch.where(torch.as_tensor(top > 0), angle, torch.zeros(())).numpy(), best


def _orientation_rows(case, seed=1, k=96, no=109):
    """Weighted orientation samples: normal; two samples of equal norm,
    (-4, 3) and (-3, -4), in windows that never hold both (first held by
    windows 10 and 21), so windows tie and the first must win; a single
    sample, so every window holding it ties; all zeros, so no ``val`` is
    above 0."""
    rng = np.random.default_rng(seed)
    if case == "normal":
        return rng.normal(size=(k, no)).astype(np.float32), rng.normal(size=(k, no)).astype(np.float32)
    rx, ry = np.zeros((k, no), np.float32), np.zeros((k, no), np.float32)
    rows = np.arange(k)
    if case == "tied_pair":
        i, j = rng.integers(0, no, k), rng.integers(0, no, k)
        j = np.where(j == i, (i + 1) % no, j)
        rx[rows, i], ry[rows, i] = -4.0, 3.0
        rx[rows, j], ry[rows, j] = -3.0, -4.0
    elif case == "one_sample":
        i = rng.integers(0, no, k)
        rx[rows, i], ry[rows, i] = rng.normal(size=k).astype(np.float32), rng.normal(size=k).astype(np.float32)
    return rx, ry


@pytest.mark.parametrize("case", ["normal", "tied_pair", "one_sample", "zeros"])
def test_warp_first_max_matches_orientation(case):
    """The fused kernel's first-max scan chooses the window, and gives the
    angle, of ``_orientation_from_samples`` (``torch.argmax``'s first
    maximum; angle 0 when no window's ``val`` is above 0)."""
    rx, ry = _orientation_rows(case)
    angle, best = _warp_orientation(rx, ry)
    want = tdesc._orientation_from_samples(torch.as_tensor(rx), torch.as_tensor(ry)).numpy()
    np.testing.assert_array_equal(angle.view(np.uint32), want.view(np.uint32))
    if case == "zeros":
        assert (best == 0).all() and (angle == 0).all()
    if case == "tied_pair":  # the (-4, 3) and (-3, -4) windows tie: the lower index wins
        assert (best == 10).all()
        np.testing.assert_allclose(angle, np.arctan2(3, -4), rtol=0, atol=1e-6)


def _slot_offsets(n_levels, hp, wp, k, w, scale, seed=3):
    """Group tables and the two passes' offsets of ``k`` keypoint slots at
    ``scale`` (as ``orient_mldb_groups`` builds them, with random angles;
    about 20% of the slots dead, so groups with dead slots and empty groups
    both occur), on the CPU: ``(tables, (orel_x, orel_y), (rel_x,
    rel_y))``."""
    lvl, xf, yf, valid = _keypoints(seed, k, n_levels, hp, wp)
    ht, wt = hp // 128, wp // 128
    ng_cap = -(-k // G) + n_levels * (ht - 1) * (wt - 1) + 1
    xf_t, yf_t = torch.as_tensor(xf), torch.as_tensor(yf)
    y0, x0 = tdesc.patch_anchor(xf_t, yf_t, hp, wp)
    ty, tx = torch.clamp(y0 // 128, 0, ht - 2), torch.clamp(x0 // 128, 0, wt - 2)
    perm, *tables, src_of, _ = tdesc.group_tables(torch.as_tensor(lvl), ty, tx, torch.as_tensor(valid),
                                                  n_levels, ht, wt, G, ng_cap, w)
    osrc = perm[src_of]
    n = osrc.shape[0]
    xf_p, yf_p = xf_t[osrc], yf_t[osrc]
    sc = torch.full((n,), float(scale))
    width, height = torch.full((n,), wp - 16, dtype=torch.int32), torch.full((n,), hp, dtype=torch.int32)
    x0_p, y0_p = tables[2].repeat_interleave(G) * 128, tables[1].repeat_interleave(G) * 128
    orel = tdesc.orientation_offsets(xf_p, yf_p, sc, width, height, x0_p, y0_p, 256)
    angle = torch.as_tensor(np.random.default_rng(seed).uniform(0, 2 * np.pi, n).astype(np.float32))
    rel = tdesc.mldb_offsets(xf_p, yf_p, sc, angle, width, height, x0_p, y0_p, 256)[:2]
    return tables, orel, rel


def test_slot_offsets_layout():
    """The cuda tests' slot layout holds empty groups, groups with dead
    slots and full groups, and its offsets stay inside the 256x256 window."""
    tables, orel, rel = _slot_offsets(6, 512, 640, 400, 1, 6)
    n_active = tables[3].numpy()
    assert (n_active == 0).any() and ((n_active > 0) & (n_active < G)).any() and (n_active == G).any()
    for t in (*orel, *rel):
        assert t.dtype == torch.int32 and int(t.min()) >= 0 and int(t.max()) < 256


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("c0,ns", [(1, 109), (0, 441)])
@pytest.mark.parametrize("scale", [None, 1, 2, 4, 6])
def test_cuda_select_groups_matches_plain(w, c0, ns, scale):
    """The group select bitwise to its plain version on the card: random
    offsets over the window (``scale`` None) and a keypoint's own offsets at
    ``scale`` (orientation disc for ``c0 = 1``, M-LDB grid for ``c0 = 0``),
    with empty groups and dead slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the group select kernel runs only there")
    n_levels, hp, wp, k = 26, 512, 1408, 8192
    dev = torch.device("cuda")
    if scale is None:
        lvl, xf, yf, valid = _keypoints(3, k, n_levels, hp, wp)
        ty, tx = _windows(xf, yf, hp, wp)
        ht, wt = hp // 128, wp // 128
        ng_cap = -(-k // G) + n_levels * (ht - 1) * (wt - 1) + 1
        tables = tdesc.group_tables(*(torch.as_tensor(a, device=dev) for a in (lvl, ty, tx, valid)),
                                    n_levels, ht, wt, G, ng_cap, w)[1:5]
        ng = tables[0].shape[0]
        gen = torch.Generator(device=dev).manual_seed(0)
        rel = [torch.randint(0, 256, (ng * G, ns), generator=gen, device=dev, dtype=torch.int32) for _ in range(2)]
    else:
        tables, orel, mrel = _slot_offsets(n_levels, hp, wp, k, w, scale)
        tables = [t.to(dev) for t in tables]
        rel = [t.to(dev).contiguous() for t in (orel if c0 == 1 else mrel)]
        assert rel[0].shape[1] == ns
    gen = torch.Generator(device=dev).manual_seed(1)
    planes = torch.randn((n_levels, 3, hp, wp), generator=gen, device=dev)
    before = tselect.select_groups.launches
    got = tselect.select_groups(planes, *tables, *rel, c0=c0)
    torch.cuda.synchronize()
    assert tselect.select_groups.launches == before + 1
    assert torch.equal(got, tselect.select_groups_plain(planes, *tables, *rel, c0=c0))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1, 2, 4, 6])
def test_cuda_select_fused_matches_plain_at_scale(scale):
    """The fused describe bitwise to its plain version on the card, every
    keypoint at ``scale``, some near the plane's edges (``ok`` false)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused describe kernel runs only there")
    n_levels, hp, wp, k = 26, 512, 1408, 8192
    lvl, xf, yf, _ = _keypoints(5, k, n_levels, hp, wp)
    dev = torch.device("cuda")
    xf, yf, lvl = (torch.as_tensor(a, device=dev) for a in (xf, yf, lvl))
    sc = torch.full((k,), float(scale), device=dev)
    width = torch.full((k,), wp - 16, dtype=torch.int32, device=dev)
    height = torch.full((k,), hp, dtype=torch.int32, device=dev)
    y0, x0 = tdesc.patch_anchor(xf, yf, hp, wp)
    orel = tdesc.orientation_offsets(xf, yf, sc, width, height, x0, y0, 128)
    gen = torch.Generator(device=dev).manual_seed(2)
    planes = torch.randn((n_levels, 3, hp, wp), generator=gen, device=dev)
    args = (planes, lvl, y0, x0, *orel, xf, yf, sc, width, height)
    before = tfused.select_fused.launches
    (vk, mk), (vp, mp) = tfused.select_fused(*args), tfused.select_fused_plain(*args)
    torch.cuda.synchronize()
    assert tfused.select_fused.launches == before + 1
    assert 0 < int((mk[:, 3] > 0.5).sum()) < k
    assert torch.equal(mk, mp) and torch.equal(vk, vp)
