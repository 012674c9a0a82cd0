"""cv_tpu_torch's batched extractor and its stages against cv_tpu's.

End to end, on the random 192x256 image of test_fast_extractor's describe
tests and on a 256x384 crop of a KITTI fixture: equal keypoint counts,
every point within 1e-3 px of a partner, angles within 1e-4 rad, at least
99% of valid rows with bitwise-equal words and no row more than 16 of 486
bits off.  The tolerances exist because the scale space differs from
XLA:CPU in the last bits (see test_torch_image_ops) and the M-LDB cell
means are summed in another order than the JAX package's float matmul
(the port adds each cell's members in a fixed order, held bitwise to a
NumPy chain below).  Measured here: counts
equal (185 and 362), points within 1.5e-5 and 7.6e-5 px, angles within
9.6e-7 rad, one row in each case one bit off (185 and 362 rows).

The dedup scan and the compaction are comparisons on identical inputs, so
they are held bitwise.

The fast path's other options on the random image, against cv_tpu's with the
same option: the strongest-k candidate methods ``'block'``, ``'raw'`` and
``'approx'`` (cv_tpu's ``jax.lax.approx_max_k``, exact off the TPU, so the
port's is ``'raw'``), the ``'gather'`` sampler and the one-hot describe
modes ``'highest'`` / ``'highest+inter'``: the same valid slots, points
within 1e-3 px, at least 99% of word rows bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cv_tpu.akaze import Akaze as JAkaze
from cv_tpu.akaze import descriptors as jdesc
from cv_tpu.akaze import extrema as jextrema
from cv_tpu.akaze import fast as jfast
from cv_tpu.akaze import load_gray as j_load_gray
from cv_tpu.akaze import to_gray_f32 as j_to_gray
from cv_tpu.utils.fixtures import fixture_path
from cv_tpu_torch.akaze import Akaze, DeviceExtractor, FeatureSet, from_numpy_config
from cv_tpu_torch.akaze import descriptors as tdesc
from cv_tpu_torch.akaze import extrema as textrema
from cv_tpu_torch.akaze import fast as tfast
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)


def _random_image():
    rng = np.random.default_rng(3)
    return rng.uniform(0, 255, (192, 256)).astype(np.uint8)


def _kitti_crop():
    return j_load_gray(fixture_path("0000000000.png"))[128:384, 400:784]


CASES = {
    "random_192x256": (_random_image, 0.001, 128, 256),
    "kitti_crop_256x384": (_kitti_crop, 0.001, 256, 512),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def both_features(request):
    make, threshold, cb, mf = CASES[request.param]
    img = j_to_gray(make())
    jcfg = JAkaze(detector_threshold=threshold)
    ref = jfast.DeviceExtractor(
        jcfg, candidate_budget=cb, max_features=mf, onehot_mode="highest"
    ).extract(jnp.asarray(img)[None])
    port = DeviceExtractor(from_numpy_config(jcfg), candidate_budget=cb, max_features=mf, device="cpu").extract(
        img[None]
    )
    ref = {k: np.asarray(getattr(ref, k)) for k in ("point", "angle", "words", "valid", "response")}
    return port.to_numpy(), ref


def _partners(port, ref):
    vp, vr = port["valid"][0], ref["valid"][0]
    pp, pr = port["point"][0][vp], ref["point"][0][vr]
    dist = np.abs(pr[:, None, :] - pp[None, :, :]).max(-1)
    return vp, vr, dist.argmin(1), dist.min(1)


def test_counts_equal(both_features):
    port, ref = both_features
    assert port["valid"].sum() == ref["valid"].sum() > 20


def test_points_within_1e3(both_features):
    _, _, _, d = _partners(*both_features)
    assert d.max() < 1e-3


def test_angles_within_1e4(both_features):
    port, ref = both_features
    vp, vr, near, _ = _partners(port, ref)
    da = np.abs(port["angle"][0][vp][near] - ref["angle"][0][vr])
    da = np.minimum(da, 2 * np.pi - da)
    assert da.max() < 1e-4


def test_words_mostly_bitwise(both_features):
    port, ref = both_features
    vp, vr, near, _ = _partners(port, ref)
    wp, wr = port["words"][0][vp][near], ref["words"][0][vr]
    assert wp.dtype == wr.dtype == np.uint32
    assert (wp == wr).all(axis=1).mean() >= 0.99
    bits_off = np.unpackbits((wp ^ wr).view(np.uint8), axis=1).sum(axis=1)
    assert bits_off.max() <= 16


def test_feature_set_numpy_round_trip(both_features):
    port, _ = both_features
    again = FeatureSet.from_numpy(port).to_numpy()
    for key, value in port.items():
        np.testing.assert_array_equal(again[key], value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_candidates_exact(seed):
    rng = np.random.default_rng(seed)
    masked = np.full((3, 1000), -np.inf, np.float32)
    for row, n in zip(masked, (5, 40, 300)):
        row[rng.choice(1000, n, replace=False)] = rng.uniform(0.01, 1.0, n)
    ref = jfast._compact_candidates(jnp.asarray(masked), 64)
    port = tfast._compact_candidates(torch.as_tensor(masked), 64)
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dedup_scan_exact(seed):
    """Sequential dedup on a batch of candidate lists with many conflicts,
    against cv_tpu's while_loop vmapped over the same frames."""
    rng = np.random.default_rng(seed)
    b, c = 3, 96
    cls = np.sort(rng.integers(0, 4, (b, c)), axis=1).astype(np.int32)
    px = rng.uniform(0, 40, (b, c)).astype(np.float32)
    py = rng.uniform(0, 40, (b, c)).astype(np.float32)
    shift = (rng.uniform(0, 1.5, (b, c))).astype(np.float32)
    resp = rng.uniform(0.01, 1.0, (b, c)).astype(np.float32)
    size2 = ((1.6 * 1.5 * 2.0 ** (cls / 4.0)) ** 2).astype(np.float32) * 4.0
    n_steps = np.array([c, c // 2, 17], np.int32)
    # The caller's contract: every valid candidate sits in the n_steps prefix.
    valid = (rng.uniform(size=(b, c)) < 0.9) & (np.arange(c)[None, :] < n_steps[:, None])
    arrays = (px, py, px + shift, py + shift, resp, cls, size2, valid)
    ref = jax.vmap(jextrema.dedup_scan_device)(*(jnp.asarray(a) for a in arrays), jnp.asarray(n_steps))
    port = textrema.dedup_scan_device(*(torch.as_tensor(a) for a in arrays), torch.as_tensor(n_steps))
    assert np.asarray(ref).any() and not np.asarray(ref).all()
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_dedup_scan_exact_large_cap():
    """The dedup wrapper on CPU tensors (its plain version) at a cap above
    1024, against cv_tpu's scan: a cache that grows past a thousand entries
    while many candidates replace or lose to earlier ones."""
    rng = np.random.default_rng(12)
    b, c = 2, 1536
    cls = np.sort(rng.integers(0, 6, (b, c)), axis=1).astype(np.int32)
    px = rng.uniform(0, 400, (b, c)).astype(np.float32)
    py = rng.uniform(0, 300, (b, c)).astype(np.float32)
    shift = (rng.uniform(0, 1.5, (b, c))).astype(np.float32)
    resp = rng.uniform(0.01, 1.0, (b, c)).astype(np.float32)
    size2 = ((2.0 * 2.0 ** (cls / 4.0)) ** 2).astype(np.float32) * 4.0
    n_steps = np.array([c, 1100], np.int32)
    valid = (rng.uniform(size=(b, c)) < 0.95) & (np.arange(c)[None, :] < n_steps[:, None])
    arrays = (px, py, px + shift, py + shift, resp, cls, size2, valid)
    ref = np.asarray(jax.vmap(jextrema.dedup_scan_device)(*(jnp.asarray(a) for a in arrays), jnp.asarray(n_steps)))
    before = textrema.dedup_scan_device.launches
    port = textrema.dedup_scan_device(*(torch.as_tensor(a) for a in arrays), torch.as_tensor(n_steps))
    assert textrema.dedup_scan_device.launches == before  # the CPU runs the plain version
    assert 1024 < ref[0].sum() < valid[0].sum()
    np.testing.assert_array_equal(port.numpy(), ref)


def _kernel_dedup(px_cmp, py_cmp, px_store, py_store, resp, cls, size2, valid, n_steps, table=64):
    """The dedup kernel's rules as a NumPy loop (csrc/dedup_scan.cu): the
    scan takes the first close slot of class k or k - 1 in slot order; the
    upper-scale pass walks, for slot i, the slots from i + 1 within the
    first and last slot of class class(i) + 1 (for a class in [0, table);
    every later slot otherwise).  Returns the (B, C) mask and what the
    inputs exercised: classes that come back, the longest chain of classes
    one slot carried by replacement, upper-pass walks the class range cut
    short, and slots whose next class has no range."""
    b, c = px_cmp.shape
    out = np.zeros((b, c), bool)
    stats = dict(returns=0, longest_chain=0, narrowed=0, unranged=0)
    for f in range(b):
        cpx, cpy, cresp = (np.zeros(c, np.float32) for _ in range(3))
        ccls, csrc, chain = (np.zeros(c, np.int64) for _ in range(3))
        count, prev, seen = 0, None, set()
        for j in range(min(max(int(n_steps[f]), 0), c)):
            if not valid[f, j]:
                continue
            k = int(cls[f, j])
            if k != prev:
                stats["returns"] += k in seen
                seen.add(k)
                prev = k
            dx = px_cmp[f, j] - cpx[:count]
            dy = py_cmp[f, j] - cpy[:count]
            in_win = (ccls[:count] == k) | (ccls[:count] == k - 1)
            close = in_win & ((dx * dx + dy * dy) <= size2[f, j])
            first = int(np.argmax(close)) if close.any() else None
            if first is None:
                slot, count = count, count + 1
                chain[slot] = 1
            elif resp[f, j] > cresp[first]:
                slot = first
                chain[slot] += ccls[slot] != k
            else:
                continue
            cpx[slot], cpy[slot], cresp[slot], ccls[slot], csrc[slot] = px_store[f, j], py_store[f, j], resp[f, j], k, j
            stats["longest_chain"] = max(stats["longest_chain"], int(chain[slot]))
        first_of = {k: int(np.argmax(ccls[:count] == k)) for k in set(ccls[:count].tolist())}
        last_of = {k: count - 1 - int(np.argmax(ccls[:count][::-1] == k)) for k in first_of}
        for i in range(count):
            up = int(ccls[i]) + 1
            q0, q1 = i + 1, count - 1
            if 0 <= up < table:
                q0, q1 = max(q0, first_of.get(up, c)), min(q1, last_of.get(up, -1))
                stats["narrowed"] += (q0, q1) != (i + 1, count - 1)
            else:
                stats["unranged"] += 1
            qs = np.arange(q0, q1 + 1)
            dx = cpx[i] - cpx[qs]
            dy = cpy[i] - cpy[qs]
            hit = (ccls[qs] == up) & ((dx * dx + dy * dy) <= size2[f, csrc[i]]) & (cresp[i] <= cresp[qs])
            out[f, csrc[i]] = not hit.any()
    return out, stats


def _jax_dedup(arrays):
    *cols, n_steps = arrays
    cols[5] = np.asarray(cols[5], np.int32)
    n_steps = np.asarray(n_steps, np.int32)
    return np.asarray(jax.vmap(jextrema.dedup_scan_device)(*(jnp.asarray(a) for a in cols), jnp.asarray(n_steps)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_scan_adversarial_exact(seed):
    """chip_smoke's adversarial dedup set (replacement chains through the
    classes, classes that return after a gap, an unordered frame with
    classes past the kernel's class table): cv_tpu's scan, the port's plain
    version and the kernel's rules agree bitwise, and the set exercises
    what they rely on: slots carried into new classes by replacement,
    classes that come back, upper-pass walks the class ranges cut short,
    and classes past the ranges' table."""
    arrays = chip_smoke.dedup_adversarial(seed)
    ref = _jax_dedup(arrays)
    port = textrema.dedup_scan_device(*(torch.as_tensor(a) for a in arrays)).numpy()
    rules, stats = _kernel_dedup(*arrays)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(rules, ref)
    assert ref.any(axis=1).all() and not ref[:, : arrays[-1].min()].all()
    assert stats["longest_chain"] >= 4 and stats["returns"] >= 3
    assert stats["narrowed"] > 0 and stats["unranged"] > 0


def test_dedup_kernel_rules_on_kitti_candidates():
    """The kernel's rules on the dense KITTI candidates (the crop at the
    default threshold and the default scan cap of 1024: 554 conflicted
    candidates of nine classes) as stage_dedup hands them to the scan:
    cv_tpu's mask, bitwise."""
    calls = []
    real = textrema.dedup_scan_device

    def record(*a, **kw):
        calls.append([t.numpy() for t in a])
        return real(*a, **kw)

    textrema.dedup_scan_device = record
    try:
        DeviceExtractor(Akaze(), candidate_budget=512, max_features=1024, dedup_scan_cap=1024,
                        device="cpu").extract(j_to_gray(_kitti_crop())[None])
    finally:
        textrema.dedup_scan_device = real
    (arrays,) = calls
    ref = _jax_dedup(arrays)
    rules, stats = _kernel_dedup(*arrays)
    np.testing.assert_array_equal(rules, ref)
    assert arrays[-1].min() > 500 and stats["narrowed"] > 0 and stats["longest_chain"] >= 2


def test_subpixel_refine_batch():
    rng = np.random.default_rng(5)
    ldet = rng.normal(size=(3, 20, 30)).astype(np.float32)
    ixy = np.stack(
        [rng.integers(0, 3, 64), rng.integers(1, 29, 64), rng.integers(1, 19, 64)], axis=1
    ).astype(np.int32)
    valid = rng.uniform(size=64) < 0.8
    d_j, ok_j = jextrema.subpixel_refine_batch(jnp.asarray(ldet), jnp.asarray(ixy), jnp.asarray(valid))
    d_t, ok_t = textrema.subpixel_refine_batch(torch.as_tensor(ldet), torch.as_tensor(ixy), torch.as_tensor(valid))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-6)


def test_describe_on_same_planes():
    """The describe stage alone, on one shared plane stack and keypoint set:
    cv_tpu's one-hot describe (bit-identical to its Pallas gather mode)
    against the port's select-based ``orient_mldb``.  OOB flags exact,
    angles within 1e-4 rad, words bitwise on at least 99% of rows."""
    rng = np.random.default_rng(11)
    n_lvl, hp, wp, k = 6, 256, 384, 96
    planes = rng.normal(size=(n_lvl, 3, hp, wp)).astype(np.float32)
    lvl = rng.integers(0, n_lvl, k).astype(np.int32)
    width = np.where(lvl % 2, 300, 384).astype(np.int32)
    height = np.where(lvl % 2, 200, 256).astype(np.int32)
    xf = (rng.uniform(0, 1, k) * width).astype(np.float32)
    yf = (rng.uniform(0, 1, k) * height).astype(np.float32)
    scale = rng.integers(1, 4, k).astype(np.float32)
    args = (planes, lvl, width, height, xf, yf, scale)
    w_j, ok_j, a_j = (
        np.asarray(x)
        for x in jdesc.orient_mldb_onehot(*(jnp.asarray(a) for a in args), pattern_size=10, chunk=32)
    )
    w_t, ok_t, a_t = tdesc.orient_mldb(*(torch.as_tensor(a) for a in args), pattern_size=10)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    assert 0 < ok_j.sum() < k  # both in-bounds and border keypoints
    assert np.abs(a_t.numpy() - a_j).max() < 1e-4
    assert (w_t.numpy().view(np.uint32) == w_j).all(axis=1).mean() >= 0.99


def test_orientation_and_pack_on_same_samples():
    """Orientation and M-LDB packing from identical sampled values: angles
    within 1e-4 rad, words bitwise on at least 99% of rows."""
    rng = np.random.default_rng(9)
    k = 256
    res_x = rng.normal(size=(k, 109)).astype(np.float32)
    res_y = rng.normal(size=(k, 109)).astype(np.float32)
    a_j = np.asarray(jdesc._orientation_from_samples(jnp.asarray(res_x), jnp.asarray(res_y)))
    a_t = tdesc._orientation_from_samples(torch.as_tensor(res_x), torch.as_tensor(res_y)).numpy()
    assert np.abs(a_t - a_j).max() < 1e-4
    ri, rx, ry = (rng.normal(size=(k, 441)).astype(np.float32) for _ in range(3))
    co = np.cos(a_j)[:, None].astype(np.float32)
    si = np.sin(a_j)[:, None].astype(np.float32)
    w_j = np.asarray(jdesc._mldb_pack(*(jnp.asarray(a) for a in (ri, rx, ry, co, si)), 10))
    w_t = tdesc._mldb_pack(*(torch.as_tensor(a) for a in (ri, rx, ry, co, si)), 10).numpy()
    assert (w_t.view(np.uint32) == w_j).all(axis=1).mean() >= 0.99


def test_cell_means_fixed_order_bitwise():
    """The M-LDB cell means equal, bitwise, a NumPy chain of adds over each
    cell's members in ascending sample order, times the inverse count."""
    uk, _, member, cell_counts = tdesc.mldb_unique_tables(10)
    rng = np.random.default_rng(7)
    values = rng.normal(size=(64, 3, len(uk))).astype(np.float32)
    inv = (1.0 / cell_counts.astype(np.float32))[None, :]
    got = tdesc.cell_means(
        torch.tensor(values),
        torch.tensor(tdesc.cell_member_table(member)),
        torch.tensor(inv),
    ).numpy()
    want = np.empty(values.shape[:2] + (member.shape[0],), np.float32)
    for c in range(member.shape[0]):
        idx = np.nonzero(member[c])[0]
        acc = values[..., idx[0]].copy()
        for j in idx[1:]:
            acc = acc + values[..., j]
        want[..., c] = acc * inv[0, c]
    np.testing.assert_array_equal(got, want)


FAST_OPTIONS = {
    "topk_block": dict(topk_method="block"),
    "topk_raw": dict(topk_method="raw"),
    "topk_approx": dict(topk_method="approx"),
    "sampler_gather": dict(sampler="gather"),
    "onehot_highest": dict(onehot_mode="highest"),
    "onehot_highest_inter": dict(onehot_mode="highest+inter"),
}


@pytest.mark.parametrize("option", sorted(FAST_OPTIONS))
def test_fast_path_options(option):
    kw = FAST_OPTIONS[option]
    img = j_to_gray(_random_image())
    jcfg = JAkaze(detector_threshold=0.001)
    ref = jfast.DeviceExtractor(jcfg, candidate_budget=128, max_features=256, **{"onehot_mode": "highest", **kw}
                                ).extract(jnp.asarray(img)[None])
    port = DeviceExtractor(from_numpy_config(jcfg), candidate_budget=128, max_features=256, device="cpu",
                           **kw).extract(img[None]).to_numpy()
    vr = np.asarray(ref.valid)
    np.testing.assert_array_equal(port["valid"], vr)
    assert vr.sum() > 100
    assert np.abs(port["point"][vr] - np.asarray(ref.point)[vr]).max() < 1e-3
    wp, wr = port["words"][vr], np.asarray(ref.words)[vr]
    assert (wp == wr).all(axis=1).mean() >= 0.99
    assert np.unpackbits((wp ^ wr).view(np.uint8), axis=1).sum(axis=1).max() <= 16


def test_tpu_describe_modes_raise():
    for mode in ("bf16x3", "bf16x3k", "highest+fused"):
        with pytest.raises(ValueError, match="TPU matrix unit"):
            DeviceExtractor(onehot_mode=mode, device="cpu")
