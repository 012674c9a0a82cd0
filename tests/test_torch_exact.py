"""cv_tpu_torch's exact AKAZE extractor (``AkazeExtractor``) and its pieces
against cv_tpu's, on the CPU.

* ``extract_candidates`` and the host dedup ``dedup_keypoints_exact``:
  bitwise to cv_tpu's on cv_tpu's own candidate masks and Ldet planes (the
  256x384 KITTI crop at ``Akaze()`` and the random 192x256 image).
* The scan's slot output: ``dedup_scan_plain``'s survivors in slot order are
  ``dedup_keypoints_exact``'s cache, bitwise, on those candidates and on a
  list built so that a later candidate replaces into an early slot and two
  survivors tie in response (where the candidates' input order and the slot
  order disagree).
* The gather forms ``compute_orientations`` / ``compute_mldb_descriptors``
  and ``orientation_flat`` / ``orientation_padded`` / ``mldb_flat`` on the
  same planes: ok flags equal, angles within 1e-4 rad, at least 99% of
  word rows bitwise equal.
* ``AkazeExtractor(device="cpu")`` end to end at ``Akaze()`` and
  ``Akaze.sparse()`` on the crop and at ``Akaze()`` on the random image:
  counts, octaves, classes and sizes equal, points within 1e-3 px of the
  same row, angles within 1e-4 rad, at least 99% of word rows bitwise
  equal and none more than 16 of 486 bits off (test_torch_extract's
  tolerances for the same arithmetic: the scale space differs from
  XLA:CPU's in the last bits, the cell means are summed in another order).
  Measured: 362 and 33 keypoints on the crop, points within 7.6e-5 px,
  one word row one bit off.
* tests/test_akaze.py's edge cases: a 30x30 zero image, a constant image,
  ``maximum_features=5``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.akaze import Akaze as JAkaze
from cv_tpu.akaze import AkazeExtractor as JExtractor
from cv_tpu.akaze import descriptors as jdesc
from cv_tpu.akaze import extrema as jextrema
from cv_tpu.akaze import load_gray as j_load_gray
from cv_tpu.akaze import to_gray_f32 as j_to_gray
from cv_tpu.utils.fixtures import fixture_path
from cv_tpu_torch.akaze import AkazeExtractor, from_numpy_config
from cv_tpu_torch.akaze import descriptors as tdesc
from cv_tpu_torch.akaze import extrema as textrema
from cv_tpu_torch.akaze.extract import DESCRIPTOR_WORDS
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)


def _random_image():
    return np.random.default_rng(3).uniform(0, 255, (192, 256)).astype(np.uint8)


def _kitti_crop():
    return j_load_gray(fixture_path("0000000000.png"))[128:384, 400:784]


CASES = {
    "kitti_crop_default": (_kitti_crop, 0.001),
    "kitti_crop_sparse": (_kitti_crop, 0.01),
    "random_default": (_random_image, 0.001),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def both(request):
    """cv_tpu's extract and scale-space outputs and the port's extract on
    one case."""
    make, threshold = CASES[request.param]
    img = make()
    cfg = JAkaze(detector_threshold=threshold)
    ref_ex = JExtractor(cfg)
    h, w = img.shape
    specs = ref_ex.specs(h, w)
    _, _, _, ldets, masks = ref_ex._scale_space_program(jnp.asarray(j_to_gray(img)), h, w)
    planes = dict(specs=specs, masks=[np.asarray(m) for m in masks], ldets=[np.asarray(x) for x in ldets])
    ref = ref_ex.extract(img)
    port = AkazeExtractor(from_numpy_config(cfg), device="cpu").extract(img)
    return request.param, cfg, planes, ref, port


def test_extract_candidates_bitwise(both):
    _, _, planes, _, _ = both
    ref = jextrema.extract_candidates(planes["specs"], planes["masks"], planes["ldets"])
    got = textrema.extract_candidates(planes["specs"], [torch.tensor(m) for m in planes["masks"]],
                                      [torch.tensor(x) for x in planes["ldets"]])
    assert len(got) == len(ref) and sum(len(c.xs) for c in ref) > 50
    for g, r in zip(got, ref):
        assert (g.e_id, g.octave, g.esigma, g.width, g.height) == (r.e_id, r.octave, r.esigma, r.width, r.height)
        for name in ("xs", "ys", "responses"):
            a, b = getattr(g, name), getattr(r, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_dedup_keypoints_exact_bitwise(both):
    _, cfg, planes, _, _ = both
    cands = jextrema.extract_candidates(planes["specs"], planes["masks"], planes["ldets"])
    ref = jextrema.dedup_keypoints_exact(cands, cfg.derivative_factor)
    got = textrema.dedup_keypoints_exact(cands, cfg.derivative_factor)
    assert sorted(got) == sorted(ref) and len(ref["response"]) > 10
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def _scan_inputs(cands, derivative_factor):
    """The scan's (1, C) inputs for host candidate lists, computed as the
    host dedup computes them, border test folded into ``valid``."""
    cols = {k: [] for k in ("px_cmp", "py_cmp", "px_store", "py_store", "resp", "cls", "size2", "valid")}
    for c in cands:
        ratio = np.float32(2.0) ** np.float32(c.octave)
        size = np.float32(c.esigma * derivative_factor)
        reach = textrema.SMAX * np.float32(np.round(size / ratio))
        off = np.float32(0.5) * (ratio - np.float32(1.0))
        x, y = c.xs.astype(np.float32), c.ys.astype(np.float32)
        cols["px_cmp"].append(x * ratio)
        cols["py_cmp"].append(y * ratio)
        cols["px_store"].append(x * ratio + off)
        cols["py_store"].append(y * ratio + off)
        cols["resp"].append(c.responses)
        cols["cls"].append(np.full(len(x), c.e_id, np.int32))
        cols["size2"].append(np.full(len(x), size * size, np.float32))
        cols["valid"].append((np.round(x - reach) - 1 >= 0) & (np.round(x + reach) + 1 < c.width)
                             & (np.round(y - reach) - 1 >= 0) & (np.round(y + reach) + 1 < c.height))
    return [torch.as_tensor(np.concatenate(cols[k])[None]) for k in cols]


def _slot_order(cands, derivative_factor):
    """``dedup_scan_plain`` with slots on host candidates: the survivors'
    candidate indices in slot order, and in candidate order."""
    keep, slots = textrema.dedup_scan_plain(*_scan_inputs(cands, derivative_factor), with_slots=True)
    keep, slots = keep[0].numpy(), slots[0].numpy()
    assert slots.dtype == np.int32
    np.testing.assert_array_equal(keep, slots >= 0)
    alive = np.nonzero(keep)[0]
    assert len(np.unique(slots[alive])) == len(alive)
    return alive[np.argsort(slots[alive])], alive


def _assert_cache_order(cands, derivative_factor, order):
    """The candidates ``order`` picks are the host dedup's cache, in order."""
    host = textrema.dedup_keypoints_exact(cands, derivative_factor)
    xs = np.concatenate([c.xs for c in cands])
    ys = np.concatenate([c.ys for c in cands])
    cls = np.concatenate([np.full(len(c.xs), c.e_id) for c in cands])
    resp = np.concatenate([c.responses for c in cands])
    np.testing.assert_array_equal(np.stack([xs[order], ys[order]], 1), host["ixy"])
    np.testing.assert_array_equal(cls[order], host["class_id"])
    np.testing.assert_array_equal(resp[order], host["response"])


def test_scan_slots_give_the_host_cache_order(both):
    _, cfg, planes, _, _ = both
    cands = textrema.extract_candidates(planes["specs"], planes["masks"], planes["ldets"])
    order, _ = _slot_order(cands, cfg.derivative_factor)
    _assert_cache_order(cands, cfg.derivative_factor, order)


def _candidates(e_id, octave, points):
    return textrema.Candidates(
        e_id=e_id, octave=octave, esigma=1.6 * 2.0 ** (e_id / 4.0), width=200, height=200,
        xs=np.array([p[0] for p in points], np.int32), ys=np.array([p[1] for p in points], np.int32),
        responses=np.array([p[2] for p in points], np.float32))


def test_scan_slots_on_a_replacement_into_an_early_slot_and_a_tie():
    """Class 0 appends A (slot 0) and B (slot 1); class 1 appends C (slot 2),
    then D lands next to A with a higher response, replaces slot 0 and ties
    B's response, then E appends (slot 3).  In candidate order D comes
    after B and C; in slot order it comes first, as in the host cache, so
    the stable sort by response puts D before B, as the host's does, and
    a sort of the survivors in candidate order would not."""
    cands = [
        _candidates(0, 0, [(60, 60, 0.30), (120, 60, 0.50)]),
        _candidates(1, 0, [(60, 140, 0.40), (61, 60, 0.50), (140, 140, 0.20)]),
    ]
    order, by_candidate = _slot_order(cands, 1.5)
    _assert_cache_order(cands, 1.5, order)
    np.testing.assert_array_equal(order, [3, 1, 2, 4])
    resp = np.concatenate([c.responses for c in cands])
    host = textrema.dedup_keypoints_exact(cands, 1.5)
    by_response = order[np.argsort(-resp[order], kind="stable")]
    np.testing.assert_array_equal(by_response, order[np.argsort(-host["response"], kind="stable")])
    np.testing.assert_array_equal(by_response, [3, 1, 2, 4])
    np.testing.assert_array_equal(by_candidate[np.argsort(-resp[by_candidate], kind="stable")], [1, 3, 2, 4])


def test_scan_slots_on_the_wrapper_run_the_plain_version():
    arrays = [a.clone() for a in _scan_inputs([_candidates(0, 0, [(60, 60, 0.3), (61, 61, 0.5)])], 1.5)]
    before = textrema.dedup_scan_device.launches
    keep, slots = textrema.dedup_scan_device(*arrays, with_slots=True)
    assert textrema.dedup_scan_device.launches == before
    assert keep.tolist() == [[False, True]] and slots.tolist() == [[-1, 0]]
    assert torch.equal(textrema.dedup_scan_device(*arrays), keep)


def _group_planes(rng, s=3, h=64, w=80):
    return [rng.normal(size=(s, h, w)).astype(np.float32) for _ in range(3)]


def _keypoints(rng, k, h, w, s):
    sub = rng.integers(0, s, k).astype(np.int32)
    xf = rng.uniform(0, w, k).astype(np.float32)
    yf = rng.uniform(0, h, k).astype(np.float32)
    scale = rng.integers(1, 4, k).astype(np.float32)
    angle = rng.uniform(0, 2 * np.pi, k).astype(np.float32)
    return sub, xf, yf, scale, angle


def _words_close(got, ref):
    got = got.view(np.uint32)
    assert (got == ref).all(axis=1).mean() >= 0.99
    assert np.unpackbits((got ^ ref).view(np.uint8), axis=1).sum(axis=1).max() <= 16


def test_gather_forms_on_the_same_planes():
    rng = np.random.default_rng(8)
    lt, lx, ly = _group_planes(rng)
    sub, xf, yf, scale, angle = _keypoints(rng, 128, 64, 80, 3)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    a_ref = np.asarray(jdesc.compute_orientations(*(jnp.asarray(a) for a in (lx, ly, sub, xf, yf, scale))))
    a_got = tdesc.compute_orientations(*(t(a) for a in (lx, ly, sub, xf, yf, scale))).numpy()
    assert np.abs(a_got - a_ref).max() < 1e-4
    w_ref, ok_ref = (np.asarray(v) for v in jdesc.compute_mldb_descriptors(
        *(jnp.asarray(a) for a in (lt, lx, ly, sub, xf, yf, scale, angle)), 10))
    w_got, ok_got = tdesc.compute_mldb_descriptors(*(t(a) for a in (lt, lx, ly, sub, xf, yf, scale, angle)), 10)
    np.testing.assert_array_equal(ok_got.numpy(), ok_ref)
    assert 0 < ok_ref.sum() < len(ok_ref)
    _words_close(w_got.numpy()[ok_ref], w_ref[ok_ref])


def test_flat_and_padded_gathers_on_the_same_planes():
    """Two planes of different sizes in one flat (P, 3) buffer and in the
    padded stack; keypoints on both."""
    rng = np.random.default_rng(9)
    shapes = ((64, 80), (32, 40))
    stacks = [rng.normal(size=(3, h, w)).astype(np.float32) for h, w in shapes]
    flat = np.concatenate([s.reshape(3, -1).T for s in stacks])
    padded = np.zeros((2, 3, 64, 80), np.float32)
    for i, s in enumerate(stacks):
        padded[i, :, : s.shape[1], : s.shape[2]] = s
    k = 96
    lvl = rng.integers(0, 2, k).astype(np.int32)
    height = np.array([shapes[v][0] for v in lvl], np.int32)
    width = np.array([shapes[v][1] for v in lvl], np.int32)
    base = np.where(lvl == 0, 0, 64 * 80).astype(np.int32)
    xf = (rng.uniform(0, 1, k) * width).astype(np.float32)
    yf = (rng.uniform(0, 1, k) * height).astype(np.float32)
    scale = rng.integers(1, 3, k).astype(np.float32)
    angle = rng.uniform(0, 2 * np.pi, k).astype(np.float32)
    j, t = (lambda a: jnp.asarray(a)), (lambda a: torch.as_tensor(a))
    for ref_fn, got_fn, src, idx in ((jdesc.orientation_flat, tdesc.orientation_flat, flat, base),
                                     (jdesc.orientation_padded, tdesc.orientation_padded, padded, lvl)):
        a_ref = np.asarray(ref_fn(*(j(a) for a in (src, idx, width, height, xf, yf, scale))))
        a_got = got_fn(*(t(a) for a in (src, idx, width, height, xf, yf, scale))).numpy()
        assert np.abs(a_got - a_ref).max() < 1e-4
    w_ref, ok_ref = (np.asarray(v) for v in jdesc.mldb_flat(
        *(j(a) for a in (flat, base, width, height, xf, yf, scale, angle)), 10))
    w_got, ok_got = tdesc.mldb_flat(*(t(a) for a in (flat, base, width, height, xf, yf, scale, angle)), 10)
    np.testing.assert_array_equal(ok_got.numpy(), ok_ref)
    assert 0 < ok_ref.sum() < k
    _words_close(w_got.numpy()[ok_ref], w_ref[ok_ref])


def test_extractor_counts_and_fields(both):
    name, _, _, (kr, wr), (kp, wp) = both
    assert len(kp["response"]) == len(kr["response"]) > 20
    assert wp.shape == wr.shape and wp.dtype == wr.dtype == np.uint32
    for key in kr:
        assert kp[key].dtype == kr[key].dtype and kp[key].shape == kr[key].shape, key
    for key in ("octave", "class_id", "size"):
        np.testing.assert_array_equal(kp[key], kr[key], err_msg=key)
    assert np.all(np.diff(kp["response"]) <= 0)


def test_extractor_points_angles_words(both):
    _, _, _, (kr, wr), (kp, wp) = both
    assert np.abs(kp["point"] - kr["point"]).max() < 1e-3
    da = np.abs(kp["angle"] - kr["angle"])
    assert np.minimum(da, 2 * np.pi - da).max() < 1e-4
    _words_close(wp, wr)


@pytest.mark.parametrize("make,cfg", [
    (lambda: np.zeros((30, 30), np.uint8), JAkaze.sparse()),
    (lambda: np.full((64, 96), 128, np.uint8), JAkaze.sparse()),
    (_kitti_crop, JAkaze(detector_threshold=0.01, maximum_features=5)),
], ids=["too_small", "constant", "maximum_features_5"])
def test_edge_cases(make, cfg):
    img = make()
    kr, wr = JExtractor(cfg).extract(img)
    kp, wp = AkazeExtractor(from_numpy_config(cfg), device="cpu").extract(img)
    assert len(kp["response"]) == len(kr["response"]) <= 5
    assert wp.shape == (len(kp["response"]), DESCRIPTOR_WORDS) and wp.dtype == np.uint32
    assert sorted(kp) == sorted(kr)
    if len(kr["response"]):
        assert np.abs(kp["point"] - kr["point"]).max() < 1e-3
        np.testing.assert_array_equal(kp["class_id"], kr["class_id"])
