"""The port's repairs against its earlier forms and against cv_tpu:

* graph BA sums each view's valid incoming edges in edge order (a scan
  along a padded table, sequential on every device): on a graph whose
  views have several incoming edges in mixed order, some invalid, the CPU
  gives the bits it gave with ``Tensor.index_add_`` over every edge (the
  former sum, kept here as the reference), over many rounds;
* the one-hot describe's select is an exact index gather: equal to the
  float32 one-hot product at full precision, out-of-patch indices giving 0;
  ``mldb_flat_onehot`` on it gives ``mldb_flat``'s words bitwise and
  cv_tpu's ``mldb_flat_onehot`` words on >= 99% of rows (the cell-mean
  order, measured 100%); ``flat_ldet_buffer`` equals cv_tpu's;
* the scale space's 2x2 downsample sums in a fixed order that equals the
  CPU's ``Tensor.mean`` bitwise (the card's mean ordered otherwise, which
  made frame 0's words differ card to CPU);
* the products of the pose, Lie, essential and eigen modules run at full
  float32 precision whatever the caller's TF32 setting, which is restored;
  on a card (``cuda``-marked, skipped here) the KITTI describes and a pose
  pipeline give the same bits with TF32 turned on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.akaze import descriptors as jdesc
from cv_tpu.akaze import fast as jfast
from cv_tpu_torch.akaze import descriptors as desc
from cv_tpu_torch.akaze import fast
from cv_tpu_torch.akaze.scale_space import EvolutionPlanes
from cv_tpu_torch.core import lie
from cv_tpu_torch.ops import image, precision
from cv_tpu_torch.sfm import device_refine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's tensor work on one thread: parallel test workers share
    the machine's cores, and torch's threads would spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph_ba_index_add(rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid, iterations, rate):
    """graph_ba_core as it summed before: ``Tensor.index_add_`` per round."""
    v_count = rot.shape[0]
    edge_to, edge_from = edge_to.long(), edge_from.long()
    has_edge = torch.zeros(v_count, dtype=torch.int32).scatter_reduce(
        0, edge_to, edge_valid.to(torch.int32), reduce="amax") > 0
    removed = ~has_edge
    zero = torch.zeros((), dtype=rot.dtype)
    mv = lambda m, v: (m * v[..., None, :]).sum(dim=-1)  # noqa: E731
    for _ in range(iterations):
        r_rel = rot[edge_from] @ rot[edge_to].transpose(-1, -2)
        t_rel = trans[edge_from] - mv(r_rel, trans[edge_to])
        r_d = edge_rot @ r_rel
        t_d = mv(edge_rot, t_rel) + edge_t
        se3_log = torch.cat([t_d, lie.so3_log(r_d)], dim=-1)
        ok_edge = edge_valid & ~removed[edge_from] & ~removed[edge_to]
        se3_log = torch.where(ok_edge[:, None], se3_log, zero)
        net = torch.zeros((v_count, 6), dtype=rot.dtype).index_add_(0, edge_to, se3_log) * rate
        finite = torch.isfinite(net).all(dim=-1) & has_edge & ~removed
        dr = lie.so3_exp(net[:, 3:6])
        rot = torch.where(finite[:, None, None], dr @ rot, rot)
        trans = torch.where(finite[:, None], mv(dr, trans) + net[:, 0:3], trans)
        removed = removed | ~finite
    return rot, trans, removed


@pytest.mark.parametrize("seed,v,e", [(0, 8, 40), (1, 12, 90), (2, 5, 7)])
def test_graph_ba_core_bits_unchanged(seed, v, e):
    rng = np.random.default_rng(seed)
    rot = lie.so3_exp(torch.tensor(rng.normal(size=(v, 3)) * 0.3))
    trans = torch.tensor(rng.normal(size=(v, 3)))
    edge_to = torch.tensor(rng.integers(0, v - 1, e))  # the last view has no edge: removed
    edge_from = (edge_to + torch.tensor(rng.integers(1, v - 1, e))) % (v - 1)
    edge_rot = lie.so3_exp(torch.tensor(rng.normal(size=(e, 3)) * 0.2))
    edge_t = torch.tensor(rng.normal(size=(e, 3)))
    edge_valid = torch.tensor(rng.uniform(size=e) < 0.8)
    args = (rot, trans, edge_to, edge_from, edge_rot, edge_t, edge_valid)
    counts = torch.bincount(edge_to[edge_valid], minlength=v)
    assert int(counts.max()) >= 2 or e < v
    table = device_refine.incoming_edges(edge_to, edge_valid, v)
    assert table.shape == (v, int(counts.max()))
    for row in range(v):  # each view's valid edges in edge order, padding after
        want = torch.nonzero((edge_to == row) & edge_valid)[:, 0]
        assert torch.equal(table[row, : len(want)], want) and bool((table[row, len(want):] == e).all())
    got = device_refine.graph_ba_core(*args, iterations=64, rate=0.05)
    ref = _graph_ba_index_add(*args, iterations=64, rate=0.05)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _onehot_product(patch, rel_x, rel_y):
    side = patch.shape[-1]
    iota = torch.arange(side)
    oh_col = (iota == rel_x[:, :, None].long()).to(patch.dtype)
    oh_row = (iota == rel_y[:, :, None].long()).to(patch.dtype)
    t = torch.einsum("knw,kchw->knch", oh_col, patch)
    return torch.einsum("knh,knch->kcn", oh_row, t)


def test_patch_select_equals_the_one_hot_product():
    rng = np.random.default_rng(4)
    patch = torch.tensor(rng.normal(size=(9, 3, 128, 128)).astype(np.float32))
    rel_x = torch.tensor(rng.integers(-3, 131, (9, 441)), dtype=torch.int32)
    rel_y = torch.tensor(rng.integers(-3, 131, (9, 441)), dtype=torch.int32)
    rel_x[0, :5] = torch.tensor([0, 127, -1, 128, 64])
    with precision.full_f32_products():
        ref = _onehot_product(patch, rel_x, rel_y)
    got = desc.patch_select(patch, rel_x, rel_y)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    outside = (rel_x < 0) | (rel_x > 127) | (rel_y < 0) | (rel_y > 127)
    assert bool(outside.any()) and bool((got.permute(0, 2, 1)[outside] == 0).all())


def _describe_inputs(seed, k=96):
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(3, 3, 256, 384)).astype(np.float32)
    lvl = rng.integers(0, 3, k).astype(np.int32)
    width = np.full(k, 384, np.int32)
    height = np.full(k, 256, np.int32)
    xf = rng.uniform(-4, 388, k).astype(np.float32)  # some samples out of the plane
    yf = rng.uniform(20, 236, k).astype(np.float32)
    scale = rng.integers(1, 4, k).astype(np.float32)
    angle = rng.uniform(0, 2 * np.pi, k).astype(np.float32)
    return planes, lvl, width, height, xf, yf, scale, angle


def test_mldb_flat_onehot_matches_mldb_flat_and_cv_tpu():
    planes, lvl, width, height, xf, yf, scale, angle = _describe_inputs(5)
    t = [torch.as_tensor(a) for a in (planes, lvl, width, height, xf, yf, scale, angle)]
    words, ok = desc.mldb_flat_onehot(*t, pattern_size=10, chunk=32)
    n_lvl, _, hp, wp = planes.shape
    flat = t[0].permute(0, 2, 3, 1).reshape(-1, 3)
    base = t[1].long() * (hp * wp)
    fw, fok = desc.mldb_flat(flat, base, t[2], t[3], t[4], t[5], t[6], t[7], 10)
    assert torch.equal(words, fw) and torch.equal(ok, fok)
    assert 0 < int(ok.sum()) < len(ok)
    rw, rok = jdesc.mldb_flat_onehot(*(jnp.asarray(a) for a in (planes, lvl, width, height, xf, yf, scale, angle)),
                                     pattern_size=10, chunk=32)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    rows = (words.numpy().view(np.uint32) == np.asarray(rw)).all(axis=1)
    assert rows.mean() >= 0.99, rows.mean()


def test_flat_ldet_buffer_matches_cv_tpu():
    rng = np.random.default_rng(6)
    shapes = [(2, 64, 96), (2, 64, 96), (2, 32, 48)]
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    planes = [EvolutionPlanes(spec=None, lt=None, lsmooth=None, lx=None, ly=None, ldet=torch.as_tensor(a))
              for a in arrays]
    ref = jfast.flat_ldet_buffer([type("P", (), {"ldet": jnp.asarray(a)})() for a in arrays])
    got = fast.flat_ldet_buffer(planes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(1, 512, 1392), (2, 257, 697), (3, 65, 87), (1, 2, 2)])
def test_half_size_sums_in_the_cpu_mean_s_order(shape):
    img = torch.as_tensor(np.random.default_rng(7).random(shape).astype(np.float32) * 3)
    h, w = shape[-2:]
    hh, hw = h // 2, w // 2
    core = img[..., : hh * 2, : hw * 2].reshape(shape[:-2] + (hh, 2, hw, 2))
    got = image.half_size(img)
    inner = (slice(None), slice(0, hh - h % 2), slice(0, hw - w % 2))
    assert torch.equal(got[inner], core.mean(dim=(-3, -1))[inner])


def test_full_f32_sets_and_restores_the_matmul_precision():
    seen = []

    @precision.full_f32
    def probe():
        seen.append(torch.get_float32_matmul_precision())
        return 1

    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        assert probe() == 1 and seen == ["highest"]
        assert torch.get_float32_matmul_precision() == "high"
        torch.set_float32_matmul_precision("highest")
        probe()
        assert seen == ["highest", "highest"] and torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.cuda
def test_tf32_on_gives_the_same_words_and_poses():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the TF32 setting acts only there")
    import importlib
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    chip_smoke = importlib.import_module("chip_smoke")
    assert chip_smoke.tf32_invariance(torch.device("cuda", 0), 0) >= 9
