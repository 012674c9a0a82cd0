"""The consensus score entry's plain version (``core.pose.c2c_score_plain``)
and the stages that score through it, against the scoring that materializes
every residual and against cv_tpu's, on a CPU.

On a card the essential estimator's ``score`` (``csrc/jacobi.cu``'s score
entry) gives each model's inlier count and total without writing a
residual; ``BatchConsensus._score_counted`` takes the lexicographic best
from them and recomputes the winner's residual row alone for its mask.
Here the plain version runs in the entry's place (``_counts_first`` is
patched to take the counted path on a CPU): counts, chosen model and mask
must equal the materializing path's and cv_tpu's ``_score_stage``; the
totals, summed in the entry's order (``ordered_row_sum``), lie within
``TOTAL_RTOL`` of torch's sums.  The entry itself runs only on a card,
where ``chip_smoke.py`` holds it bitwise to this plain version.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import _kitti, _models, _scene

from cv_tpu.consensus.batch import BatchConsensus as JConsensus
from cv_tpu.core import Isometry3 as JIso
from cv_tpu.sfm.engine import DEFAULT_ESSENTIAL_ESTIMATOR as JEST
from cv_tpu_torch.consensus import BatchConsensus as TConsensus
from cv_tpu_torch.consensus import batch as tbatch
from cv_tpu_torch.core import Isometry3 as TIso
from cv_tpu_torch.core import pose as tpose
from cv_tpu_torch.sfm.engine import DEFAULT_ESSENTIAL_ESTIMATOR as TEST
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)

# The totals' tolerance against torch's sums of the same residuals: the
# two differ by summation order alone, a few ulps of the total.
TOTAL_RTOL = 1e-13
# A materializing twin of the engine's estimator: the path without `score`.
MATERIALIZING = dataclasses.replace(TEST, score=None)


@pytest.fixture
def counted(monkeypatch):
    """The stages take ``estimator.score`` on a CPU too (its plain version)."""
    monkeypatch.setattr(tbatch, "_counts_first", lambda estimator, data: estimator.score is not None)


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bits = np.uint32 if got.dtype == np.float32 else np.uint64
    np.testing.assert_array_equal(got.view(bits)[~nan], want.view(bits)[~nan])


@pytest.mark.parametrize("m", [0, 1, 5, 11, 64, 100, 128, 129, 300])
def test_ordered_row_sum_is_the_entrys_order(m):
    """``ordered_row_sum`` against the order written out in Python floats:
    chunks of C = the least power of two >= M (at most 128), each chunk's
    values (the last padded with +0) in a halving tree, then the chunks'
    sums added in order."""
    rng = np.random.default_rng(m)
    x = rng.standard_normal((3, m)) * np.exp(rng.uniform(-20, 20, (3, m)))
    x[:, ::3] = 0.0
    cw = 1
    while cw < 128 and cw < m:
        cw *= 2
    want = []
    for row in x:
        sums = []
        for start in range(0, max(m, 1), cw):
            part = [float(row[k]) if k < m else 0.0 for k in range(start, start + cw)]
            while len(part) > 1:
                h = len(part) // 2
                part = [part[t] + part[t + h] for t in range(h)]
            sums.append(part[0])
        total = sums[0]
        for v in sums[1:]:
            total = total + v
        want.append(total)
    assert tpose.score_chunk(m) == cw
    _same_bits(tpose.ordered_row_sum(torch.as_tensor(x)).numpy(), np.array(want))


def _problems():
    """(label, rot, tr, a, b, valid, threshold): two seeded scenes with
    degenerate and non-finite rows and models (a zero translation, a NaN
    rotation), the last row padding; and the KITTI pair's 11 matches."""
    out = []
    for seed in (0, 1):
        a, b = _scene(seed, n=16)
        rot, tr = _models(a, b, seed, 24)
        valid = np.ones(len(a), bool)
        valid[-1] = False
        out.append((f"scene {seed}", rot, tr, a, b, valid, 1e-3))
    a, b = _kitti()
    rot, tr = _models(a, b, 7, 64)
    out.append(("kitti", rot, tr, a, b, np.ones(len(a), bool), 1e-3))
    return out


PROBLEMS = _problems()


@pytest.mark.parametrize("problem", PROBLEMS, ids=[p[0] for p in PROBLEMS])
def test_score_plain_against_the_materialized_scoring(problem):
    """Per model, the plain score's counts equal those of the residuals the
    stage materializes, and its totals lie within ``TOTAL_RTOL`` of their
    torch sums."""
    _, rot, tr, a, b, valid, thr = problem
    t = torch.as_tensor
    pose = TIso(t(rot)[..., None, :, :], t(tr)[..., None, :])
    counts, totals = tpose.c2c_score_plain(pose, t(a), t(b), t(valid), thr)
    res = tpose.camera_to_camera_residual(pose, t(a), t(b))
    inliers = (res < thr) & t(valid) & torch.isfinite(res)
    assert (counts > 0).any() and (counts == 0).any()
    np.testing.assert_array_equal(counts.numpy(), inliers.sum(-1).numpy())
    np.testing.assert_allclose(totals.numpy(), torch.where(inliers, res, 0.0).sum(-1).numpy(), rtol=TOTAL_RTOL,
                               atol=0)
    got = tpose.c2c_score(pose, t(a), t(b), t(valid), thr)  # a CPU tensor: the plain version
    np.testing.assert_array_equal(got[0].numpy(), counts.numpy())
    _same_bits(got[1].numpy(), totals.numpy())


@pytest.mark.parametrize("problem", PROBLEMS, ids=[p[0] for p in PROBLEMS])
def test_counted_stage_picks_the_same_model_as_today_and_cv_tpu(problem, counted):
    """``_score_stage`` through the score (the plain version here, the entry
    on a card) against the materializing path and cv_tpu's
    ``_score_stage``: the same chosen model (bitwise), count and inlier
    mask; the mask recomputed from the winner's residual row alone equals
    the materialized one."""
    _, rot, tr, a, b, valid, thr = problem
    t = torch.as_tensor
    models, data, ok = TIso(t(rot), t(tr)), (t(a), t(b)), t(valid)
    cons = TConsensus(threshold=thr, hypotheses=1, device="cpu")
    cm, cmask, ccount, ctotal = cons._score_stage(TEST, models, data, ok)
    mm, mmask, mcount, mtotal = cons._score_stage(MATERIALIZING, models, data, ok)
    jm, jmask, jcount, _ = JConsensus(threshold=thr, hypotheses=1)._score_stage(
        JEST, JIso(rotation=jnp.asarray(rot), translation=jnp.asarray(tr)), (jnp.asarray(a), jnp.asarray(b)),
        jnp.asarray(valid))
    assert int(ccount) == int(mcount) == int(jcount) > 0
    for got in (cmask, mmask):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jmask))
    for name in ("rotation", "translation"):
        _same_bits(getattr(cm, name).numpy(), getattr(mm, name).numpy())
        _same_bits(getattr(cm, name).numpy(), np.asarray(getattr(jm, name)))
    np.testing.assert_allclose(float(ctotal), float(mtotal), rtol=TOTAL_RTOL, atol=0)


def test_counted_prescore_keeps_the_same_models(counted):
    """``_prescore_stage`` through the score against the materializing path
    on a scene's block of 8 rows: the same models kept, in order."""
    a, b = _scene(2, n=16)
    rot, tr = _models(a, b, 2, 24)
    t = torch.as_tensor
    models, data = TIso(t(rot), t(tr)), (t(a), t(b))
    valid, block = torch.ones(len(a), dtype=torch.bool), torch.arange(8)
    cons = TConsensus(threshold=1e-3, hypotheses=24, prescore_matches=8, prescore_keep=16, device="cpu")
    kept = [cons._prescore_stage(est, models, data, valid, block) for est in (TEST, MATERIALIZING)]
    for name in ("rotation", "translation"):
        _same_bits(getattr(kept[0], name).numpy(), getattr(kept[1], name).numpy())


def test_score_stages_without_a_score_or_on_a_cpu_materialize():
    """Only an estimator with ``score`` on a CUDA card scores by counts: the
    engine's essential estimator carries one, the P3P estimator and
    estimators built without it do not, and CPU data keeps the
    materializing path."""
    from cv_tpu_torch.sfm.engine import DEFAULT_POSE_ESTIMATOR

    cpu = (torch.zeros(3, 3),)
    assert TEST.score is not None and DEFAULT_POSE_ESTIMATOR.score is None and MATERIALIZING.score is None
    assert not tbatch._counts_first(TEST, cpu) and not tbatch._counts_first(MATERIALIZING, cpu)
