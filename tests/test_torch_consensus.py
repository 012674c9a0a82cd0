"""cv_tpu_torch's consensus with an inlier-refit round against cv_tpu's:
given the same minimal sets, the same model, inlier mask and count.

The two packages draw their minimal sets from different generators, so the
sets are fixed here with NumPy and handed to both.  cv_tpu's
``model_inliers`` draws internally; its refit logic (engine.py's
``refit_rounds=1``) is replayed from its own stage functions.  The engine's
P3P estimator on a PnP problem with 25% outliers, float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.consensus import BatchConsensus as RefConsensus
from cv_tpu.sfm import engine as ref_engine
from cv_tpu.sfm.se3 import so3_exp
from cv_tpu_torch.consensus import BatchConsensus
from cv_tpu_torch.ops import eigen
from cv_tpu_torch.sfm import engine
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)


def _problem(seed, n=128, outliers=32):
    rng = np.random.default_rng(seed)
    rot, t = so3_exp(np.array([0.1, 0.2, 0.3])), np.array([0.1, 0.2, 0.3])
    cam = rng.uniform([-1, -1, 1], [1, 1, 6], (n, 3))
    world = (cam - t) @ rot
    bear = cam / np.linalg.norm(cam, axis=1, keepdims=True)
    bear[:outliers] = rng.normal(size=(outliers, 3))
    bear[:outliers] /= np.linalg.norm(bear[:outliers], axis=1, keepdims=True)
    wp = np.concatenate([world, np.ones((n, 1))], axis=1)
    wp /= np.linalg.norm(wp[:, :3], axis=1, keepdims=True)
    return rng, bear, wp


def _reference(cons, bear, wp, n_valid, sample_idx, refit_idx):
    """cv_tpu's two-round model_inliers with the minimal sets fixed."""
    est = ref_engine.DEFAULT_POSE_ESTIMATOR
    data = (jnp.asarray(bear), jnp.asarray(wp))
    valid_row = jnp.arange(bear.shape[0]) < n_valid

    def run(idx):
        models = est.estimate(tuple(x[jnp.asarray(idx)] for x in data))
        return cons._score_stage(est, models, data, valid_row)

    model, mask, count, total = run(sample_idx)
    m2, k2, c2, t2 = run(refit_idx)
    take = bool((c2 > count) | ((c2 == count) & (t2 < total)))
    if take:
        model, mask, count = m2, k2, c2
    return model, np.asarray(mask), int(count)


@pytest.fixture(autouse=True, scope="module")
def _cheap_consensus():
    """On a CPU the exact forms of this module's consensus runs and solver
    batches cost tens of times the cheap ones (``scripts/cpu_costs.py``):
    the module opts into the cheap CPU forms (``ops.eigen.cheap_on_cpu``,
    within a few ulps of cv_tpu's bits), which every CPU caller took before
    the exact forms became the default."""
    with eigen.cheap_on_cpu():
        yield


@pytest.mark.parametrize("seed", [0, 1])
def test_refit_round_matches_cv_tpu(seed):
    rng, bear, wp = _problem(seed)
    n_valid = 120  # the last 8 rows are padding
    sample_idx = rng.integers(0, n_valid, (64, 3))
    # Round one's inliers: the rows past the outliers; the refit draws its
    # minimal sets from them as the engine's refit does.
    ref_cons = RefConsensus(threshold=1e-9, hypotheses=64, refit_rounds=1, refit_hypotheses=32)
    m1, mask1, _ = _reference(
        RefConsensus(threshold=1e-9), bear, wp, n_valid, sample_idx, sample_idx
    )
    inl = np.nonzero(mask1)[0]
    assert len(inl) >= 3
    refit_idx = inl[rng.integers(0, len(inl), (32, 3))]
    model, mask, count = _reference(ref_cons, bear, wp, n_valid, sample_idx, refit_idx)

    cons = BatchConsensus(threshold=1e-9, hypotheses=64, refit_rounds=1, refit_hypotheses=32, device="cpu")
    got_model, got_mask, got_count = cons.model_inliers(
        torch.Generator().manual_seed(0),
        engine.DEFAULT_POSE_ESTIMATOR,
        (torch.tensor(bear), torch.tensor(wp)),
        n_valid=n_valid,
        sample_idx=torch.tensor(sample_idx),
        refit_idx=[torch.tensor(refit_idx)],
    )
    assert int(got_count) == count >= 80
    np.testing.assert_array_equal(got_mask.numpy(), mask)
    np.testing.assert_allclose(got_model.rotation.numpy(), np.asarray(model.rotation), atol=1e-9, rtol=0)
    np.testing.assert_allclose(got_model.translation.numpy(), np.asarray(model.translation), atol=1e-9, rtol=0)
