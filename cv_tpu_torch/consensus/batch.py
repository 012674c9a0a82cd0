"""Batched sample consensus (the ARRSAC slot of the reference).

Port of ``cv_tpu/consensus/batch.py``: a fixed budget of minimal sets is
drawn up front, every minimal problem is solved in one batched estimator
call, every (hypothesis, model) pair is scored against every data row, and
the best model is the exact two-stage lexicographic maximum (inlier count,
then least total inlier residual).

Random draws come from an explicit ``torch.Generator`` on the consensus
device.  They are not the JAX package's draws; the estimate stage also
takes precomputed sample indices, so a caller (or a test) can hand both
packages the same minimal sets.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def _tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a tuple/list/dataclass tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(
            **{f.name: _tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        )
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def _tree_where(cond: torch.Tensor, new, old):
    """Elementwise ``where(cond, new, old)`` over two trees of one shape."""
    if isinstance(new, torch.Tensor):
        return torch.where(cond, new, old)
    if isinstance(new, (tuple, list)):
        return type(new)(_tree_where(cond, a, b) for a, b in zip(new, old))
    return type(new)(
        **{f.name: _tree_where(cond, getattr(new, f.name), getattr(old, f.name)) for f in dataclasses.fields(new)}
    )


def _tree_cat(trees):
    """Concatenate same-structured trees along their leading axis."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(trees)
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_cat(list(parts)) for parts in zip(*trees))
    return type(first)(**{f.name: _tree_cat([getattr(t, f.name) for t in trees]) for f in dataclasses.fields(first)})


def _first_leaf(tree) -> torch.Tensor:
    while not isinstance(tree, torch.Tensor):
        tree = tree[0] if isinstance(tree, (tuple, list)) else getattr(
            tree, dataclasses.fields(tree)[0].name
        )
    return tree


def _top_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, equal
    values at the lower index first (``jax.lax.top_k``'s order)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


@dataclasses.dataclass(frozen=True)
class Estimator:
    """A minimal solver: maps sampled data to a batch of candidate models.

    * ``min_samples``: size of a minimal sample set.
    * ``estimate``: tree of ``(..., min_samples, ...)`` tensors -> models
      tree with batch shape ``(..., models_per_sample)``.
    * ``residual``: (models with batch shape S, data tree of ``(N, ...)``)
      -> residuals ``S + (N,)``.
    * ``score`` (optional): (models with batch shape S, data tree, valid
      rows ``(N,)``, threshold) -> ``(counts S, totals S)`` of each model's
      inliers (``residual < threshold``, valid, finite), without the
      residuals.  Where it is set, the stages on a CUDA card take it; the
      totals are summed in its own order.  Without it (and on a CPU) they
      score through ``residual``.
    """

    min_samples: int
    models_per_sample: int
    estimate: Callable[..., Any]
    residual: Callable[..., Any]
    score: Callable[..., Any] | None = None


def _lexicographic_best(models, flat_counts, flat_total):
    """The index of the model with the most inliers, ties broken by the
    least total (a true two-stage argmax, never a folded float score), and
    that model."""
    at_max = flat_counts == flat_counts.max()
    # argmin returns the first index among equal totals: exact ties keep the
    # first-drawn model.
    best = torch.argmin(torch.where(at_max, flat_total, torch.inf))
    return best, _tree_map(lambda x: x.reshape((-1,) + x.shape[2:])[best], models)


def _counts_first(estimator: Estimator, data) -> bool:
    """Whether the stages score through ``estimator.score``."""
    return estimator.score is not None and _first_leaf(data).device.type == "cuda"


# The most (model, data row) pairs whose residuals are materialized at once
# in the scoring stage of an estimator without a ``score`` (or on a CPU):
# a block holds its residuals and masks (~17 bytes a pair), and on a CPU
# the plain residual's intermediates (~300 bytes a pair) set the size.
SCORE_BLOCK = 1 << 22
# Hypothesis shares start at multiples of this many hypotheses.  On a CPU
# the vectorized transcendental functions (the Jacobi sweeps' atan2, cos and
# sin) round the vector body and the scalar tail of a loop differently, so
# an element's bits depend on its offset modulo the vector width; a share
# that starts at a multiple of 64 keeps every element's offset, and with it
# the unsharded run's bits.
SHARD_ALIGN = 64


@dataclasses.dataclass(frozen=True)
class BatchConsensus:
    """Fixed-budget batched consensus on ``device`` (the CUDA card unless
    the caller asks for the CPU).

    ``threshold``: inlier residual threshold.  ``hypotheses``: minimal sets
    drawn per call.  ``refit_rounds``/``refit_hypotheses``: inlier-refit
    rounds, each drawing ``refit_hypotheses`` minimal sets from the best
    model's inliers and keeping the overall lexicographic best (the batched
    analog of ARRSAC's refinement; the engine runs one round of 256).
    ``prescore_matches`` > 0 turns on ARRSAC-style preemption: every model
    is first scored on a random block of that many rows and only the best
    ``prescore_keep`` graduate to full scoring.  ``hypothesis_sharding``: a
    mesh (a tuple of devices, :func:`cv_tpu_torch.parallel.make_mesh`) over
    which the hypotheses are split: each device solves and scores its
    contiguous share, and the shares' counts and totals come back to
    ``device`` for the selection.  The draws stay on ``device``, so the
    answers equal the unsharded run's.
    """

    threshold: float
    hypotheses: int = 1024
    refit_rounds: int = 0
    refit_hypotheses: int = 256
    prescore_matches: int = 0
    prescore_keep: int = 256
    device: Any = torch.device("cuda")
    hypothesis_sharding: Any = None

    def _sharded(self, n: int, fn):
        """``fn(rows, device)`` on each mesh device's share ``rows`` (a slice)
        of ``n`` hypotheses, or once on the whole on ``device`` when
        unsharded; the results' tensors on ``device``, in order.  Shares
        are whole multiples of ``SHARD_ALIGN`` hypotheses (the last takes the
        rest), so trailing devices may get none."""
        mesh = self.hypothesis_sharding
        if not mesh:
            return [fn(slice(0, n), torch.device(self.device))]
        step = -(-n // len(mesh))
        step = -(-step // SHARD_ALIGN) * SHARD_ALIGN
        return [_tree_map(lambda x: x.to(self.device), fn(slice(a, a + step), torch.device(d)))
                for a, d in zip(range(0, n, step), mesh)]

    def sample_indices(self, generator, sample_mask, n_hyp: int, m: int):
        """``(n_hyp, m)`` minimal-set row indices by masked Gumbel top-k:
        rows where ``sample_mask`` is False are drawn last."""
        u = torch.rand(
            (n_hyp, sample_mask.shape[0]),
            generator=generator,
            dtype=torch.float64,
            device=sample_mask.device,
        )
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        gumbel = torch.where(sample_mask, gumbel, -torch.inf)
        return _top_indices(gumbel, m)

    def _estimate_stage(self, estimator, data, idx):
        """Solve the minimal sets ``idx`` ``(H, m)``: returns the candidate
        models with batch shape ``(H, models_per_sample)``."""
        parts = self._sharded(idx.shape[0], lambda rows, d: estimator.estimate(
            _tree_map(lambda x: x.to(d)[idx[rows].to(d)], data)))
        return parts[0] if len(parts) == 1 else _tree_cat(parts)

    def prescore_block(self, generator, valid_row):
        """The random block of rows the prescore stage scores on; valid rows
        are preferred (masked Gumbel top-k)."""
        n = valid_row.shape[0]
        u = torch.rand((n,), generator=generator, dtype=torch.float64, device=valid_row.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return _top_indices(torch.where(valid_row, gumbel, -torch.inf), min(self.prescore_matches, n))

    def _prescore_stage(self, estimator, models, data, valid_row, block):
        """Keep the ``prescore_keep`` most promising models by inlier count on
        the rows ``block``, ties toward the lower block residual.  Returns a
        models tree with batch shape ``(prescore_keep, 1)``."""
        sub = _tree_map(lambda x: x[block], data)
        counted = _counts_first(estimator, data)

        def keys(rows, d):
            share = _tree_map(lambda x: x[rows].to(d), models)
            sub_d, valid_d = _tree_map(lambda x: x.to(d), sub), valid_row[block].to(d)
            if counted:
                counts, total = (x.reshape(-1) for x in estimator.score(share, sub_d, valid_d, self.threshold))
            else:
                res = estimator.residual(share, sub_d)  # (h, M, P)
                inliers = (res < self.threshold) & valid_d & torch.isfinite(res)
                counts = inliers.sum(dim=-1).reshape(-1)
                total = torch.where(inliers, res, torch.zeros_like(res)).sum(dim=-1).reshape(-1)
            # Composite preemption key: counts are small ints, and the
            # tie-break term lives in (0, 1], so it can never reorder counts.
            return counts.to(torch.float32) * 2.0 + 1.0 / (1.0 + total)

        key = torch.cat(self._sharded(_first_leaf(models).shape[0], keys))
        kidx = _top_indices(key, min(self.prescore_keep, key.shape[0]))
        return _tree_map(lambda x: x.reshape((-1,) + x.shape[2:])[kidx][:, None], models)

    def _score_stage(self, estimator, models, data, valid_row):
        """Score every candidate model against every data row and pick the
        lexicographic best: max inlier count, ties broken by least total
        inlier residual (a true two-stage argmax, never a folded float
        score; see the reference's docstring).  Returns ``(best model,
        inlier mask, inlier count, total inlier residual)``.

        The residuals are taken over blocks of hypotheses of at most
        ``SCORE_BLOCK`` (model, row) pairs: the residuals, masks and sums of
        the sandbox's budgets (8,192 hypotheses x 4 models x thousands of
        matches), and on a CPU the plain residual's intermediates (a 4x4
        eigensystem a pair), would not fit at once.  Each pair's residual,
        count and total are the same in any block.  An estimator with a
        ``score`` on a card takes :meth:`_score_counted` instead."""
        if _counts_first(estimator, data):
            return self._score_counted(estimator, models, data, valid_row)
        n = _first_leaf(data).shape[0]
        h, m = _first_leaf(models).shape[:2]
        step = max(1, SCORE_BLOCK // (m * n))

        def score(rows, d):
            share = _tree_map(lambda x: x[rows].to(d), models)
            data_d, valid_d = _tree_map(lambda x: x.to(d), data), valid_row.to(d)
            masks, counts, totals = [], [], []
            for h0 in range(0, _first_leaf(share).shape[0], step):
                res = estimator.residual(_tree_map(lambda x: x[h0 : h0 + step], share), data_d)  # (h, M, N)
                inliers = (res < self.threshold) & valid_d & torch.isfinite(res)
                masks.append(inliers.reshape(-1, n))
                counts.append(inliers.sum(dim=-1).reshape(-1))
                totals.append(torch.where(inliers, res, torch.zeros_like(res)).sum(dim=-1).reshape(-1))
            return torch.cat(masks), torch.cat(counts), torch.cat(totals)

        inliers, flat_counts, flat_total = (torch.cat(parts) for parts in zip(*self._sharded(h, score)))
        best, best_model = _lexicographic_best(models, flat_counts, flat_total)
        return best_model, inliers[best], flat_counts[best], flat_total[best]

    def _score_counted(self, estimator, models, data, valid_row):
        """:meth:`_score_stage` through ``estimator.score``: every model's
        count and total without its residuals or mask, the same
        lexicographic best, and then the winner's residual row alone (one
        ``estimator.residual`` call over the rows) for its inlier mask."""
        h = _first_leaf(models).shape[0]

        def score(rows, d):
            share = _tree_map(lambda x: x[rows].to(d), models)
            return estimator.score(share, _tree_map(lambda x: x.to(d), data), valid_row.to(d), self.threshold)

        flat_counts, flat_total = (torch.cat(parts).reshape(-1) for parts in zip(*self._sharded(h, score)))
        best, best_model = _lexicographic_best(models, flat_counts, flat_total)
        res = estimator.residual(best_model, data)  # (N,)
        mask = (res < self.threshold) & valid_row & torch.isfinite(res)
        return best_model, mask, flat_counts[best], flat_total[best]

    def _round(self, generator, estimator, data, valid_row, sample_mask, n_hyp, sample_idx):
        """One draw-solve-(prescore)-score round; returns ``(model, mask,
        count, total)``."""
        if sample_idx is None:
            sample_idx = self.sample_indices(generator, sample_mask, n_hyp, estimator.min_samples)
        models = self._estimate_stage(estimator, data, sample_idx)
        if (
            self.prescore_matches > 0
            and sample_idx.shape[0] * estimator.models_per_sample > self.prescore_keep
        ):
            block = self.prescore_block(generator, valid_row)
            models = self._prescore_stage(estimator, models, data, valid_row, block)
        return self._score_stage(estimator, models, data, valid_row)

    def model_inliers(self, generator, estimator: Estimator, data, n_valid=None, sample_idx=None, refit_idx=None):
        """Find the best model and its inlier mask.

        ``data``: tree of ``(N, ...)`` tensors on ``self.device``.
        ``n_valid``: optional count <= N of real rows (rows past it are
        padding, neither sampled nor scored).  ``sample_idx``: optional
        ``(hypotheses, min_samples)`` minimal sets to use instead of drawing
        them from ``generator``; ``refit_idx``: likewise, one
        ``(refit_hypotheses, min_samples)`` tensor per refit round (row
        indices that must lie in the incumbent's inlier set).

        Returns ``(model, inlier_mask (N,), inlier_count)``; nothing is read
        back to the host.
        """
        n = _first_leaf(data).shape[0]
        rows = torch.arange(n, device=self.device)
        valid_row = rows < (n if n_valid is None else n_valid)
        best = self._round(generator, estimator, data, valid_row, valid_row, self.hypotheses, sample_idx)
        for r in range(self.refit_rounds):
            model, mask, count, total = best
            # Sample from the current inlier set when it can fill a minimal
            # set; otherwise from all valid rows.
            enough = count >= estimator.min_samples
            sample_mask = torch.where(enough, mask & valid_row, valid_row)
            new = self._round(
                generator, estimator, data, valid_row, sample_mask, self.refit_hypotheses,
                None if refit_idx is None else refit_idx[r],
            )
            # Count first, then least total inlier residual; exact ties keep
            # the incumbent.
            take = (new[2] > count) | ((new[2] == count) & (new[3] < total))
            best = (
                _tree_where(take, new[0], model),
                torch.where(take, new[1], mask),
                torch.where(take, new[2], count),
                torch.where(take, new[3], total),
            )
        return best[0], best[1], best[2]
