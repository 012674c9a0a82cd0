"""Levenberg-Marquardt nonlinear least squares.

Port of ``cv_tpu/optimize/lm.py``, the counterpart of the reference's
``cv::optimize::lm`` facade (cv/src/lib.rs:124-129, a MINPACK-style LM over
a residual and its Jacobian).  The reference's pipeline never calls it; it
is public surface for fitting arbitrary models.

The solver is a function over a residual callable; the Jacobian comes from
``torch.func.jacfwd`` unless one is supplied.  ``cv_tpu`` batches problems
with ``jax.vmap``; here ``x0`` may carry a leading batch axis, the residual
and the Jacobian are mapped over it with ``torch.func.vmap``, and each
problem stops on its own: a finished problem's state is frozen while the
others iterate.  One flag a step is read back to the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.precision import full_f32


class LMResult(NamedTuple):
    """Solution and convergence report (the crate's ``MinimizationReport``);
    every field has the problems' batch shape."""

    x: torch.Tensor  # (..., N) final parameters
    cost: torch.Tensor  # 0.5 * ||f||^2 at x
    iterations: torch.Tensor  # int32 accepted + rejected steps taken
    converged: torch.Tensor  # bool: a tolerance was met before max_iterations


@full_f32
def levenberg_marquardt(
    residuals: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    jacobian: Callable[..., torch.Tensor] | None = None,
    *,
    args: tuple = (),
    max_iterations: int = 100,
    initial_lambda: float = 1e-3,
    lambda_up: float = 10.0,
    lambda_down: float = 0.1,
    gtol: float = 1e-10,
    ftol: float = 1e-12,
) -> LMResult:
    """Minimize ``0.5 * ||residuals(x)||^2`` from ``x0``.

    ``residuals(x, *args)`` maps (N,) parameters to (M,) residuals;
    ``jacobian(x, *args)``, if given, to the (M, N) Jacobian.  ``x0`` is
    (N,), or a batch (B, N) of problems whose ``args`` tensors carry the
    same leading batch axis (each problem's data).  Damped
    normal equations with Marquardt scaling: ``(J^T J + lambda diag(J^T J))
    dx = -J^T f``, the diagonal floored at the dtype's ``tiny``; an accepted
    step (finite and lower cost) multiplies ``lambda`` by ``lambda_down``, a
    rejected one by ``lambda_up``.  A problem stops when its max-abs
    gradient falls below ``gtol``, an accepted step improves its cost by
    less than ``ftol`` relative, or after ``max_iterations`` steps.
    """
    jacobian = torch.func.jacfwd(residuals) if jacobian is None else jacobian
    x = torch.as_tensor(x0)
    single = x.ndim == 1
    if single:
        x = x[None]
        args = tuple(torch.as_tensor(a)[None] for a in args)
    f_batch, j_batch = torch.func.vmap(residuals), torch.func.vmap(jacobian)
    f_of = lambda x: f_batch(x, *args)  # noqa: E731
    j_of = lambda x: j_batch(x, *args)  # noqa: E731
    dtype, dev = x.dtype, x.device
    eps = torch.tensor(torch.finfo(dtype).tiny, dtype=dtype, device=dev)

    def cost_of(x):
        f = f_of(x)
        return 0.5 * (f * f).sum(dim=-1)

    cost = cost_of(x)
    lam = torch.full(cost.shape, initial_lambda, dtype=dtype, device=dev)
    it = torch.zeros(cost.shape, dtype=torch.int32, device=dev)
    done = torch.zeros(cost.shape, dtype=torch.bool, device=dev)
    active = ~done & (it < max_iterations)
    while bool(active.any()):
        f, j = f_of(x), j_of(x)  # (B, M), (B, M, N)
        jtj = j.transpose(-1, -2) @ j
        g = (j.transpose(-1, -2) @ f[..., None])[..., 0]
        d = torch.maximum(torch.diagonal(jtj, dim1=-2, dim2=-1), eps)
        dx = -torch.linalg.solve_ex(jtj + lam[:, None, None] * torch.diag_embed(d), g[..., None])[0][..., 0]
        x_new = x + dx
        cost_new = cost_of(x_new)
        accept = torch.isfinite(cost_new) & (cost_new < cost)
        rel_improve = (cost - cost_new) / torch.maximum(cost, eps)
        stop = (g.abs().max(dim=-1).values < gtol) | (accept & (rel_improve < ftol))
        take = active & accept
        x = torch.where(take[:, None], x_new, x)
        lam = torch.where(active, torch.where(accept, lam * lambda_down, lam * lambda_up), lam)
        cost = torch.where(take, cost_new, cost)
        it = it + active.to(torch.int32)
        done = done | (active & stop)
        active = ~done & (it < max_iterations)
    if single:
        return LMResult(x=x[0], cost=cost[0], iterations=it[0], converged=done[0])
    return LMResult(x=x, cost=cost, iterations=it, converged=done)
