"""Batched small symmetric eigensolvers (cyclic Jacobi).

Port of ``cv_tpu/ops/eigen.py``.  The cyclic Jacobi sweep is kept as
written (not ``torch.linalg.eigh``) so eigenvector order and sign follow
the reference: the consensus residual picks an eigenvector, and the
eight-point solver reads the nullspace vector's sign into the pose.
"""

from __future__ import annotations

import torch
from .precision import full_f32


def eigh_small(a: torch.Tensor, sweeps: int = 6):
    """Eigendecomposition of symmetric ``(..., N, N)`` matrices (N small).

    Returns ``(eigenvalues (..., N) ascending, eigenvectors (..., N, N))``
    with eigenvectors in columns.  A Python loop over sweeps and the
    ``N (N - 1) / 2`` rotation pairs; every rotation is batched.  The
    rotations run on a batch-last copy, ``(N, N, batch)``, so that a row
    or column of every matrix is one contiguous slice; the arithmetic is
    elementwise and the same in any layout.
    """
    n = a.shape[-1]
    batch = a.shape[:-2]
    pairs = [(p, q) for p in range(n) for q in range(p + 1, n)]
    a = a.reshape(-1, n, n).permute(1, 2, 0).contiguous()
    v = torch.eye(n, dtype=a.dtype, device=a.device)[:, :, None].expand(a.shape).contiguous()
    for _ in range(sweeps):
        for p, q in pairs:
            app = a[p, p]
            aqq = a[q, q]
            apq = a[p, q]
            # Jacobi angle annihilating a[p, q]: theta = atan2(2 apq, aqq - app)/2
            theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
            c = torch.cos(theta)
            s = torch.sin(theta)
            # A <- G^T A G with G the (p, q) Givens rotation; both new
            # columns (rows) are computed before either is written.
            col_p, col_q = a[:, p], a[:, q]
            new_p, new_q = c * col_p - s * col_q, s * col_p + c * col_q
            a[:, p], a[:, q] = new_p, new_q
            row_p, row_q = a[p], a[q]
            new_p, new_q = c * row_p - s * row_q, s * row_p + c * row_q
            a[p], a[q] = new_p, new_q
            # Accumulate eigenvectors: V <- V G.
            vp, vq = v[:, p], v[:, q]
            new_p, new_q = c * vp - s * vq, s * vp + c * vq
            v[:, p], v[:, q] = new_p, new_q

    a = a.permute(2, 0, 1).reshape(batch + (n, n))
    v = v.permute(2, 0, 1).reshape(batch + (n, n))
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    order = torch.sort(w, dim=-1, stable=True).indices
    w = torch.gather(w, -1, order)
    v = torch.gather(v, -1, order[..., None, :].expand(v.shape))
    return w, v


def eigh4(a: torch.Tensor, sweeps: int = 6):
    """Symmetric 4x4 batch eigendecomposition (see :func:`eigh_small`)."""
    return eigh_small(a, sweeps=sweeps)


@full_f32
def svd3(e: torch.Tensor, sweeps: int = 8):
    """SVD of ``(..., 3, 3)`` batches via Jacobi on E^T E.

    Returns ``(u, s, vt)`` with singular values descending.  The left
    vector of the smallest singular value is completed by a cross product
    when that value is (near) zero — the rank-2 essential-matrix case this
    exists for.
    """
    b = e.transpose(-1, -2) @ e
    w, v = eigh_small(b, sweeps=sweeps)  # ascending
    # Descending order.
    w = w.flip(-1)
    v = v.flip(-1)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    ev = e @ v  # columns: s_i * u_i
    s0 = s[..., 0:1]
    tol = torch.finfo(e.dtype).eps ** 0.5 * torch.clamp(s0, min=1e-30)
    safe = torch.where(s <= tol, torch.ones_like(s), s)
    u = ev / safe[..., None, :]
    u0, u1 = u[..., :, 0], u[..., :, 1]
    u2 = torch.where(
        (s[..., 2] <= tol[..., 0])[..., None], torch.linalg.cross(u0, u1), u[..., :, 2]
    )
    u = u.clone()
    u[..., :, 2] = u2
    # Degenerate rank<2 batches: fall back to orthonormal completion of u1.
    u1_ok = s[..., 1] > tol[..., 0]
    ex = torch.zeros_like(u0)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(u0)
    ey[..., 1] = 1.0
    alt = torch.linalg.cross(u0, ex)
    alt_norm = torch.linalg.vector_norm(alt, dim=-1, keepdim=True)
    alt = torch.where(alt_norm > 0.1, alt, torch.linalg.cross(u0, ey))
    alt = alt / torch.linalg.vector_norm(alt, dim=-1, keepdim=True)
    u[..., :, 1] = torch.where(u1_ok[..., None], u[..., :, 1], alt)
    u[..., :, 2] = torch.where(
        u1_ok[..., None], u[..., :, 2], torch.linalg.cross(u0, u[..., :, 1])
    )
    return u, s, v.transpose(-1, -2)
