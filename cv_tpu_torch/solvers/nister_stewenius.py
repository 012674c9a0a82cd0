"""Batched Nister-Stewenius five-point relative pose.

Port of ``cv_tpu/solvers/nister_stewenius.py`` (reference
nister-stewenius/src/lib.rs): the 20-monomial polynomial ring, Nister's
10x20 constraint matrix, then the action matrix's real eigenvectors.  As in
``cv_tpu`` the nonsymmetric 10x10 eigenproblem is the action matrix
balanced (Osborne), its characteristic polynomial (Faddeev-LeVerrier), all
ten roots at once by Durand-Kerner and each eigenvector by inverse
iteration, batched over every minimal set of a consensus call (40 candidate
poses a set).

Everything runs in float64, and the Durand-Kerner stage in complex128.
``cv_tpu`` keeps float32 inputs in float32 on its TPU and computes the
precision-critical stages in double-word arithmetic there; the port has no
such branch: given float32 sets it computes in float64 and returns poses in
the caller's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera import essential as essential_mod
from ..core.pose import CameraToCamera
from ..ops.eigen import eigh_small
from ..ops.precision import full_f32

MIN_SAMPLES = 5
MAX_ESSENTIALS = 10
MODELS_PER_SAMPLE = 40

EIGEN_THRESHOLD = 1e-12
DK_ITERS = 80
INV_ITERS = 3

# Monomial basis indices (lib.rs:15-34).
XXX, XXY, XYY, YYY, XXZ, XYZ, YYZ, XZZ, YZZ, ZZZ = range(10)
XX, XY, YY, XZ, YZ, ZZ, X, Y, Z, ONE = range(10, 20)


def _o1(a, b):
    """Product of two degree-1 polynomials in (x, y, z, w) (lib.rs:98-114):
    ``a``/``b`` (..., 4) -> (..., 20)."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    zero = torch.zeros_like(ax)
    out = [zero] * 20
    out[XX] = ax * bx
    out[XY] = ax * by + ay * bx
    out[XZ] = ax * bz + az * bx
    out[YY] = ay * by
    out[YZ] = ay * bz + az * by
    out[ZZ] = az * bz
    out[X] = ax * bw + aw * bx
    out[Y] = ay * bw + aw * by
    out[Z] = az * bw + aw * bz
    out[ONE] = aw * bw
    return torch.stack(out, dim=-1)


def _o2(a, b):
    """Degree-2 polynomial (..., 20) times degree-1 (..., 4) (lib.rs:116-140)."""
    bx, by, bz, bw = b.unbind(-1)
    g = lambda i: a[..., i]  # noqa: E731
    out = [None] * 20
    out[XXX] = g(XX) * bx
    out[XXY] = g(XX) * by + g(XY) * bx
    out[XXZ] = g(XX) * bz + g(XZ) * bx
    out[XYY] = g(XY) * by + g(YY) * bx
    out[XYZ] = g(XY) * bz + g(YZ) * bx + g(XZ) * by
    out[XZZ] = g(XZ) * bz + g(ZZ) * bx
    out[YYY] = g(YY) * by
    out[YYZ] = g(YY) * bz + g(YZ) * by
    out[YZZ] = g(YZ) * bz + g(ZZ) * by
    out[ZZZ] = g(ZZ) * bz
    out[XX] = g(XX) * bw + g(X) * bx
    out[XY] = g(XY) * bw + g(X) * by + g(Y) * bx
    out[XZ] = g(XZ) * bw + g(X) * bz + g(Z) * bx
    out[YY] = g(YY) * bw + g(Y) * by
    out[YZ] = g(YZ) * bw + g(Y) * bz + g(Z) * by
    out[ZZ] = g(ZZ) * bw + g(Z) * bz
    out[X] = g(X) * bw + g(ONE) * bx
    out[Y] = g(Y) * bw + g(ONE) * by
    out[Z] = g(Z) * bw + g(ONE) * bz
    out[ONE] = g(ONE) * bw
    return torch.stack(out, dim=-1)


@full_f32
def nullspace_basis(a: torch.Tensor, b: torch.Tensor):
    """4-dim nullspace of the 5x9 epipolar constraint (lib.rs:68-96).

    ``a``/``b``: (..., 5, 3). Returns ``(basis (..., 9, 4), ok)``; ``ok``
    requires nullity exactly 4: the 9x9 Gram's eigenvalues (Jacobi, 8
    sweeps, ascending) at or below ``EIGEN_THRESHOLD`` up to the fourth and
    above it from the fifth.
    """
    rows = (a[..., :, None] * b[..., None, :]).reshape(a.shape[:-1] + (9,))
    vals, vecs = eigh_small(rows.transpose(-1, -2) @ rows, sweeps=8, exact=False)
    ok = (vals[..., 3] <= EIGEN_THRESHOLD) & (vals[..., 4] > EIGEN_THRESHOLD)
    return vecs[..., :, :4], ok


def polynomial_constraints(basis: torch.Tensor) -> torch.Tensor:
    """The 10x20 constraint matrix (lib.rs:142-204). ``basis``: (..., 9, 4)."""
    ep = [[basis[..., 3 * i + j, :] for j in range(3)] for i in range(3)]
    rows = [
        _o2(_o1(ep[0][1], ep[1][2]) - _o1(ep[0][2], ep[1][1]), ep[2][0])
        + _o2(_o1(ep[0][2], ep[1][0]) - _o1(ep[0][0], ep[1][2]), ep[2][1])
        + _o2(_o1(ep[0][0], ep[1][1]) - _o1(ep[0][1], ep[1][0]), ep[2][2])
    ]
    eet = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            eet[i][j] = _o1(ep[i][0], ep[j][0]) + _o1(ep[i][1], ep[j][1]) + _o1(ep[i][2], ep[j][2])
            eet[j][i] = eet[i][j]
    trace = 0.5 * (eet[0][0] + eet[1][1] + eet[2][2])
    lm = [[eet[i][j] - trace if i == j else eet[i][j] for j in range(3)] for i in range(3)]
    for i in range(3):
        for j in range(3):
            rows.append(_o2(lm[i][0], ep[0][j]) + _o2(lm[i][1], ep[1][j]) + _o2(lm[i][2], ep[2][j]))
    return torch.stack(rows, dim=-2)  # (..., 10, 20)


def action_matrix(constraints: torch.Tensor):
    """Gauss-Jordan elimination and the action matrix (lib.rs:256-280):
    ``(at (..., 10, 10), ok)``, ``ok`` False (and ``at`` zero) where the
    left 10x10 block is singular."""
    m, info = torch.linalg.solve_ex(constraints[..., :, :10], constraints[..., :, 10:])
    ok = torch.isfinite(m).all(dim=-1).all(dim=-1) & (info == 0)
    m = torch.where(ok[..., None, None], m, torch.zeros_like(m))
    at = torch.zeros_like(m)
    at[..., 0:3, :] = m[..., 0:3, :]
    at[..., 3, :] = m[..., 4, :]
    at[..., 4, :] = m[..., 5, :]
    at[..., 5, :] = m[..., 7, :]
    at[..., 6, 0] = -1.0
    at[..., 7, 1] = -1.0
    at[..., 8, 3] = -1.0
    at[..., 9, 6] = -1.0
    return at, ok


@full_f32
def real_eigen_10(at: torch.Tensor):
    """Real eigenvalues and eigenvectors of a batch of 10x10 matrices.

    The matrix is balanced (Osborne: power-of-two similarity scaling, four
    sweeps), its characteristic polynomial taken (Faddeev-LeVerrier), all
    ten roots found at once (Durand-Kerner, ``DK_ITERS`` steps in complex
    arithmetic on the roots scaled into about the unit disc), and each
    root's real part polished into an eigenpair by inverse iteration with
    Rayleigh quotients.  A pair is valid when its eigen-residual is at most
    ``1e-7`` of the Gershgorin radius.  Replaces the reference's
    ``complex_eigenvalues`` and per-eigenvalue SVD (lib.rs:206-233).

    Returns ``(eigvals (..., 10), eigvecs (..., 10, 10), valid (..., 10))``.
    """
    n = 10
    dtype, dev = at.dtype, at.device
    eye = torch.eye(n, dtype=dtype, device=dev)
    at = at.clone()
    # Osborne balancing; ``d`` accumulates the similarity diagonal so the
    # eigenvectors can be mapped back: balanced = D^-1 A D => v_A = D v.
    d = torch.ones(at.shape[:-1], dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    for _ in range(4):
        for i in range(n):
            col = at[..., :, i].abs().sum(dim=-1) - at[..., i, i].abs()
            row = at[..., i, :].abs().sum(dim=-1) - at[..., i, i].abs()
            safe = (col > 0) & (row > 0)
            f = torch.where(safe, torch.sqrt(row / torch.where(safe, col, one)), one)
            f = torch.exp2(torch.round(torch.log2(f)))
            at[..., :, i] *= f[..., None]
            at[..., i, :] /= f[..., None]
            d[..., i] *= f

    # Faddeev-LeVerrier: poly[0] = 1 (monic), poly[k] = -trace(M_k) / k.
    coeffs = [torch.ones(at.shape[:-2], dtype=dtype, device=dev)]
    mk = at
    for k in range(1, n + 1):
        ck = -torch.diagonal(mk, dim1=-2, dim2=-1).sum(dim=-1) / k
        coeffs.append(ck)
        if k < n:
            mk = at @ (mk + ck[..., None, None] * eye)
    poly = torch.stack(coeffs, dim=-1)  # (..., 11)

    # Durand-Kerner on lambda = s mu, s the Gershgorin radius, so the roots
    # lie in about the unit disc and a unit-circle start converges.
    radius = at.abs().sum(dim=-1).max(dim=-1).values + 1.0
    powers = radius[..., None] ** torch.arange(n + 1, dtype=dtype, device=dev)
    poly_s = (poly / powers).to(torch.complex128)
    angles = 2.0 * np.pi * np.arange(n) / n + 0.4
    z = torch.complex(torch.as_tensor(np.cos(angles)), torch.as_tensor(np.sin(angles))).to(dev)
    z = z.expand(poly.shape[:-1] + (n,))
    eye_c = torch.eye(n, dtype=torch.complex128, device=dev)
    zero_c = torch.zeros((), dtype=torch.complex128, device=dev)
    for _ in range(DK_ITERS):
        diff = z[..., :, None] - z[..., None, :] + eye_c  # self-differences masked to 1
        p = diff[..., 0]
        for kk in range(1, n):
            p = p * diff[..., kk]
        h = poly_s[..., 0:1].expand(z.shape)
        for k in range(1, n + 1):
            h = h * z + poly_s[..., k : k + 1]
        step = h / p
        ok_step = torch.isfinite(step.real) & torch.isfinite(step.imag)
        z = z - torch.where(ok_step, step, zero_c)
    # Every root's real part is a candidate: inverse iteration polishes it,
    # and the eigen-residual decides (a candidate from a complex pair either
    # lands on a real eigenvalue, a harmless duplicate model, or is dropped).
    lam = z.real.to(dtype) * radius[..., None]

    reg = (1e-12 * radius)[..., None, None, None] * eye
    v = torch.ones(lam.shape + (n,), dtype=dtype, device=dev)
    for _ in range(INV_ITERS + 2):
        m_shift = at[..., None, :, :] - lam[..., :, None, None] * eye + reg
        # solve_ex does not raise on a singular shift; the finite test below
        # keeps the previous vector then.
        v_new = torch.linalg.solve_ex(m_shift, v[..., :, None])[0][..., 0]
        v_new = v_new / torch.linalg.vector_norm(v_new, dim=-1, keepdim=True)
        v = torch.where(torch.isfinite(v_new).all(dim=-1)[..., None], v_new, v)
        av = (at @ v.transpose(-1, -2)).transpose(-1, -2)
        lam = (v * av).sum(dim=-1)  # Rayleigh quotient
    av = (at @ v.transpose(-1, -2)).transpose(-1, -2)
    resid = torch.linalg.vector_norm(av - lam[..., None] * v, dim=-1)
    valid = resid <= 1e-7 * radius[..., None]
    # Undo the balancing similarity on the eigenvectors.
    v = v * d[..., None, :]
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return lam, v, valid & torch.isfinite(v).all(dim=-1)


def essentials_from_matches(a: torch.Tensor, b: torch.Tensor):
    """Up to 10 essential matrices per 5-point sample (lib.rs:241-280).

    ``a``/``b``: (..., 5, 3). Returns ``(E (..., 10, 3, 3), valid (..., 10))``.
    """
    basis, ok0 = nullspace_basis(a, b)
    at, ok1 = action_matrix(polynomial_constraints(basis))
    _, vecs, ok2 = real_eigen_10(at)
    # The solution (x, y, z, w) is eigenvector components 6..9 of the
    # reduced monomial basis [xx, xy, yy, xz, yz, zz, x, y, z, 1], as in
    # Stewenius' published MATLAB (V([7 8 9 10])).  The reference reads rows
    # 5..8 (lib.rs:230), off by one: with that window it never recovers a
    # valid essential matrix, and v[6:10] reproduces E_true to 1e-13.
    v4 = vecs[..., 6:10]  # (..., 10, 4)
    e_flat = (basis[..., None, :, :] * v4[..., :, None, :]).sum(dim=-1)  # (..., 10, 9)
    # Matrix3::from_iterator is column-major: E[r, c] = flat[3c + r].
    e = e_flat.reshape(e_flat.shape[:-1] + (3, 3)).transpose(-1, -2)
    return e, ok0[..., None] & ok1[..., None] & ok2


def estimate(a: torch.Tensor, b: torch.Tensor):
    """Estimator::estimate (lib.rs:305-330): (..., 5, 3) matches ->
    ``(CameraToCamera with batch (..., 40), valid (..., 40))``, computed in
    float64 and returned in the inputs' dtype."""
    dtype = a.dtype
    e, valid = essentials_from_matches(a.to(torch.float64), b.to(torch.float64))
    poses4 = essential_mod.possible_unscaled_poses(e)  # batch (..., 10, 4)
    shape = tuple(poses4.batch_shape[:-2]) + (MODELS_PER_SAMPLE,)
    rotation = poses4.rotation.reshape(shape + (3, 3))
    valid40 = valid.repeat_interleave(4, dim=-1) & torch.isfinite(rotation).all(dim=-1).all(dim=-1)
    poses = CameraToCamera(rotation=rotation.to(dtype), translation=poses4.translation.reshape(shape + (3,)).to(dtype))
    return poses, valid40
