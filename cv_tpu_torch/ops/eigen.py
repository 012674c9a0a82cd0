"""Batched small symmetric eigensolvers (cyclic Jacobi).

Port of ``cv_tpu/ops/eigen.py``.  The cyclic Jacobi sweep is kept as
written (not ``torch.linalg.eigh``) so eigenvector order and sign follow
the reference: the consensus residual picks an eigenvector, and the
eight-point solver reads the nullspace vector's sign into the pose.

The reference is bit for bit ``cv_tpu``'s jitted ``eigh_small``: XLA's CPU
backend computes the rotation angle with glibc's ``atan2`` and its cosine
and sine with glibc's ``cos`` and ``sin`` (``ops/trig.py`` writes them out),
and it contracts every Givens update into a fused multiply-add whose
product ``c x`` is exact, the other product rounded first:
``fma(c, x, -(s y))`` and ``fma(s, x, c y)``, for the columns, the rows
and V alike (measured against ``fractions`` on N = 3, 4 and 9, float32 and
float64).  The plain version here writes those fused operations out
exactly (``trig.fma_f64``; in float32 each product is exact in float64,
its sum rounded to odd there, then to float32).  XLA's CPU code also runs
with flush-to-zero and denormals-are-zero: every subnormal result of the
sweep (a product, an update, ``aqq - app``, the angle) is the zero of its
sign there, and so it is here (:func:`_ftz`).  On a CUDA tensor
``csrc/jacobi.cu`` computes the same function, one thread a matrix.

That exact function is what every CPU caller gets: the consensus
residual, eight-point, five-point and :func:`svd3` take the reference's
contractions (:func:`gram_fused`, ``core.pose.c2c_design``) and the exact
Jacobi, and give its bits.  On a CPU it costs 5 to 43 times the plain
unfused sweep (``scripts/cpu_costs.py``), so a caller whose CPU batches are
large may opt into the cheap forms, within a few ulps, with
:func:`cheap_on_cpu`: :func:`_eigh_unfused` and unfused products.  On a
card the kernel is exact either way.  The derivative is not defined:
a tensor that requires grad is refused.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .. import kernels
from . import trig
from .precision import full_f32_products

MAX_N = 10  # csrc/jacobi.cu's largest matrix

_CHEAP_CPU = False  # set by cheap_on_cpu()


@contextlib.contextmanager
def cheap_on_cpu():
    """Within it the CPU callers of the Jacobi (``core.pose``'s consensus
    residual, eight-point, five-point, :func:`svd3`) take their cheap forms:
    unfused products and the unfused sweep, within a few ulps of
    ``cv_tpu``'s jitted bits and 2 to 33 times cheaper
    (``scripts/cpu_costs.py``).  Outside it they compute those bits; a card
    computes them either way."""
    global _CHEAP_CPU
    before, _CHEAP_CPU = _CHEAP_CPU, True
    try:
        yield
    finally:
        _CHEAP_CPU = before


def _cheap(t: torch.Tensor) -> bool:
    """Whether a caller on ``t`` takes the cheap CPU forms (a CPU tensor
    within :func:`cheap_on_cpu`)."""
    return _CHEAP_CPU and t.device.type == "cpu"


def _exact(t: torch.Tensor) -> bool:
    """Whether a caller on ``t`` takes the reference's fused products (a
    CPU tensor outside :func:`cheap_on_cpu`; the card's solvers use
    matmuls)."""
    return t.device.type == "cpu" and not _CHEAP_CPU


_ftz = trig.ftz  # a subnormal as the zero of its sign (XLA's FTZ and DAZ)


def _rotate_f64(c, s, x, y):
    """``(fma(c, x, -(s y)), fma(s, x, c y))`` of float64, stacked on a new
    first axis: ``x``, ``y`` ``(R, B)``, ``c``, ``s`` ``(B,)``.  Each exact
    product is Dekker's, with the splits of ``c`` and ``s`` taken once."""
    xh, xl = trig._split(x)
    (ch, cl), (sh, sl) = trig._split(c), trig._split(s)
    pc, ps = c * x, s * x
    e = torch.stack((((ch * xh - pc) + ch * xl + cl * xh) + cl * xl, ((sh * xh - ps) + sh * xl + sl * xh) + sl * xl))
    return _ftz(trig._round_sum(torch.stack((pc, ps)), e, _ftz(torch.stack((-(s * y), c * y)))))


def _rotate_f32(c, s, x, y):
    """:func:`_rotate_f64` of float32: each product with ``x`` is exact in
    float64, its sum with the float32 product rounded to odd there, then to
    float32."""
    x64 = x.double()
    p = torch.stack((c.double() * x64, s.double() * x64))
    q = _ftz(torch.stack((-(s * y), c * y))).double()
    t = p + q
    bb = t - p
    err = (p - (t - bb)) + (q - bb)
    bits = t.view(torch.int64)
    step = ((err.view(torch.int64) ^ bits) >> 63) | 1
    return _ftz(torch.where((err != 0) & ((bits & 1) == 0), (bits + step).view(torch.float64), t).float())


def _converged(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Where ``atan2(y, x)`` of float64 takes its first small-quotient form
    and ``theta`` lies below 2^-27 (see :func:`_angle_f64`)."""
    ax, ay = x.abs(), y.abs()
    ex = (x.view(torch.int64) >> 52) & 0x7FF
    ey = (y.view(torch.int64) >> 52) & 0x7FF
    return (x >= 2.0 ** -500) & (x <= 2.0 ** 500) & (ay >= 2.0 ** -500) & (ay <= 2.0 ** 500) \
        & (ay / ax < 2.0 ** -28) & (ey - ex > -57)


def _angle_f64(apq, app, aqq):
    """``(cos theta, sin theta)`` of the Jacobi angle ``theta = atan2(2 apq,
    aqq - app) / 2`` in float64, glibc's functions.  Where ``aqq - app > 0``
    dominates ``2 apq`` by more than 2^28 (as it does once a sweep has
    converged, :func:`_converged`) ``theta`` is atan2's first small-quotient
    form, with its polynomial exactly -1/3 there, and below 2^-27: cos is 1
    and sin is ``theta``.  The other elements take the general functions."""
    y, x = 2.0 * apq, _ftz(aqq - app)
    ax, ay = x.abs(), y.abs()
    u = ay / ax
    fast = _converged(y, x)
    v = ax * u
    du = ((ay - v) - trig.fma_f64(ax, u, -v)) / ax
    theta = 0.5 * torch.copysign(u + trig.fma_f64(u * (u * u), trig.D[0], du), y)
    c, s = torch.ones_like(theta), theta
    slow = torch.nonzero(~fast)[:, 0]
    if slow.numel():
        th = _ftz(0.5 * trig.atan2_plain(y[slow], x[slow]))
        cs, sn = trig.cos_sin_by_dtype(th)
        c, s = c.index_put((slow,), cs), s.index_put((slow,), sn)
    return c, s


def _angle_f32(apq, app, aqq):
    """:func:`_angle_f64` of float32: glibc's atan2f, cosf and sinf."""
    return trig.cos_sin_by_dtype(_ftz(0.5 * trig.atan2_plain(2.0 * apq, _ftz(aqq - app))))


def eigh_small_plain(a: torch.Tensor, sweeps: int = 6):
    """The reference's Jacobi in elementwise operations (any device): a
    Python loop over sweeps and the ``N (N - 1) / 2`` rotation pairs, each
    rotation batched over the matrices, with A and V as one batch-last
    state ``(2 N^2, batch)`` (an entry of every matrix is one contiguous
    row).  Per rotation one angle (:func:`_angle_f64`) and the fused
    updates in two stacked calls: the columns p and q, the rows p and q
    outside the (p, q) block and V's columns together (their inputs are
    the rotation's own), then the block's two rows, which read the new
    columns."""
    n = a.shape[-1]
    batch = a.shape[:-2]
    f32 = a.dtype == torch.float32
    rotate, angle = (_rotate_f32, _angle_f32) if f32 else (_rotate_f64, _angle_f64)
    dev = a.device
    eye = torch.eye(n, dtype=a.dtype, device=dev).reshape(n * n, 1)
    a = a.reshape(-1, n * n).T
    if sweeps > 0 and n > 1:  # every entry is rewritten: a subnormal input reads as zero
        a = _ftz(a.contiguous())
    state = torch.cat((a, eye.expand(a.shape))).contiguous()
    vo = n * n
    # Per pair: the rows of the first stacked call (column p or q of A,
    # row p or q outside the block, column p or q of V) and of the second
    # (the block's row p or q).
    plan = []
    for p in range(n):
        for q in range(p + 1, n):
            others = [j for j in range(n) if j not in (p, q)]
            rows = [[i * n + k for i in range(n)] + [k * n + j for j in others] + [vo + i * n + k for i in range(n)]
                    for k in (p, q)]
            block = [[k * n + p, k * n + q] for k in (p, q)]
            plan.append((p, q, *(torch.tensor(r, device=dev) for r in rows + block)))
    for _ in range(sweeps):
        for p, q, ix, iy, bx, by in plan:
            # Jacobi angle annihilating a[p, q]: theta = atan2(2 apq, aqq - app)/2
            c, s = angle(state[p * n + q], state[p * n + p], state[q * n + q])
            for x_rows, y_rows in ((ix, iy), (bx, by)):
                out = rotate(c, s, state.index_select(0, x_rows), state.index_select(0, y_rows))
                state.index_copy_(0, x_rows, out[0])
                state.index_copy_(0, y_rows, out[1])
    a = state[:vo].T.reshape(batch + (n, n))
    v = state[vo:].T.reshape(batch + (n, n))
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    order = torch.sort(w, dim=-1, stable=True).indices
    w = torch.gather(w, -1, order)
    v = torch.gather(v, -1, order[..., None, :].expand(v.shape))
    return w, v


def eigh_small(a: torch.Tensor, sweeps: int = 6):
    """Eigendecomposition of symmetric ``(..., N, N)`` matrices (N small).

    Returns ``(eigenvalues (..., N) ascending, eigenvectors (..., N, N))``
    with eigenvectors in columns, bit for bit ``cv_tpu``'s.  On a CUDA
    tensor one launch of ``csrc/jacobi.cu`` (N <= 10, float32 or float64),
    counted on ``eigh_small.launches``; on a CPU tensor
    :func:`eigh_small_plain`.
    """
    if torch.is_grad_enabled() and a.requires_grad:
        raise ValueError("eigh_small: no derivative; pass a tensor that does not require grad")
    if a.device.type != "cpu":
        return jacobi(a, sweeps)
    return eigh_small_plain(a, sweeps)


eigh_small.launches = 0  # jacobi.cu launches so far (CPU calls do not count)

_VOID, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def jacobi(a: torch.Tensor, sweeps: int = 6):
    """``csrc/jacobi.cu`` on a CUDA tensor: :func:`eigh_small_plain`'s
    function, one thread a matrix."""
    if a.device.type != "cuda":
        raise ValueError(f"jacobi: a CUDA tensor, got {a.device}")
    if a.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"jacobi: float32 or float64, got {a.dtype}")
    n = a.shape[-1]
    if a.dim() < 2 or a.shape[-2] != n or not 1 <= n <= MAX_N:
        raise ValueError(f"jacobi: (..., N, N) with N <= {MAX_N}, got {tuple(a.shape)}")
    batch = a.shape[:-2]
    a = a.reshape(-1, n, n).contiguous()
    w = torch.empty(a.shape[:2], dtype=a.dtype, device=a.device)
    v = torch.empty_like(a)
    symbol = "cv_jacobi_f32" if a.dtype == torch.float32 else "cv_jacobi_f64"
    err = kernels.function("jacobi", symbol, [_VOID] * 3 + [_I64, _INT, _INT, _VOID])(
        a.data_ptr(), w.data_ptr(), v.data_ptr(), a.shape[0], n, int(sweeps), kernels.current_stream(a.device))
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")
    if a.shape[0] > 0:
        eigh_small.launches += 1
    return w.reshape(batch + (n,)), v.reshape(batch + (n, n))


UNFUSED_CHUNK = 16384  # matrices a chunk of the unfused sweep: ~2x over one pass on a CPU core


def _eigh_unfused(a: torch.Tensor, sweeps: int = 6):
    """The same cyclic Jacobi on a CPU without the reference's bits (the
    callers' within :func:`cheap_on_cpu`): each rotation's cosine and sine come
    from the half-angle formulas of ``theta = atan2(2 apq, aqq - app) / 2``
    instead of glibc's functions and the updates are not fused, so each
    rotation lies within a few ulps of the exact one
    (``tests/test_torch_eigen.py`` holds the result to ``cv_tpu``'s).
    Batches run in chunks of ``UNFUSED_CHUNK`` matrices, whose sweeps stay
    in the CPU's cache (each matrix's arithmetic is its own, so the bits
    do not depend on the chunk)."""
    n = a.shape[-1]
    batch = a.shape[:-2]
    flat = a.reshape(-1, n, n)
    if flat.shape[0] > UNFUSED_CHUNK:
        parts = [_eigh_unfused(flat[i:i + UNFUSED_CHUNK], sweeps) for i in range(0, flat.shape[0], UNFUSED_CHUNK)]
        return (torch.cat([w for w, _ in parts]).reshape(batch + (n,)),
                torch.cat([v for _, v in parts]).reshape(batch + (n, n)))
    a = flat.permute(1, 2, 0).contiguous()
    v = torch.eye(n, dtype=a.dtype, device=a.device)[:, :, None].expand(a.shape).contiguous()
    for _ in range(sweeps):
        for p in range(n):
            for q in range(p + 1, n):
                # cos and sin of theta = atan2(y, x) / 2 in [-pi/2, pi/2]: the
                # larger of the two from its half-angle formula, the other
                # as sin(2 theta) / (2 of it).
                y, x = 2.0 * a[p, q], a[q, q] - a[p, p]
                r = torch.hypot(x, y)
                cos2 = torch.where(r > 0, x / r, torch.copysign(torch.ones_like(x), x))
                sin2 = torch.where(r > 0, y / r, y)
                big_c = cos2 >= 0
                big = torch.sqrt(0.5 + 0.5 * cos2.abs())
                c = torch.where(big_c, big, sin2.abs() / (2.0 * big))
                s = torch.where(big_c, sin2 / (2.0 * big), torch.copysign(big, y))
                col_p, col_q = a[:, p], a[:, q]
                a[:, p], a[:, q] = c * col_p - s * col_q, s * col_p + c * col_q
                row_p, row_q = a[p], a[q]
                a[p], a[q] = c * row_p - s * row_q, s * row_p + c * row_q
                vp, vq = v[:, p], v[:, q]
                v[:, p], v[:, q] = c * vp - s * vq, s * vp + c * vq
    a = a.permute(2, 0, 1).reshape(batch + (n, n))
    v = v.permute(2, 0, 1).reshape(batch + (n, n))
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    order = torch.sort(w, dim=-1, stable=True).indices
    return torch.gather(w, -1, order), torch.gather(v, -1, order[..., None, :].expand(v.shape))


def eigh4(a: torch.Tensor, sweeps: int = 6):
    """Symmetric 4x4 batch eigendecomposition (see :func:`eigh_small`)."""
    return eigh_small(a, sweeps=sweeps)


def _eigh_for_caller(a: torch.Tensor, sweeps: int):
    """:func:`eigh_small` for the callers :func:`cheap_on_cpu` covers
    (eight-point, five-point, :func:`svd3`): within it on a CPU the unfused
    sweep."""
    return _eigh_unfused(a, sweeps) if _cheap(a) else eigh_small(a, sweeps)


def cross_fused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross`` of ``(..., 3)`` vectors as XLA's CPU code computes it
    under a jit: each component ``a_i b_j - a_j b_i`` with the first product
    fused, ``fma(a_i, b_j, -(a_j b_i))``."""
    a, b = a.unbind(-1), b.unbind(-1)
    i, j = [1, 2, 0], [2, 0, 1]
    return trig.fma(torch.stack([a[k] for k in i], -1), torch.stack([b[k] for k in j], -1),
                    -(torch.stack([a[k] for k in j], -1) * torch.stack([b[k] for k in i], -1)))


def gram_fused(rows: torch.Tensor) -> torch.Tensor:
    """``rows^T rows`` of ``(..., K, N)``, each entry the reference's
    ``sum_k rows[k, i] rows[k, j]`` as its jitted CPU code sums it
    (:func:`~cv_tpu_torch.ops.trig.dot_fused` over k in order)."""
    return trig.dot_fused(rows[..., :, :, None], rows[..., :, None, :], -3)


def gram(rows: torch.Tensor) -> torch.Tensor:
    """``rows^T rows``: :func:`gram_fused` on a CPU (the reference's bits),
    else a matmul in full float32 (the cheap CPU form within
    :func:`cheap_on_cpu`; the card's, whose solvers are not held to the
    reference's bits)."""
    if _exact(rows):
        return gram_fused(rows)
    with full_f32_products():
        return rows.transpose(-1, -2) @ rows


def svd3(e: torch.Tensor, sweeps: int = 8):
    """SVD of ``(..., 3, 3)`` batches via Jacobi on E^T E.

    Returns ``(u, s, vt)`` with singular values descending.  The left
    vector of the smallest singular value is completed by a cross product
    when that value is (near) zero — the rank-2 essential-matrix case this
    exists for.  On a CPU the bits of ``cv_tpu``'s jitted ``svd3``: every sum of products, cross product and
    norm as its jitted code contracts it (``E^T E`` by :func:`gram_fused`,
    ``E V`` by ``dot_fused``, :func:`cross_fused`; the norms are
    ``torch.linalg.vector_norm``'s, which sum and round as
    ``jnp.linalg.norm`` does on a CPU), the IEEE square root and the exact
    Jacobi.  Otherwise (a CPU within :func:`cheap_on_cpu`, a card) the
    products are matmuls in full float32; on a CPU the sweep is the unfused
    one, on a card the Jacobi kernel.
    """
    fused = _exact(e)
    w, v = _eigh_for_caller(gram(e), sweeps)  # ascending
    # Descending order.
    w = w.flip(-1)
    v = v.flip(-1)
    s = trig.sqrt(torch.clamp(w, min=0.0))
    if fused:
        ev = trig.dot_fused(e[..., :, :, None], v[..., None, :, :], -2)  # columns: s_i * u_i
        cross = cross_fused
    else:
        with full_f32_products():
            ev = e @ v
        cross = torch.linalg.cross
    s0 = s[..., 0:1]
    tol = torch.finfo(e.dtype).eps ** 0.5 * torch.clamp(s0, min=1e-30)
    safe = torch.where(s <= tol, torch.ones_like(s), s)
    u = ev / safe[..., None, :]
    u0, u1 = u[..., :, 0], u[..., :, 1]
    u2 = torch.where((s[..., 2] <= tol[..., 0])[..., None], cross(u0, u1), u[..., :, 2])
    u = u.clone()
    u[..., :, 2] = u2
    # Degenerate rank<2 batches: fall back to orthonormal completion of u1.
    u1_ok = s[..., 1] > tol[..., 0]
    ex = torch.zeros_like(u0)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(u0)
    ey[..., 1] = 1.0
    alt = cross(u0, ex)
    alt_norm = torch.linalg.vector_norm(alt, dim=-1, keepdim=True)
    alt = torch.where(alt_norm > 0.1, alt, cross(u0, ey))
    alt = alt / torch.linalg.vector_norm(alt, dim=-1, keepdim=True)
    u[..., :, 1] = torch.where(u1_ok[..., None], u[..., :, 1], alt)
    u[..., :, 2] = torch.where(u1_ok[..., None], u[..., :, 2], cross(u0, u[..., :, 1]))
    return u, s, v.transpose(-1, -2)
