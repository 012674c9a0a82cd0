"""The experiments' TPU probes on Hopper, each with its plain PyTorch version.

Ports of the Pallas kernels of the probe scripts in ``experiments/``:

* ``exp_select_kernels.py::_make_runner`` (bodies bf16x3, int8x4,
  take_along_axis): the select of its ``host_reference`` from a 136x128
  window, ``out[k, c NS + s] = planes[lvl, c, y0 + rel_y, x0 + rel_x]``:
  :func:`select_window`, the select kernel reshaped.
* ``exp_r3_gather_probe.py::phase_select``: ``patches[k, c, rel_y,
  rel_x]``, which is ``akaze.select.select_samples_patch`` (the select
  kernel); nothing here.
* ``exp_r3_gather_probe.py::phase_lane`` / ``phase_sublane``:
  :func:`take_along` (``csrc/take_along.cu``), one kernel, axis 1 or 0.
* ``exp_r5_pfused.py::phase_trig``: :func:`trig_probe`
  (``csrc/trig_probe.cu``, the kernel of :mod:`..ops.trig`).
* ``exp_bisect.py`` bodies and ``exp_r3_mxu_probe.py`` bodies: the
  functions their stage-isolating bodies compute (``csrc/select_probes.cu``,
  one ``__global__`` per body): :data:`BISECT` and :data:`MXU`, keyed by
  body name.  The two window sums of ``exp_bisect.py`` also have
  :func:`bisect_window_ordered`, a mirror of their kernel's summation
  order, which the kernels equal bit for bit; its two one-hot column sums
  have :func:`bisect_matmul_ordered`, and the two one-hot row sums of
  ``exp_r3_mxu_probe.py`` :func:`mxu_rows_ordered`.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.  Each wrapper counts its launches on
``<wrapper>.launches``; :func:`select_window`'s also count on
``select_samples.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..akaze.select import GROUP, cut_patches, select_samples, select_samples_plain
from ..ops import trig

PH, PW = 136, 128  # the window of exp_select_kernels.py / exp_bisect.py
P = 128  # the patch side of exp_r3_mxu_probe.py
TWO_PI = trig.TWO_PI
BISECT_BODIES = ("dma_only", "matmul_static", "matmul_dyn_oh", "split_nomm", "vpu_rowstage")
MXU_BODIES = ("dots", "dotsbig", "onehot", "split", "dma")
ROW_SUM_BODIES = ("dots", "dotsbig")
# The bodies that sum, and the absolute tolerance that holds each to its
# plain version (the sums run in other orders).  Largest differences
# measured: against the JAX bodies on the CPU over six seeds, 6.4e-4 for
# the 52,224-term window sums (magnitude to ~900) and 3.1e-5 for the 1,224-
# and 128-term column and row sums (to ~500); the kernels against the plain
# versions on an H100, 1.8e-4 and 6.1e-5 (two ulp at 256-512).  The
# tolerances are about three times those and eight ulp at 512.  The other
# bodies are selects, held bitwise.
SUM_ATOL = {"dma_only": 2e-3, "split_nomm": 2e-3, "matmul_static": 2.5e-4, "matmul_dyn_oh": 2.5e-4,
            "dots": 2.5e-4, "dotsbig": 2.5e-4}

_VOID, _INT = ctypes.c_void_p, ctypes.c_int


def _device(name: str, *tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _require(name: str, t: torch.Tensor, dtype, ndim: int):
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d {dtype}, got {t.dtype} {tuple(t.shape)}")


def _launch(source: str, symbol: str, argtypes, *args):
    err = kernels.function(source, symbol, argtypes)(*args)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")


_stream = kernels.current_stream


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest even) and back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _split3(p: torch.Tensor):
    """The bf16x3 split of the TPU's exact f32 products."""
    p1 = _bf16(p)
    r1 = p - p1
    p2 = _bf16(r1)
    return p1, p2, _bf16(r1 - p2)


# ---------------------------------------------------------------------------
# exp_select_kernels.py: the select of host_reference
# ---------------------------------------------------------------------------


def select_window_plain(planes, lvl, y0, x0, rel_y, rel_x) -> torch.Tensor:
    """``(K, C * NS)``: ``out[k, c NS + s] = planes[lvl[k], c, y0[k] +
    rel_y[k, s], x0[k] + rel_x[k, s]]`` (the probe's argument order)."""
    return select_samples_plain(planes, lvl, y0, x0, rel_x, rel_y).reshape(lvl.shape[0], -1)


def select_window(planes, lvl, y0, x0, rel_y, rel_x) -> torch.Tensor:
    """:func:`select_window_plain` through the select kernel; its launches
    count on ``select_samples.launches`` and on ``select_window.launches``."""
    before = select_samples.launches
    out = select_samples(planes, lvl, y0, x0, rel_x, rel_y).reshape(lvl.shape[0], -1)
    select_window.launches += select_samples.launches - before
    return out


select_window.launches = 0


# ---------------------------------------------------------------------------
# exp_r3_gather_probe.py: lane and sublane gathers
# ---------------------------------------------------------------------------


def take_along_plain(x, idx, axis: int) -> torch.Tensor:
    """``out[r, c] = x[r, idx[r, c]]`` (axis 1) or ``x[idx[r, c], c]``
    (axis 0), by advanced indexing; NaN where the index falls outside
    ``x``."""
    rows, cols = idx.shape
    j = idx.long()
    ok = (j >= 0) & (j < x.shape[axis])
    j = torch.where(ok, j, 0)
    if axis == 1:
        vals = x[torch.arange(rows, device=x.device)[:, None], j]
    else:
        vals = x[j, torch.arange(cols, device=x.device)[None, :]]
    return torch.where(ok, vals, torch.full((), float("nan"), dtype=x.dtype, device=x.device))


_TAKE_ALONG_ARGS = [_VOID] * 3 + [_INT] * 5 + [_VOID]
_INT_LIMIT = 2**31


def take_along(x, idx, axis: int) -> torch.Tensor:
    """:func:`take_along_plain` through ``csrc/take_along.cu``.  ``x``: 2-d
    float32; ``idx``: 2-d int32 with ``x``'s rows (axis 1) or columns
    (axis 0); each under 2^31 elements.  The checks are attribute reads and
    the C function is typed once, so a call costs little host time."""
    dev = x.device
    if idx.device != dev:
        raise ValueError(f"take_along: tensors on several devices {{{dev}, {idx.device}}}")
    if axis != 0 and axis != 1:
        raise ValueError(f"take_along: axis must be 0 or 1, got {axis}")
    if dev.type == "cpu":
        return take_along_plain(x, idx, axis)
    if dev.type != "cuda":
        raise ValueError(f"take_along: unsupported device {dev}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-d torch.float32, got {x.dtype} {tuple(x.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or not idx.is_contiguous():
        raise ValueError(f"idx must be a contiguous 2-d torch.int32, got {idx.dtype} {tuple(idx.shape)}")
    rows, cols = idx.shape
    x_rows, x_cols = x.shape
    if (rows != x_rows) if axis == 1 else (cols != x_cols):
        raise ValueError(f"take_along: idx {(rows, cols)} does not fit x {(x_rows, x_cols)} on axis {axis}")
    if rows * cols >= _INT_LIMIT or x_rows * x_cols >= _INT_LIMIT:
        raise ValueError(f"take_along: {(rows, cols)} / {(x_rows, x_cols)} reach 2^31 elements")
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    err = kernels.function("take_along", "cv_take_along", _TAKE_ALONG_ARGS)(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, cols, x_rows, x_cols, axis, _stream(dev))
    if err != 0:
        raise RuntimeError(f"cv_take_along kernel launch failed: cudaError {err}")
    take_along.launches += 1
    return out


take_along.launches = 0


# ---------------------------------------------------------------------------
# exp_r5_pfused.py: the trigonometry probe
# ---------------------------------------------------------------------------


def trig_probe_plain(x) -> torch.Tensor:
    """``(4, N)`` rows ``atan2(x[0], x[1])``, ``cos(x[0])``, ``sin(x[0])``
    (:mod:`..ops.trig`: glibc's functions, the reference's bits) and the
    floored ``mod(x[0] + 2pi, 2pi)``, in float32."""
    a, b = x[0], x[1]
    return torch.stack([trig.atan2_f32(a, b), trig.cos_f32(a), trig.sin_f32(a),
                        torch.remainder(a + TWO_PI, TWO_PI)])


def trig_probe(x) -> torch.Tensor:
    """:func:`trig_probe_plain` through ``csrc/trig_probe.cu``
    (``cv_trig_probe``); ``x``: (R >= 2, N) float32."""
    dev = _device("trig_probe", x)
    if dev.type == "cpu":
        return trig_probe_plain(x)
    _require("x", x, torch.float32, 2)
    if x.shape[0] < 2:
        raise ValueError(f"trig_probe: x needs two rows, got {tuple(x.shape)}")
    n = x.shape[1]
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    _launch("trig_probe", "cv_trig_probe", [_VOID] * 3 + [ctypes.c_int64, ctypes.c_float, _VOID],
            x[0].data_ptr(), x[1].data_ptr(), out.data_ptr(), n, ctypes.c_float(TWO_PI), _stream(dev))
    trig_probe.launches += 1
    return out


trig_probe.launches = 0


# ---------------------------------------------------------------------------
# exp_bisect.py: the window probes
# ---------------------------------------------------------------------------


WINDOW_SUM_BODIES = ("dma_only", "split_nomm")
MATMUL_BODIES = ("matmul_static", "matmul_dyn_oh")


def _windows(planes, lvl, y0, x0):
    """``(win, ok)``: the keypoints' ``(K, C, PH, PW)`` windows and which of
    them lie in the stack; a window that leaves it is cut at the origin of
    level 0 in its place (the bodies write NaN there)."""
    n_levels, _, height, width = planes.shape
    ok = (lvl >= 0) & (lvl < n_levels) & (y0 >= 0) & (y0 + PH <= height) & (x0 >= 0) & (x0 + PW <= width)
    at = [torch.where(ok, t, 0) for t in (lvl, y0, x0)]
    return cut_patches(planes, *at, PH, PW), ok


def _nan_where(bad, x):
    return torch.where(bad, torch.full((), float("nan"), dtype=x.dtype, device=x.device), x)


def _columns(body, rel_x, k, ns, device):
    """``(cols, bad)``: each sample's window column (clamped into the
    window) and whether it lies outside ``[0, PW)``."""
    if body == "matmul_static":
        cols = (torch.arange(ns, device=device) % PW).expand(k, ns)
        return cols, torch.zeros((k, ns), dtype=torch.bool, device=device)
    cols = rel_x.long()
    return cols.clamp(0, PW - 1), (cols < 0) | (cols >= PW)


def _zero_where(bad, x):
    return torch.where(bad, torch.zeros((), dtype=x.dtype, device=x.device), x)


def bisect_plain(body: str, planes, lvl, y0, x0, rel_y, rel_x) -> torch.Tensor:
    """The ``(K, 3 NS)`` output of ``exp_bisect.py``'s body ``body`` (see
    ``csrc/select_probes.cu``) on the 3x136x128 windows: NaN rows where a
    window leaves the stack (the TPU body's DMA cannot take such a window,
    so it defines no result there); +0.0 at a sample whose row
    (``'vpu_rowstage'``) or column (``'matmul_dyn_oh'``) leaves the window,
    where the body's one-hot has no match and its product is a sum of
    zeros.  For finite windows only: an inf or a NaN in a window meets the
    one-hot's zeros, so the body gives NaN at every sample of the keypoint
    (the row select: of that value's channel), while this copies or sums
    the values a sample names."""
    k, ns = rel_y.shape
    win, ok = _windows(planes, lvl, y0, x0)
    if body in WINDOW_SUM_BODIES:
        if body == "dma_only":
            s = win.sum(dim=(1, 2, 3))
        else:
            p1, p2, p3 = _split3(win)
            s = p1.sum(dim=(1, 2, 3)) + p2.sum(dim=(1, 2, 3)) + p3.sum(dim=(1, 2, 3))
        return _nan_where(~ok[:, None], s[:, None].expand(k, 3 * ns))
    if body == "vpu_rowstage":
        ry = rel_y.long()
        rows = ry.clamp(0, PH - 1)[:, None, :].expand(k, win.shape[1], ns)
        vals = _zero_where(((ry < 0) | (ry >= PH))[:, None, :], win[..., 0].gather(2, rows))
        return _nan_where(~ok[:, None, None], vals).reshape(k, -1)
    if body in MATMUL_BODIES:
        cols, bad = _columns(body, rel_x, k, ns, planes.device)
        g = _bf16(win).gather(3, cols[:, None, None, :].expand(k, win.shape[1], PH, ns))
        # Three stacked copies of the channels, summed over rows: the one-hot
        # product's column sum, then repeat(3).
        s = _nan_where(~ok[:, None], _zero_where(bad, torch.cat([g] * 3, dim=1).sum(dim=(1, 2))))
        return s.repeat_interleave(3, dim=1)
    raise ValueError(f"unknown exp_bisect body {body!r}")


def _block_sum(chains: torch.Tensor) -> torch.Tensor:
    """``(K,)``: the sum of ``(K, R, 256)`` chains in the window sums'
    kernel order: chain t adds its R values in order into a float32 from 0,
    then lanes ``l`` and ``l + off`` of each warp of 32 chains add for
    ``off`` = 16, 8, 4, 2, 1 (the shuffle tree), then warps 0 .. 7 in order."""
    acc = torch.zeros((chains.shape[0], chains.shape[2]), dtype=torch.float32, device=chains.device)
    for r in range(chains.shape[1]):
        acc = acc + chains[:, r]
    lanes = acc.reshape(acc.shape[0], -1, 32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes[..., :off] + lanes[..., off:2 * off]
    s = lanes[:, 0, 0]
    for w in range(1, lanes.shape[1]):
        s = s + lanes[:, w, 0]
    return s


def bisect_window_ordered(body: str, planes, lvl, y0, x0, rel_y, rel_x) -> torch.Tensor:
    """:func:`bisect_plain` of a window-sum body (``'dma_only'``,
    ``'split_nomm'``) summed in its kernel's order: each window's
    ``(C * PH, PW)`` rows as ``(C * PH / 2, 256)`` chains (chain t = row
    parity * 128 + column), summed by :func:`_block_sum`; for
    ``'split_nomm'`` one such sum for each bf16 split, then ``(s1 + s2) +
    s3``; NaN rows where :func:`bisect_plain` has them.  The kernel's output
    equals it bit for bit on any device."""
    if body not in WINDOW_SUM_BODIES:
        raise ValueError(f"not a window-sum body of exp_bisect: {body!r}")
    k, ns = rel_y.shape
    win, ok = _windows(planes, lvl, y0, x0)
    chains = win.reshape(k, -1, 2 * PW)
    if body == "dma_only":
        s = _block_sum(chains)
    else:
        s1, s2, s3 = (_block_sum(p) for p in _split3(chains))
        s = (s1 + s2) + s3
    return _nan_where(~ok[:, None], s[:, None].expand(k, 3 * ns))


def bisect_matmul_ordered(body: str, planes, lvl, y0, x0, rel_y, rel_x) -> torch.Tensor:
    """:func:`bisect_plain` of a column-sum body (``'matmul_static'``,
    ``'matmul_dyn_oh'``) summed in its kernel's order: a ``(K, PW)``
    float32 accumulator adds ``bf16(win[:, c, y, :])`` for rep 0..2, then
    c, then y, one IEEE add at a time; then the gather, +0.0 at a column
    outside ``[0, PW)`` and the quiet NaN ``0x7fc00000`` in the rows of
    windows that leave the stack, as :func:`bisect_plain` has them (finite
    windows only, as there).  The kernel's output equals it bit for bit on
    any device."""
    if body not in MATMUL_BODIES:
        raise ValueError(f"not a column-sum body of exp_bisect: {body!r}")
    k, ns = rel_y.shape
    win, ok = _windows(planes, lvl, y0, x0)
    b = _bf16(win)
    acc = torch.zeros((k, PW), dtype=torch.float32, device=planes.device)
    for _ in range(3):
        for c in range(b.shape[1]):
            for y in range(PH):
                acc = acc + b[:, c, y]
    cols, bad = _columns(body, rel_x, k, ns, planes.device)
    return _nan_where(~ok[:, None], _zero_where(bad, acc.gather(1, cols))).repeat_interleave(3, dim=1)


_BISECT_ARGS = [_VOID] * 7 + [_INT] * 8 + [_VOID]
# The bisect kernels' own failures (csrc/select_probes.cu; -2 and -3 the
# column sums' TMA only).
_BISECT_ERRORS = {-1: "the window is not 3x136x128", -2: "libcuda has no cuTensorMapEncodeTiled",
                  -3: "cuTensorMapEncodeTiled refused the plane stack"}


def _bisect_wrapper(body: str):
    symbol = f"cv_bisect_{body}"

    def run(planes, lvl, y0, x0, rel_y, rel_x) -> torch.Tensor:
        dev = _device(symbol, planes, lvl, y0, x0, rel_y, rel_x)
        if dev.type == "cpu":
            return bisect_plain(body, planes, lvl, y0, x0, rel_y, rel_x)
        _require("planes", planes, torch.float32, 4)
        if planes.shape[1] != 3:
            raise ValueError(f"planes must have 3 channels, got {tuple(planes.shape)}")
        k, ns = rel_y.shape
        for name, t in (("lvl", lvl), ("y0", y0), ("x0", x0)):
            _require(name, t, torch.int32, 1)
        for name, t in (("rel_y", rel_y), ("rel_x", rel_x)):
            _require(name, t, torch.int32, 2)
        if {tuple(lvl.shape), tuple(y0.shape), tuple(x0.shape)} != {(k,)} or rel_x.shape != rel_y.shape:
            raise ValueError(f"{symbol}: lvl/y0/x0 must be ({k},) and rel_x {tuple(rel_y.shape)}")
        if body in MATMUL_BODIES and (planes.shape[3] % 4 or planes.data_ptr() % 16):
            raise ValueError(f"{symbol}: its TMA tensor map needs rows of a multiple of 4 floats and a "
                             f"16-byte aligned stack, got {tuple(planes.shape)} at {planes.data_ptr():#x}")
        out = torch.empty((k, 3 * ns), dtype=torch.float32, device=dev)
        err = kernels.function("select_probes", symbol, _BISECT_ARGS)(
            planes.data_ptr(), lvl.data_ptr(), y0.data_ptr(), x0.data_ptr(), rel_y.data_ptr(), rel_x.data_ptr(),
            out.data_ptr(), *planes.shape, PH, PW, k, ns, _stream(dev))
        if err != 0:
            raise RuntimeError(f"{symbol} kernel launch failed: {_BISECT_ERRORS.get(err, f'cudaError {err}')}")
        run.launches += 1
        return out

    run.__name__ = run.__qualname__ = f"bisect_{body}"
    run.__doc__ = f"``exp_bisect.py``'s ``{body}`` body through ``csrc/select_probes.cu``."
    run.launches = 0
    return run


BISECT = {body: _bisect_wrapper(body) for body in BISECT_BODIES}


# ---------------------------------------------------------------------------
# exp_r3_mxu_probe.py: the patch probes
# ---------------------------------------------------------------------------


def _leader_rows(rel_y, k: int, p: int, g: int):
    """``(rows, ok)``: each sample's patch row, the index of its group's
    first keypoint clamped into ``[0, p)``, and whether it lay there."""
    ry = rel_y[torch.arange(k, device=rel_y.device) // g * g].long()
    ok = (ry >= 0) & (ry < p)
    return ry.clamp(0, p - 1), ok


def mxu_plain(body: str, rel_x, rel_y, patches, g: int = GROUP) -> torch.Tensor:
    """The ``(K, C, NS)`` output of ``exp_r3_mxu_probe.py``'s body ``body``
    (see ``csrc/select_probes.cu``) on patches ``(K, C, P, P)``.  ``'dots'``
    and ``'dotsbig'`` give 0 where the leader's row leaves ``[0, P)`` (no
    one-hot column matches).  ``'split'`` needs ``NS <= P`` and ``'dma'``
    ``NS <= 4 P``: the TPU bodies do not trace beyond
    (``exp_r3_mxu_probe.py:108-112`` fails at its own NS=512)."""
    k, c, p, _ = patches.shape
    ns = rel_x.shape[1]
    if body in ROW_SUM_BODIES:
        rows, ok = _leader_rows(rel_y, k, p, g)
        v = _bf16(patches[:, 0]).gather(1, rows[:, :, None].expand(k, ns, p))  # (K, NS, P)
        if body == "dots":
            acc = v
            for _ in range(8):
                acc = acc + v
        else:
            acc = (v + v) + v
        s = torch.where(ok, acc.sum(dim=-1), torch.zeros((), device=patches.device))
    elif body == "onehot":
        hit = (rel_x == rel_y).to(torch.float32) + patches[:, 0, 0, 0][:, None]
        s = torch.where((rel_x >= 0) & (rel_x < p), hit, torch.zeros((), device=patches.device))
    elif body == "split":
        if ns > p:
            raise ValueError(f"mxu split needs NS <= {p}, got {ns} (exp_r3_mxu_probe.py:108-112 fails to trace)")
        p1, p2, p3 = _split3(patches[:, :, :ns, :2])
        t = (p1 + p2) + p3  # (K, C, NS, 2)
        acc = torch.zeros_like(t[:, 0])
        for ch in range(c):
            acc = acc + t[:, ch]
        s = acc[..., 0] * 0 + acc[..., 1]
    elif body == "dma":
        if ns > 4 * p:
            raise ValueError(f"mxu dma needs NS <= {4 * p}, got {ns}")
        return patches[:, :, :4].reshape(k, c, 4 * p)[:, :, :ns].contiguous()
    else:
        raise ValueError(f"unknown exp_r3_mxu_probe body {body!r}")
    return s[:, None, :].expand(k, c, ns).contiguous()


def mxu_rows_ordered(body: str, rel_x, rel_y, patches, g: int = GROUP) -> torch.Tensor:
    """:func:`mxu_plain` of a row-sum body (``'dots'``, ``'dotsbig'``)
    summed in its kernel's order: each bf16 value's term (nine adds from 0,
    or ``(v + v) + v``), then per row a ``(K, P)`` float32 total adding the
    terms for x = 0 .. P - 1, one IEEE add at a time; then the gather, 0
    where the leader's row leaves ``[0, P)``.  The kernel's output equals it
    bit for bit on any device."""
    if body not in ROW_SUM_BODIES:
        raise ValueError(f"not a row-sum body of exp_r3_mxu_probe: {body!r}")
    k, c, p, _ = patches.shape
    ns = rel_y.shape[1]
    b = _bf16(patches[:, 0])  # (K, P, P): row y, column x
    if body == "dots":
        term = torch.zeros_like(b)
        for _ in range(9):
            term = term + b
    else:
        term = (b + b) + b
    tot = torch.zeros((k, p), dtype=torch.float32, device=patches.device)
    for x in range(p):
        tot = tot + term[:, :, x]
    rows, ok = _leader_rows(rel_y, k, p, g)
    s = torch.where(ok, tot.gather(1, rows), torch.zeros((), device=patches.device))
    return s[:, None, :].expand(k, c, ns).contiguous()


_MXU_ARGS = [_VOID] * 4 + [_INT] * 5 + [_VOID]


def _mxu_wrapper(body: str):
    symbol = f"cv_mxu_{body}"

    def run(rel_x, rel_y, patches, g: int = GROUP) -> torch.Tensor:
        dev = _device(symbol, rel_x, rel_y, patches)
        if dev.type == "cpu":
            return mxu_plain(body, rel_x, rel_y, patches, g)
        _require("patches", patches, torch.float32, 4)
        _require("rel_x", rel_x, torch.int32, 2)
        _require("rel_y", rel_y, torch.int32, 2)
        k, c, p, p2 = patches.shape
        ns = rel_x.shape[1]
        if p != p2 or rel_x.shape != (k, ns) or rel_y.shape != (k, ns):
            raise ValueError(f"{symbol}: patches {tuple(patches.shape)}, rel {tuple(rel_x.shape)}")
        if body == "split" and ns > p or body == "dma" and ns > 4 * p:
            raise ValueError(f"{symbol}: NS={ns} beyond what the TPU body traces (exp_r3_mxu_probe.py)")
        if body in ROW_SUM_BODIES and (p != P or patches.data_ptr() % 16):
            raise ValueError(f"{symbol}: its kernel takes {P}x{P} patches at a 16-byte aligned address, got "
                             f"{tuple(patches.shape)} at {patches.data_ptr():#x}")
        if body == "split" and (c != 3 or p % 2 or patches.data_ptr() % 8):
            raise ValueError(f"{symbol}: its kernel takes 3-channel patches of an even side at an 8-byte aligned "
                             f"address (a float2 a row), got {tuple(patches.shape)} at {patches.data_ptr():#x}")
        if body == "split" and k * ns > _INT_LIMIT - 1:
            raise ValueError(f"{symbol}: K * NS = {k * ns} threads reach 2^31")
        out = torch.empty((k, c, ns), dtype=torch.float32, device=dev)
        _launch("select_probes", symbol, _MXU_ARGS, rel_x.data_ptr(), rel_y.data_ptr(), patches.data_ptr(),
                out.data_ptr(), c, p, k, ns, g, _stream(dev))
        run.launches += 1
        return out

    run.__name__ = run.__qualname__ = f"mxu_{body}"
    run.__doc__ = f"``exp_r3_mxu_probe.py``'s ``{body}`` body through ``csrc/select_probes.cu``."
    run.launches = 0
    return run


MXU = {body: _mxu_wrapper(body) for body in MXU_BODIES}
