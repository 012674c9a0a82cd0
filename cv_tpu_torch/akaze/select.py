"""Sample select for the describe stage: the hand-written CUDA kernel and its
plain PyTorch version.

``out[k, c - c0, s] = planes[lvl[k], c, y0[k] + rel_y[k, s], x0[k] + rel_x[k, s]]``

and from the pixel-interleaved stack (the ``'+inter'`` modes),
:func:`select_samples_interleaved`:

``out[k, c - c0, s] = stack[lvl[k], y0[k] + rel_y[k, s], 3 * (x0[k] + rel_x[k, s]) + c]``

An index outside the stack gives NaN.

Port of ``cv_tpu/akaze/pallas_mldb.py::select_samples_gather`` together
with the patch cut before it: the kernel (``csrc/select_samples.cu``)
reads the padded plane stack directly.  ``c0=1`` is the orientation pass
(Lx, Ly of the 109-sample disc), ``c0=0`` the M-LDB pass (441 unique
offsets).  On a CPU tensor the wrapper runs the plain version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels


def _inside(lvl, y0, x0, rel_x, rel_y, n_levels: int, height: int, width: int):
    """Each sample's ``(lvl, y, x)`` clamped into the stack ``(K, NS)``
    int64, and whether it was inside (the kernel reads nothing outside and
    yields NaN)."""
    lv = lvl.long()[:, None]
    yy = y0.long()[:, None] + rel_y.long()
    xx = x0.long()[:, None] + rel_x.long()
    ok = (lv >= 0) & (lv < n_levels) & (yy >= 0) & (yy < height) & (xx >= 0) & (xx < width)
    return lv.clamp(0, n_levels - 1), yy.clamp(0, height - 1), xx.clamp(0, width - 1), ok


def _nan_outside(vals, ok):
    """``vals`` (K, C, NS) with NaN where the sample was outside."""
    return torch.where(ok[:, None, :], vals, torch.full((), float("nan"), dtype=vals.dtype, device=vals.device))


def select_samples_plain(planes, lvl, y0, x0, rel_x, rel_y, c0: int = 0) -> torch.Tensor:
    """The select by advanced indexing: ``(K, C - c0, NS)`` float32."""
    lv, yy, xx, ok = _inside(lvl, y0, x0, rel_x, rel_y, planes.shape[0], planes.shape[2], planes.shape[3])
    return _nan_outside(torch.stack([planes[lv, c, yy, xx] for c in range(c0, planes.shape[1])], dim=1), ok)


def select_samples_interleaved_plain(stack, lvl, y0, x0, rel_x, rel_y, c0: int = 0) -> torch.Tensor:
    """:func:`select_samples_interleaved` by advanced indexing: ``(K, 3 -
    c0, NS)`` float32 from the ``(L, Hp, 3 * Wp)`` stack."""
    lv, yy, xx, ok = _inside(lvl, y0, x0, rel_x, rel_y, stack.shape[0], stack.shape[1], stack.shape[2] // 3)
    return _nan_outside(torch.stack([stack[lv, yy, 3 * xx + c] for c in range(c0, 3)], dim=1), ok)


_SELECT_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _launch(fn, symbol, src, dims, lvl, y0, x0, rel_x, rel_y, c0):
    """Check one select's inputs and launch ``symbol`` of
    ``csrc/select_samples.cu`` on ``src`` (the stack in either layout),
    ``dims`` = (L, C, Hp, Wp); returns the (K, C - c0, NS) output."""
    n_levels, channels, height, width = dims
    k, ns = rel_x.shape
    for name, t, shape in (
        ("lvl", lvl, (k,)), ("y0", y0, (k,)), ("x0", x0, (k,)),
        ("rel_x", rel_x, (k, ns)), ("rel_y", rel_y, (k, ns)),
    ):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (src, lvl, y0, x0, rel_x, rel_y)):
        raise ValueError(f"{fn.__name__}: inputs must be contiguous")
    if not 0 <= c0 < channels:
        raise ValueError(f"c0={c0} outside [0, {channels})")
    out = torch.empty((k, channels - c0, ns), dtype=torch.float32, device=src.device)
    if k == 0 or ns == 0:
        return out
    err = kernels.function("select_samples", symbol, _SELECT_ARGS)(
        src.data_ptr(), lvl.data_ptr(), y0.data_ptr(), x0.data_ptr(),
        rel_x.data_ptr(), rel_y.data_ptr(), out.data_ptr(),
        n_levels, channels, height, width, k, ns, c0,
        kernels.current_stream(src.device),
    )
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: cudaError {err}")
    fn.launches += 1
    return out


def _on_card(fn, args) -> bool:
    """False where the select runs its plain version (every tensor on the
    CPU), True on a CUDA card; raises on mixed or other devices."""
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"{fn.__name__}: tensors on several devices {devices}")
    if args[0].device.type == "cpu":
        return False
    if args[0].device.type != "cuda":
        raise ValueError(f"{fn.__name__}: unsupported device {args[0].device}")
    return True


def select_samples(planes, lvl, y0, x0, rel_x, rel_y, c0: int = 0) -> torch.Tensor:
    """Select samples from the plane stack; see the module docstring.

    ``planes``: (L, C, Hp, Wp) float32 contiguous; ``lvl``/``y0``/``x0``:
    (K,) int32; ``rel_x``/``rel_y``: (K, NS) int32; ``c0`` in [0, C).
    """
    if not _on_card(select_samples, (planes, lvl, y0, x0, rel_x, rel_y)):
        return select_samples_plain(planes, lvl, y0, x0, rel_x, rel_y, c0)
    if planes.dtype != torch.float32 or planes.ndim != 4:
        raise ValueError(f"planes must be (L, C, Hp, Wp) float32, got {planes.dtype} {tuple(planes.shape)}")
    return _launch(select_samples, "cv_select_samples", planes, planes.shape, lvl, y0, x0, rel_x, rel_y, c0)


select_samples.launches = 0  # kernel launches so far (CPU calls do not count)


def select_samples_interleaved(stack, lvl, y0, x0, rel_x, rel_y, c0: int = 0) -> torch.Tensor:
    """Select samples from the pixel-interleaved stack; see the module
    docstring.  Port of ``cv_tpu/akaze/pallas_mldb.py::select_samples_gather``
    fed by the ``'+inter'`` patch cut (``cv_tpu/akaze/descriptors.py``:
    one ``(128, 384)`` slice a keypoint, de-interleaved): the kernel
    (``csrc/select_samples.cu``, ``cv_select_samples_interleaved``) reads
    the stack directly, a sample's channels as adjacent words.

    ``stack``: (L, Hp, 3 * Wp) float32 contiguous; ``lvl``/``y0``/``x0``:
    (K,) int32; ``rel_x``/``rel_y``: (K, NS) int32; ``c0`` in [0, 3).  On a
    CPU tensor the plain version runs; on a CUDA tensor the kernel, counted
    on ``select_samples_interleaved.launches``.
    """
    if not _on_card(select_samples_interleaved, (stack, lvl, y0, x0, rel_x, rel_y)):
        return select_samples_interleaved_plain(stack, lvl, y0, x0, rel_x, rel_y, c0)
    if stack.dtype != torch.float32 or stack.ndim != 3 or stack.shape[2] % 3:
        raise ValueError(f"stack must be (L, Hp, 3 * Wp) float32, got {stack.dtype} {tuple(stack.shape)}")
    dims = (stack.shape[0], 3, stack.shape[1], stack.shape[2] // 3)
    return _launch(select_samples_interleaved, "cv_select_samples_interleaved", stack, dims, lvl, y0, x0, rel_x,
                   rel_y, c0)


select_samples_interleaved.launches = 0  # kernel launches so far (CPU calls do not count)


def select_samples_patch(patches, rel_x, rel_y, c0: int = 0) -> torch.Tensor:
    """``out[k, c - c0, s] = patches[k, c, rel_y[k, s], rel_x[k, s]]`` over
    per-keypoint patches ``(K, C, 128, 128)``.

    Port of ``cv_tpu/akaze/pallas_mldb.py::select_samples_batched`` and
    ``select_samples``: both compute this exact select, the TPU as bf16x3
    one-hot matmuls.  Here the patches are a plane stack with one level per
    keypoint, so the select goes through :func:`select_samples` and its
    kernel (``lvl = arange(K)``, ``y0 = x0 = 0``); its launches count on
    ``select_samples.launches``.
    """
    k = patches.shape[0]
    zero = torch.zeros((k,), dtype=torch.int32, device=patches.device)
    lvl = torch.arange(k, dtype=torch.int32, device=patches.device)
    return select_samples(patches, lvl, zero, zero, rel_x, rel_y, c0)


def cut_patches(planes, lvl, y0, x0, side: int = 128, width: int | None = None) -> torch.Tensor:
    """``(K, C, side, width)`` windows ``planes[lvl, :, y0:y0+side,
    x0:x0+width]`` (``width`` defaults to ``side``): the patch cut of
    ``orient_mldb_onehot``."""
    yy = (y0.long()[:, None] + torch.arange(side, device=planes.device))[:, None, :, None]
    xx = (x0.long()[:, None] + torch.arange(width or side, device=planes.device))[:, None, None, :]
    ch = torch.arange(planes.shape[1], device=planes.device)[None, :, None, None]
    return planes[lvl.long()[:, None, None, None], ch, yy, xx]


GROUP = 8  # keypoint slots per window group (pallas_mldb.G)


def select_groups_plain(planes, win_lvl, win_ty, win_tx, n_active, rel_x, rel_y, c0: int = 0):
    """The group select by advanced indexing: ``(NG * 8, C - c0, NS)``
    float32, zero rows for slots ``j >= n_active``."""
    ng = win_lvl.shape[0]
    rel_x = rel_x.reshape(ng * GROUP, -1)
    rel_y = rel_y.reshape(ng * GROUP, -1)
    rep = lambda t: t.long().repeat_interleave(GROUP)  # noqa: E731
    yy = 128 * rep(win_ty)[:, None] + rel_y.long()
    xx = 128 * rep(win_tx)[:, None] + rel_x.long()
    lv = rep(win_lvl)[:, None]
    vals = torch.stack([planes[lv, c, yy, xx] for c in range(c0, planes.shape[1])], dim=1)
    live = torch.arange(GROUP, device=planes.device).repeat(ng) < rep(n_active)
    return torch.where(live[:, None, None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))


_GROUPS_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def select_groups(planes, win_lvl, win_ty, win_tx, n_active, rel_x, rel_y, c0: int = 0) -> torch.Tensor:
    """Select samples for window-sorted keypoint groups.

    ``out[t*8 + j, c - c0, s] = planes[win_lvl[t], c, 128*win_ty[t] +
    rel_y[t*8 + j, s], 128*win_tx[t] + rel_x[t*8 + j, s]]`` for ``j <
    n_active[t]``, zero rows otherwise.  Port of
    ``cv_tpu/akaze/pallas_mldb.py::select_samples_groups``; ``rel_x`` /
    ``rel_y`` may come in its ``(NG / w, w * 8, NS)`` layout or flat as
    ``(NG * 8, NS)`` (the same rows).  At most 3 channels are selected
    (``C - c0 <= 3``).  On a CPU tensor the wrapper runs the plain version;
    on a CUDA tensor it launches ``csrc/select_groups.cu`` or raises.
    """
    args = (planes, win_lvl, win_ty, win_tx, n_active, rel_x, rel_y)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"select_groups: tensors on several devices {devices}")
    if planes.device.type == "cpu":
        return select_groups_plain(*args, c0=c0)
    if planes.device.type != "cuda":
        raise ValueError(f"select_groups: unsupported device {planes.device}")
    if planes.dtype != torch.float32 or planes.ndim != 4:
        raise ValueError(f"planes must be (L, C, Hp, Wp) float32, got {planes.dtype} {tuple(planes.shape)}")
    n_levels, channels, height, width = planes.shape
    ng = win_lvl.shape[0]
    ns = rel_x.shape[-1]
    rel_x = rel_x.reshape(ng * GROUP, ns)
    rel_y = rel_y.reshape(ng * GROUP, ns)
    for name, t, shape in (
        ("win_lvl", win_lvl, (ng,)), ("win_ty", win_ty, (ng,)), ("win_tx", win_tx, (ng,)),
        ("n_active", n_active, (ng,)), ("rel_x", rel_x, (ng * GROUP, ns)), ("rel_y", rel_y, (ng * GROUP, ns)),
    ):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (planes, win_lvl, win_ty, win_tx, n_active, rel_x, rel_y)):
        raise ValueError("select_groups: inputs must be contiguous")
    if not 0 <= c0 < channels or channels - c0 > 3:
        raise ValueError(f"c0={c0}: select_groups takes channels c0: of C={channels}, at most 3 of them")
    out = torch.empty((ng * GROUP, channels - c0, ns), dtype=torch.float32, device=planes.device)
    if ng == 0 or ns == 0:
        return out
    err = kernels.function("select_groups", "cv_select_groups", _GROUPS_ARGS)(
        planes.data_ptr(), win_lvl.data_ptr(), win_ty.data_ptr(), win_tx.data_ptr(),
        n_active.data_ptr(), rel_x.data_ptr(), rel_y.data_ptr(), out.data_ptr(),
        n_levels, channels, height, width, ng, ns, c0,
        kernels.current_stream(planes.device),
    )
    if err != 0:
        raise RuntimeError(f"select_groups kernel launch failed: cudaError {err}")
    select_groups.launches += 1
    return out


select_groups.launches = 0  # kernel launches so far (CPU calls do not count)
