"""The single-pass describe: the hand-written CUDA kernel and its plain
PyTorch version.

Port of ``cv_tpu/akaze/pallas_mldb.py::select_samples_fused`` and the
``'pfused'`` branch of ``cv_tpu/akaze/descriptors.py::orient_mldb_onehot``.
Per keypoint, one kernel (``csrc/select_fused.cu``) selects the
orientation samples, computes the dominant angle, its cosine and sine, the
M-LDB sample positions and their bounds flag, and selects the M-LDB
samples.  The plain version is the two-pass describe of
:func:`descriptors.orient_mldb` with the plain select.  On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises.

Both sides sum each orientation window in the halving tree of
:func:`descriptors.tree_sum` and evaluate the same float expressions (the
kernel is built with ``--fmad=false``), so on the card the kernel gives its
plain version's bits.  Their ``atan2``/``cos``/``sin`` come from the CUDA
math library of two builds (PyTorch's and the card's ``nvcc``), which could
round differently; ``chip_smoke.py`` therefore also states the describe
gates (angles within 1e-5 rad, >= 99% of word rows equal).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from . import descriptors as desc
from .select import select_samples_plain


def select_fused_plain(planes, lvl, y0, x0, orel_x, orel_y, xf, yf, scale, width, height,
                       pattern_size: int = 10):
    """The two-pass version: ``(vals (K, 3, 441), meta (K, 4))`` with meta
    rows ``[angle, cos, sin, ok]``."""
    p = desc.PATCH
    angle = desc.orientation_from_values(select_samples_plain(planes, lvl, y0, x0, orel_x, orel_y, c0=1))
    rel_x, rel_y, ok, co, si = desc.mldb_offsets(xf, yf, scale, angle, width, height, x0, y0, p, pattern_size)
    vals = select_samples_plain(planes, lvl, y0, x0, rel_x, rel_y, c0=0)
    meta = torch.stack([angle, co[:, 0], si[:, 0], ok.to(angle.dtype)], dim=1)
    return vals, meta


_FUSED_ARGS = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]


def select_fused(planes, lvl, y0, x0, orel_x, orel_y, xf, yf, scale, width, height,
                 pattern_size: int = 10):
    """Orientation select, angle, M-LDB positions and M-LDB select in one
    pass; see the module docstring.

    ``planes``: (L, 3, Hp, Wp) float32; ``lvl``/``y0``/``x0``/``width``/
    ``height``: (K,) int32; ``orel_x``/``orel_y``: (K, 109) int32 offsets
    in the window at ``(y0, x0)``; ``xf``/``yf``/``scale``: (K,) float32.
    Returns ``(vals (K, 3, 441) float32, meta (K, 4) float32)``.
    """
    args = (planes, lvl, y0, x0, orel_x, orel_y, xf, yf, scale, width, height)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"select_fused: tensors on several devices {devices}")
    dev = planes.device
    if dev.type == "cpu":
        return select_fused_plain(*args, pattern_size=pattern_size)
    if dev.type != "cuda":
        raise ValueError(f"select_fused: unsupported device {dev}")
    if planes.dtype != torch.float32 or planes.ndim != 4 or planes.shape[1] != 3:
        raise ValueError(f"planes must be (L, 3, Hp, Wp) float32, got {planes.dtype} {tuple(planes.shape)}")
    n_levels, _, height_p, width_p = planes.shape
    k, no = orel_x.shape
    for name, t, dtype, shape in (
        ("lvl", lvl, torch.int32, (k,)), ("y0", y0, torch.int32, (k,)), ("x0", x0, torch.int32, (k,)),
        ("orel_x", orel_x, torch.int32, (k, no)), ("orel_y", orel_y, torch.int32, (k, no)),
        ("xf", xf, torch.float32, (k,)), ("yf", yf, torch.float32, (k,)),
        ("scale", scale, torch.float32, (k,)), ("width", width, torch.int32, (k,)),
        ("height", height, torch.int32, (k,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("select_fused: inputs must be contiguous")
    ot = desc._orientation_device_tables(dev)
    mt = desc._mldb_device_tables(pattern_size, dev)
    if ot["wt"].shape[0] != no:
        raise ValueError(f"orel tables have {no} samples, the disc has {ot['wt'].shape[0]}")
    nw, ns = ot["ang1s"].shape[0], mt["ks"].shape[0]
    vals = torch.empty((k, 3, ns), dtype=torch.float32, device=dev)
    meta = torch.empty((k, 4), dtype=torch.float32, device=dev)
    if k == 0:
        return vals, meta
    err = kernels.function("select_fused", "cv_select_fused", _FUSED_ARGS)(
        *(t.data_ptr() for t in args),
        ot["wt"].data_ptr(), ot["ang1s"].data_ptr(), ot["ang2s"].data_ptr(),
        mt["ks"].data_ptr(), mt["ls"].data_ptr(), vals.data_ptr(), meta.data_ptr(),
        n_levels, height_p, width_p, k, no, nw, ns, ctypes.c_float(desc.TWO_PI),
        kernels.current_stream(dev),
    )
    if err != 0:
        raise RuntimeError(f"select_fused kernel launch failed: cudaError {err}")
    select_fused.launches += 1
    return vals, meta


select_fused.launches = 0  # kernel launches so far (CPU calls do not count)


def orient_mldb_fused(planes, lvl, width, height, xf, yf, scale, pattern_size: int = 10):
    """Describe mode ``'pfused'``: orientation and M-LDB words through
    :func:`select_fused`.  Returns ``(words (K, 16) int32, ok (K,), angle
    (K,))``, as :func:`descriptors.orient_mldb` does."""
    lvl = lvl.to(torch.int32)
    y0, x0 = desc.patch_anchor(xf, yf, planes.shape[2], planes.shape[3])
    orel_x, orel_y = desc.orientation_offsets(xf, yf, scale, width, height, x0, y0, desc.PATCH)
    vals, meta = select_fused(
        planes, lvl, y0, x0, orel_x, orel_y, xf.contiguous(), yf.contiguous(), scale.contiguous(),
        width.to(torch.int32).contiguous(), height.to(torch.int32).contiguous(), pattern_size,
    )
    co, si = meta[:, 1:2], meta[:, 2:3]
    words = desc._mldb_pack(vals[:, 0], vals[:, 1], vals[:, 2], co, si, pattern_size)
    return words, meta[:, 3] > 0.5, meta[:, 0]
