"""The retired sample selects and describe modes 'pepatch' and 'ptiles'.

Port of ``experiments/pallas_mldb_losers.py``.  On the TPU these were
three Pallas kernels that brought each keypoint's sampling window into VMEM
in other ways (an element-offset patch DMA; four plane-quadrant blocks of a
256x256 window, one or eight keypoints a grid step) and then ran the same
select.  All three compute the function of the select kernel
(``csrc/select_samples.cu``):

    out[k, c - c0, s] = planes[lvl[k], c, y0[k] + rel_y[k, s], x0[k] + rel_x[k, s]]

with ``y0 = 128 * ty`` and ``x0 = 128 * tx`` for the tile forms.  On Hopper
that kernel already reads the stack through L2 at any offset, so each of
them is that kernel.  A launch counts on ``select.select_samples.launches``
and on the retired wrapper's own ``.launches`` (which adds the select
kernel's launches made inside the call, so a call on CPU tensors adds 0).

Importing this module registers the describe modes ``'pepatch'`` (the
two-pass describe of ``descriptors.orient_mldb`` with
:func:`epatch_select` as its select) and ``'ptiles'``
(:func:`orient_mldb_ptiles`) in ``descriptors.EXTERNAL_MODES``, as
importing the JAX module does in ``cv_tpu``.
"""

from __future__ import annotations

import torch

from ..akaze import descriptors as desc
from ..akaze.select import GROUP, select_samples

P = desc.PATCH


def _counted(wrapper, planes, lvl, y0, x0, rel_x, rel_y, c0) -> torch.Tensor:
    before = select_samples.launches
    out = select_samples(planes, lvl, y0, x0, rel_x, rel_y, c0)
    wrapper.launches += select_samples.launches - before
    return out


def select_samples_epatch(planes, lvl, y0, x0, rel_x, rel_y, c0: int = 0, g: int = GROUP) -> torch.Tensor:
    """``(K, C - c0, NS)`` samples at element offsets ``(y0, x0)``: the
    select kernel as it is.  ``g`` (keypoints per TPU grid step) has no
    effect here."""
    return _counted(select_samples_epatch, planes, lvl, y0, x0, rel_x, rel_y, c0)


def select_samples_tiles(planes, lvl, ty, tx, rel_x, rel_y, c0: int = 0) -> torch.Tensor:
    """``(K, C - c0, NS)`` samples of the 256x256 window at tile ``(ty,
    tx)``: ``rel_x``/``rel_y`` in [0, 256) from ``(128 ty, 128 tx)``."""
    return _counted(select_samples_tiles, planes, lvl, P * ty, P * tx, rel_x, rel_y, c0)


def select_samples_tiles8(planes, lvl, ty, tx, rel_x, rel_y, c0: int = 0, g: int = GROUP) -> torch.Tensor:
    """:func:`select_samples_tiles`, G keypoints a TPU grid step; ``g`` has
    no effect here."""
    return _counted(select_samples_tiles8, planes, lvl, P * ty, P * tx, rel_x, rel_y, c0)


# Select-kernel launches made through each wrapper so far.
select_samples_epatch.launches = 0
select_samples_tiles.launches = 0
select_samples_tiles8.launches = 0


def orient_mldb_ptiles(planes, lvl, width, height, xf, yf, scale, pattern_size: int = 10):
    """The 'ptiles' describe: keypoints sorted by the 256x256 tile window
    that holds their 128x128 patch, both sample passes through
    :func:`select_samples_tiles8` with window-relative offsets clipped to
    [0, 255], then put back in keypoint order.  Returns ``(words (K, 16)
    int32, ok (K,), angle (K,))``.

    A stack below 256x256 raises ``ValueError``: it has no such window, and
    the JAX version's tile clip goes to -1 there
    (``experiments/pallas_mldb_losers.py:373-374``).
    """
    hmax, wmax = planes.shape[2], planes.shape[3]
    ht, wt = hmax // P, wmax // P
    if ht < 2 or wt < 2:
        raise ValueError(
            f"'ptiles' needs a padded stack of at least 256x256, got {hmax}x{wmax} "
            "(experiments/pallas_mldb_losers.py:373-374 clips the tile to -1 there); use 'pgather'"
        )
    lvl = lvl.to(torch.int32)
    y0, x0 = desc.patch_anchor(xf, yf, hmax, wmax)
    ty = torch.clamp(y0 // P, 0, ht - 2)
    tx = torch.clamp(x0 // P, 0, wt - 2)
    key = (lvl.to(torch.int64) * ht + ty) * wt + tx
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    lvl_s, ty_s, tx_s, xf_s, yf_s, sc_s, w_s, h_s = (
        t[perm] for t in (lvl, ty, tx, xf, yf, scale, width, height)
    )
    x0_s, y0_s = tx_s * P, ty_s * P
    span = 2 * P
    orel_x, orel_y = desc.orientation_offsets(xf_s, yf_s, sc_s, w_s, h_s, x0_s, y0_s, span)
    angle_s = desc.orientation_from_values(select_samples_tiles8(planes, lvl_s, ty_s, tx_s, orel_x, orel_y, c0=1))
    rel_x, rel_y, ok_s, co, si = desc.mldb_offsets(
        xf_s, yf_s, sc_s, angle_s, w_s, h_s, x0_s, y0_s, span, pattern_size
    )
    vals = select_samples_tiles8(planes, lvl_s, ty_s, tx_s, rel_x, rel_y)
    words_s = desc._mldb_pack(vals[:, 0], vals[:, 1], vals[:, 2], co, si, pattern_size)
    return words_s[inv], ok_s[inv], angle_s[inv]


def epatch_select(planes, lvl, y0, x0, rel_x, rel_y, c0: int = 0) -> torch.Tensor:
    """The 'pepatch' select hook (``descriptors.EXTERNAL_MODES['pepatch']``):
    :func:`select_samples_epatch`.  The JAX hook padded NS to a multiple
    of 128 lanes; the kernel needs no padding."""
    return select_samples_epatch(planes, lvl, y0, x0, rel_x, rel_y, c0)


desc.EXTERNAL_MODES["ptiles"] = orient_mldb_ptiles
desc.EXTERNAL_MODES["pepatch"] = epatch_select
