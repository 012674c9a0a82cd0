"""Batched 2-D image primitives for the AKAZE scale space.

Port of ``cv_tpu/ops/image.py``.  Everything operates on ``(..., H, W)``
float32 tensors.  The separable filters are the same fixed
shift-multiply-add chain over the taps in order (not a convolution
library call), so the port rounds like the reference wherever the chain is
evaluated in source order; every step is its own elementwise kernel, so
no multiply-add is contracted into an FMA on either device.

Semantics preserved exactly:
* separable filters use replicate (edge-clamp) padding (image.rs:232-235)
* ``half_size`` is a 2x2 box with the reference's odd-edge overwrite rules
  (image.rs:154-199)
* ``gaussian_kernel`` is computed in f32 and normalized (image.rs:360-381),
  radius = ceil(2 sigma) (image.rs:383-389)
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel(sigma: float, kernel_size: int) -> np.ndarray:
    """1-D normalized Gaussian in f32 (image.rs:346-381). Host-side."""
    assert kernel_size % 2 == 1, "kernel_size must be odd"
    half = kernel_size // 2
    x = np.arange(-half, half + 1, dtype=np.float32)
    sigma = np.float32(sigma)
    k = (np.float32(1.0) / (np.sqrt(np.float32(2.0 * math.pi)) * sigma)) * np.exp(
        -(x * x) / (np.float32(2.0) * sigma * sigma)
    )
    k = k.astype(np.float32)
    return k / k.sum()


def gaussian_blur_kernel(sigma: float) -> np.ndarray:
    """Kernel used by ``gaussian_blur`` (image.rs:383-389)."""
    radius = int(math.ceil(2.0 * float(sigma)))
    return gaussian_kernel(sigma, 2 * radius + 1)


def scharr_main_kernel(sigma_size: int) -> np.ndarray:
    """Scharr derivative kernel of scale ``sigma_size`` (derivatives.rs:57-79)."""
    if sigma_size == 1:
        return np.array([-1.0, 0.0, 1.0], dtype=np.float32)
    ksize = 3 + 2 * (sigma_size - 1)
    k = np.zeros(ksize, dtype=np.float32)
    k[0], k[-1] = -1.0, 1.0
    return k


def scharr_off_kernel(sigma_size: int) -> np.ndarray:
    """Scharr smoothing kernel of scale ``sigma_size`` (derivatives.rs:57-79)."""
    if sigma_size == 1:
        return np.array([3.0, 10.0, 3.0], dtype=np.float32)
    w = 10.0 / 3.0
    norm = np.float32(1.0 / (2.0 * float(sigma_size) * (w + 2.0)))
    ksize = 3 + 2 * (sigma_size - 1)
    k = np.zeros(ksize, dtype=np.float32)
    k[0] = k[-1] = norm
    k[ksize // 2] = norm * np.float32(w)
    return k


def _conv1d(img: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate along ``axis`` (-1 = rows/horizontal, -2 = cols/vertical)
    with replicate padding, batched over all leading dims.

    The taps are applied in order as ``out = out + slice * tap``; zero taps
    (most of a scaled Scharr kernel) are skipped, as in the reference.
    """
    taps = np.asarray(kernel)
    half = taps.shape[0] // 2
    n = img.shape[axis]
    # Edge padding as an index clamp: works for any number of leading dims.
    src = torch.arange(-half, n + half, device=img.device).clamp_(0, n - 1)
    padded = img.index_select(axis, src)
    out = None
    for i in range(taps.shape[0]):
        if taps[i] == 0.0:
            continue
        term = padded.narrow(axis, i, n) * float(taps[i])
        out = term if out is None else out + term
    if out is None:  # all-zero kernel: a zero image, not None
        return torch.zeros_like(img)
    return out


def horizontal_filter(img: torch.Tensor, kernel) -> torch.Tensor:
    """Filter along x (image.rs:202-251)."""
    return _conv1d(img, np.asarray(kernel, np.float32), axis=-1)


def vertical_filter(img: torch.Tensor, kernel) -> torch.Tensor:
    """Filter along y (image.rs:253-331)."""
    return _conv1d(img, np.asarray(kernel, np.float32), axis=-2)


def separable_filter(img: torch.Tensor, h_kernel, v_kernel) -> torch.Tensor:
    """Horizontal then vertical pass (image.rs:333-340)."""
    return vertical_filter(horizontal_filter(img, h_kernel), v_kernel)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur with radius ceil(2 sigma) (image.rs:383-389)."""
    k = gaussian_blur_kernel(sigma)
    return separable_filter(img, k, k)


def scharr_horizontal(img: torch.Tensor, sigma_size: int = 1) -> torch.Tensor:
    """d/dx Scharr derivative at scale sigma_size (derivatives.rs:23-35)."""
    return separable_filter(
        img, scharr_main_kernel(sigma_size), scharr_off_kernel(sigma_size)
    )


def scharr_vertical(img: torch.Tensor, sigma_size: int = 1) -> torch.Tensor:
    """d/dy Scharr derivative at scale sigma_size (derivatives.rs:45-56)."""
    return separable_filter(
        img, scharr_off_kernel(sigma_size), scharr_main_kernel(sigma_size)
    )


def half_size(img: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample with the reference's odd-edge overwrites
    (image.rs:154-199).  Each 2x2 block is summed as ``(top-left +
    top-right) + (bottom-left + bottom-right)``, then quartered: elementwise
    adds, so every device rounds alike (``Tensor.mean``'s order depends on
    the device; this is its order on the CPU)."""
    h, w = img.shape[-2], img.shape[-1]
    hh, hw = h // 2, w // 2
    lead = img.shape[:-2]
    core = img[..., : hh * 2, : hw * 2].reshape(lead + (hh, 2, hw, 2))
    top, bottom = core[..., 0, :, :], core[..., 1, :, :]
    out = ((top[..., 0] + top[..., 1]) + (bottom[..., 0] + bottom[..., 1])) / 4.0
    if h % 2 == 1:
        last = img[..., -1, : hw * 2].reshape(lead + (hw, 2))
        out[..., -1, :] = 0.5 * last.sum(dim=-1)
    if w % 2 == 1:
        lastc = img[..., : hh * 2, -1].reshape(lead + (hh, 2))
        out[..., :, -1] = 0.5 * lastc.sum(dim=-1)
    if h % 2 == 1 and w % 2 == 1:
        out[..., -1, -1] = img[..., -1, -1]
    return out


def pm_g2(lx: torch.Tensor, ly: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Perona-Malik g2 conductivity 1/(1 + |grad|^2 / k^2)
    (nonlinear_diffusion.rs:70-83).  ``k``: per-frame contrast, shape
    ``lx.shape[:-2]`` (or 0-d)."""
    inv_k2 = (1.0 / (k * k)).to(lx.dtype)
    if inv_k2.ndim:
        inv_k2 = inv_k2[..., None, None]
    return 1.0 / (1.0 + inv_k2 * (lx * lx + ly * ly))


def fed_step(lt: torch.Tensor, conductivity: torch.Tensor, step_size: float) -> torch.Tensor:
    """One explicit FED diffusion step (nonlinear_diffusion.rs:14-58).

    Each output pixel sums the half-flows with its 4-neighbours; the flow
    between ``a`` and ``b`` is ``0.5 * step * (ca + cb) * (b - a)`` with
    ``step`` rounded to the plane's dtype first, as in the reference.
    """
    half_step = float(np.float32(0.5) * np.float32(step_size))
    c, l = conductivity, lt
    # Horizontal flows between (y, x) and (y, x+1): shape (..., H, W-1)
    hf = half_step * (c[..., :-1] + c[..., 1:]) * (l[..., 1:] - l[..., :-1])
    # Vertical flows between (y, x) and (y+1, x): shape (..., H-1, W)
    vf = half_step * (c[..., :-1, :] + c[..., 1:, :]) * (l[..., 1:, :] - l[..., :-1, :])
    # out = lt + (flow from right neighbor) - (flow into left neighbor) ...
    return (
        l
        + F.pad(hf, (0, 1))
        - F.pad(hf, (1, 0))
        + F.pad(vf, (0, 0, 0, 1))
        - F.pad(vf, (0, 0, 1, 0))
    )
