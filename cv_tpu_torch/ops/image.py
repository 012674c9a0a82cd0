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

The scale space's steps also run as hand kernels (``csrc/scale_space.cu``):
:func:`sep_filter`, :func:`evolution_flow`, :func:`fed_cycle` (an
evolution's FED steps, several a launch; :func:`fed_update` is a cycle of
one step) and :func:`detector` launch their kernel on CUDA tensors (each
counting on its own ``.launches``) and run their plain versions on CPU
tensors: :func:`sep_filter_plain`, :func:`evolution_flow_plain`,
:func:`fed_cycle_plain` (:func:`fed_step` a tau) and
:func:`detector_plain`, compositions of the functions above.  The kernels
round as those compositions do, bit for bit; a kernel that cannot build or
launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels


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


# ---------------------------------------------------------------------------
# The scale space's fused steps: plain versions and their kernels.
# ---------------------------------------------------------------------------


def sep_filter_plain(img: torch.Tensor, h_kernel, v_kernel, h2_kernel=None, v2_kernel=None):
    """:func:`separable_filter` of ``img`` with the tap pair ``(h_kernel,
    v_kernel)``, or a tuple of two such filters when ``(h2_kernel,
    v2_kernel)`` is given."""
    out = separable_filter(img, h_kernel, v_kernel)
    if h2_kernel is None:
        return out
    return out, separable_filter(img, h2_kernel, v2_kernel)


def evolution_flow_plain(lt: torch.Tensor, k: torch.Tensor):
    """An evolution's smoothed image and conductivity (lib.rs:193-258,
    nonlinear_diffusion.rs:70-83):
    ``lsmooth = gaussian_blur(lt, 1)``, its Scharr pair at scale 1 and
    ``pm_g2`` with the per-frame contrast ``k``.  Returns ``(lsmooth,
    flow)``."""
    lsmooth = gaussian_blur(lt, 1.0)
    lx = scharr_horizontal(lsmooth, 1)
    ly = scharr_vertical(lsmooth, 1)
    return lsmooth, pm_g2(lx, ly, k)


def fed_cycle_plain(lt: torch.Tensor, conductivity: torch.Tensor, taus) -> torch.Tensor:
    """An evolution's FED cycle (lib.rs:193-258): :func:`fed_step` of
    ``lt`` under ``conductivity`` for each tau of ``taus`` in turn."""
    for tau in taus:
        lt = fed_step(lt, conductivity, tau)
    return lt


def detector_plain(lsmooth: torch.Tensor, sigma_size: int):
    """The detector response of one evolution (detector_response.rs:8-57):
    the multiscale Scharr pair of ``lsmooth``, its second derivatives and
    the Hessian determinant scaled by ``sigma_size ** 4``.  Returns ``(lx,
    ly, ldet)``."""
    lx = scharr_horizontal(lsmooth, sigma_size)
    ly = scharr_vertical(lsmooth, sigma_size)
    lxx = scharr_horizontal(lx, sigma_size)
    lyy = scharr_vertical(ly, sigma_size)
    lxy = scharr_vertical(lx, sigma_size)
    ldet = (lxx * lyy - lxy * lxy) * float(sigma_size) ** 4
    return lx, ly, ldet


def sep_filter(img: torch.Tensor, h_kernel, v_kernel, h2_kernel=None, v2_kernel=None):
    """:func:`sep_filter_plain`'s function: on a CUDA tensor one launch of
    ``cv_sep_filter`` (:func:`sep_filter_kernel`, counted on
    ``sep_filter.launches``), on a CPU tensor the plain version."""
    if img.device.type == "cpu":
        return sep_filter_plain(img, h_kernel, v_kernel, h2_kernel, v2_kernel)
    return sep_filter_kernel(img, h_kernel, v_kernel, h2_kernel, v2_kernel)


def evolution_flow(lt: torch.Tensor, k: torch.Tensor):
    """:func:`evolution_flow_plain`'s function: on CUDA tensors one launch
    of ``cv_evolution_flow`` (:func:`evolution_flow_kernel`, counted on
    ``evolution_flow.launches``), on CPU tensors the plain version."""
    if lt.device.type == "cpu":
        return evolution_flow_plain(lt, k)
    return evolution_flow_kernel(lt, k)


def fed_cycle(lt: torch.Tensor, conductivity: torch.Tensor, taus) -> torch.Tensor:
    """:func:`fed_cycle_plain`'s function: on CUDA tensors ``cv_fed_cycle``
    (:func:`fed_cycle_kernel`, :func:`fed_block_steps` steps a launch, each
    launch counted on ``fed_cycle.launches``), on CPU tensors the plain
    version."""
    if lt.device.type == "cpu":
        return fed_cycle_plain(lt, conductivity, taus)
    return fed_cycle_kernel(lt, conductivity, taus)


def fed_update(lt: torch.Tensor, conductivity: torch.Tensor, step_size: float) -> torch.Tensor:
    """:func:`fed_step`'s function: on CUDA tensors a :func:`fed_cycle` of
    the one step (one launch of ``cv_fed_cycle``, counted on
    ``fed_cycle.launches``), on CPU tensors :func:`fed_step`."""
    if lt.device.type == "cpu":
        return fed_step(lt, conductivity, step_size)
    return fed_cycle_kernel(lt, conductivity, (step_size,))


def detector(lsmooth: torch.Tensor, sigma_size: int):
    """:func:`detector_plain`'s function: on a CUDA tensor one launch of
    ``cv_detector`` (:func:`detector_kernel`, counted on
    ``detector.launches``), on a CPU tensor the plain version."""
    if lsmooth.device.type == "cpu":
        return detector_plain(lsmooth, sigma_size)
    return detector_kernel(lsmooth, sigma_size)


# Kernel launches so far (CPU calls do not count).
sep_filter.launches = 0
evolution_flow.launches = 0
fed_cycle.launches = 0
detector.launches = 0

_VOID, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAPS = ctypes.POINTER(ctypes.c_float)


def _taps(kernel):
    """``(float array, count)`` of a 1-D kernel's float32 taps for a C call."""
    return _taps_of(np.asarray(kernel, np.float32).ravel().tobytes())


@functools.lru_cache(maxsize=256)
def _taps_of(raw: bytes):
    taps = np.frombuffer(raw, np.float32)
    return (ctypes.c_float * taps.shape[0])(*taps.tolist()), taps.shape[0]


@functools.lru_cache(maxsize=None)
def _flow_taps():
    """The flow's blur and scale-1 Scharr taps for ``cv_evolution_flow``."""
    return _taps(gaussian_blur_kernel(1.0)), _taps(scharr_main_kernel(1)), _taps(scharr_off_kernel(1))


@functools.lru_cache(maxsize=None)
def _scharr_taps(sigma_size: int):
    """``(main_lo, main_hi, off_side, off_mid)``: the nonzero taps of
    :func:`scharr_main_kernel` and :func:`scharr_off_kernel` at
    ``sigma_size``, at offsets -s, +s, +-s and 0."""
    main, off = scharr_main_kernel(sigma_size), scharr_off_kernel(sigma_size)
    s = sigma_size
    assert main.shape[0] == off.shape[0] == 2 * s + 1 and off[0] == off[-1]
    assert not main[1:-1].any() and not np.delete(off, [0, s, 2 * s]).any()
    return float(main[0]), float(main[-1]), float(off[0]), float(off[s])


@functools.lru_cache(maxsize=256)
def _half_steps(taus: tuple):
    """``0.5 tau`` rounded to float32 for each tau, as :func:`fed_step`
    rounds it, in a float array for a C call."""
    half = [float(np.float32(0.5) * np.float32(t)) for t in taus]
    return (ctypes.c_float * max(len(half), 1))(*half)


# The most FED steps one launch of cv_fed_cycle runs (its kMaxFused).
FED_MAX_STEPS = 32


def fed_block_steps(n: int, h: int, w: int) -> int:
    """The FED steps a launch of ``cv_fed_cycle`` runs in a cycle of ``n``
    steps on ``h x w`` planes: all of them up to :data:`FED_MAX_STEPS`."""
    return max(1, min(n, FED_MAX_STEPS))


def _planes(name: str, *planes: torch.Tensor):
    """Check ``planes`` (CUDA float32, one shape ``(..., H, W)``) for the
    kernel ``name``; returns them contiguous and ``(frames, H, W)``."""
    first = planes[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors, got {first.device}")
    if first.ndim < 2:
        raise ValueError(f"{name}: planes of shape (..., H, W), got {tuple(first.shape)}")
    for p in planes:
        if p.device != first.device or p.dtype != torch.float32 or p.shape != first.shape:
            raise ValueError(f"{name}: float32 planes of one shape on one device, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
    h, w = first.shape[-2], first.shape[-1]
    frames = first.numel() // (h * w) if h * w else 0
    if max(frames, h, w) >= 2**31:
        raise ValueError(f"{name}: {frames} frames of {h}x{w}")
    return [p.contiguous() for p in planes], (frames, h, w)


def _launched(err: int, symbol: str, counter, frames: int, h: int, w: int, launches: int = 1) -> None:
    """Raise on a refused or failed launch; else count its ``launches`` on
    ``counter``."""
    if err == -1:
        raise ValueError(f"{symbol}: arguments the kernel does not take ({frames} frames of {h}x{w})")
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")
    if frames * h * w:
        counter.launches += launches


def sep_filter_kernel(img: torch.Tensor, h_kernel, v_kernel, h2_kernel=None, v2_kernel=None):
    """``cv_sep_filter`` of ``csrc/scale_space.cu`` on a CUDA float32
    ``(..., H, W)`` tensor: :func:`sep_filter_plain`'s function, bit for
    bit, in one launch (both tap pairs of two outputs in the same one).
    Odd tap counts up to 33."""
    (x,), (frames, h, w) = _planes("sep_filter_kernel", img)
    two = h2_kernel is not None
    out1 = torch.empty_like(x)
    out2 = torch.empty_like(x) if two else None
    h1, v1 = _taps(h_kernel), _taps(v_kernel)
    h2, v2 = (_taps(h2_kernel), _taps(v2_kernel)) if two else ((None, 0), (None, 0))
    fn = kernels.function("scale_space", "cv_sep_filter",
                          [_VOID, _VOID, _VOID, _INT, _INT, _INT] + [_TAPS, _INT] * 4 + [_VOID])
    err = fn(x.data_ptr(), out1.data_ptr(), out2.data_ptr() if two else None, frames, h, w, *h1, *v1, *h2, *v2,
             kernels.current_stream(x.device))
    _launched(err, "cv_sep_filter", sep_filter, frames, h, w)
    return (out1, out2) if two else out1


def evolution_flow_kernel(lt: torch.Tensor, k: torch.Tensor):
    """``cv_evolution_flow`` of ``csrc/scale_space.cu`` on CUDA tensors:
    :func:`evolution_flow_plain`'s function, bit for bit, in one launch.
    ``lt`` float32 ``(..., H, W)``; ``k`` float32, one value a frame (shape
    ``lt.shape[:-2]``) or one for all.  Returns ``(lsmooth, flow)``."""
    (x,), (frames, h, w) = _planes("evolution_flow_kernel", lt)
    if k.device != x.device or k.dtype != torch.float32 or (k.numel() != 1 and k.shape != x.shape[:-2]):
        raise ValueError(f"evolution_flow_kernel: a float32 contrast of shape {tuple(x.shape[:-2])} or one value "
                         f"on {x.device}, got {k.dtype} {tuple(k.shape)} on {k.device}")
    k = k.contiguous()
    lsmooth, flow = torch.empty_like(x), torch.empty_like(x)
    gauss, main, off = _flow_taps()
    fn = kernels.function("scale_space", "cv_evolution_flow",
                          [_VOID, _VOID, _INT, _VOID, _VOID, _INT, _INT, _INT, _TAPS, _INT, _TAPS, _TAPS, _INT,
                           _VOID])
    err = fn(x.data_ptr(), k.data_ptr(), 0 if k.numel() == 1 else 1, lsmooth.data_ptr(), flow.data_ptr(), frames, h,
             w, *gauss, main[0], off[0], main[1], kernels.current_stream(x.device))
    _launched(err, "cv_evolution_flow", evolution_flow, frames, h, w)
    return lsmooth, flow


def fed_cycle_kernel(lt: torch.Tensor, conductivity: torch.Tensor, taus, block_steps: int | None = None):
    """``cv_fed_cycle`` of ``csrc/scale_space.cu`` on CUDA float32 planes of
    one shape: :func:`fed_cycle_plain`'s function, bit for bit, in
    ``ceil(len(taus) / block_steps)`` launches (``block_steps`` from 1 to
    :data:`FED_MAX_STEPS`, :func:`fed_block_steps` by default).  ``lt``
    itself when ``taus`` is empty."""
    (l, c), (frames, h, w) = _planes("fed_cycle_kernel", lt, conductivity)
    taus = tuple(float(t) for t in taus)
    n = len(taus)
    k = fed_block_steps(n, h, w) if block_steps is None else int(block_steps)
    if not 1 <= k <= FED_MAX_STEPS:
        raise ValueError(f"fed_cycle_kernel: block_steps from 1 to {FED_MAX_STEPS}, got {block_steps}")
    if n == 0:
        return l
    launches = -(-n // k)
    out = torch.empty_like(l)
    scratch = torch.empty_like(l) if launches > 1 else None
    fn = kernels.function("scale_space", "cv_fed_cycle",
                          [_VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _TAPS, _INT, _INT, _VOID])
    err = fn(l.data_ptr(), c.data_ptr(), out.data_ptr(), scratch.data_ptr() if scratch is not None else None, frames,
             h, w, _half_steps(taus), n, k, kernels.current_stream(l.device))
    _launched(err, "cv_fed_cycle", fed_cycle, frames, h, w, launches)
    return out


def detector_kernel(lsmooth: torch.Tensor, sigma_size: int):
    """``cv_detector`` of ``csrc/scale_space.cu`` on a CUDA float32
    ``(..., H, W)`` tensor: :func:`detector_plain`'s function, bit for bit,
    in one launch.  ``sigma_size`` from 1 to 16.  Returns ``(lx, ly,
    ldet)``."""
    (x,), (frames, h, w) = _planes("detector_kernel", lsmooth)
    if not 1 <= sigma_size <= 16:
        raise ValueError(f"detector_kernel: sigma_size from 1 to 16, got {sigma_size}")
    lx, ly, ldet = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    fn = kernels.function("scale_space", "cv_detector",
                          [_VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT, _FLOAT, _FLOAT, _FLOAT, _FLOAT, _FLOAT,
                           _VOID])
    err = fn(x.data_ptr(), lx.data_ptr(), ly.data_ptr(), ldet.data_ptr(), frames, h, w, sigma_size,
             *_scharr_taps(sigma_size), float(sigma_size) ** 4, kernels.current_stream(x.device))
    _launched(err, "cv_detector", detector, frames, h, w)
    return lx, ly, ldet
