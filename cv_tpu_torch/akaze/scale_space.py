"""Nonlinear scale-space construction + detector response.

Port of ``cv_tpu/akaze/scale_space.py`` (reference lib.rs:193-258,
contrast_factor.rs, detector_response.rs).  Evolutions are built in order
(the diffusion chain is sequential) and every op is batched over frames.
The contrast factor's histogram math runs in float64, as the reference's
CPU path does.

Each filter step is one call of ``ops/image.py``'s dispatchers: on the card
``csrc/scale_space.cu`` (one launch for each blur and Scharr pair of
:func:`compute_contrast_factor` and the base blur, each evolution's flow
and each detector response; an evolution's FED cycle in
``ops.fed_block_steps`` steps a launch), on a CPU their plain tensor
chains.  ``half_size``, the histogram and the contrast's ``* 0.75`` stay
tensor ops; nothing reads the card from the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import image as ops
from ..ops import trig
from .config import Akaze, EvolutionSpec


@dataclass(frozen=True)
class EvolutionPlanes:
    """Buffers for one evolution, each ``(B, H_o, W_o)``."""

    spec: EvolutionSpec
    lt: torch.Tensor  # diffused image (descriptor sampling source)
    lsmooth: torch.Tensor  # sigma-1 smoothed (derivative source)
    lx: torch.Tensor  # multiscale d/dx of Lsmooth (orientation/descriptors)
    ly: torch.Tensor  # multiscale d/dy
    ldet: torch.Tensor  # Hessian determinant response


def compute_contrast_factor(
    image: torch.Tensor,
    percentile: float,
    gradient_histogram_scale: float,
    num_bins: int,
) -> torch.Tensor:
    """Per-frame contrast factor k (contrast_factor.rs:16-64).

    The ``percentile`` quantile of the interior gradient-magnitude histogram
    of the blurred image: k = hmax * (first bin whose cumulative count
    reaches the threshold, plus one) / num_bins.  Counts are integers, so
    the histogram walk is exact.
    """
    blur = ops.gaussian_blur_kernel(gradient_histogram_scale)
    g = ops.sep_filter(image, blur, blur)
    main, off = ops.scharr_main_kernel(1), ops.scharr_off_kernel(1)
    lx, ly = ops.sep_filter(g, main, off, off, main)  # scharr_horizontal, scharr_vertical
    mag2 = (lx * lx + ly * ly)[..., 1:-1, 1:-1]
    batch = mag2.shape[:-2]
    m2 = mag2.reshape(-1, mag2.shape[-2] * mag2.shape[-1]).to(torch.float64)

    hmax = trig.sqrt(m2.max(dim=1).values)  # (F,)
    modg = trig.sqrt(m2)
    nonzero = modg != 0.0
    num_points = nonzero.sum(dim=1)
    threshold = torch.floor(num_points.to(torch.float64) * percentile).to(torch.int64)
    safe_hmax = torch.where(hmax == 0, torch.ones_like(hmax), hmax)
    bin_idx = torch.clamp(
        torch.floor(num_bins * (modg / safe_hmax[:, None])).to(torch.int64),
        max=num_bins - 1,
    )
    hist = torch.zeros((m2.shape[0], num_bins), dtype=torch.int64, device=m2.device)
    hist.scatter_add_(1, bin_idx, nonzero.to(torch.int64))
    cum = hist.cumsum(dim=1)
    # Smallest bin j with cumcount(<= j) >= threshold (the last bin if none).
    j = torch.clamp((cum < threshold[:, None]).sum(dim=1), max=num_bins - 1)
    k = torch.where(threshold > 0, j + 1, torch.zeros_like(j))
    result = hmax * k.to(torch.float64) / num_bins
    # Fallback 0.03 when the percentile is never reached (empty image).
    result = torch.where(num_points >= threshold, result, torch.full_like(result, 0.03))
    return result.reshape(batch).to(image.dtype)


def build_scale_space(
    config: Akaze,
    specs: list[EvolutionSpec],
    image: torch.Tensor,
) -> list[EvolutionPlanes]:
    """Build all evolutions and their detector responses for a batch of
    frames ``(B, H, W)`` float32 (lib.rs:193-258 + detector_response.rs)."""
    contrast = compute_contrast_factor(
        image, config.contrast_percentile, 1.0, config.contrast_factor_num_bins
    )

    lts = []
    lsmooths = []
    base = ops.gaussian_blur_kernel(config.base_scale_offset)
    lt = ops.sep_filter(image, base, base)
    lts.append(lt)
    lsmooths.append(lt)  # evolution 0: Lsmooth = Lt (lib.rs:199-201)
    for i in range(1, len(specs)):
        if specs[i].octave > specs[i - 1].octave:
            lt = ops.half_size(lt)
            contrast = contrast * 0.75
        lsmooth, flow = ops.evolution_flow(lt, contrast)
        lt = ops.fed_cycle(lt, flow, specs[i].fed_tau_steps)
        lts.append(lt)
        lsmooths.append(lsmooth)

    # Detector response: multiscale derivatives + Hessian determinant
    # (detector_response.rs:8-57). Lx/Ly are *overwritten* with the
    # multiscale versions, which orientation/descriptors then consume.
    out = []
    for spec, lt_i, lsm_i in zip(specs, lts, lsmooths):
        sigma_size = int(round(spec.esigma * config.derivative_factor / spec.ratio))
        lx, ly, ldet = ops.detector(lsm_i, sigma_size)
        out.append(
            EvolutionPlanes(spec=spec, lt=lt_i, lsmooth=lsm_i, lx=lx, ly=ly, ldet=ldet)
        )
    return out
