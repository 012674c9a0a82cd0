"""End-to-end AKAZE feature extraction, the exact path.

Port of ``cv_tpu/akaze/extract.py`` (reference ``Akaze::extract``,
akaze/src/lib.rs:295-339):

    scale space -> detector response -> extrema -> dedup -> subpixel +
    orientation -> sort by response desc -> truncate -> descriptors

:class:`AkazeExtractor` runs every stage on its device.  The candidates
come out evolution-major and row-major, as the reference iterates them, and
the sequential dedup runs over all of them through
:func:`.extrema.dedup_scan_device` (the hand-written scan on the card), whose
slot output gives the survivors in the cache order of the host dedup
(:func:`.extrema.dedup_keypoints_exact`).  The host sees the candidate count
and, at the end, the keypoints.

Keypoints are returned as a dict of arrays (structure-of-arrays form of the
reference's ``Vec<KeyPoint>``), descriptors as ``(N, 16) uint32`` bit-packed
486-bit M-LDB words.  The module also holds the image normalization
(``to_gray_f32``) and ``load_gray``, which reads PNGs with the port's own
decoder instead of an imaging library.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.png import read_png
from . import descriptors as desc
from . import extrema
from .config import Akaze, allocate_evolutions
from .fast import _octave_groups
from .scale_space import build_scale_space

DESCRIPTOR_WORDS = 16
DESCRIPTOR_BITS = 486


@lru_cache(maxsize=None)
def _evolution_tables(specs: tuple, derivative_factor: float, device) -> dict:
    """Per-evolution tables of the dedup and the refinement, as the host
    dedup computes them (extrema.py:105-110): plane offsets in the flat
    candidate axis, widths, heights, the octave ratio and shift, the dedup
    radius ``size = f32(esigma * derivative_factor)`` (the product in f64)
    and its square, the border reach ``SMAX * round(size / ratio)`` and the
    sampling scale ``round(size / ratio)`` (half to even, as ``np.round``)."""
    ratio = np.array([np.float32(2.0) ** np.float32(s.octave) for s in specs], np.float32)
    size = np.array([np.float32(s.esigma * derivative_factor) for s in specs], np.float32)
    sigma_size = np.round(size / ratio).astype(np.float32)
    counts = [s.height * s.width for s in specs]
    host = dict(
        base=np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64),
        width=np.array([s.width for s in specs], np.int64),
        height=np.array([s.height for s in specs], np.int64),
        ratio=ratio,
        off=(np.float32(0.5) * (ratio - np.float32(1.0))).astype(np.float32),
        size=size,
        size2=(size * size).astype(np.float32),
        reach=(extrema.SMAX * sigma_size).astype(np.float32),
        ssamp=sigma_size,
        octave=np.array([s.octave for s in specs], np.int64),
        class_id=np.array([s.index for s in specs], np.int64),
    )
    return {k: torch.as_tensor(v, device=device) for k, v in host.items()}


class AkazeExtractor:
    """The exact extractor on ``device`` (the CUDA card unless the caller
    asks for the CPU); ``extract(image) -> (keypoints dict, words)``."""

    def __init__(self, config: Akaze | None = None, device="cuda"):
        self.config = config or Akaze()
        self.device = torch.device(device)
        self._specs_cache: dict[tuple[int, int], list] = {}

    def specs(self, height: int, width: int):
        key = (height, width)
        if key not in self._specs_cache:
            self._specs_cache[key] = allocate_evolutions(self.config, width, height)
        return self._specs_cache[key]

    def candidates(self, specs, planes) -> dict:
        """Every candidate of the frame, evolution-major and row-major, as
        the dedup's inputs: ``(C,)`` tensors ``e`` (evolution), ``x``,
        ``y``, ``resp``, ``px_cmp``/``py_cmp`` (``x * ratio``),
        ``px_store``/``py_store`` (``x * ratio + 0.5 * (ratio - 1)``),
        ``size2`` and ``valid`` (the border test of extrema.py:135-139
        folded in: a border candidate neither inserts nor replaces).  One
        host read, the count."""
        cfg = self.config
        t = _evolution_tables(tuple(specs), cfg.derivative_factor, self.device)
        masks = []
        for _, idxs in _octave_groups(planes):
            stacked = torch.stack([planes[i].ldet[0] for i in idxs])
            masks.extend(extrema.candidate_mask(stacked, cfg.detector_threshold).reshape(len(idxs), -1))
        idx = torch.nonzero(torch.cat(masks))[:, 0]
        resp = torch.cat([p.ldet[0].reshape(-1) for p in planes])[idx]
        e = torch.searchsorted(t["base"], idx, right=True) - 1
        local = idx - t["base"][e]
        width, height = t["width"][e], t["height"][e]
        y = local // width
        x = local - y * width
        xf, yf = x.to(torch.float32), y.to(torch.float32)
        ratio, off, reach = t["ratio"][e], t["off"][e], t["reach"][e]
        valid = (
            (torch.round(xf - reach) - 1.0 >= 0)
            & (torch.round(xf + reach) + 1.0 < width)
            & (torch.round(yf - reach) - 1.0 >= 0)
            & (torch.round(yf + reach) + 1.0 < height)
        )
        return dict(e=e, x=x, y=y, resp=resp, px_cmp=xf * ratio, py_cmp=yf * ratio, px_store=xf * ratio + off,
                    py_store=yf * ratio + off, size2=t["size2"][e], valid=valid)

    def dedup(self, cand: dict):
        """The sequential dedup over every candidate (no cap): ``(order,
        alive)``, the candidates' indices in cache-slot order and which of
        them survive (the survivors first)."""
        row = lambda name: cand[name][None]  # noqa: E731
        _, slots = extrema.dedup_scan_device(
            row("px_cmp"), row("py_cmp"), row("px_store"), row("py_store"), row("resp"),
            cand["e"][None].to(torch.int32), row("size2"), row("valid"), with_slots=True,
        )
        slots = slots[0].long()
        alive = slots >= 0
        order = torch.argsort(torch.where(alive, slots, slots.shape[0]), stable=True)
        return order, alive[order]

    @torch.no_grad()
    def extract(self, image: np.ndarray):
        """Extract keypoints + descriptors from one grayscale image.

        ``image``: (H, W) uint8/uint16/float. Returns ``(keypoints, words)``
        where keypoints is a dict of arrays and words is (N, 16) uint32.
        """
        cfg = self.config
        img = torch.as_tensor(to_gray_f32(image), device=self.device)
        h, w = img.shape
        specs = self.specs(h, w)
        if not specs:
            return _empty_keypoints(), np.zeros((0, DESCRIPTOR_WORDS), np.uint32)
        planes = build_scale_space(cfg, specs, img[None])
        cand = self.candidates(specs, planes)
        if cand["e"].shape[0] == 0:
            return _empty_keypoints(), np.zeros((0, DESCRIPTOR_WORDS), np.uint32)
        order, alive = self.dedup(cand)
        t = _evolution_tables(tuple(specs), cfg.derivative_factor, self.device)
        e, x, y, resp = (cand[k][order] for k in ("e", "x", "y", "resp"))
        groups = []  # (ratio, first evolution, last + 1, stacked planes) of each octave
        for _, idxs in _octave_groups(planes):
            stack = {name: torch.stack([getattr(planes[i], name)[0] for i in idxs])
                     for name in ("lt", "lx", "ly", "ldet")}
            groups.append((float(2.0 ** planes[idxs[0]].spec.octave), idxs[0], idxs[-1] + 1, stack))

        # Sub-pixel refinement, per octave group (lib.rs:318-323); entries
        # of other groups take clamped coordinates and are not kept.
        point = torch.zeros((e.shape[0], 2), dtype=torch.float32, device=self.device)
        ok = torch.zeros_like(alive)
        for p, first, last, stack in groups:
            in_g = (e >= first) & (e < last)
            hg, wg = stack["ldet"].shape[-2:]
            ixy = torch.stack([torch.clamp(e - first, 0, last - first - 1), torch.clamp(x, 1, wg - 2),
                               torch.clamp(y, 1, hg - 2)], dim=1)
            delta, ok_g = extrema.subpixel_refine_batch(stack["ldet"], ixy, in_g)
            pg = torch.stack([(ixy[:, 1].to(torch.float32) + delta[:, 0]) * p + 0.5 * (p - 1.0),
                              (ixy[:, 2].to(torch.float32) + delta[:, 1]) * p + 0.5 * (p - 1.0)], dim=-1)
            point = torch.where(in_g[:, None], pg, point)
            ok |= ok_g
        ok &= alive

        # Sort by response descending, truncate (lib.rs:326-327); equal
        # responses keep the cache order.
        key = torch.where(ok, -resp, torch.inf)
        top = torch.argsort(key, stable=True)[: cfg.maximum_features]
        e, point, resp, keep = e[top], point[top], resp[top], ok[top]

        # Orientation, then M-LDB descriptors, per octave group; an
        # out-of-bounds sample drops the keypoint.
        n = e.shape[0]
        ssamp = t["ssamp"][e]
        res_x = torch.zeros((n, 109), dtype=torch.float32, device=self.device)
        res_y = torch.zeros_like(res_x)
        for p, first, last, stack in groups:
            in_g = ((e >= first) & (e < last))[:, None]
            sub = torch.clamp(e - first, 0, last - first - 1)
            rx, ry = desc.orientation_samples(stack["lx"], stack["ly"], sub, point[:, 0] / p, point[:, 1] / p, ssamp)
            res_x, res_y = torch.where(in_g, rx, res_x), torch.where(in_g, ry, res_y)
        angle = desc._orientation_from_samples(res_x, res_y)
        n_unique = desc.mldb_unique_tables(cfg.descriptor_pattern_size)[0].shape[0]
        samples = torch.zeros((3, n, n_unique), dtype=torch.float32, device=self.device)
        desc_ok = torch.zeros_like(keep)
        for p, first, last, stack in groups:
            in_g = (e >= first) & (e < last)
            sub = torch.clamp(e - first, 0, last - first - 1)
            ri, rx, ry, ok_g, co, si = desc.mldb_samples(stack["lt"], stack["lx"], stack["ly"], sub, point[:, 0] / p,
                                                         point[:, 1] / p, ssamp, angle, cfg.descriptor_pattern_size)
            samples = torch.where(in_g[None, :, None], torch.stack([ri, rx, ry]), samples)
            desc_ok |= ok_g & in_g
        # co / si are cos / sin of the angle, the same in every group.
        words = desc._mldb_pack(samples[0], samples[1], samples[2], co, si, cfg.descriptor_pattern_size)
        keep &= desc_ok

        host = {k: v.cpu().numpy() for k, v in dict(
            keep=keep, point=point, angle=angle, response=resp, size=t["size"][e] * 2.0, octave=t["octave"][e],
            class_id=t["class_id"][e], words=words).items()}
        keep = host.pop("keep")
        words = host.pop("words")[keep].view(np.uint32)
        return {k: v[keep] for k, v in host.items()}, words


def to_gray_f32(image: np.ndarray) -> np.ndarray:
    """Pixel-value normalization matching ``GrayFloatImage::from_dynamic``
    (image.rs:45-109): u8 -> /255, u16 -> /65535, float passthrough."""
    if image.ndim == 3:
        # Rec.709 luma, as the image crate's grayscale() uses.
        image = (
            0.2126 * image[..., 0] + 0.7152 * image[..., 1] + 0.0722 * image[..., 2]
        ).astype(image.dtype)
    if image.dtype == np.uint8:
        return (image.astype(np.float32)) / np.float32(255.0)
    if image.dtype == np.uint16:
        return (image.astype(np.float32)) / np.float32(65535.0)
    return image.astype(np.float32)


def _empty_keypoints():
    return {
        "point": np.zeros((0, 2), np.float32),
        "angle": np.zeros(0, np.float32),
        "response": np.zeros(0, np.float32),
        "size": np.zeros(0, np.float32),
        "octave": np.zeros(0, np.int64),
        "class_id": np.zeros(0, np.int64),
    }


def load_gray(path) -> np.ndarray:
    """Load a PNG file as a grayscale uint8 array (:func:`to_gray_u8`)."""
    return to_gray_u8(read_png(path))


def to_gray_u8(image: np.ndarray) -> np.ndarray:
    """A decoded uint8 image as grayscale: RGB is reduced with the ITU-R
    601 integer luma that the reference loader's ``convert("L")`` applies."""
    if image.ndim == 3:
        rgb = image.astype(np.uint32)
        image = (
            (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16
        ).astype(np.uint8)
    return image
