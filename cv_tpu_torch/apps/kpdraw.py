"""kpdraw: render AKAZE keypoints as crosses on an image.

Port of ``cv_tpu/apps/kpdraw.py`` (reference ``kpdraw/src/main.rs`` /
``lib.rs``): the exact extractor on the CUDA card (``main(argv,
device=...)`` for another device), the PNG written with the port's own
encoder (:func:`cv_tpu_torch.utils.png.write_png`).

Usage:
    python -m cv_tpu_torch.apps.kpdraw [--threshold T] INPUT OUTPUT
"""

from __future__ import annotations

import argparse

import numpy as np


def render_crosses(image, points, arm: int = 3):
    """Draw magenta crosses at keypoint locations (kpdraw/src/lib.rs:5-13)."""
    if image.ndim == 2:
        canvas = np.repeat(image[:, :, None], 3, axis=2)
    else:
        canvas = image.copy()
    h, w = canvas.shape[:2]
    color = np.array([255, 0, 255], np.uint8)
    for x, y in points:
        xi, yi = int(round(float(x))), int(round(float(y)))
        for d in range(-arm, arm + 1):
            if 0 <= yi < h and 0 <= xi + d < w:
                canvas[yi, xi + d] = color
            if 0 <= yi + d < h and 0 <= xi < w:
                canvas[yi + d, xi] = color
    return canvas


def build_parser():
    p = argparse.ArgumentParser(prog="kpdraw", description="Draw AKAZE keypoints")
    p.add_argument("--threshold", type=float, default=0.001)
    p.add_argument("input")
    p.add_argument("output")
    return p


def main(argv=None, *, device="cuda"):
    """Extract ``INPUT``'s keypoints on ``device`` and write the crosses to
    ``OUTPUT``; returns the keypoints."""
    from ..akaze import Akaze, AkazeExtractor, load_gray
    from ..utils.png import write_png

    opt = build_parser().parse_args(argv)
    image = load_gray(opt.input)
    kp, _ = AkazeExtractor(Akaze.new(opt.threshold), device=device).extract(image)
    print(f"extracted {len(kp['response'])} keypoints")
    write_png(opt.output, render_crosses(image, kp["point"]))
    print(f"wrote {opt.output}")
    return kp


if __name__ == "__main__":
    main()
