"""Catmull-Rom bicubic color sampling for keypoints.

Re-design of ``cv-sfm/src/bicubic.rs`` (vendored imageproc
code), vectorized over all keypoints at once.  Carried over unchanged
from ``cv_tpu/sfm/bicubic.py`` (pure NumPy).  Out-of-bounds samples return
the default color (0, 0, 0), matching the reference.
"""

from __future__ import annotations

import numpy as np


def _blend(p0, p1, p2, p3, x):
    """Catmull-Rom blend (bicubic.rs:13-30); x has shape (..., 1)."""
    return p1 + 0.5 * x * (
        p2 - p0 + x * (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3 + x * (3.0 * (p1 - p2) + p3 - p0))
    )


def bicubic_colors(image: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Sample colors at subpixel keypoint locations.

    ``image``: (H, W) grayscale or (H, W, 3) RGB uint8;
    ``points``: (N, 2) float (x, y) pixel coordinates.
    Returns (N, 3) uint8.
    """
    if image.ndim == 2:
        img = np.repeat(image[:, :, None], 3, axis=2).astype(np.float32)
    else:
        img = image.astype(np.float32)
    h, w = img.shape[:2]
    x = points[:, 0].astype(np.float32)
    y = points[:, 1].astype(np.float32)
    left = np.floor(x) - 1.0
    top = np.floor(y) - 1.0
    valid = (left >= 0) & (left + 4 < w) & (top >= 0) & (top + 4 < h)
    li = np.clip(left.astype(np.int64), 0, w - 4)
    ti = np.clip(top.astype(np.int64), 0, h - 4)
    xw = (x - (left + 1.0))[:, None]
    yw = (y - (top + 1.0))[:, None]

    rows = []
    for r in range(4):
        p = [img[ti + r, li + c] for c in range(4)]
        rows.append(_blend(p[0], p[1], p[2], p[3], xw))
    out = _blend(rows[0], rows[1], rows[2], rows[3], yw)
    out = np.clip(out, 0.0, 255.0)
    out[~valid] = 0.0
    return out.astype(np.uint8)
