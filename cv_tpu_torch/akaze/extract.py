"""Image loading and normalization for AKAZE extraction.

Port of ``cv_tpu/akaze/extract.py:240-273`` (``to_gray_f32``,
``load_gray``), reading PNGs with the port's own decoder instead of an
imaging library.  The exact host path (``AkazeExtractor``) is not ported
yet; :class:`cv_tpu_torch.akaze.fast.DeviceExtractor` is the extractor.
"""

from __future__ import annotations

import numpy as np

from ..utils.png import read_png


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
