"""Video / camera frame sources — the facade's capture module.

Port of ``cv_tpu/video.py``, host NumPy as there; image files are read with
the port's own decoder (:func:`cv_tpu_torch.akaze.extract.load_gray`).  The
reference's ``cv::video`` module re-exports the ``eye`` webcam-capture
crate (cv/src/lib.rs:140-148) so sandbox-style apps can feed live frames
into the engine.  The TPU-native framework keeps the same surface as frame
*sources*: iterables of grayscale uint8 arrays that plug directly into
``VSlam.add_frame`` / ``AkazeExtractor.extract``.

Three sources, all host-side IO (decode never touches the device):

* :class:`ImageSequenceSource` — ordered image files (the vslam-sandbox
  usage pattern: ``main.rs:124-133`` iterates CLI image paths)
* :class:`VideoFileSource` — frames decoded from a video container
  (via ``imageio``/ffmpeg)
* :class:`CameraSource` — live webcam capture (via OpenCV), the direct
  ``eye`` equivalent

Each yields ``(height, width) uint8`` grayscale frames; color sources are
converted with the Rec.601 luma weights the extractor's ``to_gray_f32``
assumes for RGB input.
"""

from __future__ import annotations

import glob as _glob
from pathlib import Path
from typing import Iterator

import numpy as np

__all__ = ["ImageSequenceSource", "VideoFileSource", "CameraSource"]


def _to_gray_u8(frame: np.ndarray) -> np.ndarray:
    """RGB(A)/gray frame -> (H, W) uint8 grayscale (Rec.601 luma).

    Wide integer frames are RESCALED to 8 bits (uint16 >> 8, matching
    ImageSequenceSource's handling of 16-bit PNGs), never clipped — a
    10/16-bit camera would otherwise saturate to white."""
    frame = np.asarray(frame)
    if frame.dtype == np.uint16:
        frame = (frame >> 8).astype(np.uint8)
    elif frame.dtype.kind in "ui" and frame.dtype.itemsize > 2:
        frame = (frame.astype(np.float64) * (255.0 / np.iinfo(frame.dtype).max)).astype(
            np.uint8
        )
    if frame.ndim == 3:
        rgb = frame[..., :3].astype(np.float32)
        frame = rgb @ np.asarray([0.299, 0.587, 0.114], np.float32)
    if frame.dtype != np.uint8:
        frame = np.clip(frame, 0, 255).astype(np.uint8)
    return frame


class ImageSequenceSource:
    """Frames from an ordered list of image files or a glob pattern.

    >>> import os
    >>> from cv_tpu_torch.utils import fixture_path
    >>> src = ImageSequenceSource(os.path.join(os.path.dirname(fixture_path("0000000000.png")), "*.png"))
    >>> frames = list(src)
    >>> len(frames) >= 2 and frames[0].ndim == 2
    True
    """

    def __init__(self, paths):
        if isinstance(paths, (str, Path)):
            paths = sorted(_glob.glob(str(paths)))
        self.paths = [Path(p) for p in paths]

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[np.ndarray]:
        from .akaze.extract import load_gray

        for p in self.paths:
            img = load_gray(p)
            if img.dtype == np.uint16:
                img = (img >> 8).astype(np.uint8)
            yield img


class VideoFileSource:
    """Frames decoded from a video file (mp4/avi/... via imageio+ffmpeg).

    ``step`` subsamples (every Nth frame); ``limit`` caps the count.
    """

    def __init__(self, path, step: int = 1, limit: int | None = None):
        self.path = str(path)
        self.step = int(step)
        self.limit = limit

    def __iter__(self) -> Iterator[np.ndarray]:
        try:
            import imageio.v3 as iio
        except ImportError as e:  # pragma: no cover - environment-dependent
            raise RuntimeError(
                "VideoFileSource needs the 'imageio' package"
            ) from e
        n = 0
        for i, frame in enumerate(iio.imiter(self.path)):
            if i % self.step:
                continue
            yield _to_gray_u8(frame)
            n += 1
            if self.limit is not None and n >= self.limit:
                return


class CameraSource:
    """Live webcam frames via OpenCV — the ``eye`` crate equivalent.

    Iterating yields frames until ``limit`` is reached (or forever when
    ``limit`` is None); use as a context manager to release the device.
    """

    def __init__(self, device: int = 0, limit: int | None = None):
        self.device = device
        self.limit = limit
        self._cap = None

    def open(self):
        try:
            import cv2
        except ImportError as e:  # pragma: no cover - environment-dependent
            raise RuntimeError("CameraSource needs the 'opencv' package") from e
        cap = cv2.VideoCapture(self.device)
        if not cap.isOpened():
            raise RuntimeError(f"cannot open camera device {self.device}")
        self._cap = cap
        return self

    __enter__ = open

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._cap is not None:
            self._cap.release()
            self._cap = None

    def __iter__(self) -> Iterator[np.ndarray]:
        owned = self._cap is None
        if owned:
            self.open()
        try:
            n = 0
            while self.limit is None or n < self.limit:
                ok, frame = self._cap.read()
                if not ok:
                    return
                # OpenCV delivers BGR; flip to RGB before the luma dot.
                yield _to_gray_u8(frame[..., ::-1])
                n += 1
        finally:
            if owned:
                self.close()
