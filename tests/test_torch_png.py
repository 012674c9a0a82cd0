"""The port's standard-library PNG reader: the KITTI fixtures decode bitwise
equal to PIL, and hand-encoded images round-trip through every row filter
in grayscale and RGB."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from cv_tpu.akaze import load_gray as j_load_gray
from cv_tpu_torch.akaze import load_gray
from cv_tpu_torch.utils import fixture_path, read_png
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)


@pytest.mark.parametrize("name", ["0000000000.png", "0000000014.png"])
def test_fixtures_equal_pil(name):
    path = fixture_path(name)
    got = read_png(path)
    ref = np.asarray(Image.open(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape == (512, 1392)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(load_gray(path), j_load_gray(path))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode(img: np.ndarray, filters) -> bytes:
    """A PNG with row ``y`` encoded by filter ``filters[y % len(filters)]``."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * bpp).astype(np.int64)
    raw = bytearray()
    prev = np.zeros(w * bpp, np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = {
            0: np.zeros_like(cur),
            1: left,
            2: prev,
            3: (left + prev) // 2,
            4: np.array([_paeth(a, b, c) for a, b, c in zip(left, prev, upleft)]),
        }[f]
        raw.append(f)
        raw.extend(((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    colour = 0 if bpp == 1 else 2
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(bytes(raw)))
        + chunk(b"IEND", b"")
    )


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]])
@pytest.mark.parametrize("channels", [1, 3])
def test_every_filter_round_trips(tmp_path, filters, channels):
    rng = np.random.default_rng(len(filters) * 10 + channels)
    shape = (13, 17) if channels == 1 else (13, 17, 3)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = tmp_path / "img.png"
    path.write_bytes(_encode(img, filters))
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_rgb_to_gray_like_pil(tmp_path):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    path = tmp_path / "rgb.png"
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(load_gray(path), np.asarray(Image.open(path).convert("L")))


def test_unsupported_png_raises(tmp_path):
    path = tmp_path / "grey16.png"
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, format="PNG")
    path.write_bytes(buf.getvalue())
    with pytest.raises(ValueError):
        read_png(path)
