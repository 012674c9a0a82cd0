"""A PNG decoder and encoder on the standard library and NumPy.

The machine the port runs on has no imaging library, so the port reads and
writes its images itself.  Supported: 8-bit grayscale (colour type 0) and
8-bit RGB (colour type 2), non-interlaced, with all five row filters (PNG
spec §9).  Anything else raises ``ValueError``.  The encoder chooses each
row's filter as libpng does by default, so its files hold the Average and
Paeth rows that camera files hold.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(ftype: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one scanline's filter; ``row``/``prev`` are uint8 byte rows."""
    if ftype == 0:
        return row
    if ftype == 1:  # Sub: running sum along each byte lane, modulo 256
        lanes = row.reshape(-1, bpp).astype(np.uint32)
        return (np.cumsum(lanes, axis=0) % 256).astype(np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return (row.astype(np.uint16) + prev).astype(np.uint8)
    if ftype not in (3, 4):
        raise ValueError(f"unknown PNG filter type {ftype}")
    # Average and Paeth depend on the byte to the left: a sequential walk.
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if ftype == 3:
            pred = (left + up[i]) >> 1
        else:
            pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def unfilter_plain(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo every scanline's filter: ``rows`` is ``(H, 1 + stride)`` uint8,
    each row its filter type then its bytes; returns ``(H, stride)``."""
    out = np.empty((rows.shape[0], rows.shape[1] - 1), np.uint8)
    prev = np.zeros(out.shape[1], np.uint8)
    for y in range(rows.shape[0]):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    return out


def unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """:func:`unfilter_plain` in compiled code: the walk of
    ``csrc/png_unfilter.cu``, built at first use as the kernels are (a
    failed build raises).  It releases the interpreter lock, so decoding
    threads overlap the caller's Python.  ``unfilter.calls`` counts the
    calls."""
    import ctypes

    from .. import kernels

    fn = kernels.function("png_unfilter", "cv_png_unfilter", [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3)
    rows = np.ascontiguousarray(rows, np.uint8)
    out = np.empty((rows.shape[0], rows.shape[1] - 1), np.uint8)
    bad = fn(rows.ctypes.data, out.ctypes.data, rows.shape[0], out.shape[1], bpp)
    if bad:
        raise ValueError(f"unknown PNG filter type {int(rows[bad - 1, 0])} in row {bad - 1}")
    unfilter.calls += 1
    return out


unfilter.calls = 0


def read_png(path) -> np.ndarray:
    """Decode a PNG file: ``(H, W)`` uint8 for grayscale, ``(H, W, 3)`` for
    RGB."""
    rows, bpp, shape = read_png_rows(path)
    return unfilter_plain(rows, bpp).reshape(shape)


def read_png_rows(path):
    """A PNG file's scanlines still filtered: ``(rows, bpp, shape)``, with
    ``rows`` the ``(H, 1 + stride)`` input of :func:`unfilter_plain` and
    :func:`unfilter` and ``shape`` the decoded image's."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    header = None
    idat = []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {colour}, "
            f"interlace {interlace}); need 8-bit grayscale or RGB, non-interlaced"
        )
    bpp = _CHANNELS[colour]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: image data has {raw.size} bytes, expected "
                         f"{height * (stride + 1)}")
    return raw.reshape(height, stride + 1), bpp, (height, width) if bpp == 1 else (height, width, bpp)


def _filtered(image: np.ndarray, bpp: int) -> np.ndarray:
    """All five filters of every row: ``(5, H, stride)`` uint8 (PNG spec
    §9.2; the encoder's side reads only unfiltered bytes, so each is one
    vectorized pass)."""
    x = image.astype(np.int16)
    a = np.zeros_like(x)  # left
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)  # up
    b[1:] = x[:-1]
    c = np.zeros_like(x)  # up-left
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    return np.stack([((x - pred) & 0xFF).astype(np.uint8) for pred in preds])


def write_png(path, image: np.ndarray, filters=None) -> np.ndarray:
    """Encode ``(H, W)`` uint8 grayscale or ``(H, W, 3)`` uint8 RGB as a
    PNG file; returns the filter type of each row.

    ``filters``: None takes, for each row, the filter whose bytes read as
    signed have the least sum of magnitudes, the first on ties (libpng's
    default heuristic); an int in 0-4 takes that filter on every row; a
    sequence gives each row's.
    """
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got {image.dtype} {image.shape}")
    height, width = image.shape[:2]
    bpp = 1 if image.ndim == 2 else 3
    rows = image.reshape(height, width * bpp)
    cand = _filtered(rows, bpp)
    if filters is None:
        cost = np.minimum(cand, 256 - cand.astype(np.int32)).sum(axis=2)
        filters = cost.argmin(axis=0)
    else:
        filters = np.broadcast_to(np.asarray(filters, np.int64), (height,))
        if filters.min(initial=0) < 0 or filters.max(initial=0) > 4:
            raise ValueError("PNG filter types are 0-4")
    body = np.empty((height, width * bpp + 1), np.uint8)
    body[:, 0] = filters
    body[:, 1:] = cand[filters, np.arange(height)]

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    header = struct.pack(">IIBBBBB", width, height, 8, 0 if bpp == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(body.tobytes()))
                + chunk(b"IEND", b""))
    return np.asarray(filters)
