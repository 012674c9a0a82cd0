"""A prefetching image loader: the counterpart of
``cv_tpu/utils/native_loader.py::PrefetchLoader``.

A pool of threads decodes the next images while the caller works on the
current one, with the port's :func:`cv_tpu_torch.akaze.extract.load_gray`.
With ``compiled`` the row filters run in compiled code instead
(:func:`cv_tpu_torch.utils.png.unfilter`, built with ``nvcc``'s host
compiler), which releases the interpreter lock, so the decoding overlaps
the caller's Python; the plain walk holds the lock.  This is the one
place that chooses: the plain walk is the reference, and machines without
``nvcc`` run it.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor


def load_gray_compiled(path):
    """:func:`cv_tpu_torch.akaze.extract.load_gray` with the compiled
    unfilter."""
    from ..akaze.extract import to_gray_u8
    from . import png

    rows, bpp, shape = png.read_png_rows(path)
    return to_gray_u8(png.unfilter(rows, bpp).reshape(shape))


class PrefetchLoader:
    """Decode ``paths`` on ``threads`` workers ahead of the caller::

        with PrefetchLoader(paths, threads=4) as loader:
            for i in range(len(paths)):
                image = loader.get(i)   # blocks only if not yet decoded

    At most ``2 * threads`` images are decoded ahead of the last one asked
    for; an image asked for again is decoded again.
    """

    def __init__(self, paths, threads: int = 4, compiled: bool = False):
        from ..akaze.extract import load_gray

        self.paths = [str(p) for p in paths]
        self.decode = load_gray_compiled if compiled else load_gray
        self.ahead = 2 * threads
        self._pool = ThreadPoolExecutor(max_workers=threads)
        self._futures: dict = {}
        self._submitted = 0

    def __len__(self):
        return len(self.paths)

    def _submit_until(self, end: int):
        while self._submitted < min(end, len(self.paths)):
            i = self._submitted
            self._futures[i] = self._pool.submit(self.decode, self.paths[i])
            self._submitted += 1

    def get(self, index: int):
        """The ``(H, W)`` uint8 image ``paths[index]``; queues the next
        ones."""
        if not 0 <= index < len(self.paths):
            raise IndexError(index)
        self._submit_until(index + 1 + self.ahead)
        future = self._futures.pop(index, None)
        if future is None:
            return self.decode(self.paths[index])
        return future.result()

    def close(self):
        for future in self._futures.values():
            future.cancel()
        self._futures.clear()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
