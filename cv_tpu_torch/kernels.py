"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``cv_tpu_torch/_build/`` (named by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source is rebuilt) and
loaded with ``ctypes``.  :func:`build_all` starts one ``nvcc`` per source
at once.  Nothing is built at import time, and a missing compiler raises:
there is no fallback.  The wrappers take each C function from
:func:`function`, which resolves and types it once, and the stream to
launch on from :func:`current_stream`.

``csrc/png_unfilter.cu`` holds host code only (the PNG decoder's
sequential row filters): ``nvcc`` hands it to its host compiler, and it is
built and loaded like the kernels.

The pose-optimizer loops, the dedup scan, the fused describe, the select
probes, the trig kernel, the Jacobi eigensolver, graph bundle adjustment
and the scale space are built with ``--fmad=false``: no
multiply-add is contracted, so each float expression rounds as it is
written, as the kernels' plain versions round.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Extra nvcc flags per kernel source.
EXTRA_FLAGS = {
    "single_view_l2": ["--fmad=false"],
    "three_view_l2": ["--fmad=false"],
    "three_view_adaptive": ["--fmad=false"],
    "dedup_scan": ["--fmad=false"],
    "select_fused": ["--fmad=false"],
    "select_probes": ["--fmad=false"],
    "trig_probe": ["--fmad=false"],
    "jacobi": ["--fmad=false"],
    "graph_ba": ["--fmad=false"],
    "scale_space": ["--fmad=false"],
}
KERNELS = (
    "select_samples", "select_groups", "select_fused", "dedup_scan",
    "single_view_l2", "three_view_l2", "three_view_adaptive",
    "take_along", "trig_probe", "select_probes", "jacobi", "graph_ba", "scale_space", "png_unfilter",
)

# name -> (ctypes library, build record); filled at first use.
_LOADED: dict = {}
# (name, symbol) -> typed ctypes function; filled at first use.
_FUNCTIONS: dict = {}


def nvcc() -> str:
    """The path of ``nvcc``: on ``PATH``, else under PyTorch's ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str):
    """``(source, flags, library path)`` of ``csrc/<name>.cu``."""
    src = os.path.join(CSRC, f"{name}.cu")
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, [])
    h = hashlib.sha1(" ".join(flags).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return src, flags, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    ``(out, tmp, proc, t0)`` or ``(out, None, None, None)``."""
    src, flags, out = _target(name)
    if os.path.exists(out):
        return out, None, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc(), *flags, "-o", tmp, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, tmp, proc, time.perf_counter()


def _finish(name: str, started) -> dict:
    out, tmp, proc, t0 = started
    if proc is None:
        return {"path": out, "seconds": 0.0, "log": ""}
    log, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return {"path": out, "seconds": seconds, "log": log}


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    Returns a record ``{"path", "seconds", "log"}``; ``seconds`` is 0 and
    ``log`` empty when the library was already built.
    """
    return _finish(name, _start(name))


def build_all(names=KERNELS) -> dict:
    """Build several kernels with one ``nvcc`` each, all started together,
    and load them; returns ``{name: build record}``."""
    todo = [n for n in names if n not in _LOADED]
    started = {n: _start(n) for n in todo}
    for n in todo:
        record = _finish(n, started[n])
        _LOADED[n] = (ctypes.CDLL(record["path"]), record)
    return {n: _LOADED[n][1] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _LOADED:
        record = build(name)
        _LOADED[name] = (ctypes.CDLL(record["path"]), record)
    return _LOADED[name][0]


def build_record(name: str) -> dict:
    """How ``load(name)`` obtained its library (path, build seconds, log)."""
    load(name)
    return _LOADED[name][1]


def function(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``csrc/<name>.cu``'s library, with its
    ``argtypes`` set and an ``int`` result (the launch's ``cudaError_t``).
    Resolved and typed at the first call; later calls return the same
    object."""
    fn = _FUNCTIONS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCTIONS[(name, symbol)] = fn
    return fn


def current_stream(device) -> int:
    """The handle of PyTorch's current stream on the CUDA ``device``, as an
    int: the raw getter where PyTorch has one (no Stream object is built),
    else ``torch.cuda.current_stream``."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream
