#!/usr/bin/env python3
"""Build ``csrc/scale_space.cu`` for the host CPU with g++ and hold its four
entries bitwise to their plain versions in ``cv_tpu_torch/ops/image.py``,
where there is no ``nvcc``.

The kernel is built through the host stand-ins of ``scripts/host_cuda.py``
(one ``std::thread`` a CUDA thread, a ``std::barrier`` for
``__syncthreads``, the blocks in turn) and its C entries run on CPU
tensors.  Each entry runs at odd and small shapes (a plane narrower and
shorter than a tile, a single row or column, a KITTI octave's 64x174) on
seeded planes with exact zeros of both signs (a block of -0 at each
corner; the FED cycle also under a conductivity of either sign, whose
zero flows are -0), ``cv_evolution_flow`` at a contrast near 0,
``cv_fed_cycle`` at every count of steps a launch from 1 to 32 (a
33-step cycle, and a 3-step one under larger counts: halos wider than
the plane) at the odd shapes and ``cv_detector`` at every scale from 1
to 16; then ``build_scale_space`` with every step through the host
entries is held plane for plane to its plain run.  What nvcc decides
(registers, spills, the SASS) shows only on the card.

Run from the repository root: ``python3 scripts/host_scale_space.py`` (a
few minutes).
"""

from __future__ import annotations

import ctypes
import os
import sys
import tempfile
import time

import host_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = [(3, 33, 32), (2, 97, 131), (1, 64, 174), (1, 1, 7), (2, 5, 1), (1, 16, 32), (1, 17, 33)]
# The shapes at which cv_fed_cycle runs every count of steps a launch.
ODD = [(1, 1, 7), (2, 5, 1), (1, 17, 33), (1, 64, 174)]
# A 33-step cycle's taus (an octave-3 evolution runs 17-29).
TAUS = tuple(0.25 + 0.37 * i for i in range(33))


def plane(shape, seed):
    """Seeded float32 planes in [-1, 1) with runs of +0 and -0."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    x[rng.uniform(size=shape) < 0.2] = 0.0
    x[rng.uniform(size=shape) < 0.2] = -0.0
    h, w = shape[-2] // 3, shape[-1] // 3
    for rows in (slice(0, h), slice(shape[-2] - h, None)):  # a block of -0 at each corner
        for cols in (slice(0, w), slice(shape[-1] - w, None)):
            x[..., rows, cols] = -0.0
    return x


def bits(t):
    return t.contiguous().view(__import__("torch").int32)


def host_entries(out):
    """The four entries of ``csrc/scale_space.cu`` built for the host in the
    directory ``out``, as functions of CPU tensors with the dispatchers'
    arguments (``fed_cycle`` also with the steps a launch):
    ``{"sep_filter", "evolution_flow", "fed_cycle", "detector"}``."""
    import numpy as np
    import torch

    from cv_tpu_torch.ops import image as ops

    lib = host_cuda.build("scale_space", out)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    taps_t = ctypes.POINTER(ctypes.c_float)
    lib.cv_sep_filter.argtypes = [vp, vp, vp, i, i, i] + [taps_t, i] * 4 + [vp]
    lib.cv_evolution_flow.argtypes = [vp, vp, i, vp, vp, i, i, i, taps_t, i, taps_t, taps_t, i, vp]
    lib.cv_fed_cycle.argtypes = [vp, vp, vp, vp, i, i, i, taps_t, i, i, vp]
    lib.cv_detector.argtypes = [vp, vp, vp, vp, i, i, i, i, f, f, f, f, f, vp]

    def dims(x):
        h, w = x.shape[-2:]
        return x.numel() // (h * w), h, w

    def call(fn, *args):
        err = fn(*args, None)
        if err != 0:
            raise RuntimeError(f"{fn.__name__}: {err}")

    def sep(x, h1, v1, h2=None, v2=None):
        o1 = torch.empty_like(x)
        o2 = torch.empty_like(x) if h2 is not None else None
        t = [ops._taps(k) for k in (h1, v1)] + ([ops._taps(k) for k in (h2, v2)] if h2 is not None else
                                               [(None, 0), (None, 0)])
        call(lib.cv_sep_filter, x.data_ptr(), o1.data_ptr(), o2.data_ptr() if o2 is not None else None, *dims(x),
             *[a for pair in t for a in pair])
        return o1 if o2 is None else (o1, o2)

    def flow(x, k):
        ls, fl = torch.empty_like(x), torch.empty_like(x)
        g, m, o = ops._taps(ops.gaussian_blur_kernel(1.0)), ops._taps(ops.scharr_main_kernel(1)), ops._taps(
            ops.scharr_off_kernel(1))
        call(lib.cv_evolution_flow, x.data_ptr(), k.data_ptr(), 0 if k.numel() == 1 else 1, ls.data_ptr(),
             fl.data_ptr(), *dims(x), *g, m[0], o[0], m[1])
        return ls, fl

    def fed(x, c, taus, k=None):
        taus = tuple(taus)
        if not taus:
            return x
        o, scratch = torch.empty_like(x), torch.empty_like(x)
        k = ops.fed_block_steps(len(taus), *x.shape[-2:]) if k is None else k
        call(lib.cv_fed_cycle, x.data_ptr(), c.data_ptr(), o.data_ptr(), scratch.data_ptr(), *dims(x),
             ops._half_steps(taus), len(taus), k)
        return o

    def det(x, s):
        lx, ly, ld = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
        call(lib.cv_detector, x.data_ptr(), lx.data_ptr(), ly.data_ptr(), ld.data_ptr(), *dims(x), s,
             *ops._scharr_taps(s), float(s) ** 4)
        return lx, ly, ld

    return {"sep_filter": sep, "evolution_flow": flow, "fed_cycle": fed, "detector": det}


def main():
    import numpy as np
    import torch

    from cv_tpu_torch.akaze import Akaze
    from cv_tpu_torch.akaze import scale_space as ss
    from cv_tpu_torch.akaze.config import allocate_evolutions
    from cv_tpu_torch.ops import image as ops

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    entries = host_entries(tempfile.mkdtemp(prefix="host_scale_space-"))
    sep, flow, fed, det = (entries[k] for k in ("sep_filter", "evolution_flow", "fed_cycle", "detector"))
    print(f"built csrc/scale_space.cu for the host in {time.perf_counter() - t0:.1f} s")

    def same(label, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if not torch.equal(bits(g), bits(w)):
                n = int((bits(g) != bits(w)).sum())
                raise SystemExit(f"{label}: {n} of {g.numel()} values differ from the plain version")

    held = 0
    for n, shape in enumerate(SHAPES):
        x = torch.as_tensor(plane(shape, n))
        c = torch.as_tensor(np.abs(plane(shape, 100 + n)))
        g9 = ops.gaussian_blur_kernel(1.6)
        main1, off1 = ops.scharr_main_kernel(1), ops.scharr_off_kernel(1)
        same(f"sep_filter blur {shape}", sep(x, g9, g9), ops.sep_filter_plain(x, g9, g9))
        same(f"sep_filter Scharr pair {shape}", sep(x, main1, off1, off1, main1),
             ops.sep_filter_plain(x, main1, off1, off1, main1))
        frames = shape[0]
        for k in (torch.full((frames,), 0.037, dtype=torch.float32), torch.tensor(1e-19, dtype=torch.float32),
                  torch.tensor([3e-20] * frames, dtype=torch.float32)):
            same(f"evolution_flow {shape} k {k.flatten()[0].item():.3g}", flow(x, k), ops.evolution_flow_plain(x, k))
        for cond in (c, torch.as_tensor(plane(shape, 200 + n))):  # a conductivity, and one of either sign
            for tau in (0.25, 1.7, 3.3):
                same(f"fed_cycle {shape} of one step, tau {tau}", fed(x, cond, (tau,)), ops.fed_step(x, cond, tau))
            want = ops.fed_cycle_plain(x, cond, TAUS)
            for k in range(1, ops.FED_MAX_STEPS + 1) if shape in ODD else (1, 4, 13, 32):
                same(f"fed_cycle {shape}, 33 steps, {k} a launch", fed(x, cond, TAUS, k), want)
            for k in (3, 7, 32):
                same(f"fed_cycle {shape}, 3 steps, {k} a launch", fed(x, cond, TAUS[:3], k),
                     ops.fed_cycle_plain(x, cond, TAUS[:3]))
        for s in range(1, 17):
            same(f"detector {shape} s {s}", det(x, s), ops.detector_plain(x, s))
        held += 1
        print(f"{shape}: every entry bitwise to its plain version")

    # The whole scale space through the host entries, against the plain run.
    cfg = Akaze()
    img = torch.as_tensor(np.random.default_rng(7).uniform(0, 1, (2, 97, 131)).astype(np.float32))
    specs = allocate_evolutions(cfg, 131, 97)
    want = ss.build_scale_space(cfg, specs, img)
    real = {name: getattr(ops, name) for name in ("sep_filter", "evolution_flow", "fed_cycle", "detector")}
    ops.sep_filter, ops.evolution_flow, ops.fed_cycle, ops.detector = sep, flow, fed, det
    try:
        got = ss.build_scale_space(cfg, specs, img)
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    for e, (pg, pw) in enumerate(zip(got, want)):
        for name in ("lt", "lsmooth", "lx", "ly", "ldet"):
            same(f"build_scale_space evolution {e} {name}", getattr(pg, name), getattr(pw, name))
    print(f"build_scale_space (2, 97, 131), {len(specs)} evolutions: every plane bitwise to the plain run; "
          f"{held} shapes held; {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
