"""The experiments' composed runs, on the port.

Ports of the measurement entry points of the JAX experiments scripts that
reach a TPU kernel: each builds its inputs on ``dev`` from an explicit
``torch.Generator`` (or takes the KITTI batch), runs the port's kernels,
and returns times and equality flags as a dict.  ``chip_smoke.py`` calls
them on the card; the defaults are the scripts' own shapes.  Times are
milliseconds: device time (CUDA events) for a kernel, host time ending in a
synchronize for an extract.  Importing this module registers the retired
describe modes (:mod:`.mldb_losers`).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from ..akaze import Akaze, DeviceExtractor
from ..akaze.select import cut_patches, select_samples_patch
from ..ops import trig
from . import mldb_losers, probes

P = 128


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_ms(fn, dev, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` runs: CUDA events on a
    card, the host clock around a synchronize elsewhere."""
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(stop) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def wall_ms(fn, dev, reps: int = 5) -> float:
    """Median host milliseconds of ``fn()``, each run ending in a synchronize."""
    out = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _randint(gen, hi, shape, dev):
    return torch.randint(0, hi, shape, generator=gen, device=dev, dtype=torch.int32)


def epatch_kernel(dev, seed: int = 0, l: int = 96, c: int = 3, hp: int = 512, wp: int = 1408, k: int = 4096,
                  ns: int = 1280, iters: int = 8) -> dict:
    """``exp_r4_epatch.py`` phase ``kernel``: the select with the patch cut
    first (``cut_patches`` + the patch-form select) against
    :func:`mldb_losers.select_samples_epatch` on a random ``(l, c, hp, wp)``
    stack; times of both and whether they are bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    planes = torch.randn((l, c, hp, wp), generator=gen, device=dev)
    lvl = _randint(gen, l, (k,), dev)
    y0 = _randint(gen, hp - P, (k,), dev)
    x0 = _randint(gen, wp - P, (k,), dev)
    rx, ry = _randint(gen, P, (k, ns), dev), _randint(gen, P, (k, ns), dev)

    def cut_plus_pgather():
        return select_samples_patch(cut_patches(planes, lvl, y0, x0), rx, ry)

    def epatch():
        return mldb_losers.select_samples_epatch(planes, lvl, y0, x0, rx, ry)

    equal = bool(torch.equal(cut_plus_pgather(), epatch()))
    return dict(cut_pgather_ms=kernel_ms(cut_plus_pgather, dev, iters), epatch_ms=kernel_ms(epatch, dev, iters),
                equal=equal)


def tiles_kernel(dev, seed: int = 0, l: int = 104, c: int = 3, hp: int = 512, wp: int = 1408, k: int = 4096,
                 ns: int = 441, iters: int = 8, k_check: int = 64) -> dict:
    """The tile selects of ``pallas_mldb_losers.py`` (G=1 and G=8) on
    tile-sorted keypoints of a random stack: times, and whether the two are
    equal and equal to a NumPy select of the first ``k_check`` keypoints."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    planes = torch.randn((l, c, hp, wp), generator=gen, device=dev)
    ht, wt = hp // P, wp // P
    lvl, ty, tx = _randint(gen, l, (k,), dev), _randint(gen, ht - 1, (k,), dev), _randint(gen, wt - 1, (k,), dev)
    perm = torch.argsort((lvl.long() * ht + ty) * wt + tx, stable=True)
    lvl, ty, tx = lvl[perm], ty[perm], tx[perm]
    rx, ry = _randint(gen, 2 * P, (k, ns), dev), _randint(gen, 2 * P, (k, ns), dev)
    args = (planes, lvl, ty, tx, rx, ry)
    g1, g8 = mldb_losers.select_samples_tiles(*args), mldb_losers.select_samples_tiles8(*args)
    ph, lh, th, xh = planes.cpu().numpy(), lvl.cpu().numpy(), ty.cpu().numpy(), tx.cpu().numpy()
    k_check = min(k_check, k)
    rxh, ryh = rx[:k_check].cpu().numpy(), ry[:k_check].cpu().numpy()
    ref = np.stack([ph[lh[i]][:, P * th[i] + ryh[i], P * xh[i] + rxh[i]] for i in range(k_check)])
    return dict(
        tiles_ms=kernel_ms(lambda: mldb_losers.select_samples_tiles(*args), dev, iters),
        tiles8_ms=kernel_ms(lambda: mldb_losers.select_samples_tiles8(*args), dev, iters),
        equal=bool(torch.equal(g1, g8) and np.array_equal(g1[:k_check].cpu().numpy(), ref)),
    )


def extract_modes(images, modes, config, candidate_budget: int, max_features: int, reps: int = 5) -> dict:
    """Each describe mode's extract of ``images``: median ms over ``reps``
    warm runs, keypoint counts, and against the first mode: valid masks,
    words on its valid rows and angles bitwise equal, and the share of equal
    word rows."""
    dev = images.device
    out, base = {}, None
    for mode in modes:
        ex = DeviceExtractor(config, candidate_budget, max_features, device=dev, onehot_mode=mode)
        fs = ex.extract(images).to_numpy()
        rec = dict(ms=wall_ms(lambda: ex.extract(images), dev, reps), counts=fs["valid"].sum(axis=1).tolist())
        if base is None:
            base = fs
        else:
            v = base["valid"]
            rows = (fs["words"][v] == base["words"][v]).all(axis=1)
            rec.update(valid_equal=bool(np.array_equal(fs["valid"], v)), words_equal=bool(rows.all()),
                       angle_equal=bool(np.array_equal(fs["angle"][v], base["angle"][v])),
                       equal_rows=float(rows.mean()) if rows.size else 1.0)
        out[mode] = rec
    return out


def epatch_extract(images, reps: int = 5) -> dict:
    """``exp_r4_epatch.py`` phase ``extract``: ``Akaze.sparse()``, 512
    candidates and 4096 features a frame, ``'pgather'``, ``'pepatch'``
    and ``'pgather+inter'`` (the select kernel on the pixel-interleaved
    stack)."""
    return extract_modes(images, ("pgather", "pepatch", "pgather+inter"), Akaze.sparse(), 512, 4096, reps)


def ptiles_extract(images, reps: int = 5) -> dict:
    """``exp_r4_ptiles.py``: ``Akaze.sparse()``, 256 / 512, ``'pgather'``
    then ``'ptiles'``."""
    return extract_modes(images, ("pgather", "ptiles"), Akaze.sparse(), 256, 512, reps)


def pfused_extract(images, reps: int = 5) -> dict:
    """``exp_r5_pfused.py`` phase ``extract``: ``Akaze.sparse()``, 256 /
    512, ``'pgather'`` then ``'pfused'``."""
    return extract_modes(images, ("pgather", "pfused"), Akaze.sparse(), 256, 512, reps)


# ---------------------------------------------------------------------------
# The probe scripts' runs
# ---------------------------------------------------------------------------


def _window_inputs(dev, seed, n_levels, hmax, wmax, k, ns, align_x=False):
    """``exp_select_kernels.py`` / ``exp_bisect.py`` ``make_inputs`` on the
    device: planes, lvl, y0, x0, rel_y, rel_x."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    planes = torch.randn((n_levels, 3, hmax, wmax), generator=gen, device=dev)
    lvl = _randint(gen, n_levels, (k,), dev)
    y0 = _randint(gen, hmax - probes.PH, (k,), dev)
    x0 = _randint(gen, wmax - probes.PW, (k,), dev)
    if align_x:
        x0 = x0 & ~127
    return planes, lvl, y0, x0, _randint(gen, probes.PH, (k, ns), dev), _randint(gen, probes.PW, (k, ns), dev)


def select_kernels_run(dev, seed: int = 0, k: int = 4096, ns: int = 1280, n_levels: int = 16, hmax: int = 544,
                       wmax: int = 1408, k_check: int = 64) -> dict:
    """``exp_select_kernels.py``: the window select against the script's
    host reference (NumPy, on the first ``k_check`` keypoints)."""
    inputs = _window_inputs(dev, seed, n_levels, hmax, wmax, k, ns)
    got = probes.select_window(*inputs)[:k_check].reshape(k_check, 3, ns).cpu().numpy()
    planes, lvl, y0, x0, rel_y, rel_x = (t.cpu().numpy() for t in inputs)
    ref = np.stack([planes[lvl[i]][:, y0[i] + rel_y[i], x0[i] + rel_x[i]] for i in range(k_check)])
    return dict(ms=kernel_ms(lambda: probes.select_window(*inputs), dev), exact=bool(np.array_equal(got, ref)))


def bisect_run(dev, seed: int = 0, k: int = 512, ns: int = 1280, n_levels: int = 16, hmax: int = 544,
               wmax: int = 1408) -> dict:
    """``exp_bisect.py``: every body, unaligned and 128-aligned ``x0``;
    ``{align_x: {body: ms}}`` and whether every output is finite."""
    out, finite = {}, True
    for align in (False, True):
        inputs = _window_inputs(dev, seed, n_levels, hmax, wmax, k, ns, align_x=align)
        out[align] = {}
        for body, fn in probes.BISECT.items():
            finite &= bool(torch.isfinite(fn(*inputs)).all())
            out[align][body] = kernel_ms(lambda fn=fn: fn(*inputs), dev)
    return dict(ms=out, finite=finite)


def gather_probe_run(dev, seed: int = 0, phases=("lane", "sublane", "select"), k: int = 4096, c: int = 3,
                     ns: int = 512) -> dict:
    """``exp_r3_gather_probe.py``'s ``phases``: the lane and sublane gathers
    of a (128, 512) tile and the patch select, each against the script's
    NumPy reference."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, axis, hi in (("lane", 1, 512), ("sublane", 0, 128)):
        if name not in phases:
            continue
        x = torch.randn((128, 512), generator=gen, device=dev)
        idx = _randint(gen, hi, (128, 512), dev)
        got = probes.take_along(x, idx, axis).cpu().numpy()
        xh, ih = x.cpu().numpy(), idx.cpu().numpy()
        ref = xh[np.arange(128)[:, None], ih] if axis == 1 else xh[ih, np.arange(512)[None, :]]
        out[name] = dict(ms=kernel_ms(lambda x=x, idx=idx, axis=axis: probes.take_along(x, idx, axis), dev),
                         exact=bool(np.array_equal(got, ref)))
    if "select" in phases:
        patches = torch.randn((k, c, P, P), generator=gen, device=dev)
        rx, ry = _randint(gen, P, (k, ns), dev), _randint(gen, P, (k, ns), dev)
        got = select_samples_patch(patches, rx, ry)[:4].cpu().numpy()
        ph, rxh, ryh = patches[:4].cpu().numpy(), rx[:4].cpu().numpy(), ry[:4].cpu().numpy()
        ref = ph[np.arange(4)[:, None, None], np.arange(c)[None, :, None], ryh[:, None, :], rxh[:, None, :]]
        out["select"] = dict(ms=kernel_ms(lambda: select_samples_patch(patches, rx, ry), dev),
                             exact=bool(np.array_equal(got, ref)))
    return out


def mxu_probe_run(dev, seed: int = 0, k: int = 4096, c: int = 3, ns: int = 512) -> dict:
    """``exp_r3_mxu_probe.py``: every body on random patches (``'split'``
    at NS = 128, where its TPU body traces); ``{body: ms}`` and whether
    every output is finite."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    patches = torch.randn((k, c, P, P), generator=gen, device=dev)
    rel = {n: (_randint(gen, P, (k, n), dev), _randint(gen, P, (k, n), dev)) for n in {ns, P}}
    out, finite = {}, True
    for body, fn in probes.MXU.items():
        rx, ry = rel[P if body == "split" else ns]
        finite &= bool(torch.isfinite(fn(rx, ry, patches)).all())
        out[body] = kernel_ms(lambda fn=fn, rx=rx, ry=ry: fn(rx, ry, patches), dev)
    return dict(ms=out, finite=finite)


def trig_run(dev, seed: int = 0) -> dict:
    """``exp_r5_pfused.py`` phase ``trig``: the kernel's atan2, cos, sin and
    floored mod of an (8, 128) uniform(-7, 7) tile against the same
    functions outside the kernel (:mod:`..ops.trig`, the reference's
    functions): per function, bit-equal and the largest difference."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((8, 128), generator=gen, device=dev) * 14.0 - 7.0
    got = probes.trig_probe(x)
    a, b = x[0], x[1]
    ref = (trig.atan2_f32(a, b), trig.cos_f32(a), trig.sin_f32(a),
           torch.remainder(a + probes.TWO_PI, probes.TWO_PI))
    out = {name: dict(bit_equal=bool(torch.equal(got[i], r)), max_diff=float((got[i] - r).abs().max()))
           for i, (name, r) in enumerate(zip(("atan2", "cos", "sin", "mod"), ref))}
    out["ms"] = kernel_ms(lambda: probes.trig_probe(x), dev)
    return out
