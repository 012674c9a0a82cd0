#!/usr/bin/env python3
"""The dedup scan, the sample select, the group select, the fused
describe and the trig kernel at the engine's own calls, the window sums,
the one-hot column sums and the row select of ``exp_bisect.py`` and the
one-hot row sums and the split select of ``exp_r3_mxu_probe.py`` at those
scripts' shapes, for several builds of each, on one CUDA card.

Builds, with each source's own flags (one nvcc per build, all started
together), into the git-ignored ``cv_tpu_torch/_build/variants/``:

* with ``--variants KERNEL:NAME=VALUE[,NAME=VALUE...] ...``, copies of
  KERNEL's source (``csrc/KERNEL.cu``; ``csrc/select_probes.cu`` for
  ``window_sums``, ``vpu_rowstage``, ``mxu_probes`` and ``mxu_split``;
  ``csrc/trig_probe.cu`` for ``trig``) with each line ``constexpr int NAME = ...;`` named set to its VALUE (a
  block size, samples a thread);
* with ``--ablations``, copies of a kernel's source with one design point
  taken out (``ABLATIONS``);
* with ``--parent DIR`` (the root of another checkout, e.g. the parent
  commit unpacked with ``git archive``), that tree's sources of the timed
  kernels (of those whose C functions its source defines).

Then records the calls of chip_smoke.py's paths where the extractor binds
the wrappers: the KITTI extract (B=8: two select calls, one dedup call),
the SfM warm pass (12 frames: 24 select calls, 12 dedup calls), the dense
extract (B=2: two group-select calls, one dedup call), the same pair in
describe mode ``'pfused'`` (one fused-describe call) and
``FastAkazeExtractor`` at 8192 features on frame 0 (path ``engine``: two
group-select calls; its dedup call counts to ``dense``).  The trig kernel's
calls (``ops.trig.angle_cv`` and ``cos_sin``, where the describe binds
them) are those of the KITTI, SfM, dense and engine runs and of the exact
extractor on the KITTI pair at ``Akaze()`` (path ``exact``).  For
``select_probes`` (the two column-sum kernels of ``csrc/select_probes.cu``)
the calls are ``exp_bisect.py``'s: K=512, NS=1280 on its (16, 3, 544, 1408)
stack, x0 unaligned and 128-aligned, one path a body and alignment, and a
path a body of 16 windows that leave the stack or whose rows and columns
leave the window (their NaN outputs compared by their bits).  For
``window_sums`` (the two window-sum kernels of the same source) and
``vpu_rowstage`` (the row select) they are the same calls of their
bodies.  For ``mxu_probes`` (the two row-sum kernels of the same source)
they are ``exp_r3_mxu_probe.py``'s: K=4096 patches of 3x128x128, NS=512,
one path a body, and a path a body of 16 keypoints whose leader rows leave
the patch at a few samples (``chip_smoke.row_sums_leaving``); for
``mxu_split`` (the split select) K=4096 at NS=128, where its TPU body
traces, and 16 keypoints with infs and NaNs in columns 0 and 1
(``chip_smoke.split_nonfinite``).  For each kernel
of ``--kernels`` the builds take turns behind the wrapper (its C function
swapped), in the order of the builds and then reversed, so that with a
parent the order is parent, this tree, ..., this tree, parent; each turn
holds every recorded call bitwise to this tree's build in the checkout
(itself held bitwise to the plain version for the group select, the
fused describe, the row select and the split select, to
``probes.bisect_window_ordered`` for the window sums, to
``probes.bisect_matmul_ordered`` for the column sums and to
``probes.mxu_rows_ordered`` for the row sums, and to ``ops/trig.py`` for
the trig kernel, a NaN by position) and sums the calls' device times (a
CUDA graph each) per path.  The ``trig-libdevice`` ablation (the card's
own atan2f, cosf and sinf) is not held: its outputs that differ from this
tree's build are counted, with the largest distance in ulps.  A build's
time is the mean of its two turns.  For the group select and the
fused describe each path also gets its byte bound at 4 bytes a
sample and at 32 bytes a distinct plane sector that the recorded offsets
touch (``chip_smoke.describe_call_bounds``); the window and column sums
get the byte bound of ``chip_smoke.bisect_work`` (the distinct bytes the
recorded windows cover, ``chip_smoke.bisect_windows_read``; for the row
select the distinct 32-byte sectors its samples name,
``chip_smoke.rowstage_sectors_read``), the row sums and the split select
that of ``chip_smoke.mxu_work`` (the split at 32 bytes a row read); the
row select and the split select also their bound at 4 bytes a float
named (the same counts with ``sectors=False``); the trig kernel the larger
of its bytes' and its operations' bounds (``chip_smoke.TRIG_OPS``).

Prints one line per build and path, and last one JSON object with every
number.
Usage: python3 scripts/time_engine_calls.py [--kernels select_groups select_fused]
       [--variants select_groups:kPer=2 dedup_scan:kThreads=256] [--ablations upper-all] [--parent _parent]
       python3 scripts/time_engine_calls.py --kernels select_probes --ablations tma-off --parent _parent
       python3 scripts/time_engine_calls.py --kernels mxu_probes --ablations mask-off --parent _parent
       python3 scripts/time_engine_calls.py --kernels window_sums --parent _parent
           [--variants window_sums:kWindowRowsInFlight=4 window_sums:kWindowRowsInFlight=34]
       python3 scripts/time_engine_calls.py --kernels vpu_rowstage mxu_split --parent _parent
           [--variants vpu_rowstage:kRowstageThreads=160,kRowstageQuads=2 mxu_split:kSplitThreads=128]
           [--ablations split-64b split-128b split-512b]
       python3 scripts/time_engine_calls.py --kernels trig --ablations trig-libdevice
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys

# Kernel -> the C functions a build of it swaps in.
SYMBOLS = {"dedup_scan": ("cv_dedup_scan",), "select_samples": ("cv_select_samples",),
           "select_groups": ("cv_select_groups",), "select_fused": ("cv_select_fused",),
           "select_probes": ("cv_bisect_matmul_static", "cv_bisect_matmul_dyn_oh"),
           "window_sums": ("cv_bisect_dma_only", "cv_bisect_split_nomm"),
           "vpu_rowstage": ("cv_bisect_vpu_rowstage",),
           "mxu_probes": ("cv_mxu_dots", "cv_mxu_dotsbig"), "mxu_split": ("cv_mxu_split",),
           "trig": ("cv_trig_angle", "cv_trig_cos_sin")}
# Kernel -> its source in csrc/, where the two differ.
SOURCES = {"window_sums": "select_probes", "vpu_rowstage": "select_probes", "mxu_probes": "select_probes",
           "mxu_split": "select_probes", "trig": "trig_probe"}
# The kernels held bitwise (NaN by its bits) to an order mirror or their
# plain version, with byte bounds per call from chip_smoke.py.
PROBES = ("select_probes", "window_sums", "vpu_rowstage", "mxu_probes", "mxu_split")
# The builds that are measured against this tree's, not held to it.
APPROXIMATE = ("trig-libdevice",)
DEFAULT_KERNELS = ("dedup_scan", "select_samples", "select_groups", "select_fused")
# The split select's loads: a float2 of each channel's row.
SPLIT_LOAD = "for (int c = 0; c < kSplitChannels; ++c) v[c] = __ldg(reinterpret_cast<const float2*>(row + c * plane));"


def split_extra_loads(n):
    """``SPLIT_LOAD`` followed by loads of the next ``n`` 32-byte sectors of
    each row, dropped: volatile loads, which ptxas keeps (it removes a plain
    load whose value goes unused)."""
    return (SPLIT_LOAD + f"\n#pragma unroll\n  for (int e = 1; e <= {n}; ++e) {{\n#pragma unroll\n"
            "    for (int c = 0; c < kSplitChannels; ++c) {\n      float a, b, d, f;\n"
            '      if (8 * (e + 1) <= p) asm volatile("ld.volatile.global.v4.f32 {%0, %1, %2, %3}, [%4];" '
            ': "=f"(a), "=f"(b), "=f"(d), "=f"(f) : "l"(row + c * plane + 8 * e));\n    }\n  }')


# Design points taken out one at a time, each by replacing one line of a
# kernel's source: the scan's upper-scale class ranges (every slot walks
# every later slot); the column sums' TMA staging (each thread loads its
# column of a chunk with plain coalesced loads into the same resident
# window); the row sums' row marks (every row of a patch staged and summed).
# And the split select at 64, 128 and 512 bytes read a row: whether its time
# follows the bytes or the rows.  And the trig kernel on libdevice's atan2f,
# cosf and sinf.
ABLATIONS = {
    "upper-all": ("dedup_scan", re.escape("if (up >= 0 && up < kClassTable) {"), "if (false) {"),
    "tma-off": ("select_probes", re.escape("constexpr int kTmaStaging = 1;"), "constexpr int kTmaStaging = 0;"),
    "mask-off": ("mxu_probes", re.escape("constexpr int kRowMask = 1;"), "constexpr int kRowMask = 0;"),
    **{f"split-{32 * (n + 1)}b": ("mxu_split", re.escape(SPLIT_LOAD), split_extra_loads(n)) for n in (1, 3, 15)},
    "trig-libdevice": ("trig", re.escape('#include "trig.cuh"'), '#define TRIG_LIBDEVICE\n#include "trig.cuh"'),
}


def edited(name, *edits):
    """The text of kernel ``name``'s source with, for each ``(pattern,
    new)`` of ``edits``, the one line matching ``pattern`` replaced by
    ``new``."""
    from cv_tpu_torch import kernels

    source = SOURCES.get(name, name)
    with open(os.path.join(kernels.CSRC, f"{source}.cu")) as f:
        text = f.read()
    for pattern, new in edits:
        text, n = re.subn(pattern, new, text)
        if n != 1:
            raise RuntimeError(f"csrc/{source}.cu does not hold a line {pattern!r} once")
    return text


def variant_jobs(variants, ablations):
    """``[(kernel, label, source text)]``: each ``KERNEL:NAME=VALUE[,NAME=
    VALUE...]`` of ``variants`` and each ablation."""
    jobs = []
    for spec in variants:
        name, _, settings = spec.partition(":")
        edits = []
        for setting in settings.split(","):
            const, _, value = setting.partition("=")
            if name not in SYMBOLS or not const or not value.isdigit():
                raise SystemExit(f"time_engine_calls: a variant is KERNEL:NAME=VALUE[,NAME=VALUE...], got {spec!r}")
            edits.append((rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};"))
        jobs.append((name, settings, edited(name, *edits)))
    jobs += [(ABLATIONS[label][0], label, edited(ABLATIONS[label][0], ABLATIONS[label][1:])) for label in ablations]
    return jobs


def build_variants(jobs, parent, names):
    """``{kernel: {label: ctypes library}}`` for the edited sources of
    ``jobs`` and, when ``parent`` is given, that tree's sources of
    ``names``; every build started at once."""
    from cv_tpu_torch import kernels

    out_dir = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    todo = []
    for name, label, text in jobs:
        src = os.path.join(out_dir, f"{name}-{re.sub(r'[^A-Za-z0-9]', '_', label)}.cu")
        with open(src, "w") as f:
            f.write(text)
        todo.append((name, label, src, kernels.CSRC))
    if parent:
        csrc = os.path.join(parent, "cv_tpu_torch", "csrc")
        for name in names:
            src = os.path.join(csrc, f"{SOURCES.get(name, name)}.cu")
            with open(src) as f:
                text = f.read()
            if all(sym in text for sym in SYMBOLS[name]):
                todo.append((name, "parent", src, csrc))
    procs = []
    for name, label, src, include in todo:
        lib = os.path.join(out_dir, f"lib{name}-{re.sub(r'[^A-Za-z0-9]', '_', label)}.so")
        flags = kernels.EXTRA_FLAGS.get(SOURCES.get(name, name), [])
        cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, *flags, "-I", include, "-o", lib, src]
        procs.append((name, label, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                         text=True)))
    libs = {name: {} for name in SYMBOLS}
    for name, label, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({label}):\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        print(f"build {name} ({label}): {'; '.join(regs)}")
        libs[name][label] = ctypes.CDLL(lib)
    return libs


def group_footprints(args, kw):
    """The live slots' footprints of one recorded ``select_groups`` call,
    as a staging design would see them: per slot the box of rows by
    16-byte-aligned columns that holds its samples.  Returns ``(slots,
    median floats a channel, slots whose box fits 1,536 floats (a warp's
    6 KB of a 48 KB block), slots whose box has fewer 32-byte sectors than
    the slot has samples)``."""
    import torch

    _, win_lvl, win_ty, win_tx, n_active, rel_x, rel_y = args[:7]
    ng, ns = win_lvl.shape[0], rel_x.shape[-1]
    live = torch.arange(8, device=rel_x.device).repeat(ng) < n_active.long().repeat_interleave(8)
    rx, ry = (t.reshape(ng * 8, ns)[live].long() for t in (rel_x, rel_y))
    xb = 128 * win_tx.long().repeat_interleave(8)[live]
    x_lo, x_hi = (xb + rx.min(dim=1).values) // 4, (xb + rx.max(dim=1).values) // 4
    box = (ry.max(dim=1).values - ry.min(dim=1).values + 1) * (x_hi - x_lo + 1) * 4
    if box.numel() == 0:
        return 0, 0, 0, 0
    return (box.numel(), int(box.median()), int((box <= 1536).sum()), int((box < 8 * ns).sum()))


def probe_calls(dev, bodies, seed=0):
    """``{path: [(args, {})]}``, ``args`` the body and its inputs: the
    ``exp_bisect.py`` bodies of ``bodies`` (the column sums, the window
    sums or the row select) at that script's shapes, per body x0 unaligned
    and 128-aligned (its ``make_inputs(align_x=...)``), and
    ``chip_smoke.bisect_leaving``'s 16 keypoints: windows that leave the
    stack, columns and rows that leave the window."""
    import chip_smoke as cs
    from cv_tpu_torch.experiments import runs

    calls = {}
    for align in (False, True):
        inputs = runs._window_inputs(dev, seed, 16, 544, 1408, 512, 1280, align_x=align)
        for body in bodies:
            calls[f"{body} x0 {'aligned' if align else 'unaligned'}"] = [((body, *inputs), {})]
    leaving = cs.bisect_leaving(*inputs)
    for body in bodies:
        calls[f"{body} leaving"] = [((body, *leaving), {})]
    return calls


def mxu_calls(dev, bodies, seed=0):
    """``{path: [(args, {})]}``, ``args`` the body and its inputs: each row
    sum of ``bodies`` at ``exp_r3_mxu_probe.py``'s shapes (K=4096, NS=512)
    and on ``chip_smoke.row_sums_leaving``'s 16 keypoints; the split select
    at K=4096, NS=128 and on ``chip_smoke.split_nonfinite``'s 16."""
    import torch

    import chip_smoke as cs
    from cv_tpu_torch.experiments import probes, runs

    gen = torch.Generator(device=dev).manual_seed(seed)
    patches = torch.randn((4096, 3, probes.P, probes.P), generator=gen, device=dev)
    calls = {}
    for body in bodies:
        ns = probes.P if body == "split" else 512
        rel_x, rel_y = (runs._randint(gen, probes.P, (4096, ns), dev) for _ in range(2))
        edge, _ = (cs.split_nonfinite if body == "split" else cs.row_sums_leaving)(rel_x, rel_y, patches)
        calls[f"{body} K=4096 NS={ns}"] = [((body, rel_x, rel_y, patches), {})]
        calls[f"{body} {'non-finite' if body == 'split' else 'leaving'}"] = [((body, *edge), {})]
    return calls


def bisect_call(body, *args):
    """``exp_bisect.py``'s body ``body`` through its wrapper."""
    from cv_tpu_torch.experiments import probes

    return probes.BISECT[body](*args)


def mxu_call(body, *args):
    """``exp_r3_mxu_probe.py``'s body ``body`` through its wrapper."""
    from cv_tpu_torch.experiments import probes

    return probes.MXU[body](*args)


def probe_bounds(name, args):
    """The byte bounds of one probe call (``args``: the body and its
    inputs), from chip_smoke.py's work counts: ``bound_ms`` and, for the
    row select and the split select, ``word_bound_ms`` at 4 bytes a float
    named (``sectors=False``)."""
    import chip_smoke as cs

    if name in ("select_probes", "window_sums", "vpu_rowstage"):
        body, k, ns = args[0], args[2].shape[0], args[5].shape[1]
        out = dict(bound_ms=cs.bound(*cs.bisect_work(body, k, ns, cs.bisect_read(body, *args[1:6])))[0])
        if name == "vpu_rowstage":
            out["word_bound_ms"] = cs.bound(*cs.bisect_work(body, k, ns, sectors=False))[0]
        return out
    body, _, rel_y, patches = args
    k, c, p, _ = patches.shape
    out = dict(bound_ms=cs.bound(*cs.mxu_work(body, k, c, p, rel_y.shape[1], cs.mxu_rows_read(rel_y, p)))[0])
    if name == "mxu_split":
        out["word_bound_ms"] = cs.bound(*cs.mxu_work(body, k, c, p, rel_y.shape[1], sectors=False))[0]
    return out


def same_bits(a, b):
    """Bitwise equality of two float32 tensors, NaN by its bits."""
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def trig_call(kind, *args):
    """One recorded call of the trig kernel's wrappers: ``kind`` ``'angle'``
    (:func:`ops.trig.angle_cv`) or ``'cos_sin'``."""
    from cv_tpu_torch.ops import trig

    return trig.angle_cv(*args) if kind == "angle" else trig.cos_sin(*args)


def trig_plain(kind, *args):
    """The plain version of :func:`trig_call`."""
    from cv_tpu_torch.ops import trig

    return trig.angle_cv_plain(*args) if kind == "angle" else trig.cos_sin_plain(*args)


def trig_same(a, b):
    """Bitwise equality of two trig outputs (a tensor or a pair), a NaN by
    position."""
    import chip_smoke as cs

    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return len(a) == len(b) and all(cs.same_bits(x, y) for x, y in zip(a, b))


def trig_distance(a, b):
    """``(outputs that differ, largest distance in ulps)`` between two trig
    outputs, NaNs by position."""
    import torch

    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    x, y = torch.cat([v.reshape(-1) for v in a]), torch.cat([v.reshape(-1) for v in b])
    nan = torch.isnan(x) | torch.isnan(y)
    ulp = (x.view(torch.int32).long() - y.view(torch.int32).long()).abs()
    differ = (ulp != 0) & ~(torch.isnan(x) & torch.isnan(y))
    return int(differ.sum()), int(ulp[~nan].max()) if bool((~nan).any()) else 0


def trig_bound(args):
    """The bound of one trig call: three floats an element moved (two in
    and one out, or one in and two out) and ``chip_smoke.TRIG_OPS``."""
    import chip_smoke as cs

    kind, n = args[0], args[1].numel()
    return cs.bound(3 * n * 4, cs.TRIG_OPS["angle" if kind == "angle" else "cos_sin"] * n)[0]


def record_paths(dev, names):
    """``{kernel: {path: [(args, kwargs)]}}`` for the kernels of ``names``:
    their calls in chip_smoke.py's KITTI, SfM warm-pass, dense, 'pfused'
    and engine-budget runs (a run is skipped when no kernel of ``names``
    has a call in it)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from cv_tpu_torch.akaze import Akaze, AkazeExtractor, DeviceExtractor, FastAkazeExtractor, load_gray, to_gray_f32
    from cv_tpu_torch.akaze import descriptors, extrema, fused
    from cv_tpu_torch.experiments import probes
    from cv_tpu_torch.utils import kitti_pair

    calls = {name: {} for name in names}
    if "select_probes" in names:
        calls["select_probes"] = probe_calls(dev, probes.MATMUL_BODIES)
    if "window_sums" in names:
        calls["window_sums"] = probe_calls(dev, probes.WINDOW_SUM_BODIES)
    if "vpu_rowstage" in names:
        calls["vpu_rowstage"] = probe_calls(dev, ("vpu_rowstage",))
    if "mxu_probes" in names:
        calls["mxu_probes"] = mxu_calls(dev, probes.ROW_SUM_BODIES)
    if "mxu_split" in names:
        calls["mxu_split"] = mxu_calls(dev, ("split",))
    where = {"select_samples": (descriptors, "select_samples", cs.keep_planes),
             "dedup_scan": (extrema, "dedup_scan_device", cs._clone),
             "select_groups": (descriptors, "select_groups", cs.keep_planes),
             "select_fused": (fused, "select_fused", cs.keep_planes),
             "trig": [(descriptors, "angle_cv", lambda a: ("angle", *cs._clone(a))),
                      (descriptors, "cos_sin", lambda a: ("cos_sin", *cs._clone(a)))]}

    def run(fn, **paths):
        """Run ``fn`` with the calls of each kernel in ``paths`` (kernel ->
        path) recorded and added to that path."""
        wanted = {name: path for name, path in paths.items() if name in names}
        if not wanted:
            return
        with contextlib.ExitStack() as stack:
            got = {name: [stack.enter_context(cs.recording(*w))
                          for w in (where[name] if isinstance(where[name], list) else [where[name]])]
                   for name in wanted}
            fn()
        for name, path in wanted.items():
            for recorded in got[name]:
                calls[name].setdefault(path, []).extend(recorded)

    pair = np.stack([to_gray_f32(load_gray(p)) for p in kitti_pair()])
    kitti = torch.as_tensor(np.concatenate([pair] * (cs.BATCH // 2)), device=dev)
    dense = torch.as_tensor(pair, device=dev)
    run(lambda: DeviceExtractor(Akaze.sparse(), 256, 512, device=dev).extract(kitti),
        select_samples="kitti", dedup_scan="kitti", trig="kitti")
    run(lambda: cs.run_sfm(dev), select_samples="sfm", dedup_scan="sfm", trig="sfm")
    run(lambda: DeviceExtractor(Akaze(), device=dev, **cs.DENSE).extract(dense),
        dedup_scan="dense", select_groups="dense", trig="dense")
    run(lambda: DeviceExtractor(Akaze(), device=dev, onehot_mode="pfused", **cs.DENSE).extract(dense),
        select_fused="pfused")
    ex = FastAkazeExtractor(Akaze(maximum_features=8192), device=dev)
    run(lambda: ex.fetch_extract(ex.dispatch_extract(np.ascontiguousarray(pair[0]))),
        dedup_scan="dense", select_groups="engine", trig="engine")
    exact = AkazeExtractor(Akaze(), device=dev)
    run(lambda: [exact.extract(load_gray(p)) for p in kitti_pair()], trig="exact")
    torch.cuda.synchronize()
    for name, paths in calls.items():
        print(f"recorded {name} calls: " + ", ".join(f"{p} {len(c)}" for p, c in paths.items()))
    return calls


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", nargs="*", default=list(DEFAULT_KERNELS), choices=list(SYMBOLS),
                        help="the kernels to time")
    parser.add_argument("--variants", nargs="*", default=[],
                        help="copies to build, each KERNEL:NAME=VALUE[,NAME=VALUE...] "
                             "(constexpr int lines of csrc/KERNEL.cu)")
    parser.add_argument("--ablations", nargs="*", default=[], choices=sorted(ABLATIONS),
                        help="design points to take out, one copy each")
    parser.add_argument("--parent", default=None, help="root of another checkout whose sources to time")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_engine_calls: torch.cuda.is_available() is False; this runs only on a CUDA card")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from cv_tpu_torch import kernels
    from cv_tpu_torch.akaze import extrema, fused, select
    from cv_tpu_torch.experiments import probes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    names = list(dict.fromkeys(args.kernels))
    jobs = variant_jobs(args.variants, args.ablations)
    names += [name for name, _, _ in jobs if name not in names]
    kernels.build_all()
    libs = build_variants(jobs, args.parent, names)
    recorded = record_paths(dev, names)
    wrappers = {"dedup_scan": (extrema.dedup_scan_device, None, 3),
                "select_samples": (select.select_samples, None, 10),
                "select_groups": (select.select_groups, select.select_groups_plain, 10),
                "select_fused": (fused.select_fused, fused.select_fused_plain, 10),
                "select_probes": (bisect_call, probes.bisect_matmul_ordered, 10),
                "window_sums": (bisect_call, probes.bisect_window_ordered, 10),
                "vpu_rowstage": (bisect_call, probes.bisect_plain, 10),
                "mxu_probes": (mxu_call, probes.mxu_rows_ordered, 10),
                "mxu_split": (mxu_call, probes.mxu_plain, 10),
                "trig": (trig_call, trig_plain, 10)}

    source_function = kernels.function
    results = {}
    for name in names:
        wrapper, plain, iters = wrappers[name]
        equal = same_bits if name in PROBES else trig_same if name == "trig" else cs.same
        paths = recorded[name]
        reference = {p: [wrapper(*a, **kw) for a, kw in calls] for p, calls in paths.items()}
        bounds = {}
        if plain is not None:
            for p, calls in paths.items():
                b4 = bs = sectors = 0
                for j, (a, kw) in enumerate(calls):
                    cs.require(equal(reference[p][j], plain(*a, **kw)),
                               f"{name} (this tree) {p} call {j}: bitwise equal to the plain version")
                    if name in PROBES or name == "trig":
                        per_call = probe_bounds(name, a) if name in PROBES else dict(bound_ms=trig_bound(a))
                        for key, ms in per_call.items():
                            bounds.setdefault(p, {}).setdefault(key, 0.0)
                            bounds[p][key] += ms
                        continue
                    b, s, n = cs.describe_call_bounds(name, a, kw, reference[p][j])
                    b4, bs, sectors = b4 + cs.bound(b)[0], bs + cs.bound(s)[0], sectors + n
                if name not in PROBES and name != "trig":
                    bounds[p] = dict(bound_ms=b4, sector_bound_ms=bs, sectors=sectors)
                if name == "select_groups":
                    for j, (a, kw) in enumerate(calls):
                        n, med, fits, fewer = group_footprints(a, kw)
                        print(f"select_groups {p} call {j} (NS={a[5].shape[-1]}): {n} live slots, footprint box "
                              f"median {med} floats a channel; {fits} fit 1,536 floats, {fewer} have fewer box "
                              "sectors than samples")
        variants = dict(libs[name])
        builds = ([("parent", variants.pop("parent"))] if "parent" in variants else []) + [("this tree", None)]
        builds += list(variants.items())
        order = builds + builds[::-1]
        times = {label: {p: [] for p in paths} for label, _ in builds}
        distance = {label: [0, 0] for label, _ in builds if label in APPROXIMATE}
        for label, lib in order:
            if lib is not None:

                def swapped(lib_name, sym, argtypes, _lib=lib, _syms=SYMBOLS[name]):
                    if sym not in _syms:
                        return source_function(lib_name, sym, argtypes)
                    fn = getattr(_lib, sym)
                    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
                    return fn

                kernels.function = swapped
            try:
                for p, calls in paths.items():
                    for j, (a, kw) in enumerate(calls):
                        got = wrapper(*a, **kw)
                        torch.cuda.synchronize()
                        if label in APPROXIMATE:
                            n, ulp = trig_distance(got, reference[p][j])
                            distance[label] = [distance[label][0] + n, max(distance[label][1], ulp)]
                            continue
                        cs.require(equal(got, reference[p][j]),
                                   f"{name} ({label}) {p} call {j}: bitwise equal to this tree's build")
                    times[label][p].append(sum(cs.device_ms(lambda a=a, kw=kw: wrapper(*a, **kw), iters=iters)
                                               for a, kw in calls))
            finally:
                kernels.function = source_function
        for label, _ in builds:
            rec = {}
            for p, calls in paths.items():
                ms = sum(times[label][p]) / len(times[label][p])
                rec[p] = dict(calls=len(calls), ms=ms, turns=times[label][p])
                line = f"{name} ({label}) {p}: {len(calls)} calls, summed device {ms:.4f} ms"
                if name == "dedup_scan":
                    steps = sum(int(a[8].max()) for a, _ in calls)
                    rec[p].update(steps=steps, us_per_step=ms * 1e3 / steps)
                    line += f", {steps} steps, {ms * 1e3 / steps:.4f} us a step"
                if p in bounds:
                    b = bounds[p]
                    rec[p].update(b, bound_share=b["bound_ms"] / ms)
                    line += (f", {'bound' if name == 'trig' else 'byte bound'} {b['bound_ms']:.4f} ms "
                             f"({100 * b['bound_ms'] / ms:.1f}%)")
                    if "word_bound_ms" in b:
                        rec[p].update(word_bound_share=b["word_bound_ms"] / ms)
                        line += (f", at 4 bytes a float {b['word_bound_ms']:.4f} ms "
                                 f"({100 * b['word_bound_ms'] / ms:.1f}%)")
                    if "sectors" in b:
                        rec[p].update(sector_bound_share=b["sector_bound_ms"] / ms)
                        line += (f", {b['sectors']} plane sectors: sector bound {b['sector_bound_ms']:.4f} ms "
                                 f"({100 * b['sector_bound_ms'] / ms:.1f}%)")
                print(line + f" (turns {', '.join(f'{t:.4f}' for t in times[label][p])})")
            if label in distance:
                n, ulp = distance[label]
                total = sum(sum(sum(x.numel() for x in (r if isinstance(r, tuple) else (r,))) for r in refs)
                            for refs in reference.values())
                rec["differ"] = dict(outputs=n // 2, of=total, max_ulp=ulp)
                print(f"{name} ({label}): {n // 2} of {total} outputs differ from this tree's build (each call "
                      f"checked in both turns), at most {ulp} ulp")
            results[f"{name}@{label}"] = rec
    print(json.dumps({"card": smi.stdout.strip(), "builds": results}))


if __name__ == "__main__":
    main()
