#!/usr/bin/env python3
"""The dedup scan and the sample select at the engine's own calls, for
several builds of each, on one CUDA card.

Builds, with each source's own flags (one nvcc per build, all started
together), into the git-ignored ``cv_tpu_torch/_build/variants/``:

* copies of ``csrc/dedup_scan.cu`` at each block size of ``--sizes`` (its
  line ``constexpr int kThreads = ...;`` changed): the scan's block-size
  sweep; with ``--ablations``, copies with one design point taken out
  (``ABLATIONS``);
* with ``--per`` and ``--select-sizes``, copies of ``csrc/select_samples.cu``
  at other numbers of samples a thread and other block sizes;
* with ``--parent DIR`` (the root of another checkout, e.g. the parent
  commit unpacked with ``git archive``), that tree's ``dedup_scan.cu`` and
  ``select_samples.cu``.

Then records the calls of chip_smoke.py's paths where the extractor binds
the wrappers: the KITTI extract (B=8: two select calls, one dedup call),
the SfM warm pass (12 frames: 24 select calls, 12 dedup calls) and the
dense extract (B=2) with ``FastAkazeExtractor`` at 8192 features on frame 0
(two dedup calls).  For each kernel the builds take turns behind the
wrapper (its C function swapped), in the order of the builds and then
reversed, so that with a parent the order is parent, this tree, ..., this
tree, parent; each turn holds every recorded call bitwise to this tree's
build in the checkout and sums the calls' device times (a CUDA graph each)
per path.  A build's time is the mean of its two turns.

Prints one line per build and path, and last one JSON object with every
number.
Usage: python3 scripts/time_engine_calls.py [--sizes 128 256 512] [--ablations upper-all]
       [--per 1 4] [--select-sizes 128 512] [--parent _parent]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

SYMBOLS = {"dedup_scan": "cv_dedup_scan", "select_samples": "cv_select_samples"}
# The lines the copies change (regular expressions, each matching once).
BLOCK_LINE = r"constexpr int kThreads = \d+;"
PER_LINE = r"constexpr int kPer = \d+;"
# Design points of the scan taken out one at a time, each by replacing one
# line of csrc/dedup_scan.cu: the upper-scale pass's class ranges (every
# slot walks every later slot).
ABLATIONS = {
    "upper-all": (re.escape("if (up >= 0 && up < kClassTable) {"), "if (false) {"),
}


def variant_jobs(sizes, pers, select_sizes, ablations):
    """``[(kernel, label, source text)]``: the scan at each block size and
    with each ablation, the select at each samples-a-thread count and block
    size."""
    from cv_tpu_torch import kernels

    def edited(name, pattern, new):
        with open(os.path.join(kernels.CSRC, f"{name}.cu")) as f:
            text, n = re.subn(pattern, new, f.read())
        if n != 1:
            raise RuntimeError(f"csrc/{name}.cu does not hold a line {pattern!r} once")
        return text

    jobs = [("dedup_scan", f"{size} threads", edited("dedup_scan", BLOCK_LINE, f"constexpr int kThreads = {size};"))
            for size in sizes]
    jobs += [("dedup_scan", label, edited("dedup_scan", *ABLATIONS[label])) for label in ablations]
    jobs += [("select_samples", f"{per} samples a thread",
              edited("select_samples", PER_LINE, f"constexpr int kPer = {per};")) for per in pers]
    jobs += [("select_samples", f"select {size} threads",
              edited("select_samples", BLOCK_LINE, f"constexpr int kThreads = {size};")) for size in select_sizes]
    return jobs


def build_variants(jobs, parent):
    """``{kernel: {label: ctypes library}}`` for the edited sources of
    ``jobs`` and, when ``parent`` is given, that tree's two sources; every
    build started at once."""
    from cv_tpu_torch import kernels

    out_dir = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    todo = []
    for name, label, text in jobs:
        src = os.path.join(out_dir, f"{name}-{label.replace(' ', '_')}.cu")
        with open(src, "w") as f:
            f.write(text)
        todo.append((name, label, src, kernels.CSRC))
    if parent:
        csrc = os.path.join(parent, "cv_tpu_torch", "csrc")
        todo += [(name, "parent", os.path.join(csrc, f"{name}.cu"), csrc) for name in SYMBOLS]
    procs = []
    for name, label, src, include in todo:
        lib = os.path.join(out_dir, f"lib{name}-{label.replace(' ', '_')}.so")
        cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, *kernels.EXTRA_FLAGS.get(name, []), "-I", include, "-o", lib, src]
        procs.append((name, label, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                         text=True)))
    libs = {name: {} for name in SYMBOLS}
    for name, label, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({label}):\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        print(f"build {name} ({label}): {regs[-1] if regs else ''}")
        libs[name][label] = ctypes.CDLL(lib)
    return libs


def record_paths(dev):
    """``({path: select calls}, {path: dedup calls})`` of chip_smoke.py's
    KITTI, SfM warm-pass and dense runs."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from cv_tpu_torch.akaze import Akaze, DeviceExtractor, FastAkazeExtractor, load_gray, to_gray_f32
    from cv_tpu_torch.akaze import descriptors, extrema
    from cv_tpu_torch.utils import kitti_pair

    pair = np.stack([to_gray_f32(load_gray(p)) for p in kitti_pair()])
    kitti = torch.as_tensor(np.concatenate([pair] * (cs.BATCH // 2)), device=dev)
    dense = torch.as_tensor(pair, device=dev)
    select_calls, scan_calls = {}, {}
    with cs.recording(descriptors, "select_samples", cs.keep_planes) as select_calls["kitti"], \
            cs.recording(extrema, "dedup_scan_device") as scan_calls["kitti"]:
        DeviceExtractor(Akaze.sparse(), 256, 512, device=dev).extract(kitti)
    with cs.recording(descriptors, "select_samples", cs.keep_planes) as select_calls["sfm"], \
            cs.recording(extrema, "dedup_scan_device") as scan_calls["sfm"]:
        cs.run_sfm(dev)
    with cs.recording(extrema, "dedup_scan_device") as scan_calls["dense"]:
        DeviceExtractor(Akaze(), device=dev, **cs.DENSE).extract(dense)
        ex = FastAkazeExtractor(Akaze(maximum_features=8192), device=dev)
        ex.fetch_extract(ex.dispatch_extract(np.ascontiguousarray(pair[0])))
    torch.cuda.synchronize()
    for kind, paths in (("select", select_calls), ("dedup", scan_calls)):
        print(f"recorded {kind} calls: " + ", ".join(f"{p} {len(c)}" for p, c in paths.items()))
    return select_calls, scan_calls


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", type=int, nargs="*", default=[128, 256, 512],
                        help="block sizes of the scan's copies")
    parser.add_argument("--per", type=int, nargs="*", default=[], help="samples a thread of the select's copies")
    parser.add_argument("--select-sizes", type=int, nargs="*", default=[], help="block sizes of the select's copies")
    parser.add_argument("--ablations", nargs="*", default=[], choices=sorted(ABLATIONS),
                        help="the scan's design points to take out, one copy each")
    parser.add_argument("--parent", default=None, help="root of another checkout whose two sources to time")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_engine_calls: torch.cuda.is_available() is False; this runs only on a CUDA card")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from cv_tpu_torch import kernels
    from cv_tpu_torch.akaze import extrema, select

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    kernels.build_all()
    libs = build_variants(variant_jobs(args.sizes, args.per, args.select_sizes, args.ablations), args.parent)
    select_calls, scan_calls = record_paths(dev)
    wrappers = {"dedup_scan": (extrema.dedup_scan_device, scan_calls, 3),
                "select_samples": (select.select_samples, select_calls, 10)}

    source_function = kernels.function
    results = {}
    for name, (wrapper, paths, iters) in wrappers.items():
        reference = {p: [wrapper(*a, **kw) for a, kw in calls] for p, calls in paths.items()}
        variants = dict(libs[name])
        builds = ([("parent", variants.pop("parent"))] if "parent" in variants else []) + [("this tree", None)]
        builds += list(variants.items())
        order = builds + builds[::-1]
        times = {label: {p: [] for p in paths} for label, _ in builds}
        for label, lib in order:
            if lib is not None:
                fn = getattr(lib, SYMBOLS[name])

                def swapped(lib_name, sym, argtypes, _fn=fn, _sym=SYMBOLS[name]):
                    if sym != _sym:
                        return source_function(lib_name, sym, argtypes)
                    _fn.argtypes, _fn.restype = list(argtypes), ctypes.c_int
                    return _fn

                kernels.function = swapped
            try:
                for p, calls in paths.items():
                    for j, (a, kw) in enumerate(calls):
                        got = wrapper(*a, **kw)
                        torch.cuda.synchronize()
                        cs.require(torch.equal(got, reference[p][j]),
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
                print(line + f" (turns {', '.join(f'{t:.4f}' for t in times[label][p])})")
            results[f"{name}@{label}"] = rec
    print(json.dumps({"card": smi.stdout.strip(), "builds": results}))


if __name__ == "__main__":
    main()
