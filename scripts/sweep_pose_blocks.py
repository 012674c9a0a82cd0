#!/usr/bin/env python3
"""Block-size sweep of the pose-optimizer kernels B and C on one CUDA card.

Kernel B (``csrc/three_view_l2.cu``) and kernel C
(``csrc/three_view_adaptive.cu``) sum their rows in an order that depends
on their block size, so the size is a constant of each source
(``constexpr int kThreads = 256;``).  This script writes a copy of each
source per size in ``--sizes`` with that line changed into the git-ignored
``cv_tpu_torch/_build/sweep/``, builds the copies with the sources' own
flags (one nvcc per copy, all started together), records every B and C call
of one pass of chip_smoke.py's 12-frame SfM configuration, and for each
build, with the wrapper's C function swapped for the copy's:

* replays the recorded calls (the SfM engine's own shapes), each call timed
  on the card with CUDA events (mean of 3 after a warm-up), summed;
* times one call at chip_smoke.py's benchmark shape (B: N=1,024, 2,000
  steps; C: K=64, N=64, 1,000 steps) in a CUDA graph;
* holds the first recorded call of each kernel within 1e-4 of the build
  in the source (the sum order differs between sizes, nothing else).

Prints one line per build and, last, one JSON object with every number.
Usage: python3 scripts/sweep_pose_blocks.py [--sizes 128 256 512]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

SYMBOLS = {"three_view_l2": "cv_three_view_l2", "three_view_adaptive": "cv_three_view_adaptive"}
BLOCK_LINE = "constexpr int kThreads = 256;"


def build_variants(sizes):
    """``{(name, size): ctypes library}``: a copy of each source per size
    with its block size changed, all builds started together."""
    from cv_tpu_torch import kernels

    out_dir = os.path.join(kernels.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in SYMBOLS:
        with open(os.path.join(kernels.CSRC, f"{name}.cu")) as f:
            text = f.read()
        if text.count(BLOCK_LINE) != 1:
            raise RuntimeError(f"csrc/{name}.cu does not hold the line {BLOCK_LINE!r} once")
        for size in sizes:
            src = os.path.join(out_dir, f"{name}-{size}.cu")
            with open(src, "w") as f:
                f.write(text.replace(BLOCK_LINE, f"constexpr int kThreads = {size};"))
            lib = os.path.join(out_dir, f"lib{name}-{size}.so")
            cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, *kernels.EXTRA_FLAGS[name], "-I", kernels.CSRC, "-o", lib, src]
            procs[(name, size)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                         text=True))
    libs = {}
    for (name, size), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} at {size} threads:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        print(f"build {name} at {size} threads: {regs[-1] if regs else ''}")
        libs[(name, size)] = ctypes.CDLL(lib)
    return libs


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", type=int, nargs="+", default=[128, 256, 512])
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sweep_pose_blocks: torch.cuda.is_available() is False; this runs only on a CUDA card")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    from cv_tpu_torch import kernels
    from cv_tpu_torch.optimize import resident

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    kernels.build_all()
    libs = build_variants(args.sizes)
    with chip_smoke.record_pose_calls() as calls:
        chip_smoke.run_sfm(dev)
    print(f"recorded {len(calls['three_view_l2'])} B calls and {len(calls['three_view_adaptive'])} C calls")

    source_function = kernels.function
    results = {}
    for name, symbol in SYMBOLS.items():
        wrapper = getattr(resident, name)
        first_args, first_kw = calls[name][0]
        reference = chip_smoke.flat_poses(wrapper(*first_args, **first_kw))
        prob = chip_smoke.pose_problem(name, 0)
        steps = chip_smoke.POSE_KERNELS[name]["steps"]
        for size in args.sizes:
            fn = getattr(libs[(name, size)], symbol)

            def swapped(lib_name, sym, argtypes, _fn=fn, _sym=symbol):
                if sym != _sym:
                    return source_function(lib_name, sym, argtypes)
                _fn.argtypes, _fn.restype = list(argtypes), ctypes.c_int
                return _fn

            kernels.function = swapped
            try:
                got = chip_smoke.flat_poses(wrapper(*first_args, **first_kw))
                err = float(np.abs(got - reference).max())
                chip_smoke.require(np.isfinite(got).all() and err <= 1e-4,
                                   f"{name} at {size} threads: first engine call within 1e-4 (max |err| {err})")
                engine_ms = sum(chip_smoke.cuda_ms(lambda a=a, kw=kw: wrapper(*a, **kw), iters=3, warmup=1)
                                for a, kw in calls[name])
                bench_ms = chip_smoke.device_ms(chip_smoke.pose_call(name, prob, steps, dev, plain=False), iters=3)
            finally:
                kernels.function = source_function
            results[f"{name}@{size}"] = dict(engine_ms=engine_ms, engine_calls=len(calls[name]), bench_device_ms=bench_ms,
                                             max_abs_err_vs_source=err)
            print(f"{name} at {size} threads: engine calls {engine_ms:.3f} ms summed over {len(calls[name])}, "
                  f"benchmark shape {bench_ms:.4f} ms (device), first call within {err:.3e} of the source's build")
    print(json.dumps({"card": smi.stdout.strip(), "sweep": results}))


if __name__ == "__main__":
    main()
