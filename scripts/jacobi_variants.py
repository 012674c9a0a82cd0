#!/usr/bin/env python3
"""Time ``csrc/jacobi.cu`` on one CUDA card against its parent and against
copies with one ``constexpr int NAME = VALUE;`` line changed.

Builds this tree's ``jacobi.cu``, the parent's (``--parent``: the root of
a tree such as the parent commit unpacked with ``git archive`` into the
git-ignored ``_parent/``) and each variant (``--variants kMinBlocks=1
kRolledMinBlocks=1``) with one ``nvcc`` each, all
started together, into ``cv_tpu_torch/_build/sweep/``, and prints each
build's registers, stack and spills (``-Xptxas -v``) for the float64 4x4
and 9x9 Jacobi and the residual entry.  Each build is held bitwise to this
tree's wrappers (``ops.eigen.eigh_small``, ``core.pose.c2c_residual``) on
the timed inputs, then the device milliseconds of its C functions (a CUDA
graph of 5 calls on the capturing stream, ``chip_smoke.device_ms``) are
taken in turns (this tree, the others, then the reverse order):

* the Jacobi at one consensus block, 4,194,304 4x4 float64 matrices, 6
  sweeps (``chip_smoke.JACOBI_TIMED``);
* the 9x9 float64 Jacobi, 8 sweeps, of eight-point and five-point at
  8,192 matrices (the sandbox's two-view hypotheses) and at 65,536;
* the residual entry at 4,194,304 pairs (1,024 x 4 models against 1,024
  matches, float64; the parent has none).

It also prints the branch mix of the 4x4 Jacobi's trigonometry on the
first 2^20 of those matrices: per sweep, the share of rotations whose angle
has atan2's first small-quotient form (``ops.eigen._converged``: cos 1, sin
theta), and the share of 32-matrix warps in which all or only some of the
matrices take it.

Usage: python3 scripts/jacobi_variants.py --parent _parent --variants kMinBlocks=1
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(name: str, text: str, csrc: str, out_dir: str):
    """Start ``nvcc`` on ``text`` (a jacobi.cu) beside copies of its headers."""
    from cv_tpu_torch import kernels

    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    for header in ("trig.cuh", "trig64_tables.cuh"):
        shutil.copy(os.path.join(csrc, header), d)
    with open(os.path.join(d, "jacobi.cu"), "w") as f:
        f.write(text)
    cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, *kernels.EXTRA_FLAGS["jacobi"], "-o", os.path.join(d, "lib.so"),
           os.path.join(d, "jacobi.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), os.path.join(d, "lib.so")


N9 = (8192, 65536)  # the 9x9 batches timed


def resources(log: str) -> dict:
    """Registers, stack and spills of the float64 4x4 and 9x9 Jacobi and the
    float64 residual entry, from ``-Xptxas -v``."""
    out, lines = {}, log.splitlines()
    for i, line in enumerate(lines):
        for key, mark in (("jacobi 4x4 f64", r"jacobi_kernelIdLi4E"), ("jacobi 9x9 f64", r"jacobi_(rolled_)?kernelIdLi9E"),
                          ("residual f64", r"c2c_residual_kernelIdE")):
            if "Compiling entry" in line and re.search(mark, line):
                out[key] = " ".join(x.strip() for x in lines[i + 2:i + 4]).replace("ptxas info    : ", "")
    return out


def variant_source(src: str, spec: str) -> str:
    for item in spec.split(","):
        name, value = item.split("=")
        src, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise SystemExit(f"no single `constexpr int {name} = ...;` line in jacobi.cu")
    return src


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the parent tree")
    ap.add_argument("--variants", nargs="*", default=[], help="NAME=VALUE[,NAME=VALUE] changes of jacobi.cu")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from cv_tpu_torch import kernels
    from cv_tpu_torch.core import pose as tpose
    from cv_tpu_torch.ops import eigen

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    csrc = os.path.join(ROOT, "cv_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "jacobi.cu")).read()
    builds = {"this tree": src, **{spec: variant_source(src, spec) for spec in args.variants}}
    if args.parent:
        builds["parent"] = open(os.path.join(args.parent, "cv_tpu_torch", "csrc", "jacobi.cu")).read()
    out_dir = os.path.join(ROOT, "cv_tpu_torch", "_build", "sweep")
    started = {name: build(re.sub(r"[^A-Za-z0-9]+", "_", name), text, csrc, out_dir) for name, text in builds.items()}
    libs = {}
    for name, (proc, path) in started.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        print(f"{name}:", resources(log))
        libs[name] = ctypes.CDLL(path)

    rng = np.random.default_rng(17)
    m = torch.as_tensor(cs.symmetric_batch(rng, cs.JACOBI_TIMED, 4)[:cs.JACOBI_TIMED], device=dev)
    m9 = {k: torch.as_tensor(cs.symmetric_batch(rng, k, 9)[:k], device=dev) for k in N9}
    pose, a, b = cs.c2c_block(dev, rng)
    w0, v0 = eigen.eigh_small(m)
    want9 = {k: eigen.eigh_small(x, sweeps=8) for k, x in m9.items()}
    r0 = tpose.c2c_residual(pose, a, b)
    rot, tr = pose.rotation.reshape(-1, 9).contiguous(), pose.translation.reshape(-1, 3).contiguous()
    runs = {}
    for name, lib in libs.items():
        jac = lib.cv_jacobi_f64
        jac.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        w, v = torch.empty_like(w0), torch.empty_like(v0)
        run_j = (lambda f, w, v: lambda: f(m.data_ptr(), w.data_ptr(), v.data_ptr(), m.shape[0], 4, 6,
                                           kernels.current_stream(dev)))(jac, w, v)
        run_j()
        runs9, same9 = {}, True
        for k, x in m9.items():
            w9, v9 = torch.empty_like(want9[k][0]), torch.empty_like(want9[k][1])
            runs9[k] = (lambda f, x, w, v: lambda: f(x.data_ptr(), w.data_ptr(), v.data_ptr(), x.shape[0], 9, 8,
                                                     kernels.current_stream(dev)))(jac, x, w9, v9)
            runs9[k]()
            torch.cuda.synchronize()
            same9 &= cs.same_bits_any(w9, want9[k][0]) and cs.same_bits_any(v9, want9[k][1])
        run_r, out = None, None
        if hasattr(lib, "cv_c2c_residual_f64"):
            res = lib.cv_c2c_residual_f64
            res.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                                    ctypes.c_void_p]
            out = torch.empty_like(r0)
            run_r = (lambda f, o: lambda: f(rot.data_ptr(), tr.data_ptr(), a.data_ptr(), b.data_ptr(), o.data_ptr(),
                                            rot.shape[0], a.shape[0], 0, 6, kernels.current_stream(dev)))(res, out)
            run_r()
        torch.cuda.synchronize()
        same = cs.same_bits_any(w, w0) and cs.same_bits_any(v, v0) and (out is None or cs.same_bits_any(out, r0))
        cs.require(same and same9, f"jacobi.cu build {name}: bitwise equal to this tree's wrappers")
        runs[name] = (run_j, run_r, runs9)
    times = {name: {"jacobi": [], "residual": [], **{k: [] for k in N9}} for name in runs}
    order = list(runs)
    for turn in (order, order[::-1]):
        for name in turn:
            run_j, run_r, runs9 = runs[name]
            times[name]["jacobi"].append(cs.device_ms(run_j, iters=5))
            for k, run in runs9.items():
                times[name][k].append(cs.device_ms(run, iters=5))
            if run_r is not None:
                times[name]["residual"].append(cs.device_ms(run_r, iters=5))
    for name, t in times.items():
        nine = "; ".join(f"at {k} {[round(x, 4) for x in t[k]]}" for k in N9)
        print(f"{name}: jacobi at {cs.JACOBI_TIMED} 4x4 float64 {[round(x, 4) for x in t['jacobi']]} ms device; "
              f"9x9 float64, 8 sweeps, {nine} ms device; "
              f"residual at {r0.numel()} pairs {[round(x, 4) for x in t['residual']]} ms device", flush=True)

    # The branch mix: the plain Jacobi's float64 angle, wrapped to record
    # which rotations take the converged form.
    masks, angle = [], eigen._angle_f64

    def recording(apq, app, aqq):
        masks.append(eigen._converged(2.0 * apq, eigen._ftz(aqq - app)))
        return angle(apq, app, aqq)

    eigen._angle_f64 = recording
    try:
        eigen.eigh_small_plain(m[: 1 << 20])
    finally:
        eigen._angle_f64 = angle
    fast = torch.stack(masks).reshape(6, 6, -1)  # sweep, pair, matrix
    warps = fast.reshape(6, 6, -1, 32)
    every, some = warps.all(-1), warps.any(-1)
    for sweep in range(6):
        mixed = float((some[sweep] & ~every[sweep]).float().mean())
        print(f"branch mix, sweep {sweep}: converged rotations {float(fast[sweep].float().mean()):.4f}; warps all "
              f"converged {float(every[sweep].float().mean()):.4f}, mixed {mixed:.4f}")


if __name__ == "__main__":
    main()
