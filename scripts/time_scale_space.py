#!/usr/bin/env python3
"""Time the scale space's kernels (``csrc/scale_space.cu``) for one or more
checkouts of the repo, on one CUDA card.

Per checkout (``--roots``, each the root of a tree such as the parent
commit unpacked with ``git archive`` into the git-ignored ``_parent/``),
one process imports that tree's ``cv_tpu_torch`` and ``chip_smoke.py``,
builds ``scale_space`` and records every call of the ``ops/image.py``
kernel wrappers (``*_kernel``: sep_filter, evolution_flow, the FED step or
cycle, detector) during one ``build_scale_space`` of:

* ``kitti``: the KITTI pair as B=8 at ``Akaze.sparse()`` (chip_smoke.py's
  slice);
* ``exact``: KITTI frame 0 alone at ``Akaze()`` (B=1, the exact
  extractor's build).

Each recorded call is replayed on its own inputs: its device ms (5 calls
captured in one CUDA graph, ``chip_smoke.device_ms``) and its call ms
(CUDA events around 5 Python calls, ``chip_smoke.cuda_ms``), summed a
wrapper and, a wrapper, a plane shape.  Each build also gets its host ms
ending in a sync (median of 10, ``chip_smoke.wall_ms``), the device ms of
the whole build captured in one CUDA graph (its host share: 1 - device /
host) and the profiler's kernel launches (``chip_smoke.profiled_launches``).

With ``--sweep`` (a tree whose ops have ``fed_cycle_kernel``), each KITTI
FED cycle is also timed (device ms) at every count of steps a launch in
``SWEEP_STEPS`` up to its own length: the data behind
``ops.fed_block_steps``.

The roots run in the order given (for a comparison: parent, this tree,
this tree, parent), one process each.  Prints a few lines per run;
``--out FILE`` writes every figure to FILE as JSON.

Usage: python3 scripts/time_scale_space.py --roots _parent . . _parent --out times.json
       python3 scripts/time_scale_space.py --roots . --sweep
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

WRAPPERS = ("sep_filter_kernel", "evolution_flow_kernel", "fed_step_kernel", "fed_cycle_kernel", "detector_kernel")
SWEEP_STEPS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 17, 24, 29, 32)


def child(root: str, sweep: bool) -> dict:
    """The figures of the tree at ``root`` (run in a process of its own)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from cv_tpu_torch import kernels
    from cv_tpu_torch.akaze import Akaze, load_gray, to_gray_f32
    from cv_tpu_torch.akaze.config import allocate_evolutions
    from cv_tpu_torch.akaze.scale_space import build_scale_space
    from cv_tpu_torch.ops import image as ops
    from cv_tpu_torch.utils import kitti_pair

    dev = torch.device("cuda", 0)
    kernels.build_all(["scale_space"])
    pair = np.stack([to_gray_f32(load_gray(p)) for p in kitti_pair()])
    builds = {"kitti": (Akaze.sparse(), torch.as_tensor(np.concatenate([pair] * (cs.BATCH // 2)), device=dev)),
              "exact": (Akaze(), torch.as_tensor(pair[:1], device=dev))}
    out = {}
    for label, (cfg, images) in builds.items():
        specs = allocate_evolutions(cfg, images.shape[-1], images.shape[-2])

        def build(cfg=cfg, specs=specs, images=images):
            return build_scale_space(cfg, specs, images)

        calls = []
        real = {name: getattr(ops, name) for name in WRAPPERS if hasattr(ops, name)}

        def recorder(name, fn):
            def recorded(*a, **kw):
                calls.append((name, a, kw))
                return fn(*a, **kw)
            return recorded

        for name, fn in real.items():
            setattr(ops, name, recorder(name, fn))
        try:
            build()
            torch.cuda.synchronize()
        finally:
            for name, fn in real.items():
                setattr(ops, name, fn)
        per = {}
        for name, a, kw in calls:
            fn = real[name]
            dms = cs.device_ms(lambda: fn(*a, **kw), iters=5)
            cms = cs.cuda_ms(lambda: fn(*a, **kw), iters=5, warmup=1)
            shape = "x".join(str(d) for d in a[0].shape)
            for key in (name, f"{name} {shape}"):
                row = per.setdefault(key, {"calls": 0, "device_ms": 0.0, "call_ms": 0.0})
                row["calls"] += 1
                row["device_ms"] += dms
                row["call_ms"] += cms
        build()
        host = statistics.median(cs.wall_ms(build, reps=10))
        device = cs.device_ms(build, iters=3)
        out[label] = {"host_ms": host, "device_ms": device, "host_share": 1.0 - device / host, "wrappers": per}
        if sweep and label == "kitti" and "fed_cycle_kernel" in real:
            fed = {}
            for name, a, kw in calls:
                if name != "fed_cycle_kernel":
                    continue
                lt, cond, taus = a
                n = len(taus)
                key = f"{'x'.join(str(d) for d in lt.shape)} n={n}"
                fed[key] = {k: cs.device_ms(lambda k=k: ops.fed_cycle_kernel(lt, cond, taus, block_steps=k), iters=5)
                            for k in sorted(set(k for k in SWEEP_STEPS if k <= n) | {n})}
            out["sweep"] = fed
    for label, (cfg, images) in builds.items():
        specs = allocate_evolutions(cfg, images.shape[-1], images.shape[-2])
        launches, events = cs.profiled_launches(lambda: build_scale_space(cfg, specs, images))
        out[label]["launches"] = launches if events else None
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--roots", nargs="+", default=["."], help="checkout roots, timed in this order")
    parser.add_argument("--sweep", action="store_true", help="time each KITTI FED cycle at every steps a launch")
    parser.add_argument("--out", default=None, help="a JSON file for every figure")
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child, args.sweep)))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    runs = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", os.path.abspath(root)]
                              + (["--sweep"] if args.sweep else []),
                              capture_output=True, text=True, cwd=os.path.abspath(root))
        if proc.returncode != 0:
            raise SystemExit(f"time_scale_space: the run of {root} failed:\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
        figures = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"root": root, **figures})
        for label in ("kitti", "exact"):
            f = figures[label]
            print(f"{root} {label}: host {f['host_ms']:.3f} ms, device {f['device_ms']:.4f} ms (host share "
                  f"{f['host_share']:.3f}), launches {f['launches']}; " + ", ".join(
                      f"{name} {row['calls']} calls {row['device_ms']:.4f} device, {row['call_ms']:.4f} call"
                      for name, row in f["wrappers"].items() if " " not in name))
        for key, times in figures.get("sweep", {}).items():
            print(f"{root} sweep {key}: " + ", ".join(f"{k} {ms:.4f}" for k, ms in times.items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": runs}, f, indent=1)
        print(f"every figure: {args.out}")


if __name__ == "__main__":
    main()
