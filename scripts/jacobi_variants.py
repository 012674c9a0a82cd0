#!/usr/bin/env python3
"""Time ``csrc/jacobi.cu``'s consensus entries on one CUDA card against its
parent, against copies with one ``constexpr int NAME = VALUE;`` line
changed, and against ablations: copies whose bits are wrong, built only to
split the residual entry's time.

Builds this tree's ``jacobi.cu``, the parent's (``--parent``: the root of a
tree such as the parent commit unpacked with ``git archive`` into the
git-ignored ``_parent/``), each variant (``--variants
kC2cMinBlocks=4``) and each ablation of this tree's source
(``--ablations``) with one ``nvcc`` each, all started together, into
``cv_tpu_torch/_build/sweep/``, and prints each build's registers, stack
and spills (``-Xptxas -v``) for the float64 residual and score entries
(and the 4x4 / 9x9 Jacobi with ``--jacobi``).  The ablations:

* ``no-flush``: ``ftz`` of a double returns its argument (every flush of
  the sweep and the angle gone) and every rotation takes the path without
  flushes, its exponent test dropped;
* ``no-keys``: every rotation takes the path without flushes, its exponent
  test dropped (what the test costs);
* ``trig-standin``: the angle's ``atan2_64`` and ``cos_sin64`` replaced
  by a branch-free stand-in of similar length (two divisions and a chain
  of fused operations, no table);
* ``no-sweeps``: no Jacobi sweep (the design, the sort and the score).

Every build that is not an ablation is held bitwise to this tree's
wrappers (``core.pose.c2c_residual``, ``c2c_score``) on every timed input.
The device milliseconds of the C functions (a CUDA graph of 5 calls,
``chip_smoke.device_ms``) are taken in turns (this tree, the others, then
the reverse order) on these inputs, float64:

* ``c2c_block``: ``chip_smoke.c2c_block`` (1,024 x 4 random models against
  1,024 random matches, 4,194,304 pairs);
* with ``--blocks``, the consensus blocks that the engine and the
  vslam-sandbox app really score: the first two-view scoring stage of the
  sandbox app at its defaults (rendered 1080x1920 frames, 8,192
  hypotheses x 4 models against the frame pair's matches; the app's
  consensus has no prescore stage), cut to the parent's block of
  ``SCORE_BLOCK`` pairs (and whole, with ``--whole``); and the first prescore stage of the
  SfM configuration (``chip_smoke.run_sfm``'s engine, 2,048 x 4 models
  against the 64 rows of its block).

For the score entry (``cv_c2c_score_f64``, where a build has one) the same
inputs are scored with the stage's threshold; the parent's figure beside it
is its residual entry plus the torch passes of its ``_score_stage``
(compare, isfinite, and, sum, where, sum), timed as one CUDA graph.

``--count`` builds this tree's source with every float64 operation of the
residual counted (a copy whose bits are right and whose time is not), runs
it on the timed inputs and prints the DADD, DMUL and DFMA instructions a
pair executes along its own branches, with each division and square root
counted as the float64 instructions of its SASS sequence (``cuobjdump
-sass`` of a one-operation kernel), beside the SASS's static counts of the
residual kernel.

It also prints the branch mix of the 4x4 Jacobi's trigonometry on the
first 2^20 designs of each block: per sweep, the share of rotations whose
angle has atan2's first small-quotient form (``ops.eigen._converged``: cos
1, sin theta), and the share of 32-pair warps in which all or only some of
the pairs take it.

Usage: python3 scripts/jacobi_variants.py --parent _parent --blocks \\
           --variants kC2cMinBlocks=4 --ablations no-flush trig-standin no-sweeps
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N9 = (8192, 65536)  # the 9x9 batches timed with --jacobi
HEADERS = ("trig.cuh", "trig64_tables.cuh")

# The ablations: (pattern, replacement) edits of jacobi.cu's source.
STANDIN = r"""\1
  // Timing stand-in: the length of atan2_64 + cos_sin64, no branch, no table.
  const double y = __dmul_rn(2.0, apq), x = __dsub_rn(aqq, app);
  const double u = __ddiv_rn(y, __dadd_rn(__dadd_rn(fabs(x), fabs(y)), 0x1p-1000));
  const double du = __ddiv_rn(__fma_rn(-u, u, 1.0), __dadd_rn(1.0, __dmul_rn(u, u)));
  const double w = __dmul_rn(u, u);
  double p = __fma_rn(w, -0x1.7458022b13c25p-4, 0x1.c71c6e5129a3bp-4);
  p = __fma_rn(p, w, -0x1.24924923f7603p-3);
  p = __fma_rn(p, w, 0x1.99999999997fdp-3);
  p = __fma_rn(p, w, -0x1.5555555555555p-2);
  const double t = __dmul_rn(0.5, __fma_rn(__dmul_rn(u, w), p, __fma_rn(du, 0x1p-60, u)));
  const double t2 = __dmul_rn(t, t);
  double cp = __fma_rn(t2, 0x1.a01a01a01a01ap-16, -0x1.6c16c16c16c17p-10);
  cp = __fma_rn(cp, t2, 0x1.5555555555555p-5);
  cp = __fma_rn(cp, t2, -0.5);
  double sp = __fma_rn(t2, 0x1.71de3a556c734p-19, -0x1.a01a01a01a01ap-13);
  sp = __fma_rn(sp, t2, 0x1.1111111111111p-7);
  sp = __fma_rn(sp, t2, -0x1.5555555555555p-3);
  c = __fma_rn(cp, t2, 1.0);
  s = __fma_rn(__dmul_rn(sp, t2), t, t);
}"""
ABLATIONS = {
    "no-flush": [(r"(__device__ __forceinline__ double ftz\(double v\) \{\n).*?\n\}", r"\1  return v;\n}"),
                 (r"no_subnormal<T>\(kc, k[ob]\)", "true")],
    "no-keys": [(r"no_subnormal<T>\(kc, k[ob]\)", "true")],
    "trig-standin": [(r"(__device__ __forceinline__ void (?:c2c_)?angle\(double apq, double app, double aqq, "
                      r"double& c, double& s\) \{).*?\n\}", STANDIN)],
    "no-sweeps": [(r"constexpr int kSweeps = \d+;", "constexpr int kSweeps = 0;")],
}
# Designs of this tree's source whose bits are right: (pattern, replacement)
# edits of jacobi.cu (or, keyed by a header's name, of that header), held
# bitwise like the variants.
EDITS = {
    # The hot float64 constants of trig.cuh in the constant bank, where an
    # operation can read them directly (not materialized a use each).
    "constbank": {"trig.cuh": [(r"constexpr double (kBig = |kSn3 = |kCs2 = |kTs1 = |kOpi = |kQpi = |kD3 = )",
                                r"__device__ __constant__ double \1")]},
    # Every value flushed by integer selects (no float64 multiply), no
    # exponent test: the per-value flush at its cheapest.
    "intflush": [(r"(__device__ __forceinline__ double ftz\(double v\) \{\n).*?\n\}",
                  r"\1  const long long b = __double_as_longlong(v);\n"
                  r"  return (b & 0x7ff0000000000000ll) == 0 ? __longlong_as_double(b & static_cast<long long>(0x8000000000000000ull)) : v;\n}"),
                 (r"no_subnormal<T>\(kc, k[ob]\)", "false")],
}


def edit(src: str, edits, every=False) -> str:
    """``src`` with each (pattern, replacement) applied once, or with
    ``every`` at each match (at least one match in all)."""
    total = 0
    for pattern, repl in edits:
        src, n = re.subn(pattern, repl, src, count=0 if every else 1, flags=re.S)
        if not every and n != 1:
            raise SystemExit(f"no match for {pattern[:60]!r} in jacobi.cu")
        total += n
    if total == 0:
        raise SystemExit(f"no match for {[p[:40] for p, _ in edits]} in jacobi.cu")
    return src


def variant_source(src: str, spec: str) -> str:
    for item in spec.split(","):
        name, value = item.split("=")
        src = edit(src, [(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};")])
    return src


def build(name: str, text: str, csrc: str, out_dir: str, extra=(), headers=None):
    """Start ``nvcc`` on ``text`` (a jacobi.cu) beside copies of its headers
    (``headers``: name -> edited text in their place)."""
    from cv_tpu_torch import kernels

    d = os.path.join(out_dir, re.sub(r"[^A-Za-z0-9]+", "_", name))
    os.makedirs(d, exist_ok=True)
    for header in HEADERS:
        shutil.copy(os.path.join(csrc, header), d)
    for header, body in (headers or {}).items():
        with open(os.path.join(d, header), "w") as f:
            f.write(body)
    with open(os.path.join(d, "jacobi.cu"), "w") as f:
        f.write(text)
    cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, *kernels.EXTRA_FLAGS["jacobi"], *extra, "-o",
           os.path.join(d, "lib.so"), os.path.join(d, "jacobi.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), os.path.join(d, "lib.so")


MARKS = (("jacobi 4x4 f64", r"jacobi_kernelIdLi4E"), ("jacobi 9x9 f64", r"jacobi_(rolled_)?kernelIdLi9E"),
         ("residual f64", r"c2c_residual_kernelIdE"), ("score f64", r"c2c_score_kernelIdE"))


def resources(log: str) -> dict:
    """Registers, stack and spills of the float64 entries, from ``-Xptxas -v``."""
    out, lines = {}, log.splitlines()
    for i, line in enumerate(lines):
        for key, mark in MARKS:
            if "Compiling entry" in line and re.search(mark, line):
                out[key] = " ".join(x.strip() for x in lines[i + 2:i + 4]).replace("ptxas info    : ", "")
    return out


def residual_fn(lib, src):
    """The build's float64 residual entry as ``f(rot, tr, a, b, out, P, M)``."""
    fn = lib.cv_c2c_residual_f64
    runtime_sweeps = "int paired, int sweeps" in src
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int] + (
        [ctypes.c_int] if runtime_sweeps else []) + [ctypes.c_void_p]
    return lambda sweeps: (lambda *a: fn(*a[:7], 0, *([sweeps] if runtime_sweeps else []), a[7]))


def score_fn(lib):
    """The build's float64 score entry, or None."""
    if not hasattr(lib, "cv_c2c_score_f64"):
        return None
    fn = lib.cv_c2c_score_f64
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_double, ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 6
    return fn


def record_blocks(dev):
    """The first two-view scoring stage of the sandbox app at its defaults
    and the first prescore stage of the SfM configuration, as ``{label:
    (pose, a, b, valid, threshold)}`` with poses of batch shape ``(H, M,
    1)``."""
    import torch

    import chip_smoke as cs
    from cv_tpu_torch.apps import vslam_sandbox as sandbox_app
    from cv_tpu_torch.consensus import BatchConsensus
    from cv_tpu_torch.core.pose import Isometry3
    from cv_tpu_torch.sfm.engine import DEFAULT_ESSENTIAL_ESTIMATOR

    class Done(Exception):
        pass

    blocks = {}

    def keep(label, models, a, b, valid, threshold):
        pose = Isometry3(models.rotation[..., None, :, :].clone(), models.translation[..., None, :].clone())
        blocks[label] = (pose, a.clone(), b.clone(), valid.clone(), float(threshold))
        raise Done

    real_score, real_pre = BatchConsensus._score_stage, BatchConsensus._prescore_stage

    def score(self, estimator, models, data, valid_row):
        if estimator.residual is DEFAULT_ESSENTIAL_ESTIMATOR.residual:
            keep("sandbox score", models, data[0], data[1], valid_row, self.threshold)
        return real_score(self, estimator, models, data, valid_row)

    def prescore(self, estimator, models, data, valid_row, block):
        if estimator.residual is DEFAULT_ESSENTIAL_ESTIMATOR.residual:
            keep("sfm prescore", models, data[0][block], data[1][block], valid_row[block], self.threshold)
        return real_pre(self, estimator, models, data, valid_row, block)

    work = os.path.join(ROOT, "_sandbox_run")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    os.environ["LOGLEVEL"] = "WARNING"
    try:
        BatchConsensus._score_stage = score
        paths, intr, _, _ = cs.sandbox_frames(work)
        _, argv = cs.sandbox_argv(work, "run1", intr, paths[:cs.SANDBOX["run1"]])
        try:
            sandbox_app.main(argv, device=dev)
        except Done:
            pass
        BatchConsensus._score_stage = real_score
        BatchConsensus._prescore_stage = prescore
        try:
            cs.run_sfm(dev, n_frames=4)
        except Done:
            pass
    finally:
        BatchConsensus._score_stage, BatchConsensus._prescore_stage = real_score, real_pre
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    return blocks


def first_pairs(block, pairs):
    """The block's first hypotheses, at most ``pairs`` (model, match) pairs
    (the parent's blocks of ``SCORE_BLOCK``)."""
    pose, a, b, valid, thr = block
    h, m = pose.translation.shape[:2]
    keep = max(1, pairs // (m * a.shape[0]))
    return type(pose)(pose.rotation[:keep], pose.translation[:keep]), a, b, valid, thr


def torch_score(res, valid, thr):
    """The parent's ``_score_stage`` passes over one block's residuals."""
    import torch

    inliers = (res < thr) & valid & torch.isfinite(res)
    return inliers.sum(dim=-1), torch.where(inliers, res, torch.zeros_like(res)).sum(dim=-1)


def count_build(src: str) -> str:
    """``src`` with every float64 operation counted per thread into
    ``cv_ops`` (DADD, DMUL, DFMA, divisions, square roots), read by
    ``cv_count_ops``."""
    head = r"""
#include <cuda_runtime.h>
// Five counters, each spread over 32 words; a warp adds its active lanes
// once.
__device__ unsigned long long cv_ops[5 * 32];
__device__ __forceinline__ void cv_tick(int k) {
  const unsigned mask = __activemask();
  if ((threadIdx.x & 31) == __ffs(mask) - 1) atomicAdd(&cv_ops[k * 32 + (blockIdx.x & 31)], __popc(mask));
}
__device__ __forceinline__ double cv_dadd(double a, double b) { cv_tick(0); return __dadd_rn(a, b); }
__device__ __forceinline__ double cv_dsub(double a, double b) { cv_tick(0); return __dsub_rn(a, b); }
__device__ __forceinline__ double cv_dmul(double a, double b) { cv_tick(1); return __dmul_rn(a, b); }
__device__ __forceinline__ double cv_dfma(double a, double b, double c) { cv_tick(2); return __fma_rn(a, b, c); }
__device__ __forceinline__ double cv_ddiv(double a, double b) { cv_tick(3); return __ddiv_rn(a, b); }
__device__ __forceinline__ double cv_dsqrt(double a) { cv_tick(4); return __dsqrt_rn(a); }
#define __dadd_rn cv_dadd
#define __dsub_rn cv_dsub
#define __dmul_rn cv_dmul
#define __fma_rn cv_dfma
#define __ddiv_rn cv_ddiv
#define __dsqrt_rn cv_dsqrt
"""
    tail = r"""
extern "C" int cv_count_ops(unsigned long long* out, int reset) {
  unsigned long long words[5 * 32] = {};
  if (reset) return static_cast<int>(cudaMemcpyToSymbol(cv_ops, words, sizeof(words)));
  const int err = static_cast<int>(cudaMemcpyFromSymbol(words, cv_ops, sizeof(words)));
  for (int k = 0; k < 5; ++k) {
    out[k] = 0;
    for (int j = 0; j < 32; ++j) out[k] += words[k * 32 + j];
  }
  return err;
}
"""
    return head + src + tail


ONE_OP = r"""
#include <cuda_runtime.h>
extern "C" __global__ void one_div(double* x) { x[0] = __ddiv_rn(x[1], x[2]); }
extern "C" __global__ void one_sqrt(double* x) { x[0] = __dsqrt_rn(x[1]); }
"""
FP64_OPS = ("DADD", "DMUL", "DFMA")


def sass_counts(path: str, kernel_mark: str | None = None) -> dict:
    """Static counts of the float64 opcodes in the SASS of ``path``'s
    kernels (those whose name matches ``kernel_mark``, or all)."""
    from cv_tpu_torch import kernels

    tool = os.path.join(os.path.dirname(kernels.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True).stdout
    out, on = {}, kernel_mark is None
    for line in text.splitlines():
        if "Function :" in line:
            on = kernel_mark is None or re.search(kernel_mark, line) is not None
        m = re.search(r"\b(D(?:ADD|MUL|FMA|SETP|MNMX))\b", line)
        if on and m:
            out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the parent tree")
    ap.add_argument("--variants", nargs="*", default=[], help="NAME=VALUE[,NAME=VALUE] changes of jacobi.cu")
    ap.add_argument("--ablations", nargs="*", default=[], choices=sorted(ABLATIONS), help="wrong-bit timing builds")
    ap.add_argument("--blocks", action="store_true", help="also time the engine's and the sandbox's blocks")
    ap.add_argument("--whole", action="store_true", help="with --blocks, also the sandbox's whole scoring stage")
    ap.add_argument("--count", action="store_true", help="count the residual's float64 instructions")
    ap.add_argument("--edits", nargs="*", default=[], choices=sorted(EDITS), help="bitwise designs of this source")
    ap.add_argument("--sass", help="write the SASS of this tree's float64 residual entry to this file")
    ap.add_argument("--jacobi", action="store_true", help="also time the 4x4 and 9x9 Jacobi entries")
    ap.add_argument("--of", choices=("tree", "parent"), default="tree",
                    help="the source the variants and ablations edit; with parent this tree's build is not timed "
                         "(its wrappers still hold every build)")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from cv_tpu_torch import kernels
    from cv_tpu_torch.consensus import batch as cbatch
    from cv_tpu_torch.core import pose as tpose
    from cv_tpu_torch.ops import eigen

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    csrc = os.path.join(ROOT, "cv_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "jacobi.cu")).read()
    builds = {"this tree": src}
    if args.parent:
        builds["parent"] = open(os.path.join(args.parent, "cv_tpu_torch", "csrc", "jacobi.cu")).read()
    base = builds["parent"] if args.of == "parent" else src
    builds.update({spec: variant_source(base, spec) for spec in args.variants})
    header_edits = {}
    for name in args.edits:
        spec = EDITS[name]
        if isinstance(spec, dict):  # edits of headers
            header_edits[f"design {name}"] = {h: edit(open(os.path.join(csrc, h)).read(), e, every=True)
                                             for h, e in spec.items()}
            builds[f"design {name}"] = base
        else:
            builds[f"design {name}"] = edit(base, spec, every=True)
    ablated = set()
    for name in args.ablations:
        if name == "no-sweeps" and "constexpr int kSweeps" not in base:
            continue  # a run-time sweep count: the ablation is a call with 0
        builds[f"ablation {name}"] = edit(base, ABLATIONS[name], every=True)
        ablated.add(f"ablation {name}")
    base_name = "parent" if args.of == "parent" else "this tree"
    out_dir = os.path.join(ROOT, "cv_tpu_torch", "_build", "sweep")
    started = {name: build(name, text, csrc, out_dir, headers=header_edits.get(name))
               for name, text in builds.items()}
    if args.count:
        started["count"] = build("count", count_build(src), csrc, out_dir)
        one = os.path.join(out_dir, "one_op")
        os.makedirs(one, exist_ok=True)
        with open(os.path.join(one, "one.cu"), "w") as f:
            f.write(ONE_OP)
        started["one op"] = (subprocess.Popen(
            [kernels.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-cubin", "-o",
             os.path.join(one, "one.cubin"), os.path.join(one, "one.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), os.path.join(one, "one.cubin"))
    libs = {}
    for name, (proc, path) in started.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        if name != "one op":
            print(f"{name}:", resources(log), flush=True)
            libs[name] = ctypes.CDLL(path)
    if args.sass:
        from cv_tpu_torch import kernels as _k

        tool = os.path.join(os.path.dirname(_k.nvcc()), "cuobjdump")
        text = subprocess.run([tool, "-sass", started["this tree"][1]], capture_output=True, text=True).stdout
        keep, out = False, []
        for line in text.splitlines():
            if "Function :" in line:
                keep = re.search(r"c2c_residual_kernelIdE", line) is not None
            if keep:
                out.append(line)
        with open(args.sass, "w") as f:
            f.write("\n".join(out))
        ops = collections.Counter(m.group(1) for m in (re.search(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", x)
                                                          for x in out) if m)
        print(f"SASS of this tree's float64 residual entry: {sum(ops.values())} instructions, "
              f"{dict(ops.most_common(40))}", flush=True)
    if args.count:
        print(f"SASS float64 opcodes, this tree's residual entry: {sass_counts(started['this tree'][1], 'c2c_residual')}"
              f"; score entry: {sass_counts(started['this tree'][1], 'c2c_score')}; a division "
              f"{sass_counts(started['one op'][1], 'one_div')}, a square root "
              f"{sass_counts(started['one op'][1], 'one_sqrt')}", flush=True)

    rng = np.random.default_rng(17)
    inputs = {"c2c_block": (*cs.c2c_block(dev, rng), None, None)}
    if args.blocks:
        recorded = record_blocks(dev)
        for label, block in recorded.items():
            whole = block
            pose, a, b, valid, thr = block
            h, m = pose.translation.shape[:2]
            if h * m * a.shape[0] > cbatch.SCORE_BLOCK:
                inputs[f"{label}, one block"] = first_pairs(block, cbatch.SCORE_BLOCK)
                if args.whole:
                    inputs[f"{label}, whole"] = whole
            else:
                inputs[f"{label}, whole"] = whole
        inputs["c2c_block"] = (*inputs["c2c_block"][:3], torch.ones(1024, dtype=torch.bool, device=dev),
                               recorded["sandbox score"][4] if "sandbox score" in recorded else 1e-3)
    for label, (pose, a, b, valid, thr) in inputs.items():
        h, m = pose.translation.shape[:2]
        print(f"input {label}: {h} x {m} models against {a.shape[0]} matches, {h * m * a.shape[0]} pairs"
              + (f", threshold {thr!r}, {int(valid.sum())} valid rows" if valid is not None else ""), flush=True)

    # Each build's runs: residual (and score) on each input, held bitwise.
    def bound(fn, *args):
        """``fn(*args, stream)`` with each tensor argument passed as its
        pointer, the arguments fixed now (the closure keeps the tensors
        alive) and the stream read at each call (``device_ms`` captures on a
        stream of its own)."""
        ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args]

        def run():
            assert args
            return fn(*ptrs, kernels.current_stream(dev))
        return run

    runs = {name: {} for name in libs if name != "count" and not (args.of == "parent" and name == "this tree")}
    for label, (pose, a, b, valid, thr) in inputs.items():
        rot = pose.rotation.reshape(-1, 9).contiguous()
        tr = pose.translation.reshape(-1, 3).contiguous()
        want = tpose.c2c_residual(pose, a, b)
        want_score = None
        if valid is not None and hasattr(tpose, "c2c_score"):
            want_score = tpose.c2c_score(pose, a, b, valid, thr)
        valid8 = valid.to(torch.uint8).contiguous() if valid is not None else None
        if valid is not None and hasattr(tpose, "c2c_score"):
            # This tree's score entry against its plain version on the
            # block's first hypotheses (the plain residual takes seconds).
            cut = first_pairs((pose, a, b, valid, thr), 1 << 20)
            got_c, got_t = tpose.c2c_score(*cut)
            plain_c, plain_t = tpose.c2c_score_plain(*cut)
            cs.require(torch.equal(got_c, plain_c) and cs.same_bits_any(got_t, plain_t),
                       f"this tree's score entry on {label}: bitwise equal to c2c_score_plain")
            print(f"this tree's score entry on {label}'s first {got_c.numel()} models: bitwise equal to the plain "
                  "version", flush=True)
        for name, lib in libs.items():
            if name not in runs:
                continue
            bsrc = builds[name]
            out = torch.empty_like(want)
            fres = residual_fn(lib, bsrc)(6)
            run = bound(fres, rot, tr, a, b, out, rot.shape[0], a.shape[0])
            run()
            torch.cuda.synchronize()
            if name not in ablated:
                cs.require(cs.same_bits_any(out, want), f"jacobi.cu build {name} on {label}: residual bitwise")
            runs[name][("residual", label)] = run
            fs = score_fn(lib)
            if valid is not None and fs is not None:
                counts = torch.empty(rot.shape[0], dtype=torch.int64, device=dev)
                totals = torch.empty(rot.shape[0], dtype=torch.float64, device=dev)
                chunks = max(1, -(-a.shape[0] // tpose.score_chunk(a.shape[0])))
                part = (torch.empty(rot.shape[0] * chunks, dtype=torch.float64, device=dev),
                        torch.empty(rot.shape[0] * chunks, dtype=torch.int64, device=dev))
                arrived = torch.zeros(rot.shape[0], dtype=torch.int32, device=dev)

                def run_s(run=bound(fs, rot, tr, a, b, valid8, thr, rot.shape[0], a.shape[0], counts, totals, *part,
                                    arrived), arrived=arrived):
                    arrived.zero_()  # as the wrapper's zeros: one launch
                    run()
                run_s()
                torch.cuda.synchronize()
                if name not in ablated and want_score is not None:
                    cs.require(torch.equal(counts, want_score[0].reshape(-1))
                               and cs.same_bits_any(totals, want_score[1].reshape(-1)),
                               f"jacobi.cu build {name} on {label}: score bitwise")
                runs[name][("score", label)] = run_s
            elif valid is not None and fs is None:
                # The parent's scoring: its residual entry, then the torch passes.
                vv = valid

                def run_p(run=run, out=out, vv=vv, thr=thr):
                    run()
                    torch_score(out, vv, thr)
                runs[name][("score", label)] = run_p
        if "ablation no-sweeps" not in builds and "no-sweeps" in args.ablations:
            out0 = torch.empty_like(want)
            f0 = residual_fn(libs[base_name], builds[base_name])(0)
            runs.setdefault("ablation no-sweeps", {})[("residual", label)] = bound(
                f0, rot, tr, a, b, out0, rot.shape[0], a.shape[0])
        del want

    if args.jacobi:
        m = torch.as_tensor(cs.symmetric_batch(rng, cs.JACOBI_TIMED, 4)[:cs.JACOBI_TIMED], device=dev)
        m9 = {k: torch.as_tensor(cs.symmetric_batch(rng, k, 9)[:k], device=dev) for k in N9}
        for label, x, n, sweeps in [("jacobi 4x4", m, 4, 6)] + [(f"jacobi 9x9 at {k}", m9[k], 9, 8) for k in N9]:
            w0, v0 = eigen.eigh_small(x, sweeps)
            for name, lib in libs.items():
                if name not in runs:
                    continue
                jac = lib.cv_jacobi_f64
                jac.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                w, v = torch.empty_like(w0), torch.empty_like(v0)
                run = bound(jac, x, w, v, x.shape[0], n, sweeps)
                run()
                torch.cuda.synchronize()
                if name not in ablated:
                    cs.require(cs.same_bits_any(w, w0) and cs.same_bits_any(v, v0),
                               f"jacobi.cu build {name}: {label} bitwise")
                runs[name][("jacobi", label)] = run

    times = {name: {key: [] for key in r} for name, r in runs.items()}
    order = list(runs)
    for turn in (order, order[::-1]):
        for name in turn:
            for key, run in runs[name].items():
                times[name][key].append(cs.device_ms(run, iters=5))
    for key in sorted({k for r in runs.values() for k in r}):
        base = times.get("parent", {}).get(key)
        for name in order:
            if key in times[name]:
                t = times[name][key]
                rel = f" ({statistics.mean(t) / statistics.mean(base):.3f}x the parent)" if base else ""
                print(f"{key[0]} on {key[1]}: {name} {[round(x, 4) for x in t]} ms device{rel}", flush=True)

    if args.count:
        lib = libs["count"]
        lib.cv_count_ops.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for label, (pose, a, b, valid, thr) in inputs.items():
            rot = pose.rotation.reshape(-1, 9).contiguous()
            tr = pose.translation.reshape(-1, 3).contiguous()
            out = torch.empty(pose.translation.shape[:2] + (a.shape[0],), dtype=torch.float64, device=dev)
            buf = (ctypes.c_ulonglong * 5)()
            lib.cv_count_ops(buf, 1)
            residual_fn(lib, builds["this tree"])(6)(rot.data_ptr(), tr.data_ptr(), a.data_ptr(), b.data_ptr(),
                                                      out.data_ptr(), rot.shape[0], a.shape[0],
                                                      kernels.current_stream(dev))
            torch.cuda.synchronize()
            lib.cv_count_ops(buf, 0)
            pairs = out.numel()
            names = ("DADD", "DMUL", "DFMA", "division", "square root")
            print(f"float64 operations a pair on {label} (counted build, residual entry): "
                  + ", ".join(f"{n} {buf[i] / pairs:.2f}" for i, n in enumerate(names)), flush=True)

    # The branch mix of the designs' Jacobi: the plain float64 angle,
    # wrapped to record which rotations take the converged form.
    for label, block in inputs.items():
        pose, a, b = first_pairs(block, 1 << 20)[:3]
        design = tpose.c2c_design(pose, a, b).reshape(-1, 4, 4)[: 1 << 20]
        masks, angle = [], eigen._angle_f64

        def recording(apq, app, aqq):
            masks.append(eigen._converged(2.0 * apq, eigen._ftz(aqq - app)))
            return angle(apq, app, aqq)

        eigen._angle_f64 = recording
        try:
            eigen.eigh_small_plain(design[: design.shape[0] // 32 * 32])
        finally:
            eigen._angle_f64 = angle
        fast = torch.stack(masks).reshape(6, 6, -1)  # sweep, pair, matrix
        warps = fast.reshape(6, 6, -1, 32)
        every, some = warps.all(-1), warps.any(-1)
        print(f"branch mix on {label}'s designs: " + "; ".join(
            f"sweep {s} converged {float(fast[s].float().mean()):.4f}, warps all "
            f"{float(every[s].float().mean()):.4f}, mixed {float((some[s] & ~every[s]).float().mean()):.4f}"
            for s in range(6)), flush=True)


if __name__ == "__main__":
    main()
