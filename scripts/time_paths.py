#!/usr/bin/env python3
"""Time the user paths (describe, pose, SfM, the vslam-sandbox app) for one
or more checkouts of the repo, on one CUDA card.

Per checkout (``--roots``, each the root of a tree such as the parent
commit unpacked with ``git archive`` into the git-ignored ``_parent/``),
one process imports that tree's ``cv_tpu_torch`` and ``chip_smoke.py``,
builds its kernels and times, warm, host milliseconds that end in a
synchronize (medians):

* ``kitti_extract_match``: chip_smoke.py's KITTI slice, the pair as B=8 at
  ``Akaze.sparse()``, 256 / 512, extract then ratio match (10 reps);
* ``kitti_describe``: that extract's describe stage (``'pgather'``, 5 reps
  of ``chip_smoke.staged``);
* ``dense_extract`` and ``dense_describe``: the pair as B=2 at ``Akaze()``
  with ``chip_smoke.DENSE`` (``'pgroups'``; 5 reps each), and
  ``pfused_describe``: the same describe in mode ``'pfused'`` (the fused
  kernel, 5 reps);
* ``exact_sparse`` and ``exact_default``: ``AkazeExtractor`` a KITTI frame
  at ``Akaze.sparse()`` and ``Akaze()``, the mean over the two frames of
  each frame's median of 3;
* ``kitti_scale_space`` and ``dense_scale_space``: those extracts' scale
  space stage (``build_scale_space``, 5 reps of ``chip_smoke.staged``);
  ``exact_scale_space``: ``build_scale_space`` of one KITTI frame as
  ``AkazeExtractor(Akaze())`` builds it, the mean over the two frames of
  each frame's median of 5;
* ``pose_pipeline``: chip_smoke.py's consensus on the KITTI pair 0 with
  the engine's eight-point estimator (``DEFAULT_ESSENTIAL_ESTIMATOR``, with
  its ``score`` where the tree has one), 512 hypotheses, float64; median of
  5;
* ``sfm_init`` and ``sfm_init_two_view``: the SfM configuration's timed pass
  (``chip_smoke.run_sfm``, after a warm pass): the engine's init phase and,
  inside it, its ``init_two_view`` calls (summed ms); ``sfm_pass`` and
  ``sfm_ba_filter``: that pass's wall ms and its BA+filter phase (the
  engine's ``_dispatch_ba_filter`` and ``_finish_ba_filter``);
  ``sfm_extract``: its extract phase (the engine's ``prefetch_extract``
  and ``kps_descriptors``); ``sfm_graph_ba``: the
  ``device_refine.graph_ba_core`` calls made inside
  that phase (``ba_filter``'s), each timed between two synchronizes,
  ``sfm_filter_tail``: the phase less them, ``sfm_graph_ba_calls``: their
  count;
* ``init_two_view_sandbox``: one ``init_two_view`` of that engine's first
  two frames at the vslam-sandbox app's two-view budget (8,192 hypotheses,
  two refit rounds of 1,024; median of 3);
* ``sandbox_run1_*`` and ``sandbox_run2_*``: the extract phase and the
  BA+filter phase split as the SfM pass's, for the vslam-sandbox app at its
  defaults
  (``chip_smoke.SANDBOX``: run 1 maps frames 0-7 and saves, run 2 resumes
  on 8-11), with the phase times of ``chip_smoke.sandbox_hooks``.

``--only`` names the groups to time (``describe``: the KITTI, dense and
exact extracts; ``pose``; ``sfm``; ``sandbox``), all of them by default.
The roots run in the order given (for a comparison: parent, this tree,
this tree, parent), one process each.  Prints one line per run, then one
JSON object: per root the mean of its runs and, where two roots are named,
``ratio``: the second root's mean over the first's, per metric.

Usage: python3 scripts/time_paths.py --roots _parent . . _parent
       python3 scripts/time_paths.py --only sfm sandbox --roots _parent . . _parent
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

BA_SPLIT = ("ba_filter", "graph_ba", "filter_tail", "graph_ba_calls")
GROUPS = {
    "describe": ("kitti_extract_match", "kitti_describe", "dense_extract", "dense_describe", "pfused_describe",
                 "exact_sparse", "exact_default", "kitti_scale_space", "dense_scale_space", "exact_scale_space"),
    "pose": ("pose_pipeline",),
    "sfm": ("sfm_init", "sfm_init_two_view", "sfm_pass", "sfm_extract", "init_two_view_sandbox")
    + tuple(f"sfm_{m}" for m in BA_SPLIT),
    "sandbox": tuple(f"sandbox_{run}_{m}" for run in ("run1", "run2") for m in ("extract",) + BA_SPLIT),
}


def child(root: str, only) -> dict:
    """The times of the tree at ``root`` (run in a process of its own) for
    the groups ``only``."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from cv_tpu_torch import kernels
    from cv_tpu_torch.akaze import Akaze, AkazeExtractor, DeviceExtractor, load_gray, to_gray_f32
    from cv_tpu_torch.akaze.scale_space import build_scale_space
    from cv_tpu_torch.apps import vslam_sandbox
    from cv_tpu_torch.camera import CameraIntrinsics
    from cv_tpu_torch.consensus import BatchConsensus
    from cv_tpu_torch.matching import PAD_DISTANCE, distance_matrix, knn2
    from cv_tpu_torch.sfm import VSlam, device_refine
    from cv_tpu_torch.sfm.engine import DEFAULT_ESSENTIAL_ESTIMATOR as estimator
    from cv_tpu_torch.utils import KITTI_INTRINSICS, kitti_pair

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.build_all()
    pair = np.stack([to_gray_f32(load_gray(p)) for p in kitti_pair()])
    images = torch.as_tensor(np.concatenate([pair] * (cs.BATCH // 2)), device=dev)
    dense_images = torch.as_tensor(pair, device=dev)
    extractor = DeviceExtractor(Akaze.sparse(), candidate_budget=256, max_features=512, device=dev)
    dense = DeviceExtractor(Akaze(), device=dev, **cs.DENSE)

    def extract_and_match():
        fs = extractor.extract(images)
        words = fs.words.reshape(cs.BATCH // 2, 2, -1, 16)
        valid = fs.valid.reshape(cs.BATCH // 2, 2, -1)
        d = distance_matrix(words[:, 0], words[:, 1])
        d = torch.where(valid[:, 0, :, None] & valid[:, 1, None, :], d, PAD_DISTANCE)
        idx, dd = knn2(d)
        return idx, (dd[..., 0].float() < dd[..., 1].float() * 0.5) & valid[:, 0]

    out = {}
    if "describe" in only:
        for _ in range(2):
            extract_and_match()
            dense.extract(dense_images)
        out["kitti_extract_match"] = statistics.median(cs.wall_ms(extract_and_match, reps=10))
        stages = cs.staged(extractor, images, "pgather", reps=5)[1]
        out["kitti_describe"], out["kitti_scale_space"] = stages["describe"], stages["scale_space"]
        out["dense_extract"] = statistics.median(cs.wall_ms(lambda: dense.extract(dense_images), reps=5))
        stages = cs.staged(dense, dense_images, "pgroups", reps=5)[1]
        out["dense_describe"], out["dense_scale_space"] = stages["describe"], stages["scale_space"]
        out["pfused_describe"] = cs.staged(dense, dense_images, "pfused", reps=5)[1]["describe"]
        frames = [load_gray(p) for p in kitti_pair()]
        for label, cfg in (("exact_sparse", Akaze.sparse()), ("exact_default", Akaze())):
            ex = AkazeExtractor(cfg, device=dev)
            for img in frames:
                ex.extract(img)
            out[label] = statistics.mean(statistics.median(cs.wall_ms(lambda img=img: ex.extract(img), reps=3))
                                         for img in frames)
        ex = AkazeExtractor(Akaze(), device=dev)
        grays = [torch.as_tensor(to_gray_f32(img), device=dev)[None] for img in frames]
        out["exact_scale_space"] = statistics.mean(statistics.median(cs.wall_ms(
            lambda g=g: build_scale_space(ex.config, ex.specs(*g.shape[-2:]), g), reps=5)) for g in grays)

    if "pose" in only:  # chip_smoke.py's consensus on pair 0
        fs = extractor.extract(images)
        idx, keep = extract_and_match()
        intr = CameraIntrinsics.from_values(*KITTI_INTRINSICS, device=dev)
        ia = torch.nonzero(keep[0])[:, 0]
        data = (intr.calibrate(fs.point[0][ia].double()), intr.calibrate(fs.point[1][idx[0, :, 0][ia]].double()))
        consensus = BatchConsensus(threshold=0.1, hypotheses=512, device=dev)

        def pose():
            return consensus.model_inliers(torch.Generator(device=dev).manual_seed(0), estimator, data)

        pose()
        out["pose_pipeline"] = statistics.median(cs.wall_ms(pose, reps=5))

    # The graph BA calls inside ba_filter, each between two synchronizes.
    timed_ba = {"on": False, "ms": 0.0, "calls": 0}
    real_core, real_filter = device_refine.graph_ba_core, device_refine.ba_filter

    def core(*a, **kw):
        if not timed_ba["on"]:
            return real_core(*a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_core(*a, **kw)
        torch.cuda.synchronize()
        timed_ba["ms"] += (time.perf_counter() - t0) * 1e3
        timed_ba["calls"] += 1
        if hasattr(real_core, "launches"):  # a kernel wrapper counts on the name it is bound to
            real_core.launches += core.launches
            core.launches = 0
        return res

    def ba_filter(*a, **kw):
        timed_ba["on"] = True
        try:
            return real_filter(*a, **kw)
        finally:
            timed_ba["on"] = False

    def split(prefix, phase_ms):
        out[f"{prefix}_ba_filter"] = phase_ms
        out[f"{prefix}_graph_ba"] = timed_ba["ms"]
        out[f"{prefix}_filter_tail"] = phase_ms - timed_ba["ms"]
        out[f"{prefix}_graph_ba_calls"] = timed_ba["calls"]
        timed_ba.update(ms=0.0, calls=0)

    core.launches = 0
    device_refine.graph_ba_core, device_refine.ba_filter = core, ba_filter

    if "sfm" in only:
        # The SfM configuration: its init phase and init_two_view calls in
        # the timed pass, then one init_two_view at the sandbox's budget.
        two_view = {"ms": 0.0}
        real = VSlam.init_two_view

        def timed(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real(self, *a, **kw)
            torch.cuda.synchronize()
            two_view["ms"] += (time.perf_counter() - t0) * 1e3
            return res

        cs.run_sfm(dev)
        timed_ba.update(ms=0.0, calls=0)
        VSlam.init_two_view = timed
        try:
            engine, pass_s, phase_ms, _ = cs.run_sfm(dev, timed_phases=True)
        finally:
            VSlam.init_two_view = real
        out["sfm_init"], out["sfm_init_two_view"] = phase_ms["init"], two_view["ms"]
        out["sfm_pass"], out["sfm_extract"] = pass_s * 1e3, phase_ms["extract"]
        split("sfm", phase_ms["ba+filter"])
        engine.two_view_consensus = BatchConsensus(threshold=engine.settings.two_view_consensus_threshold,
                                                   hypotheses=8192, refit_rounds=2, refit_hypotheses=1024,
                                                   device=dev)
        frames = sorted(engine.data.frames)[:2]
        engine.init_two_view(*frames)
        out["init_two_view_sandbox"] = statistics.median(cs.wall_ms(lambda: engine.init_two_view(*frames), reps=3))

    if "sandbox" in only:
        work = os.path.join(os.path.abspath(root), "_sandbox_run")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        paths, intrinsics, _, _ = cs.sandbox_frames(work)
        first = cs.SANDBOX["run1"]
        timed_ba.update(ms=0.0, calls=0)
        for run, frames in (("run1", paths[:first]), ("run2", paths[first:])):
            _, argv = cs.sandbox_argv(work, run, intrinsics, frames)
            with cs.sandbox_hooks(dev) as hooks:
                vslam_sandbox.main(argv, device=dev)
                torch.cuda.synchronize()
            out[f"sandbox_{run}_extract"] = sum(hooks["ms"]["extract"])
            split(f"sandbox_{run}", sum(hooks["ms"]["ba+filter"]))
        shutil.rmtree(work, ignore_errors=True)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--roots", nargs="+", default=["."], help="checkout roots, timed in this order")
    parser.add_argument("--only", nargs="+", choices=list(GROUPS), default=list(GROUPS), help="groups to time")
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child, args.only)))
        return
    metrics = tuple(m for g in args.only for m in GROUPS[g])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    runs = {root: [] for root in args.roots}
    for root in args.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", os.path.abspath(root),
                               "--only", *args.only],
                              capture_output=True, text=True, cwd=os.path.abspath(root))
        if proc.returncode != 0:
            raise SystemExit(f"time_paths: the run of {root} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[root].append(times)
        print(f"{root}: " + ", ".join(f"{k} {times[k]:.3f}" for k in metrics))
    means = {root: {k: statistics.mean(r[k] for r in rs) for k in metrics} for root, rs in runs.items()}
    result = {"card": smi, "runs": runs, "means": means}
    roots = list(means)
    if len(roots) == 2:
        first, second = roots
        result["ratio"] = {k: means[second][k] / means[first][k] for k in metrics if means[first][k]}
        print(f"{second} over {first}: " + ", ".join(f"{k} {v:.4f}" for k, v in result["ratio"].items()))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
