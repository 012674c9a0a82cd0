#!/usr/bin/env python3
"""Smoke run of cv_tpu_torch on one CUDA card.

Drives the port's two main paths:

* the two-frame KITTI pipeline at full resolution (1392x512) with the pair
  stacked four times as a batch of 8: ``DeviceExtractor(Akaze.sparse(),
  256, 512).extract`` -> Lowes-ratio 0.5 Hamming matching of consecutive
  frames -> eight-point ``BatchConsensus(threshold=0.1, hypotheses=512)``
  on pair 0 in float64;
* the SfM engine, frame by frame through ``VSlam.add_frame``, on the
  repo's "vslam-sandbox end-to-end SfM" configuration (bench.py:569-643):
  12 rendered 512x640 star-field frames, ``FastAkazeExtractor`` at 1024
  features, the settings below, nothing cut.

Phases, in order; any failed check raises and the script exits non-zero:
  1. require CUDA, turn TF32 off, print the card's name and power limit;
  2. build every kernel of both paths from the sources in the checkout,
     one nvcc per source, all started together;
  3. hold each kernel against its plain PyTorch version at the main paths'
     shapes and time both: the select kernel bitwise; the pose-optimizer
     loops A (single_view_l2, N=2048), B (three_view_l2, N=1024) and C
     (three_view_adaptive, K=64, N=64) within 1e-6 after one step, 1e-4
     after a full run (2,000 / 2,000 / 1,000 steps), and bitwise equal to
     themselves with 60 padded invalid rows;
  4. drive the KITTI path once with the launch counters at zero: gates
     [399, 343] keypoints, 11 matches, 11 inliers, the select kernel
     launched twice per extract;
  5. drive the SfM engine: one warm pass, then one timed pass with the
     counters at zero, each with a fresh engine: one reconstruction of all
     12 frames, ATE / trajectory extent < 0.02 after Umeyama alignment,
     every consecutive relative rotation < 1 degree, an empty
     ``sanity_check``, kernels A, B and C launched, the select kernel on
     every frame;
  6. hold the card's output against the port's CPU path on small inputs:
     every word row equal;
  7. time warm extract+match, each stage, the dedup scan and consensus.
The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BATCH = 8
KITTI_KEYPOINTS = [399, 343]
KITTI_MATCHES = 11
KITTI_INLIERS = 11
SFM_FRAMES = 12
SFM_SETTINGS = dict(
    akaze_threshold=0.001,
    tracking_features=1024,
    two_view_minimum_robust_matches=32,
    optimization_iterations=256,
    three_view_patience=4000,
    single_view_patience=4000,
    constraint_patience=1000,
    tracking_recent_frames=8,
)
# Pose-optimizer kernels: (engine shape, full-run steps).
POSE_KERNELS = {
    "single_view_l2": dict(n=2048, steps=2000, replaces="cv_tpu/optimize/pallas_loop.py:312"),
    "three_view_l2": dict(n=1024, steps=2000, replaces="cv_tpu/optimize/pallas_loop.py:661"),
    "three_view_adaptive": dict(k=64, n=64, steps=1000, replaces="cv_tpu/optimize/pallas_loop.py:538"),
}


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds of ``fn()`` over ``iters`` launches."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def wall_ms(fn, reps=5):
    """Host milliseconds of ``fn()`` ending in a device sync, per rep."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def pose_problem(name, seed):
    """A seeded problem at the engine's shape for pose kernel ``name``, as
    float32 numpy arrays (poses near the truth, noisy bearings)."""
    import numpy as np

    from cv_tpu_torch.core.lie import so3_exp
    import torch

    rng = np.random.default_rng(seed)
    spec = POSE_KERNELS[name]

    def rot(w):
        return so3_exp(torch.tensor(w, dtype=torch.float64)).numpy()

    def bearing(v):
        v = v + rng.normal(0.0, 1e-3, v.shape)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    if name == "single_view_l2":
        n = spec["n"]
        pts = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
        r, t = rot([0.05, -0.1, 0.04]), np.array([0.3, -0.1, 0.05])
        return dict(
            rot=rot([0.08, -0.07, 0.06]), t=t + 0.05, bear=bearing(pts @ r.T + t),
            wp=np.concatenate([pts, np.ones((n, 1))], axis=1), valid=np.ones(n, bool),
        )

    def three_view(n):
        pts = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
        obs = np.zeros((n, 3, 3))
        poses = []
        for i, c in enumerate(([0, 0, 0], [0.4, 0, 0.05], [0.8, 0.05, 0.1])):
            r = rot(np.array([0.02, -0.03, 0.01]) * i)
            obs[:, i] = bearing((pts - np.array(c, float)) @ r.T)
            poses.append((r, -r @ np.array(c, float)))
        return dict(r1=poses[1][0], t1=poses[1][1] + 0.03, r2=poses[2][0], t2=poses[2][1] - 0.02,
                    obs=obs, valid=np.ones(n, bool))

    if name == "three_view_l2":
        return three_view(spec["n"])
    probs = [three_view(spec["n"]) for _ in range(spec["k"])]
    for j, pr in enumerate(probs):
        pr["valid"][spec["n"] - j % 16:] = False  # ragged problem sizes
    return {key: np.stack([pr[key] for pr in probs]) for key in probs[0]}


def pad_problem(name, prob, extra):
    """``prob`` with ``extra`` invalid rows appended (values 0.5/1.0)."""
    import numpy as np

    out = dict(prob)
    axis = 1 if name == "three_view_adaptive" else 0
    keys = ("bear", "wp", "valid") if name == "single_view_l2" else ("obs", "valid")
    for key in keys:
        shape = list(prob[key].shape)
        shape[axis] = extra
        fill = False if key == "valid" else (1.0 if key == "wp" else 0.5)
        out[key] = np.concatenate([prob[key], np.full(shape, fill, prob[key].dtype)], axis=axis)
    return out


def run_pose(name, prob, steps, dev, plain):
    """Run kernel ``name`` (or its plain version) on ``prob`` in float32 on
    ``dev``; returns all pose numbers as one float64 numpy vector."""
    import numpy as np
    import torch

    from cv_tpu_torch.core.pose import CameraToCamera, WorldToCamera
    from cv_tpu_torch.optimize import optimizers, resident

    def t(a):
        return torch.tensor(a, dtype=torch.bool if a.dtype == bool else torch.float32, device=dev)

    if name == "single_view_l2":
        fn = optimizers.single_view_simple_optimize_l2 if plain else resident.single_view_l2
        poses = [fn(WorldToCamera(rotation=t(prob["rot"]), translation=t(prob["t"])),
                    t(prob["bear"]), t(prob["wp"]), t(prob["valid"]), 1e-3, steps)]
    else:
        pair = (CameraToCamera(rotation=t(prob["r1"]), translation=t(prob["t1"])),
                CameraToCamera(rotation=t(prob["r2"]), translation=t(prob["t2"])))
        if name == "three_view_l2":
            fn = optimizers.three_view_simple_optimize_l2 if plain else resident.three_view_l2
            poses = fn(pair, t(prob["obs"]), t(prob["valid"]), 1e-3, steps)
        else:
            fn = optimizers.three_view_adaptive_optimize_l2 if plain else resident.three_view_adaptive
            poses = fn(pair, t(prob["obs"]), t(prob["valid"]), steps)
    torch.cuda.synchronize()
    return np.concatenate([np.concatenate([p.rotation.cpu().numpy().ravel(), p.translation.cpu().numpy().ravel()])
                           for p in poses]).astype(np.float64)


def check_pose_kernels(dev, seed):
    """Phase 3 for kernels A, B, C: gates against the plain versions on the
    card and alternating timings of full runs.  Returns per-kernel records."""
    import numpy as np

    out = {}
    for i, (name, spec) in enumerate(POSE_KERNELS.items()):
        prob = pose_problem(name, seed + i)
        max_err = 0.0
        for steps, tol in ((1, 1e-6), (spec["steps"], 1e-4)):
            got = run_pose(name, prob, steps, dev, plain=False)
            ref = run_pose(name, prob, steps, dev, plain=True)
            err = float(np.abs(got - ref).max())
            require(np.isfinite(got).all() and err <= tol, f"{name} {steps} steps within {tol} (max |err| {err})")
            print(f"{name} vs plain, {steps} steps: max |err| {err:.3e} (gate {tol})")
            max_err = max(max_err, err)
        a = run_pose(name, prob, spec["steps"], dev, plain=False)
        b = run_pose(name, pad_problem(name, prob, 60), spec["steps"], dev, plain=False)
        require(np.array_equal(a, b), f"{name}: 60 padded invalid rows change the result")
        print(f"{name}: bitwise equal with 60 padded invalid rows")
        # Alternate plain, kernel, kernel, plain; full runs, 3 reps each.
        reps = []
        for plain in (True, False, False, True):
            reps.append(wall_ms(lambda: run_pose(name, prob, spec["steps"], dev, plain), reps=3))
        pms = statistics.median(reps[0] + reps[3])
        kms = statistics.median(reps[1] + reps[2])
        print(f"{name} full run ({spec['steps']} steps): kernel {kms:.3f} ms, plain {pms:.3f} ms (median of 6)")
        out[name] = dict(max_abs_err=max_err, ms=kms, plain_ms=pms)
    return out


def umeyama(src, dst):
    """Similarity (s, R, t) minimizing ||s R src + t - dst|| (tests/test_sfm.py)."""
    import numpy as np

    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    u, d, vt = np.linalg.svd(xd.T @ xs / len(src))
    sgn = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sgn[2, 2] = -1.0
    r = u @ sgn @ vt
    s = np.trace(np.diag(d) @ sgn) / ((xs**2).sum() / len(src))
    return s, r, mu_d - s * r @ mu_s


def run_sfm(dev, n_frames=SFM_FRAMES, timed_phases=False):
    """One pass of the SfM configuration through ``VSlam.add_frame`` with a
    fresh engine, pipelined as bench.py does (frame n+1's extraction is
    enqueued before frame n's engine work).  Returns ``(engine, seconds,
    phase_ms, true_poses)``; ``phase_ms`` sums host time (synchronized) per
    engine phase when ``timed_phases``."""
    import torch

    from cv_tpu_torch.apps.synth import render_sequence
    from cv_tpu_torch.camera import CameraIntrinsics, CameraIntrinsicsK1Distortion
    from cv_tpu_torch.sfm import VSlam, VSlamSettings

    images, (fx, fy, cx, cy), true_poses = render_sequence(
        n_frames=n_frames, height=512, width=640, n_points=900, seed=0
    )
    engine = VSlam(settings=VSlamSettings(**SFM_SETTINGS), seed=0, device=dev)
    intr = CameraIntrinsicsK1Distortion.new(CameraIntrinsics.from_values(fx, fy, cx, cy, device=dev), 0.0)
    phase_ms = {"extract": 0.0, "init": 0.0, "registration": 0.0, "ba+filter": 0.0}
    if timed_phases:
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

        def wrap(method, phase):
            real = getattr(engine, method)

            def timed(*a, **kw):
                sync()
                t0 = time.perf_counter()
                out = real(*a, **kw)
                sync()
                phase_ms[phase] += (time.perf_counter() - t0) * 1e3
                return out

            setattr(engine, method, timed)

        for method, phase in (("prefetch_extract", "extract"), ("kps_descriptors", "extract"),
                              ("init_reconstruction", "init"), ("register_frame", "registration"),
                              ("_dispatch_ba_filter", "ba+filter"), ("_finish_ba_filter", "ba+filter")):
            wrap(method, phase)
    feed = engine.add_feed(intr)
    t0 = time.perf_counter()
    token = engine.prefetch_extract(feed, images[0])
    for nxt in images[1:]:
        nxt_token = engine.prefetch_extract(feed, nxt)
        engine.add_frame(feed, token)
        token = nxt_token
    engine.add_frame(feed, token)
    engine.flush_pending()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return engine, time.perf_counter() - t0, phase_ms, true_poses


def sfm_gates(engine, true_poses, n_frames=SFM_FRAMES):
    """The gates of tests/test_sfm.py:620-674; returns (views, landmarks,
    ate / extent, worst consecutive rotation error in degrees)."""
    import numpy as np

    from cv_tpu_torch.sfm import se3

    require(len(engine.data.reconstructions) == 1, f"{len(engine.data.reconstructions)} reconstructions")
    rec_key = next(iter(engine.data.reconstructions))
    rec = engine.data.reconstructions[rec_key]
    est = {engine.data.frames[v.frame].feed_frame: v.pose for v in rec.views.values()}
    require(len(est) == n_frames, f"only {len(est)}/{n_frames} frames registered")

    def center(pose):
        return -pose[0].T @ pose[1]

    est_c = np.stack([center(est[i]) for i in range(n_frames)])
    true_c = np.stack([center(true_poses[i]) for i in range(n_frames)])
    s, r, t = umeyama(est_c, true_c)
    resid = (s * est_c @ r.T + t) - true_c
    ate = float(np.sqrt((resid**2).sum(axis=1).mean()))
    extent = float(np.linalg.norm(true_c.max(axis=0) - true_c.min(axis=0)))
    require(ate / extent < 0.02, f"ATE / extent {ate / extent:.4f}")
    worst = 0.0
    for i in range(n_frames - 1):
        est_rel = se3.compose(est[i + 1], se3.inverse(est[i]))
        true_rel = se3.compose(true_poses[i + 1], se3.inverse(true_poses[i]))
        worst = max(worst, float(np.rad2deg(np.linalg.norm(se3.so3_log(est_rel[0].T @ true_rel[0])))))
    require(worst < 1.0, f"consecutive rotation error {worst:.4f} deg")
    problems = engine.sanity_check(rec_key)
    require(problems == [], f"sanity_check: {problems[:3]}")
    return len(rec.views), len(rec.landmarks), ate / extent, worst


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this runs only on a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cv_tpu_torch import kernels
    from cv_tpu_torch.akaze import Akaze, DeviceExtractor, extrema, load_gray, to_gray_f32
    from cv_tpu_torch.akaze import fast as fast_mod
    from cv_tpu_torch.akaze.scale_space import build_scale_space
    from cv_tpu_torch.akaze.select import select_samples, select_samples_plain
    from cv_tpu_torch.camera import CameraIntrinsics
    from cv_tpu_torch.consensus import BatchConsensus, Estimator
    from cv_tpu_torch.core import Isometry3, camera_to_camera_residual
    from cv_tpu_torch.matching import PAD_DISTANCE, distance_matrix, knn2
    from cv_tpu_torch.optimize import optimizers, resident
    from cv_tpu_torch.solvers import eight_point
    from cv_tpu_torch.utils import KITTI_INTRINSICS, kitti_pair

    # -- 1. the card -------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # -- 2. build: one nvcc per source, all started together ----------------
    t_build = time.perf_counter()
    for name, rec in kernels.build_all().items():
        print(f"build {name}: {rec['seconds']:.2f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build all kernels: {time.perf_counter() - t_build:.2f} s wall")

    # -- 3. kernel against its plain version at the main path's shapes ------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n_lvl, hp, wp, k_kp = BATCH * 13, 512, 1408, BATCH * 512
    planes = torch.randn((n_lvl, 3, hp, wp), generator=gen, device=dev)

    def rand_i32(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    lvl = rand_i32(n_lvl, (k_kp,))
    y0 = rand_i32(hp - 128 + 1, (k_kp,))
    x0 = rand_i32(wp - 128 + 1, (k_kp,))
    kernel_ms = plain_ms = max_err = 0.0
    for c0, ns in ((1, 109), (0, 441)):
        rel_x, rel_y = rand_i32(128, (k_kp, ns)), rand_i32(128, (k_kp, ns))
        run_k = lambda: select_samples(planes, lvl, y0, x0, rel_x, rel_y, c0=c0)  # noqa: E731
        run_p = lambda: select_samples_plain(planes, lvl, y0, x0, rel_x, rel_y, c0=c0)  # noqa: E731
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        require(got.shape == ref.shape == (k_kp, 3 - c0, ns), f"select shape {tuple(got.shape)}")
        err = float((got - ref).abs().max())
        require(torch.equal(got, ref), f"select c0={c0} NS={ns} bitwise equal to plain (max |err| {err})")
        max_err = max(max_err, err)
        # Alternate plain, kernel, kernel, plain on one card.
        p1, k1, k2, p2 = cuda_ms(run_p), cuda_ms(run_k), cuda_ms(run_k), cuda_ms(run_p)
        kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
        kernel_ms += kms
        plain_ms += pms
        print(f"select c0={c0} K={k_kp} NS={ns}: bitwise equal; kernel {kms:.4f} ms, plain {pms:.4f} ms")
    del planes
    pose_records = check_pose_kernels(dev, args.seed)

    # -- 4. the KITTI path, once, with the counters at zero ------------------
    imgs = np.stack([to_gray_f32(load_gray(p)) for p in kitti_pair()] * (BATCH // 2))
    images = torch.as_tensor(imgs, device=dev)
    extractor = DeviceExtractor(Akaze.sparse(), candidate_budget=256, max_features=512, device=dev)
    intr = CameraIntrinsics.from_values(*KITTI_INTRINSICS, device=dev)
    estimator = Estimator(
        min_samples=8,
        models_per_sample=4,
        estimate=lambda s: eight_point.estimate(s[0], s[1]),
        residual=lambda m, d: camera_to_camera_residual(
            Isometry3(m.rotation[..., None, :, :], m.translation[..., None, :]), d[0], d[1]
        ),
    )
    consensus = BatchConsensus(threshold=0.1, hypotheses=512, device=dev)

    def extract_and_match(batch):
        fs = extractor.extract(batch)
        words = fs.words.reshape(BATCH // 2, 2, -1, 16)
        valid = fs.valid.reshape(BATCH // 2, 2, -1)
        d = distance_matrix(words[:, 0], words[:, 1])
        d = torch.where(valid[:, 0, :, None] & valid[:, 1, None, :], d, PAD_DISTANCE)
        idx, dd = knn2(d)
        keep = (dd[..., 0].float() < dd[..., 1].float() * 0.5) & valid[:, 0]
        return fs, idx[..., 0], keep

    def pose_pair0(fs, idx, keep):
        ia = torch.nonzero(keep[0])[:, 0]
        a = intr.calibrate(fs.point[0][ia].double())
        b = intr.calibrate(fs.point[1][idx[0][ia]].double())
        g = torch.Generator(device=dev).manual_seed(args.seed)
        model, mask, count = consensus.model_inliers(g, estimator, (a, b))
        return model, mask, count

    select_samples.launches = 0
    fs, idx, keep = extract_and_match(images)
    model, mask, count = pose_pair0(fs, idx, keep)
    torch.cuda.synchronize()
    kitti_launches = launches = select_samples.launches
    counts = fs.count.tolist()
    matches = keep.sum(dim=-1).tolist()
    print(f"main path: keypoints {counts} matches {matches} inliers {int(count)} select launches {launches}")
    require(counts == KITTI_KEYPOINTS * (BATCH // 2), f"keypoints {counts}")
    require(matches == [KITTI_MATCHES] * (BATCH // 2), f"matches {matches}")
    require(int(count) == KITTI_INLIERS, f"inliers {int(count)}")
    require(launches == 2, f"select launches {launches} (orientation + M-LDB pass)")
    require(tuple(fs.words.shape) == (BATCH, 512, 16) and fs.words.dtype == torch.int32, "words shape")
    v = fs.valid
    require(bool(torch.isfinite(fs.point[v]).all() & torch.isfinite(fs.angle[v]).all()), "finite keypoints")
    rot = model.rotation
    require(bool(torch.isfinite(rot).all()), "finite pose")
    require(
        torch.allclose(rot @ rot.T, torch.eye(3, dtype=rot.dtype, device=dev), atol=1e-6),
        "pose rotation orthonormal",
    )

    # -- 5. the SfM engine: a warm pass, then the timed main-path pass -------
    warm_engine, warm_s, _, _ = run_sfm(dev)
    print(f"sfm warm pass: {SFM_FRAMES / warm_s:.3f} fps ({warm_s:.3f} s)")
    del warm_engine
    counters = (select_samples, resident.single_view_l2, resident.three_view_l2, resident.three_view_adaptive)
    for fn in counters:
        fn.launches = 0
    # The wrappers reach their plain versions through the optimizers
    # module; count any such call during the main-path run.
    plain_calls = {}
    real_plain = {}
    for name in ("single_view_simple_optimize_l2", "three_view_simple_optimize_l2",
                 "three_view_adaptive_optimize_l2"):
        real_plain[name] = getattr(optimizers, name)
        plain_calls[name] = 0

        def counted(*a, _name=name, **kw):
            plain_calls[_name] += 1
            return real_plain[_name](*a, **kw)

        setattr(optimizers, name, counted)
    try:
        engine, sfm_s, phase_ms, true_poses = run_sfm(dev, timed_phases=True)
    finally:
        for name, fn in real_plain.items():
            setattr(optimizers, name, fn)
    sfm_launches = {fn.__name__: fn.launches for fn in counters}
    require(not any(plain_calls.values()), f"plain versions called on the card: {plain_calls}")
    views, landmarks, ate_rel, rot_deg = sfm_gates(engine, true_poses)
    print(f"sfm main path: {SFM_FRAMES / sfm_s:.3f} fps ({sfm_s:.3f} s for {SFM_FRAMES} frames), "
          f"{views} views, {landmarks} landmarks, ATE/extent {ate_rel:.5f}, "
          f"worst consecutive rotation {rot_deg:.4f} deg, launches {sfm_launches}, "
          f"plain-version calls {plain_calls}")
    print("sfm phases (ms, synchronized): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_ms.items()))
    for name in ("single_view_l2", "three_view_l2", "three_view_adaptive"):
        require(sfm_launches[name] >= 1, f"{name} launched {sfm_launches[name]} times in the SfM run")
    require(sfm_launches["select_samples"] >= 2 * SFM_FRAMES,
            f"select launched {sfm_launches['select_samples']} times for {SFM_FRAMES} frames")
    del engine

    # -- 6. the card against the port's CPU path on small inputs ------------
    rng = np.random.default_rng(args.seed + 3)
    crop = imgs[0, 128:384, 400:784]
    for name, img, cfg, cb, mf in (
        ("random 192x256", to_gray_f32(rng.uniform(0, 255, (192, 256)).astype(np.uint8)),
         Akaze(detector_threshold=0.001), 128, 256),
        ("KITTI crop 256x384", np.ascontiguousarray(crop), Akaze.sparse(), 256, 512),
    ):
        got = DeviceExtractor(cfg, cb, mf, device=dev).extract(img[None]).to_numpy()
        ref = DeviceExtractor(cfg, cb, mf, device="cpu").extract(img[None]).to_numpy()
        vg, vr = got["valid"][0], ref["valid"][0]
        require(vg.sum() == vr.sum() and vg.sum() > 10, f"{name}: counts {vg.sum()} vs {vr.sum()}")
        pg, pr = got["point"][0][vg], ref["point"][0][vr]
        dist = np.abs(pg[:, None, :] - pr[None, :, :]).max(-1)
        near = dist.argmin(1)
        require(dist.min(1).max() < 1e-3, f"{name}: points within 1e-3 px")
        rows = (got["words"][0][vg] == ref["words"][0][vr][near]).all(1).mean()
        require(rows == 1.0, f"{name}: {rows:.4f} of word rows equal")
        print(f"cpu reference {name}: {int(vg.sum())} keypoints, max point diff "
              f"{dist.min(1).max():.2e} px, word rows equal {rows:.4f}")

    # -- 7. timings --------------------------------------------------------
    for _ in range(2):
        extract_and_match(images)
    per_iter = wall_ms(lambda: extract_and_match(images), reps=10)
    med = statistics.median(per_iter)
    print(f"extract+match B={BATCH}: median {med:.3f} ms, min {min(per_iter):.3f} ms, "
          f"max {max(per_iter):.3f} ms over {len(per_iter)} reps; {BATCH * 1e3 / med:.2f} fps")

    # The scan loop runs inside stage_dedup: wrap it for the staged reps.
    scan = []
    real_scan = extrema.dedup_scan_device

    def timed_scan(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_scan(*a, **kw)
        torch.cuda.synchronize()
        scan.append(((time.perf_counter() - t0) * 1e3, int(a[-1].max())))
        return out

    cfg, k, m = extractor.config, extractor.candidate_budget, extractor.max_features
    specs = extractor.specs(*images.shape[-2:])
    stage_ms = {n: [] for n in ("scale_space", "candidates", "dedup", "refine_select", "describe", "match")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stage_ms[name].append((time.perf_counter() - t0) * 1e3)
        return out

    extrema.dedup_scan_device = timed_scan
    try:
        for _ in range(5):
            with torch.no_grad():
                planes_e = timed("scale_space", lambda: build_scale_space(cfg, specs, images))
                cand = timed("candidates", lambda: fast_mod.stage_candidates(cfg, specs, planes_e, k))
                cand = timed("dedup", lambda: fast_mod.stage_dedup(cand, k, extractor.dedup_scan_cap))
                sel = timed("refine_select", lambda: fast_mod.stage_refine_select(cfg, specs, cand, planes_e, k, m))
                words = timed("describe", lambda: fast_mod.stage_describe(cfg, planes_e, sel)).words
                words = words.reshape(BATCH // 2, 2, -1, 16)
                timed("match", lambda: knn2(distance_matrix(words[:, 0], words[:, 1])))
    finally:
        extrema.dedup_scan_device = real_scan
    for name, vals in stage_ms.items():
        print(f"stage {name}: median {statistics.median(vals):.3f} ms over {len(vals)} reps")
    print(f"dedup scan loop: median {statistics.median(s[0] for s in scan):.3f} ms, "
          f"{scan[0][1]} sequential steps")
    cons = wall_ms(lambda: pose_pair0(fs, idx, keep), reps=5)
    print(f"consensus (512 hypotheses, f64): median {statistics.median(cons):.3f} ms over {len(cons)} reps")

    records = [{
        "name": "select_samples",
        "route": "cuda",
        "source": "cv_tpu_torch/csrc/select_samples.cu",
        "replaces": "cv_tpu/akaze/pallas_mldb.py:136",
        "launches": kitti_launches + sfm_launches["select_samples"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]
    for name, spec in POSE_KERNELS.items():
        records.append({
            "name": name,
            "route": "cuda",
            "source": f"cv_tpu_torch/csrc/{name}.cu",
            "replaces": spec["replaces"],
            "launches": sfm_launches[name],
            **pose_records[name],
        })
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
