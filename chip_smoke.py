#!/usr/bin/env python3
"""Smoke run of cv_tpu_torch on one CUDA card.

Drives the port's main paths:

* the two-frame KITTI pipeline at full resolution (1392x512) with the pair
  stacked four times as a batch of 8: ``DeviceExtractor(Akaze.sparse(),
  256, 512).extract`` -> Lowes-ratio 0.5 Hamming matching of consecutive
  frames -> eight-point ``BatchConsensus(threshold=0.1, hypotheses=512)``
  on pair 0 in float64;
* the exact extractor ``AkazeExtractor`` (the engine's default, as in
  cv_tpu) on the KITTI pair at full resolution, at ``Akaze.sparse()`` and
  ``Akaze()``, with ``match_descriptors``; the apps ``kpdraw`` and the
  tutorials' chapters 2-5 on it;
* the SfM engine, frame by frame through ``VSlam.add_frame``, on the
  repo's "vslam-sandbox end-to-end SfM" configuration (bench.py:569-643):
  12 rendered 512x640 star-field frames, ``FastAkazeExtractor`` at 1024
  features (passed as ``extractor_cls``, as bench.py does), the settings
  below, nothing cut;
* the dense, engine-budget AKAZE configuration: bench.py's ``dense_anchor``
  (``DeviceExtractor(Akaze(), 2048, 4096, dedup_scan_cap=8192)`` on the
  KITTI pair, B=2, default threshold 0.001), which takes the group
  describe, the same batch through the ``'pfused'`` and ``'pallas'``
  describe modes, and ``FastAkazeExtractor(Akaze(maximum_features=8192))``
  as the engine builds it at its default ``tracking_features``;
* the SfM engine on bench.py's loop-closure scenario (bench.py:646-698):
  23 rendered 512x640 frames, two segments that form two reconstructions
  and three bridge frames that merge them (``FastAkazeExtractor`` too);
* the vslam-sandbox app (``cv_tpu_torch.apps.vslam_sandbox.main``, the
  counterpart of the Rust reference's ``vslam-sandbox``) at its own
  defaults: the exact extractor, ``VSlamSettings()`` with no settings file
  (8192 features, 1024 graph-BA iterations, patience 100,000 / 65,536) and
  the app's consensus budgets (16,384 / 8,192 hypotheses, two refit rounds
  of 1,024), on
  ``SANDBOX``'s rendered 1080x1920 frames written as PNGs; run 1 maps the
  first frames and saves vslam.cvr, run 2 resumes from it;
* the retired describe modes ``'pepatch'`` and ``'ptiles'`` (registered by
  importing ``cv_tpu_torch.experiments.mldb_losers``) on the KITTI batch
  and the dense pair, and the experiments' runs
  (``cv_tpu_torch.experiments.runs``: the composed extracts and the probe
  scripts at their own shapes).

Phases, in order; any failed check raises and the script exits non-zero:
  1. require CUDA, turn TF32 off, print the card's name and power limit;
  2. build every kernel of the paths from the sources in the checkout, one
     nvcc per source, all started together;
  3. hold each kernel against its plain PyTorch version at the main paths'
     shapes and time both: the select kernel, its patch form, the group
     select (zero rows included), the dedup scan (its keep mask and its
     slot output, on the dense candidates and on ``dedup_adversarial``'s
     set, the cache in shared and in global memory, and at a cap above the
     shared limit) and the fused describe
     bitwise (the fused describe also within its stated gates: ok flags
     equal, angles within 1e-5 rad, >= 99% of word rows bitwise equal, no
     row more than 16 of 486 bits off); the pose kernels' branch-free
     division bitwise to ``x / y`` and square root bitwise to sqrtf on
     every float of its range; the pose-optimizer loops A (single_view_l2, N=2048), B
     (three_view_l2, N=1024) and C (three_view_adaptive, K=64, N=64)
     within 1e-6 after one step, 1e-4 after a full run (2,000 / 2,000 /
     1,000 steps), A's and B's step counts (``steps_out``) equal to
     their plain versions', each bitwise equal to itself with 60 appended
     and with 60 interleaved invalid rows, its device time (``device_ms``:
     the launch in a CUDA graph) and us a step; B and C held the same way
     on a second problem in which the bearings of every row (B) or every
     fourth row (C) come from the camera centres negated, so that there the
     three triangulations of the three-view gradient pass their cheirality
     tests and the translation tangents are nonzero (checked first; on the
     first problem and on the engine's calls every triangulation fails and
     only the rotations move); C's full run there is 10 steps, as its
     translations diverge within tens (``TRANSLATING``); A and B at an
     engine-like bucket (N=1,024 with 300 / 222 valid rows scattered, the
     engine's 4,000-step cap: within 1e-4, the plain step count, bitwise
     equal to the same rows without padding) and past their shared-memory
     tiers (12,000 / 8,000 rows: 1e-6 / 1e-4, the plain step count); B at
     one row, 31 rows, no valid row and a NaN row; C at K=1, 9 ragged
     problems and a problem without valid rows; B's and C's shape cases in
     both geometries, with the padding gates; the experiments' kernels at their scripts'
     shapes: the retired selects and the probe selects and gathers
     bitwise, the trigonometry probe and the describe's trig calls
     (``ops.trig.angle_cv`` at (K, 109) and (K,), ``cos_sin`` at (K,))
     bitwise to their plain versions (``ops/trig.py``), an empty launch of
     the same library timed beside them; the float64 atan2 and cos/sin and
     the float32 atan2 of the trig kernel and the Jacobi eigensolver
     (``csrc/jacobi.cu``; N = 3, 4, 9, float32 and float64; zero, diagonal,
     repeated-eigenvalue, ``apq = 0``, rank-one, graded matrices) bitwise to
     their plain versions, and the Jacobi timed at one consensus block
     (4,194,304 4x4 float64) beside its plain version, the parent's torch
     sweep and ``torch.linalg.eigh``; the scale space's four kernels
     (``csrc/scale_space.cu``: sep_filter, evolution_flow, fed_cycle,
     detector) bitwise to their plain versions at every call of a
     ``build_scale_space`` of the KITTI pair as B=8 and as B=2, one exact
     KITTI frame, one SfM frame (512x640) and one sandbox frame
     (1080x1920), each build bitwise to those steps, each entry timed over
     the KITTI B=8 build's calls (events around the calls, and the device
     alone in a CUDA graph) beside its plain version (sep_filter also
     beside ``F.conv2d``), the whole build with the kernels and with the
     plain chain in turns, and the profiler's launches of each (at most
     ``SCALE_SPACE_MAX_LAUNCHES``); the consensus residual's entry of the
     same source (``cv_c2c_residual_f64``: the design, the Jacobi and the
     score a pair in registers) bitwise to ``pose.c2c_residual_plain`` and
     timed beside it at a block of 4,194,304 (model, match) pairs, and its
     score entry (``cv_c2c_score_f64``: each model's inlier count and total,
     no residual written) bitwise to ``pose.c2c_score_plain`` at the same
     block, both beside the parent's figures; the
     summing probes within ``probes.SUM_ATOL`` (the window, column and
     row sums also bitwise to their order mirrors); beside each kernel's time
     and its plain version's, one PyTorch call computing the same function
     where there is one (``library_ms``) and the bound; for the gather
     (``take_along``) call and device times alternated with
     ``torch.take_along_dim``'s, and thin and ragged shapes with
     out-of-range indices bitwise to its plain version;
  4. drive the KITTI path once with the launch counters at zero: gates
     [399, 343] keypoints, 11 matches, 11 inliers, the select kernel
     launched twice and the dedup kernel once per extract, the scale
     space's kernels once a step (3 / 12 / 93 / 13), the Jacobi
     kernel and the residual entry launched; the consensus's first two
     recorded residual blocks held bitwise to the plain residual (and the
     Jacobi kernel to the plain one on their designs), its first scoring
     stage rerun with the plain residual: the same model, inlier mask and
     count;
  4b. the exact extractor on the KITTI pair at full size, each threshold
     with the counters at zero: [399, 343] keypoints and 11
     ``match_descriptors`` matches at ``Akaze.sparse()``, [3425, 2908] at
     ``Akaze()`` (its word checksums printed beside cv_tpu's pinned
     31033516 / 113943370), the dedup kernel once an extract and no describe
     kernel, the extract ms a frame; the scan's calls recorded for phase 7;
     each frame at ``Akaze()`` then compared with the port's CPU run stage
     by stage (scale-space planes, keypoints, angles, word rows), each
     differing row printed with its bits, its angle on both sides, the
     M-LDB sample positions that round differently and the compared cell
     values;
  4c. the apps with the counters at zero: ``kpdraw.main`` at threshold 0.01
     on frame 0 (399 keypoints; the PNG decodes to the crosses at the
     extractor's points), tutorial chapters 2-5 (chapter 2's PNG decodes to
     its canvas, chapter 3 finds 3425 keypoints, chapters 4 and 5 the same
     symmetric matches, chapter 5 prints its inliers among them), one scan
     an extract;
  5. drive the SfM engine: one warm pass, then one timed pass with the
     counters at zero, each with a fresh engine: one reconstruction of all
     12 frames, ATE / trajectory extent < 0.02 after Umeyama alignment,
     every consecutive relative rotation < 1 degree, an empty
     ``sanity_check``, kernels A, B and C launched, the select kernel on
     every frame, the dedup kernel once per frame, the Jacobi kernel, the
     describe's trig launches, the residual entry and the graph BA kernel
     (every graph-BA call of the warm pass recorded for phase 11);
     the warm pass's first init consensus held as in phase 4; every A, B
     and C call of
     the warm pass is recorded and, after the timed pass, replayed on its
     own (calls, N, valid rows, summed device time; A's and B's steps and
     us a step); A's and B's call of fewest steps, their first call with
     each valid-row count among those of at most ``HOLD_STEPS`` steps, and
     every call of C are held to the plain version (within 1e-4; A and B
     the same step count, unless both stop by patience before the cap:
     there the float32 summation order sets the step);
  6. drive the loop-closure scenario with the counters at zero: at least
     two reconstructions during the run and fewer at the end (bench.py's
     gate), an empty ``sanity_check`` of the largest; its views beside
     cv_tpu's 13, the seconds, kernels A, B and C launched;
  6b. the vslam-sandbox app: render ``SANDBOX``'s frames and write them
     with ``write_png`` (libpng's per-row filter choice, so Average and Paeth
     rows); the compiled unfilter (``csrc/png_unfilter.cu``) bitwise to the
     plain walk and both timed; then run 1 and run 2 through ``main``, each
     with the counters at zero and every plain version counted (none may
     run, the PNG walk included): at least one reconstruction after run 1,
     an empty ``sanity_check`` of every reconstruction, each
     reconstruction's views within ``SANDBOX_POSE_GATES`` of the rendered
     poses (ATE / extent < 0.05, consecutive rotations < 1 degree),
     one PLY file a new reconstruction whose vertex count at every export
     is its robust landmarks plus 5 a camera, each new reconstruction's
     first view at identity after its normalize, ``vslam.cvr`` equal to a
     save of the live state; run 2 loads run 1's checkpoint, whose arrays equal a save
     of run 1's live state, with its intrinsics on the card; the exact
     extractor's launches (the scan once a frame over every candidate, its
     steps printed; the trig kernel, no select kernel), A's, B's and C's,
     the graph BA kernel (its calls recorded for phase 11),
     the phase times (extract, init, registration, BA+filter, normalize, export, save,
     load, PNG decode a frame), A's, B's and C's calls replayed and held
     to plain as the SfM path's are, and each run's first two-view
     consensus held as in phase 4 (the residual entry launched in run 1);
     the scan calls are replayed with phase 7's, graph BA's with phase 11's;
  7. drive the dense path, each run with the counters at zero: keypoint
     counts within bench.py's tolerance of [3425, 2908], the group select
     launched twice and the dedup kernel once; the ``'pfused'`` and
     ``'pallas'`` runs give the same counts and words within the fused
     gates; ``FastAkazeExtractor`` at 8192 features takes the group path
     and finds frame 0's count; then every select call of the KITTI path
     and of the SfM warm pass, every dedup call of the KITTI, exact, SfM
     warm, merge, sandbox and dense runs (keep mask and slot output), every
     group-select call of the dense and engine-budget runs and the fused
     describe's call of the ``'pfused'`` run (recorded where the extractor
     binds the wrappers, the counts handed on), replayed: bitwise to the
     plain version, summed device time
     per path, the selects' byte bounds (the group select's and the fused
     describe's also at 32 bytes a distinct plane sector), the scan's us a
     step and its chain floor;
  8. drive the retired modes, each run with the counters at zero:
     ``'pepatch'`` at the KITTI batch gives [399, 343] and every valid word
     row and angle bitwise equal to ``'pgather'``; ``'ptiles'`` at the
     KITTI batch and on the dense pair gives ``'pgather'``'s / ``'pgroups'``'s
     keypoints and meets the describe gates (bitwise equality printed);
     the retired selects launch the select kernel; then every experiments
     run (``runs.py``) with the counters at zero, each of its kernels
     launched;
  9. hold the card's output against the port's CPU path on small inputs:
     every word row equal (the fast path), at least 99% (the group
     describe, and the exact extractor on a KITTI crop, row for row); the
     exact extractor's whole KITTI frames at ``Akaze()`` (phase 4b): scale
     space, counts, points, angles and word rows bitwise
     (``EXACT_UNEQUAL_ROWS`` is 0); print the exact extract ms a frame;
  10. time warm extract+match, each stage, the dedup scan and consensus;
  11. the library modules, which have no kernel, on the card against the
     port's CPU path (``library_modules``): five-point at bench.py's 64 sets
     (float64, timed warm), its recovery on 64 exact sets (at least 0.9)
     and the four near-degenerate scenarios at cv_tpu's float64 floors
     0.55 / 0.55 / 0.30 / 0.80; the L1 optimizers and Levenberg-Marquardt
     on the reference tests' problems (objective reduced, within 1e-9 of
     the CPU; LM's batch within 1e-12 of the problems one at a time); the
     five triangulators within 1e-9 of the CPU; ``sharded_extract`` and
     ``sharded_consensus`` over the visible devices and over ``(cuda:0,
     cuda:0)`` bitwise to the unsharded runs; ``train_codebook`` bitwise to
     its CPU run; graph BA (``check_graph_ba``): every recorded call of the
     SfM warm pass and the sandbox runs launched on the card bitwise to the
     plain version's CPU run (run in worker processes after the timed
     phases, with nothing else running) and, over its first 16 rounds, to
     the plain version on the card, each path's summed kernel ms; at the
     largest call two launches equal, the kernel's device and call ms and
     us a round beside its chain floor (two views, two edges), the kernel
     and the plain version on the card at 128 rounds (bitwise), the plain
     version's first 16 rounds captured in a CUDA graph and replayed, and
     the launches from the profiler; then the TF32 check
     (``tf32_invariance``): the KITTI describes and a pose pipeline give
     the same bits with ``allow_tf32`` and ``"high"`` matmul precision
     turned on, and the setting is restored.
Every main-path run launches the scale space's kernels.  No main-path run
may call a kernel's plain version.  The line before the
last is the per-kernel JSON record; the last line is ``{"ok": true,
"device": {...}}``.

Usage: python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

BATCH = 8
KITTI_KEYPOINTS = [399, 343]
KITTI_MATCHES = 11
KITTI_INLIERS = 11
SFM_FRAMES = 12
DENSE_KEYPOINTS = [3425, 2908]  # tests/test_oracle.py:141, tests/test_akaze.py:121
DENSE = dict(candidate_budget=2048, max_features=4096, dedup_scan_cap=8192)  # bench.py:376-379
# Phase 3's shapes: the padded stack of one 1392x512 frame (13 levels of
# 512x1408) and the keypoints per frame of the KITTI and dense paths; and a
# dedup cap whose cache (20 B a slot) is above the 227 KB a block may hold.
SHAPES = dict(levels=13, hp=512, wp=1408, width=1392, height=512, kitti_k=512, dense_k=4096)
DEDUP_GLOBAL_CAP = 12288
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
# bench.py's loop-closure scenario (_bench_sfm_merge, bench.py:646-698):
# segment A, the far segment B, then three bridge frames between them.
MERGE_SEGMENT = 5
MERGE_SEED = 5
MERGE_SETTINGS = dict(SFM_SETTINGS, tracking_recent_frames=3, tracking_similar_frames=6,
                      tracking_similar_frame_recent_threshold=3, tracking_similar_frame_search_num=64)
MERGE_REFERENCE_VIEWS = 13  # cv_tpu's largest final reconstruction (BENCH_r05.json, sfm_merge_views)
# The vslam-sandbox app at its own defaults (cv_tpu/apps/vslam_sandbox.py, Rust vslam-sandbox/src/main.rs):
# ``VSlamSettings()`` (no settings file) and the app's consensus budgets, on rendered star-field frames at the
# frame size its default principal point (951.1, 555.1) implies and its default focals.  Run 1 maps the first
# ``run1`` frames and saves vslam.cvr; run 2 resumes from it on the next ``run2``.
SANDBOX = dict(height=1080, width=1920, fx=893.39010814, fy=898.32648616, n_points=3000, seed=0, run1=8, run2=4)
# The sandbox's pose gates against the rendered poses: ATE / trajectory extent and the worst consecutive rotation
# in degrees.  The engine's FastAkazeExtractor at the app's settings places views less tightly than the SfM
# configuration does, in cv_tpu as in the port: over engine seeds 0-2 on 8 small rendered frames both reach
# ATE / extent up to ~0.018 and rotations up to ~0.76 degree (tests/test_torch_sandbox.py::pose_spread), and
# the ratio of a reconstruction of 4 views is about twice that of 8 for the same error.  A view off by one
# frame's motion is ~0.14 of an 8-view extent.
SANDBOX_POSE_GATES = (0.05, 1.0)
# Pose-optimizer kernels: (engine shape, full-run steps).
POSE_KERNELS = {
    "single_view_l2": dict(n=2048, steps=2000, replaces="cv_tpu/optimize/pallas_loop.py:312"),
    "three_view_l2": dict(n=1024, steps=2000, replaces="cv_tpu/optimize/pallas_loop.py:661"),
    "three_view_adaptive": dict(k=64, n=64, steps=1000, replaces="cv_tpu/optimize/pallas_loop.py:538"),
}
# B's and C's problems whose translations move (pose_problem's
# ``translating``): every how many rows take the translation path, and the
# steps of the full run.  C's adaptive rate moves a pose by about the size
# of its translation each step, so a problem with translating rows diverges
# within tens of steps, in float64 too; a quarter of the rows and 10 steps
# keep it well posed.
TRANSLATING = {"three_view_l2": dict(every=1, steps=2000), "three_view_adaptive": dict(every=4, steps=10)}
# The most word rows of a whole KITTI frame of the exact extractor at
# Akaze() that may differ card to CPU, as a share of the rows: none.  The
# angles' atan2, cos and sin are ops/trig.py's on both sides (its kernel,
# csrc/trig_probe.cu, on the card), so every angle is bitwise equal too,
# and a last-ulp angle can no longer move a rounded M-LDB sample.
EXACT_UNEQUAL_ROWS = 0
# The pose kernels that report their steps (steps_out), and each kernel's
# plain version in cv_tpu_torch.optimize.optimizers.
STEPPED = ("single_view_l2", "three_view_l2")
# The most steps of an A or B engine call held to its plain version (besides
# each replay's call of fewest steps): the plain versions take about 1.5 and
# 3.4 ms a step, and the SfM path's calls stop at 4000 steps.
HOLD_STEPS = 4000
PLAIN_VERSIONS = {
    "single_view_l2": "single_view_simple_optimize_l2",
    "three_view_l2": "three_view_simple_optimize_l2",
    "three_view_adaptive": "three_view_adaptive_optimize_l2",
}
# Published peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W limit):
# HBM3 bandwidth and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Float32 operations per landmark and step of the pose loops, counted from
# csrc/single_view_l2.cu (transform, projection, world_pose_gradient) and
# csrc/pose_loops.cuh::tv_tangent_rows (three triangulations, three rotation
# gradients); estimates for the operations bound.
POSE_FLOPS = {"single_view_l2": 80, "three_view_l2": 500, "three_view_adaptive": 520}
# Float32 operations per keypoint of the fused describe (select_fused.cu):
# 109 atan2 (~25 each), 42 windows x 109 samples x 4 (two compares, two
# masked adds), 441 M-LDB positions (~20 each); an estimate.
FUSED_FLOPS = 30_000
# Float32-equivalent operations an element of csrc/trig.cuh's functions,
# counted from the source, a float64 operation as two (float64 runs at half
# float32's rate outside the tensor cores: 34 against 67 TFLOP/s on an H100
# SXM, NVIDIA's data sheet): atan2 ~35 float operations and the angle's wrap
# 2 more; cos and sin ~14 float64 operations each; the probe's four rows
# (atan2, cos, sin, mod); an estimate.
TRIG_OPS = {"angle": 37, "cos_sin": 56, "probe": 93}
# Every describe path but 'pfused' (whose kernel computes them itself)
# launches the trig kernel for its angles and for their cos and sin.
TRIG_LAUNCHED = dict(angle_cv=(1,), cos_sin=(1,))
# Float64 outside the tensor cores on an H100 SXM (NVIDIA's data sheet, at
# its 700 W limit): the Jacobi kernel's operations bound.
FP64_FLOPS = 34e12
# The Jacobi kernel's shapes: (N, sweeps, matrices held) as the port calls
# it: svd3 (3, 8), the consensus residual and the triangulators (4, 6),
# eight-point and five-point (9, 8).  The timed batch is one consensus
# block of 4x4 float64 (consensus.batch.SCORE_BLOCK pairs).
JACOBI_SHAPES = ((3, 8, 65536), (4, 6, 65536), (9, 8, 8192))
JACOBI_TIMED = 1 << 22
# Graph BA (csrc/graph_ba.cu): float64 operations (an add, multiply, fma,
# division or square root one each) counted from the source on its common
# path: an edge whose views stand (three 3x3 products, so3_log with atan2's
# ~31) and a live view (so3_exp with cos and sin's ~24, the pose product),
# and 6 a valid edge for its view's sum.  An estimate of the work, not of
# the instructions issued.
GRAPH_BA_EDGE_OPS = 194
GRAPH_BA_VIEW_OPS = 121
# Rounds at which phase 11 times the kernel beside the plain loop on the
# card at the largest call, and the rounds of the plain loop that it
# captures in one CUDA graph (where the fused products run their dense
# repair): ~27 ms a round eagerly and ~10 ms captured on an H100 at 700 W
# (PERF.md), so the 1,024 rounds of a sandbox call would take ~28 s.
GRAPH_BA_PLAIN_ROUNDS = 128
GRAPH_BA_CAPTURED_ROUNDS = 16
# Every recorded call is also held against the plain version on the card
# over its first rounds (the CPU run holds all of them).
GRAPH_BA_HELD_ROUNDS = 16
# The scale space's kernels (csrc/scale_space.cu): row -> (the dispatcher
# in ops/image.py, its plain version, the cv_tpu line it replaces).  Bytes a
# pixel: each plane read once and each output written once (a second
# output of sep_filter adds 4; a FED cycle reads lt and the flow and writes
# lt once, whatever its steps).  Float32 operations a pixel, counted from
# the plain chain: a 1-D pass of n nonzero taps 2n - 1; the flow's blur 2 x
# 9, Scharr pair 2 x 8 and pm_g2 6; a FED step's two flows a pixel (4
# each) and four adds, a cycle's steps each; the detector's five Scharr
# passes (8 each) and 3.
SCALE_SPACE_ROWS = {
    "sep_filter": ("sep_filter", "sep_filter_plain", "cv_tpu/akaze/scale_space.py:132"),
    "evolution_flow": ("evolution_flow", "evolution_flow_plain", "cv_tpu/akaze/scale_space.py:140"),
    "fed_cycle": ("fed_cycle", "fed_cycle_plain", "cv_tpu/akaze/scale_space.py:144"),
    "detector": ("detector", "detector_plain", "cv_tpu/akaze/scale_space.py:158"),
}
SCALE_SPACE_BYTES = {"evolution_flow": 12, "fed_cycle": 12, "detector": 16}
SCALE_SPACE_OPS = {"evolution_flow": 40, "fed_cycle": 12, "detector": 43}  # fed_cycle: a step
# Every extract builds a scale space: its kernels launch on every path.
SCALE_SPACE_LAUNCHED = dict(sep_filter=(3,), evolution_flow=(1,), fed_cycle=(1,), detector=(1,))
# The profiler's kernel launches of one build_scale_space at KITTI B=8 may
# not exceed this (the plain chain launches about 3,700; 178 with a FED
# step a launch).
SCALE_SPACE_MAX_LAUNCHES = 110
# The probe scripts' shapes: exp_select_kernels.py / exp_bisect.py (a
# (16, 3, 544, 1408) stack, 136x128 windows, NS=1280, K=4096 / 512) and
# exp_r3_gather_probe.py / exp_r3_mxu_probe.py (K=4096 patches of 3x128x128,
# NS=512).
PROBE_SHAPES = dict(levels=16, hmax=544, wmax=1408, window_k=4096, window_ns=1280, bisect_k=512, patch_k=4096,
                    patch_ns=512)
# The experiments' probe kernels: record name -> (source, the TPU kernel
# it replaces).
EXPERIMENT_KERNELS = {
    "select_samples_epatch": ("select_samples", "experiments/pallas_mldb_losers.py:79"),
    "select_samples_tiles": ("select_samples", "experiments/pallas_mldb_losers.py:192"),
    "select_samples_tiles8": ("select_samples", "experiments/pallas_mldb_losers.py:301"),
    "select_window[exp_select_kernels]": ("select_samples", "experiments/exp_select_kernels.py:67"),
    "select_samples_patch[phase_select]": ("select_samples", "experiments/exp_r3_gather_probe.py:105"),
    "take_along[phase_lane]": ("take_along", "experiments/exp_r3_gather_probe.py:51"),
    "take_along[phase_sublane]": ("take_along", "experiments/exp_r3_gather_probe.py:71"),
    "trig_probe": ("trig_probe", "experiments/exp_r5_pfused.py:28"),
    "bisect_dma_only": ("select_probes", "experiments/exp_bisect.py:75"),
    "bisect_matmul_static": ("select_probes", "experiments/exp_bisect.py:86"),
    "bisect_matmul_dyn_oh": ("select_probes", "experiments/exp_bisect.py:110"),
    "bisect_split_nomm": ("select_probes", "experiments/exp_bisect.py:132"),
    "bisect_vpu_rowstage": ("select_probes", "experiments/exp_bisect.py:153"),
    "mxu_dots": ("select_probes", "experiments/exp_r3_mxu_probe.py:50"),
    "mxu_dotsbig": ("select_probes", "experiments/exp_r3_mxu_probe.py:67"),
    "mxu_onehot": ("select_probes", "experiments/exp_r3_mxu_probe.py:87"),
    "mxu_split": ("select_probes", "experiments/exp_r3_mxu_probe.py:99"),
    "mxu_dma": ("select_probes", "experiments/exp_r3_mxu_probe.py:117"),
}


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def same_bits(a, b):
    """Two float32 tensors bitwise equal, a NaN only by position."""
    import torch

    nan = torch.isnan(b)
    return bool(torch.equal(torch.isnan(a), nan)
                and torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


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


def device_ms(fn, iters=20):
    """Mean device milliseconds of ``fn()`` without the host's dispatch:
    ``iters`` calls captured in one CUDA graph (a ctypes launch on the
    current stream is captured like any other), the graph replayed between
    two events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / iters
    del graph
    return ms


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


def pose_problem(name, seed, n=None, k=None, translating=0):
    """A seeded problem at the engine's shape for pose kernel ``name`` (at
    ``n`` landmarks, and ``k`` problems for C, when given), as float32
    numpy arrays (poses near the truth, noisy bearings).  C's problems have
    ragged valid-row counts.  B and C: with the camera centres as given,
    every triangulation of the three-view gradient fails its cheirality
    test, as on the engine's calls, and only the rotations move; with
    ``translating`` > 0 the bearings of every ``translating``-th row are
    made from the centres negated, so there the three triangulations pass
    and the translation tangents are nonzero."""
    import numpy as np

    from cv_tpu_torch.core.lie import so3_exp
    import torch

    rng = np.random.default_rng(seed)
    spec = POSE_KERNELS[name]
    n = n or spec["n"]

    def rot(w):
        return so3_exp(torch.tensor(w, dtype=torch.float64)).numpy()

    def bearing(v):
        v = v + rng.normal(0.0, 1e-3, v.shape)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    if name == "single_view_l2":
        pts = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
        r, t = rot([0.05, -0.1, 0.04]), np.array([0.3, -0.1, 0.05])
        return dict(
            rot=rot([0.08, -0.07, 0.06]), t=t + 0.05, bear=bearing(pts @ r.T + t),
            wp=np.concatenate([pts, np.ones((n, 1))], axis=1), valid=np.ones(n, bool),
        )

    def three_view(n):
        pts = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
        negated = (np.arange(n) % translating == 0)[:, None] if translating else False
        obs = np.zeros((n, 3, 3))
        poses = []
        for i, c in enumerate(([0, 0, 0], [0.4, 0, 0.05], [0.8, 0.05, 0.1])):
            r, c = rot(np.array([0.02, -0.03, 0.01]) * i), np.array(c, float)
            obs[:, i] = bearing(np.where(negated, pts + c, pts - c) @ r.T)
            poses.append((r, -r @ c))
        return dict(r1=poses[1][0], t1=poses[1][1] + 0.03, r2=poses[2][0], t2=poses[2][1] - 0.02,
                    obs=obs, valid=np.ones(n, bool))

    if name == "three_view_l2":
        return three_view(n)
    probs = [three_view(n) for _ in range(k or spec["k"])]
    for j, pr in enumerate(probs):
        pr["valid"][n - j % 16:] = False  # ragged problem sizes
    return {key: np.stack([pr[key] for pr in probs]) for key in probs[0]}


def pad_problem(name, prob, extra, interleave=False):
    """``prob`` with ``extra`` invalid rows (values 0.5/1.0) appended, or,
    with ``interleave``, inserted at seeded random places among its rows."""
    import numpy as np

    out = dict(prob)
    axis = 1 if name == "three_view_adaptive" else 0
    keys = ("bear", "wp", "valid") if name == "single_view_l2" else ("obs", "valid")
    n = prob["valid"].shape[axis]
    at = np.sort(np.random.default_rng(n + extra).integers(0, n + 1, extra)) if interleave else np.full(extra, n)
    for key in keys:
        fill = False if key == "valid" else (1.0 if key == "wp" else 0.5)
        out[key] = np.insert(prob[key], at, fill, axis=axis)
    return out


def valid_rows_only(name, prob):
    """``prob`` without its invalid rows (one problem: A or B)."""
    keys = ("bear", "wp", "valid") if name == "single_view_l2" else ("obs", "valid")
    return {key: (v[prob["valid"]] if key in keys else v) for key, v in prob.items()}


def translation_rows(prob):
    """A B or C problem at its start poses, through the plain functions in
    float64 on the CPU: per triangulation of the three-view gradient (p_f,
    p_s, p_c) the valid rows that pass its cheirality test, and the norms of
    the summed translation tangents of both poses."""
    import torch

    from cv_tpu_torch.core.pose import CameraToCamera
    from cv_tpu_torch.geom import epipolar

    def t(a):
        return torch.tensor(a, dtype=torch.float64)

    ftoc = CameraToCamera(rotation=t(prob["r1"]), translation=t(prob["t1"])).inverse()
    stoc = CameraToCamera(rotation=t(prob["r2"]), translation=t(prob["t2"])).inverse()
    obs, valid = t(prob["obs"]), torch.tensor(prob["valid"])
    c = obs[..., 0, :]
    f = (ftoc.rotation[..., None, :, :] * obs[..., 1, None, :]).sum(dim=-1)
    s = (stoc.rotation[..., None, :, :] * obs[..., 2, None, :]).sum(dim=-1)
    ft, st = ftoc.translation[..., None, :], stoc.translation[..., None, :]
    rows = [int((epipolar.two_view_same_space_triangulate_sine_l1(d, a, b)[1] & valid).sum())
            for d, a, b in ((-st, c, s), (-ft, c, f), (-(st - ft), f, s))]
    (t1, _), (t2, _) = epipolar.three_view_gradients(c, f, ft, s, st)
    sums = [float(torch.where(valid[..., None], x, 0.0).sum(dim=-2).norm()) for x in (t1, t2)]
    return rows, sums


def pose_call(name, prob, steps, dev, plain, **kw):
    """A function of no arguments that runs kernel ``name`` (or its plain
    version) on ``prob`` in float32 on ``dev`` and returns its poses; the
    inputs go to the device once.  ``kw`` goes to the call (A and B:
    ``steps_out``)."""
    import torch

    from cv_tpu_torch.core.pose import CameraToCamera, WorldToCamera
    from cv_tpu_torch.optimize import optimizers, resident

    def t(a):
        return torch.tensor(a, dtype=torch.bool if a.dtype == bool else torch.float32, device=dev)

    if name == "single_view_l2":
        fn = optimizers.single_view_simple_optimize_l2 if plain else resident.single_view_l2
        args = (WorldToCamera(rotation=t(prob["rot"]), translation=t(prob["t"])),
                t(prob["bear"]), t(prob["wp"]), t(prob["valid"]), 1e-3, steps)
        return lambda: [fn(*args, **kw)]
    pair = (CameraToCamera(rotation=t(prob["r1"]), translation=t(prob["t1"])),
            CameraToCamera(rotation=t(prob["r2"]), translation=t(prob["t2"])))
    if name == "three_view_l2":
        fn = optimizers.three_view_simple_optimize_l2 if plain else resident.three_view_l2
        args = (pair, t(prob["obs"]), t(prob["valid"]), 1e-3, steps)
    else:
        fn = optimizers.three_view_adaptive_optimize_l2 if plain else resident.three_view_adaptive
        args = (pair, t(prob["obs"]), t(prob["valid"]), steps)
    return lambda: list(fn(*args, **kw))


def flat_poses(poses):
    """One pose or a sequence of poses -> all their numbers as one float64
    numpy vector."""
    import numpy as np

    from cv_tpu_torch.core.pose import Isometry3

    poses = [poses] if isinstance(poses, Isometry3) else poses
    return np.concatenate([np.concatenate([p.rotation.double().cpu().numpy().ravel(),
                                           p.translation.double().cpu().numpy().ravel()]) for p in poses])


def run_pose(name, prob, steps, dev, plain, **kw):
    """Run kernel ``name`` (or its plain version) on ``prob`` in float32 on
    ``dev``; returns all pose numbers as one float64 numpy vector."""
    import torch

    poses = pose_call(name, prob, steps, dev, plain, **kw)()
    torch.cuda.synchronize()
    return flat_poses(poses)


def hold_pose(name, label, prob, steps, dev, tol):
    """Kernel ``name`` against its plain version on ``prob``: within ``tol``
    and, for A and B, the same step count.  Returns the kernel's poses
    (numpy), its steps (``steps`` for C) and the largest difference."""
    import numpy as np
    import torch

    kw_k, kw_p = ({"steps_out": torch.zeros(1, dtype=torch.int32, device=dev)} if name in STEPPED else {}
                  for _ in range(2))
    got = run_pose(name, prob, steps, dev, plain=False, **kw_k)
    ref = run_pose(name, prob, steps, dev, plain=True, **kw_p)
    err = float(np.abs(got - ref).max())
    require(np.isfinite(got).all() and err <= tol, f"{name} {label} within {tol} (max |err| {err})")
    k_steps = steps
    if name in STEPPED:
        k_steps, p_steps = int(kw_k["steps_out"].item()), int(kw_p["steps_out"].item())
        require(k_steps == p_steps, f"{name} {label}: {k_steps} steps, its plain version {p_steps}")
    print(f"{name} {label}: max |err| {err:.3e} (gate {tol})"
          + (f", {k_steps} steps as the plain version" if name in STEPPED else ""))
    return got, k_steps, err


def check_pose_arithmetic(dev, seed, n=1 << 22):
    """The pose kernels' branch-free division and square root against IEEE
    on the card.  The division (``cv_single_view_div_check``, with ``/``
    where an operand is out of its range) bitwise against ``x / y``: random
    bit patterns (every exponent, specials included), log-uniform
    magnitudes across the range's edges at 2^-60 and 2^60, and operands
    whose significand is all ones.  The square root against sqrtf on every
    float of its range (``cv_pose_fast_path_check``).  Returns the numbers
    of pairs and square roots checked."""
    import ctypes

    import torch

    from cv_tpu_torch import kernels

    gen = torch.Generator(device=dev).manual_seed(seed + 31)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    bits = torch.randint(-2**31, 2**31 - 1, (2, n), generator=gen, device=dev, dtype=torch.int32).view(torch.float32)
    mag = torch.exp2(uniform(2, n) * 140.0 - 70.0) * torch.where(uniform(2, n) < 0.5, -1.0, 1.0)
    exps = torch.randint(40, 215, (2, n), generator=gen, device=dev, dtype=torch.int32)
    ones = ((exps << 23) | 0x7FFFFF).view(torch.float32)
    fn = kernels.function("single_view_l2", "cv_single_view_div_check", [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                                                                  ctypes.c_void_p])
    for x, y in ((bits[0], bits[1]), (mag[0], mag[1]), (ones[0], mag[1]), (mag[0], ones[1]), (ones[0], ones[1])):
        x, y = x.contiguous(), y.contiguous()
        out = torch.empty_like(x)
        require(fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), n, kernels.current_stream(dev)) == 0,
                "division check launch")
        ref = x / y
        same = (out.view(torch.int32) == ref.view(torch.int32)) | (out.isnan() & ref.isnan())
        require(bool(same.all()), f"the pose kernels' division differs from x / y on {int((~same).sum())} pairs")
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    check = kernels.function("three_view_l2", "cv_pose_fast_path_check", [ctypes.c_void_p] * 2)
    require(check(bad.data_ptr(), kernels.current_stream(dev)) == 0, "fast-path check launch")
    sqrt_bad = int(bad.item())
    require(sqrt_bad == 0, f"the pose kernels' square root differs from sqrtf on {sqrt_bad} floats")
    return 5 * n, 0x7F7FFFFF - 0x0D000000 + 1


def gate_pose(name, label, prob, steps, dev):
    """Kernel ``name`` on ``prob`` against its plain version: within 1e-6
    after one step and 1e-4 after ``steps`` (A and B: the plain step
    count), and bitwise unchanged by 60 appended and by 60 interleaved
    invalid rows.  Returns the kernel's poses after ``steps``, its steps and
    the largest difference."""
    import numpy as np

    max_err = 0.0
    for n_steps, tol in ((1, 1e-6), (steps, 1e-4)):
        got, k_steps, err = hold_pose(name, f"{label}{n_steps} steps", prob, n_steps, dev, tol)
        max_err = max(max_err, err)
    for what, padded in (("60 appended", pad_problem(name, prob, 60)),
                         ("60 interleaved", pad_problem(name, prob, 60, interleave=True))):
        require(np.array_equal(got, run_pose(name, padded, steps, dev, plain=False)),
                f"{name} {label}{what} invalid rows change the result")
        print(f"{name} {label}{steps} steps: bitwise equal with {what} invalid rows")
    return got, k_steps, max_err


def translation_path(name, label, prob):
    """``prob`` (B or C) after ``translation_rows`` showed that it takes the
    translation path: each triangulation passes its cheirality test on some
    valid row, and both summed translation tangents are nonzero."""
    rows, sums = translation_rows(prob)
    require(min(rows) > 0 and min(sums) > 0,
            f"{name} {label}the translation path: p_f / p_s / p_c pass on {rows} rows, translation sums {sums}")
    print(f"{name} {label}p_f / p_s / p_c pass their cheirality test on {rows} of {int(prob['valid'].sum())} "
          f"valid rows; summed translation tangents {sums[0]:.4g} / {sums[1]:.4g}")
    return prob


def translating_problem(name, seed, label, edit=lambda prob: prob, **kw):
    """B's or C's ``pose_problem(name, seed, **kw)`` with its rows
    translating as ``TRANSLATING`` says, passed through ``edit`` and checked
    by ``translation_path``."""
    prob = edit(pose_problem(name, seed, translating=TRANSLATING[name]["every"], **kw))
    return translation_path(name, label, prob)


def both_geometries(name, seed, label, steps, edit=lambda prob: prob, **kw):
    """``[(label, problem, steps), ...]``: B's or C's ``pose_problem(name,
    seed, **kw)`` as given (rotations only, ``steps``) and translating (at
    most the steps of ``TRANSLATING``), each passed through ``edit``."""
    moving = f"{label}translating, "
    return [(label, edit(pose_problem(name, seed, **kw)), steps),
            (moving, translating_problem(name, seed, moving, edit, **kw), min(steps, TRANSLATING[name]["steps"]))]


def check_pose_kernels(dev, seed):
    """Phase 3 for kernels A, B, C: the division and square root, then per
    kernel the gates of ``gate_pose`` against its plain version on the card
    (B and C also on a problem that moves the translations), alternating
    timings of full runs (wall time of a call, the inputs' copy to the card
    and the poses' copy back included), the device time (the launch in a
    CUDA graph) and, for A and B, us a step; then each kernel's shape
    cases.  Returns per-kernel records."""
    pairs, roots = check_pose_arithmetic(dev, seed)
    print(f"pose kernels' division bitwise equal to x / y on {pairs} pairs; square root bitwise equal to sqrtf "
          f"on all {roots} floats of its range")
    out = {}
    for i, (name, spec) in enumerate(POSE_KERNELS.items()):
        prob = pose_problem(name, seed + i)
        if name != "single_view_l2":
            rows, _ = translation_rows(prob)
            print(f"{name}: p_f / p_s / p_c pass their cheirality test on {rows} of {int(prob['valid'].sum())} "
                  f"valid rows (rotations only, as on the engine's calls); timed on this problem")
        got, k_steps, max_err = gate_pose(name, "", prob, spec["steps"], dev)
        if name != "single_view_l2":
            moving = translating_problem(name, seed + i, "translating, ")
            max_err = max(max_err, gate_pose(name, "translating, ", moving, TRANSLATING[name]["steps"], dev)[2])
        # Alternate plain, kernel, kernel, plain; full runs, 3 reps each.
        reps = [wall_ms(lambda plain=plain: run_pose(name, prob, spec["steps"], dev, plain), reps=3)
                for plain in (True, False, False, True)]
        pms = statistics.median(reps[0] + reps[3])
        kms = statistics.median(reps[1] + reps[2])
        print(f"{name} full run ({spec['steps']} steps): kernel {kms:.3f} ms, plain {pms:.3f} ms (median of 6)")
        # The bound counts the steps this problem takes (the patience rule
        # may stop A and B early; hold_pose held them to the plain count)
        # over its valid landmarks.
        steps = k_steps
        dms = device_ms(pose_call(name, prob, spec["steps"], dev, plain=False), iters=3)
        extra = dict(device_ms=dms, us_per_step=dms * 1e3 / steps)
        print(f"{name}: {steps} steps; device {dms:.4f} ms, {dms * 1e3 / steps:.3f} us a step")
        SHAPE_CASES[name](dev, seed)
        nbytes = sum(v.nbytes for v in prob.values()) + 2 * 24 * 4
        flops = steps * int(prob["valid"].sum()) * POSE_FLOPS[name]
        out[name] = kernel_record(kms, pms, max_err, nbytes, flops, steps=steps, **extra)
        print(f"{name}: {steps} steps, bound {out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']}); "
              f"the chain of {steps} dependent steps bounds it")
    return out


def scatter_rows(prob, seed, rows):
    """``prob`` (one problem: A or B) with only ``rows`` seeded rows valid."""
    import numpy as np

    bucket = prob["valid"].shape[0]
    prob["valid"][:] = False
    prob["valid"][np.random.default_rng(seed).choice(bucket, rows, replace=False)] = True
    return prob


def check_bucket(name, label, prob, cap, dev):
    """An engine-like call of A or B: ``prob``, a bucket with its valid rows
    scattered, at the engine's step cap ``cap`` (partly filled register
    slots, warps that skip them, padding rows masked out), held to the plain
    version and bitwise to the kernel on the valid rows alone."""
    import numpy as np

    bucket, rows = prob["valid"].shape[0], int(prob["valid"].sum())
    what = f"{label}N={bucket}, {rows} valid rows scattered"
    got, _, _ = hold_pose(name, f"{what}, {cap} iterations", prob, cap, dev, 1e-4)
    require(np.array_equal(got, run_pose(name, valid_rows_only(name, prob), cap, dev, plain=False)),
            f"{name} {what}: the bucket's padding rows change the result")
    print(f"{name} {what}: bitwise equal to the {rows} rows alone")


def check_single_view_shapes(dev, seed, beyond=12000):
    """Kernel A where phase 3's problem does not take it: the engine-like
    bucket (1,024 rows, 300 valid), then ``beyond`` valid rows, more than
    the registers and shared memory hold (rows read from global memory each
    step)."""
    name = "single_view_l2"
    check_bucket(name, "", scatter_rows(pose_problem(name, seed + 5, n=1024), seed + 5, 300),
                 SFM_SETTINGS["single_view_patience"], dev)
    prob = pose_problem(name, seed + 6, n=beyond)
    for steps, tol in ((1, 1e-6), (300, 1e-4)):
        hold_pose(name, f"N={beyond} (global-memory tier), {steps} steps", prob, steps, dev, tol)


def check_three_view_shapes(dev, seed, beyond=8000):
    """Kernel B where phase 3's problem does not take it, in both
    geometries: the engine's bucket (1,024 rows, 222 valid, as its calls in
    the SfM pass), one row, a partial warp and ``beyond`` rows, more than
    its registers and shared memory hold, a NaN row; and no valid row.
    Each but the bucket held by ``gate_pose`` (300 steps)."""
    import numpy as np

    name = "three_view_l2"
    cap = SFM_SETTINGS["three_view_patience"]
    for label, prob, _ in both_geometries(name, seed + 5, "", cap, lambda p: scatter_rows(p, seed + 5, 222), n=1024):
        check_bucket(name, label, prob, cap, dev)

    def nan_row(prob):
        prob["obs"][17] = np.nan
        return prob

    cases = [case for n in (1, 31, beyond) for case in both_geometries(name, seed + 7, f"N={n}, ", 300, n=n)]
    cases += both_geometries(name, seed + 9, "N=200, a NaN row, ", 300, nan_row, n=200)
    none = pose_problem(name, seed + 8, n=200)
    none["valid"][:] = False
    for label, prob, steps in cases + [("N=200, no valid row, ", none, 300)]:
        gate_pose(name, label, prob, steps, dev)


def check_adaptive_shapes(dev, seed):
    """Kernel C at the engine's problem counts, in both geometries: one
    problem, nine with ragged valid rows, and four of which one has no
    valid row.  Each held by ``gate_pose`` (200 steps; translating, the 10
    of ``TRANSLATING``)."""
    name = "three_view_adaptive"

    def empty_third(prob):
        prob["valid"][2] = False
        return prob

    cases = (both_geometries(name, seed + 10, "K=1, ", 200, k=1)
             + both_geometries(name, seed + 11, "K=9, ragged, ", 200, k=9)
             + both_geometries(name, seed + 12, "K=4, one problem without valid rows, ", 200, empty_third, k=4))
    for label, prob, steps in cases:
        gate_pose(name, f"{label}N=64, ", prob, steps, dev)


SHAPE_CASES = {
    "single_view_l2": check_single_view_shapes,
    "three_view_l2": check_three_view_shapes,
    "three_view_adaptive": check_adaptive_shapes,
}


def _clone(x):
    """A copy of a call argument: tensors and poses cloned, containers
    rebuilt, anything else as it is."""
    import torch

    from cv_tpu_torch.core.pose import Isometry3

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, Isometry3):
        return type(x)(rotation=x.rotation.clone(), translation=x.translation.clone())
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def _as_f32(x):
    """A call argument with its floating tensors and poses in float32."""
    import torch

    from cv_tpu_torch.core.pose import Isometry3

    if isinstance(x, torch.Tensor):
        return x.float() if x.is_floating_point() else x
    if isinstance(x, Isometry3):
        return type(x)(rotation=x.rotation.float(), translation=x.translation.float())
    if isinstance(x, (tuple, list)):
        return type(x)(_as_f32(v) for v in x)
    return x


@contextlib.contextmanager
def recording(mod, attr, keep=_clone):
    """Record every call of ``mod.attr`` while the body runs; yields
    ``[(keep(args), kwargs clone), ...]``.  The recorder passes each call on
    and stays out of the launch counts: a wrapper counts its launches on the
    name it is bound to (here the recorder), so the recorder hands them on
    to the real function (a plain function has no count)."""
    calls = []
    real = getattr(mod, attr)

    def recorded(*a, **kw):
        calls.append((keep(a), _clone(kw)))
        out = real(*a, **kw)
        if hasattr(real, "launches"):
            real.launches += recorded.launches
            recorded.launches = 0
        return out

    recorded.launches = 0
    setattr(mod, attr, recorded)
    try:
        yield calls
    finally:
        setattr(mod, attr, real)


def keep_planes(args):
    """A select call's arguments: the plane stack by reference (the extract
    never writes it after the call), the rest cloned."""
    return (args[0],) + _clone(tuple(args[1:]))


@contextlib.contextmanager
def record_pose_calls():
    """Record the arguments (clones) of every call of kernels A, B and C
    where ``sfm/engine.py`` and ``sfm/device_refine.py`` bind the wrappers;
    yields ``{kernel name: [(args, kwargs), ...]}``."""
    from cv_tpu_torch.sfm import device_refine
    from cv_tpu_torch.sfm import engine as engine_mod

    calls = {name: [] for name in POSE_KERNELS}
    real = {}
    for mod in (engine_mod, device_refine):
        for name in POSE_KERNELS:
            if hasattr(mod, name):
                real[(mod, name)] = getattr(mod, name)

                def recorded(*a, _fn=real[(mod, name)], _name=name, **kw):
                    calls[_name].append((_clone(a), _clone(kw)))
                    return _fn(*a, **kw)

                setattr(mod, name, recorded)
    try:
        yield calls
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)


def replay_pose_calls(calls):
    """Each recorded call of A, B and C replayed under ``cuda_ms``.  Per
    kernel: the number of calls, the ranges of N and of valid rows (per
    problem for C), the summed device milliseconds; for A and B also the
    steps each call took (``steps_out``) and us a step.  Held to the plain
    version in float32 (within 1e-4; A and B also the same step count,
    unless both stop by patience before the cap): every call of C, and of
    A's and B's calls the one with the fewest steps and the first with each
    distinct count of valid rows among those of at most ``HOLD_STEPS``
    steps."""
    import numpy as np
    import torch

    from cv_tpu_torch.optimize import optimizers, resident

    out = {}
    for name, recorded in calls.items():
        fn, plain = getattr(resident, name), getattr(optimizers, PLAIN_VERSIONS[name])
        stepped = name in STEPPED
        ns, rows, ms, steps, got, firsts = [], [], [], [], [], []
        for args, kw in recorded:
            valid = args[3] if name == "single_view_l2" else args[2]
            counts = [int(v) for v in valid.reshape(-1, valid.shape[-1]).sum(dim=-1).tolist()]
            ns.append(int(valid.shape[-1]))
            rows.extend(counts)
            firsts.append(counts[0] if stepped else counts)
            ms.append(cuda_ms(lambda: fn(*args, **kw), iters=3, warmup=1))
            kw = dict(kw)
            if stepped:
                kw["steps_out"] = torch.zeros(1, dtype=torch.int32, device=valid.device)
            got.append(fn(*args, **kw))
            if stepped:
                steps.append(int(kw["steps_out"].item()))
        if stepped and recorded:
            chosen = {}
            for j, st in enumerate(steps):
                if st <= HOLD_STEPS:
                    chosen.setdefault(firsts[j], j)
            held_calls = sorted(set(chosen.values()) | {int(np.argmin(steps))})
        else:
            held_calls = range(len(recorded))
        held = {}
        for j in held_calls:
            args, kw = recorded[j]
            kw = dict(kw)
            if stepped:
                kw["steps_out"] = torch.zeros(1, dtype=torch.int32, device=valid.device)
            ref = plain(*_as_f32(args), **kw)
            err = float(np.abs(flat_poses(got[j]) - flat_poses(ref)).max())
            what = f"{name} engine call {j} ({firsts[j]} valid rows)"
            require(np.isfinite(flat_poses(got[j])).all() and err <= 1e-4,
                    f"{what} within 1e-4 of plain (max |err| {err})")
            held[j] = (err, None)
            if stepped:
                # A stop by patience (no better sum norm in PATIENCE steps)
                # at a float32 plateau depends on the summation order, so two
                # such stops may differ; a run to the cap may not.
                p_steps, cap = int(kw["steps_out"].item()), args[5 if name == "single_view_l2" else 4]
                require(steps[j] == p_steps or max(steps[j], p_steps) < cap,
                        f"{what}: {steps[j]} steps, its plain version {p_steps} (cap {cap})")
                held[j] = (err, p_steps)
        rec = dict(calls=len(recorded), n=[min(ns, default=0), max(ns, default=0)],
                   valid_rows=[min(rows, default=0), max(rows, default=0)], ms=sum(ms), held_to_plain=len(held),
                   max_abs_err=max((e for e, _ in held.values()), default=0.0))
        if stepped:
            rec["held_steps"] = {j: [steps[j], p] for j, (_, p) in held.items()}
        if stepped and recorded:
            rec.update(steps=[min(steps), max(steps)], total_steps=sum(steps), us_per_step=sum(ms) * 1e3 / sum(steps))
        out[name] = rec
        print(f"engine-shape replay {name}: {rec['calls']} calls, N {rec['n']}, valid rows {rec['valid_rows']}, "
              f"summed device time {rec['ms']:.3f} ms"
              + (f", steps {rec['steps']} ({rec['total_steps']} in all), {rec['us_per_step']:.3f} us a step"
                 if "steps" in rec else "")
              + f"; {len(held)} calls held to plain: max |err| {rec['max_abs_err']:.3e} (gate 1e-4)"
              + ("; steps, kernel / plain (" + ", ".join(f"call {j}, {firsts[j]} rows: {k} / {p}"
                                                         for j, (k, p) in rec["held_steps"].items()) + ")"
                 if stepped else ""))
    return out


def dense_ok(counts):
    """bench.py's dense_anchor tolerance: |c - a| <= max(2, 0.5% of a)."""
    return all(abs(int(c) - a) <= max(2, int(0.005 * a)) for c, a in zip(counts, DENSE_KEYPOINTS))


@contextlib.contextmanager
def main_path(counters, plains):
    """Zero every kernel counter, count calls of every plain version (the
    module attributes the wrappers call), run the body, then restore the
    plain versions.  Yields a dict that holds ``launches`` (wrapper name ->
    count) and ``plain`` (name -> calls) once the body has run."""
    import torch

    record = {}
    real = {}
    calls = {name: 0 for _, name in plains}
    for mod, name in plains:
        real[(mod, name)] = getattr(mod, name)

        def counted(*a, _fn=real[(mod, name)], _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        setattr(mod, name, counted)
    for fn in counters.values():
        fn.launches = 0
    try:
        yield record
        torch.cuda.synchronize()
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
    record["launches"] = {label: fn.launches for label, fn in counters.items()}
    record["plain"] = calls
    require(not any(calls.values()), f"plain versions called on the card: {calls}")


def describe_gates(what, words, ok, angle, words_ref, ok_ref, angle_ref):
    """The fused describe's gates between two describes of the same
    keypoints (numpy arrays): ok flags equal; on the valid rows angles
    within 1e-5 rad (2 pi wrap), >= 99% of word rows bitwise equal, no row
    more than 16 of 486 bits off.  Returns (unequal rows, rows, max bits
    off, max angle difference)."""
    import numpy as np

    require(np.array_equal(ok, ok_ref), f"{what}: ok flags differ in {int((ok != ok_ref).sum())} rows")
    v = ok_ref
    da = np.abs(angle[v] - angle_ref[v])
    da = float(np.minimum(da, 2 * np.pi - da).max()) if v.any() else 0.0
    w, wr = words[v].view(np.uint32), words_ref[v].view(np.uint32)
    unequal = int((w != wr).any(axis=1).sum())
    bits = int(np.unpackbits((w ^ wr).view(np.uint8), axis=1).sum(axis=1).max()) if v.any() else 0
    print(f"{what}: {unequal} of {int(v.sum())} valid word rows unequal, max {bits} bits off, "
          f"max angle difference {da:.3e} rad")
    require(da <= 1e-5, f"{what}: angles within 1e-5 rad (max {da:.3e})")
    require(unequal <= 0.01 * v.sum(), f"{what}: {unequal} unequal word rows")
    require(bits <= 16, f"{what}: a row {bits} bits off")
    return unequal, int(v.sum()), bits, da


def alternate(run_k, run_p, timer):
    """Times of ``run_p``, ``run_k``, ``run_k``, ``run_p`` in turn; returns
    (kernel ms, plain ms), each the mean of its two."""
    p1, k1, k2, p2 = timer(run_p), timer(run_k), timer(run_k), timer(run_p)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes, flops=0.0):
    """``(bound_ms, bound_by)``: the least time an H100 SXM could take for
    work that moves ``nbytes`` (each input read once, each output written
    once) and does ``flops`` float32 operations, the larger of the two
    against the published peaks (HBM_BYTES_PER_S, FP32_FLOPS)."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def select_bytes(k, ns, channels, per_keypoint=12):
    """Bytes a select of ``ns`` samples for each of ``k`` keypoints must
    move: per-keypoint words (lvl, y0, x0), two int32 offsets a sample, the
    sampled values and the output, ``channels`` floats each."""
    return k * per_keypoint + k * ns * 8 + 2 * k * ns * channels * 4


def group_select_bytes(ng, n_live, ns, nc, sectors=None):
    """Bytes a group select of ``ng`` groups must move: 16 bytes of tables
    a group, two int32 offsets a live sample, the plane reads (4 bytes a
    live sample and channel, or 32 bytes for each of ``sectors`` distinct
    32-byte sectors when given) and ``nc`` floats a sample for all ``ng * 8``
    slots."""
    reads = n_live * ns * nc * 4 if sectors is None else 32 * sectors
    return 16 * ng + n_live * ns * 8 + reads + ng * 8 * ns * nc * 4


def fused_bytes(k, no, ns, sectors=None):
    """Bytes the fused describe of ``k`` keypoints must move: 32 bytes of
    per-keypoint words, two int32 offsets an orientation sample, the plane
    reads (2 floats an orientation sample and 3 an M-LDB sample, or 32
    bytes for each of ``sectors`` distinct sectors when given), the (3,
    ``ns``) values and 4 meta floats."""
    reads = k * (no * 2 + ns * 3) * 4 if sectors is None else 32 * sectors
    return k * (32 + no * 8 + ns * 3 * 4 + 16) + reads


def plane_sectors(planes, lvl, c0, ys, xs, interleaved=False):
    """The distinct 32-byte sectors of ``planes`` (L, C, Hp, Wp) float32
    that reads of channels ``c0:`` at ``planes[lvl, c, ys, xs]`` touch
    (``lvl`` (N,), ``ys``/``xs`` (N, S)): a 1-D int64 tensor of sector
    numbers (the stack's base is 32-byte aligned).  ``interleaved``: the
    same reads of the pixel-interleaved stack (L, Hp, 3 * Wp), word
    ``3 * x + c`` of a row."""
    import torch

    if interleaved:
        _, h, lanes = planes.shape
        ch = torch.arange(c0, 3, device=planes.device)[None, :, None]
        addr = (lvl.long()[:, None, None] * h + ys.long()[:, None, :]) * lanes + 3 * xs.long()[:, None, :] + ch
        return torch.unique(addr // 8)
    _, c, h, w = planes.shape
    ch = torch.arange(c0, c, device=planes.device)[None, :, None]
    addr = ((lvl.long()[:, None, None] * c + ch) * h + ys.long()[:, None, :]) * w + xs.long()[:, None, :]
    return torch.unique(addr // 8)


def group_call_bounds(args, kw):
    """``(bytes at 4 a sample, bytes at 32 a sector, sectors)`` of one
    recorded ``select_groups`` call: only live slots read the planes."""
    import torch

    planes, win_lvl, win_ty, win_tx, n_active, rel_x, rel_y = args[:7]
    c0 = kw.get("c0", args[7] if len(args) > 7 else 0)
    ng, ns = win_lvl.shape[0], rel_x.shape[-1]
    rep = lambda t: t.long().repeat_interleave(8)  # noqa: E731
    live = torch.arange(8, device=planes.device).repeat(ng) < rep(n_active)
    ys = 128 * rep(win_ty)[live][:, None] + rel_y.reshape(ng * 8, ns)[live]
    xs = 128 * rep(win_tx)[live][:, None] + rel_x.reshape(ng * 8, ns)[live]
    sectors = plane_sectors(planes, rep(win_lvl)[live], c0, ys, xs).numel()
    n_live, nc = int(live.sum()), planes.shape[1] - c0
    return group_select_bytes(ng, n_live, ns, nc), group_select_bytes(ng, n_live, ns, nc, sectors), sectors


def fused_call_bounds(args, kw, meta):
    """``(bytes at 4 a sample, bytes at 32 a sector, sectors)`` of one
    recorded ``select_fused`` call whose meta rows are ``meta``: the
    orientation reads (channels 1:) and the M-LDB reads at the positions of
    the call's angles, sectors counted once over both."""
    import torch

    from cv_tpu_torch.akaze import descriptors as desc

    planes, lvl, y0, x0, orel_x, orel_y, xf, yf, scale, width, height = args[:11]
    pattern = kw.get("pattern_size", args[11] if len(args) > 11 else 10)
    rel_x, rel_y = desc.mldb_offsets(xf, yf, scale, meta[:, 0], width, height, x0, y0, desc.PATCH, pattern)[:2]
    y0, x0 = y0.long()[:, None], x0.long()[:, None]
    sectors = torch.unique(torch.cat([plane_sectors(planes, lvl, 1, y0 + orel_y, x0 + orel_x),
                                      plane_sectors(planes, lvl, 0, y0 + rel_y, x0 + rel_x)])).numel()
    k, no, ns = orel_x.shape[0], orel_x.shape[1], rel_x.shape[1]
    return fused_bytes(k, no, ns), fused_bytes(k, no, ns, sectors), sectors


def describe_call_bounds(name, args, kw, out):
    """The bounds of one recorded group-select (``out`` its values) or
    fused-describe (``out`` its ``(vals, meta)``) call."""
    return group_call_bounds(args, kw) if name == "select_groups" else fused_call_bounds(args, kw, out[1])


def same(a, b):
    """Bitwise equality of two outputs: tensors, or tuples of tensors."""
    import torch

    if isinstance(a, tuple):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def index_call(planes, rows, ys, xs, c0=0):
    """One PyTorch advanced-index call computing a select (the library
    yardstick): ``planes[rows, c, ys, xs]`` for channels ``c >= c0`` with
    ``rows`` (K,) and ``ys``/``xs`` (K, NS) built beforehand; returns a
    function of no arguments giving ``(K, C - c0, NS)``."""
    import torch

    lv = rows.long()[:, None, None]
    ch = torch.arange(c0, planes.shape[1], device=planes.device)[None, :, None]
    yy, xx = ys.long()[:, None, :], xs.long()[:, None, :]
    return lambda: planes[lv, ch, yy, xx]


def kernel_record(kms, pms, err, nbytes, flops=0.0, library_ms=None, **extra):
    """A kernel's record: its times, the library call's, and its bound."""
    ms, by = bound(nbytes, flops)
    return dict(max_abs_err=err, ms=kms, plain_ms=pms, library_ms=library_ms, bound_ms=ms, bound_by=by, **extra)


def check_select_kernels(dev, seed):
    """Phase 3 for the describe kernels: the select kernel, its patch form,
    the group select and the fused describe against their plain versions,
    at the KITTI and dense paths' shapes, with alternating timings.  Returns
    per-kernel records."""
    import numpy as np
    import torch

    from cv_tpu_torch.akaze import descriptors as desc
    from cv_tpu_torch.akaze import fused, select

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand_i32(hi, shape, lo=0):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    out = {}
    # The select kernel at the KITTI batch's shapes (B=8, 512 features).
    hp, wp = SHAPES["hp"], SHAPES["wp"]
    n_lvl, k_kp = BATCH * SHAPES["levels"], BATCH * SHAPES["kitti_k"]
    planes = torch.randn((n_lvl, 3, hp, wp), generator=gen, device=dev)
    lvl = rand_i32(n_lvl, (k_kp,))
    y0 = rand_i32(hp - 128 + 1, (k_kp,))
    x0 = rand_i32(wp - 128 + 1, (k_kp,))
    rec = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0)
    for c0, ns in ((1, 109), (0, 441)):
        rel_x, rel_y = rand_i32(128, (k_kp, ns)), rand_i32(128, (k_kp, ns))
        lib = index_call(planes, lvl, y0[:, None] + rel_y, x0[:, None] + rel_x, c0)
        run_k = lambda: select.select_samples(planes, lvl, y0, x0, rel_x, rel_y, c0=c0)  # noqa: E731
        run_p = lambda: select.select_samples_plain(planes, lvl, y0, x0, rel_x, rel_y, c0=c0)  # noqa: E731
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        require(got.shape == ref.shape == (k_kp, 3 - c0, ns), f"select shape {tuple(got.shape)}")
        err = float((got - ref).abs().max())
        require(torch.equal(got, ref), f"select c0={c0} NS={ns} bitwise equal to plain (max |err| {err})")
        require(torch.equal(lib(), got), f"select c0={c0}: the advanced-index call gives the kernel's values")
        kms, pms = alternate(run_k, run_p, cuda_ms)
        lms = cuda_ms(lib)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["ms"] += kms
        rec["plain_ms"] += pms
        rec["library_ms"] += lms
        rec["nbytes"] += select_bytes(k_kp, ns, 3 - c0)
        print(f"select c0={c0} K={k_kp} NS={ns}: bitwise equal; kernel {kms:.4f} ms, plain {pms:.4f} ms, "
              f"advanced index {lms:.4f} ms, bound {bound(select_bytes(k_kp, ns, 3 - c0))[0]:.4f} ms")
    out["select_samples"] = kernel_record(rec["ms"], rec["plain_ms"], rec["max_abs_err"], rec["nbytes"],
                                          library_ms=rec["library_ms"])

    # The same select from the pixel-interleaved stack ('+inter'), on the
    # same planes and keypoints; then an adversarial draw whose indices
    # leave the stack on every axis (NaN there, as the plain version).
    stack = planes.permute(0, 2, 3, 1).reshape(n_lvl, hp, 3 * wp).contiguous()
    rec = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0)
    for c0, ns in ((1, 109), (0, 441)):
        rel_x, rel_y = rand_i32(128, (k_kp, ns)), rand_i32(128, (k_kp, ns))
        lanes = 3 * (x0[:, None] + rel_x).long()
        lib = lambda: torch.stack([stack[lvl.long()[:, None], (y0[:, None] + rel_y).long(), lanes + c]  # noqa: E731
                                   for c in range(c0, 3)], dim=1)
        run_k = lambda: select.select_samples_interleaved(stack, lvl, y0, x0, rel_x, rel_y, c0=c0)  # noqa: E731
        run_p = lambda: select.select_samples_interleaved_plain(stack, lvl, y0, x0, rel_x, rel_y, c0=c0)  # noqa: E731
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        require(got.shape == ref.shape == (k_kp, 3 - c0, ns), f"interleaved select shape {tuple(got.shape)}")
        require(torch.equal(got, ref), f"interleaved select c0={c0} NS={ns} bitwise equal to plain")
        require(torch.equal(got, select.select_samples_plain(planes, lvl, y0, x0, rel_x, rel_y, c0=c0)),
                f"interleaved select c0={c0}: the channel-major select's values")
        require(torch.equal(lib(), got), f"interleaved select c0={c0}: the advanced-index call gives its values")
        kms, pms = alternate(run_k, run_p, cuda_ms)
        lms = cuda_ms(lib)
        rec["ms"] += kms
        rec["plain_ms"] += pms
        rec["library_ms"] += lms
        rec["nbytes"] += select_bytes(k_kp, ns, 3 - c0)
        print(f"interleaved select c0={c0} K={k_kp} NS={ns}: bitwise equal; kernel {kms:.4f} ms, plain {pms:.4f} ms, "
              f"advanced index {lms:.4f} ms, bound {bound(select_bytes(k_kp, ns, 3 - c0))[0]:.4f} ms")
    for c0, ns in ((1, 109), (0, 441)):
        bad_l, bad_y, bad_x = lvl.clone(), y0.clone(), x0.clone()
        bad_l[::97], bad_l[1::89], bad_y[2::83], bad_x[3::79], bad_x[4::73] = -1, n_lvl, -3, -1, wp - 100
        rel_x, rel_y = rand_i32(128, (k_kp, ns)), rand_i32(128, (k_kp, ns))
        rel_y[5::71] = hp
        for fn, plain, src in ((select.select_samples_interleaved, select.select_samples_interleaved_plain, stack),
                               (select.select_samples, select.select_samples_plain, planes)):
            got, ref = fn(src, bad_l, bad_y, bad_x, rel_x, rel_y, c0), plain(src, bad_l, bad_y, bad_x, rel_x, rel_y, c0)
            torch.cuda.synchronize()
            nan = int(torch.isnan(ref).sum())
            require(nan > 0 and torch.equal(got.view(torch.int32), ref.view(torch.int32)),
                    f"{fn.__name__} c0={c0}, indices outside the stack: bitwise equal to plain ({nan} NaN)")
        print(f"select and interleaved select c0={c0}, indices outside the stack: bitwise equal to plain, "
              f"{nan} NaN values")
    out["select_samples_interleaved"] = kernel_record(rec["ms"], rec["plain_ms"], 0.0, rec["nbytes"],
                                                      library_ms=rec["library_ms"])
    del planes, stack

    # The dense stack (B=2: 26 levels) and its K = 2 x 4096 keypoints.
    n_lvl, k_kp = 2 * SHAPES["levels"], 2 * SHAPES["dense_k"]
    planes = torch.randn((n_lvl, 3, hp, wp), generator=gen, device=dev)

    # Patch form (#2 / #3): the patches cut from the stack, K = 8192.
    lvl = rand_i32(n_lvl, (k_kp,))
    y0 = rand_i32(hp - 128 + 1, (k_kp,))
    x0 = rand_i32(wp - 128 + 1, (k_kp,))
    patches = select.cut_patches(planes, lvl, y0, x0)
    rec = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0)
    zero = torch.zeros_like(lvl)
    arange = torch.arange(k_kp, dtype=torch.int32, device=dev)
    for c0, ns in ((1, 109), (0, 441)):
        rel_x, rel_y = rand_i32(128, (k_kp, ns)), rand_i32(128, (k_kp, ns))
        run_k = lambda: select.select_samples_patch(patches, rel_x, rel_y, c0)  # noqa: E731
        run_p = lambda: select.select_samples_plain(patches, arange, zero, zero, rel_x, rel_y, c0)  # noqa: E731
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        direct = select.select_samples_plain(planes, lvl, y0, x0, rel_x, rel_y, c0)
        require(torch.equal(got, ref) and torch.equal(got, direct),
                f"patch-form select c0={c0} NS={ns} bitwise equal to plain and to the stack select")
        lib = index_call(patches, arange, rel_y, rel_x, c0)
        require(torch.equal(lib(), got), f"patch form c0={c0}: the advanced-index call gives the kernel's values")
        kms, pms = alternate(run_k, run_p, cuda_ms)
        lms = cuda_ms(lib)
        rec["ms"] += kms
        rec["plain_ms"] += pms
        rec["library_ms"] += lms
        rec["nbytes"] += select_bytes(k_kp, ns, 3 - c0, per_keypoint=0)
        print(f"patch-form select c0={c0} K={k_kp} NS={ns}: bitwise equal; kernel {kms:.4f} ms, "
              f"plain {pms:.4f} ms, advanced index {lms:.4f} ms")
    out["select_samples_patch"] = kernel_record(rec["ms"], rec["plain_ms"], 0.0, rec["nbytes"],
                                                library_ms=rec["library_ms"])
    del patches

    # The group select at the dense shapes: ~20% invalid slots, w 1 and 4.
    ht, wt = hp // 128, wp // 128
    kxf = torch.rand((k_kp,), generator=gen, device=dev) * SHAPES["width"]
    kyf = torch.rand((k_kp,), generator=gen, device=dev) * SHAPES["height"]
    kvalid = torch.rand((k_kp,), generator=gen, device=dev) >= 0.2
    ky0, kx0 = desc.patch_anchor(kxf, kyf, hp, wp)
    ty, tx = torch.clamp(ky0 // 128, 0, ht - 2), torch.clamp(kx0 // 128, 0, wt - 2)
    ng_cap = -(-k_kp // 8) + n_lvl * (ht - 1) * (wt - 1) + 1
    rec = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0)
    for w in (1, 4):
        tables = desc.group_tables(lvl, ty, tx, kvalid, n_lvl, ht, wt, 8, ng_cap, w)[1:5]
        ng = tables[0].shape[0]
        for c0, ns in ((1, 109), (0, 441)):
            rel_x, rel_y = rand_i32(256, (ng * 8, ns)), rand_i32(256, (ng * 8, ns))
            run_k = lambda: select.select_groups(planes, *tables, rel_x, rel_y, c0)  # noqa: E731
            run_p = lambda: select.select_groups_plain(planes, *tables, rel_x, rel_y, c0)  # noqa: E731
            got, ref = run_k(), run_p()
            torch.cuda.synchronize()
            zero_rows = int((torch.arange(8, device=dev).repeat(ng) >= tables[3].long().repeat_interleave(8)).sum())
            require(torch.equal(got, ref), f"select_groups w={w} c0={c0} NS={ns} bitwise equal to plain")
            if w == 1:
                # The library yardstick selects the live rows only.
                live = torch.arange(8, device=dev).repeat(ng) < tables[3].repeat_interleave(8)
                rep = lambda t: t.repeat_interleave(8)[live]  # noqa: E731
                lib = index_call(planes, rep(tables[0]), 128 * rep(tables[1])[:, None] + rel_y[live],
                                 128 * rep(tables[2])[:, None] + rel_x[live], c0)
                require(torch.equal(lib(), got[live]), "select_groups: the advanced-index call gives the live rows")
                kms, pms = alternate(run_k, run_p, cuda_ms)
                lms = cuda_ms(lib)
                n_live = int(live.sum())
                rec["ms"] += kms
                rec["plain_ms"] += pms
                rec["library_ms"] += lms
                rec["nbytes"] += group_select_bytes(ng, n_live, ns, 3 - c0)
                print(f"select_groups w={w} c0={c0} NG={ng} NS={ns}: bitwise equal ({zero_rows} zero rows); "
                      f"kernel {kms:.4f} ms, plain {pms:.4f} ms, advanced index over {n_live} live rows "
                      f"{lms:.4f} ms")
            else:
                print(f"select_groups w={w} c0={c0} NG={ng} NS={ns}: bitwise equal ({zero_rows} zero rows)")
    out["select_groups"] = kernel_record(rec["ms"], rec["plain_ms"], 0.0, rec["nbytes"],
                                         library_ms=rec["library_ms"])

    # The fused describe on real-sized random keypoints of the dense stack.
    width = torch.full((k_kp,), SHAPES["width"], dtype=torch.int32, device=dev)
    height = torch.full((k_kp,), SHAPES["height"], dtype=torch.int32, device=dev)
    scale = rand_i32(5, (k_kp,), lo=1).float()
    orel = desc.orientation_offsets(kxf, kyf, scale, width, height, kx0, ky0, 128)
    args = (planes, lvl, ky0, kx0, *orel, kxf, kyf, scale, width, height)
    run_k = lambda: fused.select_fused(*args)  # noqa: E731
    run_p = lambda: fused.select_fused_plain(*args)  # noqa: E731
    (vk, mk), (vp, mp) = run_k(), run_p()
    torch.cuda.synchronize()

    def words(vals, meta):
        return desc._mldb_pack(vals[:, 0], vals[:, 1], vals[:, 2], meta[:, 1:2], meta[:, 2:3], 10).cpu().numpy()

    same = int((mk == mp).all(dim=1).sum())
    print(f"select_fused K={k_kp}: angle, cos, sin and ok bitwise equal to plain on {same} of {k_kp} keypoints")
    unequal, rows, bits, da = describe_gates(
        "select_fused vs plain", words(vk, mk), (mk[:, 3] > 0.5).cpu().numpy(), mk[:, 0].cpu().numpy(),
        words(vp, mp), (mp[:, 3] > 0.5).cpu().numpy(), mp[:, 0].cpu().numpy(),
    )
    # Both sides sum the windows in one halving tree and build the same
    # float expressions (--fmad=false), so the kernel is held bitwise too.
    require(torch.equal(mk, mp) and torch.equal(vk, vp), "select_fused bitwise equal to its plain version")
    kms, pms = alternate(run_k, run_p, cuda_ms)
    print(f"select_fused K={k_kp}: bitwise equal; kernel {kms:.4f} ms, plain (two-pass) {pms:.4f} ms")
    no, ns = orel[0].shape[1], vk.shape[2]
    out["select_fused"] = kernel_record(kms, pms, da, fused_bytes(k_kp, no, ns), k_kp * FUSED_FLOPS,
                                        unequal_rows=unequal, rows=rows)
    return out


def dedup_adversarial(seed=0, c=192):
    """A dedup batch (numpy, the wrapper's argument order) built against the
    scan's class window, one frame each:

    * frame 0, class-major: eight chains, each a candidate of every class
      0-5 at one place with rising responses (even chains; odd chains drop
      their class-3 candidate), so an early slot carries its chain up through
      the classes while fillers of every class, some on the chains, append
      above it; the window of a late class then starts at an early slot and
      holds slots of older classes;
    * frame 1: runs of classes that come back after a gap (0, 1, 2, 0, 3, 1,
      4, 2, 5, 0), with chains across the runs;
    * frame 2: no order at all (a random class a candidate), with classes
      63-65 beside 0-3 (past the kernel's 64-entry class table) and a prefix
      shorter than the cap.

    About 10% of the prefix candidates are invalid; every valid one lies in
    the ``n_steps`` prefix, as stage_dedup hands them over."""
    import numpy as np

    rng = np.random.default_rng(seed + 41)
    cols = {key: np.zeros((3, c), dt) for key, dt in (("x", np.float32), ("y", np.float32), ("r", np.float32),
                                                      ("cls", np.int32))}

    def put(f, j, x, y, r, cls):
        cols["x"][f, j], cols["y"][f, j], cols["r"][f, j], cols["cls"][f, j] = x, y, r, cls

    # Frame 0: chains through classes 0-5 and fillers, class-major.
    centers = [(12.0 + 9.0 * m, 14.0 + 4.0 * (m % 3)) for m in range(8)]
    rows = []
    for e in range(6):
        cands = [(cx + rng.uniform(-0.4, 0.4), cy + rng.uniform(-0.4, 0.4), 0.05 if m % 2 and e == 3 else 0.1 + 0.1 * e,
                  e) for m, (cx, cy) in enumerate(centers)]
        cands += [(rng.uniform(5, 85), rng.uniform(5, 30), rng.uniform(0.01, 1.0), e) for _ in range(24)]
        rows += [cands[i] for i in rng.permutation(len(cands))]
    for j, cand in enumerate(rows[:c]):
        put(0, j, *cand)
    # Frame 1: classes that return after a gap.
    j = 0
    for cls, n in ((0, 24), (1, 20), (2, 20), (0, 16), (3, 20), (1, 16), (4, 20), (2, 16), (5, 20), (0, 16)):
        for i in range(n):
            if i % 4 == 0:  # on a chain centre
                cx, cy = centers[(i // 4) % len(centers)]
                put(1, j, cx + rng.uniform(-0.4, 0.4), cy + rng.uniform(-0.4, 0.4), rng.uniform(0.01, 1.0), cls)
            else:
                put(1, j, rng.uniform(5, 85), rng.uniform(5, 30), rng.uniform(0.01, 1.0), cls)
            j += 1
    # Frame 2: a random class a candidate, classes past the table included.
    classes = np.array([0, 1, 2, 3, 63, 64, 65])
    for j in range(c):
        put(2, j, rng.uniform(5, 60), rng.uniform(5, 25), rng.uniform(0.01, 1.0), rng.choice(classes))
    n_steps = np.array([c, c, c - 23], np.int32)
    shift = rng.uniform(0, 1.5, (3, c)).astype(np.float32)
    size2 = ((2.0 * 2.0 ** (np.minimum(cols["cls"], 6) / 4.0)) ** 2 * 2.0).astype(np.float32)
    valid = (rng.uniform(size=(3, c)) < 0.9) & (np.arange(c)[None, :] < n_steps[:, None])
    x, y = cols["x"], cols["y"]
    return [x, y, x + shift, y + shift, cols["r"], cols["cls"], size2, valid, n_steps]


def scan_steps(args):
    """A dedup call's steps per frame: its ``n_steps``, or the cap ``C``
    when the call passes none (the exact extractor scans every candidate)."""
    import torch

    if len(args) > 8 and args[8] is not None:
        return args[8].to(torch.int32)
    b, c = args[0].shape
    return torch.full((b,), c, dtype=torch.int32, device=args[0].device)


def scan_both(args, kw=None, **extra):
    """A dedup call's keep mask and slot output from the kernel and from the
    plain version on the same inputs, and whether both are bitwise equal."""
    import torch

    from cv_tpu_torch.akaze import extrema

    kw = {**(kw or {}), **extra, "with_slots": True}
    got = extrema.dedup_scan_device(*args, **kw)
    ref = extrema.dedup_scan_plain(*args[:8], scan_steps(args), with_slots=True)
    torch.cuda.synchronize()
    return got, ref, all(torch.equal(g, r) for g, r in zip(got, ref))


def dedup_floor(args):
    """Launch the dedup scan's chain floor (``cv_dedup_scan_floor``: the
    kernel's steps without the cache work) on a call's arguments, prepared
    as the wrapper prepares them.  A measurement: its output is not a
    dedup."""
    import torch

    from cv_tpu_torch import kernels
    from cv_tpu_torch.akaze import extrema

    floats = [t.contiguous() for t in args[:5]]
    cls, s2, ok = args[5].to(torch.int32).contiguous(), args[6].contiguous(), args[7].contiguous()
    steps = scan_steps(args).contiguous()
    b, c = floats[0].shape
    out = torch.empty((b, c), dtype=torch.bool, device=floats[0].device)
    err = kernels.function("dedup_scan", "cv_dedup_scan_floor", extrema._DEDUP_ARGS)(
        *(t.data_ptr() for t in floats), cls.data_ptr(), s2.data_ptr(), ok.data_ptr(), steps.data_ptr(),
        out.data_ptr(), b, c, -1, kernels.current_stream(floats[0].device))
    require(err == 0, f"dedup floor launch: cudaError {err}")
    return out


def plain_in_batches(calls, batch=4):
    """The plain scan's keep mask and slot output for each recorded dedup
    call, ``batch`` calls at a time as one batch of frames: the plain loop
    costs the same a step for one frame as for several, and frames are
    independent, so each call's candidates are padded with invalid ones to
    the group's longest cap (changing nothing) and its rows cut back."""
    import torch

    from cv_tpu_torch.akaze import extrema

    out = []
    for start in range(0, len(calls), batch):
        group = [args for args, _ in calls[start:start + batch]]
        cap = max(a[0].shape[1] for a in group)

        def stacked(i):
            return torch.cat([torch.nn.functional.pad(a[i], (0, cap - a[i].shape[1])) for a in group])

        mask, slots = extrema.dedup_scan_plain(*(stacked(i) for i in range(8)),
                                               torch.cat([scan_steps(a) for a in group]), with_slots=True)
        row = 0
        for a in group:
            b, c = a[0].shape
            out.append((mask[row:row + b, :c], slots[row:row + b, :c]))
            row += b
    return out


def replay_dedup(paths):
    """Each recorded dedup call (``paths``: path -> [(args, kwargs)]) held
    bitwise to the plain version, its keep mask and its slot output (the
    plain version run on a path's calls four at a time,
    ``plain_in_batches``), then timed as it was called in a CUDA graph
    (``device_ms``) with its chain floor beside it.  Per path: calls, the
    steps of the chain (the frame batch's longest prefix, summed over
    calls), the summed device ms and us a step of the kernel and of its
    floor."""
    import torch

    from cv_tpu_torch.akaze import extrema

    out = {}
    for path, calls in paths.items():
        rec = dict(calls=len(calls), steps=0, ms=0.0, floor_ms=0.0)
        for j, ((args, kw), ref) in enumerate(zip(calls, plain_in_batches(calls))):
            got = extrema.dedup_scan_device(*args, **{**kw, "with_slots": True})
            torch.cuda.synchronize()
            require(all(torch.equal(g, r) for g, r in zip(got, ref)),
                    f"dedup {path} call {j}: mask and slots bitwise equal to the plain version")
            rec["steps"] += int(scan_steps(args).max())
            rec["ms"] += device_ms(lambda a=args, kw=kw: extrema.dedup_scan_device(*a, **kw), iters=3)
            rec["floor_ms"] += device_ms(lambda a=args: dedup_floor(a), iters=3)
        steps = max(rec["steps"], 1)
        rec.update(us_per_step=rec["ms"] * 1e3 / steps, floor_us_per_step=rec["floor_ms"] * 1e3 / steps)
        out[path] = rec
        print(f"engine-call replay dedup_scan {path}: {rec['calls']} calls bitwise equal to plain (mask and slots), "
              f"{rec['steps']} steps, summed device {rec['ms']:.4f} ms ({rec['us_per_step']:.4f} us a step); "
              f"chain floor {rec['floor_ms']:.4f} ms ({rec['floor_us_per_step']:.4f} us a step)")
    return out


def replay_select(paths):
    """Each recorded select call held bitwise to the plain version, then
    timed in a CUDA graph.  Per path: calls, summed device ms, the summed
    byte bound (``select_bytes``) and its share of the time."""
    import torch

    from cv_tpu_torch.akaze import select

    out = {}
    for path, calls in paths.items():
        rec = dict(calls=len(calls), ms=0.0, bound_ms=0.0)
        for j, (args, kw) in enumerate(calls):
            got, ref = select.select_samples(*args, **kw), select.select_samples_plain(*args, **kw)
            torch.cuda.synchronize()
            require(torch.equal(got, ref), f"select {path} call {j}: bitwise equal to the plain version")
            rec["ms"] += device_ms(lambda a=args, kw=kw: select.select_samples(*a, **kw), iters=10)
            k, ns = args[4].shape
            rec["bound_ms"] += bound(select_bytes(k, ns, got.shape[1]))[0]
        rec["bound_share"] = rec["bound_ms"] / rec["ms"] if rec["ms"] else 0.0
        out[path] = rec
        print(f"engine-call replay select_samples {path}: {rec['calls']} calls bitwise equal to plain, summed "
              f"device {rec['ms']:.4f} ms, byte bound {rec['bound_ms']:.4f} ms ({100 * rec['bound_share']:.1f}%)")
    return out


def replay_interleaved(calls):
    """Each recorded interleaved select call held bitwise to its plain
    version and timed in a CUDA graph, beside #1 (the channel-major select)
    at the same call on the same planes laid out channel-major; each with
    its byte bound (``select_bytes``) and its sector bound (32 bytes for
    each distinct plane sector its reads touch, plus the offsets, words and
    output)."""
    import torch

    from cv_tpu_torch.akaze import select

    rec = dict(calls=len(calls), ms=0.0, channel_major_ms=0.0, bound_ms=0.0, sector_bound_ms=0.0,
               channel_major_sector_bound_ms=0.0, sectors=0, channel_major_sectors=0, calls_detail=[])
    for j, (args, kw) in enumerate(calls):
        stack, lvl, y0, x0, rel_x, rel_y = args[:6]
        c0 = kw.get("c0", args[6] if len(args) > 6 else 0)
        got = select.select_samples_interleaved(*args, **kw)
        ref = select.select_samples_interleaved_plain(*args, **kw)
        n_lvl, hp, lanes = stack.shape
        planes = stack.reshape(n_lvl, hp, lanes // 3, 3).permute(0, 3, 1, 2).contiguous()
        cm = select.select_samples(planes, lvl, y0, x0, rel_x, rel_y, c0)
        torch.cuda.synchronize()
        require(torch.equal(got, ref) and torch.equal(got, cm),
                f"interleaved select call {j}: bitwise equal to the plain version and to the channel-major select")
        ms = device_ms(lambda: select.select_samples_interleaved(*args, **kw), iters=10)
        cms = device_ms(lambda: select.select_samples(planes, lvl, y0, x0, rel_x, rel_y, c0), iters=10)
        k, ns = rel_x.shape
        ys, xs = y0.long()[:, None] + rel_y.long(), x0.long()[:, None] + rel_x.long()
        sec = plane_sectors(stack, lvl, c0, ys, xs, interleaved=True).numel()
        cm_sec = plane_sectors(planes, lvl, c0, ys, xs).numel()
        b4 = select_bytes(k, ns, 3 - c0)
        rest = b4 - k * ns * (3 - c0) * 4  # the words, offsets and output
        detail = dict(c0=c0, k=k, ns=ns, ms=ms, channel_major_ms=cms, bound_ms=bound(b4)[0],
                      sector_bound_ms=bound(rest + 32 * sec)[0],
                      channel_major_sector_bound_ms=bound(rest + 32 * cm_sec)[0], sectors=sec,
                      channel_major_sectors=cm_sec, sectors_per_sample=sec / (k * ns),
                      channel_major_sectors_per_sample=cm_sec / (k * ns))
        rec["calls_detail"].append(detail)
        for key in ("ms", "channel_major_ms", "bound_ms", "sector_bound_ms", "channel_major_sector_bound_ms",
                    "sectors", "channel_major_sectors"):
            rec[key] += detail[key]
        print(f"engine-call replay select_samples_interleaved kitti call {j} (c0={c0}, K={k}, NS={ns}): bitwise "
              f"equal to plain and to #1; device {ms:.4f} ms, #1 (channel-major) {cms:.4f} ms; byte bound "
              f"{detail['bound_ms']:.4f} ms; {sec} sectors ({detail['sectors_per_sample']:.3f} a sample): sector "
              f"bound {detail['sector_bound_ms']:.4f} ms; #1 {cm_sec} sectors "
              f"({detail['channel_major_sectors_per_sample']:.3f} a sample): "
              f"{detail['channel_major_sector_bound_ms']:.4f} ms")
        del planes
    rec["bound_share"] = rec["bound_ms"] / rec["ms"] if rec["ms"] else 0.0
    rec["sector_bound_share"] = rec["sector_bound_ms"] / rec["ms"] if rec["ms"] else 0.0
    print(f"engine-call replay select_samples_interleaved kitti: {rec['calls']} calls, summed device {rec['ms']:.4f} "
          "ms "
          f"(#1 at the same calls {rec['channel_major_ms']:.4f} ms); byte bound {rec['bound_ms']:.4f} ms "
          f"({100 * rec['bound_share']:.1f}%), sector bound {rec['sector_bound_ms']:.4f} ms "
          f"({100 * rec['sector_bound_share']:.1f}%; #1's {rec['channel_major_sector_bound_ms']:.4f} ms)")
    return rec


def replay_describe(paths):
    """Each recorded group-select and fused-describe call (``paths``:
    kernel -> path -> [(args, kwargs)]) held bitwise to its plain version,
    then timed in a CUDA graph.  Per kernel and path: calls, summed device
    ms, the byte bound at 4 bytes a sample and at 32 bytes a distinct plane
    sector, their shares of the time, and the sectors."""
    import torch

    from cv_tpu_torch.akaze import fused, select

    fns = {"select_groups": (select.select_groups, select.select_groups_plain),
           "select_fused": (fused.select_fused, fused.select_fused_plain)}
    out = {}
    for name, by_path in paths.items():
        kernel, plain = fns[name]
        out[name] = {}
        for path, calls in by_path.items():
            rec = dict(calls=len(calls), ms=0.0, bound_ms=0.0, sector_bound_ms=0.0, sectors=0)
            for j, (args, kw) in enumerate(calls):
                got, ref = kernel(*args, **kw), plain(*args, **kw)
                torch.cuda.synchronize()
                require(same(got, ref), f"{name} {path} call {j}: bitwise equal to the plain version")
                rec["ms"] += device_ms(lambda a=args, kw=kw: kernel(*a, **kw), iters=10)
                b4, bs, sectors = describe_call_bounds(name, args, kw, got)
                rec["bound_ms"] += bound(b4)[0]
                rec["sector_bound_ms"] += bound(bs)[0]
                rec["sectors"] += sectors
            rec["bound_share"] = rec["bound_ms"] / rec["ms"] if rec["ms"] else 0.0
            rec["sector_bound_share"] = rec["sector_bound_ms"] / rec["ms"] if rec["ms"] else 0.0
            out[name][path] = rec
            print(f"engine-call replay {name} {path}: {rec['calls']} calls bitwise equal to plain, summed device "
                  f"{rec['ms']:.4f} ms; byte bound {rec['bound_ms']:.4f} ms ({100 * rec['bound_share']:.1f}%), "
                  f"{rec['sectors']} plane sectors: sector bound {rec['sector_bound_ms']:.4f} ms "
                  f"({100 * rec['sector_bound_share']:.1f}%)")
    return out


def check_dedup_kernel(dev, seed, dense_args):
    """Phase 3 for the dedup kernel: bitwise against its plain version on
    the dense KITTI candidates (``dense_args``, as stage_dedup passed them)
    and on ``dedup_adversarial``'s set, each with the cache in shared memory
    and forced to global memory, and on a random batch whose cap is above
    the shared-memory cache size; alternating timings on the dense
    candidates."""
    import numpy as np
    import torch

    from cv_tpu_torch.akaze import extrema

    run_k = lambda: extrema.dedup_scan_device(*dense_args)  # noqa: E731
    run_p = lambda: extrema.dedup_scan_plain(*dense_args)  # noqa: E731
    got, ref = run_k(), run_p()
    torch.cuda.synchronize()
    steps = dense_args[-1].tolist()
    cap = dense_args[0].shape[1]
    require(torch.equal(got, ref), "dedup kernel bitwise equal to plain on the dense candidates")
    forced = extrema.dedup_scan_device(*dense_args, max_shared_slots=0)
    torch.cuda.synchronize()
    require(torch.equal(forced, ref), "dedup kernel with its cache forced to global memory bitwise equal to plain")
    for slots in (None, 0):
        both = scan_both(dense_args, max_shared_slots=slots)
        require(both[2] and torch.equal(both[0][0], ref),
                f"dedup kernel's mask and slot output bitwise equal to plain on the dense candidates "
                f"(max_shared_slots={slots})")
    print(f"dedup dense candidates: B={len(steps)} cap {cap} steps {steps}: bitwise equal with the cache "
          f"in shared and in global memory, the slot output too, {got.sum(dim=1).tolist()} survivors")
    kms, pms = alternate(run_k, run_p, lambda fn: wall_ms(fn, reps=1)[0])
    print(f"dedup dense: kernel {kms:.3f} ms, plain {pms:.3f} ms (host clock, plain-kernel-kernel-plain)")

    # The adversarial set (chains through the classes, classes that return,
    # no order), with the cache in shared and in global memory.
    adv = [torch.as_tensor(a, device=dev) for a in dedup_adversarial(seed)]
    ref = extrema.dedup_scan_plain(*adv)
    for slots in (None, 0):
        got_adv = extrema.dedup_scan_device(*adv, max_shared_slots=slots)
        torch.cuda.synchronize()
        require(torch.equal(got_adv, ref), f"dedup kernel bitwise equal to plain on the adversarial set "
                                           f"(max_shared_slots={slots})")
        require(scan_both(adv, max_shared_slots=slots)[2], f"dedup kernel's mask and slot output bitwise equal to "
                                                          f"plain on the adversarial set (max_shared_slots={slots})")
    print(f"dedup adversarial set B=3 cap {adv[0].shape[1]}: bitwise equal with the cache in shared and in global "
          f"memory, the slot output too, {ref.sum(dim=1).tolist()} survivors")

    rng = np.random.default_rng(seed + 11)
    b, c = 2, DEDUP_GLOBAL_CAP
    cls = np.sort(rng.integers(0, 8, (b, c)), axis=1)
    px = rng.uniform(0, SHAPES["width"], (b, c)).astype(np.float32)
    py = rng.uniform(0, SHAPES["height"], (b, c)).astype(np.float32)
    shift = rng.uniform(0, 1.5, (b, c)).astype(np.float32)
    size2 = ((2.0 * 2.0 ** (cls / 4.0)) ** 2 * 4.0).astype(np.float32)
    arrays = [px, py, px + shift, py + shift, rng.uniform(0.01, 1, (b, c)).astype(np.float32), cls, size2,
              rng.uniform(size=(b, c)) < 0.95, np.array([c, c * 5 // 6])]
    args = [torch.as_tensor(a, device=dev) for a in arrays]
    got2, ref = extrema.dedup_scan_device(*args), extrema.dedup_scan_plain(*args)
    torch.cuda.synchronize()
    require(torch.equal(got2, ref), f"dedup kernel bitwise equal to plain at cap {c} (global-memory cache)")
    require(scan_both(args)[2], f"dedup kernel's mask and slot output bitwise equal to plain at cap {c}")
    print(f"dedup random B={b} cap {c} (global-memory cache): bitwise equal, the slot output too, "
          f"{got2.sum(dim=1).tolist()} survivors")
    # Bound: every input read once and the mask written; operations, at
    # least ~8 a step for each cache slot, the cache growing to the
    # survivors (half of them on average over the steps).
    nbytes = sum(t.numel() * t.element_size() for t in dense_args) + got.numel()
    flops = sum(8 * st * int(n) / 2 for st, n in zip(steps, got.sum(dim=1).tolist()))
    rec = kernel_record(kms, pms, 0.0, nbytes, flops, steps=steps)
    print(f"dedup bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}); the chain of {max(steps)} dependent "
          "steps bounds it")
    return rec


def bisect_windows_read(planes, lvl, y0, x0):
    """The distinct floats of ``planes`` that ``exp_bisect.py``'s windows at
    ``(lvl, y0, x0)`` cover: the union of each level's 136x128 windows, in
    every channel.  Windows overlap on a level, more so with x0 aligned; a
    window that leaves the stack reads nothing."""
    import torch

    from cv_tpu_torch.experiments import probes

    n_levels, channels, height, width = planes.shape
    ok = (lvl >= 0) & (lvl < n_levels) & (y0 >= 0) & (y0 + probes.PH <= height) & (x0 >= 0) & (
        x0 + probes.PW <= width)
    lv, ys, xs = lvl[ok].long(), y0[ok].long(), x0[ok].long()
    # The windows' corners in a difference array; its 2-D prefix sum counts
    # the windows over each pixel.
    d = torch.zeros((n_levels, height + 1, width + 1), dtype=torch.int32, device=lvl.device)
    for dy, dx, sign in ((0, 0, 1), (probes.PH, 0, -1), (0, probes.PW, -1), (probes.PH, probes.PW, 1)):
        d.index_put_((lv, ys + dy, xs + dx), torch.full_like(lv, sign, dtype=torch.int32), accumulate=True)
    return channels * int((d.cumsum(1).cumsum(2) > 0).sum())


def rowstage_sectors_read(planes, lvl, y0, x0, rel_y):
    """The distinct 32-byte sectors of ``planes`` that ``exp_bisect.py``'s
    row select (``'vpu_rowstage'``) must read: for each sample of a window
    in the stack whose row lies in ``[0, PH)``, the sector that holds
    ``planes[lvl, c, y0 + row, x0]`` in every channel c, which is (level,
    channel, row, x0 >> 3) on a stack whose rows are a multiple of 8 floats.
    Windows on one level share sectors, more often with x0 aligned."""
    import torch

    from cv_tpu_torch.experiments import probes

    n_levels, channels, height, width = planes.shape
    ok = (lvl >= 0) & (lvl < n_levels) & (y0 >= 0) & (y0 + probes.PH <= height) & (x0 >= 0) & (
        x0 + probes.PW <= width)
    ry = rel_y.long()
    named = ok[:, None] & (ry >= 0) & (ry < probes.PH)
    lv, ys, xs = (t.long()[:, None].expand_as(ry)[named] for t in (lvl, y0, x0))
    rows = ys + ry[named]
    flat = torch.cat([((lv * channels + c) * height + rows) * width + xs for c in range(channels)])
    return int(torch.unique(flat >> 3).numel())


def bisect_read(body, planes, lvl, y0, x0, rel_y):
    """What ``bisect_work`` takes of a draw: the distinct 32-byte sectors
    for ``'vpu_rowstage'`` (``rowstage_sectors_read``), else the distinct
    floats the windows cover (``bisect_windows_read``)."""
    if body == "vpu_rowstage":
        return rowstage_sectors_read(planes, lvl, y0, x0, rel_y)
    return bisect_windows_read(planes, lvl, y0, x0)


def bisect_work(body, k, ns, read=0, sectors=True):
    """``(bytes, float32 operations)`` that ``exp_bisect.py``'s body
    ``body`` must move and do for ``k`` keypoints of ``ns`` samples: the
    per-keypoint words, what the stack gives (``read``: the distinct floats
    that the windows cover, ``bisect_windows_read``; for ``'vpu_rowstage'``
    the distinct 32-byte sectors its samples name,
    ``rowstage_sectors_read``, or with ``sectors=False`` 4 bytes a sample
    and channel), ``rel_y`` for the row select and ``rel_x`` for the
    dynamic one-hot, and the (K, 3 NS) output.  The operations are counted
    for every window, as each keypoint sums its own."""
    from cv_tpu_torch.experiments import probes

    window = 3 * probes.PH * probes.PW
    if body == "vpu_rowstage":
        return k * 12 + (32 * read if sectors else k * 3 * ns * 4) + k * ns * 4 + k * 3 * ns * 4, 0
    nbytes = k * 12 + read * 4 + k * 3 * ns * 4 + (k * ns * 4 if body == "matmul_dyn_oh" else 0)
    flops = {"dma_only": k * window, "split_nomm": 8 * k * window}.get(body, k * ns * 9 * probes.PH)
    return nbytes, flops


def bisect_leaving(planes, lvl, y0, x0, rel_y, rel_x):
    """The first 16 keypoints of an ``exp_bisect.py`` draw (NS > 100) whose
    windows 0-4 leave the stack (past either edge, or an absent level): rows
    of the quiet NaN in every body.  Keypoint 5's columns and rows at
    samples 0-2 (-1, the window's edge, 10,000) and keypoint 6's row at
    sample 100 (PH) leave the window: +0 in the body that reads them (the
    dynamic column sum, 9 outputs; the row select, 12)."""
    import torch

    from cv_tpu_torch.experiments import probes

    n_levels, _, height, width = planes.shape
    lvl, y0, x0, rel_y, rel_x = (t[:16].clone() for t in (lvl, y0, x0, rel_y, rel_x))
    x0[0], y0[1], lvl[2], x0[3], y0[4] = width - probes.PW + 1, -1, n_levels, -3, height - probes.PH + 1
    rel_x[5, :3] = torch.tensor([-1, probes.PW, 10_000], dtype=torch.int32, device=rel_x.device)
    rel_y[5, :3] = torch.tensor([-1, probes.PH, 10_000], dtype=torch.int32, device=rel_y.device)
    rel_y[6, 100] = probes.PH
    return planes, lvl, y0, x0, rel_y, rel_x


def hold_bisect_sums(body, fn, args, aligned):
    """A window-sum or column-sum body's kernel against its order mirror
    (``bisect_window_ordered``, ``bisect_matmul_ordered``): bitwise on
    ``args`` (x0 unaligned), on ``aligned`` (x0 128-aligned) and on
    ``bisect_leaving``'s draw (the quiet NaN where windows leave the stack;
    +0 where the dynamic columns leave the window); on ``aligned`` also
    within ``SUM_ATOL`` of ``bisect_plain``.  Returns the aligned draw's
    times (kernel and plain, alternated)."""
    import torch

    from cv_tpu_torch.experiments import probes

    mirror = probes.bisect_window_ordered if body in probes.WINDOW_SUM_BODIES else probes.bisect_matmul_ordered
    for label, draw in (("x0 unaligned", args), ("x0 aligned", aligned), ("leaving", bisect_leaving(*args))):
        got, ref = fn(*draw), mirror(body, *draw)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
                f"bisect {body} ({label}): bitwise equal to its order mirror "
                f"({int((got.view(torch.int32) != ref.view(torch.int32)).sum())} words differ)")
    nan = int(torch.isnan(got).sum())
    require(nan == 5 * got.shape[1], f"bisect {body}: {nan} NaN outputs where windows leave")
    if body == "matmul_dyn_oh":
        require(bool((got[5, :9].view(torch.int32) == 0).all()), f"bisect {body}: +0 where the columns leave")
    got, plain = fn(*aligned), probes.bisect_plain(body, *aligned)
    err = float((got - plain).abs().max())
    require(err <= probes.SUM_ATOL[body], f"bisect {body} (x0 aligned) within {probes.SUM_ATOL[body]} of its plain "
                                          f"version (max |err| {err})")
    kms, pms = alternate(lambda: fn(*aligned), lambda: probes.bisect_plain(body, *aligned), cuda_ms)
    zeros = " and 9 +0" if body == "matmul_dyn_oh" else ""
    print(f"bisect {body}: bitwise equal to its order mirror (x0 unaligned, aligned, leaving: {nan} NaN{zeros}); "
          f"x0 aligned: max |err| {err:.3e} to plain, kernel {kms:.4f} ms, plain {pms:.4f} ms")
    return dict(aligned_ms=kms, aligned_plain_ms=pms, aligned_max_abs_err=err)


def hold_rowstage(fn, args, aligned):
    """The row select's kernel against ``bisect_plain``, bitwise (NaN by its
    bits): on ``aligned`` (x0 128-aligned), at NS = 1279 (rows that are not
    16-byte aligned: the scalar head, quads and tail) and on
    ``bisect_leaving``'s draw (rows of the quiet NaN where windows leave
    the stack, +0 where rows leave the window).  Returns the aligned draw's
    times (kernel and plain, alternated)."""
    import torch

    from cv_tpu_torch.experiments import probes

    planes, lvl, y0, x0, rel_y, rel_x = args
    ragged = (planes, lvl, y0, x0, rel_y[:, :1279].contiguous(), rel_x[:, :1279].contiguous())
    leaving = bisect_leaving(*args)
    n_nan, n_zero = 5 * planes.shape[1] * rel_y.shape[1], 4 * planes.shape[1]
    for label, draw in (("x0 aligned", aligned), ("NS=1279", ragged), ("leaving", leaving)):
        got, ref = fn(*draw), probes.bisect_plain("vpu_rowstage", *draw)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
                f"bisect vpu_rowstage ({label}): bitwise equal to its plain version "
                f"({int((got.view(torch.int32) != ref.view(torch.int32)).sum())} words differ)")
    bits = got.view(torch.int32)
    nan, zero = int((bits == 0x7FC00000).sum()), int((bits == 0).sum())
    require(nan == n_nan and zero == n_zero,
            f"bisect vpu_rowstage: {nan} quiet NaN and {zero} +0 outputs where {n_nan} and {n_zero} must be")
    kms, pms = alternate(lambda: fn(*aligned), lambda: probes.bisect_plain("vpu_rowstage", *aligned), cuda_ms)
    print(f"bisect vpu_rowstage: bitwise equal to its plain version (x0 aligned, NS=1279, leaving: {nan} NaN, "
          f"{zero} +0); x0 aligned: kernel {kms:.4f} ms, plain {pms:.4f} ms")
    return dict(aligned_ms=kms, aligned_plain_ms=pms)


def split_nonfinite(rel_x, rel_y, patches):
    """The first 16 keypoints of a split draw with an inf, a -inf or a NaN
    planted in column 0 or 1 of six rows in several channels.  Each such row
    gives NaN in every channel row of its sample (the bf16x3 split of an inf
    is NaN; column 0 passes it on through ``* 0``).  Returns the draw and
    the NaN outputs it must give."""
    patches = patches[:16].clone()
    inf = float("inf")
    planted = ((0, 0, 3, 0, inf), (1, 1, 5, 1, -inf), (2, 2, 7, 0, float("nan")), (3, 0, 9, 1, float("nan")),
               (4, 1, 0, 0, -inf), (4, 2, 11, 1, inf))
    for k, c, y, x, v in planted:
        patches[k, c, y, x] = v
    ns = rel_x.shape[1]
    samples = {(k, y) for k, _, y, _, _ in planted if y < ns}
    return (rel_x[:16], rel_y[:16], patches), len(samples) * patches.shape[1]


def hold_split(fn, args):
    """The split select's kernel against ``mxu_plain``, bitwise (NaN by its
    bits): at NS = 100 and on ``split_nonfinite``'s draw."""
    import torch

    from cv_tpu_torch.experiments import probes

    rel_x, rel_y, patches = args
    nonfinite, n_nan = split_nonfinite(*args)
    short = (rel_x[:, :100].contiguous(), rel_y[:, :100].contiguous(), patches)
    for label, draw in (("NS=100", short), ("non-finite", nonfinite)):
        got, ref = fn(*draw), probes.mxu_plain("split", *draw)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
                f"mxu split ({label}): bitwise equal to its plain version "
                f"({int((got.view(torch.int32) != ref.view(torch.int32)).sum())} words differ)")
    nan = int(torch.isnan(got).sum())
    require(nan == n_nan, f"mxu split: {nan} NaN outputs where {n_nan} must be (inf or NaN in columns 0 and 1)")
    print(f"mxu split: bitwise equal to its plain version (NS=100, non-finite: {nan} NaN)")


def mxu_rows_read(rel_y, p=128, g=8):
    """The distinct (keypoint, row) pairs that the row sums of
    ``exp_r3_mxu_probe.py`` must read: the rows in ``[0, p)`` that each
    keypoint's group leader names."""
    import torch

    k = rel_y.shape[0]
    ry = rel_y[torch.arange(k, device=rel_y.device) // g * g].long()
    ry = torch.where((ry >= 0) & (ry < p), ry, p)  # out of range: the spare column p
    return int(torch.zeros((k, p + 1), device=rel_y.device).scatter_(1, ry, 1.0)[:, :p].sum())


def mxu_work(body, k, c, p, ns, rows_read=0, sectors=True):
    """``(bytes, float32 operations)`` that ``exp_r3_mxu_probe.py``'s body
    ``body`` must move and do for ``k`` patches of ``c`` x ``p`` x ``p`` and
    ``ns`` samples: the row sums (``'dots'``, ``'dotsbig'``) the leaders'
    indices, the ``rows_read`` rows (``mxu_rows_read``) and the output; the
    others their indices, the words they read (``'split'``: the 32-byte sector
    of each row's two floats, or with ``sectors=False`` the two floats) and
    the output."""
    if body in ("dots", "dotsbig"):
        return k // 8 * ns * 4 + rows_read * p * 4 + k * c * ns * 4, k * ns * p * (10 if body == "dots" else 4)
    if body == "onehot":
        return k * ns * 8 + k * 4 + k * c * ns * 4, k * ns
    if body == "split":  # 32 bytes a row: its two floats share a sector, rows lie p floats apart
        return k * c * ns * (32 if sectors else 8) + k * c * ns * 4, k * c * ns * 2 * 9
    return 2 * k * c * ns * 4, 0


def row_sums_leaving(rel_x, rel_y, patches):
    """The first 16 keypoints of a row-sum draw with leader rows that leave
    the patch: keypoint 0's at samples 0-2 and keypoint 8's at 100-102
    (both groups read 0 there), and keypoint 3's at sample 7 (not a leader,
    never read).  Returns the draw and the number of zero outputs it must
    give."""
    import torch

    from cv_tpu_torch.experiments import probes

    rel_y = rel_y[:16].clone()
    rel_y[0, :3] = torch.tensor([-1, probes.P, 300], dtype=torch.int32, device=rel_y.device)
    rel_y[8, 100:103] = torch.tensor([300, -1, probes.P], dtype=torch.int32, device=rel_y.device)
    rel_y[3, 7] = -5
    return (rel_x[:16], rel_y, patches[:16]), 2 * 8 * 3 * patches.shape[1]


def hold_row_sums(body, fn, args):
    """A row-sum body's kernel against its order mirror, bitwise: on
    ``args`` (``exp_r3_mxu_probe.py``'s shapes), on its first 12 keypoints
    (a last group of four) and on ``row_sums_leaving``'s draw (0 where the
    leader's rows leave the patch)."""
    import torch

    from cv_tpu_torch.experiments import probes

    leaving, zeros = row_sums_leaving(*args)
    for label, draw in (("script's shapes", args), ("K=12", tuple(t[:12] for t in args)), ("leaving", leaving)):
        got, ref = fn(*draw), probes.mxu_rows_ordered(body, *draw)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
                f"mxu {body} ({label}): bitwise equal to its order mirror "
                f"({int((got.view(torch.int32) != ref.view(torch.int32)).sum())} words differ)")
    n_zero = int((got == 0).sum())
    require(n_zero == zeros, f"mxu {body}: {n_zero} zero outputs where {zeros} must be (leader rows leave the patch)")
    print(f"mxu {body}: bitwise equal to its order mirror (script's shapes, K=12, leaving: {n_zero} zeros)")


def same_bits_any(a, b):
    """Two float32 or float64 tensors bitwise equal, a NaN only by position."""
    import torch

    bits = torch.int32 if a.dtype == torch.float32 else torch.int64
    nan = torch.isnan(b)
    return a.dtype == b.dtype and bool(torch.equal(torch.isnan(a), nan)
                                       and torch.equal(a.view(bits)[~nan], b.view(bits)[~nan]))


def trig64_inputs(seed, n=1 << 20):
    """Float64 arguments for the trig kernels: normal x e^U(-40, 40) pairs
    and unit draws; atan2's bands (|y/x| near 1/16, 1, the table's 1/256
    steps, 2^+-57 binades, magnitudes near 2^+-500); cos/sin's (2^-27,
    2^-26, 0.126, 0.855469, 2.426265, 105414350, near multiples of pi/2 to
    10^4, huge); and a grid of special values (zeros, subnormals, infinities,
    NaN).  Returns ``(y, x, a)`` NumPy arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y = [rng.standard_normal(n) * np.exp(rng.uniform(-40, 40, n)), rng.uniform(-1, 1, n)]
    x = [rng.standard_normal(n) * np.exp(rng.uniform(-40, 40, n)), rng.uniform(-1, 1, n)]
    base = rng.standard_normal(n // 8) * np.exp(rng.uniform(-5, 5, n // 8))
    for ratio in (1 / 16, 16.0, 1.0, 2.0 ** 57, 2.0 ** -57, 2.0 ** 58, 2.0 ** -58):
        y.append(base * ratio * (1 + rng.uniform(-1e-9, 1e-9, base.size)))
        x.append(base * rng.choice([-1.0, 1.0], base.size))
    y.append(base * rng.integers(16, 257, base.size) / 256 * (1 + rng.uniform(-1e-12, 1e-12, base.size)))
    x.append(base)
    for scale in (2.0 ** 500, 2.0 ** -500):
        y.append(rng.standard_normal(base.size) * scale)
        x.append(rng.standard_normal(base.size) * scale)
    special = np.array([0.0, 5e-324, 1e-310, 2.0 ** -1022, 2.0 ** -600, 1e-200, 2.0 ** -27, 0.5, 1.0, 2.0, 1e22,
                        2.0 ** 501, 1e300, np.finfo(np.float64).max, np.inf])
    special = np.concatenate([special, -special, [np.nan]])
    sy, sx = np.meshgrid(special, special, indexing="ij")
    y += [sy.ravel()]
    x += [sx.ravel()]

    def near(v, span):
        b = np.atleast_1d(np.asarray(v, np.float64)).view(np.int64)[:, None]
        return (b + np.arange(-span, span + 1, dtype=np.int64)[None, :]).ravel().view(np.float64)

    bounds = [2.0 ** -27, 2.0 ** -26, 0.126, 0.85546875, 2.4262657165527344, 105414350.0]
    a = [y[0], rng.uniform(-np.pi / 2, np.pi / 2, n), near(bounds, 2000), -near(bounds, 2000),
         near([k * np.pi / 2 for k in range(-6400, 6401) if k], 8), rng.uniform(-1e9, 1e9, n // 8),
         rng.standard_normal(n // 8) * np.exp(rng.uniform(18, 700, n // 8)), special]
    return np.concatenate(y), np.concatenate(x), np.concatenate(a)


def symmetric_batch(rng, b, n):
    """``b`` random symmetric n x n matrices (scales e^U(-3, 3)) and a set
    of structured ones: zero, identity, diagonal (ascending, descending,
    repeated), repeated eigenvalues in a random basis, ``apq = 0``,
    rank one, graded, a 2x2 block."""
    import numpy as np

    m = rng.standard_normal((b, n, n)) * np.exp(rng.uniform(-3, 3, (b, 1, 1)))
    mats = [np.zeros((n, n)), np.eye(n), np.diag(np.arange(n, 0, -1.0)), np.diag(np.arange(n) * 1.0),
            np.diag(np.repeat([2.0, -1.0], [n - n // 2, n // 2]))]
    for _ in range(4):
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        mats.append(q @ np.diag(np.repeat([1.0, 3.0], [n // 2, n - n // 2])) @ q.T)
        r = rng.standard_normal((n, n))
        r = r + r.T
        r[0, 1] = r[1, 0] = 0.0
        mats.append(r)
        v = rng.standard_normal(n)
        mats.append(np.outer(v, v))
        d = np.diag(10.0 ** rng.uniform(-8, 8, n))
        mats.append(d @ (r / 2) @ d)
        blk = np.zeros((n, n))
        blk[:2, :2] = r[:2, :2]
        mats.append(blk)
    return np.concatenate([(m + np.swapaxes(m, -1, -2)) / 2, np.stack(mats)])


def jacobi_flops(n, sweeps):
    """Float64 operations of one matrix in csrc/jacobi.cu along its
    cheapest branches (a fused multiply-add as two), counted from the
    source: a rotation's angle ~25 (atan2's small-quotient form: the
    quotient, its correction, the polynomial), its cosine and sine ~36
    (do_cos and the Taylor sine), and 6 a row of each of the three updates
    (two products, two fused operations), 3N rows."""
    return sweeps * n * (n - 1) // 2 * (25 + 36 + 18 * n)


def torch_jacobi_unfused(a, sweeps=6):
    """The parent's eigh_small (torch's atan2, cos and sin; unfused
    updates): the time the kernel replaces, printed beside it."""
    import torch

    n = a.shape[-1]
    a = a.reshape(-1, n, n).permute(1, 2, 0).contiguous()
    v = torch.eye(n, dtype=a.dtype, device=a.device)[:, :, None].expand(a.shape).contiguous()
    for _ in range(sweeps):
        for p in range(n):
            for q in range(p + 1, n):
                theta = 0.5 * torch.atan2(2.0 * a[p, q], a[q, q] - a[p, p])
                c, s = torch.cos(theta), torch.sin(theta)
                col_p, col_q = a[:, p], a[:, q]
                a[:, p], a[:, q] = c * col_p - s * col_q, s * col_p + c * col_q
                row_p, row_q = a[p], a[q]
                a[p], a[q] = c * row_p - s * row_q, s * row_p + c * row_q
                vp, vq = v[:, p], v[:, q]
                v[:, p], v[:, q] = c * vp - s * vq, s * vp + c * vq
    w = torch.diagonal(a.permute(2, 0, 1), dim1=-2, dim2=-1)
    order = torch.sort(w, dim=-1, stable=True).indices
    v = v.permute(2, 0, 1)
    return torch.gather(w, -1, order), torch.gather(v, -1, order[..., None, :].expand(v.shape))


# Float64 operations of one pair in csrc/jacobi.cu's residual entry besides
# its 4x4 Jacobi (a fused multiply-add as two, a division or square root as
# one), counted from the source: the two bearings' v^T pm (4 columns of 6)
# and rows (12 fused operations), 48 + 48; the design's 10 entries of 11;
# two from_homogeneous of 11; the rotated point, 3 x 8; the two cosines, 12;
# the residual, 3.
C2C_EXTRA_FLOPS = 96 + 110 + 22 + 24 + 12 + 3
# The residual's timed block: 1,024 x 4 models against 1,024 matches.
C2C_BLOCK = (1024, 4, 1024)
# The parent commit's device ms at that block, as PERF.md records them
# (its residual entry; its score entry: scripts/jacobi_variants.py
# --parent, NVIDIA H100 80GB HBM3 at 700 W), printed beside this tree's.
C2C_PARENT_MS = {"residual": 2.858, "scoring": 3.075}
# The most (model, match) pairs of a recorded scoring stage rerun with the
# plain residual.
SCORE_HOLD_PAIRS = 1 << 21


def c2c_block(dev, rng):
    """A consensus block of the residual, float64: random relative poses
    (so(3) angles within 0.3 rad, unit-variance translations) of batch
    shape ``(H, M, 1)`` against ``N`` random unit bearing pairs."""
    import torch

    from cv_tpu_torch.core.lie import so3_exp
    from cv_tpu_torch.core.pose import Isometry3

    h, m, n = C2C_BLOCK
    rot = so3_exp(torch.as_tensor(rng.uniform(-0.3, 0.3, (h, m, 1, 3)), device=dev))
    tr = torch.as_tensor(rng.standard_normal((h, m, 1, 3)), device=dev)
    a, b = (torch.nn.functional.normalize(torch.as_tensor(rng.standard_normal((n, 3)), device=dev), dim=-1)
            for _ in range(2))
    return Isometry3(rot, tr), a, b


def check_eigen_trig64(dev, seed):
    """The float64 trig kernels (``csrc/trig_probe.cu``: atan2 of float64
    and float32, cos/sin of float64) and the Jacobi kernel
    (``csrc/jacobi.cu``) bitwise to their plain versions on the card (a NaN
    by position): the trig on ``trig64_inputs``, the Jacobi at
    ``JACOBI_SHAPES`` in float32 and float64; then the Jacobi's times at a
    consensus block of 4x4 float64 beside the plain version's, the parent's
    torch sweep's and ``torch.linalg.eigh``'s.  Returns the Jacobi's record
    and the trig kernel's float64 figures."""
    import numpy as np
    import torch

    from cv_tpu_torch.ops import eigen, trig

    yn, xn, an = trig64_inputs(seed)
    y, x, a = (torch.as_tensor(v, device=dev) for v in (yn, xn, an))
    got = trig.atan2(y, x)
    ref = trig.atan2_f64(y, x)
    require(same_bits_any(got, ref), "atan2 float64 kernel bitwise equal to its plain version")
    got32, ref32 = trig.atan2(y.float(), x.float()), trig.atan2_f32(y.float(), x.float())
    require(same_bits_any(got32, ref32), "atan2 float32 kernel bitwise equal to its plain version")
    co, si = trig.cos_sin(a)
    pc, ps = trig.cos_sin_f64(a)
    require(same_bits_any(co, pc) and same_bits_any(si, ps),
            "cos/sin float64 kernel bitwise equal to its plain version")
    print(f"trig float64: atan2 on {y.numel()} pairs, cos/sin on {a.numel()} arguments, atan2 float32 on "
          f"{y.numel()}: bitwise equal to the plain versions ({int(torch.isnan(ref).sum())} / "
          f"{int(torch.isnan(pc).sum())} NaN in the same places)")
    # The library yardstick: torch.atan2, and torch.cos plus torch.sin (no
    # one call computes both), on the same arguments: the same functions,
    # not the same bits.
    y32, x32 = y.float(), x.float()
    trig_rec = {}
    for label, run_k, run_p, run_l, nbytes, count in (
            ("atan2 f64", lambda: trig.atan2(y, x), lambda: trig.atan2_f64(y, x), lambda: torch.atan2(y, x),
             24 * y.numel(), y.numel()),
            ("atan2 f32", lambda: trig.atan2(y32, x32), lambda: trig.atan2_f32(y32, x32),
             lambda: torch.atan2(y32, x32), 12 * y.numel(), y.numel()),
            ("cos_sin f64", lambda: trig.cos_sin(a), lambda: trig.cos_sin_f64(a),
             lambda: (torch.cos(a), torch.sin(a)), 24 * a.numel(), a.numel())):
        kdev = device_ms(run_k)
        kms, pms = alternate(run_k, run_p, lambda f: cuda_ms(f, iters=3, warmup=1))
        lms = cuda_ms(run_l, iters=10, warmup=2)
        trig_rec[label] = dict(device_ms=kdev, ms=kms, plain_ms=pms, library_ms=lms,
                               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        print(f"trig {label} at {count}: kernel {kms:.4f} ms, device (a CUDA graph) {kdev:.4f} ms, plain "
              f"{pms:.3f} ms, library {lms:.4f} ms, byte bound {trig_rec[label]['bound_ms']:.4f} ms")

    rng = np.random.default_rng(seed + 17)
    for n, sweeps, count in JACOBI_SHAPES:
        mats = symmetric_batch(rng, count, n)
        for dtype in (torch.float64, torch.float32):
            m = torch.as_tensor(mats, dtype=dtype, device=dev)
            w, v = eigen.eigh_small(m, sweeps)
            wp, vp = eigen.eigh_small_plain(m, sweeps)
            ok = same_bits_any(w, wp) and same_bits_any(v, vp)
            print(f"jacobi N={n} sweeps={sweeps} {str(dtype)[6:]}: {len(mats)} matrices bitwise equal to the plain "
                  f"version {ok}")
            require(ok, f"jacobi N={n} {dtype}: bitwise equal to eigh_small_plain")

    # One consensus block of 4x4 float64 designs (random symmetric, the
    # residual's scale): the kernel, the plain version, the parent's torch
    # sweep and LAPACK-style torch.linalg.eigh.
    m = torch.as_tensor(symmetric_batch(rng, JACOBI_TIMED, 4)[:JACOBI_TIMED], device=dev)
    w, v = eigen.eigh_small(m)
    kdev = device_ms(lambda: eigen.eigh_small(m), iters=5)
    kms = cuda_ms(lambda: eigen.eigh_small(m), iters=5, warmup=1)
    pms = statistics.median(wall_ms(lambda: eigen.eigh_small_plain(m), reps=2))
    wp, vp = eigen.eigh_small_plain(m)
    require(same_bits_any(w, wp) and same_bits_any(v, vp), "jacobi at the timed block: bitwise equal to plain")
    parent_ms = statistics.median(wall_ms(lambda: torch_jacobi_unfused(m), reps=3))
    print(f"jacobi at a consensus block: kernel {kms:.3f} ms (device {kdev:.3f}), plain {pms:.1f} ms, the parent's "
          f"torch sweep {parent_ms:.1f} ms", flush=True)
    # torch.linalg.eigh (cuSOLVER's batched syev): one call where cuSOLVER
    # takes the batch, else the sum over 4, 16, ... equal chunks.
    chunks = 1
    while True:
        step = JACOBI_TIMED // chunks

        def lib():
            return [torch.linalg.eigh(m[i:i + step]) for i in range(0, JACOBI_TIMED, step)]

        try:
            wl = torch.cat([r[0] for r in lib()])
            break
        except RuntimeError as err:
            if chunks >= 1024:
                raise
            print(f"torch.linalg.eigh on {step} matrices a call: {str(err)[:100]}")
            chunks *= 4
    lib_ms = cuda_ms(lib, iters=3, warmup=1)
    nbytes = JACOBI_TIMED * (16 + 4 + 16) * 8
    rec = kernel_record(kms, pms, float((w - wp).abs().max()), nbytes, library_ms=lib_ms, device_ms=kdev,
                        parent_torch_ms=parent_ms, library_calls=chunks)
    ms_ops = JACOBI_TIMED * jacobi_flops(4, 6) / FP64_FLOPS * 1e3
    if ms_ops > rec["bound_ms"]:
        rec["bound_ms"], rec["bound_by"] = ms_ops, "operations"
    print(f"jacobi at a consensus block ({JACOBI_TIMED} 4x4 float64, 6 sweeps): kernel {kms:.3f} ms, device (a CUDA "
          f"graph) {kdev:.3f} ms; plain (eigh_small_plain, torch ops) {pms:.1f} ms; the parent's torch sweep "
          f"{parent_ms:.1f} ms; torch.linalg.eigh {lib_ms:.3f} ms in {chunks} call(s) (eigenvalues within "
          f"{float((wl - w).abs().max()):.2e}); bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
          f"{nbytes / 1e9:.3f} GB at 3.35 TB/s {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
          f"{JACOBI_TIMED * jacobi_flops(4, 6) / 1e9:.2f} GFLOP float64 at 34 TFLOP/s {ms_ops:.4f} ms)")
    del m, w, v, wp, vp

    # The residual entry at a block of (model, match) pairs: the kernel
    # beside its plain version (torch ops, the plain Jacobi); no one library
    # call computes it.  Then the score entry on the same block.
    from cv_tpu_torch.core import pose as pose_mod

    pose, a, b = c2c_block(dev, rng)
    got = pose_mod.c2c_residual(pose, a, b)
    rdev = device_ms(lambda: pose_mod.c2c_residual(pose, a, b), iters=5)
    rms = cuda_ms(lambda: pose_mod.c2c_residual(pose, a, b), iters=5, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = pose_mod.c2c_residual_plain(pose, a, b)
    torch.cuda.synchronize()
    rpms = (time.perf_counter() - t0) * 1e3
    require(same_bits_any(got, want), "residual at the timed block: bitwise equal to the plain version")
    pairs = got.numel()
    flops = pairs * (jacobi_flops(4, 6) + C2C_EXTRA_FLOPS)
    nbytes = (12 * C2C_BLOCK[0] * C2C_BLOCK[1] + 6 * C2C_BLOCK[2] + pairs) * 8  # poses, bearings in; residuals out
    res_rec = kernel_record(rms, rpms, float((got - want).abs().max()), nbytes, library_ms=None, device_ms=rdev)
    ms_ops = flops / FP64_FLOPS * 1e3
    if ms_ops > res_rec["bound_ms"]:
        res_rec["bound_ms"], res_rec["bound_by"] = ms_ops, "operations"
    print(f"residual at a consensus block ({pairs} pairs, float64): kernel {rms:.3f} ms, device (a CUDA graph) "
          f"{rdev:.3f} ms (the parent's: {C2C_PARENT_MS['residual']} ms device); plain (c2c_residual_plain, torch "
          f"ops) {rpms:.1f} ms; {int((got == 2.0).sum())} pairs at 2.0; bound {res_rec['bound_ms']:.4f} ms "
          f"({res_rec['bound_by']}: {flops / 1e9:.2f} GFLOP float64 at 34 TFLOP/s); library: none")
    # Poses scaled to ~1e-155: the design's products and the rotated
    # points' squares fall below the normal range, where the reference
    # flushes them (XLA's FTZ/DAZ); the kernel flushes at the same steps and
    # the plain version's fused operations are exact there.  Residual and
    # score held bitwise on 64 x 4 models against 1024 rows.
    tiny = pose_mod.Isometry3(pose.rotation[:64] * 1e-155, pose.translation[:64] * 1e-155)
    got_t, want_t = pose_mod.c2c_residual(tiny, a, b), pose_mod.c2c_residual_plain(tiny, a, b)
    valid_t = torch.ones(a.shape[0], dtype=torch.bool, device=dev)
    score_t, pscore_t = pose_mod.c2c_score(tiny, a, b, valid_t, 0.1), pose_mod.c2c_score_plain(tiny, a, b, valid_t, 0.1)
    torch.cuda.synchronize()
    require(same_bits_any(got_t, want_t), "residual on poses at 1e-155: bitwise equal to the plain version")
    require(torch.equal(score_t[0], pscore_t[0]) and same_bits_any(score_t[1], pscore_t[1]),
            "score on poses at 1e-155: counts and totals bitwise equal to the plain version")
    print(f"residual and score on poses scaled to 1e-155 ({got_t.numel()} pairs, {int((got_t < 2.0).sum())} below "
          "2.0): bitwise equal to the plain versions")
    del got_t, want_t, tiny
    # The score entry: every model's inlier count and total (at 0.1, where
    # ~15% of this draw's pairs are inliers, so the totals sum many terms),
    # all rows valid, beside its plain version and the parent's
    # scoring of the block (its residual entry, then the torch passes:
    # compare, isfinite, and, sum, where, sum).
    thr = 0.1
    valid = torch.ones(C2C_BLOCK[2], dtype=torch.bool, device=dev)
    counts, totals = pose_mod.c2c_score(pose, a, b, valid, thr)
    sdev = device_ms(lambda: pose_mod.c2c_score(pose, a, b, valid, thr), iters=5)
    sms = cuda_ms(lambda: pose_mod.c2c_score(pose, a, b, valid, thr), iters=5, warmup=1)
    inliers = (want < thr) & valid & torch.isfinite(want)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pcounts, ptotals = pose_mod.c2c_score_plain(pose, a, b, valid, thr)
    torch.cuda.synchronize()
    spms = (time.perf_counter() - t0) * 1e3
    require(torch.equal(counts, pcounts) and same_bits_any(totals, ptotals),
            "score at the timed block: counts and totals bitwise equal to the plain version")
    require(torch.equal(counts, inliers.sum(-1)), "score at the timed block: counts equal the residuals' inliers")

    def torch_scoring():
        res = pose_mod.c2c_residual(pose, a, b)
        ins = (res < thr) & valid & torch.isfinite(res)
        return ins.sum(-1), torch.where(ins, res, torch.zeros_like(res)).sum(-1)

    tdev = device_ms(torch_scoring, iters=5)
    flops_s = pairs * (jacobi_flops(4, 6) + C2C_EXTRA_FLOPS + 2)
    nbytes_s = (12 * C2C_BLOCK[0] * C2C_BLOCK[1] + 6 * C2C_BLOCK[2]) * 8 + C2C_BLOCK[2] \
        + 16 * C2C_BLOCK[0] * C2C_BLOCK[1]  # poses, bearings, valid in; counts, totals out
    score_rec = kernel_record(sms, spms, float((totals - ptotals).abs().max()), nbytes_s, library_ms=None,
                              device_ms=sdev, residual_and_torch_device_ms=tdev)
    ms_ops = flops_s / FP64_FLOPS * 1e3
    if ms_ops > score_rec["bound_ms"]:
        score_rec["bound_ms"], score_rec["bound_by"] = ms_ops, "operations"
    print(f"score at a consensus block ({pairs} pairs, float64, threshold {thr!r}, {int(counts.sum())} inliers): "
          f"kernel {sms:.3f} ms, device {sdev:.3f} ms (the parent's: {C2C_PARENT_MS['scoring']} ms device); the "
          f"residual entry plus the torch passes {tdev:.3f} ms device; plain (c2c_score_plain) {spms:.1f} ms; bound "
          f"{score_rec['bound_ms']:.4f} ms ({score_rec['bound_by']}: {flops_s / 1e9:.2f} GFLOP float64 at 34 "
          "TFLOP/s); library: none")
    del got, want, inliers
    return rec, trig_rec, res_rec, score_rec


def first_calls(k):
    """A ``recording`` keep that clones the first ``k`` calls' arguments
    and drops the rest."""
    seen = [0]

    def keep(args):
        seen[0] += 1
        return _clone(args) if seen[0] <= k else None

    return keep


def cut_models(models, valid, pairs):
    """The first hypotheses of a ``(H, M)`` models batch, at most ``pairs``
    (model, row) pairs against ``valid``'s rows."""
    h, m = models.translation.shape[:2]
    keep = max(1, pairs // (m * valid.shape[0]))
    return type(models)(rotation=models.rotation[:keep], translation=models.translation[:keep])


def hold_recorded_residuals(calls, score_calls, scores, label):
    """Each recorded call of the residual entry (``pose.c2c_residual``: the
    winners' rows) bitwise to the plain residual, and the Jacobi kernel
    bitwise to ``eigh_small_plain`` on those pairs' designs; each recorded
    call of the score entry (``pose.c2c_score``: the stages' blocks; its
    first models, up to ``SCORE_HOLD_PAIRS`` pairs) bitwise to
    ``c2c_score_plain``, counts and totals; each recorded scoring stage
    (``BatchConsensus._score_stage``; its first hypotheses, up to
    ``SCORE_HOLD_PAIRS`` pairs) rerun with the plain residual and score in
    the entries' place (the same model, mask, count and total, bitwise) and
    on the parent's path, the estimator without its ``score`` (every
    residual written, torch's sums): the same model, mask and count, or a
    tie of counts that only the totals' summation order decides, printed
    with both totals."""
    import dataclasses

    import torch

    from cv_tpu_torch.consensus import BatchConsensus
    from cv_tpu_torch.core import pose as pose_mod
    from cv_tpu_torch.ops import eigen

    pairs = designs = held = scored = 0
    for args, kw in calls:
        if args is None:
            continue
        got = pose_mod.c2c_residual(*args, **kw)
        want = pose_mod.c2c_residual_plain(*args[:3])
        require(same_bits_any(got, want), f"residual on {label}'s pairs: bitwise equal to the plain version")
        pairs += got.numel()
        design = pose_mod.c2c_design(*args[:3]).reshape(-1, 4, 4)[: 1 << 20]
        w, v = eigen.eigh_small(design)
        wp, vp = eigen.eigh_small_plain(design)
        require(same_bits_any(w, wp) and same_bits_any(v, vp), f"jacobi on {label}'s designs: bitwise equal")
        designs += design.shape[0]
    require(pairs > 0, f"no {label} residual recorded")
    for args, kw in score_calls:
        if args is None:
            continue
        pose, a, b, valid, thr = args
        pose = cut_models(pose, valid, SCORE_HOLD_PAIRS)
        got_c, got_t = pose_mod.c2c_score(pose, a, b, valid, thr)
        want_c, want_t = pose_mod.c2c_score_plain(pose, a, b, valid, thr)
        require(torch.equal(got_c, want_c) and same_bits_any(got_t, want_t),
                f"score on {label}'s blocks: counts and totals bitwise equal to the plain version")
        scored += got_c.numel() * a.shape[0]
    require(scored > 0, f"no {label} score recorded")
    for args, kw in scores:
        if args is None:
            continue
        # At most ``SCORE_HOLD_PAIRS`` pairs: the first hypotheses' models
        # (the plain residual takes seconds a block).
        consensus, estimator, models, data, valid = args
        args = (consensus, estimator, cut_models(models, valid, SCORE_HOLD_PAIRS), data, valid)
        kernel = BatchConsensus._score_stage(*args, **kw)
        real = pose_mod.c2c_residual, pose_mod.c2c_score
        pose_mod.c2c_residual = lambda pose, a, b: pose_mod.c2c_residual_plain(pose, a, b)
        pose_mod.c2c_score = pose_mod.c2c_score_plain
        try:
            plain = BatchConsensus._score_stage(*args, **kw)
        finally:
            pose_mod.c2c_residual, pose_mod.c2c_score = real
        parent = BatchConsensus._score_stage(args[0], dataclasses.replace(estimator, score=None), *args[2:], **kw)
        (km, kmask, kcount, ktotal), (pm, pmask, pcount, ptotal) = kernel, plain
        same = (torch.equal(km.rotation, pm.rotation) and torch.equal(km.translation, pm.translation)
                and torch.equal(kmask, pmask) and int(kcount) == int(pcount) and same_bits_any(ktotal, ptotal))
        require(same, f"{label}'s scoring with the plain residual and score: the same model, mask, count and total")
        qm, qmask, qcount, qtotal = parent
        if not (torch.equal(km.rotation, qm.rotation) and torch.equal(km.translation, qm.translation)):
            require(int(kcount) == int(qcount), f"{label}'s scoring on the parent's path: another count")
            print(f"{label}'s scoring: a tie of {int(kcount)} inliers decided otherwise than on the parent's path "
                  f"by the totals' summation order: this tree's winner's total {float(ktotal)!r}, the parent's "
                  f"winner's total {float(qtotal)!r}")
        else:
            require(torch.equal(kmask, qmask) and int(kcount) == int(qcount),
                    f"{label}'s scoring on the parent's path: the same model, mask and count")
        held += 1
    require(held > 0, f"no {label} scoring stage recorded")
    print(f"residual on {label}'s recorded blocks: {pairs} pairs bitwise equal to the plain version, the jacobi on "
          f"{designs} of their designs bitwise; score entry on {scored} recorded pairs bitwise equal to the plain "
          f"version; {held} scoring stage(s) with the plain residual and score: the same model, inlier mask, count "
          "and total; on the parent's path the same model, mask and count")


def check_experiment_kernels(dev, seed):
    """Phase 3 for the experiments' kernels, at their scripts' shapes: the
    retired selects (the select kernel at the KITTI batch's shapes), the
    probes' selects and gathers bitwise, the trigonometry bitwise to
    ``ops/trig.py`` (the probe and the describe's forms, with the launch
    floor of an empty kernel), the summing probes within
    ``probes.SUM_ATOL``; alternating timings, the library call where one
    computes the function, and the bound.  Returns
    per-kernel records."""
    import torch

    from cv_tpu_torch.akaze import select
    from cv_tpu_torch.experiments import mldb_losers, probes
    from cv_tpu_torch.ops import trig

    gen = torch.Generator(device=dev).manual_seed(seed + 21)

    def rand_i32(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    out = {}

    def hold(name, run_k, run_p, nbytes, flops=0.0, lib=None, atol=None):
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        require(got.shape == ref.shape and bool(torch.isfinite(got).all()), f"{name}: shape and finite values")
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        if atol is None:
            require(torch.equal(got, ref), f"{name} bitwise equal to its plain version (max |err| {err})")
        else:
            require(err <= atol, f"{name} within {atol} of its plain version (max |err| {err})")
        if lib is not None:
            require(torch.equal(lib(), got), f"{name}: the library call gives the same values")
        kms, pms = alternate(run_k, run_p, cuda_ms)
        lms = cuda_ms(lib) if lib is not None else None
        rec = kernel_record(kms, pms, err, nbytes, flops, library_ms=lms)
        gate = "bitwise" if atol is None else f"max |err| {err:.3e} (gate {atol})"
        lib_text = "none" if lms is None else f"{lms:.4f} ms"
        print(f"{name}: {gate}; kernel {kms:.4f} ms, plain {pms:.4f} ms, library {lib_text}, "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        return rec

    def add(name, recs):
        """Sum the records of one kernel's calls (the describe's two passes)."""
        keys = ("ms", "plain_ms", "library_ms", "bound_ms")
        merged = {k: sum(r[k] for r in recs) for k in keys}
        merged["max_abs_err"] = max(r["max_abs_err"] for r in recs)
        merged["bound_by"] = max(recs, key=lambda r: r["bound_ms"])["bound_by"]
        out[name] = merged

    # Row 9: the retired selects at the KITTI batch's describe shapes (B=8
    # stack, 4,096 keypoints; orientation NS=109 on Lx/Ly, M-LDB NS=441).
    hp, wp = SHAPES["hp"], SHAPES["wp"]
    n_lvl, k = BATCH * SHAPES["levels"], BATCH * SHAPES["kitti_k"]
    planes = torch.randn((n_lvl, 3, hp, wp), generator=gen, device=dev)
    lvl = rand_i32(n_lvl, (k,))
    y0, x0 = rand_i32(hp - 128 + 1, (k,)), rand_i32(wp - 128 + 1, (k,))
    ht, wt = hp // 128, wp // 128
    ty, tx = rand_i32(ht - 1, (k,)), rand_i32(wt - 1, (k,))
    perm = torch.argsort((lvl.long() * ht + ty) * wt + tx, stable=True)  # tile-sorted, as 'ptiles' sorts
    lvl_s, ty_s, tx_s = lvl[perm], ty[perm], tx[perm]
    recs = {"select_samples_epatch": [], "select_samples_tiles": [], "select_samples_tiles8": []}
    for c0, ns in ((1, 109), (0, 441)):
        rx, ry = rand_i32(128, (k, ns)), rand_i32(128, (k, ns))
        rx2, ry2 = rand_i32(256, (k, ns)), rand_i32(256, (k, ns))
        nbytes = select_bytes(k, ns, 3 - c0)
        recs["select_samples_epatch"].append(hold(
            f"select_samples_epatch c0={c0} NS={ns}",
            lambda: mldb_losers.select_samples_epatch(planes, lvl, y0, x0, rx, ry, c0),
            lambda: select.select_samples_plain(planes, lvl, y0, x0, rx, ry, c0), nbytes,
            lib=index_call(planes, lvl, y0[:, None] + ry, x0[:, None] + rx, c0)))
        for name in ("select_samples_tiles", "select_samples_tiles8"):
            fn = getattr(mldb_losers, name)
            recs[name].append(hold(
                f"{name} c0={c0} NS={ns}",
                lambda fn=fn: fn(planes, lvl_s, ty_s, tx_s, rx2, ry2, c0),
                lambda: select.select_samples_plain(planes, lvl_s, 128 * ty_s, 128 * tx_s, rx2, ry2, c0), nbytes,
                lib=index_call(planes, lvl_s, 128 * ty_s[:, None] + ry2, 128 * tx_s[:, None] + rx2, c0)))
    for name, r in recs.items():
        add(name, r)
    del planes

    # Row 10: exp_select_kernels.py (K=4096, NS=1280, 136x128 windows of a
    # (16, 3, 544, 1408) stack) and exp_bisect.py (K=512, the same stack).
    sh = PROBE_SHAPES
    planes = torch.randn((sh["levels"], 3, sh["hmax"], sh["wmax"]), generator=gen, device=dev)

    def window_inputs(k, ns):
        return (planes, rand_i32(sh["levels"], (k,)), rand_i32(sh["hmax"] - probes.PH, (k,)),
                rand_i32(sh["wmax"] - probes.PW, (k,)), rand_i32(probes.PH, (k, ns)), rand_i32(probes.PW, (k, ns)))

    k, ns = sh["window_k"], sh["window_ns"]
    args = window_inputs(k, ns)
    _, wl, wy, wx, wry, wrx = args
    out["select_window[exp_select_kernels]"] = hold(
        f"select_window (exp_select_kernels, K={k}, NS={ns})", lambda: probes.select_window(*args),
        lambda: probes.select_window_plain(*args), select_bytes(k, ns, 3),
        lib=lambda f=index_call(planes, wl, wy[:, None] + wry, wx[:, None] + wrx): f().reshape(k, -1))
    k = sh["bisect_k"]
    args = window_inputs(k, ns)
    _, bl, by, bx, bry, brx = args
    # exp_bisect.py's second run: x0 128-aligned (make_inputs(align_x=True)).
    aligned = window_inputs(k, ns)
    aligned = (*aligned[:3], aligned[3] & ~127, *aligned[4:])
    for body, fn in probes.BISECT.items():
        nbytes, flops = bisect_work(body, k, ns, bisect_read(body, *args[:5]))
        lib = None
        if body == "vpu_rowstage":
            f = index_call(planes, bl, by[:, None] + bry, bx[:, None].expand(k, ns))
            lib = lambda f=f: f().reshape(k, -1)  # noqa: E731
        name = f"bisect {body} (K={k}, NS={ns})"
        rec = out[f"bisect_{body}"] = hold(name, lambda fn=fn: fn(*args),
                                           lambda body=body: probes.bisect_plain(body, *args), nbytes, flops, lib,
                                           probes.SUM_ATOL.get(body))
        if body == "vpu_rowstage":
            rec.update(hold_rowstage(fn, args, aligned))
            word_ms = bound(*bisect_work(body, k, ns, sectors=False))[0]
            print(f"{name}: {100 * word_ms / rec['ms']:.1f}% of its bound at 4 bytes a sample, {word_ms:.4f} ms")
        else:  # the window and column sums
            rec.update(hold_bisect_sums(body, fn, args, aligned))
        rec["aligned_bound_ms"] = bound(*bisect_work(body, k, ns, bisect_read(body, *aligned[:5])))[0]
        print(f"{name}: {100 * rec['bound_ms'] / rec['ms']:.1f}% of its bound {rec['bound_ms']:.4f} ms "
              f"unaligned, {100 * rec['aligned_bound_ms'] / rec['aligned_ms']:.1f}% of "
              f"{rec['aligned_bound_ms']:.4f} ms aligned (the distinct "
              f"{'sectors its samples name' if body == 'vpu_rowstage' else 'bytes of the windows'})")
    del planes, args, aligned

    # exp_r3_gather_probe.py and exp_r3_mxu_probe.py: patches (4096, 3, 128,
    # 128), NS=512 ('split' at NS=128, where its TPU body traces).
    k, c, p, ns = sh["patch_k"], 3, 128, sh["patch_ns"]
    patches = torch.randn((k, c, p, p), generator=gen, device=dev)
    rx, ry = rand_i32(p, (k, ns)), rand_i32(p, (k, ns))
    kk = torch.arange(k, dtype=torch.int32, device=dev)
    out["select_samples_patch[phase_select]"] = hold(
        f"select_samples_patch (phase_select, K={k}, NS={ns})", lambda: select.select_samples_patch(patches, rx, ry),
        lambda: select.select_samples_plain(patches, kk, kk * 0, kk * 0, rx, ry),
        select_bytes(k, ns, c, per_keypoint=0), lib=index_call(patches, kk, ry, rx))
    rx128, ry128 = rand_i32(p, (k, p)), rand_i32(p, (k, p))
    rows_read = mxu_rows_read(ry, p)
    for body, fn in probes.MXU.items():
        n = p if body == "split" else ns
        bx, bys = (rx128, ry128) if body == "split" else (rx, ry)
        nbytes, flops = mxu_work(body, k, c, p, n, rows_read)
        lib = None
        if body == "dma":
            sidx = torch.arange(n, device=dev)
            lib = lambda s=sidx: patches[:, :, s // p, s % p]  # noqa: E731
        rec = out[f"mxu_{body}"] = hold(
            f"mxu {body} (K={k}, NS={n})", lambda fn=fn, bx=bx, bys=bys: fn(bx, bys, patches),
            lambda body=body, bx=bx, bys=bys: probes.mxu_plain(body, bx, bys, patches), nbytes, flops, lib,
            probes.SUM_ATOL.get(body))
        if body in probes.ROW_SUM_BODIES:
            hold_row_sums(body, fn, (rx, ry, patches))
            print(f"mxu {body} (K={k}, NS={n}): {100 * rec['bound_ms'] / rec['ms']:.1f}% of its bound "
                  f"({rows_read / k:.2f} distinct rows a keypoint)")
        elif body == "split":
            hold_split(fn, (bx, bys, patches))
            word_ms = bound(*mxu_work(body, k, c, p, n, sectors=False))[0]
            print(f"mxu split (K={k}, NS={n}): {100 * rec['bound_ms'] / rec['ms']:.1f}% of its bound "
                  f"{rec['bound_ms']:.4f} ms at 32 bytes a row, {100 * word_ms / rec['ms']:.1f}% of "
                  f"{word_ms:.4f} ms at 8")
    del patches

    # exp_r3_gather_probe.py phase_lane / phase_sublane: a (128, 512) tile.
    # Beside the call times (cuda_ms over Python calls, the host's dispatch
    # included), the device times (device_ms: the calls in a CUDA graph),
    # each alternated with torch.take_along_dim's.
    x = torch.randn((128, 512), generator=gen, device=dev)
    for phase, axis, hi in (("lane", 1, 512), ("sublane", 0, 128)):
        idx = rand_i32(hi, (128, 512))
        idx_l = idx.long()
        run_k = lambda idx=idx, axis=axis: probes.take_along(x, idx, axis)  # noqa: E731
        lib = lambda idx_l=idx_l, axis=axis: torch.take_along_dim(x, idx_l, dim=axis)  # noqa: E731
        name = f"take_along[phase_{phase}]"
        rec = out[name] = hold(
            f"take_along axis {axis} (phase_{phase}, 128x512)", run_k,
            lambda idx=idx, axis=axis: probes.take_along_plain(x, idx, axis), 3 * x.numel() * 4, lib=lib)
        rec["ms"], rec["library_ms"] = alternate(run_k, lib, cuda_ms)
        rec["device_ms"], rec["library_device_ms"] = alternate(run_k, lib, device_ms)
        print(f"{name}: call {rec['ms']:.4f} ms against torch.take_along_dim {rec['library_ms']:.4f} ms "
              f"({'no slower' if rec['ms'] <= rec['library_ms'] else 'slower'}); device {rec['device_ms']:.4f} ms "
              f"against {rec['library_device_ms']:.4f} ms "
              f"({'no slower' if rec['device_ms'] <= rec['library_device_ms'] else 'slower'}); "
              f"bound {rec['bound_ms']:.4f} ms")
    # Its scalar path at the edges of x: one or two rows of x on axis 0 (a
    # lane past a row's end must read nothing), widths not a multiple of 4,
    # indices outside x (NaN); bitwise to the plain version.
    for axis, x_shape, idx_shape in ((0, (1, 130), (5, 130)), (0, (2, 1), (7, 1)), (1, (5, 1), (5, 130)),
                                     (1, (3, 7), (3, 6))):
        xs = torch.randn(x_shape, generator=gen, device=dev)
        ids = torch.randint(-1, x_shape[axis] + 1, idx_shape, generator=gen, device=dev, dtype=torch.int32)
        got, ref = probes.take_along(xs, ids, axis), probes.take_along_plain(xs, ids, axis)
        require(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
                f"take_along axis {axis}, x {x_shape}, idx {idx_shape}: bitwise equal to its plain version")
    print("take_along: thin and ragged shapes with out-of-range indices bitwise equal to its plain version")

    # exp_r5_pfused.py phase_trig: an (8, 128) uniform(-7, 7) tile, held
    # bitwise to its plain version (ops/trig.py: the C library's atan2f,
    # cosf and sinf, as cv_tpu's jnp functions compute them on a CPU).
    xt = torch.rand((8, 128), generator=gen, device=dev) * 14.0 - 7.0
    got, ref = probes.trig_probe(xt), probes.trig_probe_plain(xt)
    torch.cuda.synchronize()
    for i, fname in enumerate(("atan2", "cos", "sin", "mod")):
        print(f"trig probe {fname}: bitwise equal to its plain version {same_bits(got[i], ref[i])}, max diff "
              f"{float((got[i] - ref[i]).abs().max()):.3e}")
    require(same_bits(got, ref), "trig probe bitwise equal to its plain version")
    kms, pms = alternate(lambda: probes.trig_probe(xt), lambda: probes.trig_probe_plain(xt), cuda_ms)
    kdev, pdev = alternate(lambda: probes.trig_probe(xt), lambda: probes.trig_probe_plain(xt), device_ms)
    n = xt.shape[1]
    rec = out["trig_probe"] = kernel_record(kms, pms, float((got - ref).abs().max()), 6 * n * 4,
                                            TRIG_OPS["probe"] * n, device_ms=kdev, plain_device_ms=pdev)
    print(f"trig probe: kernel {kms:.4f} ms, plain {pms:.4f} ms, library none; device (a CUDA graph) {kdev:.4f} ms, "
          f"plain {pdev:.4f} ms; bound {rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    # The describe's forms at the KITTI batch's shapes (K = 8 x 512): the
    # orientation angles of (K, 109) samples and of the K chosen sums, cos
    # and sin of the K angles; the samples hold zeros, NaNs (a sample outside
    # the window) and tied values, held bitwise (a NaN by position).
    k = BATCH * SHAPES["kitti_k"]
    res = torch.randn((2, k, 109), generator=gen, device=dev) * torch.exp(
        torch.rand((2, k, 109), generator=gen, device=dev) * 10.0 - 5.0)
    res[:, :, ::7] = 0.0
    res[0, ::5, 3] = float("nan")
    res[1, ::3, 4] = res[0, ::3, 4]
    ry, rx = res[0], res[1]
    sy, sx = ry[:, 0].contiguous(), rx[:, 0].contiguous()
    ang_k = trig.angle_cv(sy, sx)
    pairs = (("angle_cv (K, 109)", lambda: trig.angle_cv(ry, rx), lambda: trig.angle_cv_plain(ry, rx), 3 * ry.numel()),
             ("angle_cv (K,)", lambda: trig.angle_cv(sy, sx), lambda: trig.angle_cv_plain(sy, sx), 3 * k),
             ("cos_sin (K,)", lambda: trig.cos_sin(ang_k), lambda: trig.cos_sin_plain(ang_k), 3 * k))
    for label, run_k, run_p, words in pairs:
        got, ref = (torch.cat(r) if isinstance(r, tuple) else r for r in (run_k(), run_p()))
        torch.cuda.synchronize()
        require(same_bits(got, ref), f"trig {label}: bitwise equal to its plain version")
        fms, fpms = alternate(run_k, run_p, cuda_ms)
        fdev, fpdev = alternate(run_k, run_p, device_ms)
        ops = TRIG_OPS["cos_sin" if label.startswith("cos") else "angle"] * (words // 3)
        b_ms, b_by = bound(words * 4, ops)
        rec[label] = dict(ms=fms, plain_ms=fpms, device_ms=fdev, plain_device_ms=fpdev, bound_ms=b_ms)
        if label.startswith("cos"):  # the library yardstick: torch.cos plus torch.sin (angle_cv's wrap has none)
            rec[label]["library_ms"] = cuda_ms(lambda: (torch.cos(ang_k), torch.sin(ang_k)))
        print(f"trig {label}: bitwise equal ({int(torch.isnan(ref).sum())} NaN in the same places); kernel {fms:.4f} "
              f"ms, plain {fpms:.4f} ms; device (a CUDA graph) {fdev:.4f} ms, plain {fpdev:.4f} ms; library "
              f"{rec[label].get('library_ms', float('nan')):.4f} ms; bound {b_ms:.6f} ms ({b_by})")
    # The launch floor: an empty kernel of one block from the same library.
    rec["empty_ms"] = cuda_ms(lambda: trig.empty_launch(dev))
    rec["empty_device_ms"] = device_ms(lambda: trig.empty_launch(dev))
    print(f"trig empty launch: call {rec['empty_ms']:.4f} ms, device (a CUDA graph) {rec['empty_device_ms']:.4f} ms")
    return out


def npz_arrays(path):
    """Every array of an npz checkpoint, by key."""
    import numpy as np

    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def same_checkpoint(a, b):
    """The keys whose arrays differ (value, dtype or shape) between two
    checkpoints' arrays."""
    import numpy as np

    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]))


def sandbox_frames(work):
    """Render the sandbox's frames and write them as PNGs into ``work``;
    returns ``(paths, (fx, fy, cx, cy), per-frame row filter counts, the
    frames' true poses)``."""
    import numpy as np

    from cv_tpu_torch.apps.synth import render_sequence
    from cv_tpu_torch.utils.png import write_png

    images, intrinsics, true_poses = render_sequence(
        n_frames=SANDBOX["run1"] + SANDBOX["run2"], height=SANDBOX["height"], width=SANDBOX["width"],
        n_points=SANDBOX["n_points"], seed=SANDBOX["seed"], fx=SANDBOX["fx"], fy=SANDBOX["fy"])
    paths, filters = [], []
    for i, img in enumerate(images):
        paths.append(os.path.join(work, f"frame-{i:03d}.png"))
        filters.append(np.bincount(write_png(paths[-1], img), minlength=5).tolist())
    return paths, intrinsics, filters, true_poses


def sandbox_argv(work, run, intrinsics, frames):
    """The sandbox's command line for one run: the shared checkpoint, no
    settings file, the run's own output directory, the renderer's pinhole
    intrinsics without distortion (as tests/test_pipelines.py:155-166 passes
    KITTI's)."""
    out = os.path.join(work, f"out-{run}")
    os.makedirs(out, exist_ok=True)
    fx, fy, cx, cy = intrinsics
    return out, ["-d", os.path.join(work, "vslam.cvr"), "-s", os.path.join(work, "no-settings.json"), "-o", out,
                 "--x-focal", repr(fx), "--y-focal", repr(fy), "--x-center", repr(cx), "--y-center", repr(cy),
                 "--radial-distortion", "0", *frames]


@contextlib.contextmanager
def sandbox_hooks(dev):
    """Time the sandbox's phases and check its per-frame gates while the
    body runs.  Yields a dict: ``ms`` (phase -> [milliseconds a call];
    engine phases synchronized, PNG decode timed in the loader's threads),
    ``normalized`` ([(reconstruction, max |first view pose - identity|)]),
    ``exports`` ([(reconstruction, vertices in the file, robust landmarks, views)]),
    ``loaded`` (the arrays of a save of each loaded checkpoint, taken before
    the engine touches it, and its feeds' intrinsics devices)."""
    import numpy as np
    import torch

    from cv_tpu_torch.akaze import extract
    from cv_tpu_torch.sfm import VSlam, VSlamData, host_geom
    from cv_tpu_torch.sfm.serialize import save_npz
    from cv_tpu_torch.utils import loader

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    hooks = dict(ms={}, normalized=[], exports=[], loaded=[])
    saved = []

    def patch(owner, attr, phase, after=None, synced=True):
        raw = owner.__dict__[attr]
        static = isinstance(raw, staticmethod)
        fn = raw.__func__ if static else raw
        hooks["ms"].setdefault(phase, [])

        def timed(*a, **kw):
            if synced:
                sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if synced:
                sync()
            hooks["ms"][phase].append((time.perf_counter() - t0) * 1e3)
            if after is not None:
                after(out, *a, **kw)
            return out

        saved.append((owner, attr, raw))
        setattr(owner, attr, staticmethod(timed) if static else timed)

    def normalized(_, engine, reconstruction):
        rec = engine.data.reconstructions.get(reconstruction)
        if rec is not None and rec.views:
            r, t = next(iter(rec.views.values())).pose
            hooks["normalized"].append((reconstruction, float(max(np.abs(r - np.eye(3)).max(), np.abs(t).max()))))

    def exported(_, engine, reconstruction, path, camera_faces=True):
        rec = engine.data.reconstructions[reconstruction]
        robust = 0
        for landmark in rec.landmarks:
            hp = engine.triangulate_landmark_robust(reconstruction, landmark)
            robust += hp is not None and host_geom.point_of(hp) is not None
        with open(path) as f:
            vertices = next(int(line.split()[2]) for line in f if line.startswith("element vertex"))
        hooks["exports"].append((reconstruction, vertices, robust, len(rec.views)))

    def loaded(data, path, device="cuda"):
        keep = os.path.join(os.path.dirname(os.path.abspath(path)), "loaded-resave.cvr")
        save_npz(data, keep)
        devices = sorted({str(f.intrinsics.simple_intrinsics.focals.device) for f in data.feeds.values()
                          if f.intrinsics is not None})
        hooks["loaded"].append((npz_arrays(keep), devices))

    for method, phase in (("kps_descriptors", "extract"), ("init_reconstruction", "init"),
                          ("init_two_view", "init: two-view (of init)"), ("register_frame", "registration"),
                          ("_dispatch_ba_filter", "ba+filter"), ("_finish_ba_filter", "ba+filter")):
        patch(VSlam, method, phase)
    patch(VSlam, "normalize_reconstruction", "normalize", normalized)
    patch(VSlam, "export_reconstruction", "export", exported)
    patch(VSlamData, "save", "save")
    patch(VSlamData, "load", "load", loaded)
    patch(extract, "load_gray", "png decode (loader thread)", synced=False)
    patch(loader, "load_gray_compiled", "png decode (loader thread)", synced=False)
    try:
        yield hooks
    finally:
        for owner, attr, raw in reversed(saved):
            setattr(owner, attr, raw)


def sandbox_phase(dev, counters, plains, tally, scan_calls, ba_calls):
    """Phase 6b: the vslam-sandbox app through ``main`` at its defaults,
    run 1 then run 2 resuming from run 1's checkpoint, each with the
    counters at zero; the gates of the module docstring.  The engine takes
    its default, the exact extractor: one dedup scan a frame over every
    candidate, the trig kernel for the angles, no select kernel.  Records
    the dedup scan's calls into ``scan_calls`` (replayed in phase 7) and
    graph BA's into ``ba_calls`` (held in phase 11), and replays A's, B's
    and C's calls on their own.  Returns per run: seconds, launches, phase ms, the median
    PNG decode ms."""
    import numpy as np
    import torch

    from cv_tpu_torch.akaze import extrema
    from cv_tpu_torch.akaze.extract import load_gray
    from cv_tpu_torch.apps import vslam_sandbox as sandbox_app
    from cv_tpu_torch.consensus import BatchConsensus
    from cv_tpu_torch.core import pose as pose_mod
    from cv_tpu_torch.sfm import device_refine
    from cv_tpu_torch.utils import loader
    from cv_tpu_torch.utils import png as png_mod

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_sandbox_run")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    os.environ["LOGLEVEL"] = "WARNING"
    t0 = time.perf_counter()
    paths, sb_intr, sb_filters, true_poses = sandbox_frames(work)
    print(f"sandbox frames: {len(paths)} rendered {SANDBOX['height']}x{SANDBOX['width']} star-field frames "
          f"({SANDBOX['n_points']} points, seed {SANDBOX['seed']}, fx {sb_intr[0]}, fy {sb_intr[1]}, cx {sb_intr[2]}, "
          f"cy {sb_intr[3]}) written as PNGs in {time.perf_counter() - t0:.2f} s; rows by filter type 0-4 "
          f"(None, Sub, Up, Average, Paeth): {np.sum(sb_filters, axis=0).tolist()}")
    # The loader's compiled decode against the plain one, on the first frames.
    for path in paths[:2]:
        t0 = time.perf_counter()
        plain_img = load_gray(path)
        plain_s = time.perf_counter() - t0
        compiled_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            compiled_img = loader.load_gray_compiled(path)
            compiled_s.append(time.perf_counter() - t0)
        require(np.array_equal(compiled_img, plain_img),
                f"{path}: the compiled unfilter bitwise equal to the plain walk")
        print(f"png decode {os.path.basename(path)}: plain walk {plain_s * 1e3:.1f} ms, compiled unfilter "
              f"{statistics.median(compiled_s) * 1e3:.1f} ms (median of 3), bitwise equal")
    sandbox, split, feed_base = {}, SANDBOX["run1"], {}
    for run, frames in (("run1", paths[:split]), ("run2", paths[split:])):
        out_dir, argv = sandbox_argv(work, run, sb_intr, frames)
        png_mod.unfilter.calls = 0
        with sandbox_hooks(dev) as hooks, main_path(counters, plains + [(png_mod, "unfilter_plain")]) as sb_run, \
                recording(extrema, "dedup_scan_device") as scan_calls[f"sandbox {run}"], \
                recording(device_refine, "graph_ba_core") as ba_calls[f"sandbox {run}"], \
                record_pose_calls() as sb_pose, recording(pose_mod, "c2c_residual", first_calls(1)) as sb_res, \
                recording(pose_mod, "c2c_score", first_calls(1)) as sb_score_calls, \
                recording(BatchConsensus, "_score_stage", first_calls(1)) as sb_scores:
            t0 = time.perf_counter()
            sb_engine = sandbox_app.main(argv, device=dev)
            torch.cuda.synchronize()
            sb_s = time.perf_counter() - t0
        recs = sb_engine.data.reconstructions
        new_feeds = sorted(set(sb_engine.data.feeds) - set(feed_base))
        require(len(new_feeds) == 1, f"sandbox {run}: new feeds {new_feeds}")
        feed_base[new_feeds[0]] = 0 if run == "run1" else split
        launches = sb_run["launches"]
        print(f"sandbox {run}: {len(frames)} frames in {sb_s:.3f} s ({len(frames) / sb_s:.4f} fps), "
              f"{len(recs)} reconstructions, launches select_groups {launches['select_groups']}, dedup_scan "
              f"{launches['dedup_scan']}, single_view_l2 {launches['single_view_l2']}, three_view_l2 "
              f"{launches['three_view_l2']}, three_view_adaptive {launches['three_view_adaptive']}, select_samples "
              f"{launches['select_samples']}, select_fused {launches['select_fused']}, angle_cv "
              f"{launches['angle_cv']}, cos_sin {launches['cos_sin']}, atan2 {launches['atan2']}, jacobi "
              f"{launches['jacobi']}, c2c_residual {launches['c2c_residual']}, c2c_score {launches['c2c_score']}, "
              f"graph_ba {launches['graph_ba']}; compiled unfilter calls "
              f"{png_mod.unfilter.calls}; plain-version calls {sb_run['plain']}")
        require(png_mod.unfilter.calls == len(frames), f"sandbox {run}: {png_mod.unfilter.calls} compiled decodes")
        scan_steps_run = [int(scan_steps(args).max()) for args, _ in scan_calls[f"sandbox {run}"]]
        print(f"sandbox {run}: the exact extractor's dedup scan, steps a frame (every candidate) {scan_steps_run}")
        expect = dict(select_groups=0, select_samples=0, select_fused=0, dedup_scan=len(frames), graph_ba=(1,),
                      **TRIG_LAUNCHED, **SCALE_SPACE_LAUNCHED)
        if run == "run1":
            expect.update(single_view_l2=(1,), three_view_l2=(1,), three_view_adaptive=(1,), jacobi=(1,),
                          c2c_residual=(1,), c2c_score=(1,))
        tally(sb_run, **expect)
        if run == "run1" or sb_res:
            hold_recorded_residuals(sb_res, sb_score_calls, sb_scores, f"the sandbox {run}'s first two-view consensus")
        del sb_res, sb_score_calls, sb_scores
        ms = hooks["ms"]
        decode = ms.pop("png decode (loader thread)")
        print(f"sandbox {run} phases (ms, synchronized; calls): "
              + ", ".join(f"{k} {sum(v):.1f} ({len(v)})" for k, v in ms.items())
              + f"; png decode a frame (loader thread) median {statistics.median(decode):.1f}, max {max(decode):.1f}")
        if run == "run1":
            require(len(recs) >= 1, "sandbox run 1: no reconstruction")
        for key, rec in recs.items():
            problems = sb_engine.sanity_check(key)
            require(problems == [], f"sandbox {run} reconstruction {key}: sanity_check {problems[:3]}")
        new_recs = {k for k, _ in hooks["normalized"]}
        for key, dev_max in hooks["normalized"]:
            require(dev_max < 1e-9, f"sandbox {run} reconstruction {key}: first view {dev_max} from identity")
        plys = sorted(os.listdir(out_dir))
        require(plys == sorted(f"reconstruction-{k}.ply" for k in new_recs),
                f"sandbox {run}: PLY files {plys} for the new reconstructions {sorted(new_recs)}")
        for key, vertices, robust, views in hooks["exports"]:
            require(vertices == robust + 5 * views,
                    f"sandbox {run} reconstruction {key}: {vertices} vertices, {robust} robust landmarks, {views} views")
        require(os.path.exists(argv[1]), f"sandbox {run}: {argv[1]} not written")
        live = os.path.join(work, f"live-{run}.cvr")
        sb_engine.data.save(live)
        differ = same_checkpoint(npz_arrays(argv[1]), npz_arrays(live))
        require(not differ, f"sandbox {run}: vslam.cvr differs from a save of the live state in {differ}")
        if run == "run2":
            require(len(hooks["loaded"]) == 1, f"sandbox run 2: {len(hooks['loaded'])} checkpoints loaded")
            arrays, devices = hooks["loaded"][0]
            differ = same_checkpoint(arrays, npz_arrays(os.path.join(work, "live-run1.cvr")))
            require(not differ, f"sandbox run 2: the loaded checkpoint differs from run 1's live state in {differ}")
            require(all(d.startswith("cuda") for d in devices), f"sandbox run 2: loaded intrinsics on {devices}")
        for key, rec in recs.items():
            frames_of = [sb_engine.data.frames[v.frame] for v in rec.views.values()]
            est = {feed_base[f.feed] + f.feed_frame: v.pose for f, v in zip(frames_of, rec.views.values())}
            ate_rel, rot_deg = trajectory_errors(est, true_poses)
            require(ate_rel < SANDBOX_POSE_GATES[0] and rot_deg < SANDBOX_POSE_GATES[1],
                    f"sandbox {run} reconstruction {key} (frames {sorted(est)}): ATE / extent {ate_rel:.5f}, worst "
                    f"consecutive rotation {rot_deg:.4f} deg (gates {SANDBOX_POSE_GATES})")
            # cv_tpu's app at these consensus budgets does not fit a CPU's
            # memory (PERF.md section 4), so there is no reference count.
            print(f"sandbox {run} reconstruction {key}: {len(rec.views)} views (frames {sorted(est)}), "
                  f"{len(rec.landmarks)} landmarks (cv_tpu's sandbox on these frames: not measured); sanity_check "
                  f"empty; against the rendered poses ATE / extent {ate_rel:.5f}, worst consecutive rotation "
                  f"{rot_deg:.4f} deg")
        print(f"sandbox {run}: first views of {sorted(new_recs)} at identity after normalize; PLY vertices = robust "
              f"landmarks + 5 a camera on all {len(hooks['exports'])} exports; vslam.cvr equals a save of the live "
              "state" + ("; the loaded checkpoint equals run 1's live state, intrinsics on " + ", ".join(devices)
                         if run == "run2" else ""))
        sandbox[run] = dict(seconds=sb_s, launches=launches, ms={k: sum(v) for k, v in ms.items()},
                            decode_ms=statistics.median(decode), pose=sb_pose)
        del sb_engine, recs
    for run in ("run1", "run2"):
        print(f"sandbox {run}: pose kernels' calls replayed")
        replay_pose_calls(sandbox[run].pop("pose"))
    shutil.rmtree(work, ignore_errors=True)
    return sandbox


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

    from cv_tpu_torch.akaze import FastAkazeExtractor
    from cv_tpu_torch.apps.synth import render_sequence
    from cv_tpu_torch.camera import CameraIntrinsics, CameraIntrinsicsK1Distortion
    from cv_tpu_torch.sfm import VSlam, VSlamSettings

    images, (fx, fy, cx, cy), true_poses = render_sequence(
        n_frames=n_frames, height=512, width=640, n_points=900, seed=0
    )
    engine = VSlam(settings=VSlamSettings(**SFM_SETTINGS), seed=0, extractor_cls=FastAkazeExtractor, device=dev)
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


def run_merge(dev, n_seg=MERGE_SEGMENT, seed=MERGE_SEED):
    """bench.py's loop-closure scenario through the port on ``dev``:
    ``render_sequence(n_frames=23, 512x640, n_points=1200, seed=5)``, the
    engine's ``FastAkazeExtractor`` at 1024 features, segment A (frames
    0-4), the far segment B (18-22), then the bridge frames 10-12, which
    retrieve both segments and must merge their reconstructions.  Returns
    ``(engine, reconstructions after each frame, merges, seconds)``."""
    import torch

    from cv_tpu_torch.akaze import FastAkazeExtractor
    from cv_tpu_torch.apps.synth import render_sequence
    from cv_tpu_torch.camera import CameraIntrinsics, CameraIntrinsicsK1Distortion
    from cv_tpu_torch.sfm import VSlam, VSlamSettings

    gap = int(2.7 * n_seg)
    n_total = n_seg + gap + n_seg
    images, (fx, fy, cx, cy), _ = render_sequence(n_frames=n_total, height=512, width=640, n_points=1200, seed=seed)
    mid = n_seg + gap // 2
    order = list(range(n_seg)) + list(range(n_seg + gap, n_total)) + [mid - 1, mid, mid + 1]
    engine = VSlam(settings=VSlamSettings(**MERGE_SETTINGS), seed=0, extractor_cls=FastAkazeExtractor, device=dev)
    intr = CameraIntrinsicsK1Distortion.new(CameraIntrinsics.from_values(fx, fy, cx, cy, device=dev), 0.0)
    merges = []
    real_merge = engine.try_merge_reconstructions

    def counted(*a, **kw):
        out = real_merge(*a, **kw)
        merges.append(out is not None)
        return out

    engine.try_merge_reconstructions = counted
    feed = engine.add_feed(intr)
    counts = []
    t0 = time.perf_counter()
    for i in order:
        engine.add_frame(feed, images[i])
        counts.append(len(engine.data.reconstructions))
    engine.flush_pending()
    torch.cuda.synchronize()
    return engine, counts, merges, time.perf_counter() - t0


def trajectory_errors(est, true_poses):
    """A reconstruction's poses ``est`` ({frame index: (R, t)}) against
    the rendered ``true_poses``: ATE / trajectory extent after Umeyama
    alignment of the camera centres, and the worst relative rotation error
    in degrees between frames consecutive in ``est``."""
    import numpy as np

    from cv_tpu_torch.sfm import se3

    def center(pose):
        return -pose[0].T @ pose[1]

    frames = sorted(est)
    est_c = np.stack([center(est[i]) for i in frames])
    true_c = np.stack([center(true_poses[i]) for i in frames])
    s, r, t = umeyama(est_c, true_c)
    resid = (s * est_c @ r.T + t) - true_c
    ate = float(np.sqrt((resid**2).sum(axis=1).mean()))
    extent = float(np.linalg.norm(true_c.max(axis=0) - true_c.min(axis=0)))
    worst = 0.0
    for i, k in zip(frames, frames[1:]):
        est_rel = se3.compose(est[k], se3.inverse(est[i]))
        true_rel = se3.compose(true_poses[k], se3.inverse(true_poses[i]))
        worst = max(worst, float(np.rad2deg(np.linalg.norm(se3.so3_log(est_rel[0].T @ true_rel[0])))))
    return ate / extent, worst


def sfm_gates(engine, true_poses, n_frames=SFM_FRAMES):
    """The gates of tests/test_sfm.py:620-674; returns (views, landmarks,
    ate / extent, worst consecutive rotation error in degrees)."""
    require(len(engine.data.reconstructions) == 1, f"{len(engine.data.reconstructions)} reconstructions")
    rec_key = next(iter(engine.data.reconstructions))
    rec = engine.data.reconstructions[rec_key]
    est = {engine.data.frames[v.frame].feed_frame: v.pose for v in rec.views.values()}
    require(len(est) == n_frames, f"only {len(est)}/{n_frames} frames registered")
    ate_rel, worst = trajectory_errors(est, true_poses)
    require(ate_rel < 0.02, f"ATE / extent {ate_rel:.4f}")
    require(worst < 1.0, f"consecutive rotation error {worst:.4f} deg")
    problems = engine.sanity_check(rec_key)
    require(problems == [], f"sanity_check: {problems[:3]}")
    return len(rec.views), len(rec.landmarks), ate_rel, worst


def staged(extractor, images, mode, reps):
    """Per-stage host milliseconds (synchronized) of ``extractor`` on
    ``images`` over ``reps`` runs, and the dedup kernel's time and steps."""
    import torch

    from cv_tpu_torch.akaze import extrema
    from cv_tpu_torch.akaze import fast as fast_mod
    from cv_tpu_torch.akaze.scale_space import build_scale_space

    scan = []
    real_scan = extrema.dedup_scan_device

    def timed_scan(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_scan(*a, **kw)
        torch.cuda.synchronize()
        scan.append(((time.perf_counter() - t0) * 1e3, a[-1].tolist()))
        return out

    timed_scan.launches = 0  # the wrapper counts on the name it is bound to

    cfg, k, m = extractor.config, extractor.candidate_budget, extractor.max_features
    specs = extractor.specs(*images.shape[-2:])
    stage_ms = {n: [] for n in ("scale_space", "candidates", "dedup", "refine_select", "describe")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stage_ms[name].append((time.perf_counter() - t0) * 1e3)
        return out

    extrema.dedup_scan_device = timed_scan
    try:
        for _ in range(reps):
            with torch.no_grad():
                planes = timed("scale_space", lambda: build_scale_space(cfg, specs, images))
                cand = timed("candidates", lambda: fast_mod.stage_candidates(cfg, specs, planes, k))
                cand = timed("dedup", lambda: fast_mod.stage_dedup(cand, k, extractor.dedup_scan_cap))
                sel = timed("refine_select", lambda: fast_mod.stage_refine_select(cfg, specs, cand, planes, k, m))
                fs = timed("describe", lambda: fast_mod.stage_describe(cfg, planes, sel, mode))
    finally:
        extrema.dedup_scan_device = real_scan
    return fs, {n: statistics.median(v) for n, v in stage_ms.items()}, scan


def scale_space_launches(specs, h, w):
    """The kernel launches of one ``build_scale_space`` of ``specs`` on
    ``h x w`` frames, at any batch: sep_filter 3 (the contrast factor's
    blur and Scharr pair, the base blur), a flow and its FED cycle's
    launches (``ops.fed_block_steps`` steps each) an evolution after the
    first, a detector response an evolution."""
    from cv_tpu_torch.ops import image as ops

    fed = 0
    for spec in specs[1:]:
        n, ho, wo = len(spec.fed_tau_steps), h >> spec.octave, w >> spec.octave
        fed += -(-n // ops.fed_block_steps(n, ho, wo)) if n else 0
    return dict(sep_filter=3, evolution_flow=len(specs) - 1, fed_cycle=fed, detector=len(specs))


@contextlib.contextmanager
def plain_scale_space():
    """The scale space's dispatchers (``ops/image.py``) bound to their
    plain versions while the body runs: the tensor chain that the kernels
    replace."""
    from cv_tpu_torch.ops import image as ops

    real = {spec[0]: getattr(ops, spec[0]) for spec in SCALE_SPACE_ROWS.values()}
    try:
        for dispatch, plain, _ in SCALE_SPACE_ROWS.values():
            setattr(ops, dispatch, getattr(ops, plain))
        yield
    finally:
        for dispatch, fn in real.items():
            setattr(ops, dispatch, fn)


def profiled_launches(fn):
    """``(kernel launches, device events)`` of ``fn()`` in the profiler's
    trace (copies and memsets are events, not launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    return sum(not n.startswith(("Memcpy", "Memset")) for n in names), len(names)


def hold_scale_space(label, cfg, specs, images, timed=False):
    """``images`` (B, H, W) on the card through ``build_scale_space``'s
    steps, each step's kernel (``ops/image.py``'s ``*_kernel``) and plain
    version called on the same inputs and held bitwise, the kernel's planes
    carried on; then the whole ``build_scale_space`` held to those planes.
    With ``timed``, each call's kernel and plain ms (CUDA events around 5
    and 3 Python calls, summed over the calls), the kernel's device ms (5
    calls captured in a CUDA graph: :func:`device_ms`) and, for sep_filter,
    one ``F.conv2d`` computing the same filters on the input padded
    beforehand (the library yardstick).  Returns, a row, the build's
    ``calls`` and their ``ms``, ``device_ms``, ``plain_ms``,
    ``library_ms``, ``nbytes`` and ``flops``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from cv_tpu_torch.akaze import scale_space as ss
    from cv_tpu_torch.ops import image as ops

    stats = {row: dict(calls=0, ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0, flops=0)
             for row in SCALE_SPACE_ROWS}
    kernel_of = {"sep_filter": ops.sep_filter_kernel, "evolution_flow": ops.evolution_flow_kernel,
                 "fed_cycle": ops.fed_cycle_kernel, "detector": ops.detector_kernel}

    def step(row, args, nbytes, flops, library=None):
        kernel, plain = kernel_of[row], getattr(ops, SCALE_SPACE_ROWS[row][1])
        got, want = kernel(*args), plain(*args)
        got_t, want_t = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        require(all(same_bits(g, w) for g, w in zip(got_t, want_t)),
                f"scale space, {label}: {row} call {stats[row]['calls']} differs from its plain version")
        st = stats[row]
        st["calls"] += 1
        st["nbytes"] += nbytes
        st["flops"] += flops
        if timed:
            st["ms"] += cuda_ms(lambda: kernel(*args), iters=5, warmup=1)
            st["device_ms"] += device_ms(lambda: kernel(*args), iters=5)
            st["plain_ms"] += cuda_ms(lambda: plain(*args), iters=3, warmup=1)
            if library is not None:
                st["library_ms"] += cuda_ms(library(), iters=5, warmup=1)
        return got

    def nz(taps):
        return int((np.asarray(taps) != 0).sum())

    def sep(x, *taps):
        """One sep_filter call of ``x`` with the tap pairs ``taps``."""
        pairs = list(zip(taps[0::2], taps[1::2]))
        n = x.numel()

        def conv():
            hy, hx = len(pairs[0][1]) // 2, len(pairs[0][0]) // 2
            weight = torch.stack([torch.as_tensor(np.outer(v, h)) for h, v in pairs])[:, None].to(x.device)
            padded = F.pad(x.reshape(-1, 1, *x.shape[-2:]), (hx, hx, hy, hy), mode="replicate")
            return lambda: F.conv2d(padded, weight)

        return step("sep_filter", (x, *taps), 4 * n * (1 + len(pairs)),
                    n * sum(2 * nz(h) + 2 * nz(v) - 2 for h, v in pairs), conv)

    blur = ops.gaussian_blur_kernel(1.0)
    main, off = ops.scharr_main_kernel(1), ops.scharr_off_kernel(1)
    sep(sep(images, blur, blur), main, off, off, main)
    contrast = ss.compute_contrast_factor(images, cfg.contrast_percentile, 1.0, cfg.contrast_factor_num_bins)
    base = ops.gaussian_blur_kernel(cfg.base_scale_offset)
    lt = sep(images, base, base)
    lts, lsmooths = [lt], [lt]
    for i in range(1, len(specs)):
        if specs[i].octave > specs[i - 1].octave:
            lt = ops.half_size(lt)
            contrast = contrast * 0.75
        n = lt.numel()
        lsmooth, flow = step("evolution_flow", (lt, contrast),
                             SCALE_SPACE_BYTES["evolution_flow"] * n + 4 * lt.shape[0],
                             SCALE_SPACE_OPS["evolution_flow"] * n)
        taus = specs[i].fed_tau_steps
        lt = step("fed_cycle", (lt, flow, taus), SCALE_SPACE_BYTES["fed_cycle"] * n,
                  SCALE_SPACE_OPS["fed_cycle"] * n * len(taus))
        lts.append(lt)
        lsmooths.append(lsmooth)
    dets = []
    for spec, lsm in zip(specs, lsmooths):
        s = int(round(spec.esigma * cfg.derivative_factor / spec.ratio))
        dets.append(step("detector", (lsm, s), SCALE_SPACE_BYTES["detector"] * lsm.numel(),
                         SCALE_SPACE_OPS["detector"] * lsm.numel()))
    planes = ss.build_scale_space(cfg, specs, images)
    for e, (p, lt_e, lsm_e, (lx, ly, ldet)) in enumerate(zip(planes, lts, lsmooths, dets)):
        require(all(same_bits(a, b) for a, b in ((p.lt, lt_e), (p.lsmooth, lsm_e), (p.lx, lx), (p.ly, ly),
                                                  (p.ldet, ldet))),
                f"scale space, {label}: build_scale_space's evolution {e} differs from the held steps")
    calls = {row: st["calls"] for row, st in stats.items()}
    print(f"scale space, {label}: {len(specs)} evolutions of {tuple(images.shape)}, calls {calls}, each bitwise to "
          "its plain version on the card (fed_cycle at every evolution); build_scale_space bitwise to the held steps")
    return stats


def scale_space_builds(cfg, specs, images):
    """Two functions of no arguments: ``build_scale_space(cfg, specs,
    images)`` through the kernels, and through the plain chain."""
    from cv_tpu_torch.akaze import scale_space as ss

    def build():
        ss.build_scale_space(cfg, specs, images)

    def plain_build():
        with plain_scale_space():
            ss.build_scale_space(cfg, specs, images)

    return build, plain_build


def profile_scale_space():
    """Run by :func:`check_scale_space` in a process of its own: the
    profiler's ``(kernel launches, device events)`` of one
    ``build_scale_space`` of the KITTI pair at B=8 with the kernels and with
    the plain chain, printed as one JSON line."""
    import numpy as np
    import torch

    from cv_tpu_torch import kernels
    from cv_tpu_torch.akaze import Akaze, load_gray, to_gray_f32
    from cv_tpu_torch.akaze.config import allocate_evolutions
    from cv_tpu_torch.utils import kitti_pair

    kernels.build_all(["scale_space"])
    pair = np.stack([to_gray_f32(load_gray(p)) for p in kitti_pair()])
    images = torch.as_tensor(np.concatenate([pair] * (BATCH // 2)), device="cuda")
    cfg = Akaze.sparse()
    build, plain_build = scale_space_builds(cfg, allocate_evolutions(cfg, images.shape[-1], images.shape[-2]), images)
    build()
    plain_build()
    torch.cuda.synchronize()
    print(json.dumps({"kernels": profiled_launches(build), "plain": profiled_launches(plain_build)}))


def check_scale_space(dev, pair):
    """Phase 3's scale space (``csrc/scale_space.cu``): each entry bitwise
    to its plain version at every call of a ``build_scale_space``
    (:func:`hold_scale_space`) of five configurations: the KITTI pair
    ``pair`` as B=8 at ``Akaze.sparse()`` (timed), as B=2 at ``Akaze()``
    (the dense path), frame 0 alone at ``Akaze()`` (the exact extractor),
    an SfM frame (512x640) and a sandbox frame (1080x1920) of their rendered
    sequences at ``Akaze()`` (their engines' extractors).  At KITTI B=8 the
    whole build's host ms ending in a sync with the kernels and with the
    plain chain (:func:`plain_scale_space`), in turns, and the profiler's
    launches of each (:func:`profile_scale_space`, in a process of its
    own).  Returns the four rows' records (KITTI B=8 figures:
    the summed calls of one build)."""
    import numpy as np
    import torch

    from cv_tpu_torch.akaze import Akaze, to_gray_f32
    from cv_tpu_torch.akaze.config import allocate_evolutions
    from cv_tpu_torch.apps.synth import render_sequence

    sfm = render_sequence(n_frames=SFM_FRAMES, height=512, width=640, n_points=900, seed=0)[0][0]
    sandbox = render_sequence(n_frames=SANDBOX["run1"] + SANDBOX["run2"], height=SANDBOX["height"],
                              width=SANDBOX["width"], n_points=SANDBOX["n_points"], seed=SANDBOX["seed"],
                              fx=SANDBOX["fx"], fy=SANDBOX["fy"])[0][0]
    kitti = torch.as_tensor(np.concatenate([pair] * (BATCH // 2)), device=dev)
    configs = (("KITTI B=8", Akaze.sparse(), kitti), ("dense B=2", Akaze(), torch.as_tensor(pair, device=dev)),
               ("exact frame", Akaze(), torch.as_tensor(pair[:1], device=dev)),
               ("SfM frame", Akaze(), torch.as_tensor(to_gray_f32(sfm)[None], device=dev)),
               ("sandbox frame", Akaze(), torch.as_tensor(to_gray_f32(sandbox)[None], device=dev)))
    held = {}
    for label, cfg, images in configs:
        specs = allocate_evolutions(cfg, images.shape[-1], images.shape[-2])
        held[label] = hold_scale_space(label, cfg, specs, images, timed=label == "KITTI B=8")
    cfg, images = configs[0][1], configs[0][2]
    specs = allocate_evolutions(cfg, images.shape[-1], images.shape[-2])

    build, plain_build = scale_space_builds(cfg, specs, images)
    build()
    plain_build()
    stage_ms, stage_plain_ms = alternate(build, plain_build, lambda fn: statistics.median(wall_ms(fn, reps=5)))
    # The profiler runs in a process of its own: after a trace here, phase
    # 11's traces of graph BA came back empty on the card.
    proc = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.profile_scale_space()"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"scale space: the profiler's process failed:\n{proc.stderr[-3000:]}")
    profiled = json.loads(proc.stdout.strip().splitlines()[-1])
    launches, plain_launches = profiled["kernels"], profiled["plain"]
    if launches[1]:
        require(launches[0] <= SCALE_SPACE_MAX_LAUNCHES,
                f"scale space, KITTI B=8: {launches[0]} launches (at most {SCALE_SPACE_MAX_LAUNCHES})")
        note = (f"launches (profiler) {launches[0]} ({launches[1]} device events), the plain chain {plain_launches[0]} "
                f"({plain_launches[1]})")
    else:
        note = "launches: the profiler saw no device events"
    print(f"scale space, KITTI B=8 (one build_scale_space): {stage_ms:.3f} ms with the kernels, {stage_plain_ms:.3f} "
          f"ms with the plain chain (host ms ending in a sync, medians of 5, in turns); {note}; the entries' device ms "
          "summed over the build's calls: " + ", ".join(
              f"{row} {st['calls']} calls {st['ms']:.4f} (device {st['device_ms']:.4f}, plain {st['plain_ms']:.4f})"
              for row, st in held["KITTI B=8"].items()))
    records = {}
    for row, st in held["KITTI B=8"].items():
        records[row] = kernel_record(st["ms"], st["plain_ms"], 0.0, st["nbytes"], st["flops"],
                                     library_ms=st["library_ms"] if row == "sep_filter" else None,
                                     calls=st["calls"], device_ms=st["device_ms"], stage_ms=stage_ms, stage_plain_ms=stage_plain_ms,
                                     stage_launches=launches[0] if launches[1] else None,
                                     stage_plain_launches=plain_launches[0] if plain_launches[1] else None)
    return records


def exact_path(dev, counters, plains, tally, scan_calls):
    """Phase 4b: ``AkazeExtractor`` on the KITTI pair at full size, at
    ``Akaze.sparse()`` (the Rust reference's goldens [399, 343] keypoints and
    11 ``match_descriptors`` matches) and at ``Akaze()`` (cv_tpu's pinned
    [3425, 2908]; the word checksums printed beside its 31033516 /
    113943370), each pair with the counters at zero: the dedup scan once an
    extract, the trig kernel for the angles and no select kernel.  Records
    the scan's calls as path ``exact`` (replayed in phase 7: keep mask and
    slot output bitwise to the plain version).  Then each frame at
    ``Akaze()`` against the port's CPU run, stage by stage, with the
    differing word rows printed (:func:`word_rows`; gated in phase 9).  Returns the warm extract ms a
    frame, the word rows' reports and the ``Akaze()`` words of the pair."""
    import numpy as np

    from cv_tpu_torch.akaze import Akaze, AkazeExtractor, extrema, load_gray
    from cv_tpu_torch.matching import match_descriptors
    from cv_tpu_torch.utils import kitti_pair

    frames = [load_gray(p) for p in kitti_pair()]
    exact_ms = {}
    for label, cfg, want in (("sparse", Akaze.sparse(), KITTI_KEYPOINTS), ("default", Akaze(), DENSE_KEYPOINTS)):
        ex = AkazeExtractor(cfg, device=dev)
        with main_path(counters, plains) as run, recording(extrema, "dedup_scan_device") as calls:
            out = [ex.extract(img) for img in frames]
        scan_calls.setdefault("exact", []).extend(calls)
        counts = [len(kp["response"]) for kp, _ in out]
        sums = [int(np.asarray(w, np.uint64).sum() % 2**31) for _, w in out]
        cands = [int(args[0].shape[1]) for args, _ in calls]
        exact_ms[label] = [round(statistics.median(wall_ms(lambda img=img: ex.extract(img), reps=3)), 3)
                           for img in frames]
        line = (f"exact {label} (threshold {cfg.detector_threshold}): keypoints {counts} (goldens {want}), candidates "
                f"scanned {cands}, word checksums {sums}")
        if label == "sparse":
            ia, _ = match_descriptors(out[0][1], out[1][1], device=dev)
            line += f", match_descriptors {len(ia)} matches (golden {KITTI_MATCHES})"
        else:
            line += " (cv_tpu's pinned [31033516, 113943370])"
        print(line + f"; extract ms a frame {exact_ms[label]}; launches {run['launches']}")
        tally(run, dedup_scan=len(frames), select_samples=0, select_groups=0, select_fused=0, **TRIG_LAUNCHED,
              **SCALE_SPACE_LAUNCHED)
        require(counts == want, f"exact {label}: keypoints {counts}, goldens {want}")
        if label == "sparse":
            require(len(ia) == KITTI_MATCHES, f"exact sparse: {len(ia)} matches")
        for kp, words in out:
            require(words.shape == (len(kp["response"]), 16) and words.dtype == np.uint32, "exact words")
            require(np.isfinite(kp["point"]).all() and np.isfinite(kp["angle"]).all(), "exact finite keypoints")
            require(bool(np.all(np.diff(kp["response"]) <= 0)), "exact keypoints sorted by response")
    reports = [word_rows(dev, Akaze(), img, f"exact frame {i} Akaze(), card against CPU") for i, img in enumerate(frames)]
    return exact_ms, reports, np.concatenate([words for _, words in out])


def _ulps(a, b):
    """Distance in float32 units in the last place (same sign)."""
    import numpy as np

    return int(abs(int(np.float32(a).view(np.int32)) - int(np.float32(b).view(np.int32))))


def word_rows(dev, cfg, img, label, limit=8):
    """The exact extractor on frame ``img`` at ``cfg``, on the card and on
    the port's CPU path, compared stage by stage: the scale-space planes
    (evolutions bitwise equal, the most pixels that differ in one, the
    largest difference), the keypoints (count, points, angles bitwise) and
    the word rows.  For each differing row (the first ``limit`` printed): its
    index, evolution, the differing bit positions, the angle on each device
    and their distance in ulps, the M-LDB sample positions that round
    differently, and for each differing bit the two compared cell values on
    each device.  Returns a dict: ``rows``, ``unequal`` (word rows),
    ``angles`` (unequal angles), ``moved`` (differing rows with a sample
    position that moved), ``planes_equal``, ``counts`` (card, CPU)."""
    import numpy as np
    import torch

    from cv_tpu_torch.akaze import AkazeExtractor
    from cv_tpu_torch.akaze import descriptors as desc
    from cv_tpu_torch.akaze.extract import _evolution_tables, to_gray_f32
    from cv_tpu_torch.akaze.scale_space import build_scale_space

    cpu = torch.device("cpu")
    runs = []
    for d in (dev, cpu):
        ex = AkazeExtractor(cfg, device=d)
        kp, words = ex.extract(img)
        gray = torch.as_tensor(to_gray_f32(img), device=d)
        specs = ex.specs(*gray.shape)
        runs.append(dict(kp=kp, words=words, device=d, planes=build_scale_space(cfg, specs, gray[None]),
                         tables=_evolution_tables(tuple(specs), cfg.derivative_factor, d)))
    card, host = runs
    worst_px, worst_diff, planes_equal = 0, 0.0, 0
    for pg, pc in zip(card["planes"], host["planes"]):
        same = True
        for name in ("lt", "lx", "ly", "ldet"):
            a, b = getattr(pg, name).cpu().numpy(), getattr(pc, name).numpy()
            n = int((a.view(np.int32) != b.view(np.int32)).sum())
            same &= n == 0
            worst_px = max(worst_px, n)
            worst_diff = max(worst_diff, float(np.abs(a - b).max()))
        planes_equal += same
    kg, kc = card["kp"], host["kp"]
    out = dict(counts=(len(kg["response"]), len(kc["response"])), planes_equal=planes_equal,
               rows=len(kc["response"]), unequal=0, angles=0, moved=0, points_equal=False, evolutions=0)
    print(f"{label}: scale space {planes_equal} of {len(card['planes'])} evolutions bitwise equal card to CPU "
          f"(most differing pixels in one plane {worst_px}, largest difference {worst_diff:.3e}); keypoints "
          f"{out['counts']}")
    if out["counts"][0] != out["counts"][1]:
        return out
    same_point = (kg["point"].view(np.int32) == kc["point"].view(np.int32)).all(axis=1)
    same_angle = kg["angle"].view(np.int32) == kc["angle"].view(np.int32)
    diff_rows = np.nonzero((card["words"] != host["words"]).any(axis=1))[0]
    out.update(unequal=len(diff_rows), angles=int((~same_angle).sum()), points_equal=bool(same_point.all()),
               evolutions=len(card["planes"]))
    ps = cfg.descriptor_pattern_size
    for shown, k in enumerate(diff_rows):
        e = int(kc["class_id"][k])
        p = float(2.0 ** int(kc["octave"][k]))
        per = {}
        for name, run in (("card", card), ("cpu", host)):
            d = run["device"]
            pt = torch.as_tensor(run["kp"]["point"][k:k + 1], device=d)
            ang = torch.as_tensor(run["kp"]["angle"][k:k + 1], device=d)
            scale = run["tables"]["ssamp"][e:e + 1]
            x1, y1, co, si = desc._mldb_sample_positions(pt[:, 0] / p, pt[:, 1] / p, scale, ang, ps)
            pl = run["planes"][e]
            h, w = pl.lt.shape[-2:]
            xs, ys = x1[0].long().clamp(0, w - 1), y1[0].long().clamp(0, h - 1)
            vals = torch.stack([pl.lt[0][ys, xs], pl.lx[0][ys, xs], pl.ly[0][ys, xs]])[None]  # (1, 3, U)
            t = desc._mldb_device_tables(ps, d)
            means = desc.cell_means(vals, t["cell_members"], t["inv_counts"])[0]  # (3, 29)
            di, sx, sy = means[0], means[1], means[2]
            cells = torch.stack([di, -sx * si[0] + sy * co[0], sx * co[0] + sy * si[0]], dim=-1)  # (29, 3)
            per[name] = dict(x=x1[0].cpu().numpy(), y=y1[0].cpu().numpy(), cells=cells.cpu().numpy(),
                             ci=t["ci"].cpu().numpy(), cj=t["cj"].cpu().numpy(), ch=t["ch"].cpu().numpy())
        g, c = per["card"], per["cpu"]
        moved = np.nonzero((g["x"] != c["x"]) | (g["y"] != c["y"]))[0]
        out["moved"] += int(len(moved) > 0)
        if shown >= limit:
            continue
        xor = (card["words"][k] ^ host["words"][k]).astype(np.uint32)
        bits = [32 * wi + b for wi in range(16) for b in range(32) if (int(xor[wi]) >> b) & 1]
        ag, ac = float(kg["angle"][k]), float(kc["angle"][k])
        cmp = []
        for b in bits[:4]:
            i, j, ch = int(c["ci"][b]), int(c["cj"][b]), int(c["ch"][b])
            cmp.append(f"bit {b} (cell {i} vs {j}, channel {ch}): card {g['cells'][i, ch]:.9e} vs "
                       f"{g['cells'][j, ch]:.9e}, cpu {c['cells'][i, ch]:.9e} vs {c['cells'][j, ch]:.9e}")
        pos = ", ".join(f"sample {u}: card ({g['x'][u]}, {g['y'][u]}) cpu ({c['x'][u]}, {c['y'][u]})"
                        for u in moved[:3])
        print(f"{label} row {k}: evolution {e}, point bitwise equal {bool(same_point[k])}, bits {bits}, angle "
              f"card {ag!r} cpu {ac!r} ({_ulps(ag, ac)} ulp), {len(moved)} sample positions moved"
              + (f" ({pos})" if pos else "") + "; " + "; ".join(cmp))
    print(f"{label}: {out['unequal']} of {out['rows']} word rows differ card to CPU ({out['moved']} of them with a "
          f"sample position that moved), {out['angles']} angles differ, points bitwise equal "
          f"{bool(same_point.all())}")
    return out


def tf32_invariance(dev, seed):
    """Each product the port takes gives the same bits whatever the caller's
    TF32 setting: the KITTI pair's describe (the exact extractor at
    ``Akaze.sparse()``, ``DeviceExtractor`` in its default mode and in
    ``'highest'``) and a pose pipeline (eight-point consensus on seeded
    float32 and float64 bearings, Lambda-Twist and five-point on float32
    sets, the L2 and L1 single-view refinements in float32) run twice: as
    set (TF32 off), then with ``allow_tf32 = True`` and
    ``set_float32_matmul_precision("high")``; words and poses must be equal,
    and the settings are restored.  Returns the number of outputs held."""
    import numpy as np
    import torch

    from cv_tpu_torch.akaze import Akaze, AkazeExtractor, DeviceExtractor, load_gray, to_gray_f32
    from cv_tpu_torch.consensus import BatchConsensus, Estimator
    from cv_tpu_torch.core import Isometry3, WorldToCamera, camera_to_camera_residual, lie, projective
    from cv_tpu_torch.optimize import single_view_simple_optimize_l1, single_view_simple_optimize_l2
    from cv_tpu_torch.solvers import eight_point, lambda_twist, nister_stewenius
    from cv_tpu_torch.utils import kitti_pair

    frames = [load_gray(p) for p in kitti_pair()]
    batch = torch.as_tensor(np.stack([to_gray_f32(f) for f in frames]), device=dev)
    rng = np.random.default_rng(seed + 11)
    pose = Isometry3(rotation=lie.so3_exp(torch.tensor([0.05, -0.1, 0.04], dtype=torch.float64)),
                     translation=torch.tensor([0.3, -0.1, 0.05], dtype=torch.float64))
    pts = torch.as_tensor(rng.uniform([-2, -2, 4], [2, 2, 10], (256, 3)))
    a_h = projective.from_point(pts)
    bear_a, bear_b = projective.bearing(a_h), projective.bearing(pose.transform(a_h))
    bear_b = bear_b + torch.as_tensor(rng.normal(0.0, 1e-3, bear_b.shape))
    estimator = Estimator(8, 4, lambda s: eight_point.estimate(s[0], s[1]), lambda m, d: camera_to_camera_residual(
        Isometry3(m.rotation[..., None, :, :], m.translation[..., None, :]), d[0], d[1]))
    consensus = BatchConsensus(threshold=1e-3, hypotheses=256, refit_rounds=1, refit_hypotheses=64, device=dev)
    w2c = WorldToCamera(rotation=pose.rotation.float().to(dev), translation=pose.translation.float().to(dev))
    start = WorldToCamera(rotation=lie.so3_exp(torch.tensor([0.06, -0.09, 0.03], device=dev)) , translation=
                          torch.tensor([0.25, -0.05, 0.1], device=dev))
    world = projective.from_point(pts.float().to(dev))
    cam_bear = projective.bearing(w2c.transform(world))
    valid = torch.ones(256, dtype=torch.bool, device=dev)

    def run():
        out = {}
        out["exact"] = np.concatenate([AkazeExtractor(Akaze.sparse(), device=dev).extract(f)[1] for f in frames])
        for mode in (None, "highest"):
            fs = DeviceExtractor(Akaze.sparse(), 256, 512, device=dev, onehot_mode=mode).extract(batch)
            out[f"device {mode or 'default'}"] = fs.words.cpu().numpy()
        for dtype in (torch.float32, torch.float64):
            g = torch.Generator(device=dev).manual_seed(seed)
            model, mask, _ = consensus.model_inliers(g, estimator, (bear_a.to(dev, dtype), bear_b.to(dev, dtype)))
            out[f"consensus {dtype}"] = torch.cat([model.rotation.reshape(-1), model.translation,
                                                   mask.to(model.rotation.dtype)]).cpu().numpy()
        p3p, _ = lambda_twist.estimate(cam_bear[:24].reshape(8, 3, 3), world[:24].reshape(8, 3, 4))
        out["lambda_twist f32"] = p3p.rotation.cpu().numpy()
        five, _ = nister_stewenius.estimate(bear_a[:20].reshape(4, 5, 3).float().to(dev),
                                            bear_b[:20].reshape(4, 5, 3).float().to(dev))
        out["five_point f32"] = five.rotation.cpu().numpy()
        for name, fn in (("single_view_l2 f32", lambda: single_view_simple_optimize_l2(
                start, cam_bear, world, valid, 0.5, 200)), ("single_view_l1 f32", lambda: single_view_simple_optimize_l1(
                start, cam_bear, world, valid, 1e-6, 0.5, 200))):
            p = fn()
            out[name] = torch.cat([p.rotation.reshape(-1), p.translation]).cpu().numpy()
        return out

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    base = run()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        on = run()
        require(torch.get_float32_matmul_precision() == "high", "the caller's TF32 setting restored")
    finally:
        torch.set_float32_matmul_precision(prev[1])
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
    unequal = [k for k in base if not np.array_equal(base[k].view(np.uint8), on[k].view(np.uint8))]
    print(f"TF32 on against off: {len(base) - len(unequal)} of {len(base)} outputs bitwise equal "
          f"({', '.join(base)}); unequal {unequal}")
    require(not unequal, f"TF32 changes {unequal}")
    return len(base)


def five_point_sets(rng, n, scenario="general"):
    """``n`` seeded five-point problems as float64 CPU tensors ``(a, b,
    rotation, translation)``: ``'general'`` is tests/test_solvers_p3p_5pt.py's
    exact data, the others its near-degenerate scenarios."""
    import numpy as np
    import torch

    from cv_tpu_torch.core import CameraToCamera, lie, projective

    out = [[], [], [], []]
    for _ in range(n):
        rot = lie.so3_exp(torch.tensor(rng.normal(size=3) * (0.2 if scenario == "general" else 0.1)))
        if scenario in ("general", "tiny_baseline", "forward"):
            pts = rng.uniform([-2, -2, 3], [2, 2, 8], (5, 3))
        if scenario == "general":
            t = torch.tensor(rng.normal(size=3))
        elif scenario == "coplanar":
            xy = rng.uniform(-2, 2, (5, 2))
            normal = rng.normal(size=3)
            normal /= np.linalg.norm(normal)
            normal = normal * np.sign(normal[2]) if normal[2] != 0 else normal
            d0 = rng.uniform(4, 7)
            pts = d0 * normal + xy @ np.linalg.svd(normal[None])[2][1:]
            t = torch.tensor(rng.normal(size=3))
        elif scenario == "near_coplanar":
            xy = rng.uniform(-2, 2, (5, 2))
            pts = np.stack([xy[:, 0], xy[:, 1], 5.0 + rng.normal(0, 0.02, 5)], axis=-1)
            t = torch.tensor(rng.normal(size=3))
        elif scenario == "tiny_baseline":
            t = torch.tensor(rng.normal(size=3)) * 1e-3
        else:  # forward
            t = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64) * rng.uniform(0.3, 1.0)
        pose = CameraToCamera(rotation=rot, translation=t)
        a_h = projective.from_point(torch.as_tensor(np.asarray(pts)))
        for lst, x in zip(out, (projective.bearing(a_h), projective.bearing(pose.transform(a_h)), rot, t)):
            lst.append(x)
    return tuple(torch.stack(x) for x in out)


def five_point_recovery(poses, valid, rt, tt, tol, rotation_only=False, sign_free=False):
    """Share of sets whose true pose is among the valid candidates: the
    largest rotation-entry error (``so3_log``'s for ``rotation_only``, as
    the reference's envelope test) plus the translation-direction error
    below ``tol``."""
    import torch

    from cv_tpu_torch.core import lie

    rot, trans, valid = poses.rotation.cpu(), poses.translation.cpu(), valid.cpu()
    tn = tt / torch.linalg.vector_norm(tt, dim=-1, keepdim=True)
    te = trans / torch.linalg.vector_norm(trans, dim=-1, keepdim=True)
    t_err = torch.linalg.vector_norm(te - tn[:, None], dim=-1)
    if sign_free:
        t_err = torch.minimum(t_err, torch.linalg.vector_norm(te + tn[:, None], dim=-1))
    if rotation_only or sign_free:
        r_err = torch.linalg.vector_norm(lie.so3_log(rot.transpose(-1, -2) @ rt[:, None]), dim=-1)
    else:
        r_err = (rot - rt[:, None]).abs().amax(dim=(-1, -2))
    err = r_err if rotation_only else r_err + t_err
    return float((torch.where(valid, err, torch.inf).min(dim=-1).values < tol).double().mean())


def _max_diff(a, b):
    """Largest absolute difference of two tensors or tuples of tensors (on
    the CPU)."""
    import torch

    if isinstance(a, torch.Tensor):
        return float((a.cpu().double() - b.cpu().double()).abs().max()) if a.numel() else 0.0
    return max(_max_diff(x, y) for x, y in zip(a, b))


def _same_bits(a, b):
    import torch

    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if hasattr(a, "__dataclass_fields__"):
        return all(_same_bits(getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__)
    return all(_same_bits(x, y) for x, y in zip(a, b))


# cv_tpu's float64 recovery floors of the five-point envelope
# (tests/test_solvers_p3p_5pt.py:281-300): scenario -> (tolerance, floor,
# rotation only).
FIVE_POINT_FLOORS = {"coplanar": (1e-3, 0.55, False), "near_coplanar": (1e-3, 0.55, False),
                     "tiny_baseline": (1e-2, 0.30, True), "forward": (1e-3, 0.80, False)}
# Phase 11 trains the codebook on the first words of the KITTI pair's exact
# extract (its CPU run takes ~14 s on all 6,333).
CODEBOOK_WORDS = 2048


def library_modules(dev, seed, exact_words):
    """Phase 11: the modules without a kernel, on the card against the
    port's CPU path on the same inputs.  Five-point at bench.py's 64 noisy
    sets (float64, warm, timed), its recovery on 64 exact sets and the four
    near-degenerate scenarios against cv_tpu's floors; the L1 optimizers
    and Levenberg-Marquardt on the reference tests' problems; the five
    triangulators; ``sharded_extract`` and ``sharded_consensus`` over the
    visible devices and over ``(dev, dev)``, bitwise to the unsharded run;
    ``train_codebook`` on the exact extractor's KITTI words, bitwise to its
    CPU run.  Returns the times (ms)."""
    import numpy as np
    import torch

    from cv_tpu_torch.akaze import Akaze, DeviceExtractor, load_gray, to_gray_f32
    from cv_tpu_torch.consensus import BatchConsensus, Estimator
    from cv_tpu_torch.core import (CameraToCamera, Isometry3, WorldToCamera, camera_to_camera_residual, lie,
                                   projective, world_to_camera_residual)
    from cv_tpu_torch.geom import epipolar
    from cv_tpu_torch.matching import codebook
    from cv_tpu_torch.optimize import (levenberg_marquardt, single_view_simple_optimize_l1,
                                       three_view_simple_optimize_l1)
    from cv_tpu_torch.parallel import make_mesh, sharded_consensus, sharded_extract
    from cv_tpu_torch.sfm import device_refine
    from cv_tpu_torch.solvers import eight_point, nister_stewenius
    from cv_tpu_torch import triangulate
    from cv_tpu_torch.utils import kitti_pair

    cpu = torch.device("cpu")
    times = {}

    def on(d, x):
        if isinstance(x, torch.Tensor):
            return x.to(d)
        return type(x)(rotation=x.rotation.to(d), translation=x.translation.to(d))

    # -- five-point ----------------------------------------------------------
    rng = np.random.default_rng(0)
    pts5 = rng.uniform([-2, -2, 4], [2, 2, 10], (64, 5, 3))  # bench.py:841-845
    a5 = pts5 / np.linalg.norm(pts5, axis=-1, keepdims=True)
    b5 = a5 + rng.normal(scale=1e-2, size=a5.shape)
    b5 /= np.linalg.norm(b5, axis=-1, keepdims=True)
    a5, b5 = torch.as_tensor(a5, device=dev), torch.as_tensor(b5, device=dev)
    nister_stewenius.estimate(a5, b5)
    times["five_point (64 sets, f64)"] = statistics.median(wall_ms(lambda: nister_stewenius.estimate(a5, b5), reps=5))
    t0 = time.perf_counter()
    nister_stewenius.estimate(a5.cpu(), b5.cpu())
    times["five_point (64 sets, f64) on the CPU"] = (time.perf_counter() - t0) * 1e3
    a, b, rt, tt = five_point_sets(np.random.default_rng(seed + 20), 64)
    rates = {d.type: five_point_recovery(*nister_stewenius.estimate(a.to(d), b.to(d)), rt, tt, 1e-6)
             for d in (dev, cpu)}
    line = [f"five-point: bench.py's 64 sets {times['five_point (64 sets, f64)']:.3f} ms (f64, warm, median of 5; "
            f"CPU {times['five_point (64 sets, f64) on the CPU']:.1f} ms); exact data, true pose within 1e-6 in "
            f"{rates[dev.type]:.4f} of 64 sets (CPU {rates['cpu']:.4f}; cv_tpu's test asks > 0.9 at 1e-4)"]
    require(rates[dev.type] >= 0.9, f"five-point exact data: {rates[dev.type]} of sets recovered")
    for scenario, (tol, floor, rot_only) in FIVE_POINT_FLOORS.items():
        a, b, rt, tt = five_point_sets(np.random.default_rng(0), 100, scenario)
        rate = five_point_recovery(*nister_stewenius.estimate(a.to(dev), b.to(dev)), rt, tt, tol, rot_only,
                                   sign_free=True)
        line.append(f"{scenario} {rate:.2f} (floor {floor})")
        require(rate >= floor, f"five-point {scenario}: recovery {rate} below cv_tpu's f64 floor {floor}")
    print("; ".join(line))

    # -- the L1 optimizers and Levenberg-Marquardt ---------------------------
    rng = np.random.default_rng(0)
    true = WorldToCamera(rotation=lie.so3_exp(torch.tensor([0.1, -0.2, 0.15], dtype=torch.float64)),
                         translation=torch.tensor([0.2, -0.1, 0.4], dtype=torch.float64))
    wps = projective.from_point(torch.as_tensor(rng.uniform([-2, -2, 2], [2, 2, 8], (64, 3))))
    bearings = projective.bearing(true.transform(wps))
    init = WorldToCamera(rotation=lie.so3_exp(torch.tensor([0.02, 0.01, -0.02], dtype=torch.float64)) @ true.rotation,
                         translation=true.translation + torch.tensor([0.05, -0.03, 0.04], dtype=torch.float64))
    valid = torch.ones(64, dtype=torch.bool)
    runs = {}
    for d in (dev, cpu):
        t0 = time.perf_counter()
        runs[d.type] = single_view_simple_optimize_l1(on(d, init), bearings.to(d), wps.to(d), valid.to(d), 1e-9, 1e-2,
                                                      1000)
        torch.cuda.synchronize()
        times[f"single_view_simple_optimize_l1 (64 landmarks) on {d.type}"] = (time.perf_counter() - t0) * 1e3
    obj = lambda p: float(world_to_camera_residual(on(cpu, p), bearings, wps).mean())  # noqa: E731
    diff_sv = _max_diff((runs[dev.type].rotation, runs[dev.type].translation), (runs["cpu"].rotation,
                                                                                 runs["cpu"].translation))
    require(obj(runs[dev.type]) < 0.1 * obj(init), "single-view L1 reduces the objective tenfold")
    require(diff_sv < 1e-9, f"single-view L1: card and CPU poses {diff_sv:.3e} apart")

    p1 = CameraToCamera(rotation=lie.so3_exp(torch.tensor([0.02, 0.1, 0.0], dtype=torch.float64)),
                        translation=torch.tensor([0.5, 0.05, 0.1], dtype=torch.float64))
    p2 = CameraToCamera(rotation=lie.so3_exp(torch.tensor([-0.05, 0.03, 0.08], dtype=torch.float64)),
                        translation=torch.tensor([-0.3, 0.4, 0.05], dtype=torch.float64))
    pts = projective.from_point(torch.as_tensor(rng.uniform([-2, -2, 3], [2, 2, 9], (128, 3))))
    obs = torch.stack([projective.bearing(pts), projective.bearing(p1.transform(pts)),
                       projective.bearing(p2.transform(pts))], dim=1)
    n1 = CameraToCamera(rotation=lie.so3_exp(torch.tensor([0.01, -0.008, 0.012], dtype=torch.float64)) @ p1.rotation,
                        translation=p1.translation + torch.tensor([0.02, -0.01, 0.015], dtype=torch.float64))
    n2 = CameraToCamera(rotation=lie.so3_exp(torch.tensor([-0.01, 0.006, 0.009], dtype=torch.float64)) @ p2.rotation,
                        translation=p2.translation + torch.tensor([-0.015, 0.02, -0.01], dtype=torch.float64))

    def epipolar_loss(q1, q2):
        i1, i2 = on(cpu, q1).inverse(), on(cpu, q2).inverse()
        l1 = epipolar.loss(i1.translation.expand(128, 3), obs[:, 0], i1.rotate(obs[:, 1]))
        l2 = epipolar.loss(i2.translation.expand(128, 3), obs[:, 0], i2.rotate(obs[:, 2]))
        return float(l1.mean() + l2.mean())

    tv = {}
    for d in (dev, cpu):
        t0 = time.perf_counter()
        tv[d.type] = three_view_simple_optimize_l1((on(d, n1), on(d, n2)), obs.to(d), torch.ones(128, dtype=torch.bool,
                                                   device=d), 1e-9, 1e-2, 500)
        torch.cuda.synchronize()
        times[f"three_view_simple_optimize_l1 (128 landmarks) on {d.type}"] = (time.perf_counter() - t0) * 1e3
    before, after = epipolar_loss(n1, n2), epipolar_loss(*tv[dev.type])
    diff_tv = _max_diff(tuple(x for q in tv[dev.type] for x in (q.rotation, q.translation)),
                        tuple(x for q in tv["cpu"] for x in (q.rotation, q.translation)))
    require(after < before, f"three-view L1: epipolar loss {before:.3e} -> {after:.3e}")
    require(diff_tv < 1e-9, f"three-view L1: card and CPU poses {diff_tv:.3e} apart")

    def exp_fit(p, y):
        t = torch.linspace(0.0, 2.0, 32, dtype=p.dtype, device=p.device)
        return p[0] * torch.exp(p[1] * t) - y

    lm = {}
    for d in (dev, cpu):
        t = torch.linspace(0.0, 2.0, 32, dtype=torch.float64, device=d)
        ys = torch.stack([amp * torch.exp(rate * t) for amp, rate in ((1.7, -0.9), (0.5, 0.3), (2.5, -2.0))])
        x0 = torch.tensor([1.0, 0.0], dtype=torch.float64, device=d)
        one = [levenberg_marquardt(exp_fit, x0, args=(y,)) for y in ys]
        t0 = time.perf_counter()
        batch = levenberg_marquardt(exp_fit, x0.expand(3, 2), args=(ys,))
        torch.cuda.synchronize()
        times[f"levenberg_marquardt (3 problems) on {d.type}"] = (time.perf_counter() - t0) * 1e3
        apart = max(_max_diff(o.x, batch.x[i]) for i, o in enumerate(one))
        require(apart < 1e-12 and [int(o.iterations) for o in one] == batch.iterations.tolist(),
                f"LM on {d.type}: the batch {apart:.3e} from the problems one at a time")
        lm[d.type] = (batch, apart)
    (batch, apart), (batch_cpu, _) = lm[dev.type], lm["cpu"]
    require(bool(batch.converged.all()) and _max_diff(batch.x[0], torch.tensor([1.7, -0.9])) < 1e-5,
            "LM: the exponential fit converges")
    diff_lm = _max_diff(batch.x, batch_cpu.x)
    require(diff_lm < 1e-12, f"LM: card and CPU {diff_lm:.3e} apart")
    print(f"L1 and LM: single-view L1 objective {obj(init):.3e} -> {obj(runs[dev.type]):.3e} (card - CPU "
          f"{diff_sv:.3e}); three-view L1 epipolar loss {before:.3e} -> {after:.3e} (card - CPU {diff_tv:.3e}); LM "
          f"{batch.iterations.tolist()} iterations, card - CPU {diff_lm:.3e}, batch - one at a time on the card "
          f"{apart:.3e}; " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in times.items() if "optimize" in k or "marquardt" in k))

    # -- the five triangulators ----------------------------------------------
    pose = CameraToCamera(rotation=lie.so3_exp(torch.tensor([0.1, 0.1, 0.1], dtype=torch.float64)),
                          translation=torch.tensor([0.1, 0.1, 0.1], dtype=torch.float64))
    hp = projective.from_point(torch.as_tensor(rng.uniform([-1, -1, 1.5], [1, 1, 6], (256, 3))))
    ta, tb = projective.bearing(hp), projective.bearing(pose.transform(hp))
    eye = Isometry3.identity(batch_shape=(256,), dtype=torch.float64)
    views = Isometry3(rotation=torch.stack([eye.rotation, pose.rotation.expand(256, 3, 3)], dim=-3),
                      translation=torch.stack([eye.translation, pose.translation.expand(256, 3)], dim=-2))
    bear2 = torch.stack([ta, tb], dim=-2)
    worst = 0.0
    for name, fn in (("sine_l1", lambda d: triangulate.sine_l1(on(d, views), bear2.to(d))),
                     ("relative_dlt", lambda d: triangulate.relative_dlt(on(d, pose), ta.to(d), tb.to(d))),
                     ("mean_mean", lambda d: triangulate.mean_mean(on(d, views), bear2.to(d))),
                     ("angular_l1", lambda d: triangulate.angular_l1(on(d, pose), ta.to(d), tb.to(d))),
                     ("angular_linf", lambda d: triangulate.angular_linf(on(d, pose), ta.to(d), tb.to(d)))):
        (pg, okg), (pc, okc) = fn(dev), fn(cpu)
        diff = _max_diff(pg, pc)
        worst = max(worst, diff)
        require(torch.equal(okg.cpu(), okc) and bool(okc.all()), f"{name}: ok masks")
        require(diff < 1e-9, f"{name}: card and CPU points {diff:.3e} apart")
    print(f"triangulators (256 points): card within {worst:.3e} of the CPU, every ok mask equal")

    # -- sharded extraction and consensus -------------------------------------
    frames = np.stack([to_gray_f32(load_gray(p)) for p in kitti_pair()] * 2)
    images = torch.as_tensor(frames, device=dev)
    ex = DeviceExtractor(Akaze.sparse(), 256, 512, device=dev)
    whole = ex.extract(images)
    meshes = {"visible devices": make_mesh(), "(dev, dev)": (dev, dev)}
    for label, mesh in meshes.items():
        require(_same_bits(sharded_extract(ex, images, mesh), whole), f"sharded_extract over {label}")
    pose = Isometry3(rotation=lie.so3_exp(torch.tensor([0.05, -0.1, 0.04], dtype=torch.float64)),
                     translation=torch.tensor([0.3, -0.1, 0.05], dtype=torch.float64))
    pts = projective.from_point(torch.as_tensor(rng.uniform([-2, -2, 4], [2, 2, 10], (512, 3))))
    data = (projective.bearing(pts).to(dev), projective.bearing(pose.transform(pts)).to(dev))
    est = Estimator(8, 4, lambda smp: eight_point.estimate(smp[0], smp[1]), lambda m, dd: camera_to_camera_residual(
        Isometry3(m.rotation[..., None, :, :], m.translation[..., None, :]), dd[0], dd[1]))
    cons = BatchConsensus(threshold=1e-4, hypotheses=1024, refit_rounds=1, refit_hypotheses=256, device=dev)
    ref = cons.model_inliers(torch.Generator(device=dev).manual_seed(seed), est, data)
    for label, mesh in meshes.items():
        got = sharded_consensus(cons, mesh).model_inliers(torch.Generator(device=dev).manual_seed(seed), est, data)
        require(_same_bits((got[0].rotation, got[0].translation, got[1], got[2]),
                           (ref[0].rotation, ref[0].translation, ref[1], ref[2])), f"sharded_consensus over {label}")
    print(f"parallel: sharded_extract (B=4) and sharded_consensus (1024 + 256 hypotheses) over "
          f"{', '.join(f'{k} {tuple(str(d) for d in v)}' for k, v in meshes.items())} bitwise to the unsharded runs "
          f"({int(ref[2])} inliers)")

    # -- codebook training -----------------------------------------------------
    books = {}
    for d in (dev, cpu):
        t0 = time.perf_counter()
        books[d.type] = codebook.train_codebook(exact_words[:CODEBOOK_WORDS], device=d)
        times[f"train_codebook ({CODEBOOK_WORDS} words) on {d.type}"] = (time.perf_counter() - t0) * 1e3
    require(np.array_equal(books[dev.type], books["cpu"]), "train_codebook: card and CPU tables differ")
    print(f"train_codebook (512 codewords, 25 rounds) on the first {CODEBOOK_WORDS} of the exact extractor's "
          f"{len(exact_words)} KITTI words: card table bitwise equal to the CPU's; card "
          f"{times[f'train_codebook ({CODEBOOK_WORDS} words) on {dev.type}']:.1f} ms, CPU "
          f"{times[f'train_codebook ({CODEBOOK_WORDS} words) on cpu']:.1f} ms")

    return times


def _bits_equal(a, b):
    """Two tensors or arrays of one dtype and shape equal bit for bit."""
    import torch

    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        bits = torch.int64 if a.dtype == torch.float64 else torch.int32
        return bool(torch.equal(a.view(bits), b.view(bits)))
    return bool(torch.equal(a, b))


def graph_ba_plain_cpu(call):
    """``device_refine.graph_ba_core_plain`` of one recorded graph-BA call on
    the CPU, in a worker process: NumPy arrays and the rounds and rate in,
    ``(rot, trans, removed, seconds)`` out."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cv_tpu_torch.sfm import device_refine

    torch.set_num_threads(1)
    args = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in call]
    t0 = time.perf_counter()
    out = device_refine.graph_ba_core_plain(*args)
    return tuple(o.numpy() for o in out) + (time.perf_counter() - t0,)


def graph_ba_work(args):
    """``(float64 operations, bytes)`` of one graph-BA call: every valid
    edge and every view with one counted in every round (the run's
    removals not taken off), each input read once and each output written
    once."""
    import torch

    rot, trans, to, frm, erot, et, valid = args[:7]
    v = rot.shape[0]
    ok = valid & (to >= 0) & (to < v) & (frm >= 0) & (frm < v)
    edges = int(ok.sum())
    views = int(torch.unique(to[ok]).numel())
    flops = int(args[7]) * (edges * (GRAPH_BA_EDGE_OPS + 6) + views * GRAPH_BA_VIEW_OPS)
    nbytes = sum(t.numel() * t.element_size() for t in args[:7]) + rot.numel() * rot.element_size() \
        + trans.numel() * trans.element_size() + v
    return flops, nbytes


def graph_ba_plain_on_cpu(ba_calls):
    """The plain graph BA of every recorded call (path -> [(args, kwargs)])
    on the CPU, in one worker process per core this process may run on (at
    most one a call), the largest first; nothing else runs meanwhile.
    Returns path -> [(rot, trans, removed, seconds)]."""
    import multiprocessing

    import torch

    jobs = []
    for path, calls in ba_calls.items():
        for i, (args, kw) in enumerate(calls):
            require(not kw and len(args) == 9, f"graph BA {path}: a call of {len(args)} arguments and {list(kw)}")
            host = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in args]
            jobs.append((graph_ba_work(args)[0], path, i, host))
    workers = max(1, min(len(os.sched_getaffinity(0)), len(jobs)))
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        pending = {path: [None] * len(calls) for path, calls in ba_calls.items()}
        for _, path, i, host in sorted(jobs, key=lambda j: -j[0]):
            pending[path][i] = pool.apply_async(graph_ba_plain_cpu, (host,))
        out = {path: [r.get() for r in results] for path, results in pending.items()}
        pool.close()
        pool.join()
    cpu_s = sum(r[3] for results in out.values() for r in results)
    print(f"graph BA plain version on the CPU: {len(jobs)} recorded calls in {workers} processes, "
          f"{cpu_s:.1f} s of CPU, {time.perf_counter() - t0:.1f} s")
    return out


def check_graph_ba(dev, ba_calls, plain_cpu):
    """Phase 11's graph BA (``csrc/graph_ba.cu``: ``device_refine.graph_ba_core``
    on the card).  Every recorded call of the SfM warm pass and the
    sandbox runs launched once more and held bitwise to the plain
    version's CPU run (removed masks exact) and, over its first
    ``GRAPH_BA_HELD_ROUNDS`` rounds, to the plain version on the card, with
    each path's summed kernel device ms.  At the largest call (float64
    operations): two launches equal; the whole call's kernel device and
    call ms and the chain floor (the kernel on two views joined by two
    edges: one edge's and one view's dependent chain a round) at its
    rounds; at ``GRAPH_BA_PLAIN_ROUNDS`` rounds (the row's ``rounds``) the
    kernel's device ms, the plain version's ms on the card (held bitwise
    to the kernel) and the bound; the plain version's first
    ``GRAPH_BA_CAPTURED_ROUNDS`` rounds captured in one CUDA graph and
    replayed (``graph_rounds``); the profiler's launches of one kernel call
    and of the plain version at 2 and 4 rounds.  Every number of the
    returned record is measured at the rounds it names; the printed line
    also gives the plain version's figures scaled to the whole call,
    labelled so.  Returns the kernels line's record."""
    import torch

    from cv_tpu_torch.sfm import device_refine

    run, plain = device_refine.graph_ba_core, device_refine.graph_ba_core_plain
    held, worst, paths, largest = 0, 0.0, {}, None
    for path, calls in ba_calls.items():
        summed = 0.0
        for i, ((args, kw), want) in enumerate(zip(calls, plain_cpu[path])):
            got = run(*args, **kw)
            diff = _max_diff(got[:2], tuple(torch.as_tensor(w) for w in want[:2]))
            require(all(_bits_equal(g, w) for g, w in zip(got, want[:3])),
                    f"graph BA, {path} call {i}: the kernel differs from the plain version on the CPU (max {diff:.3e})")
            worst = max(worst, diff)
            cut = (*args[:7], min(int(args[7]), GRAPH_BA_HELD_ROUNDS), args[8])
            require(all(_bits_equal(g, w) for g, w in zip(run(*cut), plain(*cut))),
                    f"graph BA, {path} call {i}: the kernel differs from the plain version on the card")
            held += 1
            summed += cuda_ms(lambda args=args: run(*args), iters=3, warmup=1)
            work = graph_ba_work(args)
            if largest is None or work[0] > largest[0]:
                largest = (*work, args, path)
        paths[path] = round(summed, 4)
        shapes = sorted({(int(a[0].shape[0]), int(a[2].shape[0]), int(a[7])) for a, _ in calls})
        print(f"graph BA, {path}: {len(calls)} calls (V, E, rounds: {shapes}), each bitwise to the plain version "
              f"on the CPU and, over its first {GRAPH_BA_HELD_ROUNDS} rounds, on the card; kernel device ms summed "
              f"over the calls {summed:.3f}")
    require(held >= 1, "graph BA: no call recorded")
    _, _, args, path = largest
    v, e, rounds, rate = int(args[0].shape[0]), int(args[2].shape[0]), int(args[7]), float(args[8])
    first, second = run(*args), run(*args)
    require(all(_bits_equal(a, b) for a, b in zip(first, second)), "graph BA: two launches of one call differ")
    call_dev_ms = device_ms(lambda: run(*args), iters=5)
    call_ms = statistics.median(wall_ms(lambda: run(*args), reps=5))
    # The kernel and the plain version on the card at the same rounds.
    cut = min(rounds, GRAPH_BA_PLAIN_ROUNDS)
    cut_args = (*args[:7], cut, rate)
    dev_ms = device_ms(lambda: run(*cut_args), iters=5)
    plain_ms = wall_ms(lambda: plain(*cut_args), reps=1)[0]
    require(all(_bits_equal(a, b) for a, b in zip(run(*cut_args), plain(*cut_args))),
            f"graph BA: the kernel differs from the plain version on the card ({cut} rounds)")
    flops, nbytes = graph_ba_work(cut_args)
    # The plain rounds in one CUDA graph (after the set-up's host read).
    captured = min(rounds, GRAPH_BA_CAPTURED_ROUNDS)
    plain_graph_ms = None
    try:
        static = [a.clone() for a in args[:7]]
        to, frm = static[2].long(), static[3].long()
        incoming, removed = device_refine.graph_ba_setup(to, static[6], v)

        def rounds_of_plain():
            return device_refine.graph_ba_rounds(static[0], static[1], to, frm, static[4], static[5], static[6],
                                                 incoming, removed, captured, rate)

        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            rounds_of_plain()
        torch.cuda.current_stream().wait_stream(side)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            replayed = rounds_of_plain()
        capture_s = time.perf_counter() - t0
        graph.replay()
        torch.cuda.synchronize()
        require(all(_bits_equal(a, b) for a, b in zip(replayed, plain(*args[:7], captured, rate))),
                "graph BA: the captured plain rounds differ from the plain version")
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        plain_graph_ms = start.elapsed_time(stop) / 3
        del graph
        graph_note = (f"the plain version's first {captured} rounds captured in one CUDA graph ({capture_s:.1f} s to "
                      f"capture) and replayed: {plain_graph_ms:.1f} ms (scaled to {rounds} rounds: "
                      f"{plain_graph_ms * rounds / captured:.1f} ms)")
    except Exception as exc:  # noqa: BLE001  (the capture is a measurement; say why it failed)
        graph_note = f"the plain rounds could not be captured in a CUDA graph: {exc!r}"

    kernel_launches = profiled_launches(lambda: run(*args))
    plain_launches = {str(k): profiled_launches(lambda k=k: plain(*args[:7], k, rate))[0] for k in (2, 4)}
    if kernel_launches[1]:
        per_round = (plain_launches["4"] - plain_launches["2"]) // 2
        set_up = plain_launches["2"] - 2 * per_round
        launches_note = (f"launches (profiler): one kernel call {kernel_launches[0]} ({kernel_launches[1]} device "
                         f"events), the plain version {plain_launches['2']} at 2 rounds and {plain_launches['4']} at "
                         f"4 (so {set_up} in its set-up and {per_round} a round; projected to {rounds} rounds: "
                         f"{set_up + rounds * per_round})")
    else:
        launches_note, plain_launches = "launches: the profiler saw no device events", None
    # The chain floor: two views, each the other's only edge.
    dtype = args[0].dtype
    c, s_ = 0.99995000041666526, 0.0099998333341666645  # cos and sin of 0.01
    two_views = [torch.tensor(x, dtype=dtype, device=dev) for x in (
        [[[1.0, 0, 0], [0, 1, 0], [0, 0, 1]]] * 2, [[0.0, 0, 0], [1.0, 0, 0]])]
    edge_rot = torch.tensor([[[c, -s_, 0], [s_, c, 0], [0, 0, 1.0]], [[c, s_, 0], [-s_, c, 0], [0, 0, 1.0]]],
                            dtype=dtype, device=dev)
    edges = [torch.tensor([0, 1], device=dev), torch.tensor([1, 0], device=dev), edge_rot,
             torch.tensor([[-0.99, 0.01, 0], [1.01, 0, 0.01]], dtype=dtype, device=dev),
             torch.tensor([True, True], device=dev)]
    floor_ms = device_ms(lambda: run(*two_views, *edges, rounds, rate), iters=3)
    ms_ops, ms_bytes = flops / FP64_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (ms_ops, "operations") if ms_ops >= ms_bytes else (ms_bytes, "bytes")
    print(f"graph BA at the largest call ({path}: {v} views, {e} edges, {rounds} rounds, float64): kernel "
          f"{call_dev_ms:.4f} ms device, {call_ms:.4f} ms a call, {call_dev_ms * 1e3 / rounds:.3f} us a round "
          f"(chain floor, two views and two edges: {floor_ms:.4f} ms, {floor_ms * 1e3 / rounds:.3f} us a round); "
          f"two launches equal; at {cut} rounds, bitwise: the kernel {dev_ms:.4f} ms device, the plain version on "
          f"the card {plain_ms:.1f} ms (scaled to {rounds} rounds: {plain_ms * rounds / cut:.1f} ms); {graph_note}; "
          f"{launches_note}; bound at {cut} rounds {bound_ms * 1e3:.3f} us ({bound_by}: {flops} float64 operations, "
          f"{nbytes} bytes)")
    return dict(max_abs_err=worst, ms=dev_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, rounds=cut, call_rounds=rounds, call_device_ms=call_dev_ms, call_ms=call_ms,
                call_chain_floor_ms=floor_ms, plain_graph_ms=plain_graph_ms, graph_rounds=captured,
                plain_launches=plain_launches, calls_held=held, paths=paths)


def apps_phase(dev, counters, plains, tally):
    """Phase 4c: ``kpdraw.main`` at threshold 0.01 on KITTI frame 0 (its PNG
    decodes to the crosses at the exact extractor's points, 399 of them) and
    tutorial chapters 2-5 (chapter 2's PNG decodes to its canvas, chapter 3
    finds 3425 keypoints, chapters 4 and 5 the same symmetric matches,
    chapter 5 its inliers among them), with the counters at zero: one scan
    an extract, the trig kernel, the score entry, no select kernel."""
    import numpy as np

    from cv_tpu_torch.akaze import load_gray
    from cv_tpu_torch.apps import kpdraw, tutorials
    from cv_tpu_torch.utils import kitti_pair, read_png

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_apps_run")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    frame0 = kitti_pair()[0]
    t0 = time.perf_counter()
    with main_path(counters, plains) as run:
        kp = kpdraw.main(["--threshold", "0.01", frame0, os.path.join(work, "kpdraw.png")], device=dev)
        canvas2 = tutorials.chapter2_random_draw(os.path.join(work, "chapter2.png"))
        kp3 = tutorials.chapter3_akaze_extraction(os.path.join(work, "chapter3.png"), device=dev)
        matches4 = tutorials.chapter4_feature_matching(os.path.join(work, "chapter4.png"), device=dev)
        _, inliers5, matches5 = tutorials.chapter5_geometric_verification(device=dev)
    seconds = time.perf_counter() - t0
    print(f"apps: kpdraw {len(kp['response'])} keypoints; chapter 3 {len(kp3['response'])} keypoints; chapter 4 "
          f"{len(matches4)} symmetric matches; chapter 5 {inliers5} inliers of {matches5} matches; {seconds:.3f} s; "
          f"launches {run['launches']}")
    tally(run, dedup_scan=6, select_samples=0, select_groups=0, select_fused=0, jacobi=(1,), c2c_score=(1,),
          **TRIG_LAUNCHED, **SCALE_SPACE_LAUNCHED)
    require(len(kp["response"]) == KITTI_KEYPOINTS[0], f"kpdraw: {len(kp['response'])} keypoints")
    drawn = read_png(os.path.join(work, "kpdraw.png"))
    require(np.array_equal(drawn, kpdraw.render_crosses(load_gray(frame0), kp["point"])),
            "kpdraw: the PNG decodes to the crosses at the extractor's points")
    require(np.array_equal(read_png(os.path.join(work, "chapter2.png")), canvas2), "chapter 2: the PNG decodes")
    require(len(kp3["response"]) == DENSE_KEYPOINTS[0], f"chapter 3: {len(kp3['response'])} keypoints")
    require(read_png(os.path.join(work, "chapter4.png")).shape == (1024, 1392, 3), "chapter 4: the PNG decodes")
    require(len(matches4) == matches5 > 0 and 8 <= inliers5 <= matches5,
            f"chapters 4 and 5: {len(matches4)} / {matches5} matches, {inliers5} inliers")
    shutil.rmtree(work, ignore_errors=True)


def kernel_counters():
    """Every kernel wrapper's launch counter (row name -> wrapper), and
    every plain version the wrappers call ((module, name) pairs, counted in
    the main-path runs, where none may run)."""
    from cv_tpu_torch.akaze import extrema
    from cv_tpu_torch.akaze import fused as fused_mod
    from cv_tpu_torch.akaze import select as select_mod
    from cv_tpu_torch.core import pose as pose_mod
    from cv_tpu_torch.experiments import mldb_losers, probes
    from cv_tpu_torch.ops import eigen as eigen_mod
    from cv_tpu_torch.ops import image as image_mod
    from cv_tpu_torch.ops import trig as trig_mod
    from cv_tpu_torch.optimize import optimizers, resident
    from cv_tpu_torch.sfm import device_refine

    counters = {
        "select_samples": select_mod.select_samples,
        "select_samples_interleaved": select_mod.select_samples_interleaved,
        "select_groups": select_mod.select_groups,
        "select_fused": fused_mod.select_fused,
        "dedup_scan": extrema.dedup_scan_device,
        "single_view_l2": resident.single_view_l2,
        "three_view_l2": resident.three_view_l2,
        "three_view_adaptive": resident.three_view_adaptive,
        "select_samples_epatch": mldb_losers.select_samples_epatch,
        "select_samples_tiles": mldb_losers.select_samples_tiles,
        "select_samples_tiles8": mldb_losers.select_samples_tiles8,
        "select_window[exp_select_kernels]": probes.select_window,
        "take_along": probes.take_along,
        "trig_probe": probes.trig_probe,
        "angle_cv": trig_mod.angle_cv,
        "cos_sin": trig_mod.cos_sin,
        "atan2": trig_mod.atan2,
        "jacobi": eigen_mod.eigh_small,
        "c2c_residual": pose_mod.c2c_residual,
        "c2c_score": pose_mod.c2c_score,
        "graph_ba": device_refine.graph_ba_core,
        **{row: getattr(image_mod, spec[0]) for row, spec in SCALE_SPACE_ROWS.items()},
        **{f"bisect_{body}": fn for body, fn in probes.BISECT.items()},
        **{f"mxu_{body}": fn for body, fn in probes.MXU.items()},
    }
    plains = [
        (select_mod, "select_samples_plain"), (select_mod, "select_samples_interleaved_plain"),
        (select_mod, "select_groups_plain"),
        (fused_mod, "select_fused_plain"), (extrema, "dedup_scan_plain"),
        (optimizers, "single_view_simple_optimize_l2"), (optimizers, "three_view_simple_optimize_l2"),
        (optimizers, "three_view_adaptive_optimize_l2"), (probes, "select_window_plain"),
        (probes, "take_along_plain"), (probes, "trig_probe_plain"), (probes, "bisect_plain"), (probes, "mxu_plain"),
        (trig_mod, "angle_cv_plain"), (trig_mod, "cos_sin_plain"), (trig_mod, "cos_sin_by_dtype"),
        (trig_mod, "atan2_plain"), (eigen_mod, "eigh_small_plain"), (pose_mod, "c2c_residual_plain"),
        (pose_mod, "c2c_score_plain"), (device_refine, "graph_ba_core_plain"),
        *((image_mod, spec[1]) for spec in SCALE_SPACE_ROWS.values()),
    ]
    return counters, plains


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
    from cv_tpu_torch.akaze import (Akaze, AkazeExtractor, DeviceExtractor, FastAkazeExtractor, extrema, load_gray,
                                    to_gray_f32)
    from cv_tpu_torch.akaze import descriptors as desc_mod
    from cv_tpu_torch.akaze import fused as fused_mod
    from cv_tpu_torch.camera import CameraIntrinsics
    from cv_tpu_torch.consensus import BatchConsensus, Estimator
    from cv_tpu_torch.core import Isometry3, camera_to_camera_residual
    from cv_tpu_torch.core import pose as pose_mod
    from cv_tpu_torch.experiments import probes
    from cv_tpu_torch.experiments import runs as exp_runs
    from cv_tpu_torch.matching import PAD_DISTANCE, distance_matrix, knn2
    from cv_tpu_torch.sfm import device_refine
    from cv_tpu_torch.solvers import eight_point
    from cv_tpu_torch.utils import KITTI_INTRINSICS, kitti_pair

    counters, plains = kernel_counters()
    t_start = time.perf_counter()

    def clock(done):
        """Print the script's elapsed seconds after phase ``done``."""
        print(f"phase clock: {done} done at {time.perf_counter() - t_start:.1f} s")
    # Launches per kernel row: the main paths' (KITTI, SfM, dense) for rows
    # 1-8 and the dedup scan; the retired modes' and the experiments' runs
    # for the rest.  Rows that map to the select kernel count its launches
    # in their own runs.
    main_launches = {name: 0 for name in (*counters, *EXPERIMENT_KERNELS, "select_samples_patch")}

    def tally(run, attribute=None, **expect):
        """Add a main-path run's launches to the totals and hold each
        expected count (an int, or (min,) for at least).  ``attribute``
        names the row that the select kernel's launches in this run belong
        to (the patch form's #2/#3 in a 'pallas' run, a retired select or
        probe in theirs), else #1's."""
        for name, n in run["launches"].items():
            main_launches[attribute if attribute and name == "select_samples" else name] += n
        for name, want in expect.items():
            got = run["launches"][name]
            ok = got >= want[0] if isinstance(want, tuple) else got == want
            require(ok, f"{name} launched {got} times (expected {want})")

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
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build all kernels: {time.perf_counter() - t_build:.2f} s wall")

    clock("2 (build)")
    # -- 3. kernel against its plain version at the main paths' shapes ------
    select_records = check_select_kernels(dev, args.seed)
    pose_records = check_pose_kernels(dev, args.seed)
    # The dedup kernel on the dense path's own candidates, recorded from
    # one dense extract (outside any main-path run).
    dense_pair = np.stack([to_gray_f32(load_gray(p)) for p in kitti_pair()])
    dense_images = torch.as_tensor(dense_pair, device=dev)
    dense = DeviceExtractor(Akaze(), device=dev, **DENSE)
    with recording(extrema, "dedup_scan_device") as recorded:
        dense.extract(dense_images)
    dedup_record = check_dedup_kernel(dev, args.seed, recorded[0][0])
    del recorded
    exp_records = check_experiment_kernels(dev, args.seed)
    jacobi_record, trig64_record, c2c_record, score_record = check_eigen_trig64(dev, args.seed)
    clock("3 (before the scale space)")
    scale_space_records = check_scale_space(dev, dense_pair)

    clock("3")
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
        score=lambda m, d, valid, threshold: pose_mod.c2c_score(
            Isometry3(m.rotation[..., None, :, :], m.translation[..., None, :]), d[0], d[1], valid, threshold
        ),
    )
    consensus = BatchConsensus(threshold=0.1, hypotheses=512, device=dev)

    def extract_and_match(batch, ex=extractor):
        fs = ex.extract(batch)
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

    # The select's and the dedup scan's calls of every path are recorded
    # where the extractor binds them (replayed after phase 7).
    select_calls, scan_calls = {}, {}
    with main_path(counters, plains) as kitti_run, \
            recording(desc_mod, "select_samples", keep_planes) as select_calls["kitti"], \
            recording(extrema, "dedup_scan_device") as scan_calls["kitti"], \
            recording(pose_mod, "c2c_residual", first_calls(2)) as kitti_residuals, \
            recording(pose_mod, "c2c_score", first_calls(2)) as kitti_score_calls, \
            recording(BatchConsensus, "_score_stage", first_calls(1)) as kitti_scores:
        fs, idx, keep = extract_and_match(images)
        model, mask, count = pose_pair0(fs, idx, keep)
    counts = fs.count.tolist()
    matches = keep.sum(dim=-1).tolist()
    print(f"main path: keypoints {counts} matches {matches} inliers {int(count)} "
          f"launches {kitti_run['launches']} plain-version calls {kitti_run['plain']}")
    require(counts == KITTI_KEYPOINTS * (BATCH // 2), f"keypoints {counts}")
    require(matches == [KITTI_MATCHES] * (BATCH // 2), f"matches {matches}")
    require(int(count) == KITTI_INLIERS, f"inliers {int(count)}")
    # orientation + M-LDB; one scan; the residual's blocks
    tally(kitti_run, select_samples=2, dedup_scan=1, jacobi=(1,), c2c_residual=(1,), c2c_score=(1,),
          **TRIG_LAUNCHED, **scale_space_launches(extractor.specs(*images.shape[-2:]), *images.shape[-2:]))
    hold_recorded_residuals(kitti_residuals, kitti_score_calls, kitti_scores, "the KITTI pose pipeline")
    del kitti_residuals, kitti_score_calls, kitti_scores
    require(tuple(fs.words.shape) == (BATCH, 512, 16) and fs.words.dtype == torch.int32, "words shape")
    v = fs.valid
    require(bool(torch.isfinite(fs.point[v]).all() & torch.isfinite(fs.angle[v]).all()), "finite keypoints")
    rot = model.rotation
    require(bool(torch.isfinite(rot).all()), "finite pose")
    require(
        torch.allclose(rot @ rot.T, torch.eye(3, dtype=rot.dtype, device=dev), atol=1e-6),
        "pose rotation orthonormal",
    )

    clock("4")
    # -- 4d. the KITTI path in the '+inter' describe modes --------------------
    # The same batch through DeviceExtractor on the pixel-interleaved stack:
    # 'pgather+inter' (the interleaved select kernel) and 'pallas+inter' (the
    # patch form on patches cut from it); each run with the counters at zero,
    # the goldens, and keypoints, words and angles bitwise phase 4's.
    kitti_ref = fs.to_numpy()
    inter_extractors = {}
    for mode, expect in (("pgather+inter", dict(select_samples_interleaved=2, select_samples=0)),
                         ("pallas+inter", dict(select_samples=2, select_samples_interleaved=0))):
        ex = inter_extractors[mode] = DeviceExtractor(Akaze.sparse(), candidate_budget=256, max_features=512,
                                                      device=dev, onehot_mode=mode)
        with main_path(counters, plains) as run, \
                recording(desc_mod, "select_samples_interleaved", keep_planes) as inter_calls:
            fs_i, idx_i, keep_i = extract_and_match(images, ex)
            _, _, count_i = pose_pair0(fs_i, idx_i, keep_i)
        if mode == "pgather+inter":
            select_calls["kitti+inter"] = inter_calls
        host = fs_i.to_numpy()
        cnt, matches_i = host["valid"].sum(axis=1).tolist(), keep_i.sum(dim=-1).tolist()
        print(f"KITTI {mode}: keypoints {cnt} matches {matches_i} inliers {int(count_i)} launches {run['launches']} "
              f"plain-version calls {run['plain']}")
        require(cnt == KITTI_KEYPOINTS * (BATCH // 2), f"{mode}: keypoints {cnt}")
        require(matches_i == [KITTI_MATCHES] * (BATCH // 2), f"{mode}: matches {matches_i}")
        require(int(count_i) == KITTI_INLIERS, f"{mode}: inliers {int(count_i)}")
        tally(run, attribute="select_samples_patch" if mode == "pallas+inter" else None, dedup_scan=1,
              jacobi=(1,), c2c_residual=(1,), c2c_score=(1,), **TRIG_LAUNCHED, **expect,
              **scale_space_launches(ex.specs(*images.shape[-2:]), *images.shape[-2:]))
        for key in ("valid", "point", "words"):
            require(np.array_equal(host[key], kitti_ref[key]), f"{mode}: {key} differ from the 'pgather' run")
        require(np.array_equal(host["angle"].view(np.uint32), kitti_ref["angle"].view(np.uint32)),
                f"{mode}: angles differ from the 'pgather' run")
        print(f"KITTI {mode}: valid flags, points, words and angles bitwise the 'pgather' run's")
    require(len(select_calls["kitti+inter"]) == 2, "interleaved select: 2 KITTI calls recorded")

    clock("4d")
    # -- 4b. the exact extractor on the KITTI pair, with the counters at zero
    exact_ms, exact_rows, exact_words = exact_path(dev, counters, plains, tally, scan_calls)
    clock("4b")

    # -- 4c. the apps: kpdraw and the tutorials, with the counters at zero --
    apps_phase(dev, counters, plains, tally)
    clock("4c")

    # -- 5. the SfM engine: a warm pass, then the timed main-path pass -------
    # The warm pass records the select's, the dedup scan's, A's, B's and
    # C's and graph BA's calls, so the timed pass runs as it would without
    # them.
    ba_calls = {}
    with record_pose_calls() as pose_calls, \
            recording(desc_mod, "select_samples", keep_planes) as select_calls["sfm"], \
            recording(extrema, "dedup_scan_device") as scan_calls["sfm"], \
            recording(device_refine, "graph_ba_core") as ba_calls["sfm"], \
            recording(pose_mod, "c2c_residual", first_calls(2)) as sfm_residuals, \
            recording(pose_mod, "c2c_score", first_calls(2)) as sfm_score_calls, \
            recording(BatchConsensus, "_score_stage", first_calls(1)) as sfm_scores:
        warm_engine, warm_s, _, _ = run_sfm(dev)
    print(f"sfm warm pass: {SFM_FRAMES / warm_s:.3f} fps ({warm_s:.3f} s)")
    del warm_engine
    with main_path(counters, plains) as sfm_run:
        engine, sfm_s, phase_ms, true_poses = run_sfm(dev, timed_phases=True)
    views, landmarks, ate_rel, rot_deg = sfm_gates(engine, true_poses)
    print(f"sfm main path: {SFM_FRAMES / sfm_s:.3f} fps ({sfm_s:.3f} s for {SFM_FRAMES} frames), "
          f"{views} views, {landmarks} landmarks, ATE/extent {ate_rel:.5f}, "
          f"worst consecutive rotation {rot_deg:.4f} deg, launches {sfm_run['launches']}, "
          f"plain-version calls {sfm_run['plain']}")
    print("sfm phases (ms, synchronized): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_ms.items()))
    tally(sfm_run, single_view_l2=(1,), three_view_l2=(1,), three_view_adaptive=(1,),
          select_samples=(2 * SFM_FRAMES,), dedup_scan=(SFM_FRAMES,), jacobi=(1,), c2c_residual=(1,),
          c2c_score=(1,), graph_ba=(1,), **TRIG_LAUNCHED, **SCALE_SPACE_LAUNCHED)
    hold_recorded_residuals(sfm_residuals, sfm_score_calls, sfm_scores, "the SfM warm pass's first init")
    del sfm_residuals, sfm_score_calls, sfm_scores
    del engine
    # Every A, B and C call of the warm pass, replayed on its own.
    for name, recorded in pose_calls.items():
        require(len(recorded) >= 1, f"{name}: no call recorded in the warm pass")
        print(f"{name}: {len(recorded)} calls recorded in the warm pass, {sfm_run['launches'][name]} launched "
              "in the timed pass")
    engine_records = replay_pose_calls(pose_calls)
    del pose_calls
    share = sum(r["ms"] for r in engine_records.values()) / (sfm_s * 1e3)
    print(f"engine-shape replay: A, B and C take {share:.4f} of the timed pass's {sfm_s * 1e3:.1f} ms "
          "(the warm pass's calls)")
    for name, rec in engine_records.items():
        pose_records[name]["engine"] = rec

    clock("5")
    # -- 6. the loop-closure merge, once, with the counters at zero ---------
    with main_path(counters, plains) as merge_run, \
            recording(extrema, "dedup_scan_device") as scan_calls["merge"]:
        merge_engine, merge_counts, merges, merge_s = run_merge(dev)
    final = len(merge_engine.data.reconstructions)
    require(max(merge_counts) >= 2 and final < max(merge_counts),
            f"merge: reconstructions after each frame {merge_counts}, {final} at the end")
    largest = max(merge_engine.data.reconstructions, key=lambda k: len(merge_engine.data.reconstructions[k].views))
    merge_views = len(merge_engine.data.reconstructions[largest].views)
    problems = merge_engine.sanity_check(largest)
    require(problems == [], f"merge: sanity_check {problems[:3]}")
    print(f"merge (bench.py's loop-closure scenario, seed {MERGE_SEED}): reconstructions after each frame "
          f"{merge_counts}, {final} at the end; {sum(merges)} of {len(merges)} merge attempts merged; largest "
          f"reconstruction {merge_views} views, {len(merge_engine.data.reconstructions[largest].landmarks)} "
          f"landmarks (cv_tpu: {MERGE_REFERENCE_VIEWS} views), sanity_check empty; {merge_s:.3f} s for "
          f"{len(merge_counts)} frames; launches three_view_l2 {merge_run['launches']['three_view_l2']}, "
          f"three_view_adaptive {merge_run['launches']['three_view_adaptive']}, single_view_l2 "
          f"{merge_run['launches']['single_view_l2']}, angle_cv {merge_run['launches']['angle_cv']}, cos_sin "
          f"{merge_run['launches']['cos_sin']}, graph_ba {merge_run['launches']['graph_ba']}; plain-version calls "
          f"{merge_run['plain']}")
    tally(merge_run, three_view_l2=(1,), three_view_adaptive=(1,), single_view_l2=(1,),
          select_samples=(2 * len(merge_counts),), dedup_scan=(len(merge_counts),), jacobi=(1,), graph_ba=(1,),
          **TRIG_LAUNCHED, **SCALE_SPACE_LAUNCHED)
    del merge_engine

    clock("6")
    # -- 6b. the vslam-sandbox app at its own defaults ----------------------
    # The group select's calls (the sandbox; the dense path's default mode
    # and engine-budget extractor below) and the fused describe's
    # ('pfused'), recorded where the describe binds them.
    describe_calls = {"select_groups": {}, "select_fused": {}}
    sandbox_phase(dev, counters, plains, tally, scan_calls, ba_calls)

    clock("6b")
    # -- 7. the dense path ---------------------------------------------------
    runs = {}
    # 'pfused' computes its angles, cos and sin inside the fused kernel.
    for mode, expect in ((None, dict(select_groups=2, dedup_scan=1, select_samples=0, **TRIG_LAUNCHED)),
                         ("pfused", dict(select_fused=1, dedup_scan=1, select_groups=0, angle_cv=0, cos_sin=0)),
                         ("pallas", dict(select_samples=2, dedup_scan=1, select_groups=0, **TRIG_LAUNCHED))):
        ex = dense if mode is None else DeviceExtractor(Akaze(), device=dev, onehot_mode=mode, **DENSE)
        with main_path(counters, plains) as run, recording(extrema, "dedup_scan_device") as calls, \
                recording(desc_mod, "select_groups", keep_planes) as group_calls, \
                recording(fused_mod, "select_fused", keep_planes) as fused_calls:
            fs_d = ex.extract(dense_images)
        scan_calls.setdefault("dense", []).extend(calls)
        if mode is None:
            describe_calls["select_groups"]["dense"] = group_calls
        elif mode == "pfused":
            describe_calls["select_fused"]["pfused"] = fused_calls
        host = fs_d.to_numpy()
        label = ex.describe_mode(*dense_pair.shape[-2:])
        cnt = host["valid"].sum(axis=1).tolist()
        print(f"dense {label}: keypoints {cnt} (anchors {DENSE_KEYPOINTS}), launches {run['launches']}, "
              f"plain-version calls {run['plain']}")
        tally(run, attribute="select_samples_patch" if mode == "pallas" else None, **expect, **SCALE_SPACE_LAUNCHED)
        v = host["valid"]
        require(np.isfinite(host["point"][v]).all() and np.isfinite(host["angle"][v]).all(), f"dense {label} finite")
        if mode is None:
            require(label == "pgroups", f"dense default describe mode {label}")
            require(dense_ok(cnt), f"dense counts {cnt} outside bench.py's tolerance of {DENSE_KEYPOINTS}")
        else:
            base = runs[None]
            require(cnt == base["valid"].sum(axis=1).tolist(), f"dense {label}: counts {cnt} differ")
            require(np.array_equal(host["point"], base["point"]), f"dense {label}: points differ")
            describe_gates(f"dense {label} vs pgroups", host["words"].reshape(-1, 16), v.reshape(-1),
                           host["angle"].reshape(-1), base["words"].reshape(-1, 16), base["valid"].reshape(-1),
                           base["angle"].reshape(-1))
        runs[mode] = host

    engine_ex = FastAkazeExtractor(Akaze(maximum_features=8192), device=dev)
    frame0 = np.ascontiguousarray(dense_pair[0])
    require(engine_ex._dev.describe_mode(*frame0.shape) == "pgroups", "engine-budget extractor takes pgroups")
    with main_path(counters, plains) as run, recording(extrema, "dedup_scan_device") as calls, \
            recording(desc_mod, "select_groups", keep_planes) as describe_calls["select_groups"]["engine"]:
        kp, words0, sketch = engine_ex.fetch_extract(engine_ex.dispatch_extract(frame0))
    scan_calls["dense"].extend(calls)
    n0 = len(kp["response"])
    print(f"FastAkazeExtractor(maximum_features=8192) frame 0: {n0} keypoints (dense DeviceExtractor: "
          f"{int(runs[None]['valid'][0].sum())}), launches {run['launches']}")
    tally(run, select_groups=2, dedup_scan=1, **TRIG_LAUNCHED, **SCALE_SPACE_LAUNCHED)
    require(n0 == int(runs[None]["valid"][0].sum()), "engine-budget count differs from the dense extract's")
    require(words0.shape == (n0, 16) and sketch.shape == (16,), "engine-budget words and sketch shapes")

    for _ in range(2):
        dense.extract(dense_images)
    dense_wall = wall_ms(lambda: dense.extract(dense_images), reps=5)
    _, dense_stages, dense_scan = staged(dense, dense_images, "pgroups", reps=3)
    print(f"dense extract B=2: median {statistics.median(dense_wall):.3f} ms, min {min(dense_wall):.3f} ms, "
          f"max {max(dense_wall):.3f} ms over {len(dense_wall)} reps")
    for name, ms in dense_stages.items():
        print(f"dense stage {name}: median {ms:.3f} ms over 3 reps")
    _, fused_stages, _ = staged(dense, dense_images, "pfused", reps=3)
    print(f"dense stage describe, pfused: median {fused_stages['describe']:.3f} ms over 3 reps "
          f"(pgroups {dense_stages['describe']:.3f} ms)")
    print(f"dense dedup kernel: median {statistics.median(s[0] for s in dense_scan):.3f} ms, "
          f"sequential steps per frame {dense_scan[0][1]}")

    # The select's and the dedup scan's recorded calls, replayed: each held
    # bitwise to its plain version and timed on the card.
    for path, want in (("kitti", 2), ("sfm", 2 * SFM_FRAMES)):
        require(len(select_calls[path]) == want, f"select: {len(select_calls[path])} {path} calls recorded")
    for path, want in (("kitti", 1), ("exact", 4), ("sfm", SFM_FRAMES), ("merge", len(merge_counts)), ("dense", 4),
                       ("sandbox run1", SANDBOX["run1"]), ("sandbox run2", SANDBOX["run2"])):
        require(len(scan_calls[path]) == want, f"dedup: {len(scan_calls[path])} {path} calls recorded")
    for name, path, want in (("select_groups", "dense", 2), ("select_groups", "engine", 2),
                             ("select_fused", "pfused", 1)):
        got = len(describe_calls[name][path])
        require(got == want, f"{name}: {got} {path} calls recorded")
    select_records["select_samples_interleaved"]["engine"] = replay_interleaved(select_calls.pop("kitti+inter"))
    select_records["select_samples"]["engine"] = replay_select(select_calls)
    dedup_record["engine"] = replay_dedup(scan_calls)
    for name, rec in replay_describe(describe_calls).items():
        select_records[name]["engine"] = rec
    del select_calls, scan_calls, describe_calls

    clock("7")
    # -- 8. the retired describe modes and the experiments' runs ------------
    # 'pepatch' and 'ptiles' (registered by importing mldb_losers) at the
    # KITTI batch, against phase 4's 'pgather'; 'ptiles' on the dense pair,
    # against the default 'pgroups'.  Each run with the counters at zero;
    # the retired wrappers count their own select-kernel launches.
    for mode, ex, imgs_in, base, row in (
        ("pepatch", DeviceExtractor(Akaze.sparse(), 256, 512, device=dev, onehot_mode="pepatch"), images,
         kitti_ref, "select_samples_epatch"),
        ("ptiles", DeviceExtractor(Akaze.sparse(), 256, 512, device=dev, onehot_mode="ptiles"), images,
         kitti_ref, "select_samples_tiles8"),
        ("ptiles", DeviceExtractor(Akaze(), device=dev, onehot_mode="ptiles", **DENSE), dense_images,
         runs[None], "select_samples_tiles8"),
    ):
        label = f"{'dense' if imgs_in is dense_images else 'KITTI'} {mode}"
        with main_path(counters, plains) as run:
            host = ex.extract(imgs_in).to_numpy()
        launches = run["launches"]
        cnt = host["valid"].sum(axis=1).tolist()
        require(launches[row] == 2 and launches["select_groups"] == 0 and launches["dedup_scan"] == 1,
                f"{label}: launches {launches}")
        main_launches[row] += launches[row]
        v = base["valid"]
        require(cnt == v.sum(axis=1).tolist(), f"{label}: counts {cnt} differ from {v.sum(axis=1).tolist()}")
        require(np.array_equal(host["valid"], v) and np.array_equal(host["point"], base["point"]),
                f"{label}: keypoints differ")
        rows = (host["words"][v] == base["words"][v]).all(axis=1)
        same_angles = np.array_equal(host["angle"][v], base["angle"][v])
        print(f"{label}: keypoints {cnt}, {int(rows.sum())} of {int(v.sum())} valid word rows bitwise equal "
              f"({rows.mean():.4f}), angles bitwise equal {same_angles}, launches {row} {launches[row]}, "
              f"plain-version calls {run['plain']}")
        if mode == "pepatch":
            require(cnt == KITTI_KEYPOINTS * (BATCH // 2), f"{label}: keypoints {cnt}")
            require(bool(rows.all()) and same_angles, f"{label}: every valid word row and angle bitwise equal")
        else:
            describe_gates(f"{label} vs {'pgather' if base is kitti_ref else 'pgroups'}",
                           host["words"].reshape(-1, 16), host["valid"].reshape(-1), host["angle"].reshape(-1),
                           base["words"].reshape(-1, 16), v.reshape(-1), base["angle"].reshape(-1))

    def experiment(label, fn, rows):
        """One experiments entry point with the counters at zero and no
        plain version; each kernel row in ``rows`` (row -> counter) must
        launch, and its launches count to the row."""
        with main_path(counters, plains) as run:
            res = fn()
        for row, counter in rows.items():
            require(run["launches"][counter] >= 1, f"{label}: {counter} not launched ({run['launches']})")
            main_launches[row] += run["launches"][counter]
        print(f"experiments {label}: {json.dumps(res)}")
        return res

    res = experiment("exp_r4_epatch kernel (l=96, K=4096, NS=1280)", lambda: exp_runs.epatch_kernel(dev, args.seed),
                     {"select_samples_epatch": "select_samples_epatch"})
    require(res["equal"], "epatch select bitwise equal to the cut + patch-form select")
    res = experiment("tile selects (K=4096, NS=441)", lambda: exp_runs.tiles_kernel(dev, args.seed),
                     {"select_samples_tiles": "select_samples_tiles", "select_samples_tiles8": "select_samples_tiles8"})
    require(res["equal"], "tile selects equal to each other and to NumPy")
    for label, fn, rows in (
        ("exp_r4_epatch extract (B=8, 512 / 4096)", exp_runs.epatch_extract,
         {"select_samples_epatch": "select_samples_epatch"}),
        ("exp_r4_ptiles (B=8, 256 / 512)", exp_runs.ptiles_extract, {"select_samples_tiles8": "select_samples_tiles8"}),
        ("exp_r5_pfused extract (B=8, 256 / 512)", exp_runs.pfused_extract, {}),
    ):
        res = experiment(label, lambda fn=fn: fn(images), rows)
        modes = list(res)
        require(all(res[m]["counts"] == res[modes[0]]["counts"] for m in modes), f"{label}: keypoints differ")
        require(res[modes[1]]["valid_equal"] and res[modes[1]]["equal_rows"] >= 0.99, f"{label}: words")
    res = experiment("exp_select_kernels (K=4096, NS=1280)", lambda: exp_runs.select_kernels_run(dev, args.seed),
                     {"select_window[exp_select_kernels]": "select_window[exp_select_kernels]"})
    require(res["exact"], "exp_select_kernels: bit-exact to its host reference")
    for phase, row, counter in (("lane", "take_along[phase_lane]", "take_along"),
                                ("sublane", "take_along[phase_sublane]", "take_along"),
                                ("select", "select_samples_patch[phase_select]", "select_samples")):
        res = experiment(f"exp_r3_gather_probe {phase}", lambda phase=phase: exp_runs.gather_probe_run(
            dev, args.seed, phases=(phase,)), {row: counter})
        require(res[phase]["exact"], f"exp_r3_gather_probe {phase}: exact")
    res = experiment("exp_bisect (K=512, NS=1280)", lambda: exp_runs.bisect_run(dev, args.seed),
                     {f"bisect_{b}": f"bisect_{b}" for b in probes.BISECT})
    require(res["finite"], "exp_bisect: finite outputs")
    res = experiment("exp_r3_mxu_probe (K=4096, NS=512)", lambda: exp_runs.mxu_probe_run(dev, args.seed),
                     {f"mxu_{b}": f"mxu_{b}" for b in probes.MXU})
    require(res["finite"], "exp_r3_mxu_probe: finite outputs")
    experiment("exp_r5_pfused trig", lambda: exp_runs.trig_run(dev, args.seed), {"trig_probe": "trig_probe"})

    clock("8")
    # -- 9. the card against the port's CPU path on small inputs ------------
    rng = np.random.default_rng(args.seed + 3)
    crop = imgs[0, 128:384, 400:784]
    for name, img, cfg, cb, mf, share in (
        ("random 192x256", to_gray_f32(rng.uniform(0, 255, (192, 256)).astype(np.uint8)),
         Akaze(detector_threshold=0.001), 128, 256, 1.0),
        ("KITTI crop 256x384", np.ascontiguousarray(crop), Akaze.sparse(), 256, 512, 1.0),
        # The group describe, 1000+ angles: the fused describe's word gate.
        ("KITTI crop 256x384, dense, groups", np.ascontiguousarray(crop), Akaze(), 512, 2048, 0.99),
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
        require(rows >= share, f"{name}: {rows:.4f} of word rows equal")
        print(f"cpu reference {name}: {int(vg.sum())} keypoints, max point diff "
              f"{dist.min(1).max():.2e} px, word rows equal {rows:.4f}")
    # The exact extractor, row for row (its order is the reference's).
    crop_u8 = np.ascontiguousarray(load_gray(kitti_pair()[0])[128:384, 400:784])
    (kg, wg), (kr, wr) = (AkazeExtractor(Akaze(), device=d).extract(crop_u8) for d in (dev, "cpu"))
    require(len(kg["response"]) == len(kr["response"]) > 10, f"exact crop: counts {len(kg['response'])} vs "
                                                             f"{len(kr['response'])}")
    diff = float(np.abs(kg["point"] - kr["point"]).max())
    rows = float((wg == wr).all(1).mean())
    require(diff < 1e-3 and rows >= 0.99, f"exact crop: point diff {diff}, word rows equal {rows}")
    print(f"cpu reference exact KITTI crop 256x384: {len(kg['response'])} keypoints, max point diff {diff:.2e} px, "
          f"word rows equal {rows:.4f}")
    # The exact extractor's whole KITTI frames at Akaze() (phase 4b's
    # reports): scale space, counts, points, angles and word rows bitwise.
    for i, rep in enumerate(exact_rows):
        require(rep["planes_equal"] == rep["evolutions"] > 0, f"exact frame {i}: scale space differs card to CPU")
        require(rep["counts"][0] == rep["counts"][1] and rep["points_equal"], f"exact frame {i}: keypoints differ")
        require(rep["angles"] == 0, f"exact frame {i}: {rep['angles']} of {rep['rows']} angles differ")
        require(rep["unequal"] <= EXACT_UNEQUAL_ROWS * rep["rows"],
                f"exact frame {i}: {rep['unequal']} of {rep['rows']} word rows differ ({rep['moved']} moved a sample)")
    print("cpu reference exact KITTI frames at Akaze(): word rows unequal "
          + ", ".join(f"{r['unequal']} of {r['rows']}" for r in exact_rows)
          + f", angles unequal {', '.join(str(r['angles']) for r in exact_rows)} (bound {EXACT_UNEQUAL_ROWS}); "
          "scale space and points bitwise")
    print("exact extract ms a frame (card, warm; median of 3): " + ", ".join(f"{k} {v}" for k, v in exact_ms.items()))

    clock("9")
    # -- 10. timings -------------------------------------------------------
    for _ in range(2):
        extract_and_match(images)
    per_iter = wall_ms(lambda: extract_and_match(images), reps=10)
    med = statistics.median(per_iter)
    print(f"extract+match B={BATCH}: median {med:.3f} ms, min {min(per_iter):.3f} ms, "
          f"max {max(per_iter):.3f} ms over {len(per_iter)} reps; {BATCH * 1e3 / med:.2f} fps")
    fs5, stage_ms, scan = staged(extractor, images, "pgather", reps=5)
    words = fs5.words.reshape(BATCH // 2, 2, -1, 16)
    match = wall_ms(lambda: knn2(distance_matrix(words[:, 0], words[:, 1])), reps=5)
    for name, ms in stage_ms.items():
        print(f"stage {name}: median {ms:.3f} ms over 5 reps")
    print(f"stage match: median {statistics.median(match):.3f} ms over 5 reps")
    print(f"dedup kernel: median {statistics.median(s[0] for s in scan):.3f} ms, "
          f"sequential steps per frame {scan[0][1]}")
    for mode in ("pepatch", "ptiles", "pgather+inter", "pallas+inter"):
        _, other_ms, _ = staged(extractor, images, mode, reps=5)
        print(f"stage describe, {mode}: median {other_ms['describe']:.3f} ms over 5 reps "
              f"(pgather {stage_ms['describe']:.3f} ms)")
    # The whole extract in each mode of the slice, in turns (pgather, then
    # each '+inter' mode, then pgather again).
    extract_ms = {}
    for label, ex in (("pgather", extractor), *inter_extractors.items(), ("pgather ", extractor)):
        ex.extract(images)
        extract_ms[label] = statistics.median(wall_ms(lambda ex=ex: ex.extract(images), reps=7))
    print("extract B=8 ms (median of 7, in turns): " + ", ".join(f"{k.strip()} {v:.3f}" for k, v in
                                                                 extract_ms.items()))
    cons = wall_ms(lambda: pose_pair0(fs, idx, keep), reps=5)
    print(f"consensus (512 hypotheses, f64): median {statistics.median(cons):.3f} ms over {len(cons)} reps")

    def row(name, source, replaces, launches, rec):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        measured = ("device_ms", "library_device_ms", "plain_device_ms", "steps", "us_per_step", "engine", "calls",
                    "stage_ms", "stage_plain_ms", "stage_launches", "stage_plain_launches",
                    "aligned_ms", "aligned_plain_ms", "aligned_bound_ms", "parent_torch_ms", "library_calls",
                    "so3_entries", "residual_and_torch_device_ms", "call_ms", "rounds", "call_rounds",
                    "call_device_ms", "call_chain_floor_ms", "plain_graph_ms", "graph_rounds", "plain_launches",
                    "calls_held", "paths")
        return {"name": name, "route": "cuda", "source": f"cv_tpu_torch/csrc/{source}.cu", "replaces": replaces,
                "launches": launches, **{k: rec[k] for k in keys}, **{k: rec[k] for k in measured if k in rec}}

    # #2 and #3 both map to the patch form of kernel #1: one pair of
    # launches, the 'pallas' run's, stands in both rows.
    patch = select_records["select_samples_patch"]
    records = [
        row("select_samples", "select_samples", "cv_tpu/akaze/pallas_mldb.py:136",
            main_launches["select_samples"], select_records["select_samples"]),
        row("select_samples_interleaved", "select_samples", "cv_tpu/akaze/pallas_mldb.py:136",
            main_launches["select_samples_interleaved"], select_records["select_samples_interleaved"]),
        row("select_samples_patch[select_samples_batched]", "select_samples",
            "cv_tpu/akaze/pallas_mldb.py:175", main_launches["select_samples_patch"], patch),
        row("select_samples_patch[select_samples]", "select_samples",
            "cv_tpu/akaze/pallas_mldb.py:208", main_launches["select_samples_patch"], patch),
        row("select_groups", "select_groups", "cv_tpu/akaze/pallas_mldb.py:313",
            main_launches["select_groups"], select_records["select_groups"]),
        row("select_fused", "select_fused", "cv_tpu/akaze/pallas_mldb.py:494",
            main_launches["select_fused"], select_records["select_fused"]),
        row("dedup_scan", "dedup_scan", "cv_tpu/akaze/extrema.py:188",
            main_launches["dedup_scan"], dedup_record),
    ]
    for name, spec in POSE_KERNELS.items():
        records.append(row(name, name, spec["replaces"], main_launches[name], pose_records[name]))
    records.append(row("jacobi", "jacobi", "cv_tpu/ops/eigen.py:19", main_launches["jacobi"], jacobi_record))
    records.append(row("c2c_residual", "jacobi", "cv_tpu/core/pose.py:206", main_launches["c2c_residual"],
                       c2c_record))
    records.append(row("c2c_score", "jacobi", "cv_tpu/consensus/batch.py:135", main_launches["c2c_score"],
                       score_record))
    for name, (_, _, replaces) in SCALE_SPACE_ROWS.items():
        records.append(row(name, "scale_space", replaces, main_launches[name], scale_space_records[name]))
    # The trig kernel's row counts the describe paths' launches (angle_cv,
    # cos_sin), the so(3) maps' (cos_sin, atan2) and the probe run's.
    trig_launches = {k: main_launches[k] for k in ("angle_cv", "cos_sin", "atan2", "trig_probe")}
    main_launches["trig_probe"] = sum(trig_launches.values())
    print(f"trig kernel launches: {json.dumps(trig_launches)}")
    exp_records["trig_probe"]["so3_entries"] = trig64_record
    for name, (source, replaces) in EXPERIMENT_KERNELS.items():
        records.append(row(name, source, replaces, main_launches[name], exp_records[name]))
    clock("10")
    # -- 11. the library modules and the TF32 setting, on the card ------------
    # The plain graph BA of every recorded call (the SfM warm pass's and
    # the sandbox runs') on the CPU, after the timed phases and before
    # phase 11's; held against the kernel below.
    ba_plain = graph_ba_plain_on_cpu(ba_calls)
    library_ms = library_modules(dev, args.seed, exact_words)
    print("library modules ms: " + json.dumps({k: round(v, 3) for k, v in library_ms.items()}))
    graph_ba_record = check_graph_ba(dev, ba_calls, ba_plain)
    records.append(row("graph_ba", "graph_ba", "cv_tpu/sfm/device_refine.py:37", main_launches["graph_ba"],
                       graph_ba_record))
    tf32_invariance(dev, args.seed)
    clock("11")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
