#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pre3_tpu_torch) on one NVIDIA GPU.

Drives the port's slices through their entry points and checks each
CUDA kernel of those paths against its plain PyTorch version:

  * VO dead reckoning: ``extract_features`` → ``run_sequence`` (K2 match
    + K1-scored RANSAC per frame pair);
  * EKF-SLAM: ``extract_features`` → ``run_slam`` (per frame: VO with
    K2 + K1 and its IFT covariance, prediction, K2 map matching, 1-point
    RANSAC, Kalman updates, map management);
  * the flagship, BASELINE config #3 as bench.py headlines it:
    ``extract_features_sift`` → ``run_slam`` at K=256, and frame by frame
    through ``OnlineSlam(extractor="sift")`` as __graft_entry__ builds it;
  * config #2: ``extract_features`` → ``run_slam(matcher="ncc_warp")``
    with every frame's intensity and xyz image (VO with K2 + K1; the map
    matched by the warped-patch NCC scan);
  * config #4, the keyframe backend: ``select_keyframes`` →
    ``ba_problem_from_slam`` (with ``kf_feats``: keyframe tracks, K2 once
    per keyframe) → ``mine_keyframe_loop_closures`` (K2 + K1 per pair) →
    ``merge_lcp`` → ``bundle_adjust`` → ``apply_ba_corrections``, and
    ``OnlineSlam.smooth``;
  * the host-side paths: the ``.dat`` directory through the native
    decoder into ``OnlineSlam`` and the tracks BA
    (``python3 -m pre3_tpu_torch.examples.run_dat_pipeline``), the cached
    offline keyframing (``...examples.run_offline_keyframing``), replay
    from a snapshot, and the PnP/ICP solvers;
  * the multi-sequence path (``pre3_tpu_torch/utils/measure_batch.py``):
    ``extract_features_sift`` over S·F frames → ``run_slam_batched``, one
    ``torch.func.vmap(slam_step)`` over S sequences per step, K1 and K2
    launched once per step for all of them with a sequence axis;
  * the SIFT frontend's fast-math branch (``PRE3_SIFT_FAST_MATH=1``: bf16
    band filters on the tensor cores, bf16 descriptor taps) into
    ``run_slam``, and the full-engine walkthrough
    (``python3 -m pre3_tpu_torch.examples.run_synthetic_slam``: SIFT → VO
    → ``run_slam`` → keyframes → BA → smoothing → plots and PLY).

Run it from the root of a checkout:

    python3 chip_smoke.py

It builds the kernels from ``pre3_tpu_torch/csrc`` on first use (needs
``nvcc``; one ``nvcc`` per source, started together), needs one CUDA
device, and imports nothing of JAX. Phases:

  1. device     — the card's name and power limit (nvidia-smi);
  2. build      — compile or load K1 (RANSAC scorer), K2 (streaming
                  matcher), K3 (new landmarks and their Jacobians) and
                  K4 (the VO increment's IFT covariance), with ptxas
                  registers/spills;
  3. kernel     — K1, K2, K3 and K4 vs their plain versions on the card,
                  timed (K3 at a step's A = 8, a bootstrap's A = 32 and
                  S = 16 × 8 through torch.func.vmap, beside the four
                  passes it replaces and its empty-kernel floor; K4 at
                  N = 288 and 256 and S = 16 × 288 through vmap, beside
                  the torch.func passes it replaces and its floor, and
                  checked with all weights 0 and with 3 inliers);
  4. parity     — a 16-frame VO slice on the card vs the port's CPU path;
  5. slice      — the 256-frame corridor VO slice at the bench operating
                  point: frames/s, K1 and K2 launches per run, ATE;
  6. ekf-parity — a 16-frame run_slam (K=64, plane fit on) on the card vs
                  the port's CPU path, same injected draws;
  7. ekf-options — the same, with the iterated update (est_method="iekf"),
                  and with the attitude update every 4 steps;
  8. ekf-slice  — the 256-frame corridor run_slam with FAST features
                  (K=256, D=1549), one run under sync checks: frames/s,
                  K1 and K2 launches, ATE;
  9. sift-parity — an 8-frame extract_features_sift on the card vs the
                  port's CPU path: keypoints as sets, descriptors;
 10. sift-slice — the headline: the 256-frame corridor through
                  extract_features_sift and run_slam with bench.py's CFG
                  (K=256, min_measured=50, max_update_slots=96): frames/s
                  and the frontend's share, K1 and K2 launches per run,
                  n_ic/n_li/n_active, peak memory, ATE;
 11. online     — OnlineSlam(extractor="sift", n_landmarks=64) frame by
                  frame over 32 corridor frames against run_slam under the
                  same draws, with no host sync after the bootstrap; then
                  process_chunk over chunks of 8;
 12. online-smooth — OnlineSlam.smooth() after phase 11's frames against
                  the offline chain on run_slam's records, same draws;
 13. ncc-parity — a 16-frame run_slam with the NCC matcher (K=64) on the
                  card vs the port's CPU path, same draws; and with
                  est_method="iekf";
 14. ncc-slice  — config #2 over the 256-frame corridor at K=256:
                  frames/s, K1 and K2 launches (VO only), n_ic/n_li, ATE;
 15. ba         — config #4 on the SIFT slice's last trajectory: M, L,
                  observations, cost, BA time (ba_ms_total), launches and
                  device time per LM iteration of the BA program, post-BA
                  ATE; the same problem solved on the CPU;
 16. loop       — bench.py's out-and-back scene through the SIFT
                  run_slam, the keyframe BA, keyframe tracks (K2 per
                  keyframe) and mined loop closures (K2 + K1 per pair):
                  SLAM and post-BA ATE; the keyframe tracks built on the
                  card and on the CPU (by the eager loop of their body,
                  recorded keyframe by keyframe): their spawn masks and
                  post-BA ATEs;
 17. dat        — the native decoder built from native/sr4000_loader.cc,
                  against the numpy parser, and its decode rates; then
                  examples/run_dat_pipeline.py's chain (48 frames as .dat
                  → native decode in OnlineSlam.run's prefetch thread →
                  OnlineSlam → keyframes → tracks BA): online and post-BA
                  ATE, launches, ms per frame;
 18. offline-kf — examples/run_offline_keyframing.py cold, then warm on
                  the same caches: the warm keyframe search launches
                  nothing and repeats the cold one to the bit; KeyFrames/;
 19. replay     — a 16-frame run_slam snapshotted at step 7 and replayed
                  from the snapshot: equal to the uninterrupted run to the
                  bit; feature_performance, summarize_stats, the map as
                  PLY;
 20. pnp-icp    — EPnP, DLS-PnP, ICP and GICP on a corridor frame pair,
                  each through its program, on the card and on the CPU,
                  against the pair's VO;
 21. multi-device — the parallel modules on spawned ranks
                  (``parallel/dryrun.py``): 21a one rank in a real NCCL
                  group, the dry run's five stages, then sharded RANSAC at
                  2048 hypotheses on a SIFT pair (K1 at (2048, 288)),
                  landmark- and pose-sharded BA on phase 15's problem and
                  pose-sharded BA on phase 16's (with its loop-closure
                  pose factors), and run_slam_pipelined (SIFT, 64 frames,
                  chunks of 16), each against its single-device function
                  on the card; 21b two ranks sharing the card over gloo,
                  the five stages, RANSAC and the landmark-sharded BA,
                  equal to the bit across the ranks and within the
                  tolerances of 21a. Per case: collectives, bytes,
                  transport, K1/K2 launches. Each sharded BA (21a: both
                  on phases 15–16's problems; 21b: the landmark one and
                  the pose one on the dry run's problem) through its
                  program against its eager loop on every rank, bit for
                  bit: host ms, launches and device busy per LM
                  iteration, graphed and eager;
 22. batch      — 22a the batched K1 at (16, 512, 288) and K2 at
                  16 × 288²×128 and 16 × 256×288×128: bitwise equal to 16
                  single launches, one launch through torch.func.vmap,
                  against the vmapped plain version, timed; 22b 4 SIFT
                  corridors × 16 frames through run_slam_batched, each
                  against its own run_slam with the same generator; 22c
                  S = 1, 4, 16 over 32 frames with vmap's fallback off and
                  host syncs raising: K1 = 1 and K2 = 2 launches per
                  batched step, frames/s, launches and device busy per
                  step, idle share, peak memory, ATE;
 23. fast-sift-walkthrough — 23a 8 corridor frames through
                  extract_features_sift with the fast-math branch, card vs
                  the port's CPU path (keypoints as sets, descriptors),
                  and against the card's exact branch; 23b the frontend's
                  device time per frame over one 64-frame chunk, exact and
                  fast in turns, and the fast chunk's bf16 GEMMs; 23c a
                  32-frame fast-branch run_slam on corridor 0 of phase
                  22: K1 and K2 launches, ATE in the JAX fast band; 23d
                  examples/run_synthetic_slam.main at 32 frames: every
                  stage, K1/K2 per stage, BA cost, the PLY, three ATEs.
                  PRE3_SIFT_FAST_MATH is put back as it was found;
 24. graphs     — the step programs (utils/graphs.py), each against the
                  eager loop of its step on the card over 32 corridor
                  frames, bit for bit: run_slam for config #3, FAST EKF,
                  config #2, IEKF and the attitude update every 4 steps
                  (tilted floor), VO run_sequence, run_slam_batched at
                  S=4, OnlineSlam.process against its fused_fn, then
                  process_chunk and a resumed run (K3 once per
                  replayed step and once per bootstrap, K4 once per
                  replayed step of the EKF drivers and none for VO's
                  run_sequence). Per program: K1/K2
                  on the kernels' device counters; the driver's steps
                  profiled, with K1 and K2 found by name as often as the
                  counters ran them in that window, the host-issued
                  launches (graph launches, fills, copies) per step
                  within their limits and the device busy time and idle
                  share of that window; host ms per step graphed and
                  eager; capture seconds and pool; replays under sync
                  checks. Then the graphed run_slam's peak memory at 32
                  and 256 frames, the eager loop's at 16 and 48, what
                  one eager step's kept outputs hold, and the SIFT
                  frontend's peak at 32 and 256 frames;
 25. backend-graphs — config #4's programs, each against the eager loop
                  of its body on the card, bit for bit: bundle_adjust on
                  phase 15's problem and on phase 16's merged one (10 LM
                  iterations), build_tracks on the loop scene's 64
                  keyframes, the loop mining on its candidate pairs (the
                  same generator seed), the cold find_keyframes_vo of
                  phase 18's example. Per case: K1/K2 on the device
                  counters (0 per LM iteration, one K2 per keyframe, one
                  K1 and one K2 per pair, and K4 once per mined pair);
                  host ms, host-issued launches,
                  device busy and idle share per step, graphed and eager;
                  capture seconds and pools; launches within their limits;
 26. frontend-graphs — extract_features_sift (exact and fast) and
                  extract_features at 256 frames, 1 frame and 72 (a chunk
                  and a tail), each through its programs against its
                  bodies run eagerly, bit for bit: host ms, launches and
                  device busy per chunk, graphed and eager (at most 6
                  launches per chunk), capture seconds and pools; then
                  run_slam_pipelined against run_slam, to the bit;
 27. solver-graphs — the reference's last jitted sites as programs, each
                  against its bodies run under ``graphs.eager()`` on the
                  same inputs and draws, bit for bit: (a) icp and gicp on
                  phase 20's 2048-point clouds (20 iterations),
                  epnp_camera and dls_pnp on its pair's inliers; (b)
                  bootstrap_state for SIFT at K=256 with the plane-fit
                  prior, for NCC with its image, and bootstrap_batched at
                  S=4 with generators. Per case: host ms, host-issued
                  launches and device busy per iteration or bootstrap,
                  graphed and eager, capture seconds and pools; each
                  graphed call under sync checks; K1/K2 none, K3 once
                  per bootstrap (S for the batched one); launches
                  within SOLVER_LAUNCHES_ITERATION, _EPNP and
                  _BOOTSTRAP. Then a 32-frame SIFT run_slam's wall time
                  with the bootstrap eager and as its program (a record);
 28. tracer     — the tracer (utils/profiling.py) on phase 10's SIFT
                  run_slam: the probe kernel neither built nor loaded
                  before tracing turns on; a traced run bit-equal to an
                  untraced one; the step replays timed by their probes
                  (scan_steps.begin → .end) against CUDA events around
                  the same replays (a synchronize per step, a spin
                  kernel ahead of each so that the launch is queued
                  before the first event fires): the means
                  within 2% or 10 µs (TRACER_TOL); slam_step's stages
                  and the write-out within 1% of the replay; no probe
                  dropped; the clock mapping's uncertainty and the
                  smallest probe difference printed.

The drivers and their bootstraps, bundle_adjust's LM iterations, the
keyframe tracks, the loop-mining and keyframe-search pairs, the
standalone frontends (one graph per chunk), the sharded BAs (per LM
iteration one graph over NCCL or at one rank, one per block between
collectives over gloo), ICP, GICP, EPnP and DLS-PnP replay captured
CUDA graphs (K1 and K2 inside);
a program's first call captures it, waiting for the device once, and
the phases that time a driver run it once untimed first. K1 and K2 count
their own runs on the device (a replay counts; a program's warm-up,
set-up before its capture, does not).

Each phase prints its seconds (``[time]`` lines).

The line before the last is ``{"kernels": [...]}`` and the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without printing a result.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parent

# Operating point of the reference's config #1 (bench.py vo_pipeline).
N_FRAMES = 256
N_POINTS = 832
NOISE = 0.004
THRESHOLD = 0.05
MAX_FEATURES = 256
BATCH = 1024
TIMED_RUNS = 3
# ATE band of the VO corridor: the JAX reference on the CPU over keys
# 0..6 spans 0.8459–0.8500 m (PERF.md); the band is 0.848 ± 0.02 m.
ATE_CENTER, ATE_HALF_WIDTH = 0.848, 0.02
# Phase 4 (card vs CPU, same draws): pose agreement bound. Both run the
# same f32 arithmetic; only reduction order differs (~1e-6 per pair), and
# 15 chained pairs stay far inside 1e-3.
PARITY_TOL = 1e-3

# Operating point of the EKF slice: bench.py's headline (N_LANDMARKS=256,
# SlamConfig(min_measured=50, max_update_slots=96), vo_batch 512) on the
# same corridor, with FAST + patch features and ratio 1.3
# (tests/test_slam_sequence.py) in place of SIFT.
EKF_LANDMARKS = 256
EKF_CFG = dict(min_measured=50, max_update_slots=96, match_ratio=1.3)
# ATE band of the EKF slice: the JAX reference on the CPU over keys 0..6,
# same sequence, features and config, spans 0.1377–0.1688 m (PERF.md §2);
# the band is 0.153 ± 0.05 m, ~1.6× that spread on each side. A fault
# (a wrong branch, a lost update) moves it far more: dead-reckoned VO
# alone is 0.848 m.
EKF_ATE_CENTER, EKF_ATE_HALF_WIDTH = 0.153, 0.05
# Phase 6: card vs CPU poses over 15 steps (a Kalman-filtered chain of
# the VO's ~1e-6 per-pair differences), and how far the per-step counts
# may differ: a near-tie can flip one match in one step.
EKF_PARITY_TOL = 1e-3
EKF_PARITY_STEPS = 2
# The FAST and NCC slices each run once under sync checks (the first run
# captures the step program) and once timed.
EKF_TIMED_RUNS, NCC_TIMED_RUNS = 1, 1

# The flagship (bench.py CFG): SIFT, 3 octaves × 96 = 288 keypoints of
# 128 dims per frame, run_slam at K=256 with the default ratio 1.5.
SIFT_KF = 288
SIFT_LANDMARKS = 256
SIFT_CFG = dict(min_measured=50, max_update_slots=96)
# One run, timed and sync-checked, with this seed: the smoke ran 645–846 s
# with 1 warm-up and 1–2 timed runs, as host speed varied between H100
# machines, against its 1200 s limit.
SIFT_SEED = 1
# ATE band of the SIFT slice: the JAX reference on the CPU (its exact SIFT
# branch, tools/jax_sift_ate_band.py) over keys 0..6, same sequence and
# config, spans 0.1126–0.1277 m, mean 0.1188 (PERF.md §2); the band is
# 0.119 ± 0.03 m, ~2× that spread on each side. Dead-reckoned VO alone is
# 0.848 m.
SIFT_ATE_CENTER, SIFT_ATE_HALF_WIDTH = 0.119, 0.03
# Phase 9 (card vs CPU frontend): share of the CPU's valid keypoints found
# on the card (uv within 1e-3 px), and descriptor agreement on them —
# 1e-5 where the positions agree within 1e-5 px, 1e-4 on every match (a
# DoG summed in another order moves a refined keypoint by up to ~4e-4 px,
# and its upright descriptor by up to ~3e-5; tests/test_torch_sift.py).
SIFT_MIN_MATCHED = 0.99
SIFT_DESC_TOL, SIFT_DESC_TOL_MOVED = 1e-5, 1e-4
# Phase 11: OnlineSlam vs run_slam on the card, same draws and frontend
# calls; __graft_entry__'s configuration.
ONLINE_FRAMES, ONLINE_LANDMARKS, ONLINE_CHUNK = 32, 64, 8
ONLINE_TOL = 1e-5

# Config #2 (bench.py fast_ncc_pipeline, :313-325): FAST at threshold
# 0.05 with 256 features, the warped-patch NCC matcher (grid 13, patch 11,
# NCC ≥ 0.60, gates 2–20 px), ratio 1.3 (VO), every frame's intensity and
# xyz image given (so the plane-fit prior is on), K = EKF_LANDMARKS (256).
NCC_CFG = dict(min_measured=50, max_update_slots=96, matcher="ncc_warp",
               match_ratio=1.3)
# ATE band of config #2: the JAX reference on the CPU over keys 0..6
# (tools/jax_sift_ate_band.py --config ncc) spans 0.0536–0.0899 m, mean
# 0.0725 (PERF.md §2); the band is 0.072 ± 0.073 m, ~2× that spread on
# each side. Dead-reckoned VO alone is 0.848 m.
NCC_ATE_CENTER, NCC_ATE_HALF_WIDTH = 0.072, 0.073

# Config #4 (bench.py :240-269): select_keyframes(max_keyframes=64) →
# ba_problem_from_slam(max_landmarks=512) → bundle_adjust(iters=10) →
# apply_ba_corrections, on the SIFT slice's trajectory. Post-BA ATE band:
# the JAX reference on the CPU over keys 0..6 (--config ba) spans
# 0.1423–0.2026 m, mean 0.1634; the band is 0.172 ± 0.12 m.
BA_KEYFRAMES, BA_LANDMARKS, BA_ITERS = 64, 512, 10
BA_ATE_CENTER, BA_ATE_HALF_WIDTH = 0.172, 0.12
# The same BaProblem solved on the card and on the CPU: the same f32
# arithmetic in another reduction order. Every LM decision (accept or
# reject) must be the same on both: the smallest cost change was 0.013
# (8e-4 relative), far above f32 noise. Readings on an H100 (PERF.md
# §6): kf_t 4.3–6.6e-6 m, kf_q 2.6–8.5e-7, points 4.6e-5–1.1e-4 m; the
# bounds are 15× the largest kf_t and 9× the largest points reading.
BA_PARITY_TOL, BA_POINTS_TOL = 1e-4, 1e-3

# The loop scene (bench.py :271-306; tools/measure_lcp.py :52-80): the
# out-and-back corridor through the SIFT run_slam, then config #4's chain,
# once as bench.py runs it and once with keyframe tracks merged and the
# mined keyframe loop closures added. JAX CPU keys 0..6 (--config loop):
# SLAM ATE 0.0950–0.1310 m, post-BA 0.0699–0.0962 m, post-BA with tracks
# and mined loop closures 0.0942–0.1691 m; each band ~2× the spread on
# each side.
LOOP_POINTS = 600
MINE_MAX_PAIRS = 16  # mine_keyframe_loop_closures' default budget
LOOP_ATE_CENTER, LOOP_ATE_HALF_WIDTH = 0.113, 0.072
LOOP_BA_ATE_CENTER, LOOP_BA_ATE_HALF_WIDTH = 0.083, 0.053
LOOP_MINED_ATE_CENTER, LOOP_MINED_ATE_HALF_WIDTH = 0.132, 0.15

# Phase 16, the track table's zero rows: the post-BA ATE with keyframe
# tracks (no mined closures) on the card and on the CPU is held to the
# band of the loop's post-BA with tracks and mined closures.

# Phase 17 (examples/run_dat_pipeline.py, 48 frames, K=64, FAST 128):
# the JAX reference's chain on the CPU over keys 0..6
# (tools/jax_sift_ate_band.py --config dat) gives an online ATE of
# 0.0257–0.0258 m and a post-BA ATE of 0.0228 m on every key (PERF.md §2):
# the draws barely move this short, easy sequence. The bands, 0.026 ±
# 0.008 and 0.023 ± 0.008 m, are wide against that spread and narrow
# against a fault: dead-reckoned VO alone drifts several cm in 48 frames.
DAT_FRAMES, DAT_PAIRS = 48, 47
DAT_ATE_CENTER, DAT_ATE_HALF_WIDTH = 0.026, 0.008
DAT_BA_ATE_CENTER, DAT_BA_ATE_HALF_WIDTH = 0.023, 0.008
DAT_KEYFRAMES = 16  # select_keyframes(max_keyframes=16): K2 per slot
DAT_CHECK_FRAMES = 8  # decoded natively and by numpy, held to 1 ulp
# Phase 18: examples/run_offline_keyframing.py, 24 frames. The port on
# the CPU gives VO 0.0427 m and post-BA 0.0174 m; the smoke holds both
# below 0.1 m (a sanity bound: the run has no JAX band).
OFFLINE_ATE_MAX = 0.1
OFFLINE_BATCH = 512  # the example's find_keyframes_vo(batch=)
# Phase 19: 16 frames, K=64, snapshot after step 7.
REPLAY_FRAMES, REPLAY_SNAPSHOT = 16, 7
# Phase 20: card vs CPU on the same inputs. tests/test_torch_pnp_icp.py
# holds the port to the JAX reference at 1e-4 in r and t on 40–230
# points; over 2048 points (ICP/GICP) a nearest neighbour near a tie may
# differ between the two devices, so the bound is 1e-3.
PNP_ICP_TOL = 1e-3
ICP_POINTS = 2048

# Phase 21 (multi-device): the reference's sharded RANSAC batch; the
# pipeline over 64 of the corridor's frames in chunks of 16; each spawned
# run's time limit (a hung collective fails the phase).
MD_RANSAC_BATCH = 2048
MD_FRAMES, MD_CHUNK = 64, 16
MD_TIMEOUT = 300
# Landmark-sharded BA vs bundle_adjust on the same problem, on the card:
# phase 15's card-vs-CPU bounds, with every LM decision equal (the CPU
# tests: 0 at one rank on phase 15's problem, ≤ 1e-4 at 2 and 4 ranks
# against the reference's sharded BA). Pose-sharded: the reference
# test's 2e-3 on kf_t (the port on the CPU at one rank: 1.8e-5 on phase
# 15's problem, 2.4e-7 on phase 16's). The pipeline: t and q within
# 1e-4 where the chunked extraction's features are not bit-equal.
MD_BA_TOL, MD_BA_POINTS_TOL, MD_PIPE_TOL = 1e-4, 1e-3, 1e-4
MD_POSE_TOL, MD_POSE_POINTS_TOL = 2e-3, 5e-3
# 21b's landmark-sharded BA (two shards summed) against 21a's, on phase
# 15's problem in f32 and again in f64 (tools/md_ba_witness.py gives the
# readings). The two ranks add the reduced system in another order, and
# the solve (condition number 1.7e5 after Jacobi scaling) carries the f32
# rounding into the poses: on an H100 each f32 run lies up to 1.8e-4 m
# from its f64 run, and the two f32 runs part by 3.7e-6 to 1.0e-4 m in
# kf_t (points up to 1.2e-4 m) with nothing at fault; the f64 runs part
# by 8.4e-14 m. The faults the checks must catch, read at two CPU ranks:
# the odometry terms added on every rank before the all-reduce moves kf_t
# by 9.9e-3 m and the points by 2.0e-3 m, which the f32 bounds catch;
# the damping kept on every rank moves kf_t by 2.1e-5 m in f32, inside
# the f32 noise, and by 1.4e-7 m in f64 (kf_q 1.9e-8), which only the
# f64 bound catches.
MD_RANKS_TOL, MD_RANKS_POINTS_TOL = 1e-3, 5e-4
MD_RANKS_F64_TOL = 1e-10
# Each rank's K1 and K2 launches per stage and case of phase 21: the dry
# run's sharded RANSAC one K1; its FAST pipeline over 9 frames one K1
# and two K2 (VO, map match) per step; its multiprocess stage one RANSAC
# K1 and run_slam over 8 frames; the BAs none; the full-width RANSAC one
# K1 and the SIFT pipeline one K1 and two K2 per step.
MD_LAUNCHES = {
    "sharded-ransac": (1, 0), "sharded-ba": (0, 0),
    "pose-sharded-ba": (0, 0), "stage-pipeline": (8, 16),
    "multiprocess": (1 + 7, 2 * 7), "ransac": (1, 0), "ba": (0, 0),
    "ba64": (0, 0), "pose_ba": (0, 0), "pose_ba_loop": (0, 0),
    "pose_dry": (0, 0), "pipeline": (MD_FRAMES - 1, 2 * (MD_FRAMES - 1)),
}
# Each sharded BA's program against its eager loop (graphs.eager() in the
# rank): "X" is the solve whose first call captures, "X~graphed" the same
# solve again, replays only, and "X~eager" the eager loop, each timed;
# where MD_PROFILE says so, "X~graphed1/2" and "X~eager1/2" at 1 and 2 LM
# iterations, each profiled once on rank 0: their difference is one
# iteration (the profiler lists every kernel, a replayed one too, and a
# pose-sharded iteration holds ~7,000; whole solves take it minutes).
# Phase 16's problem is only timed. 21a's landmark-sharded BA issues at
# most MD_GRAPH_LAUNCHES host launches per LM iteration over its whole
# solve (one replay and the cost's copy per iteration; the shard's
# loads, cost0 and the result spread over it). 21b's pose-sharded case
# is the dry run's problem (dryrun.make_pose_ba_problem(2, seed 0)) at
# MD_DRY_ITERS iterations of MD_DRY_CG PCG iterations: over gloo every
# collective runs on the host (1.3 ms each in the dry run's stage, PR
# 12), 142 per iteration at this trip count, so the case is cut.
MD_GRAPH_LAUNCHES = 6
MD_DRY_ITERS, MD_DRY_CG = 2, 32
MD_PROFILE = {"ba": True, "pose_ba": True, "pose_ba_loop": False,
              "pose_dry": True}

# Phase 22 (batch): the multi-sequence path, run_slam_batched (one
# torch.func.vmap of slam_step over S sequences per step), on
# pre3_tpu_torch/utils/measure_batch.py's SIFT corridors (scene_seed=b,
# traj_seed=100 + b) cut to BATCH_FRAMES frames. 22a: the batched K1 at
# (BATCH_SEQS, 512, 288) and K2 at BATCH_SEQS × 288²×128 and × 256×288×128;
# 22b: BATCH_PARITY_SEQS sequences over their first BATCH_PARITY_FRAMES
# frames, each against its own run_slam with the same generator; 22c:
# S ∈ BATCH_SIZES, one sync-checked timed run each.
BATCH_SEQS = 16
BATCH_PARITY_SEQS, BATCH_PARITY_FRAMES = 4, 16
BATCH_SIZES, BATCH_FRAMES = (1, 4, 16), 32
# 22b: a batched sequence runs the single run's f32 arithmetic with the
# kernels bit-equal and a few reductions batched in another order (the
# CPU test: ≤ 3e-8 m over 7 steps, stats equal); every stat must be
# equal, and t within this bound, far under what a wrong draw, branch or
# match moves (≥ 1e-3 m).
BATCH_PARITY_TOL = 1e-4
# 22c: each sequence's ATE band. The JAX reference on the CPU over keys
# 0..6 (tools/jax_sift_ate_band.py --config batch: the same 32-frame
# corridors, the exact SIFT branch, K=256) gives these means per
# sequence, each key within 0.0021–0.0169 m of the others (PERF.md §2);
# the band is the mean ± 0.3× it, as the .dat bands are. Every reference
# key lies inside it (the farthest, sequence 13's 0.0900 m, at 0.61 of
# the half width).
BATCH_ATE_MEANS = (0.1116, 0.0463, 0.0641, 0.0938, 0.1375, 0.0777, 0.0823,
                   0.0852, 0.0565, 0.0311, 0.0429, 0.0560, 0.0620, 0.0760,
                   0.0873, 0.0305)
BATCH_ATE_REL = 0.3

# Phase 23 (fast-sift-walkthrough): the SIFT frontend's fast-math branch
# (PRE3_SIFT_FAST_MATH=1: bf16 band filters on the tensor cores, bf16
# descriptor taps) and examples/run_synthetic_slam.py. 23a: 8 corridor
# frames from each of four windows, card vs the port's CPU path.
# Keypoints as sets (phase 9's share); descriptors: bf16 values that
# differ by an f32 ulp can round to neighbouring bf16 values, one
# spacing being 2^-8–2^-7 of a binned tap. Card against CPU, the four
# windows read a largest error of 2.7e-4–6.9e-4 and a median of 3e-8 on
# an H100 (PERF.md §6); the exact branch against the fast one reads
# median 6.5e-4. So every match within 1e-3, the median within 1e-5.
# Against the card's exact branch, the reference test's criteria
# (tests/test_sift.py:263-267): ≥ 80% of the keypoint count, > 80% of
# exact keypoints with a fast one within 1 px, co-located descriptors'
# median cosine > 0.99.
FAST_FRAMES, FAST_WINDOWS = 8, (0, 64, 128, 192)
FAST_DESC_TOL, FAST_DESC_MEDIAN = 1e-3, 1e-5
# 23b: one 64-frame chunk (the frontend's FRAME_CHUNK), profiled in turns
# exact, fast, fast, exact after a warm-up of each. A bf16 GEMM is a
# device kernel whose name holds "bf16" or cuBLASLt's "nvjet_t" (bf16
# operands): at least one per product, two per level and octave, 3 × 6 ×
# 2 per fast chunk, and none in an exact one. The band filters' device
# time is that of the kernels launched inside BAND_RANGE, a profiler
# range around each _tri_sepconv call.
BAND_OCTAVES, BAND_LEVELS, BAND_RANGE = 3, 6, "sift._tri_sepconv"
FAST_CHUNK, FAST_GEMMS = 64, 36
# 23c: corridor 0 of the multi-sequence recipe (phase 22), 32 frames,
# K=256, the fast branch. The JAX reference on the CPU with its fast
# branch (tools/jax_sift_ate_band.py --config batch --frames 32
# --sequences 1 --fast-math) gives 0.1105–0.1126 m over keys 0..6, mean
# 0.1116, the exact branch's figures to four digits (PERF.md §2); the
# band is the mean ± 0.3× it, as 22c's.
FAST_ATE_MEAN = 0.1116
# 23d: examples/run_synthetic_slam.main at its defaults (32 frames, 400
# points): sanity bounds (no JAX band: the reference's walkthrough at 16
# frames gives VO 0.0415, SLAM 0.0252, smoothed 0.0244 m on the CPU).
WALK_FRAMES, WALK_ATE_MAX = 32, 0.5

# K2 agreement (phase 3): rows whose best/second margin, or ratio margin,
# is below this relative gap may legitimately resolve either way.
K2_MARGIN = 1e-5
# K3 agreement (phase 3): per output block, max |kernel − plain| over the
# block's largest |plain| entry (tests/test_torch_inverse_depth_init_card.py).
K3_TOL = 1e-5
# K3's f32 flops per candidate, counted from csrc/inverse_depth_init.cu
# with a value and two tangents per scalar: the 10 Newton steps ~640, the
# rest of the undistortion ~110, the rotations and angles ~150, the
# camera Jacobian's four columns ~200 (each atan2 counted as 1).
K3_FLOPS = 1100
# K4 agreement (phase 3), max |kernel − plain| over max |plain|: against
# the plain version in float64 on the same inputs (K4 computes in float64;
# tests/test_torch_vo_covariance_card.py). The gap to the plain version in
# float32 is printed beside that version's own gap to float64, which on
# an H100 read up to 1.02e-5 on one of 16 well-spread fits, and on the
# CPU up to ~3e-4 on fits of 3 inliers.
K4_TOL_F64 = 1e-6
# K4's f64 flops per point pair, counted from csrc/vo_covariance.cu: R·p2,
# the residual and p1 − t ~25, A's 10 sums ~60, the two point covariances
# ~60, V = [I; [p1 − t]×] R ~45, the two sandwiches U S Uᵀ (21 entries)
# ~510; the block's 6×6 inverse and products (~1000 once) left out.
K4_FLOPS = 700

# Phase 28: probe-timed step replays against CUDA events around them
# (a relative and an absolute tolerance: either holds), and the stages'
# sum against the replay.
TRACER_TOL, TRACER_TOL_US, TRACER_CLOSURE = 0.02, 10.0, 0.01
# A spin ahead of each timed replay (~10 ms at 1980 MHz): longer than
# the host takes to launch the step's graph, which in a whole smoke run
# took up to ~2 ms (0.43 ms on average) against a 0.5 ms spin.
TRACER_SPIN_CYCLES = 20_000_000
# Kernel timing (phase 3): device time by graph replay (see device_ms).
GRAPH_CALLS, GRAPH_REPLAYS, GRAPH_READINGS = 20, 10, 5
# Published peaks of one H100 SXM at 700 W (NVIDIA's H100 datasheet).
H100_BYTES_PER_S = 3.35e12
H100_TF32_FLOPS = 495e12
H100_F32_FLOPS = 67e12
H100_F64_FLOPS = 34e12
H100_BF16_FLOPS = 989e12


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def scorer_problem(b: int, n: int, seed: int, all_invalid: bool = False):
    """VO-like scoring inputs: p1 = R0·p2 + t0 + noise; hypothesis 0 is
    the true motion (R0, t0), the others perturb it."""
    from pre3_tpu_torch.data.synthetic import _rodrigues as rodrigues

    rng = np.random.default_rng(seed)
    r0 = rodrigues(rng.normal(scale=0.02, size=3))
    t0 = rng.normal(scale=0.03, size=3)
    p2 = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                   rng.uniform(1.2, 3.5, n)], axis=-1)
    p1 = p2 @ r0.T + t0 + rng.normal(scale=0.005, size=(n, 3))
    r = np.stack([r0 @ rodrigues(rng.normal(scale=0.02, size=3))
                  for _ in range(b)])
    t = t0 + rng.normal(scale=0.02, size=(b, 3))
    r[0], t[0] = r0, t0
    valid = (rng.uniform(size=n) > 0.2) & (not all_invalid)
    thr = 0.001 * np.sqrt(np.min(np.sum(p2 * p2, -1)))
    return [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in (r, t, p1, p2)] + [
        torch.as_tensor(valid, device="cuda"),
        torch.tensor(thr, dtype=torch.float32, device="cuda")]


def matcher_problem(n1: int, n2: int, d: int, seed: int,
                    device: str = "cuda"):
    """Unit descriptors; 60% of d1's rows are noisy copies of d2 rows, so
    the ratio test both accepts and rejects; ~10% invalid on each side.
    (The CPU tests draw the same problems with device="cpu".)"""
    rng = np.random.default_rng(seed)
    d2 = rng.normal(size=(n2, d)).astype(np.float32)
    d1 = rng.normal(size=(n1, d)).astype(np.float32)
    k = int(0.6 * min(n1, n2))
    d1[:k] = d2[rng.permutation(n2)[:k]] + rng.normal(scale=0.3, size=(k, d))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    v1 = rng.uniform(size=n1) > 0.1
    v2 = rng.uniform(size=n2) > 0.1
    return [torch.as_tensor(a, device=device) for a in (d1, d2, v1, v2)]


def capture(fn, calls: int = 1):
    """``fn`` warmed up on a side stream, then ``calls`` calls captured
    in one CUDA graph: the graph and the last captured call's outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    return graph, out


def device_ms(fn) -> float:
    """Device time per call, in ms: GRAPH_CALLS back-to-back calls of
    ``fn`` captured in one CUDA graph, CUDA events around GRAPH_REPLAYS
    replays, the median of GRAPH_READINGS such readings over
    GRAPH_REPLAYS·GRAPH_CALLS. No host work (the wrapper's checks,
    allocations, ctypes call) lies between the events."""
    graph, _ = capture(fn, GRAPH_CALLS)
    for _ in range(3):
        graph.replay()
    readings = []
    for _ in range(GRAPH_READINGS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(GRAPH_REPLAYS):
            graph.replay()
        stop.record()
        stop.synchronize()
        readings.append(start.elapsed_time(stop)
                        / (GRAPH_REPLAYS * GRAPH_CALLS))
    return statistics.median(readings)


def wrapper_ms(fn, calls: int = 200) -> float:
    """Host time per eager call, in ms: a host clock around ``calls``
    calls and one synchronize (the wrapper's Python, its checks and
    allocations, and the launch; the device time where that is longer)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def replay_equals_eager(fn) -> bool:
    """One call captured in a CUDA graph and replayed gives outputs
    bitwise equal to an eager call on the same inputs."""
    eager = [x.clone() for x in fn()]
    graph, captured = capture(fn)
    graph.replay()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(eager, captured))


def bound_ms(flops: float, flop_rate: float, nbytes: float):
    """The least time the card could take, in ms, and what bounds it:
    the larger of operations over the peak rate for their type and
    bytes (each input read once, each output written once) over the
    memory rate (published peaks of an H100 SXM at 700 W)."""
    t_ops = flops / flop_rate * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_bound(b: int, n: int, s: int = 1):
    """K1: ~28 f32 flops per (hypothesis, point) — 9 products, 9 sums
    and 3 differences for R·p2 + t − p1, 3 squares and 2 sums, the
    compare and the accumulation — outside the tensor cores; bytes: R,
    t, both point sets, the flags, the threshold, support and err; all
    of it ``s`` times for s sequences."""
    return bound_ms(28.0 * s * b * n, H100_F32_FLOPS,
                    s * (b * 48 + 2 * n * 12 + n + 4 + b * 8))


def k2_bound(n1: int, n2: int, d: int, s: int = 1):
    """K2: the product's 2·N1·N2·D flops at the TF32 tensor-core rate,
    the fastest the card runs f32 inputs (3xTF32 does three passes and
    cannot beat it); bytes: both descriptor sets, the column flags and
    the three outputs; all of it ``s`` times for s sequences."""
    return bound_ms(2.0 * s * n1 * n2 * d, H100_TF32_FLOPS,
                    s * (4 * (n1 + n2) * d + n2 + n1 * 16))


def k3_bound(a: int, s: int = 1):
    """K3: K3_FLOPS f32 flops per candidate outside the tensor cores;
    bytes: each candidate's pixel and ρ in, its y and three Jacobians
    (6 + 78 + 12 + 6 floats) out, and each sequence's camera."""
    return bound_ms(K3_FLOPS * s * a, H100_F32_FLOPS,
                    s * (a * 4 * (3 + 102) + 4 * 13))


def k4_bound(n: int, s: int = 1):
    """K4: K4_FLOPS f64 flops per point pair outside the tensor cores;
    bytes: each pair's two points and weight in, each sequence's R, t and
    its [6, 6] covariance out."""
    return bound_ms(K4_FLOPS * s * n, H100_F64_FLOPS,
                    s * (n * 4 * 7 + 4 * (12 + 36)))


def floor_fn(launch, *sizes):
    """An empty kernel at a kernel's launch configuration (grid, cluster,
    threads, shared memory) for these sizes: ``launch`` is the kernel
    library's ``*_floor_launch``."""
    def run():
        rc = launch(*sizes, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"empty-kernel launch failed: cudaError {rc}")
    return run


def render(n_frames: int, n_points: int, x_range, loop: bool = False):
    from pre3_tpu_torch.data.synthetic import render_sequence

    frames, traj, _ = render_sequence(
        n_frames=n_frames, n_points=n_points, noise=NOISE, x_range=x_range,
        loop=loop)
    intensity = np.stack([f.intensity for f in frames])
    xyz = np.nan_to_num(np.stack([f.xyz for f in frames]))
    conf = np.stack([f.confidence for f in frames])
    gt = (traj.t - traj.t[0]) @ traj.r[0]
    return (intensity, xyz, conf), gt


def features(images):
    from pre3_tpu_torch.frontend.pipeline import extract_features

    return extract_features(*images, threshold=THRESHOLD,
                            max_features=MAX_FEATURES)


def run_slice(images, gumbel=None, generator=None):
    from pre3_tpu_torch.vo.dead_reckoning import run_sequence

    return run_sequence(features(images), gumbel=gumbel, generator=generator,
                        batch=BATCH)


def run_ekf(images, n_landmarks, cfg, draws=None, generator=None,
            xyz_imgs=None):
    """FAST features → run_slam; the NCC matcher also gets every frame's
    intensity image."""
    from pre3_tpu_torch.ekf.slam import run_slam
    from pre3_tpu_torch.geometry.camera import sr4000_camera

    return run_slam(sr4000_camera(), features(images), cfg,
                    n_landmarks=n_landmarks, draws=draws,
                    generator=generator, xyz_imgs=xyz_imgs,
                    images=images[0] if cfg.matcher == "ncc_warp" else None)


def build_kernels(names):
    """One nvcc per source, all started together; echo ptxas's lines."""
    from pre3_tpu_torch.utils.cuda_build import build_library, library_path

    t0 = time.perf_counter()
    cached = {n: library_path(n).exists() for n in names}
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(build_library, names)))
    phase("build", f"{', '.join(names)} ready in "
          f"{time.perf_counter() - t0:.2f} s (in parallel)")
    for name, path in paths.items():
        phase("build", f"{name} {'loaded' if cached[name] else 'built'}: "
              f"{path.name}")
        log = path.with_suffix(".so.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    phase("build", f"{name}: {line.strip()}")


def k1_compare(where: str, name: str, args, k, p) -> float:
    """K1's (support, err) vs the plain version's on one problem: support
    equal but for points whose residual lies within 1e-6·thr of thr
    (they may fall either way; counted per hypothesis), err within 1e-5
    relative on the hypotheses without such points. Returns the largest
    err difference there."""
    from pre3_tpu_torch.ops.ransac_score import residuals_torch

    r, t, p1, p2, valid, thr = args
    (sup_k, err_k), (sup_p, err_p) = k, p
    torch.cuda.synchronize()
    resid2 = residuals_torch(r, t, p1, p2)
    band = (valid[None] & ((resid2 - thr).abs() <= 1e-6 * thr)).sum(-1)
    diff = (sup_k.long() - sup_p.long()).abs()
    outside = int((diff > band).sum())
    clean = band == 0
    rel = ((err_k - err_p).abs() / err_p.abs().clamp(min=1e-30))[clean]
    abs_err = float((err_k - err_p).abs()[clean].max())
    phase(where, f"K1 {name}: support mismatches outside band "
          f"{outside}, exact {int((diff == 0).sum())}/{len(sup_k)}; err max "
          f"abs {abs_err:.3e}, max rel "
          f"{float(rel.max()) if rel.numel() else 0.0:.3e}")
    if outside:
        raise AssertionError(f"K1 {name}: support differs outside the band")
    torch.testing.assert_close(err_k[clean], err_p[clean], rtol=1e-5,
                               atol=0.0)
    return abs_err


def check_k1():
    """K1 vs its plain version at every path's shape (VO (1024, 256), the
    EKF slices' and the offline keyframing's (512, 256), (512, 288), loop
    mining's (1024, 288) and 21b's sharded RANSAC, the .dat path's
    (512, 128), 21a's sharded RANSAC (2048, 288), the dry run's FAST VO
    (512, 96) and its RANSAC stage's (64, 64) and (32, 64)) and the corner
    cases; timings at the same shapes."""
    from pre3_tpu_torch.ops.ransac_score import (
        K1, score_hypotheses, score_hypotheses_torch,
    )

    cases = [  # (name, B, N, seed, all_invalid)
        ("main-1024x256", 1024, 256, 0, False),
        ("slam-512x288", 512, 288, 1, False),
        ("ekf-512x256", 512, 256, 6, False),
        ("mine-1024x288", 1024, 288, 17, False),
        ("dat-512x128", 512, 128, 21, False),
        ("multi-device-2048x288", 2048, 288, 23, False),
        ("dryrun-vo-512x96", 512, 96, 24, False),
        ("dryrun-64x64", 64, 64, 25, False),
        ("dryrun-2-ranks-32x64", 32, 64, 26, False),
        ("ragged-1000x250", 1000, 250, 2, False),
        ("n1-64x1", 64, 1, 3, False),
        ("all-invalid-128x256", 128, 256, 4, True),
        ("chunks-256x3000", 256, 3000, 5, False),
    ]
    max_abs_err = 0.0
    for name, b, n, seed, all_invalid in cases:
        args = scorer_problem(b, n, seed, all_invalid)
        sup_k, err_k = score_hypotheses(*args)
        abs_err = k1_compare("kernel", name, args, (sup_k, err_k),
                             score_hypotheses_torch(*args))
        max_abs_err = max(max_abs_err, abs_err)
        if all_invalid and int(sup_k.sum()) != 0:
            raise AssertionError(f"K1 {name}: all-invalid case has support")
        if not all_invalid and n > 1 and int(torch.argmax(sup_k)) != 0:
            raise AssertionError(f"K1 {name}: true motion (hyp 0) did not win")
    args = scorer_problem(512, 256, 12)
    if not replay_equals_eager(lambda: score_hypotheses(*args)):
        raise AssertionError("K1: graph replay differs from the eager call")
    phase("kernel", "K1 graph replay at 512x256: support and err bitwise "
          "equal to the eager call")
    timings = {}
    for name, b, n in (("1024x256", 1024, 256), ("512x256", 512, 256),
                       ("512x288", 512, 288), ("1024x288", 1024, 288),
                       ("512x128", 512, 128), ("2048x288", 2048, 288),
                       ("512x96", 512, 96), ("64x64", 64, 64)):
        args = scorer_problem(b, n, 10)
        t = dict(device_ms=device_ms(lambda: score_hypotheses(*args)),
                 plain_ms=device_ms(lambda: score_hypotheses_torch(*args)),
                 library_ms=None,
                 wrapper_ms=wrapper_ms(lambda: score_hypotheses(*args)),
                 launch_floor_ms=device_ms(floor_fn(
                     K1.lib().ransac_score_floor_launch, 1, b)))
        t["bound_ms"], t["bound_by"] = k1_bound(b, n)
        timings[name] = t
        phase("kernel", f"K1 time B×N={name}: device {t['device_ms']:.5f} ms "
              f"(empty-kernel floor {t['launch_floor_ms']:.5f}), plain "
              f"{t['plain_ms']:.5f}, library none, wrapper (host) "
              f"{t['wrapper_ms']:.5f}; bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}), {t['bound_ms'] / t['device_ms']:.2%} of it")
    return max_abs_err, timings


def init_problem(s: int, a: int, seed: int):
    """K3's inputs: candidates over the whole image, camera states with a
    unit q, depth priors across the corridor's range; a leading sequence
    axis when s > 1."""
    from pre3_tpu_torch.geometry.camera import sr4000_camera

    cam = sr4000_camera()
    rng = np.random.default_rng(seed)
    uv = rng.uniform(0, [cam.n_cols - 1, cam.n_rows - 1], (s, a, 2))
    cam13 = rng.normal(scale=0.5, size=(s, 13))
    q = rng.normal(size=(s, 4))
    cam13[:, 3:7] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    rho = rng.uniform(0.1, 2.0, (s, a))
    args = [torch.as_tensor(x[0] if s == 1 else x, dtype=torch.float32,
                            device="cuda") for x in (uv, cam13, rho)]
    return cam, args


def k3_gap(got, ref) -> float:
    """The largest, over K3's four output blocks, of max |got − ref| ÷
    the block's largest |ref| (NaNs in the same places)."""
    worst = 0.0
    for g, r in zip(got, ref):
        if not torch.equal(torch.isnan(g), torch.isnan(r)):
            raise AssertionError("K3: NaN layouts differ from the plain "
                                 "version's")
        ok = ~torch.isnan(r)
        worst = max(worst, float((g - r)[ok].abs().max())
                    / max(float(r[ok].abs().max()), 1e-30))
    return worst


def check_k3():
    """K3 vs its plain version at every path's shape (a step's A = 8, a
    bootstrap's A = 32, run_slam_batched's S = 16 × 8 through
    torch.func.vmap, one launch each), graph replay bitwise equal to the
    eager call; timings at the same shapes beside the plain version (the
    four passes it replaces; vmapped at S = 16) and the empty-kernel
    floor."""
    from pre3_tpu_torch.ops.inverse_depth_init import (
        K3, inverse_depth_init, inverse_depth_init_torch,
    )

    vmapped = lambda f, cam: torch.func.vmap(  # noqa: E731
        lambda u, c, r: f(cam, u, c, r))
    shapes = (("8", 1, 8), ("32", 1, 32), ("16x8", 16, 8))
    max_gap, timings = 0.0, {}
    for name, s, a in shapes:
        cam, args = init_problem(s, a, 30 + a + s)
        kernel = (vmapped(inverse_depth_init, cam) if s > 1 else
                  lambda *x: inverse_depth_init(cam, *x))
        plain = (vmapped(inverse_depth_init_torch, cam) if s > 1 else
                 lambda *x: inverse_depth_init_torch(cam, *x))
        inverse_depth_init.launches = 0
        got = kernel(*args)
        launches = inverse_depth_init.launches
        gap = k3_gap(got, plain(*args))
        max_gap = max(max_gap, gap)
        phase("kernel", f"K3 {name}: one launch {launches == 1}, largest "
              f"block gap {gap:.3e} (tolerance {K3_TOL})")
        if launches != 1 or gap > K3_TOL:
            raise AssertionError(f"K3 {name}: {launches} launches, gap "
                                 f"{gap:.3e}")
        if not replay_equals_eager(lambda: kernel(*args)):
            raise AssertionError(f"K3 {name}: graph replay differs from "
                                 f"the eager call")
        t = dict(device_ms=device_ms(lambda: kernel(*args)),
                 plain_ms=device_ms(lambda: plain(*args)), library_ms=None,
                 wrapper_ms=wrapper_ms(lambda: kernel(*args)),
                 launch_floor_ms=device_ms(floor_fn(
                     K3.lib().inverse_depth_init_floor_launch, s, a)))
        t["bound_ms"], t["bound_by"] = k3_bound(a, s)
        timings[name] = t
        phase("kernel", f"K3 time {name}: graph replay bitwise equal to "
              f"eager; device {t['device_ms']:.5f} ms (empty-kernel floor "
              f"{t['launch_floor_ms']:.5f}), plain {t['plain_ms']:.5f}, "
              f"library none, wrapper (host) {t['wrapper_ms']:.5f}; bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / t['device_ms']:.2%} of it")
    return max_gap, timings


def cov_problem(s: int, n: int, seed: int, n_inliers: int | None = None):
    """K4's inputs (r, t, p1, p2, w) on the card: a fit rotated by
    0.05 rad about a random axis with a few cm of translation, N points
    1–4 m in front of the camera with 5 mm of noise, ~70% inliers (or the
    first ``n_inliers``); a leading sequence axis when s > 1."""
    from pre3_tpu_torch.data.synthetic import _rodrigues

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(s):
        axis = rng.normal(size=3)
        r = _rodrigues(0.05 * axis / np.linalg.norm(axis))
        t = rng.normal(scale=0.05, size=3)
        p2 = np.c_[rng.uniform(-1.5, 1.5, (n, 2)), rng.uniform(1.0, 4.0, n)]
        p1 = p2 @ r.T + t + rng.normal(scale=0.005, size=(n, 3))
        w = (rng.uniform(size=n) < 0.7).astype(np.float64)
        if n_inliers is not None:
            w = (np.arange(n) < n_inliers).astype(np.float64)
        rows.append((r, t, p1, p2, w))
    return [torch.as_tensor(np.stack(x) if s > 1 else x[0],
                            dtype=torch.float32, device="cuda")
            for x in zip(*rows)]


def check_k4():
    """K4 vs the plain torch.func version in float64 on the same inputs
    (K4_TOL_F64; the float32 gap printed), at the main path's shapes (the
    SIFT step's N = 288, FAST's N = 256, run_slam_batched's S = 16 × 288
    through torch.func.vmap, one launch each) and at two degenerate ones
    (all weights 0, 3 inliers), graph replay bitwise equal to the eager call;
    timings at the main path's shapes beside the plain version (vmapped
    at S = 16) and the empty-kernel floor. Returns the largest gap to the
    float64 plain version, and the timings."""
    from pre3_tpu_torch.ops.vo_covariance import K4, vo_covariance
    from pre3_tpu_torch.vo.covariance import vo_covariance_torch

    def gap(got, ref):
        scale = float(ref.abs().max())
        return float((got.double() - ref.double()).abs().max()) / (
            scale if scale else 1.0)

    vmapped = torch.func.vmap
    shapes = (("288", 1, 288, None), ("256", 1, 256, None),
              ("16x288", 16, 288, None), ("288 weights 0", 1, 288, 0),
              ("288 3 inliers", 1, 288, 3))
    max_gap, timings = 0.0, {}
    for name, s, n, n_in in shapes:
        args = cov_problem(s, n, 50 + n + s, n_in)
        kernel = vmapped(vo_covariance) if s > 1 else vo_covariance
        plain = vmapped(vo_covariance_torch) if s > 1 else vo_covariance_torch
        vo_covariance.launches = 0
        got = kernel(*args)
        torch.cuda.synchronize()
        launches = vo_covariance.launches
        ref = plain(*args)
        ref64 = plain(*(x.double() for x in args))
        gap32, gap64 = gap(got, ref), gap(got, ref64)
        max_gap = max(max_gap, gap64)
        phase("kernel", f"K4 {name}: one launch {launches == 1}, gap "
              f"{gap64:.3e} to the plain version in f64 (tolerance "
              f"{K4_TOL_F64}), {gap32:.3e} to it in f32, whose own gap to "
              f"f64 is {gap(ref, ref64):.3e}; max |plain| "
              f"{float(ref.abs().max()):.3e}")
        if launches != 1 or gap64 > K4_TOL_F64:
            raise AssertionError(f"K4 {name}: {launches} launches, gap "
                                 f"{gap64:.3e} to the f64 plain version")
        if not replay_equals_eager(lambda: (kernel(*args),)):
            raise AssertionError(f"K4 {name}: graph replay differs from "
                                 f"the eager call")
        if n_in is not None:
            continue
        t = dict(device_ms=device_ms(lambda: kernel(*args)),
                 plain_ms=device_ms(lambda: plain(*args)), library_ms=None,
                 wrapper_ms=wrapper_ms(lambda: kernel(*args)),
                 launch_floor_ms=device_ms(floor_fn(
                     K4.lib().vo_covariance_floor_launch, s)))
        t["bound_ms"], t["bound_by"] = k4_bound(n, s)
        timings[name] = t
        phase("kernel", f"K4 time {name}: graph replay bitwise equal to "
              f"eager; device {t['device_ms']:.5f} ms (empty-kernel floor "
              f"{t['launch_floor_ms']:.5f}), plain {t['plain_ms']:.5f}, "
              f"library none, wrapper (host) {t['wrapper_ms']:.5f}; bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / t['device_ms']:.2%} of it")
    return max_gap, timings


def k2_compare(name, k, p, d1, d2, where: str = "kernel") -> float:
    """K2's Matches vs the plain matcher's: index equal on every row whose
    relative best/second margin exceeds K2_MARGIN, accepted equal where
    the ratio margin does too, "no candidate" (BIG) exactly where the
    plain version has it, dist2 and second within 1e-5·max‖d‖². Returns
    the largest dist2 error."""
    from pre3_tpu_torch.ops.matching import BIG

    scale = float(torch.maximum((d1 * d1).sum(-1).max(),
                                (d2 * d2).sum(-1).max()))
    margin = (p.dist2_second - p.dist2) / p.dist2.clamp(min=1e-30)
    clear = margin > K2_MARGIN
    ratio_gap = (p.dist2 * 1.3 - p.dist2_second).abs() / (
        p.dist2_second.clamp(min=1e-30))
    sel = clear & (ratio_gap > K2_MARGIN)
    idx_bad = int((k.index != p.index)[clear].sum())
    acc_bad = int((k.accepted != p.accepted)[sel].sum())
    # distances compared where finite; BIG (no candidate) must match
    # exactly
    big_bad = int(((k.dist2 >= BIG) != (p.dist2 >= BIG)).sum() + (
        (k.dist2_second >= BIG) != (p.dist2_second >= BIG)).sum())
    err = max(float(torch.where(q < BIG, (a - q).abs(), 0.0).max())
              for a, q in ((k.dist2, p.dist2),
                           (k.dist2_second, p.dist2_second)))
    phase(where, f"K2 {name}: index mismatches on clear rows "
          f"{idx_bad}/{int(clear.sum())}, accepted mismatches "
          f"{acc_bad}/{int(sel.sum())}, dist2 max abs err {err:.3e} "
          f"(tol {1e-5 * scale:.1e}), accepted {int(k.accepted.sum())}")
    if idx_bad or acc_bad or big_bad or err > 1e-5 * scale:
        raise AssertionError(f"K2 {name}: disagrees with the plain matcher")
    return err


def check_k2():
    """K2 vs the plain matcher on every path's shapes (the keyframe
    tracks' table with its zero, inactive rows among them) and the corner
    cases, those of the cluster's column split among them; graph replay
    vs eager; timings at the slices' shapes (256²×121, 288²×128,
    256×288×128, the keyframe tracks' 512×288×128, the map match at K=64
    of OnlineSlam and the walkthrough, 64×288×128, the .dat path's
    128²×121 and 64×128×121, the dry run's FAST 96²×121 and 24×96×121)
    and at 4096² and 8192², which no path of the repo reaches."""
    from pre3_tpu_torch.ops.matching import (
        BIG, K2, K2_RANKS, _best_two, _launch_k2, _pairwise_dist2,
        match_descriptors, match_descriptors_k2,
    )

    cases = [  # (name, N1, N2, D, seed)
        ("step-256x256-d121", 256, 256, 121, 0),
        ("sift-256x288-d128", 256, 288, 128, 1),
        ("sift-vo-288x288-d128", 288, 288, 128, 15),
        ("tracks-512x288-d128", 512, 288, 128, 16),
        ("dat-128x128-d121", 128, 128, 121, 22),
        ("dat-map-64x128-d121", 64, 128, 121, 23),
        # the map match at K=64: OnlineSlam (phase 11), the walkthrough
        ("k64-map-64x288-d128", 64, 288, 128, 26),
        ("dryrun-vo-96x96-d121", 96, 96, 121, 24),
        ("dryrun-map-24x96-d121", 24, 96, 121, 25),
        ("ragged-1000x777-d121", 1000, 777, 121, 2),
        ("one-1x1-d121", 1, 1, 121, 3),
        ("map-4096x4096-d128", 4096, 4096, 128, 4),
        ("map-8192x8192-d128", 8192, 8192, 128, 5),
        # fewer columns than the cluster's ranks: ranks with no column
        ("few-64x1-d121", 64, 1, 121, 8),
        ("few-64x7-d121", 64, 7, 121, 9),
        # one column past 8 full 64-column tiles: ragged rank ranges
        ("split-300x513-d128", 300, 8 * 64 + 1, 128, 10),
    ]
    max_abs_err = 0.0
    for name, n1, n2, d, seed in cases:
        d1, d2, v1, v2 = matcher_problem(n1, n2, d, seed)
        k = match_descriptors_k2(d1, d2, v1, v2, ratio=1.3)
        p = match_descriptors(d1, d2, v1, v2, ratio=1.3)
        torch.cuda.synchronize()
        max_abs_err = max(max_abs_err, k2_compare(name, k, p, d1, d2))
        if n2 > 1 and not bool(k.accepted.any()):
            raise AssertionError(f"K2 {name}: nothing accepted")

    # duplicate-column ties (inside a tile and across tiles): exact
    d1, d2, _, _ = matcher_problem(3, 300, 121, 6)
    d2[41] = d2[40]
    d2[200] = d2[7]
    d1 = d2[[7, 40, 250]].clone()
    k = match_descriptors_k2(d1, d2, ratio=1.5)
    p = match_descriptors(d1, d2, ratio=1.5)
    for m in (k, p):
        if m.index.tolist() != [7, 40, 250] or m.accepted.tolist() != [
            False, False, True
        ] or not torch.equal(m.dist2[:2], m.dist2_second[:2]):
            raise AssertionError(f"K2 duplicate tie: {m}")
    phase("kernel", "K2 duplicate-column tie: index [7, 40, 250], second == "
          "best on the tied rows, rejected — equal to the plain version")
    # duplicate pairs straddling the boundaries of the cluster's column
    # split (rank s walks [s·N2/S, (s+1)·N2/S)): exact
    n2 = 300
    cut1, cut2 = n2 // K2_RANKS, 2 * n2 // K2_RANKS
    d1, d2, _, _ = matcher_problem(2, n2, 121, 13)
    d2[cut1] = d2[cut1 - 1]
    d2[cut2] = d2[cut2 - 1]
    d1 = d2[[cut1 - 1, cut2 - 1]].clone()
    k = match_descriptors_k2(d1, d2, ratio=1.5)
    p = match_descriptors(d1, d2, ratio=1.5)
    for m in (k, p):
        if m.index.tolist() != [cut1 - 1, cut2 - 1] or bool(
            m.accepted.any()
        ) or not torch.equal(m.dist2, m.dist2_second):
            raise AssertionError(f"K2 straddling tie: {m}")
    phase("kernel", f"K2 tie across the split (columns {cut1 - 1}|{cut1}, "
          f"{cut2 - 1}|{cut2}): lower index, second == best, rejected — "
          "equal to the plain version")
    # valid columns inside one rank's range only
    lo, hi = 4 * n2 // K2_RANKS, 5 * n2 // K2_RANKS
    d1, d2, v1, _ = matcher_problem(40, n2, 121, 14)
    one = torch.zeros(n2, dtype=torch.bool, device="cuda")
    one[lo:hi] = True
    k = match_descriptors_k2(d1, d2, v1, one, ratio=1.3)
    p = match_descriptors(d1, d2, v1, one, ratio=1.3)
    max_abs_err = max(max_abs_err, k2_compare(
        f"valid-in-one-split-40x{n2}", k, p, d1, d2))
    if not bool(((k.index >= lo) & (k.index < hi)).all()):
        raise AssertionError("K2: a match outside the only valid range")
    # all-invalid d2: exact
    d1, d2, v1, _ = matcher_problem(50, 60, 121, 7)
    none2 = torch.zeros(60, dtype=torch.bool, device="cuda")
    k = match_descriptors_k2(d1, d2, v1, none2, ratio=1.3)
    p = match_descriptors(d1, d2, v1, none2, ratio=1.3)
    big = torch.tensor(BIG, dtype=torch.float32)
    for m in (k, p):
        if not (bool((m.index == 0).all()) and bool(
            (m.dist2.cpu() == big).all()) and bool(
                (m.dist2_second.cpu() == big).all()) and not bool(
                    m.accepted.any())):
            raise AssertionError(f"K2 all-invalid: {m}")
    phase("kernel", "K2 all-invalid d2: best = second = 1e30, index 0, "
          "nothing accepted — equal to the plain version")
    # the keyframe tracks' table (backend/tracks.py): 512 rows, zero and
    # inactive (valid1 False) until a keyframe spawns them, 64 at a time;
    # none active at the first keyframe. A zero row's distances are the
    # columns' ‖d2‖², equal to within ulps (unit descriptors), so its
    # index is a near-tie, left out of the index check and counted apart
    for n_active, seed in ((0, 18), (64, 19), (192, 20)):
        d1, d2, _, v2 = matcher_problem(512, 288, 128, seed)
        d1[n_active:] = 0.0
        v1 = torch.zeros(512, dtype=torch.bool, device="cuda")
        v1[:n_active] = True
        k = match_descriptors_k2(d1, d2, v1, v2, ratio=1.3)
        p = match_descriptors(d1, d2, v1, v2, ratio=1.3)
        name = f"tracks-{n_active}-active-512x288-d128"
        max_abs_err = max(max_abs_err, k2_compare(name, k, p, d1, d2))
        same = int((k.index == p.index)[n_active:].sum())
        phase("kernel", f"K2 {name}: zero rows' index equal to the plain "
              f"version's on {same}/{512 - n_active}")
        if bool(k.accepted[n_active:].any()) or (
            n_active and not bool(k.accepted.any())
        ):
            raise AssertionError(f"K2 {name}: accepted on inactive rows, "
                                 "or nothing on the active ones")

    d1, d2, v1, v2 = matcher_problem(256, 256, 121, 12)
    if not replay_equals_eager(
        lambda: match_descriptors_k2(d1, d2, v1, v2, ratio=1.3)
    ):
        raise AssertionError("K2: graph replay differs from the eager call")
    phase("kernel", "K2 graph replay at 256x256-d121: index, dist2, second "
          "and accepted bitwise equal to the eager call")

    timings = {}
    for name, n1, n2, d in (("256x256-d121", 256, 256, 121),
                            ("288x288-d128", 288, 288, 128),
                            ("256x288-d128", 256, 288, 128),
                            ("512x288-d128", 512, 288, 128),
                            ("128x128-d121", 128, 128, 121),
                            ("64x128-d121", 64, 128, 121),
                            ("64x288-d128", 64, 288, 128),
                            ("96x96-d121", 96, 96, 121),
                            ("24x96-d121", 24, 96, 121),
                            ("4096x4096-d128", 4096, 4096, 128),
                            ("8192x8192-d128", 8192, 8192, 128)):
        d1, d2, v1, v2 = matcher_problem(n1, n2, d, 11)
        # the kernel alone, and the plain version of what it computes
        # (masked distances → best/second); the ratio test after both is
        # a few elementwise kernels
        t = dict(
            device_ms=device_ms(lambda: _launch_k2(d1, d2, v2)),
            plain_ms=device_ms(lambda: _best_two(torch.where(
                v2[None, :], _pairwise_dist2(d1, d2), BIG))),
            library_ms=device_ms(lambda: torch.mm(d1, d2.T)),
            wrapper_ms=wrapper_ms(
                lambda: match_descriptors_k2(d1, d2, v1, v2, ratio=1.3)),
            launch_floor_ms=device_ms(floor_fn(
                K2.lib().match_stream_floor_launch, 1, n1, n2, d)))
        t["bound_ms"], t["bound_by"] = k2_bound(n1, n2, d)
        timings[name] = t
        phase("kernel", f"K2 time {name}: device {t['device_ms']:.5f} ms "
              f"(empty-kernel floor {t['launch_floor_ms']:.5f}), plain "
              f"{t['plain_ms']:.5f}, torch.mm f32 {t['library_ms']:.5f}, "
              f"wrapper (host) {t['wrapper_ms']:.5f}; bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / t['device_ms']:.2%} of it")
    return max_abs_err, timings


def vo_phases():
    """Phases 4 and 5: the VO slice, card vs CPU, then the corridor."""
    from pre3_tpu_torch.eval.trajectory import ate_rmse
    from pre3_tpu_torch.ops.matching import match_descriptors_k2
    from pre3_tpu_torch.ops.ransac_score import score_hypotheses

    n_short = 16
    images, _ = render(n_short, 300, None)
    gumbel = np.random.default_rng(7).gumbel(
        size=(n_short - 1, BATCH, MAX_FEATURES)).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        im = [torch.as_tensor(a, device=dev) for a in images]
        outs[dev] = run_slice(im, gumbel=torch.as_tensor(gumbel, device=dev))
    gpu, cpu = outs["cuda"], outs["cpu"]
    dt = float((gpu.t.cpu() - cpu.t).abs().max())
    dq = float((gpu.q.cpu() - cpu.q).abs().max())
    dn = int((gpu.n_inliers.cpu() - cpu.n_inliers).abs().max())
    phase("parity", f"VO {n_short} frames: ok equal "
          f"{bool(torch.equal(gpu.ok.cpu(), cpu.ok))}, max |Δn_inliers| {dn}, "
          f"max |Δt| {dt:.3e} m, max |Δq| {dq:.3e} (tolerance {PARITY_TOL})")
    if not torch.equal(gpu.ok.cpu(), cpu.ok) or dn > 1 or dt > PARITY_TOL or (
        dq > PARITY_TOL
    ):
        raise AssertionError("card and CPU VO slices disagree")

    drift = 0.03 * 0.5 * N_FRAMES
    t0 = time.perf_counter()
    images, gt = render(N_FRAMES, N_POINTS, (-1.8, drift + 1.8))
    im = [torch.as_tensor(a, device="cuda") for a in images]
    torch.cuda.synchronize()
    phase("slice", f"rendered + uploaded {N_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s (set-up, not timed)")
    seconds = []
    for run in range(TIMED_RUNS + 1):  # run 0 warms up
        gen = torch.Generator(device="cuda").manual_seed(run)
        torch.cuda.synchronize()
        # the warm-up run proves the path never waits on the card: any
        # synchronizing call (.item(), a device-to-host copy, ...) raises
        torch.cuda.set_sync_debug_mode("error" if run == 0 else "default")
        score_hypotheses.launches = 0
        match_descriptors_k2.launches = 0
        t0 = time.perf_counter()
        traj = run_slice(im, generator=gen)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        k1, k2 = score_hypotheses.launches, match_descriptors_k2.launches
        ok = traj.ok.cpu()
        ate = ate_rmse(traj.t.cpu().numpy(), gt, align=False)
        phase("slice", f"run {run}{' (warm-up, no host sync)' if run == 0 else ''}: "
              f"{elapsed:.4f} s, {N_FRAMES / elapsed:.2f} frames/s, "
              f"K1 launches {k1}, K2 launches {k2}, pairs ok "
              f"{int(ok[1:].sum())}/{N_FRAMES - 1}, mean inliers "
              f"{float(traj.n_inliers[1:].float().mean()):.1f}, ATE {ate:.4f} m")
        if k1 != N_FRAMES - 1 or k2 != N_FRAMES - 1:
            raise AssertionError(f"VO slice: K1 launched {k1}, K2 {k2} times; "
                                 f"expected {N_FRAMES - 1} each")
        if not bool(ok.all()):
            raise AssertionError("a frame pair failed")
        if abs(ate - ATE_CENTER) > ATE_HALF_WIDTH:
            raise AssertionError(f"ATE {ate:.4f} m outside {ATE_CENTER} ± "
                                 f"{ATE_HALF_WIDTH}")
        if run:
            seconds.append(elapsed)
    fps = sorted(N_FRAMES / s for s in seconds)
    phase("slice", f"VO frames/s median {statistics.median(fps):.2f}, min "
          f"{fps[0]:.2f}, max {fps[-1]:.2f} over {len(fps)} runs "
          f"(frontend + run_sequence, host clock around synchronize)")
    return images, im, gt


def ekf_draws(n_frames: int, cfg, n_landmarks: int, seed: int,
              kf: int = MAX_FEATURES):
    """Numpy-seeded Gumbel draws for every random choice of run_slam: the
    plane fits of the attitude update's steps (i % N == 0) stacked in
    step order."""
    from pre3_tpu_torch.ekf.one_point_ransac import pool_size
    from pre3_tpu_torch.ekf.slam import SlamDraws, StepDraws

    rng = np.random.default_rng(seed)
    g = lambda *s: rng.gumbel(size=s).astype(np.float32)
    m = pool_size(n_landmarks, cfg.max_update_slots or None)
    n_region = (144 - int(144 * 0.6)) * 176
    s = n_frames - 1
    every = cfg.heading_update_every
    n_fits = sum(1 for i in range(1, n_frames) if every and i % every == 0)
    return SlamDraws(
        steps=StepDraws(vo=g(s, cfg.vo_batch, kf),
                        ransac=g(s, cfg.ransac_batch, m), add=g(s, kf),
                        heading=g(n_fits, 512, n_region) if n_fits else None),
        boot_add=g(kf), plane=g(512, n_region))


def tilted_floor_xyz(tilt_deg: float = -20.0) -> np.ndarray:
    """An xyz image whose lower rows see a floor 1 m below a camera
    pitched by tilt_deg, and whose upper rows see a wall 4 m ahead (the
    rendered corridor has no floor, so its plane fits fail the gates)."""
    from pre3_tpu_torch.data.synthetic import _rodrigues as rodrigues

    h, w = 144, 176
    up_cam = rodrigues(np.array([np.radians(tilt_deg), 0, 0])).T @ np.array(
        [0.0, -1.0, 0.0])
    rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    rays = np.stack([(cc - 88) / 250.0, (rr - 72) / 250.0,
                     np.ones_like(cc, float)], axis=-1)
    denom = rays @ up_cam
    hits = denom < -1e-3
    s = -1.0 / np.where(hits, denom, -1.0)
    floor = (rr > h * 0.55) & hits & (s > 0) & (s < 8)
    return np.where(floor[..., None], rays * s[..., None],
                    rays * 4.0).astype(np.float32)


def ekf_parity(name: str = "ekf-parity", **options):
    """Phase 6 (7 and 13 with ``options``): 16-frame run_slam, K=64, card
    vs the port's CPU path, same draws. With the attitude update, every
    frame's xyz image is a tilted floor (so the plane fits pass their
    gates), and the card's run is also held against the same run without
    it: the update must have moved the orientation. With the NCC matcher
    every frame's intensity image is given too."""
    from pre3_tpu_torch.ekf.slam import SlamConfig
    from pre3_tpu_torch.utils.interop import to_torch

    n_short, k = 16, 64
    # max_update_slots 48 < K so the bounded update and pool run too
    cfg = SlamConfig(min_measured=50, max_update_slots=48, match_ratio=1.3,
                     **options)
    images, _ = render(n_short, 300, None)
    heading = cfg.heading_update_every > 0
    xyz_imgs = np.stack([tilted_floor_xyz()] * n_short) if heading else (
        images[1])
    draws = ekf_draws(n_short, cfg, k, seed=8)
    outs = {}
    for dev in ("cuda", "cpu"):
        im = [torch.as_tensor(a, device=dev) for a in images]
        outs[dev] = run_ekf(im, k, cfg, draws=to_torch(draws, dev),
                            xyz_imgs=torch.as_tensor(xyz_imgs, device=dev))
    if heading:
        off = run_ekf([torch.as_tensor(a, device="cuda") for a in images], k,
                      cfg._replace(heading_update_every=0),
                      draws=to_torch(draws, "cuda"),
                      xyz_imgs=torch.as_tensor(xyz_imgs, device="cuda"))
        moved = float((off.q - outs["cuda"].q).abs().max())
        phase(name, f"attitude update every {cfg.heading_update_every} "
              f"steps moved q by up to {moved:.3e} against the same run "
              f"without it")
        if moved < 1e-5:
            raise AssertionError(f"{name}: the attitude update never applied")
    gpu, cpu = outs["cuda"], outs["cpu"]
    dt = float((gpu.t.cpu() - cpu.t).abs().max())
    dq = float((gpu.q.cpu() - cpu.q).abs().max())
    d_ic = (gpu.stats.n_ic.cpu() - cpu.stats.n_ic).abs()
    d_li = (gpu.stats.n_li.cpu() - cpu.stats.n_li).abs()
    steps_off = int(((d_ic > 0) | (d_li > 0)).sum())
    phase(name, f"{n_short} frames, K={k} {options or ''}: n_ic equal per step "
          f"{bool((d_ic == 0).all())}, n_li equal per step "
          f"{bool((d_li == 0).all())} (steps differing {steps_off}, max "
          f"|Δn_ic| {int(d_ic.max())}, max |Δn_li| {int(d_li.max())}), "
          f"max |Δt| {dt:.3e} m, max |Δq| {dq:.3e} (tolerance "
          f"{EKF_PARITY_TOL}), mean n_li {float(cpu.stats.n_li.float().mean()):.1f}")
    if dt > EKF_PARITY_TOL or dq > EKF_PARITY_TOL or (
        steps_off > EKF_PARITY_STEPS
    ) or int(d_ic.max()) > 1 or int(d_li.max()) > 1 or not bool(
        torch.isfinite(gpu.t).all()
    ):
        raise AssertionError(f"{name}: card and CPU EKF runs disagree")


def ekf_slice(im, gt, name="ekf-slice", cfg_kw=EKF_CFG,
              band=(EKF_ATE_CENTER, EKF_ATE_HALF_WIDTH),
              timed_runs=EKF_TIMED_RUNS):
    """Phase 8 (14 with the NCC matcher): the 256-frame corridor EKF
    slice with FAST features at K=256, one run under sync checks and
    ``timed_runs`` more (with none, the checked run is the timed one).
    The descriptor matcher launches K2 twice per step (VO and the map),
    the NCC matcher once (VO; the map is matched by the NCC scan, which
    also gets every frame's xyz image)."""
    from pre3_tpu_torch.ekf.slam import SlamConfig
    from pre3_tpu_torch.eval.trajectory import ate_rmse
    from pre3_tpu_torch.ops.matching import match_descriptors_k2
    from pre3_tpu_torch.ops.ransac_score import score_hypotheses

    cfg = SlamConfig(**cfg_kw)
    ncc = cfg.matcher == "ncc_warp"
    want_k2 = (1 if ncc else 2) * (N_FRAMES - 1)
    center, half = band
    seconds = []
    for run in range(timed_runs + 1):  # run 0 runs under sync checks
        gen = torch.Generator(device="cuda").manual_seed(run)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if run == 0 else "default")
        score_hypotheses.launches = 0
        match_descriptors_k2.launches = 0
        t0 = time.perf_counter()
        out = run_ekf(im, EKF_LANDMARKS, cfg, generator=gen,
                      xyz_imgs=im[1] if ncc else None)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        k1, k2 = score_hypotheses.launches, match_descriptors_k2.launches
        s = out.stats
        t = out.t.cpu().numpy()
        ate = ate_rmse(t, gt, align=False)
        phase(name, f"run {run}{' (no host sync)' if run == 0 else ''}: "
              f"{elapsed:.4f} s, {N_FRAMES / elapsed:.2f} frames/s, "
              f"K1 launches {k1}, K2 launches {k2}, VO ok "
              f"{int(s.vo_ok.sum())}/{N_FRAMES - 1}, mean n_ic "
              f"{float(s.n_ic.float().mean()):.2f}, n_li "
              f"{float(s.n_li.float().mean()):.2f}, n_hi "
              f"{float(s.n_hi.float().mean()):.2f}, n_active "
              f"{float(s.n_active.float().mean()):.2f}, overflow "
              f"{int(s.update_overflow.sum())}, ATE {ate:.4f} m")
        if k1 != N_FRAMES - 1 or k2 != want_k2:
            raise AssertionError(f"{name}: K1 launched {k1}, K2 {k2} times; "
                                 f"expected {N_FRAMES - 1} and {want_k2}")
        if not np.isfinite(t).all():
            raise AssertionError(f"{name}: non-finite trajectory")
        if abs(ate - center) > half:
            raise AssertionError(f"{name}: ATE {ate:.4f} m outside {center} "
                                 f"± {half}")
        if run or not timed_runs:
            seconds.append(elapsed)
    fps = sorted(N_FRAMES / s for s in seconds)
    phase(name, f"frames/s median {statistics.median(fps):.2f}, "
          f"min {fps[0]:.2f}, max {fps[-1]:.2f} over {len(fps)} runs "
          f"(frontend + run_slam, host clock around synchronize)")
    return k1, k2


def sift_features(images):
    from pre3_tpu_torch.frontend.pipeline import extract_features_sift

    return extract_features_sift(*images)


def keypoint_matches(cpu, gpu):
    """The CPU run's valid keypoints found among the card's at uv within
    1e-3 px, over every frame: (share found, each match's uv gap, each
    match's largest descriptor error)."""
    found, total, gaps, errs = 0, 0, [], []
    for f in range(cpu.uv.shape[0]):
        cv, gv = cpu.valid[f], gpu.valid[f].cpu()
        cuv, guv = cpu.uv[f][cv], gpu.uv[f].cpu()[gv]
        d = (cuv[:, None] - guv[None]).abs().amax(-1)
        dmin, j = d.min(dim=1)
        hit = dmin < 1e-3
        found += int(hit.sum())
        total += int(cv.sum())
        gaps.append(dmin[hit])
        errs.append((cpu.desc[f][cv][hit]
                     - gpu.desc[f].cpu()[gv][j[hit]]).abs().amax(-1))
    return found / max(total, 1), torch.cat(gaps), torch.cat(errs)


def match_keypoints(cpu, gpu):
    """keypoint_matches as (share found, largest uv gap, descriptor error
    on matches whose uv agree within 1e-5 px, and on every match)."""
    share, gaps, errs = keypoint_matches(cpu, gpu)
    if not len(gaps):
        return share, 0.0, 0.0, 0.0
    same = gaps < 1e-5
    err_same = float(errs[same].max()) if bool(same.any()) else 0.0
    return share, float(gaps.max()), err_same, float(errs.max())


def sift_parity():
    """Phase 9: an 8-frame extract_features_sift, card vs the port's CPU
    path: keypoints as sets, descriptors on the matches."""
    n_short = 8
    images, _ = render(n_short, 300, None)
    gpu = sift_features([torch.as_tensor(a, device="cuda") for a in images])
    torch.cuda.synchronize()
    cpu = sift_features([torch.as_tensor(a) for a in images])
    share, gap, err_same, err_all = match_keypoints(cpu, gpu)
    n_cpu, n_gpu = int(cpu.valid.sum()), int(gpu.valid.sum())
    phase("sift-parity", f"{n_short} frames: valid keypoints CPU {n_cpu}, "
          f"card {n_gpu}; {share:.2%} of the CPU's found on the card (uv "
          f"within 1e-3 px, largest gap {gap:.2e} px); descriptor max abs "
          f"error {err_same:.2e} where uv agree within 1e-5 px (tolerance "
          f"{SIFT_DESC_TOL}), {err_all:.2e} on every match (tolerance "
          f"{SIFT_DESC_TOL_MOVED})")
    if share < SIFT_MIN_MATCHED or err_same > SIFT_DESC_TOL or (
        err_all > SIFT_DESC_TOL_MOVED
    ):
        raise AssertionError("card and CPU SIFT frontends disagree")


def sift_slice(im, gt):
    """Phase 10, the headline: the 256-frame corridor through
    extract_features_sift and run_slam with bench.py's CFG, once, timed
    and under sync checks, after one untimed run that captures run_slam's
    step program (K1, K2 and the SIFT frontend are warm from the earlier
    phases). The frontend and run_slam are timed apart: a synchronize
    between them, outside the checked calls."""
    from pre3_tpu_torch.ekf.slam import SlamConfig, run_slam
    from pre3_tpu_torch.eval.trajectory import ate_rmse
    from pre3_tpu_torch.geometry.camera import sr4000_camera
    from pre3_tpu_torch.ops.matching import match_descriptors_k2
    from pre3_tpu_torch.ops.ransac_score import score_hypotheses

    # the step program's capture: an untimed run at the same shapes
    warm = sift_features(im)
    run_slam(sr4000_camera(), warm, SlamConfig(**SIFT_CFG),
             n_landmarks=SIFT_LANDMARKS,
             generator=torch.Generator(device="cuda").manual_seed(0))
    del warm
    gen = torch.Generator(device="cuda").manual_seed(SIFT_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    score_hypotheses.launches = 0
    match_descriptors_k2.launches = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    feats = sift_features(im)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_fe = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("error")
    out = run_slam(sr4000_camera(), feats, SlamConfig(**SIFT_CFG),
                   n_landmarks=SIFT_LANDMARKS, generator=gen)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k1, k2 = score_hypotheses.launches, match_descriptors_k2.launches
    peak = torch.cuda.max_memory_allocated()
    s = out.stats
    t = out.t.cpu().numpy()
    ate = ate_rmse(t, gt, align=False)
    phase("sift-slice", f"{elapsed:.4f} s, {N_FRAMES / elapsed:.2f} frames/s "
          f"(frontend + run_slam, host clock around synchronize, no host "
          f"sync in either), frontend {t_fe:.4f} s "
          f"({1e3 * t_fe / N_FRAMES:.3f} ms per frame, {t_fe / elapsed:.2%}), "
          f"K1 launches {k1}, K2 launches {k2}, VO ok "
          f"{int(s.vo_ok.sum())}/{N_FRAMES - 1}, valid keypoints per "
          f"frame {float(feats.valid.sum(-1).float().mean()):.1f}, mean "
          f"n_ic {float(s.n_ic.float().mean()):.2f}, n_li "
          f"{float(s.n_li.float().mean()):.2f}, n_hi "
          f"{float(s.n_hi.float().mean()):.2f}, n_active "
          f"{float(s.n_active.float().mean()):.2f}, overflow "
          f"{int(s.update_overflow.sum())}, peak memory "
          f"{peak / 2**20:.1f} MiB, ATE {ate:.4f} m")
    if k1 != N_FRAMES - 1 or k2 != 2 * (N_FRAMES - 1):
        raise AssertionError(f"SIFT slice: K1 launched {k1}, K2 {k2} "
                             f"times; expected {N_FRAMES - 1} and "
                             f"{2 * (N_FRAMES - 1)}")
    if feats.desc.shape != (N_FRAMES, SIFT_KF, 128):
        raise AssertionError(f"SIFT slice: features {feats.desc.shape}")
    if not np.isfinite(t).all():
        raise AssertionError("SIFT slice: non-finite trajectory")
    if abs(ate - SIFT_ATE_CENTER) > SIFT_ATE_HALF_WIDTH:
        raise AssertionError(f"SIFT ATE {ate:.4f} m outside "
                             f"{SIFT_ATE_CENTER} ± {SIFT_ATE_HALF_WIDTH}")
    return k1, k2, out


def tracer_phase(im):
    """Phase 28: the tracer on the flagship's run_slam over phase 10's
    corridor (see the module docstring)."""
    from pre3_tpu_torch.ekf.slam import STAGES, SlamConfig, run_slam
    from pre3_tpu_torch.geometry.camera import sr4000_camera
    from pre3_tpu_torch.utils import graphs, profiling
    from torch.utils._pytree import tree_leaves

    def probe_loaded() -> bool:
        return "libprobe_" in Path("/proc/self/maps").read_text()

    feats = sift_features(im)

    def run():
        return run_slam(sr4000_camera(), feats, SlamConfig(**SIFT_CFG),
                        n_landmarks=SIFT_LANDMARKS,
                        generator=torch.Generator(device="cuda").manual_seed(
                            SIFT_SEED))

    plain = run()
    torch.cuda.synchronize()
    if probe_loaded():
        raise AssertionError("tracer: the probe kernel was loaded with "
                             "tracing off")
    replay, events = graphs.StepProgram.replay, []

    def timed(self, variant, generators=()):
        if self.name != "scan_steps":
            return replay(self, variant, generators)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        # the device spins while the host launches the replay, so the
        # events time the device's work, not the host's launch
        torch.cuda._sleep(TRACER_SPIN_CYCLES)
        a.record()
        replay(self, variant, generators)
        b.record()
        torch.cuda.synchronize()
        events.append(1e3 * a.elapsed_time(b))  # µs

    t0 = time.perf_counter()
    with profiling.tracing():
        traced = run()
        graphs.StepProgram.replay = timed
        try:
            timed_run = run()
        finally:
            graphs.StepProgram.replay = replay
    ex = profiling.export()
    for name, got in (("traced", traced), ("timed", timed_run)):
        for a, b in zip(tree_leaves(plain), tree_leaves(got)):
            if not torch.equal(a, b):
                raise AssertionError(f"tracer: the {name} run_slam differs "
                                     f"from the untraced one")
    probes = ex["probes"]
    begins = [i for i, p in enumerate(probes) if p[0] == "scan_steps.begin"]
    ends = [i for i, p in enumerate(probes) if p[0] == "scan_steps.end"]
    steps = N_FRAMES - 1
    if len(begins) != 2 * steps or len(ends) != 2 * steps:
        raise AssertionError(f"tracer: {len(begins)} step begin probes and "
                             f"{len(ends)} end probes for 2 × {steps} steps")
    pairs = list(zip(begins, ends))
    replay_us = [(probes[e][1] - probes[b][1]) / 1e3 for b, e in pairs]
    stage_us = {s: 0.0 for s in STAGES}
    for b, e in pairs:
        for p, q in zip(probes[b + 1:e], probes[b + 2:e + 1]):
            stage_us[p[0].split(".")[1]] += (q[1] - p[1]) / 1e3
    n = len(pairs)
    mean_probe = sum(replay_us[steps:]) / steps
    mean_event = sum(events) / len(events)
    worst = max(abs(a - b) for a, b in zip(replay_us[steps:], events))
    closure = sum(stage_us.values()) / sum(replay_us)
    diffs = [q[1] - p[1] for p, q in zip(probes, probes[1:]) if q[1] > p[1]]
    clock = ex["clock"]
    phase("tracer", f"{ex['counters'].get('graphs.replays', 0)} replays "
          f"traced in {time.perf_counter() - t0:.2f} s; step replay by probes "
          f"{mean_probe:.2f} µs against CUDA events {mean_event:.2f} µs "
          f"(sync per step; the widest step apart {worst:.2f} µs); the "
          f"untimed traced run's {sum(replay_us[:steps]) / steps:.2f} µs; "
          f"stages per step " + ", ".join(
              f"{k} {v / n:.2f}" for k, v in stage_us.items()) +
          f" µs: {closure:.4%} of the replay; probes dropped "
          f"{ex['dropped']}; clock offset uncertainty "
          f"{clock['uncertainty_ns']} ns, drift {clock['drift_ns']} ns; "
          f"smallest probe difference {min(diffs)} ns; bit-equal traced, "
          f"timed and untraced trajectories")
    if ex["dropped"]:
        raise AssertionError(f"tracer: {ex['dropped']} probes dropped")
    if len(events) != steps or abs(mean_probe - mean_event) > max(
            TRACER_TOL * mean_event, TRACER_TOL_US):
        raise AssertionError(f"tracer: probes {mean_probe:.2f} µs against "
                             f"events {mean_event:.2f} µs per step "
                             f"({len(events)} timed)")
    if abs(closure - 1.0) > TRACER_CLOSURE:
        raise AssertionError(f"tracer: the stages sum to {closure:.4%} of "
                             f"the replay")
    return dict(probe_us=mean_probe, event_us=mean_event,
                stages_us={k: v / n for k, v in stage_us.items()})


def online_phase(images, gt):
    """Phase 11: OnlineSlam (SIFT, K=64) frame by frame over the first 32
    corridor frames, given as host arrays as a sensor delivers them,
    against run_slam on the card under the same draws and the same
    per-frame frontend calls; no host sync in process() after the
    bootstrap. Then run() with chunks of 8 (process_chunk)."""
    from pre3_tpu_torch.ekf.slam import SlamConfig, StepDraws, run_slam
    from pre3_tpu_torch.eval.trajectory import ate_rmse
    from pre3_tpu_torch.geometry.camera import sr4000_camera
    from pre3_tpu_torch.runtime.online import OnlineSlam
    from pre3_tpu_torch.utils.interop import to_torch

    n = ONLINE_FRAMES
    cfg = SlamConfig(min_measured=50)  # __graft_entry__'s
    intensity, xyz, conf = (a[:n] for a in images)
    draws = to_torch(ekf_draws(n, cfg, ONLINE_LANDMARKS, seed=9, kf=SIFT_KF),
                     "cuda")
    slam = OnlineSlam(sr4000_camera(), cfg=cfg, n_landmarks=ONLINE_LANDMARKS,
                      extractor="sift")
    host_ms = []
    for i in range(n):
        step = draws if i == 0 else StepDraws(
            *(None if d is None else d[i - 1] for d in draws.steps))
        torch.cuda.set_sync_debug_mode("default" if i == 0 else "error")
        t0 = time.perf_counter()
        slam.process(intensity[i], xyz[i], conf[i], draws=step)
        host_ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ts, qs = slam.trajectory
    # the reference: run_slam fed the same per-frame frontend calls
    frames = [[torch.as_tensor(a[i:i + 1], device="cuda")
               for a in (intensity, np.nan_to_num(xyz), conf)]
              for i in range(n)]
    per_frame = [sift_features(f) for f in frames]
    feats = type(per_frame[0])(*map(torch.cat, zip(*per_frame)))
    ref = run_slam(sr4000_camera(), feats, cfg, n_landmarks=ONLINE_LANDMARKS,
                   draws=draws, xyz_imgs=torch.as_tensor(
                       np.nan_to_num(xyz), device="cuda"))
    dt = float(np.abs(ts - ref.t.cpu().numpy()).max())
    dq = float(np.abs(qs - ref.q.cpu().numpy()).max())
    stats_equal = all(
        bool(torch.equal(torch.stack([getattr(r.stats, f)
                                      for r in slam.results[1:]]),
                         getattr(ref.stats, f)))
        for f in ref.stats._fields)
    ate = ate_rmse(ts, gt[:n], align=False)
    med = statistics.median(host_ms[1:])
    phase("online", f"{n} frames, K={ONLINE_LANDMARKS}: process() host time "
          f"per frame median {med:.2f} ms ({min(host_ms[1:]):.2f}–"
          f"{max(host_ms[1:]):.2f}), bootstrap {host_ms[0]:.2f} ms, no host "
          f"sync after it; vs run_slam: stats equal {stats_equal}, max |Δt| "
          f"{dt:.3e} m, max |Δq| {dq:.3e} (tolerance {ONLINE_TOL}); ATE "
          f"{ate:.4f} m")
    if not stats_equal or dt > ONLINE_TOL or dq > ONLINE_TOL:
        raise AssertionError("OnlineSlam and run_slam disagree on the card")
    streamed = (slam, ref)

    chunked = OnlineSlam(sr4000_camera(), cfg=cfg,
                         n_landmarks=ONLINE_LANDMARKS, extractor="sift",
                         generator=torch.Generator("cuda").manual_seed(2))
    t0 = time.perf_counter()
    frames = [type("Frame", (), dict(intensity=intensity[i], xyz=xyz[i],
                                     confidence=conf[i])) for i in range(n)]
    out = chunked.run(frames, chunk=ONLINE_CHUNK)
    tc, _ = chunked.trajectory
    elapsed = time.perf_counter() - t0
    ate_c = ate_rmse(tc, gt[:n], align=False)
    dispatches = chunked.timer.summary()["dispatch"]["count"]
    phase("online", f"run(chunk={ONLINE_CHUNK}): {len(out)} steps in "
          f"{dispatches} dispatches, {elapsed:.3f} s ({n / elapsed:.2f} "
          f"frames/s, host clock around synchronize), ATE {ate_c:.4f} m")
    if len(out) != n or dispatches != 1 + -(-(n - 1) // ONLINE_CHUNK) or (
        not np.isfinite(tc).all()
    ):
        raise AssertionError("OnlineSlam.process_chunk run failed")
    return streamed


def smooth_phase(slam, ref):
    """Phase 12: OnlineSlam.smooth() (its defaults: keyframes over the
    whole history, max_keyframes 32, max_landmarks 256, 8 LM iterations)
    after phase 11's frames, against the offline chain on run_slam's
    records under the same draws."""
    from pre3_tpu_torch.backend.ba import bundle_adjust
    from pre3_tpu_torch.backend.ekf_ba import ba_problem_from_slam
    from pre3_tpu_torch.backend.keyframes import select_keyframes
    from pre3_tpu_torch.backend.smoothing import apply_ba_corrections
    from pre3_tpu_torch.geometry.camera import sr4000_camera

    t0 = time.perf_counter()
    sm_t, sm_q = slam.smooth()
    elapsed = time.perf_counter() - t0
    n = ref.t.shape[0]
    ks = select_keyframes(ref.t, ref.q, torch.ones(n, dtype=torch.bool,
                                                   device="cuda"),
                          max_keyframes=32)
    prob = ba_problem_from_slam(ref, ks.indices, ks.valid, max_landmarks=256)
    if prob is None:
        raise AssertionError("online-smooth: no landmark in two keyframes")
    res = bundle_adjust(sr4000_camera(), prob, iters=8)
    off_t, off_q = (x.cpu().numpy() for x in apply_ba_corrections(
        ref.t, ref.q, ks.indices, ks.valid, res.kf_t, res.kf_q))
    ts, _ = slam.trajectory
    dt = float(np.abs(sm_t - off_t).max())
    dq = float(np.abs(sm_q - off_q).max())
    moved = float(np.abs(sm_t - ts).max())
    phase("online-smooth", f"smooth() over {n} frames in {elapsed:.3f} s "
          f"(host clock; it synchronises): {int(ks.n)} keyframes, "
          f"{prob.mask.shape[1]} landmarks, cost {float(res.cost[0]):.4f} "
          f"-> {float(res.cost[-1]):.4f}; moved the trajectory by up to "
          f"{moved:.4f} m; vs the offline chain on run_slam's records: "
          f"max |Δt| {dt:.3e} m, max |Δq| {dq:.3e} (tolerance {ONLINE_TOL})")
    if dt > ONLINE_TOL or dq > ONLINE_TOL or moved < 1e-3 or not (
        np.isfinite(sm_t).all()
    ):
        raise AssertionError("OnlineSlam.smooth and the offline chain "
                             "disagree")


def ba_chain(out, kf_feats=None):
    """Config #4's keyframes and bridge on a run_slam output: (KeyframeSet,
    BaProblem); with ``kf_feats`` the keyframe tracks are merged."""
    from pre3_tpu_torch.backend.ekf_ba import ba_problem_from_slam
    from pre3_tpu_torch.backend.keyframes import select_keyframes

    n = out.t.shape[0]
    ks = select_keyframes(out.t, out.q, torch.ones(n, dtype=torch.bool,
                                                   device=out.t.device),
                          max_keyframes=BA_KEYFRAMES)
    prob = ba_problem_from_slam(out, ks.indices, ks.valid,
                                max_landmarks=BA_LANDMARKS, kf_feats=kf_feats)
    if prob is None:
        raise AssertionError("ba_problem_from_slam found no landmark")
    return ks, prob


def ba_solve(out, ks, prob):
    """bundle_adjust(iters=BA_ITERS) → apply_ba_corrections: (BaResult,
    smoothed positions [F, 3])."""
    from pre3_tpu_torch.backend.ba import bundle_adjust
    from pre3_tpu_torch.backend.smoothing import apply_ba_corrections
    from pre3_tpu_torch.geometry.camera import sr4000_camera

    res = bundle_adjust(sr4000_camera(), prob, iters=BA_ITERS)
    sm_t, _ = apply_ba_corrections(out.t, out.q, ks.indices, ks.valid,
                                   res.kf_t, res.kf_q)
    return res, sm_t


def describe(prob) -> str:
    m, l = prob.mask.shape
    n_lcp = 0 if prob.lcp_i is None else int(prob.lcp_i.shape[0])
    return (f"M {m}, L {l}, observations {int(prob.mask.sum())}, "
            f"loop-closure landmarks {int(prob.lc_lm.sum())}, lcp {n_lcp}")


def ba_phase(out, gt):
    """Phase 15, config #4 on the SIFT slice's last trajectory: keyframes
    and bridge, then BA + corrections twice (the first run warms up; the
    second is bench.py's ba_ms_total), one profiled BA (launches and
    device time per LM iteration), and the same BaProblem solved on the
    CPU."""
    from pre3_tpu_torch.backend.ba import BaProblem, bundle_adjust
    from pre3_tpu_torch.eval.trajectory import ate_rmse
    from pre3_tpu_torch.geometry.camera import sr4000_camera
    from pre3_tpu_torch.utils.profile_slice import _profiled

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ks, prob = ba_chain(out)
    torch.cuda.synchronize()
    t_bridge = time.perf_counter() - t0
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, sm_t = ba_solve(out, ks, prob)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    cost = res.cost.cpu().numpy()
    slam_ate = ate_rmse(out.t.cpu().numpy(), gt, align=False)
    ate = ate_rmse(sm_t.cpu().numpy(), gt, align=False)
    cam = sr4000_camera()
    launches, busy_us, window_s, _ = _profiled(
        lambda: bundle_adjust(cam, prob, iters=BA_ITERS))
    per_it = ms[1] / BA_ITERS
    busy_it = busy_us / 1e3 / BA_ITERS
    phase("ba", f"{int(ks.n)} keyframes; {describe(prob)}; keyframes + "
          f"bridge {1e3 * t_bridge:.1f} ms; BA + corrections {ms[0]:.1f} ms "
          f"(first), {ms[1]:.1f} ms (ba_ms_total; host clock around "
          f"synchronize); cost {cost[0]:.4f} -> {cost[-1]:.4f} "
          f"({', '.join(f'{c:.4f}' for c in cost)}); peak memory "
          f"{peak / 2**20:.1f} MiB; SLAM ATE {slam_ate:.4f} m, post-BA ATE "
          f"{ate:.4f} m")
    phase("ba", f"per LM iteration: {launches / BA_ITERS:.1f} launches, "
          f"device busy {busy_it:.3f} ms, host {per_it:.3f} ms unprofiled, "
          f"idle share {1.0 - busy_us / 1e6 / window_s:.4f} (of the "
          f"profiled run)")
    if not np.isfinite(cost).all() or cost[-1] >= cost[0]:
        raise AssertionError(f"BA: cost {cost[0]} -> {cost[-1]}")
    if abs(ate - BA_ATE_CENTER) > BA_ATE_HALF_WIDTH:
        raise AssertionError(f"post-BA ATE {ate:.4f} m outside "
                             f"{BA_ATE_CENTER} ± {BA_ATE_HALF_WIDTH}")
    t0 = time.perf_counter()
    res_cpu = bundle_adjust(cam, BaProblem(
        *(None if x is None else x.cpu() for x in prob)), iters=BA_ITERS)
    t_cpu = time.perf_counter() - t0
    dt = float((res.kf_t.cpu() - res_cpu.kf_t).abs().max())
    dq = float((res.kf_q.cpu() - res_cpu.kf_q).abs().max())
    dp = float((res.points.cpu() - res_cpu.points).abs().max())
    cost_cpu = res_cpu.cost.numpy()
    # a rejected LM step keeps the cost; an accepted one lowers it
    accepted, accepted_cpu = np.diff(cost) < 0, np.diff(cost_cpu) < 0
    phase("ba", f"card vs CPU (CPU solve {t_cpu:.1f} s): max |Δkf_t| "
          f"{dt:.3e} m, max |Δkf_q| {dq:.3e} (tolerance {BA_PARITY_TOL}), "
          f"max |Δpoints| {dp:.3e} m (tolerance {BA_POINTS_TOL}); LM steps "
          f"accepted {int(accepted.sum())}/{BA_ITERS} on the card, "
          f"{int(accepted_cpu.sum())}/{BA_ITERS} on the CPU, decisions "
          f"equal {bool((accepted == accepted_cpu).all())}; CPU cost "
          f"{', '.join(f'{c:.4f}' for c in cost_cpu)}")
    if dt > BA_PARITY_TOL or dq > BA_PARITY_TOL or dp > BA_POINTS_TOL or (
        not (accepted == accepted_cpu).all()
    ):
        raise AssertionError("BA: card and CPU solutions disagree")
    return prob


def loop_phase():
    """Phase 16, the loop scene (bench.py :271-306 and
    tools/measure_lcp.py :52-80): the out-and-back corridor through the
    SIFT run_slam; config #4's chain as bench.py runs it; then the
    keyframe tracks merged into the bridge (K2 once per keyframe) and the
    mined keyframe loop closures (K2 + K1 once per candidate pair tried)
    merged into its factors, and BA again. Returns the launches of the
    tracks and of the mining, the merged problem and phase 25's inputs."""
    from pre3_tpu_torch.backend.loop_detect import (
        merge_lcp, mine_keyframe_loop_closures, pairs_to_try,
    )
    from pre3_tpu_torch.ekf.slam import SlamConfig, run_slam
    from pre3_tpu_torch.eval.trajectory import ate_rmse
    from pre3_tpu_torch.frontend.pipeline import Features
    from pre3_tpu_torch.geometry.camera import sr4000_camera
    from pre3_tpu_torch.ops.matching import match_descriptors_k2
    from pre3_tpu_torch.ops.ransac_score import score_hypotheses

    drift = 0.03 * 0.5 * (N_FRAMES // 2)
    images, gt = render(N_FRAMES, LOOP_POINTS, (-1.8, drift + 1.8), loop=True)
    im = [torch.as_tensor(a, device="cuda") for a in images]
    t0 = time.perf_counter()
    feats = sift_features(im)
    out = run_slam(sr4000_camera(), feats, SlamConfig(**SIFT_CFG),
                   n_landmarks=SIFT_LANDMARKS,
                   generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t_slam = time.perf_counter() - t0
    slam_ate = ate_rmse(out.t.cpu().numpy(), gt, align=False)

    ks, prob = ba_chain(out)
    _, sm_t = ba_solve(out, ks, prob)
    ba_ate = ate_rmse(sm_t.cpu().numpy(), gt, align=False)

    idx = ks.indices.long()
    kf_feats = Features(*(x[idx] for x in feats))
    match_descriptors_k2.launches = 0
    _, prob_t = ba_chain(out, kf_feats)
    k2_tracks = match_descriptors_k2.launches
    score_hypotheses.launches = 0
    match_descriptors_k2.launches = 0
    mined = mine_keyframe_loop_closures(
        kf_feats, out.t[idx], out.q[idx], ks.valid, max_pairs=MINE_MAX_PAIRS,
        generator=torch.Generator(device="cuda").manual_seed(1))
    k1_mine, k2_mine = score_hypotheses.launches, match_descriptors_k2.launches
    n_mined = 0 if mined is None else len(mined[0])
    # the mining tries pairs_to_try's pairs in order until MINE_MAX_PAIRS
    # factors are accepted
    tried = pairs_to_try(out.t[idx], ks.valid)
    pairs = len(tried) if n_mined < MINE_MAX_PAIRS else tried.index(
        (int(mined[0][-1]), int(mined[1][-1]))) + 1
    merged = merge_lcp(prob_t, mined)
    res, sm2 = ba_solve(out, ks, merged)
    mined_ate = ate_rmse(sm2.cpu().numpy(), gt, align=False)
    l = prob.mask.shape[1]
    phase("loop", f"{N_FRAMES} frames out and back: SIFT run_slam "
          f"{t_slam:.1f} s ({N_FRAMES / t_slam:.2f} frames/s), SLAM ATE "
          f"{slam_ate:.4f} m; {int(ks.n)} keyframes; bench.py's chain: "
          f"{describe(prob)}, post-BA ATE {ba_ate:.4f} m")
    phase("loop", f"keyframe tracks ({min(4 * l, 512)} table rows × "
          f"{feats.desc.shape[1]} features per keyframe): K2 launches "
          f"{k2_tracks} for {len(idx)} keyframes; {describe(prob_t)}")
    phase("loop", f"loop mining: {pairs} candidate pairs tried, K2 launches "
          f"{k2_mine}, K1 launches {k1_mine}, {n_mined} factors mined; "
          f"merged: {describe(merged)}; cost {float(res.cost[0]):.4f} -> "
          f"{float(res.cost[-1]):.4f}; post-BA ATE {mined_ate:.4f} m")
    if k2_tracks != len(idx):
        raise AssertionError(f"tracks: K2 launched {k2_tracks} times for "
                             f"{len(idx)} keyframes")
    if pairs < 1 or k1_mine != pairs or k2_mine != pairs:
        raise AssertionError(f"loop mining: K1 {k1_mine}, K2 {k2_mine} "
                             f"launches for {pairs} pairs tried")
    for name, ate, center, half in (
            ("SLAM", slam_ate, LOOP_ATE_CENTER, LOOP_ATE_HALF_WIDTH),
            ("post-BA", ba_ate, LOOP_BA_ATE_CENTER, LOOP_BA_ATE_HALF_WIDTH),
            ("post-BA with tracks and mined loop closures", mined_ate,
             LOOP_MINED_ATE_CENTER, LOOP_MINED_ATE_HALF_WIDTH)):
        if abs(ate - center) > half:
            raise AssertionError(f"loop {name} ATE {ate:.4f} m outside "
                                 f"{center} ± {half}")
    zero_rows_phase(out, feats, ks, gt)
    # phase 25's inputs: the keyframes and table size the tracks ran with
    backend = dict(kf_feats=kf_feats, kf_t=out.t[idx], kf_q=out.q[idx],
                   kf_valid=ks.valid, max_tracks=min(4 * l, 512),
                   merged=merged)
    return k2_tracks, (k1_mine, k2_mine), merged, backend


def recorded_tracks(fn):
    """Run ``fn`` with backend/tracks.py's matcher and spawn mask
    recorded, its tracks built by the eager loop of their body: per
    keyframe, the table's active rows, each row's best feature (index)
    and the spawn-blocking ``used`` mask."""
    from pre3_tpu_torch.backend import tracks

    rec = []
    match, used = tracks.match_descriptors_auto, tracks.used_features
    build = tracks.build_tracks

    def match_rec(d1, d2, valid1=None, valid2=None, ratio=1.5):
        rec.append({"active": valid1.cpu()})
        return match(d1, d2, valid1=valid1, valid2=valid2, ratio=ratio)

    def used_rec(index, matched, n):
        out = used(index, matched, n)
        rec[-1].update(index=index.cpu(), used=out.cpu())
        return out

    # the eager loop of build_tracks' body, whose reads a capture would
    # refuse; phase 25 holds the program to it bit for bit
    tracks.match_descriptors_auto, tracks.used_features = match_rec, used_rec
    tracks.build_tracks = eager_build_tracks
    try:
        result = fn()
    finally:
        tracks.match_descriptors_auto, tracks.used_features = match, used
        tracks.build_tracks = build
    return result, rec


def winners(index: torch.Tensor, n: int) -> torch.Tensor:
    """[n] the highest table row naming each feature, -1 for none (the
    row whose ``matched`` flag decides ``used``)."""
    rows = torch.arange(index.shape[0])
    return torch.full((n,), -1, dtype=rows.dtype).scatter_reduce(
        0, index, rows, reduce="amax")


def zero_rows_phase(out, feats, ks, gt):
    """Phase 16's close-out of the track table's zero rows: the keyframe
    tracks and their BA built on the card and on the CPU from the same
    run_slam output (no draws on this path). Until the two tables part,
    every feature whose spawn mask (``used``) differs must be one that an
    inactive, zero row decides on either device, and they may part only
    after such a difference; both post-BA ATEs stay in band."""
    from pre3_tpu_torch.ekf.slam import SlamTrajectory, StepRecord, StepStats
    from pre3_tpu_torch.eval.trajectory import ate_rmse
    from pre3_tpu_torch.frontend.pipeline import Features

    idx = ks.indices.long()
    kf_feats = Features(*(x[idx] for x in feats))
    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    out_cpu = SlamTrajectory(t=out.t.cpu(), q=out.q.cpu(),
                             stats=StepStats(*map(cpu, out.stats)),
                             records=StepRecord(*map(cpu, out.records)))
    runs = {}
    for dev, o, kf in (("card", out, kf_feats),
                       ("CPU", out_cpu, Features(*map(cpu, kf_feats)))):
        (ks_d, prob), rec = recorded_tracks(lambda: ba_chain(o, kf))
        _, sm_t = ba_solve(o, ks_d, prob)
        runs[dev] = (rec, ate_rmse(sm_t.cpu().numpy(), gt, align=False))
    (rec_g, ate_g), (rec_c, ate_c) = runs["card"], runs["CPU"]
    # keyframe by keyframe while the two tables hold the same active rows:
    # once a spawn differs, the tables differ and so does every later match
    n_diff = n_zero = n_zero_rows_index = n_active_index = 0
    parted = None
    for i, (g, c) in enumerate(zip(rec_g, rec_c)):
        if not torch.equal(g["active"], c["active"]):
            parted = i
            break
        n = g["used"].shape[0]
        diff = g["used"] != c["used"]
        inactive = ~g["active"]
        by_zero = torch.zeros(n, dtype=torch.bool)
        for w in (winners(g["index"], n), winners(c["index"], n)):
            by_zero |= (w >= 0) & inactive[w.clamp(min=0)]
        n_diff += int(diff.sum())
        n_zero += int((diff & by_zero).sum())
        moved = g["index"] != c["index"]
        n_zero_rows_index += int(moved[inactive].sum())
        n_active_index += int(moved[~inactive].sum())
    phase("loop", f"zero rows: {len(rec_g)} keyframes, the tables equal "
          f"through keyframe {len(rec_g) if parted is None else parted}; "
          f"until then zero rows naming another feature on the card than "
          f"on the CPU {n_zero_rows_index}, active rows {n_active_index}; "
          f"spawn-mask features differing {n_diff}, of them decided by a "
          f"zero row {n_zero}; post-BA ATE with tracks: card {ate_g:.4f} "
          f"m, CPU {ate_c:.4f} m (band {LOOP_MINED_ATE_CENTER} ± "
          f"{LOOP_MINED_ATE_HALF_WIDTH})")
    if n_zero != n_diff or (parted is not None and not n_diff):
        raise AssertionError("tracks: the card and the CPU part on a "
                             "feature no zero row decides")
    for name, ate in (("card", ate_g), ("CPU", ate_c)):
        if abs(ate - LOOP_MINED_ATE_CENTER) > LOOP_MINED_ATE_HALF_WIDTH:
            raise AssertionError(f"tracks: {name} post-BA ATE {ate:.4f} m "
                                 "out of band")


def reset_launches():
    from pre3_tpu_torch.ops.inverse_depth_init import inverse_depth_init
    from pre3_tpu_torch.ops.matching import match_descriptors_k2
    from pre3_tpu_torch.ops.ransac_score import score_hypotheses
    from pre3_tpu_torch.ops.vo_covariance import vo_covariance

    score_hypotheses.launches = 0
    match_descriptors_k2.launches = 0
    inverse_depth_init.launches = 0
    vo_covariance.launches = 0


def read_launches() -> tuple[int, int]:
    from pre3_tpu_torch.ops.matching import match_descriptors_k2
    from pre3_tpu_torch.ops.ransac_score import score_hypotheses

    return score_hypotheses.launches, match_descriptors_k2.launches


def read_k3() -> int:
    """K3's runs on its device counter since ``reset_launches``."""
    from pre3_tpu_torch.ops.inverse_depth_init import inverse_depth_init

    return inverse_depth_init.launches


def read_k4() -> int:
    """K4's runs on its device counter since ``reset_launches``."""
    from pre3_tpu_torch.ops.vo_covariance import vo_covariance

    return vo_covariance.launches


def max_ulp(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in f32 ulps between two arrays (NaNs must agree)."""
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        raise AssertionError("NaN layouts differ")
    ia = np.nan_to_num(a).view(np.int32).astype(np.int64)
    ib = np.nan_to_num(b).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max(initial=0))


def dat_phase(work: Path):
    """Phase 17: the native decoder, built in this run from
    native/sr4000_loader.cc into build/native/, against the numpy parser
    and timed beside it; then examples/run_dat_pipeline.run on the card
    (48 frames exported as .dat, decoded natively in OnlineSlam.run's
    prefetch thread, OnlineSlam with K1 + K2 per pair and K2 on the map,
    keyframes, tracks BA with K2 per keyframe slot). Returns (K1, K2)
    launches of that run."""
    from pre3_tpu_torch.data import native_loader
    from pre3_tpu_torch.data.export import export_dat_sequence
    from pre3_tpu_torch.data.sr4000 import list_sequence, read_frame
    from pre3_tpu_torch.data.synthetic import render_sequence
    from pre3_tpu_torch.examples import run_dat_pipeline as ex

    lib = native_loader.library_path()
    lib.unlink(missing_ok=True)  # so that this run builds it
    t0 = time.perf_counter()
    built = native_loader.native_available()
    secs = time.perf_counter() - t0
    if not built or native_loader.loaded_library() != lib:
        raise AssertionError(f"dat: the native decoder built at {lib} is "
                             "not the one loaded")
    phase("dat", f"native decoder built from native/sr4000_loader.cc in "
          f"{secs:.2f} s: {lib.relative_to(ROOT)} (loaded; "
          f"flags {' '.join(native_loader.CXX_FLAGS)})")

    data_dir, out_dir = work / "data", work / "out"
    t0 = time.perf_counter()
    frames, traj, _ = render_sequence(n_frames=DAT_FRAMES, n_points=400,
                                      noise=0.004)
    export_dat_sequence(frames, str(data_dir))  # as run() renders it
    np.save(data_dir / "gt_t.npy", (traj.t - traj.t[0]) @ traj.r[0])
    paths = list_sequence(str(data_dir))
    t_export = time.perf_counter() - t0
    n_chk = DAT_CHECK_FRAMES
    t0 = time.perf_counter()
    ref = [read_frame(p) for p in paths[:n_chk]]
    t_numpy = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = [native_loader.read_frame_native(p) for p in paths]
    t_single = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = native_loader.read_sequence_native(paths)
    t_batch = time.perf_counter() - t0
    ulps = max(max_ulp(getattr(a, f), getattr(b, f))
               for a, b in zip(single[:n_chk], ref)
               for f in ("intensity", "xyz", "confidence"))
    same_batch = all(np.array_equal(getattr(a, f), getattr(b, f),
                                    equal_nan=True)
                     for a, b in zip(batch, single)
                     for f in ("intensity", "xyz", "confidence"))
    phase("dat", f"{DAT_FRAMES} frames rendered and exported as .dat in "
          f"{t_export:.1f} s; decode frames/s: numpy parser "
          f"{n_chk / t_numpy:.1f} (over {n_chk}), native one by one "
          f"{len(paths) / t_single:.1f}, native batch threaded "
          f"{len(paths) / t_batch:.1f} ({os.cpu_count()} host cores); native "
          f"vs numpy on {n_chk} frames: max {ulps} ulp; batch equal to "
          f"one by one {same_batch}")
    if ulps > 1 or not same_batch or any(
            a.timestamp != b.timestamp for a, b in zip(single, ref)):
        raise AssertionError("dat: the native decoder disagrees")

    class TimedSlam(ex.OnlineSlam):
        """OnlineSlam whose run() is timed up to a synchronize."""

        def run(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = super().run(*args, **kwargs)
            torch.cuda.synchronize()
            TimedSlam.seconds = time.perf_counter() - t0
            TimedSlam.timer = self.timer
            return out

    ex.OnlineSlam = TimedSlam
    try:
        reset_launches()
        t0 = time.perf_counter()
        ate, ate_ba = ex.run(str(data_dir), str(out_dir), n_frames=DAT_FRAMES,
                             device="cuda")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        k1, k2 = read_launches()
    finally:
        ex.OnlineSlam = ex.OnlineSlam.__mro__[1]
    stages = TimedSlam.timer.summary()
    wait = stages.get("decode_wait", {}).get("total_s", 0.0)
    saved = np.load(out_dir / "trajectory.npz")
    phase("dat", f"run_dat_pipeline: {elapsed:.2f} s in all; OnlineSlam.run "
          f"{TimedSlam.seconds:.2f} s, {1e3 * TimedSlam.seconds / DAT_FRAMES:.1f}"
          f" ms per frame (decode wait {1e3 * wait / DAT_FRAMES:.2f} ms per "
          f"frame); K1 launches {k1}, K2 launches {k2} ({DAT_PAIRS} pairs, "
          f"{DAT_KEYFRAMES} keyframe slots); online ATE {ate:.4f} m (band "
          f"{DAT_ATE_CENTER} ± {DAT_ATE_HALF_WIDTH}), post-BA ATE "
          f"{ate_ba:.4f} m (band {DAT_BA_ATE_CENTER} ± "
          f"{DAT_BA_ATE_HALF_WIDTH})")
    if k1 != DAT_PAIRS or k2 != 2 * DAT_PAIRS + DAT_KEYFRAMES:
        raise AssertionError(f"dat: K1 {k1}, K2 {k2} launches; expected "
                             f"{DAT_PAIRS} and {2 * DAT_PAIRS + DAT_KEYFRAMES}")
    if saved["t"].shape != (DAT_FRAMES, 3) or not np.isfinite(
            saved["t_ba"]).all():
        raise AssertionError("dat: the trajectory dump is malformed")
    for name, v, c, h in (("online", ate, DAT_ATE_CENTER, DAT_ATE_HALF_WIDTH),
                          ("post-BA", ate_ba, DAT_BA_ATE_CENTER,
                           DAT_BA_ATE_HALF_WIDTH)):
        if abs(v - c) > h:
            raise AssertionError(f"dat: {name} ATE {v:.4f} m outside {c} ± "
                                 f"{h}")
    return k1, k2


def offline_kf_phase(work: Path):
    """Phase 18: examples/run_offline_keyframing.main cold, then warm on
    the same work directory. The warm keyframe search reads every pair
    from VoCache: it launches neither kernel and returns the cold pass's
    keyframes, VO-call count and increments to the bit. Returns the
    (K1, K2) launches of the keyframe search, cold and warm, and the
    features it searched (phase 25's input)."""
    from pre3_tpu_torch.examples import run_offline_keyframing as ex

    find = ex.find_keyframes_vo
    counts, feats = [], []

    def counted(*args, **kwargs):
        reset_launches()
        out = find(*args, **kwargs)
        counts.append(read_launches())
        feats.append(args[0])
        return out

    ex.find_keyframes_vo = counted
    runs = []
    try:
        for _ in ("cold", "warm"):
            t0 = time.perf_counter()
            res = ex.main(str(work), device="cuda")
            torch.cuda.synchronize()
            runs.append((res, time.perf_counter() - t0))
    finally:
        ex.find_keyframes_vo = find
    (cold, t_cold), (warm, t_warm) = runs
    kc, kw = cold["keyframes"], warm["keyframes"]
    same = (np.array_equal(kc.indices, kw.indices)
            and kc.n_vo_calls == kw.n_vo_calls
            and np.array_equal(kc.delta_t, kw.delta_t)
            and np.array_equal(kc.delta_q, kw.delta_q))
    kdir = Path(cold["keyframe_dir"])
    n = len(kc.indices)
    dats = sorted(p.name for p in kdir.glob("d1_*.dat"))
    npzs = sorted(p.name for p in kdir.glob("features_*.npz"))
    manifest = json.loads((kdir / "manifest.json").read_text())
    phase("offline-kf", f"cold {t_cold:.2f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in cold["seconds"].items())
          + f"), warm {t_warm:.2f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in warm["seconds"].items())
          + f"); keyframes {kc.indices.tolist()} from {kc.n_vo_calls} VO "
          f"calls; K1/K2 launches in the keyframe search: cold "
          f"{counts[0][0]}/{counts[0][1]}, warm {counts[1][0]}/{counts[1][1]}"
          f"; warm equal to cold {same}; KeyFrames/: {len(dats)} .dat, "
          f"{len(npzs)} features npz, manifest of {len(manifest['original_indices'])}"
          f"; ATE VO {cold['ate_vo']:.4f} m, post-BA {cold['ate_ba']:.4f} m "
          f"(warm {warm['ate_ba']:.4f} m)")
    if counts[0] != (kc.n_vo_calls, kc.n_vo_calls) or counts[1] != (0, 0):
        raise AssertionError(f"offline-kf: launches {counts}")
    if not same or n < 2:
        raise AssertionError("offline-kf: the warm pass differs from the cold")
    if dats != [f"d1_{i + 1:04d}.dat" for i in range(n)] or len(npzs) != n or (
            manifest["original_indices"] != kc.indices.tolist()):
        raise AssertionError("offline-kf: KeyFrames/ is incomplete")
    if not (cold["ate_vo"] < OFFLINE_ATE_MAX and cold["ate_ba"] < OFFLINE_ATE_MAX):
        raise AssertionError("offline-kf: ATE above the sanity bound")
    return counts, feats[0]


def replay_phase(work: Path):
    """Phase 19: a 16-frame FAST run_slam (K=64) on the card; the same
    run stopped after step 7, snapshotted with its generator state
    (save_state(generator=)) and replayed by replay_sequence: poses and
    final state equal to the uninterrupted run's to the bit. Then
    feature_performance, summarize_stats and export_map_ply."""
    from pre3_tpu_torch.ekf.slam import (
        SlamConfig, _frame, bootstrap_state, run_slam, scan_steps,
    )
    from pre3_tpu_torch.eval.stats import summarize_stats
    from pre3_tpu_torch.eval.viz import export_map_ply
    from pre3_tpu_torch.frontend.pipeline import Features
    from pre3_tpu_torch.geometry.camera import sr4000_camera
    from pre3_tpu_torch.utils.checkpoint import save_state
    from pre3_tpu_torch.utils.replay import feature_performance, replay_sequence

    n, k, snap = REPLAY_FRAMES, 64, REPLAY_SNAPSHOT
    cam, cfg = sr4000_camera(), SlamConfig(min_measured=50, match_ratio=1.3)
    images, _ = render(n, 300, None)
    feats = features([torch.as_tensor(a, device="cuda") for a in images])
    gen = lambda: torch.Generator(device="cuda").manual_seed(5)  # noqa: E731
    steps = lambda a, b: torch.arange(a, b, dtype=torch.int32,  # noqa: E731
                                      device="cuda")
    chunk = lambda a, b: Features(*(x[a:b] for x in feats))  # noqa: E731

    out = run_slam(cam, feats, cfg, n_landmarks=k, generator=gen())
    g = gen()
    state0 = bootstrap_state(cam, _frame(feats, 0), cfg, k, generator=g)
    final, (ts, qs, _, _) = scan_steps(cam, state0, _frame(feats, 0),
                                       chunk(1, n), steps(1, n), cfg,
                                       generator=g, first_step=1)
    g = gen()
    state0 = bootstrap_state(cam, _frame(feats, 0), cfg, k, generator=g)
    mid, _ = scan_steps(cam, state0, _frame(feats, 0), chunk(1, snap + 1),
                        steps(1, snap + 1), cfg, generator=g, first_step=1)
    path = work / "snapshot.npz"
    save_state(str(path), mid, snap, generator=g)
    t0 = time.perf_counter()
    traj, rep_state, rep_stats = replay_sequence(cam, feats, str(path), cfg)
    torch.cuda.synchronize()
    t_rep = time.perf_counter() - t0
    rep_t = np.stack([t for t, _ in traj])
    rep_q = np.stack([q for _, q in traj])
    run_equal = torch.equal(ts, out.t[1:]) and torch.equal(qs, out.q[1:])
    poses_equal = (np.array_equal(rep_t, out.t[snap + 1:].cpu().numpy())
                   and np.array_equal(rep_q, out.q[snap + 1:].cpu().numpy()))
    state_equal = all(torch.equal(a, b) for a, b in zip(rep_state, final))
    perf = feature_performance(rep_state, n - 1)
    summary = summarize_stats(out.stats)
    ply = work / "map.ply"
    export_map_ply(str(ply), rep_state)
    n_pts = len(ply.read_text().splitlines()) - 7
    phase("replay", f"{n} frames, K={k}, snapshot after step {snap}: "
          f"replayed {len(traj)} steps in {t_rep:.2f} s; poses equal to the "
          f"uninterrupted run {poses_equal}, final state equal {state_equal} "
          f"(run_slam equal to the stepped run {run_equal}); "
          f"feature_performance: {len(perf.slot)} landmarks, track ratio "
          f"{perf.track_ratio.min():.3f}–{perf.track_ratio.max():.3f}; "
          f"summarize_stats: ic_matches_mean {summary['ic_matches_mean']:.2f}, "
          f"li_inliers_mean {summary['li_inliers_mean']:.2f}, vo_ok_rate "
          f"{summary['vo_ok_rate']:.3f}, map_size_final "
          f"{summary['map_size_final']}; map PLY {n_pts} points")
    if not (poses_equal and state_equal and run_equal) or len(
            rep_stats) != n - 1 - snap:
        raise AssertionError("replay: the replay differs from the run")
    if not len(perf.slot) or perf.track_ratio.max() > 1.0 or (
            n_pts != int(rep_state.active.sum())):
        raise AssertionError("replay: feature performance or map export")


def rotation_gap_deg(r, r_ref) -> float:
    c = (float(torch.trace(r @ r_ref.T)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def pnp_icp_phase(images):
    """Phase 20: EPnP (from pixels) and DLS-PnP on one corridor pair's
    FAST features (256 per frame): pixels of frame k against the points
    of frame k−1 over the pair's RANSAC-VO inliers; ICP and GICP on 2048
    valid points sampled from the two xyz images. Each solver on the card
    and on the CPU from the same inputs; every one against the VO.
    Returns (the largest card-vs-CPU gap, name → (solver, its inputs on
    the card)): phase 27's cases."""
    from pre3_tpu_torch.geometry.camera import sr4000_camera, undistort
    from pre3_tpu_torch.ops.matching import match_descriptors_auto
    from pre3_tpu_torch.vo.icp import gicp, icp
    from pre3_tpu_torch.vo.pnp import dls_pnp, epnp_camera
    from pre3_tpu_torch.vo.ransac import ransac_rigid

    k = 40
    pair = [torch.as_tensor(a[k - 1:k + 1], device="cuda") for a in images]
    f = features(pair)
    m = match_descriptors_auto(f.desc[0], f.desc[1], valid1=f.valid[0],
                               valid2=f.valid[1], ratio=1.3)
    p1, p2 = f.xyz[0], f.xyz[1][m.index]
    valid = m.accepted & f.valid[0] & f.valid[1][m.index]
    vo = ransac_rigid(p1, p2, valid, batch=BATCH,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    uv = f.uv[1][m.index]
    inl = vo.inliers
    # the VO's T_c(k-1)_ck as the PnP's world(k-1)→camera(k) motion
    r_vo, t_vo = vo.r.cpu(), vo.t.cpu()
    r_pnp_ref, t_pnp_ref = r_vo.T, -(r_vo.T @ t_vo)

    rng = np.random.default_rng(3)
    clouds = []
    for i in (0, 1):
        xyz = images[1][k - 1 + i].reshape(-1, 3)
        ok = np.flatnonzero(np.linalg.norm(xyz, axis=-1) > 0.4)
        clouds.append(xyz[rng.choice(ok, ICP_POINTS, replace=False)])
    pts = [torch.as_tensor(c, device="cuda") for c in clouds]
    ones = torch.ones(ICP_POINTS, dtype=torch.bool, device="cuda")
    cam = sr4000_camera()
    # DLS-PnP takes normalized coordinates: the undistorted pixels
    und = undistort(cam, uv)
    uv_n = torch.stack([(und[:, 0] - cam.cx) / cam.f,
                        (und[:, 1] - cam.cy) / cam.f], -1)
    solvers = {  # name: (solver, inputs, points, the VO's motion)
        "epnp_camera": (lambda a, b, c: epnp_camera(cam, a, b, c),
                        (p1, uv, inl), int(inl.sum()), (r_pnp_ref, t_pnp_ref)),
        "dls_pnp": (dls_pnp, (p1, uv_n, inl), int(inl.sum()),
                    (r_pnp_ref, t_pnp_ref)),
        "icp": (icp, (pts[0], pts[1], ones, ones), ICP_POINTS, (r_vo, t_vo)),
        "gicp": (gicp, (pts[0], pts[1], ones, ones), ICP_POINTS, (r_vo, t_vo)),
    }
    worst = 0.0
    for name, (fn, args, n_pts, (r_ref, t_ref)) in solvers.items():
        fn(*args)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        ms_gpu = 1e3 * (time.perf_counter() - t0)
        cpu_args = [a.cpu() for a in args]
        t0 = time.perf_counter()
        ref = fn(*cpu_args)
        ms_cpu = 1e3 * (time.perf_counter() - t0)
        dr = float((res.r.cpu() - ref.r).abs().max())
        dt = float((res.t.cpu() - ref.t).abs().max())
        worst = max(worst, dr, dt)
        phase("pnp-icp", f"{name}: {n_pts} points; card {ms_gpu:.2f} ms, CPU {ms_cpu:.2f} ms per call; "
              f"ok card {bool(res.ok)} CPU {bool(ref.ok)}; card vs CPU max "
              f"|Δr| {dr:.2e}, |Δt| {dt:.2e} m (tolerance {PNP_ICP_TOL}); "
              f"vs the pair's VO: rotation {rotation_gap_deg(res.r.cpu(), r_ref):.4f}"
              f" deg, translation {float((res.t.cpu() - t_ref).norm()):.4f} m")
        if bool(res.ok) != bool(ref.ok) or not bool(res.ok) or (
                dr > PNP_ICP_TOL or dt > PNP_ICP_TOL):
            raise AssertionError(f"pnp-icp: {name} disagrees card vs CPU")
    return worst, {name: (fn, args) for name, (fn, args, *_) in
                   solvers.items()}


def md_cpu(nt) -> dict:
    """A NamedTuple's fields as a dict of CPU tensors (None kept)."""
    return {k: None if v is None else v.cpu() for k, v in nt._asdict().items()}


def md_describe(name, rec) -> str:
    comm = ", ".join(f"{k} ×{v['count']} ({v['bytes']} B)"
                     for k, v in rec["comm"].items()) or "none"
    return (f"{name}: {rec['seconds']:.2f} s, K1 {rec['k1']}, K2 "
            f"{rec['k2']}; collectives {comm}")


def md_check_ba(name, got, ref, tol, points_tol):
    """A sharded BA's states against a reference BA's: (max |Δkf_t|,
    max |Δpoints|); every LM decision equal."""
    dt = float((got["kf_t"] - ref.kf_t.cpu()).abs().max())
    dq = float((got["kf_q"] - ref.kf_q.cpu()).abs().max())
    dp = float((got["points"] - ref.points.cpu()).abs().max())
    same = bool(np.array_equal(np.diff(got["cost"].numpy()) < 0,
                               np.diff(ref.cost.cpu().numpy()) < 0))
    phase("multi-device", f"{name}: max |Δkf_t| {dt:.3e} m, "
          f"max |Δkf_q| {dq:.3e} (tolerance {tol}), max |Δpoints| {dp:.3e} m "
          f"(tolerance {points_tol}); LM decisions equal {same}; cost "
          f"{float(got['cost'][0]):.4f} -> {float(got['cost'][-1]):.4f}")
    if dt > tol or dq > tol or dp > points_tol or not same:
        raise AssertionError(f"multi-device {name}: disagrees")
    return dt, dp


def md_check_launches(name, records) -> None:
    """Each stage's and case's K1 and K2 launches on one rank are
    MD_LAUNCHES'."""
    for case, rec in records.items():
        if (rec["k1"], rec["k2"]) != MD_LAUNCHES[case.split("~")[0]]:
            raise AssertionError(
                f"{name} {case}: K1 {rec['k1']}, K2 {rec['k2']} launches, "
                f"expected {MD_LAUNCHES[case]}")


def md_family(case: dict, profile: bool) -> list[dict]:
    """A sharded BA case and its family (see MD_PROFILE): the solve again
    through its program and as its eager loop, timed; with ``profile``
    each at 1 and 2 LM iterations, profiled."""
    args = case["args"]
    more = {"~graphed": {}, "~eager": dict(eager=True)}
    if profile:
        for n in (1, 2):
            more[f"~graphed{n}"] = dict(profile=True,
                                        args={**args, "iters": n})
            more[f"~eager{n}"] = dict(eager=True, profile=True,
                                      args={**args, "iters": n})
    return [case] + [{**case, "name": case["name"] + k, **v}
                     for k, v in more.items()]


def md_graphs(tag: str, results: list, name: str, iters: int,
              limit: float | None = None) -> dict:
    """A sharded BA's program against its eager loop on every rank:
    the first (capturing) solve, the replayed one and the eager loop
    equal to the bit; on rank 0 host ms per LM iteration, graphed and
    eager, and where the family was profiled, launches and device busy
    ms per LM iteration as 2 iterations less 1, graphed and eager, and
    the graphed solve's launches per LM iteration over ``iters`` (its
    loads, cost0 and result spread over it: 1 iteration's launches plus
    iters − 1 more iterations'), which ``limit`` bounds. Returns those
    figures."""
    for r in results:
        out = r["outputs"]
        for other in (name + "~graphed", name + "~eager"):
            diff = [k for k in out[name]
                    if not torch.equal(out[name][k], out[other][k])]
            if diff:
                raise AssertionError(f"{tag} {name}: rank {r['rank']}'s "
                                     f"{other} differs in {diff}")
    rec = results[0]["records"]
    g, e = rec[name + "~graphed"], rec[name + "~eager"]
    caps = rec[name]["captures"]
    res = dict(host_ms=1e3 * g["seconds"] / iters,
               eager_host_ms=1e3 * e["seconds"] / iters,
               first_s=rec[name]["seconds"], captures=len(caps),
               capture_s=sum(c[2] for c in caps),
               pool_mib=sum(c[3] for c in caps) / 2**20)
    line = (f"{tag} {name}: graphed vs eager bit-equal on every rank; per "
            f"LM iteration over {iters}: host {res['host_ms']:.3f} ms "
            f"graphed, {res['eager_host_ms']:.3f} ms eager; the first "
            f"(capturing) solve {res['first_s']:.2f} s: {len(caps)} graphs "
            f"captured in {res['capture_s']:.2f} s, pools "
            f"{res['pool_mib']:.1f} MiB "
            f"({', '.join(f'{c[1]} {c[3] / 2**20:.0f}' for c in caps)})")
    if name + "~graphed2" in rec:
        g1, g2 = rec[name + "~graphed1"], rec[name + "~graphed2"]
        e1, e2 = rec[name + "~eager1"], rec[name + "~eager2"]
        res.update(launches=g2["launches"] - g1["launches"],
                   busy_ms=g2["busy_ms"] - g1["busy_ms"],
                   idle=1.0 - g2["busy_ms"] / g2["wall_ms"],
                   eager_launches=e2["launches"] - e1["launches"],
                   eager_busy_ms=e2["busy_ms"] - e1["busy_ms"],
                   eager_idle=1.0 - e2["busy_ms"] / e2["wall_ms"])
        res["solve_launches"] = (g1["launches"] + (iters - 1)
                                 * res["launches"]) / iters
        line += (f"; 2 iterations less 1: graphed launches "
                 f"{res['launches']:.1f}, device busy {res['busy_ms']:.4f} "
                 f"ms, idle share {res['idle']:.4f} (2 iterations); eager "
                 f"launches {res['eager_launches']:.1f}, device busy "
                 f"{res['eager_busy_ms']:.4f} ms, idle share "
                 f"{res['eager_idle']:.4f}; the graphed solve "
                 f"{res['solve_launches']:.2f} launches per LM iteration")
    phase("multi-device", line)
    if limit is not None and res["solve_launches"] > limit:
        raise AssertionError(f"{tag} {name}: {res['solve_launches']:.2f} "
                             f"launches per LM iteration (limit {limit})")
    return res


def md_first_difference(a, b) -> str | None:
    for name in a._fields:
        if not torch.equal(getattr(a, name), getattr(b, name)):
            return name
    return None


def multi_device_phase(im, prob15, prob16):
    """Phase 21: the parallel modules on spawned ranks, 21a one rank in a
    real NCCL group, 21b two ranks sharing the card over gloo; each case
    against its single-device function on the card (computed here first,
    so the ranks only load the kernels phase 2 built). Returns the K1 and
    K2 launches of 21a and of 21b's ranks."""
    from pre3_tpu_torch.backend.ba import bundle_adjust
    from pre3_tpu_torch.ekf.slam import SlamConfig, run_slam
    from pre3_tpu_torch.frontend.pipeline import Features
    from pre3_tpu_torch.geometry.camera import sr4000_camera
    from pre3_tpu_torch.ops.matching import match_descriptors_auto
    from pre3_tpu_torch.parallel import dryrun
    from pre3_tpu_torch.utils.interop import to_torch
    from pre3_tpu_torch.vo.ransac import ransac_rigid

    cam = sr4000_camera()
    # one SIFT pair of phase 10's frames, matched as vo_pair matches it
    pair = sift_features([x[:2] for x in im])
    m = match_descriptors_auto(pair.desc[0], pair.desc[1],
                               valid1=pair.valid[0], valid2=pair.valid[1],
                               ratio=1.3)
    p1, p2 = pair.xyz[0], pair.xyz[1][m.index]
    valid = m.accepted & pair.valid[0] & pair.valid[1][m.index]
    gumbel = torch.as_tensor(np.random.default_rng(21).gumbel(
        size=(MD_RANSAC_BATCH, SIFT_KF)).astype(np.float32), device="cuda")
    ref_ransac = ransac_rigid(p1, p2, valid, batch=MD_RANSAC_BATCH,
                              support_threshold=1e-3, gumbel=gumbel)
    ref_ba = bundle_adjust(cam, prob15, iters=BA_ITERS)
    ref_ba16 = bundle_adjust(cam, prob16, iters=BA_ITERS)
    # the pipeline's reference: the full-batch frontend, then run_slam
    # under the same draws
    cfg = SlamConfig(**SIFT_CFG)
    draws = to_torch(ekf_draws(MD_FRAMES, cfg, SIFT_LANDMARKS, seed=22,
                               kf=SIFT_KF), "cpu")
    frames = [x[:MD_FRAMES] for x in im]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = sift_features(frames)
    torch.cuda.synchronize()
    t_fe = time.perf_counter() - t0
    ref_slam = run_slam(cam, feats, cfg, n_landmarks=SIFT_LANDMARKS,
                        draws=to_torch(draws, "cuda"))
    torch.cuda.synchronize()
    t_be = time.perf_counter() - t0 - t_fe

    ransac_case = {"name": "ransac", "kind": "ransac", "mesh": {"axis": "hyp"},
                   "args": {"p1": p1.cpu(), "p2": p2.cpu(),
                            "valid": valid.cpu(), "gumbel": gumbel.cpu(),
                            "batch": MD_RANSAC_BATCH,
                            "support_threshold": 1e-3}}
    ba_case = {"name": "ba", "kind": "ba", "mesh": {"axis": "lm"},
               "args": {"problem": md_cpu(prob15), "iters": BA_ITERS}}
    ba64_case = {"name": "ba64", "kind": "ba", "mesh": {"axis": "lm"},
                 "args": {"problem": {
                     k: v.double() if v is not None and v.is_floating_point()
                     else v for k, v in md_cpu(prob15).items()},
                     "iters": BA_ITERS}}
    pose_cases = [
        {"name": name, "kind": "pose_ba", "mesh": {"axis": "blk"},
         "args": {"problem": md_cpu(prob), "iters": BA_ITERS}}
        for name, prob in (("pose_ba", prob15), ("pose_ba_loop", prob16))]
    cases = [ransac_case, *md_family(ba_case, MD_PROFILE["ba"]),
             ba64_case] + [
        c for case in pose_cases
        for c in md_family(case, MD_PROFILE[case["name"]])
    ] + [{"name": "pipeline", "kind": "pipeline", "mesh": {"axis": "frame"},
          "args": {"intensity": frames[0].cpu(), "xyz": frames[1].cpu(),
                   "conf": frames[2].cpu(), "cfg": SIFT_CFG,
                   "n_landmarks": SIFT_LANDMARKS, "chunk": MD_CHUNK,
                   "extractor": "sift",
                   "draws": {"steps": draws.steps._asdict(),
                             "boot_add": draws.boot_add,
                             "plane": draws.plane}}}]
    torch.cuda.empty_cache()

    # ---- 21a: one rank, a real NCCL group ----
    t0 = time.perf_counter()
    res_a = dryrun.run(1, backend="nccl", device="cuda", cases=cases,
                       timeout=MD_TIMEOUT)[0]
    phase("multi-device", f"21a: 1 rank, NCCL, {res_a['device']}: "
          f"{time.perf_counter() - t0:.1f} s with the spawn")
    for name, rec in res_a["records"].items():
        phase("multi-device", "21a " + md_describe(name, rec))
    md_check_launches("21a", res_a["records"])
    out = res_a["outputs"]
    got = out["ransac"]
    for f in ref_ransac._fields:
        if not torch.equal(got[f], getattr(ref_ransac, f).cpu()):
            raise AssertionError(f"21a sharded RANSAC {f} differs from "
                                 "ransac_rigid")
    phase("multi-device", f"21a sharded RANSAC ({MD_RANSAC_BATCH}, {SIFT_KF}): "
          f"equal to ransac_rigid to the bit; n_inliers "
          f"{int(got['n_inliers'])}, best_support {int(got['best_support'])}")
    md_check_ba("21a landmark-sharded BA vs bundle_adjust", out["ba"], ref_ba,
                MD_BA_TOL, MD_BA_POINTS_TOL)
    for name, ref in (("pose_ba", ref_ba), ("pose_ba_loop", ref_ba16)):
        rep = {k: int(out[name][k]) for k in ("fb", "window", "global_lm",
                                              "dropped_obs")}
        phase("multi-device", f"21a {name}: {rep}")
        md_check_ba(f"21a pose-sharded BA ({name}) vs bundle_adjust",
                    out[name], ref,
                    MD_POSE_TOL, MD_POSE_POINTS_TOL)
    pipe = out["pipeline"]
    exact = all(torch.equal(pipe[k], v.cpu()) for k, v in (
        ("t", ref_slam.t), ("q", ref_slam.q), ("stats.n_li",
                                               ref_slam.stats.n_li)))
    seconds = res_a["records"]["pipeline"]["seconds"]
    if exact:
        note = "t, q and n_li equal to run_slam's to the bit"
    else:
        chunks = [(0, 1)] + [(lo, min(lo + MD_CHUNK, MD_FRAMES))
                             for lo in range(1, MD_FRAMES, MD_CHUNK)]
        parts = [sift_features([x[lo:hi] for x in frames])
                 for lo, hi in chunks]
        chunked = Features(*(torch.cat(f) for f in zip(*parts)))
        field = md_first_difference(chunked, feats)
        dt = float((pipe["t"] - ref_slam.t.cpu()).abs().max())
        dq = float((pipe["q"] - ref_slam.q.cpu()).abs().max())
        note = (f"not bit-equal (first differing feature field of the "
                f"chunked extraction: {field}); max |Δt| {dt:.3e}, max |Δq| "
                f"{dq:.3e} (tolerance {MD_PIPE_TOL})")
        if field is None or dt > MD_PIPE_TOL or dq > MD_PIPE_TOL or not (
            torch.equal(pipe["stats.n_li"], ref_slam.stats.n_li.cpu())
        ):
            raise AssertionError(f"21a pipeline: {note}")
    phase("multi-device", f"21a run_slam_pipelined, SIFT, {MD_FRAMES} frames, "
          f"chunks of {MD_CHUNK}: {note}; wall {seconds:.2f} s (in the "
          f"rank), serial frontend + backend here {t_fe:.2f} + {t_be:.2f} = "
          f"{t_fe + t_be:.2f} s")
    for name, rec in res_a["records"].items():
        if rec["comm"] and not any(k.endswith("/nccl") for k in rec["comm"]):
            raise AssertionError(f"21a {name}: no collective went over NCCL")
    graphed = {"21a " + name: md_graphs(
        "21a", [res_a], name, BA_ITERS,
        MD_GRAPH_LAUNCHES if name == "ba" else None)
        for name in ("ba", "pose_ba", "pose_ba_loop")}

    # ---- 21b: two ranks on cuda:0 over gloo ----
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry, _ = dryrun.make_pose_ba_problem(2, np.random.default_rng(0))
    dry_case = {"name": "pose_dry", "kind": "pose_ba",
                "mesh": {"axis": "blk"},
                "args": {"problem": md_cpu(dry), "iters": MD_DRY_ITERS,
                         "cg_iters": MD_DRY_CG}}
    res_b = dryrun.run(2, backend="gloo", device="cuda",
                       cases=[ransac_case,
                              *md_family(ba_case, MD_PROFILE["ba"]),
                              ba64_case,
                              *md_family(dry_case, MD_PROFILE["pose_dry"])],
                       timeout=MD_TIMEOUT)
    phase("multi-device", f"21b: 2 ranks, gloo, "
          f"{[r['device'] for r in res_b]}: "
          f"{time.perf_counter() - t0:.1f} s with the spawn; every output "
          f"equal to the bit across the ranks")
    for r in res_b:
        if not r["device"].startswith("cuda"):
            raise AssertionError(f"21b rank {r['rank']} ran on {r['device']}")
    for name, rec in res_b[0]["records"].items():
        phase("multi-device", "21b rank 0 " + md_describe(name, rec))
    for r in res_b:
        md_check_launches(f"21b rank {r['rank']}", r["records"])
    got = res_b[0]["outputs"]
    same = all(torch.equal(got["ransac"][f], out["ransac"][f])
               for f in out["ransac"])
    dt = float((got["ransac"]["t"] - out["ransac"]["t"]).abs().max())
    phase("multi-device", f"21b sharded RANSAC ({MD_RANSAC_BATCH // 2} per "
          f"rank): equal to 21a's to the bit {same}, max |Δt| {dt:.3e}")
    if dt > 1e-5 or not torch.equal(got["ransac"]["inliers"],
                                    out["ransac"]["inliers"]):
        raise AssertionError("21b sharded RANSAC disagrees with 21a")
    md_check_ba("21b landmark-sharded BA vs 21a", got["ba"],
                type(ref_ba)(**out["ba"]), MD_RANKS_TOL, MD_RANKS_POINTS_TOL)
    md_check_ba("21b landmark-sharded BA vs 21a in f64", got["ba64"],
                type(ref_ba)(**out["ba64"]), MD_RANKS_F64_TOL,
                MD_RANKS_F64_TOL)
    f32_err = [max(float((o["ba"][k].double() - o["ba64"][k]).abs().max())
                   for k in ("kf_t", "points")) for o in (out, got)]
    phase("multi-device", f"21a/21b f32 landmark-sharded BA vs the same in "
          f"f64: max |Δ| {f32_err[0]:.3e} m at one rank, {f32_err[1]:.3e} m "
          f"at two")
    graphed["21b ba"] = md_graphs("21b", res_b, "ba", BA_ITERS)
    graphed["21b pose_dry"] = md_graphs("21b", res_b, "pose_dry",
                                        MD_DRY_ITERS)
    k_a = (sum(r["k1"] for r in res_a["records"].values()),
           sum(r["k2"] for r in res_a["records"].values()))
    k_b = [(sum(r["k1"] for r in x["records"].values()),
            sum(r["k2"] for r in x["records"].values())) for x in res_b]
    return k_a, k_b, graphed


def batch_kernels():
    """Phase 22a: the batched launches of K1 at (BATCH_SEQS, 512, 288)
    and K2 at BATCH_SEQS × 288²×128 (VO) and × 256×288×128 (map), each
    sequence its own problem: equal to the bit to BATCH_SEQS single
    launches; through torch.func.vmap of the wrapper one launch, equal to
    the direct batched one; against the vmapped plain version within
    phase 3's tolerances. Times: the batched launch, the BATCH_SEQS
    single launches, plain and (K2) torch.bmm f32, all by graph replay;
    the vmapped wrapper's host time; the empty kernel at the batched
    configuration; bounds BATCH_SEQS times the single ones."""
    from pre3_tpu_torch.ops import matching, ransac_score
    from pre3_tpu_torch.ops.matching import (
        BIG, Matches, _best_two, _launch_k2, _pairwise_dist2,
        match_descriptors, match_descriptors_k2,
    )
    from pre3_tpu_torch.ops.ransac_score import (
        _launch, score_hypotheses, score_hypotheses_torch,
    )

    n_seq = BATCH_SEQS
    vmap = torch.func.vmap
    times, errs = {}, {}

    def timing(key, batched, singles, plain, library, wrapper, floor, bound):
        t = dict(device_ms=device_ms(batched), singles_ms=device_ms(singles),
                 plain_ms=device_ms(plain),
                 library_ms=None if library is None else device_ms(library),
                 wrapper_ms=wrapper_ms(wrapper, calls=50),
                 launch_floor_ms=device_ms(floor))
        t["bound_ms"], t["bound_by"] = bound
        times[key] = t
        lib = "none" if library is None else f"{t['library_ms']:.5f}"
        phase("batch", f"{key}: batched device {t['device_ms']:.5f} ms "
              f"(empty-kernel floor {t['launch_floor_ms']:.5f}), "
              f"{n_seq} single launches {t['singles_ms']:.5f}, plain "
              f"{t['plain_ms']:.5f}, library {lib}, vmapped wrapper (host) "
              f"{t['wrapper_ms']:.5f}; bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}), {t['bound_ms'] / t['device_ms']:.2%} of it")

    # K1
    b, n = 512, SIFT_KF
    probs = [scorer_problem(b, n, 30 + q) for q in range(n_seq)]
    args = [torch.stack(x).contiguous() for x in zip(*probs)]
    sup_b, err_b = _launch(*args)
    for q, prob in enumerate(probs):
        sup_1, err_1 = _launch(*prob)
        if not (torch.equal(sup_b[q], sup_1) and torch.equal(err_b[q], err_1)):
            raise AssertionError(f"batched K1: sequence {q} differs from its "
                                 "single launch")
    before = score_hypotheses.launches
    sup_v, err_v = vmap(score_hypotheses)(*args)
    if score_hypotheses.launches != before + 1 or not (
        torch.equal(sup_v, sup_b) and torch.equal(err_v, err_b)
    ):
        raise AssertionError("K1 under vmap: not one batched launch equal "
                             "to the direct one")
    sup_p, err_p = vmap(score_hypotheses_torch)(*args)
    errs["k1"] = max(k1_compare(
        "batch", f"batched {n_seq}x{b}x{n} sequence {q}",
        [x[q] for x in args], (sup_b[q], err_b[q]), (sup_p[q], err_p[q]))
        for q in range(n_seq))
    phase("batch", f"K1 batched ({n_seq}, {b}, {n}): bitwise equal to "
          f"{n_seq} single launches; vmap of the wrapper: one launch, equal")
    timing(f"K1 {n_seq}x{b}x{n}", lambda: _launch(*args),
           lambda: [_launch(*prob) for prob in probs],
           lambda: vmap(score_hypotheses_torch)(*args), None,
           lambda: vmap(score_hypotheses)(*args),
           floor_fn(ransac_score.K1.lib().ransac_score_floor_launch,
                    n_seq, b), k1_bound(b, n, n_seq))

    # K2
    errs["k2"] = 0.0
    for name, n1, n2, d in (("vo", SIFT_KF, SIFT_KF, 128),
                            ("map", SIFT_LANDMARKS, SIFT_KF, 128)):
        probs = [matcher_problem(n1, n2, d, 40 + q) for q in range(n_seq)]
        d1, d2, v1, v2 = (torch.stack(x).contiguous() for x in zip(*probs))
        got = _launch_k2(d1, d2, v2)
        for q in range(n_seq):
            one = _launch_k2(d1[q], d2[q], v2[q])
            if not all(torch.equal(a[q], c) for a, c in zip(got, one)):
                raise AssertionError(f"batched K2 {name}: sequence {q} "
                                     "differs from its single launch")
        before = match_descriptors_k2.launches
        k = vmap(lambda a, c, e, f: match_descriptors_k2(
            a, c, e, f, ratio=1.3))(d1, d2, v1, v2)
        if match_descriptors_k2.launches != before + 1 or not all(
            torch.equal(a, c) for a, c in zip(k[:3], got)
        ):
            raise AssertionError(f"K2 {name} under vmap: not one batched "
                                 "launch equal to the direct one")
        p = vmap(lambda a, c, e, f: match_descriptors(
            a, c, e, f, ratio=1.3))(d1, d2, v1, v2)
        for q in range(n_seq):
            errs["k2"] = max(errs["k2"], k2_compare(
                f"batched {name} {n_seq}x{n1}x{n2}x{d} sequence {q}",
                Matches(*(x[q] for x in k)), Matches(*(x[q] for x in p)),
                d1[q], d2[q], where="batch"))
        phase("batch", f"K2 batched {name} {n_seq}x{n1}x{n2}x{d}: bitwise "
              f"equal to {n_seq} single launches; vmap of the wrapper: one "
              "launch, equal")
        timing(f"K2 {name} {n_seq}x{n1}x{n2}x{d}",
               lambda: _launch_k2(d1, d2, v2),
               lambda: [_launch_k2(d1[q], d2[q], v2[q])
                        for q in range(n_seq)],
               lambda: _best_two(torch.where(
                   v2[:, None, :], _pairwise_dist2(d1, d2), BIG)),
               lambda: torch.bmm(d1, d2.transpose(1, 2)),
               lambda: vmap(lambda a, c, e, f: match_descriptors_k2(
                   a, c, e, f, ratio=1.3))(d1, d2, v1, v2),
               floor_fn(matching.K2.lib().match_stream_floor_launch,
                        n_seq, n1, n2, d), k2_bound(n1, n2, d, n_seq))
    return errs, times


def batch_parity(host):
    """Phase 22b: BATCH_PARITY_SEQS of the corridors over their first
    BATCH_PARITY_FRAMES frames through run_slam_batched, each sequence
    against run_slam on its own features with the same generator seed:
    every stat equal, t within BATCH_PARITY_TOL."""
    from pre3_tpu_torch.ekf.slam import run_slam
    from pre3_tpu_torch.frontend.pipeline import Features
    from pre3_tpu_torch.geometry.camera import sr4000_camera
    from pre3_tpu_torch.utils import measure_batch

    n_seq, n = BATCH_PARITY_SEQS, BATCH_PARITY_FRAMES
    images = [torch.as_tensor(x[:n_seq, :n], device="cuda") for x in host]
    out, feats, _, t_slam = measure_batch.pipeline(images, SIFT_LANDMARKS,
                                                   seed=5)
    gens = measure_batch.generators(n_seq, 5, "cuda")
    gaps = []
    for q in range(n_seq):
        one = run_slam(sr4000_camera(), Features(*(x[q] for x in feats)),
                       measure_batch.CFG, n_landmarks=SIFT_LANDMARKS,
                       generator=gens[q])
        for name in one.stats._fields:
            a, c = getattr(out.stats, name)[q], getattr(one.stats, name)
            if not torch.equal(a, c):
                step = int(torch.nonzero(a != c)[0, 0])
                raise AssertionError(
                    f"batch parity: sequence {q}, {name} first differs at "
                    f"step {step + 1}: batched {a.tolist()}, single "
                    f"{c.tolist()}; max |Δt| before it "
                    f"{float((out.t[q, :step + 1] - one.t[:step + 1]).abs().max()):.3e} m")
        gaps.append((float((out.t[q] - one.t).abs().max()),
                     float((out.q[q] - one.q).abs().max())))
    phase("batch", f"22b: {n_seq} sequences x {n} frames, K="
          f"{SIFT_LANDMARKS} (run_slam_batched {t_slam:.2f} s): every stat "
          f"equal to its single run_slam; max |Δt| per sequence "
          f"{[f'{g[0]:.3e}' for g in gaps]} m, max |Δq| "
          f"{[f'{g[1]:.3e}' for g in gaps]} (bound {BATCH_PARITY_TOL} m)")
    if max(g[0] for g in gaps) > BATCH_PARITY_TOL:
        raise AssertionError("batch parity: t outside the bound")


def batch_sweep(host, gts):
    """Phase 22c: S ∈ BATCH_SIZES over BATCH_FRAMES frames, one timed run
    each with host syncs raising (measure_batch.measure: frontend over
    the S·F frames, run_slam_batched with vmap's fallback off), then a
    profiled step. K1 = 1 and K2 = 2 launches per batched step at every
    S; each S's ATE in its band. Returns the largest S's (K1, K2)
    launches."""
    from pre3_tpu_torch.utils import measure_batch

    res = None
    for n_seq in BATCH_SIZES:
        images = [torch.as_tensor(x[:n_seq], device="cuda") for x in host]
        res = measure_batch.measure(images, gts[:n_seq], SIFT_LANDMARKS,
                                    reps=1, sync_check=True, warmup=True)
        phase("batch", "22c " + measure_batch.describe(res))
        steps = BATCH_FRAMES - 1
        if (res["k1"], res["k2"]) != (steps, 2 * steps):
            raise AssertionError(f"batch S={n_seq}: K1 {res['k1']}, K2 "
                                 f"{res['k2']} launches over {steps} steps")
        t = res["trajectory"].t
        if t.shape != (n_seq, BATCH_FRAMES, 3) or not bool(
            torch.isfinite(t).all()
        ):
            raise AssertionError(f"batch S={n_seq}: trajectory {t.shape}")
        phase("batch", f"22c S={n_seq} ATE per sequence "
              f"{[round(a, 4) for a in res['ates']]} m")
        for q, ate in enumerate(res["ates"]):
            ref = BATCH_ATE_MEANS[q]
            if abs(ate - ref) > BATCH_ATE_REL * ref:
                raise AssertionError(
                    f"batch S={n_seq}: sequence {q} ATE {ate:.4f} m outside "
                    f"{ref} ± {BATCH_ATE_REL * ref:.4f}")
    return res["k1"], res["k2"]


def batch_phase():
    """Phase 22: the multi-sequence path (22a, 22b, 22c)."""
    from pre3_tpu_torch.utils import measure_batch

    t0 = time.perf_counter()
    errs, times = batch_kernels()
    t1 = time.perf_counter()
    host, gts = measure_batch.render_batch(BATCH_FRAMES, max(BATCH_SIZES))
    t2 = time.perf_counter()
    batch_parity(host)
    t3 = time.perf_counter()
    launches = batch_sweep(host, gts)
    phase("batch", f"22a {t1 - t0:.1f} s, rendering {t2 - t1:.1f} s, 22b "
          f"{t3 - t2:.1f} s, 22c {time.perf_counter() - t3:.1f} s")
    return errs, times, launches


@contextlib.contextmanager
def sift_branch(value: str | None):
    """PRE3_SIFT_FAST_MATH set to ``value`` (None: unset) inside, put
    back as it was found on the way out."""
    prior = os.environ.get("PRE3_SIFT_FAST_MATH")
    try:
        if value is None:
            os.environ.pop("PRE3_SIFT_FAST_MATH", None)
        else:
            os.environ["PRE3_SIFT_FAST_MATH"] = value
        yield
    finally:
        if prior is None:
            os.environ.pop("PRE3_SIFT_FAST_MATH", None)
        else:
            os.environ["PRE3_SIFT_FAST_MATH"] = prior


def fast_parity(images):
    """23a: FAST_FRAMES corridor frames from each of FAST_WINDOWS through
    extract_features_sift with the fast branch on the card and on the
    CPU (keypoints as sets, descriptors within FAST_DESC_TOL, median
    within FAST_DESC_MEDIAN), then the card's fast branch against its
    exact one. Every window is read before any is judged."""
    rows, failed = [], []
    for start in FAST_WINDOWS:
        host = [a[start:start + FAST_FRAMES] for a in images]
        with sift_branch("1"):
            gpu = sift_features([torch.as_tensor(a, device="cuda")
                                 for a in host])
            cpu = sift_features([torch.as_tensor(a) for a in host])
        with sift_branch("0"):
            exact = sift_features([torch.as_tensor(a, device="cuda")
                                   for a in host])
        share, gaps, errs = keypoint_matches(cpu, gpu)
        top, med = float(errs.max()), float(errs.median())
        rows.append(top)
        phase("fast-sift", f"23a frames {start}–{start + FAST_FRAMES - 1}, "
              f"fast branch: valid keypoints CPU {int(cpu.valid.sum())}, "
              f"card {int(gpu.valid.sum())}; {share:.2%} of the CPU's found "
              f"on the card (largest uv gap {float(gaps.max()):.2e} px); "
              f"descriptor error per match max {top:.2e} (tolerance "
              f"{FAST_DESC_TOL}), median {med:.2e} (tolerance "
              f"{FAST_DESC_MEDIAN}), {float((errs > 1e-5).float().mean()):.2%}"
              " above 1e-5")
        if share < SIFT_MIN_MATCHED or top > FAST_DESC_TOL or (
            med > FAST_DESC_MEDIAN
        ):
            failed.append(f"frames {start}+: card and CPU disagree")
        counts, overlaps, cosines = [], [], []
        for f in range(FAST_FRAMES):
            uv_e = exact.uv[f][exact.valid[f]].cpu()
            uv_f = gpu.uv[f][gpu.valid[f]].cpu()
            counts.append(len(uv_f) / max(len(uv_e), 1))
            d = torch.linalg.vector_norm(uv_e[:, None] - uv_f[None], dim=-1)
            dmin, j = d.min(dim=1)
            overlaps.append(float((dmin < 1.0).float().mean()))
            pairs = dmin < 0.25
            de = exact.desc[f][exact.valid[f]].cpu()[pairs]
            df = gpu.desc[f][gpu.valid[f]].cpu()[j[pairs]]
            cos = (de * df).sum(-1) / torch.clamp(
                torch.linalg.vector_norm(de, dim=-1)
                * torch.linalg.vector_norm(df, dim=-1), min=1e-9)
            cosines.append((int(pairs.sum()), float(cos.median())))
        phase("fast-sift", f"23a frames {start}+, card fast vs exact per "
              f"frame: keypoint count ratio min {min(counts):.3f}, overlap "
              f"within 1 px min {min(overlaps):.3f}, co-located pairs and "
              f"median cosine min {min(n for n, _ in cosines)}, "
              f"{min(c for _, c in cosines):.7f}")
        if min(counts) < 0.8 or min(overlaps) <= 0.8 or any(
            n < 10 or c <= 0.99 for n, c in cosines
        ):
            failed.append(f"frames {start}+: fast too far from exact")
    phase("fast-sift", f"23a card vs CPU, largest descriptor error per "
          f"window {['%.2e' % e for e in rows]} (tolerance {FAST_DESC_TOL})")
    if failed:
        raise AssertionError(f"23a: {failed}")


def fast_timing(im):
    """23b: device time of extract_features_sift over one FAST_CHUNK-frame
    chunk per branch, its program's body run eagerly (``graphs.eager()``:
    a replay runs no Python, so no profiler range), from the profiler as
    profile_slice reads it, in turns exact, fast, fast, exact after a
    warm-up of each; within the same profiled run, the band filters'
    device time (every kernel that a _tri_sepconv call launches, each
    call inside a profiler range) and the bf16 GEMMs. Returns {branch:
    [ms per frame, ...]}."""
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)

    from pre3_tpu_torch.frontend import sift
    from pre3_tpu_torch.utils import graphs
    from pre3_tpu_torch.utils.profile_slice import LAUNCHES

    inner = sift._tri_sepconv

    def ranged(*args, **kwargs):
        with record_function(BAND_RANGE):
            return inner(*args, **kwargs)

    chunk = [x[:FAST_CHUNK] for x in im]
    # each level's two products, [H, H] × [H, W·8] and [.., W] × [W, W]
    n, h, w = chunk[0].shape
    flops = BAND_LEVELS * sum(
        2.0 * n * sift.NBO * ho * wo * (ho + wo)
        for ho, wo in ((-(-h // 2**o), -(-w // 2**o))
                       for o in range(BAND_OCTAVES)))
    for value in ("0", "1"):
        with sift_branch(value), graphs.eager():
            sift_features(chunk)
    torch.cuda.synchronize()
    ms, gemms = {"exact": [], "fast": []}, {"exact": [], "fast": []}
    band = {"exact": [], "fast": []}
    for name in ("exact", "fast", "fast", "exact"):
        sift._tri_sepconv = ranged
        try:
            with sift_branch("1" if name == "fast" else "0"), graphs.eager(
            ), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
            ) as prof:
                sift_features(chunk)
                torch.cuda.synchronize()
        finally:
            sift._tri_sepconv = inner
        avgs = prof.key_averages()
        kernels = [a for a in avgs if a.device_type == DeviceType.CUDA
                   and a.key != BAND_RANGE]
        launches = sum(a.count for a in avgs if a.key in LAUNCHES)
        busy_us = sum(a.self_device_time_total for a in kernels)
        band_us = sum(e.device_time_total for e in prof.events()
                      if e.name == BAND_RANGE
                      and e.device_type == DeviceType.CPU)
        bf16 = {a.key: (a.count, a.self_device_time_total) for a in kernels
                if "bf16" in a.key or "nvjet_t" in a.key}
        ms[name].append(busy_us / 1e3 / FAST_CHUNK)
        band[name].append(band_us / 1e3)
        gemms[name].append(sum(n for n, _ in bf16.values()))
        phase("fast-sift", f"23b {name}: device busy {ms[name][-1]:.4f} ms "
              f"per frame over {FAST_CHUNK} frames, {launches} launches; "
              f"band filters {band[name][-1]:.4f} ms per chunk "
              f"({band_us / busy_us:.1%} of the device time); bf16 GEMM "
              f"kernels {gemms[name][-1]}, "
              f"{sum(t for _, t in bf16.values()) / 1e3:.4f} ms "
              + (str(sorted((k[:40], n) for k, (n, _) in bf16.items()))
                 if bf16 else ""))
    phase("fast-sift", f"23b device ms per frame: exact {ms['exact']}, fast "
          f"{ms['fast']}; fast / exact "
          f"{sum(ms['fast']) / sum(ms['exact']):.3f}; band filters ms per "
          f"chunk: exact {band['exact']}, fast {band['fast']}; bound "
          f"{flops / H100_F32_FLOPS * 1e3:.4f} (f32) and "
          f"{flops / H100_BF16_FLOPS * 1e3:.4f} ms (bf16), "
          f"{flops / 1e9:.1f} GFLOP, operations")
    if any(gemms["exact"]) or any(g < FAST_GEMMS for g in gemms["fast"]):
        raise AssertionError(f"bf16 GEMMs per chunk: {gemms} (expected 0 "
                             f"exact, at least {FAST_GEMMS} fast)")
    if not all(0.0 < b < m * FAST_CHUNK for k in ms
               for b, m in zip(band[k], ms[k])):
        raise AssertionError(f"band filters' device time {band} outside "
                             f"(0, the frontend's {ms})")
    return ms


def fast_slam():
    """23c: corridor 0 of phase 22's recipe, 32 frames, through the fast
    frontend and run_slam at K=SIFT_LANDMARKS: K1 and K2 launches as the
    exact branch's, ATE in the JAX fast branch's band. Returns (K1, K2)."""
    from pre3_tpu_torch.ekf.slam import run_slam
    from pre3_tpu_torch.eval.trajectory import ate_rmse
    from pre3_tpu_torch.geometry.camera import sr4000_camera
    from pre3_tpu_torch.utils import measure_batch

    host, gts = measure_batch.render_batch(BATCH_FRAMES, 1)
    steps = BATCH_FRAMES - 1
    with sift_branch("1"):
        feats = sift_features([torch.as_tensor(x[0], device="cuda")
                               for x in host])
    reset_launches()
    out = run_slam(sr4000_camera(), feats, measure_batch.CFG,
                   n_landmarks=SIFT_LANDMARKS,
                   generator=torch.Generator("cuda").manual_seed(SIFT_SEED))
    k1, k2 = read_launches()
    t = out.t.cpu().numpy()
    ate = ate_rmse(t, gts[0], align=False)
    half = BATCH_ATE_REL * FAST_ATE_MEAN
    phase("fast-sift", f"23c corridor 0, {BATCH_FRAMES} frames, fast "
          f"branch, K={SIFT_LANDMARKS}: K1 {k1}, K2 {k2} launches, ATE "
          f"{ate:.4f} m (band {FAST_ATE_MEAN} ± {half:.4f})")
    if (k1, k2) != (steps, 2 * steps):
        raise AssertionError(f"fast run_slam: K1 {k1}, K2 {k2} launches "
                             f"over {steps} steps")
    if not np.isfinite(t).all() or abs(ate - FAST_ATE_MEAN) > half:
        raise AssertionError(f"fast run_slam: ATE {ate:.4f} m out of band")
    return k1, k2


def walkthrough(work: Path):
    """23d: examples/run_synthetic_slam.main on the card at WALK_FRAMES
    frames, the branch the caller set: every stage runs, the BA cost
    falls, the PLY holds one vertex per landmark of the BA problem, the
    ATEs under WALK_ATE_MAX. Returns each stage's (K1, K2) launches."""
    from pre3_tpu_torch.examples import run_synthetic_slam as ex

    stages = {"extract_features_sift": "frontend", "run_sequence": "vo",
              "run_slam": "slam", "select_keyframes": "keyframes",
              "ba_problem_from_slam": "ba-problem",
              "bundle_adjust": "ba", "apply_ba_corrections": "smoothing"}
    originals = {name: getattr(ex, name) for name in stages}
    launches, landmarks = {}, []

    def counted(name):
        def run(*args, **kwargs):
            reset_launches()
            out = originals[name](*args, **kwargs)
            launches[stages[name]] = read_launches()
            if name == "ba_problem_from_slam":
                landmarks.append(out.points.shape[0])
            return out
        return run

    for name in stages:
        setattr(ex, name, counted(name))
    try:
        res = ex.main(str(work), n_frames=WALK_FRAMES, device="cuda")
    finally:
        for name, fn in originals.items():
            setattr(ex, name, fn)
    header = (work / "ba_map.ply").read_text().split("end_header")[0]
    vertices = int(header.split("element vertex")[1].split()[0])
    cost = res["cost"]
    steps = WALK_FRAMES - 1
    phase("fast-sift", f"23d walkthrough, {WALK_FRAMES} frames: ATE VO "
          f"{res['ate_vo']:.4f}, SLAM {res['ate_slam']:.4f} (RPE "
          f"{res['rpe_slam']:.4f}), smoothed {res['ate_smoothed']:.4f} m; "
          f"keyframes {res['keyframes']}, BA cost {cost[0]:.4f} -> "
          f"{cost[-1]:.4f}, PLY vertices {vertices} for {landmarks} BA "
          f"landmarks; files {[Path(f).name for f in res['files']]}; K1/K2 "
          f"per stage {launches}; seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in res["seconds"].items()))
    want = {"vo": (steps, steps), "slam": (steps, 2 * steps)}
    if set(launches) != set(stages.values()) or any(
        launches[k] != want.get(k, (0, 0)) for k in launches
    ):
        raise AssertionError(f"walkthrough: launches per stage {launches}")
    if not cost[-1] < cost[0] or landmarks != [vertices] or vertices < 1:
        raise AssertionError("walkthrough: BA cost or map export wrong")
    if not all(res[k] < WALK_ATE_MAX for k in ("ate_vo", "ate_slam",
                                                 "ate_smoothed")):
        raise AssertionError("walkthrough: ATE above the sanity bound")
    return launches


def fast_sift_phase(images, im, work: Path):
    """Phase 23: 23a–23c with the fast branch (each switch inside
    sift_branch, which puts PRE3_SIFT_FAST_MATH back as it was found,
    whatever fails), then 23d, the walkthrough, with the variable as the
    caller left it (unset: the exact branch)."""
    t0 = time.perf_counter()
    fast_parity(images)
    t1 = time.perf_counter()
    ms = fast_timing(im)
    t2 = time.perf_counter()
    slam_launches = fast_slam()
    t3 = time.perf_counter()
    walk = walkthrough(work)
    phase("fast-sift", f"23a {t1 - t0:.1f} s, 23b {t2 - t1:.1f} s, 23c "
          f"{t3 - t2:.1f} s, 23d {time.perf_counter() - t3:.1f} s")
    return ms, slam_launches, walk


# ---------------------------------------------------------------------------
# Phase 24 (graphs): every driver of the main path replays one captured
# CUDA graph per step (utils/graphs.py); each is held against the eager
# loop of the same step on the card.
# ---------------------------------------------------------------------------

GRAPH_FRAMES = 32
GRAPH_SEED = 11
GRAPH_BATCH_SEQS = 4
GRAPH_ONLINE_LANDMARKS = 64
GRAPH_CHUNK = 8
GRAPH_RESUME_AT = 16  # snapshot after this many steps
GRAPH_PROFILED_FRAMES = 8  # OnlineSlam.process calls in its profiled window
# Host-issued launches (kernels, graph launches, copies, memsets) per
# step, counted by the profiler over a driver's steps: run_slam and the
# VO pair at most GRAPH_LAUNCHES_RUN_SLAM, the batched step that plus one
# per sequence, OnlineSlam's frame GRAPH_LAUNCHES_FRAME.
GRAPH_LAUNCHES_RUN_SLAM = 10
GRAPH_LAUNCHES_FRAME = 20
# The graphed run_slam's peak memory at these frame counts (K=256): its
# growth per frame above the first stays under GRAPH_PEAK_GROWTH_MB.
GRAPH_MEMORY_FRAMES = (32, 256)
GRAPH_PEAK_GROWTH_MB = 0.25
# The eager loop of slam_step (the port's run_slam before this phase's
# programs) at these frame counts, and the frontend alone, to show where
# the old growth per frame came from.
EAGER_MEMORY_FRAMES = (16, 48)
K1_KERNEL, K2_KERNEL = "ransac_score_kernel", "match_stream_kernel"


def tree_gap(a, b) -> tuple[bool, float]:
    """(every leaf bit-equal, the largest |a − b| over the leaves)."""
    from torch.utils._pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False, float("inf")
    equal = all(x.shape == y.shape and torch.equal(x, y)
                for x, y in zip(la, lb))
    gap = max((float((x.double() - y.double()).abs().max())
               for x, y in zip(la, lb) if x.numel() and x.shape == y.shape),
              default=0.0)
    return equal, gap


def eager_run_slam(cam, feats, cfg, k, generator=None, images=None,
                   xyz_imgs=None):
    """run_slam as a plain Python loop of slam_step after the bootstrap's
    body (run under ``graphs.eager()``), each step's outputs kept in lists
    and stacked at the end (the port's run_slam before step programs):
    what phase 24 holds the replays to."""
    from pre3_tpu_torch.ekf.slam import (
        SlamTrajectory, StepRecord, StepStats, _frame, bootstrap_state,
        slam_step,
    )
    from pre3_tpu_torch.utils import graphs

    n = feats.uv.shape[0]
    pick = lambda x, i: None if x is None else x[i]  # noqa: E731
    with graphs.eager():
        state = bootstrap_state(cam, _frame(feats, 0), cfg, k,
                                xyz_img=pick(xyz_imgs, 0),
                                image=pick(images, 0), generator=generator)
    q0 = state.x[3:7]
    steps = torch.arange(1, n, dtype=torch.int32, device=feats.uv.device)
    ts, qs, stats, recs = [], [], [], []
    for i in range(1, n):
        state, (st, rec) = slam_step(
            cam, state, _frame(feats, i), _frame(feats, i - 1), steps[i - 1],
            cfg, generator=generator, image=pick(images, i),
            xyz_img=pick(xyz_imgs, i), host_step=i)
        ts.append(state.x[0:3])
        qs.append(state.x[3:7])
        stats.append(st)
        recs.append(rec)
    stack = lambda rows, cls: cls(*map(torch.stack, zip(*rows)))  # noqa: E731
    return SlamTrajectory(
        t=torch.cat([torch.zeros_like(ts[0])[None], torch.stack(ts)]),
        q=torch.cat([q0[None], torch.stack(qs)]),
        stats=stack(stats, StepStats), records=stack(recs, StepRecord)), (
        ts, qs, stats, recs)


def eager_run_sequence(feats, generator):
    """VO's run_sequence as a plain loop of vo_pair."""
    from pre3_tpu_torch.frontend.pipeline import Features
    from pre3_tpu_torch.geometry.quaternion import qnormalize, qprod, qrotate
    from pre3_tpu_torch.vo.dead_reckoning import Trajectory, vo_pair

    n = feats.uv.shape[0]
    dev = feats.uv.device
    t_w = torch.zeros(3, device=dev)
    q_w = torch.zeros(4, device=dev)
    q_w[0].fill_(1.0)
    unit = q_w
    ts, qs = [t_w], [q_w]
    oks = [torch.ones((), dtype=torch.bool, device=dev)]
    nis = [torch.zeros((), dtype=torch.int32, device=dev)]
    for i in range(1, n):
        s = vo_pair(Features(*(x[i - 1] for x in feats)),
                    Features(*(x[i] for x in feats)), generator=generator,
                    batch=BATCH)
        dt = torch.where(s.ok, s.delta.t, torch.zeros_like(t_w))
        dq = torch.where(s.ok, s.delta.q, unit)
        t_w = t_w + qrotate(q_w, dt)
        q_w = qnormalize(qprod(q_w, dq))
        ts.append(t_w)
        qs.append(q_w)
        oks.append(s.ok)
        nis.append(s.n_inliers)
    return Trajectory(*map(torch.stack, (ts, qs, oks, nis)))


def eager_batched(cam, feats, cfg, k, gens):
    """run_slam_batched as a plain loop of draw_batched and
    slam_step_batched after the bootstraps' bodies (under
    ``graphs.eager()``)."""
    from pre3_tpu_torch.ekf.slam import (
        SlamTrajectory, StepRecord, StepStats, bootstrap_batched,
        draw_batched, slam_step_batched,
    )
    from pre3_tpu_torch.frontend.pipeline import Features
    from pre3_tpu_torch.utils import graphs

    n_seq, n = feats.uv.shape[:2]
    dev = feats.uv.device
    with graphs.eager():
        state = bootstrap_batched(cam, Features(*(x[:, 0] for x in feats)),
                                  cfg, k, generators=gens)
    q0 = state.x[:, 3:7]
    steps = torch.arange(1, n, dtype=torch.int32, device=dev)
    ts, qs, stats, recs = [], [], [], []
    for i in range(1, n):
        d = draw_batched(cfg, feats.uv.shape[2], k, gens, dev)
        state, (st, rec) = slam_step_batched(
            cam, state, Features(*(x[:, i] for x in feats)),
            Features(*(x[:, i - 1] for x in feats)), steps[i - 1], cfg, d)
        ts.append(state.x[:, 0:3])
        qs.append(state.x[:, 3:7])
        stats.append(st)
        recs.append(rec)
    stack = lambda rows, cls: cls(*(torch.stack(f, 1)  # noqa: E731
                                    for f in zip(*rows)))
    kept = (ts, qs, stats, recs)
    ts = torch.stack(ts, 1)
    return SlamTrajectory(
        t=torch.cat([torch.zeros_like(ts[:, :1]), ts], 1),
        q=torch.cat([q0[:, None], torch.stack(qs, 1)], 1),
        stats=stack(stats, StepStats), records=stack(recs, StepRecord)), kept


def new_captures(before: dict) -> list[str]:
    """The programs' graphs captured since ``before`` (id → variants), as
    'name[variant]: capture s, pool MiB'."""
    from pre3_tpu_torch.utils import graphs

    out = []
    for p in graphs.programs():
        for v, cap in p.graphs.items():
            if v not in before.get(id(p), ()):
                out.append(f"{p.name}[{v}]: capture {cap.capture_s:.2f} s, "
                           f"pool {cap.pool_bytes / 2**20:.1f} MiB")
    return out


def captured_now() -> dict:
    from pre3_tpu_torch.utils import graphs

    return {id(p): set(p.graphs) for p in graphs.programs()}


def profiled_launches(fn):
    """One profiled run of ``fn`` (``profile_slice._profiled``: one
    window, opened by a run of ``fn`` that is not kept and timed
    synchronize to synchronize): (host-issued launches,
    device busy ms, the window's wall ms, K1 and K2 records by kernel
    name, K1 and K2 runs on the kernels' device counters over the same
    run)."""
    from pre3_tpu_torch.utils.profile_slice import _profiled, device_ops

    launches, busy, wall, avgs = _profiled(fn, warm=fn,
                                           between=reset_launches)
    counted = dict(zip((K1_KERNEL, K2_KERNEL), read_launches()))
    names = {K1_KERNEL: 0, K2_KERNEL: 0}
    for a in device_ops(avgs):
        for k in names:
            if k in a.key:
                names[k] += a.count
    return launches, busy / 1e3, 1e3 * wall, names, counted


def host_seconds(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def graphed_vs_eager(name, run, eager, stepper, steps, k1_per_step,
                     k2_per_step, k3=0, k4=0, limit=GRAPH_LAUNCHES_RUN_SLAM):
    """One driver: ``run()`` graphed (its first call captures), again
    under sync checks (replays only) and against ``eager()``; K1/K2 on
    the kernels' device counters, K3's against ``k3`` (one per step
    and one per bootstrap the call runs) and K4's against ``k4`` (one per
    step that runs VO with its covariance); host ms per step of the whole call
    and of ``stepper()`` alone (the steps after the driver's
    bootstrap), medians of 3; ``stepper()`` profiled for the host-issued
    launches per step, device busy per step and the idle share of that
    same window, with K1 and K2 found by kernel name as often as their
    device counters ran them. Returns a dict of the figures."""
    before = captured_now()
    t_first = host_seconds(run)
    caps = new_captures(before)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    got = run()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    k1, k2 = read_launches()
    k3_runs, k4_runs = read_k3(), read_k4()
    t_run = statistics.median([t_run] + [host_seconds(run) for _ in range(2)])
    t_steps = statistics.median([host_seconds(stepper) for _ in range(3)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ref = eager()
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    eager_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    graphed_peak = peak_above(run)
    equal, gap = tree_gap(got, ref)
    launches, busy, wall, names, counted = profiled_launches(stepper)
    res = dict(name=name, equal=equal, gap=gap, k1=k1, k2=k2, k3=k3_runs,
               k4=k4_runs,
               launches=launches / steps, busy_ms=busy / steps,
               host_ms=1e3 * t_run / steps, steps_ms=1e3 * t_steps / steps,
               eager_host_ms=1e3 * t_eager / steps, idle=1.0 - busy / wall,
               fps=(steps + 1) / t_run, eager_fps=(steps + 1) / t_eager,
               names=names, first_s=t_first, captures=caps,
               peak_mib=graphed_peak, eager_peak_mib=eager_peak)
    phase("graphs", f"{name}: graphed vs eager bit-equal {equal} (max gap "
          f"{gap:.3e}); K1 {k1}, K2 {k2}, K3 {k3_runs} (want {k3}), K4 "
          f"{k4_runs} (want {k4}) over "
          f"{steps} steps (device counters); host {res['host_ms']:.3f} ms per step for the whole "
          f"call, {res['fps']:.2f} frames/s (eager {res['eager_host_ms']:.3f}"
          f" ms, {res['eager_fps']:.2f} frames/s), the steps alone "
          f"{res['steps_ms']:.3f} ms per step; the steps profiled: launches "
          f"per step {res['launches']:.2f}, device busy {res['busy_ms']:.4f} "
          f"ms per step, idle share {res['idle']:.4f} of that window "
          f"({wall / steps:.3f} ms per step), kernels by name {names} "
          f"against the device counters {counted}; peak memory above the "
          f"inputs {graphed_peak:.1f} MiB (eager {eager_peak:.1f}); first "
          f"call {t_first:.2f} s; " + "; ".join(caps))
    if not equal:
        raise AssertionError(f"graphs {name}: graphed and eager differ "
                             f"(max gap {gap:.3e})")
    # the device counters are exact; the profiler may drop one replay's
    # records from a window (on an H100: VO's 30 of 31 once, the
    # attitude update's once, in 29 windows), so it must find both
    # kernels by name
    want = {K1_KERNEL: k1_per_step * steps, K2_KERNEL: k2_per_step * steps}
    if (k1, k2) != tuple(want.values()) or counted != want or not all(
            names.values()) or (k3_runs, k4_runs) != (k3, k4):
        raise AssertionError(f"graphs {name}: K1 {k1}, K2 {k2}, K3 {k3_runs}"
                             f", K4 {k4_runs} over {steps} steps; profiled "
                             f"{names}, counted {counted}, want {want}, K3 "
                             f"{k3} and K4 {k4}")
    if res["launches"] > limit:
        raise AssertionError(f"graphs {name}: {res['launches']:.2f} launches "
                             f"per step (limit {limit})")
    return res


def peak_above(fn) -> float:
    """MiB the device's allocated memory peaks above where it stood."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    del out
    return peak


def retained_per_step(rows) -> tuple[float, float]:
    """(MiB of storage, MiB of data) one step's kept outputs hold: each
    distinct storage behind them counted once."""
    from torch.utils._pytree import tree_leaves

    seen, storage, data = set(), 0, 0
    for t in tree_leaves(rows):
        s = t.untyped_storage()
        data += t.nbytes
        if s.data_ptr() not in seen:
            seen.add(s.data_ptr())
            storage += s.nbytes()
    return storage / 2**20, data / 2**20


def graph_memory(feats_all, cam, images):
    """24d: the graphed run_slam's peak at GRAPH_MEMORY_FRAMES (K=256),
    first call (the program made and captured) and steady; the eager loop
    at EAGER_MEMORY_FRAMES and what one step's kept outputs hold; the
    SIFT frontend's allocated peak at GRAPH_MEMORY_FRAMES, the memory
    reserved after it (which the peak does not see: the graph pool is
    the allocator's reserve, not its allocations) and the frontend
    programs' shared pool."""
    from pre3_tpu_torch.ekf.slam import SlamConfig, run_slam
    from pre3_tpu_torch.frontend.pipeline import Features
    from pre3_tpu_torch.utils import graphs

    cfg = SlamConfig(**SIFT_CFG)
    gen = lambda: torch.Generator("cuda").manual_seed(GRAPH_SEED)  # noqa: E731
    cut = lambda n: Features(*(x[:n] for x in feats_all))  # noqa: E731
    first, steady = {}, {}
    for n in GRAPH_MEMORY_FRAMES:
        run = lambda n=n: run_slam(cam, cut(n), cfg,  # noqa: E731
                                   n_landmarks=SIFT_LANDMARKS,
                                   generator=gen())
        graphs.clear()  # the first call makes and captures the program
        first[n] = peak_above(run)
        steady[n] = peak_above(run)
    span = GRAPH_MEMORY_FRAMES[1] - GRAPH_MEMORY_FRAMES[0]
    growth = {k: (v[GRAPH_MEMORY_FRAMES[1]] - v[GRAPH_MEMORY_FRAMES[0]])
              * 2**20 / 1e6 / span for k, v in (("first", first),
                                                 ("steady", steady))}
    eager, kept = {}, None
    for n in EAGER_MEMORY_FRAMES:
        eager[n] = peak_above(lambda n=n: eager_run_slam(
            cam, cut(n), cfg, SIFT_LANDMARKS, gen()))
    _, rows = eager_run_slam(cam, cut(4), cfg, SIFT_LANDMARKS, gen())
    kept = retained_per_step([r[-1] for r in rows])
    espan = EAGER_MEMORY_FRAMES[1] - EAGER_MEMORY_FRAMES[0]
    e_growth = (eager[EAGER_MEMORY_FRAMES[1]] - eager[EAGER_MEMORY_FRAMES[0]]
                ) * 2**20 / 1e6 / espan
    fe, fe_reserved = {}, {}
    for n in GRAPH_MEMORY_FRAMES:
        im_n = [torch.as_tensor(a[:n], device="cuda") for a in images]
        fe[n] = peak_above(lambda: sift_features(im_n))
        fe_reserved[n] = torch.cuda.memory_reserved() / 2**20
        del im_n
    phase("graphs", f"24d memory, K={SIFT_LANDMARKS}: graphed run_slam peak "
          f"above its inputs, first call (program made, captured) "
          f"{ {n: round(v, 1) for n, v in first.items()} } MiB, steady "
          f"{ {n: round(v, 1) for n, v in steady.items()} } MiB at "
          f"{GRAPH_MEMORY_FRAMES} frames: {growth['first']:.4f} and "
          f"{growth['steady']:.4f} MB per frame (limit "
          f"{GRAPH_PEAK_GROWTH_MB}); eager loop "
          f"{ {n: round(v, 1) for n, v in eager.items()} } MiB at "
          f"{EAGER_MEMORY_FRAMES} frames: {e_growth:.4f} MB per frame; one "
          f"eager step's kept outputs hold {kept[0]:.4f} MiB of storage for "
          f"{kept[1]:.4f} MiB of data; the SIFT frontend's peak "
          f"{ {n: round(v, 1) for n, v in fe.items()} } MiB at "
          f"{GRAPH_MEMORY_FRAMES} frames, reserved after it "
          f"{ {n: round(v, 1) for n, v in fe_reserved.items()} } MiB; "
          + frontend_pool())
    if max(growth.values()) > GRAPH_PEAK_GROWTH_MB:
        raise AssertionError(f"graphs: run_slam's peak grows "
                             f"{growth} MB per frame")
    return dict(first=first, steady=steady, growth=growth, eager=eager,
                eager_growth=e_growth, kept=kept, frontend=fe,
                frontend_reserved=fe_reserved)


def online_graphs(images, cam):
    """24b: OnlineSlam (SIFT, K=64) frame by frame against its own
    boot_fn (under graphs.eager()) and fused_fn run eagerly;
    process_chunk against that bootstrap + frontend + the eager loop; a
    resumed and primed run against the uninterrupted one."""
    from pre3_tpu_torch.ekf.slam import SlamConfig, _frame
    from pre3_tpu_torch.runtime.online import OnlineSlam
    from pre3_tpu_torch.utils import graphs

    n, k = GRAPH_FRAMES, GRAPH_ONLINE_LANDMARKS
    cfg = SlamConfig(min_measured=50)
    host = [a[:n] for a in images]
    gen = lambda: torch.Generator("cuda").manual_seed(GRAPH_SEED)  # noqa: E731

    def online(steps=n, slam=None):
        slam = slam or OnlineSlam(cam, cfg=cfg, n_landmarks=k,
                                  extractor="sift", generator=gen())
        for i in range(slam.step_i, steps):
            slam.process(*(a[i] for a in host))
        return slam

    def eager():
        slam = OnlineSlam(cam, cfg=cfg, n_landmarks=k, extractor="sift",
                          generator=gen())
        frames = [[torch.as_tensor(a[i], device="cuda") for a in host]
                  for i in range(n)]
        with graphs.eager():
            state, step, prev, t, q = slam.boot_fn(*frames[0],
                                                   generator=slam.generator)
        rows = [(t, q)]
        for i in range(1, n):
            state, step, prev, t, q, st, _ = slam.fused_fn(
                state, step, prev, *frames[i], generator=slam.generator,
                host_step=i)
            rows.append((t, q, st))
        return rows

    slam = online()  # another instance, for "two instances equal"
    before = captured_now()
    slam2 = OnlineSlam(cam, cfg=cfg, n_landmarks=k, extractor="sift",
                       generator=gen())
    slam2.process(*(a[0] for a in host))  # the bootstrap
    reset_launches()
    first = host_seconds(lambda: slam2.process(*(a[1] for a in host)))
    caps = new_captures(before)
    ms = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.set_sync_debug_mode("error")
    t_loop = time.perf_counter()
    for i in range(2, n):
        t0 = time.perf_counter()
        slam2.process(*(a[i] for a in host))
        ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t_loop) / (n - 2)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    k1, k2 = read_launches()
    k3, k4 = read_k3(), read_k4()
    ref = eager()
    got = [(r.t, r.q) if r.stats is None else (r.t, r.q, r.stats)
           for r in slam2.results]
    equal, gap = tree_gap(got, ref)
    same, _ = tree_gap([(r.t, r.q) for r in slam.results],
                       [(r.t, r.q) for r in slam2.results])
    # a profiled window of GRAPH_PROFILED_FRAMES more frames (the last
    # ones fed again) on the same instance
    again = [[a[i] for a in host] for i in range(n - GRAPH_PROFILED_FRAMES, n)]
    launches, busy, p_wall, names, counted = profiled_launches(
        lambda: [slam2.process(*f) for f in again])
    launches /= GRAPH_PROFILED_FRAMES
    busy /= GRAPH_PROFILED_FRAMES
    idle = 1 - busy * GRAPH_PROFILED_FRAMES / p_wall
    med = statistics.median(ms)
    phase("graphs", f"OnlineSlam.process (SIFT, K={k}), {n} frames: "
          f"graphed vs its fused_fn eagerly bit-equal {equal} (max gap "
          f"{gap:.3e}), two instances equal {same}; K1 {k1}, K2 {k2}, K3 "
          f"{k3}, K4 {k4}; "
          f"process() returns in {med:.3f} ms (median, no host sync), "
          f"{wall:.3f} ms per frame over frames 2–{n - 1} with the closing "
          f"synchronize ({1e3 / wall:.1f} frames/s); {GRAPH_PROFILED_FRAMES} "
          f"frames profiled: launches per frame {launches:.2f}, device busy "
          f"{busy:.4f} ms per frame, idle share {idle:.4f} of that window "
          f"({p_wall / GRAPH_PROFILED_FRAMES:.3f} ms per frame), kernels by "
          f"name {names} against the device counters {counted}; peak memory "
          f"{peak:.1f} MiB above the state; first frame after the bootstrap "
          f"{first:.2f} s; " + "; ".join(caps))
    # frames 1..n−1: the first of them captures (its warm-up uncounted)
    if not (equal and same) or (k1, k2, k3, k4) != (
            n - 1, 2 * (n - 1), n - 1, n - 1):
        raise AssertionError("graphs: OnlineSlam.process differs from its "
                             "eager frames or from its K1/K2/K3/K4 counts")
    want = {K1_KERNEL: GRAPH_PROFILED_FRAMES,
            K2_KERNEL: 2 * GRAPH_PROFILED_FRAMES}
    if launches > GRAPH_LAUNCHES_FRAME or counted != want or not all(
            names.values()):
        raise AssertionError(f"graphs: process() issued {launches} launches "
                             f"per frame; profiled {names}, counted "
                             f"{counted}, want {want}")
    out = dict(host_ms=wall, dispatch_ms=med, launches=launches,
               busy_ms=busy, idle=idle, peak_mib=peak, captures=caps,
               fps=1e3 / wall)

    # process_chunk: bootstrap, then chunks of GRAPH_CHUNK
    def chunked():
        s = OnlineSlam(cam, cfg=cfg, n_landmarks=k, extractor="sift",
                       generator=gen())
        s.process(*(a[0] for a in host))
        for lo in range(1, n, GRAPH_CHUNK):
            s.process_chunk(*(a[lo:lo + GRAPH_CHUNK] for a in host))
        return [(r.t, r.q) for r in s.results]

    def chunked_eager():
        from pre3_tpu_torch.ekf.slam import slam_step

        s = OnlineSlam(cam, cfg=cfg, n_landmarks=k, extractor="sift",
                       generator=gen())
        frames = [torch.as_tensor(a, device="cuda") for a in host]
        with graphs.eager():
            state, step, prev, t, q = s.boot_fn(*(f[0] for f in frames),
                                                generator=s.generator)
        rows = [(t, q)]
        for lo in range(1, n, GRAPH_CHUNK):
            feats = s._extract(*(f[lo:lo + GRAPH_CHUNK] for f in frames))
            for j in range(feats.uv.shape[0]):
                cur = _frame(feats, j)
                state, _ = slam_step(cam, state, cur, prev, step + j, cfg,
                                     generator=s.generator,
                                     host_step=lo + j)
                rows.append((state.x[0:3], state.x[3:7]))
                prev = cur
            step = step + feats.uv.shape[0]
        return rows

    c_equal, c_gap = tree_gap(chunked(), chunked_eager())
    phase("graphs", f"OnlineSlam.process_chunk ({GRAPH_CHUNK} frames): "
          f"graphed vs eager bit-equal {c_equal} (max gap {c_gap:.3e})")
    if not c_equal:
        raise AssertionError("graphs: process_chunk differs from its eager "
                             "loop")

    # resume: snapshot after GRAPH_RESUME_AT steps, a new instance resumed
    # and primed, against the uninterrupted run
    with tempfile.TemporaryDirectory(prefix="pre3_graphs_") as tmp:
        a = OnlineSlam(cam, cfg=cfg, n_landmarks=k, extractor="sift",
                       generator=gen(), snapshot_dir=tmp,
                       snapshot_every=GRAPH_RESUME_AT)
        online(GRAPH_RESUME_AT, a)
        b = OnlineSlam(cam, cfg=cfg, n_landmarks=k, extractor="sift")
        b.process(*(x[0] for x in host))  # a live carry to copy into
        b.resume(f"{tmp}/snapshot_{GRAPH_RESUME_AT:05d}.npz")
        b.prime(*(x[GRAPH_RESUME_AT - 1] for x in host))
        online(n, b)
        online(n, a)
    r_equal, r_gap = tree_gap([(r.t, r.q) for r in a.results[GRAPH_RESUME_AT:]],
                              [(r.t, r.q) for r in b.results[1:]])
    s_equal, _ = tree_gap(tuple(a.state), tuple(b.state))
    phase("graphs", f"OnlineSlam resume after step {GRAPH_RESUME_AT}: poses "
          f"equal to the uninterrupted run {r_equal} (max gap {r_gap:.3e}), "
          f"final state equal {s_equal}")
    if not (r_equal and s_equal):
        raise AssertionError("graphs: the resumed run differs")
    return out


def graphs_phase(images, im):
    """Phase 24: the step programs on the card (see GRAPH_* above), on
    the 256-frame corridor of phases 5–10 (host arrays and on the card)."""
    from pre3_tpu_torch.ekf.slam import (
        SlamConfig, _frame, bootstrap_batched, bootstrap_state, run_slam,
        run_slam_batched, scan_steps, scan_steps_batched,
    )
    from pre3_tpu_torch.frontend.pipeline import Features
    from pre3_tpu_torch.geometry.camera import sr4000_camera
    from pre3_tpu_torch.utils import measure_batch
    from pre3_tpu_torch.vo.dead_reckoning import run_sequence

    cam = sr4000_camera()
    n = GRAPH_FRAMES
    steps = n - 1
    gen = lambda: torch.Generator("cuda").manual_seed(GRAPH_SEED)  # noqa: E731
    feats_sift = sift_features(im)
    im_n = [x[:n] for x in im]
    sift = Features(*(x[:n] for x in feats_sift))
    fast = features(im_n)
    floor = torch.as_tensor(np.stack([tilted_floor_xyz()] * n),
                            device="cuda")
    results = {}

    def slam_case(name, feats, cfg, k, images_=None, xyz=None, k2=2):
        run = lambda: run_slam(cam, feats, cfg, n_landmarks=k,  # noqa: E731
                               generator=gen(), images=images_,
                               xyz_imgs=xyz)
        eager = lambda: eager_run_slam(  # noqa: E731
            cam, feats, cfg, k, gen(), images_, xyz)[0]
        first = _frame(feats, 0)
        state0 = bootstrap_state(
            cam, first, cfg, k, xyz_img=None if xyz is None else xyz[0],
            image=None if images_ is None else images_[0], generator=gen())
        rest = Features(*(x[1:] for x in feats))
        idx = torch.arange(1, n, dtype=torch.int32, device="cuda")
        stepper = lambda: scan_steps(  # noqa: E731
            cam, state0, first, rest, idx, cfg, generator=gen(),
            xyz_imgs=None if xyz is None else xyz[1:], first_step=1,
            images=None if images_ is None else images_[1:])
        # K3: one per step and one for the bootstrap; K4: one per step
        # (the bootstrap runs no VO)
        results[name] = graphed_vs_eager(name, run, eager, stepper, steps, 1,
                                         k2, k3=steps + 1, k4=steps)

    slam_case("run_slam #3 (SIFT, K=256)", sift, SlamConfig(**SIFT_CFG),
              SIFT_LANDMARKS)
    slam_case("run_slam FAST EKF (K=256)", fast, SlamConfig(**EKF_CFG),
              EKF_LANDMARKS)
    slam_case("run_slam #2 NCC (K=256)", fast, SlamConfig(**NCC_CFG),
              EKF_LANDMARKS, images_=im_n[0], xyz=im_n[1], k2=1)
    slam_case("run_slam IEKF (K=256)", fast,
              SlamConfig(**EKF_CFG, est_method="iekf"), EKF_LANDMARKS)
    slam_case("run_slam attitude update every 4 (K=64, tilted floor)", fast,
              SlamConfig(**EKF_CFG, heading_update_every=4), 64, xyz=floor)
    vo_run = lambda: run_sequence(fast, generator=gen(),  # noqa: E731
                                  batch=BATCH)
    results["vo"] = graphed_vs_eager(
        "run_sequence (VO)", vo_run, lambda: eager_run_sequence(fast, gen()),
        vo_run, steps, 1, 1)
    s = GRAPH_BATCH_SEQS
    host, _ = measure_batch.render_batch(n, s)
    bfeats = measure_batch.extract_sequences(
        measure_batch.extract_features_sift,
        *(torch.as_tensor(x, device="cuda") for x in host))
    bcfg = measure_batch.CFG
    bgens = lambda: measure_batch.generators(s, GRAPH_SEED, "cuda")  # noqa: E731
    bstate = bootstrap_batched(cam, Features(*(x[:, 0] for x in bfeats)),
                               bcfg, SIFT_LANDMARKS, generators=bgens())
    results["batched"] = graphed_vs_eager(
        f"run_slam_batched (S={s}, K={SIFT_LANDMARKS})",
        lambda: run_slam_batched(cam, bfeats, bcfg, SIFT_LANDMARKS,
                                 generators=bgens()),
        lambda: eager_batched(cam, bfeats, bcfg, SIFT_LANDMARKS, bgens())[0],
        lambda: scan_steps_batched(cam, bstate, bfeats, bcfg, SIFT_LANDMARKS,
                                   generators=bgens()),
        steps, 1, 2, k3=steps + s, k4=steps,
        limit=GRAPH_LAUNCHES_RUN_SLAM + s)
    _, rows = eager_batched(cam, Features(*(x[:, :4] for x in bfeats)), bcfg,
                            SIFT_LANDMARKS, bgens())
    kept = retained_per_step([r[-1] for r in rows])
    results["batched"]["kept_mib"] = kept
    phase("graphs", f"one eager batched step (S={s}, K={SIFT_LANDMARKS}) "
          f"keeps {kept[0]:.4f} MiB of storage for {kept[1]:.4f} MiB of "
          f"data in its outputs")
    results["online"] = online_graphs(images, cam)
    results["memory"] = graph_memory(feats_sift, cam, images)
    return results


# ---------------------------------------------------------------------------
# Phase 25 (backend-graphs): config #4's programs (bundle_adjust,
# build_tracks, the loop-mining pair, find_keyframes_vo's pair) each
# replay one captured CUDA graph per step; each is held against an eager
# loop of its body on the card, on phases 15, 16 and 18's inputs.
# ---------------------------------------------------------------------------

# Host-issued launches (kernels, graph launches, copies, fills), counted
# by the profiler over one call: BA at most BACKEND_LAUNCHES_BA per LM
# iteration (the problem's loads, cost0 and the result copy included),
# the tracks at most BACKEND_LAUNCHES_STEP per keyframe, the loop pair and
# the keyframe pair at most that per pair, not counting the one copy of
# its output row to the host that reads the verdict (the reference reads
# each pair's verdict too).
BACKEND_LAUNCHES_BA = 5
BACKEND_LAUNCHES_STEP = 10


def eager_bundle_adjust(cam, prob, iters: int):
    """bundle_adjust as a plain loop of its bodies (the initial cost, then
    ``_lm_step``), the default weights and damping."""
    from pre3_tpu_torch.backend import ba

    terms = ba._terms(prob, 50.0, 20.0, 50.0, 0.0, 20.0, 50.0)
    c0 = ba._problem_cost(cam, prob, terms, prob.kf_t, prob.kf_q,
                          prob.points)
    lam = torch.full((), 1e-3, dtype=c0.dtype, device=c0.device)
    state, costs = (prob.kf_t, prob.kf_q, prob.points, lam, c0), [c0]
    for _ in range(iters):
        state = ba._lm_step(cam, prob, terms, True, *state)
        costs.append(state[4])
    return ba.BaResult(*state[:3], cost=torch.stack(costs))


def eager_build_tracks(kf_feats, kf_t, kf_q, kf_valid, max_tracks=256,
                       adds_per_frame=64, ratio=1.3, gate_px=25.0):
    """build_tracks as a plain loop of ``track_step`` (the same
    signature and result)."""
    from pre3_tpu_torch.backend import tracks
    from pre3_tpu_torch.frontend.pipeline import Features

    dev, dt = kf_feats.xyz.device, kf_feats.xyz.dtype
    table = tracks.TrackTable(
        torch.zeros((max_tracks, kf_feats.desc.shape[-1]), dtype=dt,
                    device=dev),
        torch.zeros(max_tracks, dtype=torch.bool, device=dev),
        torch.zeros((max_tracks, 3), dtype=dt, device=dev))
    rows = []
    for i in range(kf_feats.uv.shape[0]):
        table, obs = tracks.track_step(
            table, Features(*(x[i] for x in kf_feats)), kf_t[i], kf_q[i],
            kf_valid[i], adds_per_frame, ratio, gate_px)
        rows.append(obs)
    return (*map(torch.stack, zip(*rows)), table)


def eager_mine(kf_feats, kf_t, kf_valid, generator, max_tried=None):
    """mine_keyframe_loop_closures as a plain loop of ``pair_fit`` over
    pairs_to_try (the first ``max_tried`` of them, or all), reading each
    verdict: (the mined arrays, pairs tried)."""
    from pre3_tpu_torch.backend import loop_detect

    side = lambda i: (kf_feats.desc[i], kf_feats.xyz[i],  # noqa: E731
                      kf_feats.valid[i])
    rows, tried = [], 0
    for a, b in loop_detect.pairs_to_try(kf_t, kf_valid)[:max_tried]:
        if len(rows) >= MINE_MAX_PAIRS:
            break
        tried += 1
        _r, t, q, ok, _n, _e, cov = loop_detect.pair_fit(
            side(a), side(b), generator=generator)
        if bool(ok):
            rows.append((a, b, t.cpu().numpy(), q.cpu().numpy(),
                         loop_detect.sqrt_information(cov.cpu().numpy())))
    if not rows:
        return None, tried
    a, b, t, q, info = zip(*rows)
    return (np.asarray(a, np.int32), np.asarray(b, np.int32), np.stack(t),
            np.stack(q), np.ones(len(a), np.float32), np.stack(info)), tried


def eager_keyframe_search(feats, generator, batch: int):
    """find_keyframes_vo (no cache) as a plain loop of vo_pair and motion,
    reading each verdict: the same OfflineKeyframes."""
    from pre3_tpu_torch.backend import keyframes
    from pre3_tpu_torch.frontend.pipeline import Features

    rot = float(np.radians(keyframes.ROT_THRESH_DEG))
    frame = lambda i: Features(*(x[i] for x in feats))  # noqa: E731
    last, idx = 0, [0]
    dts, dqs = [np.zeros(3, np.float32)], [np.array([1.0, 0, 0, 0],
                                                    np.float32)]
    for i in range(1, feats.uv.shape[0]):
        s = keyframes.vo_pair(frame(last), frame(i), generator=generator,
                              batch=batch, min_inliers=8)
        ang, dist = keyframes.motion(s.delta.t, s.delta.q)
        if bool(s.ok) and (float(ang) >= rot or float(dist)
                           >= keyframes.TRANS_THRESH_M):
            idx.append(i)
            dts.append(s.delta.t.cpu().numpy())
            dqs.append(s.delta.q.cpu().numpy())
            last = i
    return keyframes.OfflineKeyframes(np.asarray(idx, np.int64),
                                      np.stack(dts), np.stack(dqs),
                                      feats.uv.shape[0] - 1)


def as_tensors(tree):
    """The tensors and arrays of a result, as CPU tensors (tree_gap's
    input); ints and None dropped."""
    from torch.utils._pytree import tree_leaves

    return [torch.as_tensor(x).cpu() for x in tree_leaves(tree)
            if isinstance(x, (torch.Tensor, np.ndarray))]


def backend_case(name, run, eager, steps: int, unit: str, want, limit,
                 verdict: int = 0, where: str = "backend-graphs",
                 sync_check: bool = False, eager_steps=(1, 2), k3: int = 0,
                 k4: int = 0):
    """One program of config #4: ``run()`` (through the program; a first
    call captures any variant not captured yet) against ``eager(steps)``,
    the plain loop of its body, on the same inputs and draws, bit for bit.
    K1/K2 on the device counters of the graphed and the eager runs
    against ``want``, K3's against ``k3`` (one per bootstrap), K4's
    against ``k4`` (one per loop-mining pair); host ms per step of each (medians of 3 and of 1);
    the graphed run profiled for host-issued launches per step (less
    ``verdict`` host reads per step), device busy per step and idle
    share, and the eager loop profiled over ``eager_steps`` (1 and 2)
    steps, whose difference is one eager step (a whole eager run holds
    tens of thousands of launches, which the profiler takes minutes to
    list; a case whose step is a whole call profiles 0 (nothing) and
    1; (0, n): per step over a whole call of n);
    the capture seconds and pool of each variant the first call
    captured. ``sync_check``: the counted graphed run under torch's sync
    debug mode "error" (a program that reads nothing to the host).
    Returns a dict of the figures."""
    from pre3_tpu_torch.utils.profile_slice import _profiled

    def counted_run(fn, check=False):
        """(fn's result, host seconds, K1/K2/K3/K4 on the device
        counters)."""
        reset_launches()
        torch.cuda.synchronize()
        if check:
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, (*read_launches(), read_k3(),
                                               read_k4())

    t_case = time.perf_counter()
    before = captured_now()
    t_first = host_seconds(run)
    caps = new_captures(before)
    got, t_graph, counts = counted_run(run, sync_check)
    t_graph = statistics.median([t_graph] + [host_seconds(run)
                                             for _ in range(2)])
    launches, busy, wall, names, counted = profiled_launches(run)
    ref, t_eager, eager_counts = counted_run(lambda: eager(steps))
    e0, e1 = eager_steps
    (l1, b1, _, _), (l2, b2, w2, _) = (
        (0, 0.0, 0.0, None) if n == 0 else _profiled(lambda n=n: eager(n))
        for n in eager_steps)
    equal, gap = tree_gap(as_tensors(got), as_tensors(ref))
    res = dict(name=name, equal=equal, gap=gap, k1=counts[0], k2=counts[1],
               k3=counts[2], k4=counts[3],
               launches=launches / steps - verdict, busy_ms=busy / steps,
               host_ms=1e3 * t_graph / steps, idle=1.0 - busy / wall,
               eager_host_ms=1e3 * t_eager / steps,
               eager_launches=(l2 - l1) / (e1 - e0) - verdict,
               eager_busy_ms=(b2 - b1) / (e1 - e0) / 1e3,
               eager_idle=1.0 - b2 / 1e6 / w2, first_s=t_first,
               captures=caps, case_s=time.perf_counter() - t_case)
    phase(where, f"{name}: graphed vs eager bit-equal {equal} "
          f"(max gap {gap:.3e}); per {unit}: graphed host "
          f"{res['host_ms']:.4f} ms, launches {res['launches']:.2f}, device "
          f"busy {res['busy_ms']:.4f} ms, idle share {res['idle']:.4f} (over "
          f"{steps}); eager host {res['eager_host_ms']:.4f} ms (over {steps}),"
          f" launches {res['eager_launches']:.2f}, device busy "
          f"{res['eager_busy_ms']:.4f} ms ({e1} steps less {e0}, per "
          f"step), idle "
          f"share {res['eager_idle']:.4f} ({e1} steps); launches less "
          f"{verdict} "
          f"verdict read per {unit}; whole call graphed {1e3 * t_graph:.2f} "
          f"ms, eager {1e3 * t_eager:.2f} ms, first call {t_first:.2f} s; "
          f"K1/K2/K3/K4 graphed {counts}, eager {eager_counts}, profiled "
          f"{names} against the counters {counted}, want {(*want, k3, k4)}; "
          f"case "
          f"{res['case_s']:.1f} s; " + "; ".join(caps))
    if not equal:
        raise AssertionError(f"{where} {name}: graphed and eager "
                             f"differ (max gap {gap:.3e})")
    want_names = dict(zip((K1_KERNEL, K2_KERNEL), want))
    want = (*want, k3, k4)
    if counts != want or eager_counts != want or counted != want_names or (
            any(names[k] == 0 for k, v in want_names.items() if v)):
        raise AssertionError(f"{where} {name}: K1/K2/K3/K4 {counts} "
                             f"(eager {eager_counts}, profiled {names}, "
                             f"counted {counted}), want {want}")
    if res["launches"] > limit:
        raise AssertionError(f"{where} {name}: {res['launches']:.2f} "
                             f"launches per {unit} (limit {limit})")
    return res


def backend_graphs_phase(prob15, loop, offline_feats):
    """Phase 25: (a) bundle_adjust on phase 15's problem and (b) on phase
    16's merged one (tracks, lc_lm, mined lcp with lcp_info); (c)
    build_tracks on the loop scene's keyframes; (d) the loop mining on its
    candidate pairs, the same generator seed for both runs; (e) the cold
    find_keyframes_vo of phase 18's 24-frame example."""
    from pre3_tpu_torch.backend.ba import bundle_adjust
    from pre3_tpu_torch.backend.keyframes import find_keyframes_vo
    from pre3_tpu_torch.backend.loop_detect import (
        mine_keyframe_loop_closures,
    )
    from pre3_tpu_torch.backend.tracks import build_tracks
    from pre3_tpu_torch.frontend.pipeline import Features
    from pre3_tpu_torch.geometry.camera import sr4000_camera
    from pre3_tpu_torch.utils import graphs

    graphs.clear()  # each case's first call captures its program here
    cam = sr4000_camera()
    gen = lambda seed: torch.Generator("cuda").manual_seed(seed)  # noqa
    results = {}
    for key, prob in (("ba15", prob15), ("ba16", loop["merged"])):
        results[key] = backend_case(
            f"bundle_adjust ({key}: {describe(prob)})",
            lambda prob=prob: bundle_adjust(cam, prob, iters=BA_ITERS),
            lambda n, prob=prob: eager_bundle_adjust(cam, prob, n),
            BA_ITERS, "LM iteration", (0, 0), BACKEND_LAUNCHES_BA)
    kf_feats, kf_t, kf_q, kf_valid = (loop[k] for k in (
        "kf_feats", "kf_t", "kf_q", "kf_valid"))
    m, rows = kf_feats.uv.shape[0], loop["max_tracks"]
    first = lambda n, *xs: [x[:n] for x in xs]  # noqa: E731
    results["tracks"] = backend_case(
        f"build_tracks ({m} keyframes × {kf_feats.uv.shape[1]} features, "
        f"{rows} rows)",
        lambda: build_tracks(kf_feats, kf_t, kf_q, kf_valid, max_tracks=rows),
        lambda n: eager_build_tracks(
            Features(*first(n, *kf_feats)), *first(n, kf_t, kf_q, kf_valid),
            max_tracks=rows),
        m, "keyframe", (0, m), BACKEND_LAUNCHES_STEP)
    _, tried = eager_mine(kf_feats, kf_t, kf_valid, gen(1))
    results["mining"] = backend_case(
        f"mine_keyframe_loop_closures ({tried} pairs tried)",
        lambda: mine_keyframe_loop_closures(
            kf_feats, kf_t, kf_q, kf_valid, max_pairs=MINE_MAX_PAIRS,
            generator=gen(1)),
        lambda n: eager_mine(kf_feats, kf_t, kf_valid, gen(1), n)[0],
        tried, "pair", (tried, tried), BACKEND_LAUNCHES_STEP, verdict=1,
        k4=tried)
    n = offline_feats.uv.shape[0] - 1
    results["keyframes"] = backend_case(
        f"find_keyframes_vo (cold, {n + 1} frames, {n} pairs)",
        lambda: find_keyframes_vo(offline_feats, batch=OFFLINE_BATCH,
                                  generator=gen(0)),
        lambda k: eager_keyframe_search(
            Features(*first(k + 1, *offline_feats)), gen(0), OFFLINE_BATCH),
        n, "pair", (n, n), BACKEND_LAUNCHES_STEP, verdict=1)
    return results


# ---------------------------------------------------------------------------
# Phase 26 (frontend-graphs): the standalone frontends (extract_features,
# extract_features_sift) replay one captured CUDA graph per chunk of up to
# 64 frames (frontend/pipeline.py); each is held against its eager bodies
# on the card.
# ---------------------------------------------------------------------------

# The corridor's 256 frames (four 64-frame chunks), one frame (the
# examples' and OnlineSlam's bootstrap calls) and 72 frames (a chunk and
# a tail of 8, a program of its own).
FRONTEND_FRAMES = (N_FRAMES, 1, 72)
# Host-issued launches per chunk: the copy in (one multi-tensor copy of
# the chunk's intensity, xyz and confidence), the graph launch and the
# copy out (one per dtype of the features: f32 and bool).
FRONTEND_LAUNCHES = 6
# run_slam_pipelined against run_slam: the first run captures the
# pipeline's programs, the others replay them
PIPELINE_RUNS = 3


def frontend_pool() -> str:
    """The frontend programs' shared graph pool: its size and graphs."""
    from pre3_tpu_torch.frontend.pipeline import FRONTEND_POOL
    from pre3_tpu_torch.utils import graphs

    pool = [p for (name, _), p in graphs.pools().items()
            if name == FRONTEND_POOL]
    if not pool:
        raise AssertionError("frontend-graphs: no frontend program captured "
                             "into the frontend pool")
    return (f"the frontend pool {pool[0].bytes / 2**20:.1f} MiB for "
            f"{pool[0].graphs} graphs")


def nested_capture_refused(frames) -> str:
    """A program whose body calls extract_features_sift (a program) must
    fail its capture, naming both programs; its warm-up, outside any
    capture, runs the frontend's program as any caller would."""
    from pre3_tpu_torch.frontend.pipeline import extract_features_sift
    from pre3_tpu_torch.utils import graphs

    outer = graphs.StepProgram("nested-capture probe", {}, "cuda")
    part = [x[:2] for x in frames]
    try:
        outer.run("v", lambda b, g: extract_features_sift(*part))
    except RuntimeError as e:
        msg = str(e)
    else:
        raise AssertionError("frontend-graphs: a program ran inside another "
                             "program's capture")
    if "extract_features_sift" not in msg or "nested-capture probe" not in msg:
        raise AssertionError(f"frontend-graphs: the nested capture raised "
                             f"without naming both programs: {msg}")
    return msg


def frontend_case(name, fn, chunks: int) -> dict:
    """One frontend call through its programs (the first call captures
    any program or variant not captured yet) against the same call with
    the programs' bodies run eagerly (``graphs.eager()``), bit for bit;
    per chunk: host ms (medians of 3), host-issued launches and device
    busy of one profiled run, graphed and eager; the capture seconds and
    pools."""
    from pre3_tpu_torch.utils import graphs

    before = captured_now()
    t_first = host_seconds(fn)
    caps = new_captures(before)
    got = fn()
    t_graph = statistics.median([host_seconds(fn) for _ in range(3)])
    launches, busy, wall, _, _ = profiled_launches(fn)
    with graphs.eager():
        ref = fn()
        t_eager = statistics.median([host_seconds(fn) for _ in range(3)])
        e_launches, e_busy, e_wall, _, _ = profiled_launches(fn)
    equal, gap = tree_gap(list(got), list(ref))
    res = dict(name=name, equal=equal, host_ms=1e3 * t_graph / chunks,
               launches=launches / chunks, busy_ms=busy / chunks,
               idle=1.0 - busy / wall, eager_host_ms=1e3 * t_eager / chunks,
               eager_launches=e_launches / chunks,
               eager_busy_ms=e_busy / chunks, eager_idle=1.0 - e_busy / e_wall,
               first_s=t_first, captures=caps)
    phase("frontend-graphs", f"{name}: graphed vs eager bit-equal {equal} "
          f"(max gap {gap:.3e}); per chunk (over {chunks}): graphed host "
          f"{res['host_ms']:.3f} ms, launches {res['launches']:.2f}, device "
          f"busy {res['busy_ms']:.4f} ms, idle share {res['idle']:.4f}; "
          f"eager host {res['eager_host_ms']:.3f} ms, launches "
          f"{res['eager_launches']:.1f}, device busy "
          f"{res['eager_busy_ms']:.4f} ms, idle share "
          f"{res['eager_idle']:.4f}; first call {t_first:.2f} s; "
          + ("; ".join(caps) or "no new capture"))
    if not equal:
        raise AssertionError(f"frontend-graphs {name}: graphed and eager "
                             f"differ (max gap {gap:.3e})")
    if res["launches"] > FRONTEND_LAUNCHES:
        raise AssertionError(f"frontend-graphs {name}: {res['launches']:.2f} "
                             f"launches per chunk (limit "
                             f"{FRONTEND_LAUNCHES})")
    return res


def frontend_graphs_phase(im):
    """Phase 26: the SIFT frontend (exact and fast branches) and the FAST
    frontend at FRONTEND_FRAMES, each graphed against its eager bodies;
    then a program entered during another's capture (refused), and
    after it run_slam_pipelined (SIFT, MD_FRAMES frames in chunks of
    MD_CHUNK: the next chunk's frontend replayed on a side stream while
    the backend's steps replay) against run_slam on the one-batch
    frontend, under the same draws, to the bit, PIPELINE_RUNS times: the
    first with every program dropped, so that the pipeline captures its
    programs itself, on the side stream among them."""
    from pre3_tpu_torch.ekf.slam import SlamConfig, run_slam
    from pre3_tpu_torch.frontend.pipeline import (
        extract_features, extract_features_sift,
    )
    from pre3_tpu_torch.geometry.camera import sr4000_camera
    from pre3_tpu_torch.runtime.stage_pipeline import run_slam_pipelined
    from pre3_tpu_torch.utils import graphs
    from pre3_tpu_torch.utils.interop import to_torch

    results = {}
    for n in FRONTEND_FRAMES:
        part = [x[:n] for x in im]
        chunks = -(-n // 64)
        for branch, label in (("0", "exact"), ("1", "fast")):
            with sift_branch(branch):
                results[f"sift {label} {n}"] = frontend_case(
                    f"extract_features_sift ({label}, {n} frames)",
                    lambda part=part: extract_features_sift(*part), chunks)
        results[f"fast {n}"] = frontend_case(
            f"extract_features (FAST, {n} frames)",
            lambda part=part: extract_features(
                *part, threshold=THRESHOLD, max_features=MAX_FEATURES),
            chunks)
    cam, cfg = sr4000_camera(), SlamConfig(**SIFT_CFG)
    draws = to_torch(ekf_draws(MD_FRAMES, cfg, SIFT_LANDMARKS, seed=26,
                               kf=SIFT_KF), "cuda")
    frames = [x[:MD_FRAMES] for x in im]
    phase("frontend-graphs", f"after every case: {frontend_pool()}")
    msg = nested_capture_refused(frames)
    phase("frontend-graphs", f"nested capture refused: {msg}")
    ref = run_slam(cam, extract_features_sift(*frames), cfg,
                   n_landmarks=SIFT_LANDMARKS, draws=draws)
    for run in range(PIPELINE_RUNS):
        if run == 0:
            graphs.clear()
        torch.cuda.synchronize()
        t_pipe = time.perf_counter()
        got = run_slam_pipelined(cam, *frames, cfg=cfg,
                                 n_landmarks=SIFT_LANDMARKS, chunk=MD_CHUNK,
                                 extractor="sift", draws=draws)
        torch.cuda.synchronize()
        t_pipe = time.perf_counter() - t_pipe
        equal, gap = tree_gap([got.t, got.q, *got.stats],
                              [ref.t, ref.q, *ref.stats])
        how = "its programs captured in it" if run == 0 else "replays"
        phase("frontend-graphs", f"run_slam_pipelined run {run + 1} of "
              f"{PIPELINE_RUNS} ({how}; SIFT, {MD_FRAMES} frames, chunks "
              f"of {MD_CHUNK}) vs run_slam: "
              f"t, q and every stat equal to the bit {equal} (max gap "
              f"{gap:.3e}); {t_pipe:.2f} s")
        if not equal:
            raise AssertionError(f"frontend-graphs: run_slam_pipelined run "
                                 f"{run + 1} differs from run_slam")
    return results


# ---------------------------------------------------------------------------
# Phase 27 (solver-graphs): the reference's last jitted sites, ICP, GICP,
# EPnP, DLS-PnP and the bootstrap, replay their programs' graphs; each is
# held against its bodies run under graphs.eager() on the card.
# ---------------------------------------------------------------------------

# Host-issued launches (graph launches, fills, copies), counted by the
# profiler over one call: per iteration of an ICP, GICP or DLS-PnP call
# (its loads, covariances or seed, finish and result copy included), per
# EPnP call, and per bootstrap. Each replay is one graph launch, and at
# most two fills where torch seeds a generator registered with it.
SOLVER_ITERS = 20  # icp's and gicp's default; dls_pnp's is 10
SOLVER_LAUNCHES_ITERATION = 5
SOLVER_LAUNCHES_EPNP = 6
SOLVER_LAUNCHES_BOOTSTRAP = 10
SOLVER_BATCH_SEQS = 4
SOLVER_RUN_FRAMES = 32


def eager_calls(fn):
    """n → ``fn(n)`` under ``graphs.eager()``: the program's bodies run
    eagerly on its buffers (backend_case's plain loop)."""
    from pre3_tpu_torch.utils import graphs

    def run(n):
        with graphs.eager():
            return fn(n)

    return run


def repeated(fn):
    """n → fn() n times, the last result (a per-call case's n steps)."""
    def run(n):
        out = None
        for _ in range(n):
            out = fn()
        return out

    return run


def solver_graphs_phase(pnp_cases, im):
    """Phase 27: (a) icp and gicp (SOLVER_ITERS iterations) on phase 20's
    2048-point clouds, epnp_camera and dls_pnp (10 iterations) on its
    pair's inliers; (b) bootstrap_state for SIFT at K=256 with the
    plane-fit prior from frame 0's xyz image (as OnlineSlam calls it),
    for NCC at K=256 with frame 0's intensity image, and
    bootstrap_batched over S=4 corridor frames with a generator each;
    each held to its bodies under graphs.eager() by ``backend_case``, on
    the same inputs and the same generator seeds; (c) a 32-frame SIFT
    run_slam (bench.py's form) timed whole with its bootstrap eager and
    as its program. Returns a dict of the figures."""
    from pre3_tpu_torch.ekf.slam import (
        SlamConfig, _frame, bootstrap_batched, bootstrap_state, run_slam,
        scan_steps,
    )
    from pre3_tpu_torch.frontend.pipeline import Features
    from pre3_tpu_torch.geometry.camera import sr4000_camera
    from pre3_tpu_torch.utils import graphs

    n = SOLVER_RUN_FRAMES
    # the frontend's programs of phase 26's 64-frame chunk and one frame
    sift = Features(*(x[:n] for x in sift_features([x[:64] for x in im])))
    fast = features([x[:1] for x in im])
    graphs.clear()  # each case's first call captures its program here
    cam = sr4000_camera()
    gen = lambda: torch.Generator("cuda").manual_seed(GRAPH_SEED)  # noqa: E731
    results = {}
    for name, (fn, args) in pnp_cases.items():
        if name == "epnp_camera":
            call = lambda fn=fn, args=args: fn(*args)  # noqa: E731
            case = (repeated(call), 1, "call", SOLVER_LAUNCHES_EPNP, (0, 1))
        else:
            iters = 10 if name == "dls_pnp" else SOLVER_ITERS
            call = lambda n, fn=fn, args=args: fn(*args, iters=n)  # noqa
            # DLS: eager per iteration over a whole call (its EPnP seed,
            # ~3600 launches, in every window otherwise)
            case = (call, iters, "iteration", SOLVER_LAUNCHES_ITERATION,
                    (0, iters) if name == "dls_pnp" else (1, 2))
        body, steps, unit, limit, profiled = case
        results[name] = backend_case(
            f"{name} ({args[0].shape[0]} points, {steps} {unit}s)",
            lambda body=body, steps=steps: body(steps), eager_calls(body),
            steps, unit, (0, 0), limit, where="solver-graphs",
            sync_check=True, eager_steps=profiled)

    boots = {  # name: (features, cfg, K, xyz_img, image)
        "bootstrap SIFT": (sift, SIFT_CFG, SIFT_LANDMARKS, im[1][0], None),
        "bootstrap NCC": (fast, NCC_CFG, EKF_LANDMARKS, im[1][0], im[0][0]),
    }
    for name, (feats, cfg, k, xyz, image) in boots.items():
        cfg = SlamConfig(**cfg)
        call = lambda feats=feats, cfg=cfg, k=k, xyz=xyz, image=image: (  # noqa
            bootstrap_state(cam, _frame(feats, 0), cfg, k, xyz_img=xyz,
                            image=image, generator=gen()))
        results[name] = backend_case(
            f"{name} (K={k}, {feats.uv.shape[1]} features, plane-fit "
            f"prior{', init patches' if image is not None else ''})",
            call, eager_calls(repeated(call)), 1, "bootstrap", (0, 0),
            SOLVER_LAUNCHES_BOOTSTRAP, where="solver-graphs",
            sync_check=True, eager_steps=(0, 1), k3=1)
    s = SOLVER_BATCH_SEQS
    cfg = SlamConfig(**SIFT_CFG)
    gens = lambda n: [torch.Generator("cuda").manual_seed(  # noqa: E731
        GRAPH_SEED + i) for i in range(n)]
    batched = lambda n: bootstrap_batched(  # noqa: E731
        cam, Features(*(x[:n] for x in sift)), cfg, SIFT_LANDMARKS,
        generators=gens(n))
    # one eager bootstrap profiled: a call of one sequence (the batched
    # call adds no work of its own per sequence)
    results["bootstrap batched"] = backend_case(
        f"bootstrap_batched (S={s}, K={SIFT_LANDMARKS})",
        lambda: batched(s), eager_calls(batched), s, "bootstrap", (0, 0),
        SOLVER_LAUNCHES_BOOTSTRAP, where="solver-graphs", sync_check=True,
        eager_steps=(0, 1), k3=s)

    feats = sift
    first, rest = _frame(feats, 0), Features(*(x[1:] for x in feats))
    idx = torch.arange(1, n, dtype=torch.int32, device="cuda")

    def eager_boot():
        g = gen()
        with graphs.eager():
            state0 = bootstrap_state(cam, first, cfg, SIFT_LANDMARKS,
                                     generator=g)
        return scan_steps(cam, state0, first, rest, idx, cfg, generator=g,
                          first_step=1)

    graphed = lambda: run_slam(cam, feats, cfg, SIFT_LANDMARKS,  # noqa: E731
                               generator=gen())
    graphed()  # captures the step program and this bootstrap's
    walls = {"eager": [], "graphed": []}
    for _ in range(3):
        walls["eager"].append(host_seconds(eager_boot))
        walls["graphed"].append(host_seconds(graphed))
    ms = {k: 1e3 * statistics.median(v) for k, v in walls.items()}
    results["run_slam"] = ms
    phase("solver-graphs", f"run_slam, SIFT, {n} frames, K={SIFT_LANDMARKS} "
          f"(a record): whole call {ms['eager']:.2f} ms with the bootstrap "
          f"eager, {ms['graphed']:.2f} ms with its program (medians of 3, "
          f"in turns: " + ", ".join(f"{k} " + " ".join(
              f"{1e3 * x:.2f}" for x in v) for k, v in walls.items()) + ")")
    return results


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); the port's smoke run needs one GPU")
    if not (ROOT / "pre3_tpu_torch").is_dir():
        raise SystemExit(f"chip_smoke: no pre3_tpu_torch package beside "
                         f"{__file__}; run it from the root of a checkout")
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}")

    seconds = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - t0
        phase("time", f"{name}: {seconds[name]:.1f} s")
        return out

    # ---- 2. build ----
    timed("build", build_kernels,
          ["ransac_score", "match_stream", "inverse_depth_init",
           "vo_covariance"])

    # ---- 3. kernels vs plain on the card ----
    k1_err, k1_times = timed("kernel K1", check_k1)
    k2_err, k2_times = timed("kernel K2", check_k2)
    k3_gap, k3_times = timed("kernel K3", check_k3)
    k4_gap, k4_times = timed("kernel K4", check_k4)

    # ---- 4./5. VO slice ----
    images, im, gt = timed("parity + slice (VO)", vo_phases)

    # ---- 6.–8. EKF slice, FAST features ----
    timed("ekf-parity", ekf_parity)
    timed("ekf-options iekf", ekf_parity, "ekf-options", est_method="iekf")
    timed("ekf-options heading", ekf_parity, "ekf-options",
          heading_update_every=4)
    timed("ekf-slice", ekf_slice, im, gt)

    # ---- 9.–12. the flagship: SIFT → run_slam, OnlineSlam, smooth() ----
    timed("sift-parity", sift_parity)
    k1, k2, sift_out = timed("sift-slice", sift_slice, im, gt)
    streamed = timed("online", online_phase, images, gt)
    timed("online-smooth", smooth_phase, *streamed)

    # ---- 13./14. config #2: FAST + the warped-patch NCC matcher ----
    timed("ncc-parity", ekf_parity, "ncc-parity", matcher="ncc_warp")
    timed("ncc-parity iekf", ekf_parity, "ncc-parity", matcher="ncc_warp",
          est_method="iekf")
    ncc_k1, ncc_k2 = timed("ncc-slice", ekf_slice, im, gt, "ncc-slice",
                           NCC_CFG, (NCC_ATE_CENTER, NCC_ATE_HALF_WIDTH),
                           NCC_TIMED_RUNS)

    # ---- 15./16. config #4: keyframe BA, tracks, loop mining ----
    prob15 = timed("ba", ba_phase, sift_out, gt)
    tracks_k2, (mine_k1, mine_k2), prob16, loop = timed("loop", loop_phase)

    # ---- 17.–20. the host-side paths: .dat, caches, replay, PnP/ICP ----
    with tempfile.TemporaryDirectory(prefix="pre3_smoke_") as tmp:
        tmp = Path(tmp)
        dat_k1, dat_k2 = timed("dat", dat_phase, tmp / "dat")
        ((kf_k1, kf_k2), warm), offline_feats = timed(
            "offline-kf", offline_kf_phase, tmp / "keyframing")
        timed("replay", replay_phase, tmp)
    pnp_err, pnp_cases = timed("pnp-icp", pnp_icp_phase, images)

    # ---- 21. the multi-device modules on spawned ranks ----
    md_a, md_b, _ = timed("multi-device", multi_device_phase, im, prob15,
                          prob16)

    # ---- 22. the multi-sequence path: run_slam_batched ----
    b_err, b_times, (b_k1, b_k2) = timed("batch", batch_phase)

    # ---- 23. SIFT's fast-math branch; examples/run_synthetic_slam.py ----
    with tempfile.TemporaryDirectory(prefix="pre3_smoke_") as tmp:
        _, (fast_k1, fast_k2), walk = timed(
            "fast-sift-walkthrough", fast_sift_phase, images, im, Path(tmp))

    # ---- 24. the step programs: each driver graphed against eager ----
    graph_res = timed("graphs", graphs_phase, images, im)

    # ---- 25. config #4's programs: each graphed against eager ----
    backend_res = timed("backend-graphs", backend_graphs_phase, prob15, loop,
                        offline_feats)

    # ---- 26. the standalone frontends: each graphed against eager ----
    timed("frontend-graphs", frontend_graphs_phase, im)

    # ---- 27. ICP, GICP, PnP and the bootstraps: graphed against eager ----
    solver_res = timed("solver-graphs", solver_graphs_phase, pnp_cases, im)

    # ---- 28. the tracer: probes inside the step program's graphs ----
    timed("tracer", tracer_phase, im)
    phase("done", f"all phases passed in {time.perf_counter() - t_start:.1f} "
          f"s: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))

    # times at the SIFT headline's shapes, whose run gave "launches";
    # "ms" is the graph-replayed device time. K2 runs at 288×288 (VO) and
    # 256×288 (map matching), once each per step. "paths" holds each
    # path's launches, counted from 0 around that path's run; the
    # offline keyframing's are those of its keyframe search, cold (the
    # warm pass launches none).
    k1_t = k1_times["512x288"]
    k2_vo, k2_map = k2_times["288x288-d128"], k2_times["256x288-d128"]
    print(json.dumps({"kernels": [
        {"name": "ransac_score", "route": "cuda",
         "source": "pre3_tpu_torch/csrc/ransac_score.cu",
         "replaces": "pre3_tpu/ops/ransac_score.py:45",
         "shape": "B=512, N=288", "launches": k1, "max_abs_err": k1_err,
         "ms": k1_t["device_ms"], **k1_t,
         "paths": {"sift_slice": k1, "ncc_slice": ncc_k1,
                   "loop_mining": mine_k1, "dat": dat_k1,
                   "offline_kf": kf_k1, "offline_kf_warm": warm[0],
                   "multi_device": {"nccl_1_rank": md_a[0],
                                    "gloo_2_ranks": [k[0] for k in md_b]},
                   "fast_sift_slam": fast_k1,
                   "walkthrough": {k: v[0] for k, v in walk.items()}},
         "loop_mining_time": {"shape": "B=1024, N=288",
                              **k1_times["1024x288"]},
         "dat_time": {"shape": "B=512, N=128", **k1_times["512x128"]},
         "multi_device_time": {"shape": "B=2048, N=288",
                               **k1_times["2048x288"]},
         "dryrun_time": {"shape": "B=512, N=96", **k1_times["512x96"]},
         "dryrun_ransac_time": {"shape": "B=64, N=64",
                                **k1_times["64x64"]}},
        {"name": "match_stream", "route": "cuda",
         "source": "pre3_tpu_torch/csrc/match_stream.cu",
         "replaces": "pre3_tpu/ops/matching.py:105",
         "shape": "N1=N2=288, D=128 (VO; half the launches)",
         "launches": k2, "max_abs_err": k2_err, "ms": k2_vo["device_ms"],
         **k2_vo, "map_match": {"shape": "N1=256, N2=288, D=128", **k2_map},
         "paths": {"sift_slice": k2, "ncc_slice": ncc_k2,
                   "tracks": tracks_k2, "loop_mining": mine_k2,
                   "dat": dat_k2, "offline_kf": kf_k2,
                   "offline_kf_warm": warm[1],
                   "multi_device": {"nccl_1_rank": md_a[1],
                                    "gloo_2_ranks": [k[1] for k in md_b]},
                   "fast_sift_slam": fast_k2,
                   "walkthrough": {k: v[1] for k, v in walk.items()}},
         "tracks_time": {"shape": "N1=512, N2=288, D=128",
                         **k2_times["512x288-d128"]},
         "k64_map_time": {"shape": "N1=64, N2=288, D=128 (OnlineSlam, "
                                   "the walkthrough's run_slam)",
                          **k2_times["64x288-d128"]},
         "dat_time": {"shape": "N1=N2=128, D=121",
                      **k2_times["128x128-d121"]},
         "dat_map_time": {"shape": "N1=64, N2=128, D=121",
                          **k2_times["64x128-d121"]},
         "dryrun_time": {"shape": "N1=N2=96, D=121",
                         **k2_times["96x96-d121"]},
         "dryrun_map_time": {"shape": "N1=24, N2=96, D=121",
                             **k2_times["24x96-d121"]}},
        {"name": "ransac_score_batched", "route": "cuda",
         "source": "pre3_tpu_torch/csrc/ransac_score.cu",
         "replaces": "pre3_tpu/ops/ransac_score.py:45",
         "shape": f"S={BATCH_SEQS}, B=512, N=288",
         "launches": b_k1, "max_abs_err": b_err["k1"],
         "ms": b_times[f"K1 {BATCH_SEQS}x512x{SIFT_KF}"]["device_ms"],
         **b_times[f"K1 {BATCH_SEQS}x512x{SIFT_KF}"]},
        {"name": "match_stream_batched", "route": "cuda",
         "source": "pre3_tpu_torch/csrc/match_stream.cu",
         "replaces": "pre3_tpu/ops/matching.py:105",
         "shape": f"S={BATCH_SEQS}, N1=N2=288, D=128 (VO; half the "
                  "launches)",
         "launches": b_k2, "max_abs_err": b_err["k2"],
         "ms": b_times[f"K2 vo {BATCH_SEQS}x288x288x128"]["device_ms"],
         **b_times[f"K2 vo {BATCH_SEQS}x288x288x128"],
         "map_match": {"shape": f"S={BATCH_SEQS}, N1=256, N2=288, D=128",
                       **b_times[f"K2 map {BATCH_SEQS}x256x288x128"]}},
        {"name": "inverse_depth_init", "route": "cuda",
         "source": "pre3_tpu_torch/csrc/inverse_depth_init.cu",
         "replaces": "none (add_features' inverse_depth_point and its three "
                     "jacfwd passes, pre3_tpu/ekf/map_management.py)",
         "shape": "A=8 (a step)",
         "launches": graph_res["run_slam #3 (SIFT, K=256)"]["k3"],
         "max_rel_block_gap": k3_gap, "ms": k3_times["8"]["device_ms"],
         **k3_times["8"],
         "bootstrap_time": {"shape": "A=32", **k3_times["32"]},
         "batched_time": {"shape": "S=16, A=8", **k3_times["16x8"]}},
        {"name": "vo_covariance", "route": "cuda",
         "source": "pre3_tpu_torch/csrc/vo_covariance.cu",
         "replaces": "none (vo_covariance's hessian and two jacfwd-of-grad "
                     "passes, pre3_tpu/vo/covariance.py)",
         "shape": "N=288 (a SIFT step)",
         "launches": graph_res["run_slam #3 (SIFT, K=256)"]["k4"],
         "max_rel_gap_f64": k4_gap, "ms": k4_times["288"]["device_ms"],
         **k4_times["288"],
         "fast_time": {"shape": "N=256", **k4_times["256"]},
         "batched_time": {"shape": "S=16, N=288", **k4_times["16x288"]}},
    ], "pnp_icp_card_vs_cpu": pnp_err,
        "graphs": {k: {f: v[f] for f in ("launches", "host_ms", "busy_ms",
                                        "idle", "k1", "k2", "k3", "k4")
                    if f in v}
                   for k, v in graph_res.items() if k != "memory"},
        "graph_memory": {k: graph_res["memory"][k]
                         for k in ("growth", "eager_growth", "frontend")},
        "backend_graphs": {k: {f: v[f] for f in (
            "launches", "host_ms", "busy_ms", "eager_launches",
            "eager_host_ms", "k1", "k2")} for k, v in backend_res.items()},
        "solver_graphs": {k: v if k == "run_slam" else {f: v[f] for f in (
            "launches", "host_ms", "busy_ms", "eager_launches",
            "eager_host_ms")} for k, v in solver_res.items()}}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
