#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pre3_tpu_torch) on one NVIDIA GPU.

Drives the port's two slices through their entry points and checks each
CUDA kernel of those paths against its plain PyTorch version:

  * VO dead reckoning: ``extract_features`` → ``run_sequence`` (K2 match
    + K1-scored RANSAC per frame pair);
  * EKF-SLAM: ``extract_features`` → ``run_slam`` (per frame: VO with
    K2 + K1 and its IFT covariance, prediction, K2 map matching, 1-point
    RANSAC, Kalman updates, map management).

Run it from the root of a checkout:

    python3 chip_smoke.py

It builds the kernels from ``pre3_tpu_torch/csrc`` on first use (needs
``nvcc``; one ``nvcc`` per source, started together), needs one CUDA
device, and imports nothing of JAX. Phases:

  1. device     — the card's name and power limit (nvidia-smi);
  2. build      — compile or load K1 (RANSAC scorer) and K2 (streaming
                  matcher), with ptxas registers/spills;
  3. kernel     — K1 and K2 vs their plain versions on the card, timed;
  4. parity     — a 16-frame VO slice on the card vs the port's CPU path;
  5. slice      — the 256-frame corridor VO slice at the bench operating
                  point: frames/s, K1 and K2 launches per run, ATE;
  6. ekf-parity — a 16-frame run_slam (K=64, plane fit on) on the card vs
                  the port's CPU path, same injected draws;
  7. ekf-slice  — the 256-frame corridor run_slam at the bench headline's
                  operating point (K=256, D=1549): frames/s, K1 and K2
                  launches per run, n_ic/n_li/n_active, ATE.

The line before the last is ``{"kernels": [...]}`` and the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without printing a result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

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

# K2 agreement (phase 3): rows whose best/second margin, or ratio margin,
# is below this relative gap may legitimately resolve either way.
K2_MARGIN = 1e-5

# Kernel timing (phase 3): device time by graph replay (see device_ms).
GRAPH_CALLS, GRAPH_REPLAYS, GRAPH_READINGS = 20, 10, 5
# Published peaks of one H100 SXM at 700 W (NVIDIA's H100 datasheet).
H100_BYTES_PER_S = 3.35e12
H100_TF32_FLOPS = 495e12
H100_F32_FLOPS = 67e12


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


def k1_bound(b: int, n: int):
    """K1: ~28 f32 flops per (hypothesis, point) — 9 products, 9 sums
    and 3 differences for R·p2 + t − p1, 3 squares and 2 sums, the
    compare and the accumulation — outside the tensor cores; bytes: R,
    t, both point sets, the flags, the threshold, support and err."""
    return bound_ms(28.0 * b * n, H100_F32_FLOPS,
                    b * 48 + 2 * n * 12 + n + 4 + b * 8)


def k2_bound(n1: int, n2: int, d: int):
    """K2: the product's 2·N1·N2·D flops at the TF32 tensor-core rate,
    the fastest the card runs f32 inputs (3xTF32 does three passes and
    cannot beat it); bytes: both descriptor sets, the column flags and
    the three outputs."""
    return bound_ms(2.0 * n1 * n2 * d, H100_TF32_FLOPS,
                    4 * (n1 + n2) * d + n2 + n1 * 16)


def floor_fn(launch, *sizes):
    """An empty kernel at a kernel's launch configuration (grid, cluster,
    threads, shared memory) for these sizes: ``launch`` is the kernel
    library's ``*_floor_launch``."""
    def run():
        rc = launch(*sizes, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"empty-kernel launch failed: cudaError {rc}")
    return run


def render(n_frames: int, n_points: int, x_range):
    from pre3_tpu_torch.data.synthetic import render_sequence

    frames, traj, _ = render_sequence(
        n_frames=n_frames, n_points=n_points, noise=NOISE, x_range=x_range)
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
    from pre3_tpu_torch.ekf.slam import run_slam
    from pre3_tpu_torch.geometry.camera import sr4000_camera

    return run_slam(sr4000_camera(), features(images), cfg,
                    n_landmarks=n_landmarks, draws=draws,
                    generator=generator, xyz_imgs=xyz_imgs)


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


def check_k1():
    """K1 vs its plain version at the VO shapes; timings."""
    from pre3_tpu_torch.ops.ransac_score import (
        _lib, residuals_torch, score_hypotheses, score_hypotheses_torch,
    )

    cases = [  # (name, B, N, seed, all_invalid)
        ("main-1024x256", 1024, 256, 0, False),
        ("slam-512x288", 512, 288, 1, False),
        ("ekf-512x256", 512, 256, 6, False),
        ("ragged-1000x250", 1000, 250, 2, False),
        ("n1-64x1", 64, 1, 3, False),
        ("all-invalid-128x256", 128, 256, 4, True),
        ("chunks-256x3000", 256, 3000, 5, False),
    ]
    max_abs_err = 0.0
    for name, b, n, seed, all_invalid in cases:
        args = scorer_problem(b, n, seed, all_invalid)
        r, t, p1, p2, valid, thr = args
        sup_k, err_k = score_hypotheses(*args)
        sup_p, err_p = score_hypotheses_torch(*args)
        torch.cuda.synchronize()
        # points whose residual lies within 1e-6·thr of thr may fall
        # either way; they are counted per hypothesis
        resid2 = residuals_torch(r, t, p1, p2)
        band = (valid[None] & ((resid2 - thr).abs() <= 1e-6 * thr)).sum(-1)
        diff = (sup_k.long() - sup_p.long()).abs()
        outside = int((diff > band).sum())
        clean = band == 0
        rel = ((err_k - err_p).abs() / err_p.abs().clamp(min=1e-30))[clean]
        abs_err = float((err_k - err_p).abs()[clean].max())
        max_abs_err = max(max_abs_err, abs_err)
        phase("kernel", f"K1 {name}: support mismatches outside band "
              f"{outside}, exact {int((diff == 0).sum())}/{b}; err max abs "
              f"{abs_err:.3e}, max rel "
              f"{float(rel.max()) if rel.numel() else 0.0:.3e}")
        if outside:
            raise AssertionError(f"K1 {name}: support differs outside the band")
        torch.testing.assert_close(err_k[clean], err_p[clean], rtol=1e-5,
                                   atol=0.0)
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
                       ("512x288", 512, 288)):
        args = scorer_problem(b, n, 10)
        t = dict(device_ms=device_ms(lambda: score_hypotheses(*args)),
                 plain_ms=device_ms(lambda: score_hypotheses_torch(*args)),
                 library_ms=None,
                 wrapper_ms=wrapper_ms(lambda: score_hypotheses(*args)),
                 launch_floor_ms=device_ms(floor_fn(
                     _lib().ransac_score_floor_launch, b)))
        t["bound_ms"], t["bound_by"] = k1_bound(b, n)
        timings[name] = t
        phase("kernel", f"K1 time B×N={name}: device {t['device_ms']:.5f} ms "
              f"(empty-kernel floor {t['launch_floor_ms']:.5f}), plain "
              f"{t['plain_ms']:.5f}, library none, wrapper (host) "
              f"{t['wrapper_ms']:.5f}; bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}), {t['bound_ms'] / t['device_ms']:.2%} of it")
    return max_abs_err, timings


def k2_compare(name, k, p, d1, d2) -> float:
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
    phase("kernel", f"K2 {name}: index mismatches on clear rows "
          f"{idx_bad}/{int(clear.sum())}, accepted mismatches "
          f"{acc_bad}/{int(sel.sum())}, dist2 max abs err {err:.3e} "
          f"(tol {1e-5 * scale:.1e}), accepted {int(k.accepted.sum())}")
    if idx_bad or acc_bad or big_bad or err > 1e-5 * scale:
        raise AssertionError(f"K2 {name}: disagrees with the plain matcher")
    return err


def check_k2():
    """K2 vs the plain matcher on the main path's shapes and the corner
    cases, those of the cluster's column split among them; graph replay
    vs eager; timings at 256², 4096² and 8192²."""
    from pre3_tpu_torch.ops.matching import (
        BIG, K2_RANKS, _best_two, _launch_k2, _lib, _pairwise_dist2,
        match_descriptors, match_descriptors_k2,
    )

    cases = [  # (name, N1, N2, D, seed)
        ("step-256x256-d121", 256, 256, 121, 0),
        ("sift-256x288-d128", 256, 288, 128, 1),
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

    d1, d2, v1, v2 = matcher_problem(256, 256, 121, 12)
    if not replay_equals_eager(
        lambda: match_descriptors_k2(d1, d2, v1, v2, ratio=1.3)
    ):
        raise AssertionError("K2: graph replay differs from the eager call")
    phase("kernel", "K2 graph replay at 256x256-d121: index, dist2, second "
          "and accepted bitwise equal to the eager call")

    timings = {}
    for name, n, d in (("256x256-d121", 256, 121),
                       ("4096x4096-d128", 4096, 128),
                       ("8192x8192-d128", 8192, 128)):
        d1, d2, v1, v2 = matcher_problem(n, n, d, 11)
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
                _lib().match_stream_floor_launch, n, n, d)))
        t["bound_ms"], t["bound_by"] = k2_bound(n, n, d)
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
    return im, gt


def ekf_draws(n_frames: int, cfg, n_landmarks: int, seed: int):
    """Numpy-seeded Gumbel draws for every random choice of run_slam."""
    from pre3_tpu_torch.ekf.one_point_ransac import pool_size
    from pre3_tpu_torch.ekf.slam import SlamDraws, StepDraws

    rng = np.random.default_rng(seed)
    g = lambda *s: rng.gumbel(size=s).astype(np.float32)
    m = pool_size(n_landmarks, cfg.max_update_slots or None)
    n_region = (144 - int(144 * 0.6)) * 176
    s = n_frames - 1
    return SlamDraws(
        steps=StepDraws(vo=g(s, cfg.vo_batch, MAX_FEATURES),
                        ransac=g(s, cfg.ransac_batch, m),
                        add=g(s, MAX_FEATURES)),
        boot_add=g(MAX_FEATURES), plane=g(512, n_region))


def ekf_parity():
    """Phase 6: 16-frame run_slam, K=64, card vs the port's CPU path."""
    from pre3_tpu_torch.ekf.slam import SlamConfig
    from pre3_tpu_torch.utils.interop import to_torch

    n_short, k = 16, 64
    # max_update_slots 48 < K so the bounded update and pool run too
    cfg = SlamConfig(min_measured=50, max_update_slots=48, match_ratio=1.3)
    images, _ = render(n_short, 300, None)
    draws = ekf_draws(n_short, cfg, k, seed=8)
    outs = {}
    for dev in ("cuda", "cpu"):
        im = [torch.as_tensor(a, device=dev) for a in images]
        outs[dev] = run_ekf(im, k, cfg, draws=to_torch(draws, dev),
                            xyz_imgs=im[1])
    gpu, cpu = outs["cuda"], outs["cpu"]
    dt = float((gpu.t.cpu() - cpu.t).abs().max())
    dq = float((gpu.q.cpu() - cpu.q).abs().max())
    d_ic = (gpu.stats.n_ic.cpu() - cpu.stats.n_ic).abs()
    d_li = (gpu.stats.n_li.cpu() - cpu.stats.n_li).abs()
    steps_off = int(((d_ic > 0) | (d_li > 0)).sum())
    phase("ekf-parity", f"{n_short} frames, K={k}: n_ic equal per step "
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
        raise AssertionError("card and CPU EKF runs disagree")


def ekf_slice(im, gt):
    """Phase 7: the 256-frame corridor EKF slice, 1 warm-up + 3 timed."""
    from pre3_tpu_torch.ekf.slam import SlamConfig
    from pre3_tpu_torch.eval.trajectory import ate_rmse
    from pre3_tpu_torch.ops.matching import match_descriptors_k2
    from pre3_tpu_torch.ops.ransac_score import score_hypotheses

    cfg = SlamConfig(**EKF_CFG)
    seconds = []
    for run in range(TIMED_RUNS + 1):  # run 0 warms up under sync checks
        gen = torch.Generator(device="cuda").manual_seed(run)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if run == 0 else "default")
        score_hypotheses.launches = 0
        match_descriptors_k2.launches = 0
        t0 = time.perf_counter()
        out = run_ekf(im, EKF_LANDMARKS, cfg, generator=gen)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        k1, k2 = score_hypotheses.launches, match_descriptors_k2.launches
        s = out.stats
        t = out.t.cpu().numpy()
        ate = ate_rmse(t, gt, align=False)
        phase("ekf-slice", f"run {run}{' (warm-up, no host sync)' if run == 0 else ''}: "
              f"{elapsed:.4f} s, {N_FRAMES / elapsed:.2f} frames/s, "
              f"K1 launches {k1}, K2 launches {k2}, VO ok "
              f"{int(s.vo_ok.sum())}/{N_FRAMES - 1}, mean n_ic "
              f"{float(s.n_ic.float().mean()):.2f}, n_li "
              f"{float(s.n_li.float().mean()):.2f}, n_hi "
              f"{float(s.n_hi.float().mean()):.2f}, n_active "
              f"{float(s.n_active.float().mean()):.2f}, overflow "
              f"{int(s.update_overflow.sum())}, ATE {ate:.4f} m")
        if k1 != N_FRAMES - 1 or k2 != 2 * (N_FRAMES - 1):
            raise AssertionError(f"EKF slice: K1 launched {k1}, K2 {k2} "
                                 f"times; expected {N_FRAMES - 1} and "
                                 f"{2 * (N_FRAMES - 1)}")
        if not np.isfinite(t).all():
            raise AssertionError("EKF slice: non-finite trajectory")
        if abs(ate - EKF_ATE_CENTER) > EKF_ATE_HALF_WIDTH:
            raise AssertionError(f"EKF ATE {ate:.4f} m outside "
                                 f"{EKF_ATE_CENTER} ± {EKF_ATE_HALF_WIDTH}")
        if run:
            seconds.append(elapsed)
    fps = sorted(N_FRAMES / s for s in seconds)
    phase("ekf-slice", f"EKF frames/s median {statistics.median(fps):.2f}, "
          f"min {fps[0]:.2f}, max {fps[-1]:.2f} over {len(fps)} runs "
          f"(frontend + run_slam, host clock around synchronize)")
    return k1, k2


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

    # ---- 2. build ----
    build_kernels(["ransac_score", "match_stream"])

    # ---- 3. kernels vs plain on the card ----
    k1_err, k1_times = check_k1()
    k2_err, k2_times = check_k2()

    # ---- 4./5. VO slice ----
    im, gt = vo_phases()

    # ---- 6./7. EKF slice ----
    ekf_parity()
    k1, k2 = ekf_slice(im, gt)
    phase("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")

    # times at the EKF step's shapes, whose run gave the launch counts;
    # "ms" is the graph-replayed device time
    k1_t, k2_t = k1_times["512x256"], k2_times["256x256-d121"]
    print(json.dumps({"kernels": [
        {"name": "ransac_score", "route": "cuda",
         "source": "pre3_tpu_torch/csrc/ransac_score.cu",
         "replaces": "pre3_tpu/ops/ransac_score.py:45",
         "shape": "B=512, N=256", "launches": k1, "max_abs_err": k1_err,
         "ms": k1_t["device_ms"], **k1_t},
        {"name": "match_stream", "route": "cuda",
         "source": "pre3_tpu_torch/csrc/match_stream.cu",
         "replaces": "pre3_tpu/ops/matching.py:105",
         "shape": "N1=N2=256, D=121", "launches": k2, "max_abs_err": k2_err,
         "ms": k2_t["device_ms"], **k2_t},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
