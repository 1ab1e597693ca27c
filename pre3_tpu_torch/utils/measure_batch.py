"""Multi-sequence SLAM throughput: the port's tools/measure_batch.py.

B independent corridor sequences, distinct scenes and trajectories
(``render_sequence(n_frames=F, n_points=832, noise=0.004, x_range=(-1.8,
0.015·F + 1.8), scene_seed=b, traj_seed=100 + b)``), go through
``extract_features_sift`` over all B·F frames at once (its 64-frame
chunks) and ``run_slam_batched`` at K=256 with
``SlamConfig(min_measured=50, max_update_slots=96)``: each step is one
``torch.func.vmap(slam_step)`` over the B sequences, each sequence with
its own ``torch.Generator``, captured once into a CUDA graph and
replayed (``utils/graphs.py``). The reference maps its frontend over the
sequences and vmaps its jitted ``run_slam``.

For each B, after one warm-up run: aggregate and per-sequence frames/s
(frontend + SLAM, host clock around a synchronize, median of ``--reps``),
the frontend's share, host ms per step (``run_slam_batched``'s time over
F−1 steps, the B bootstraps included), ATE mean and max (no alignment),
K1 and K2 launches per step (counted on the device by the kernels), the
peak device memory of the last timed run's frontend and SLAM stages,
and from the F−1 steps profiled after their bootstraps
(``scan_steps_batched`` on the last timed run's features,
``torch.profiler``) the host-issued launches (copies, draw runs, a graph
replay per step) and device busy time per step and that run's idle
share, 1 − busy / its wall time. On the CPU the device figures are not
measured.

    python3 -m pre3_tpu_torch.utils.measure_batch [n_frames] [K] \\
        [batches...] [--device cuda|cpu] [--reps N]

Defaults: 256 frames, K=256, B ∈ {1, 4, 8, 16}, on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import time

import numpy as np
import torch

from pre3_tpu_torch.data.synthetic import render_sequence
from pre3_tpu_torch.ekf.slam import (
    SlamConfig, bootstrap_batched, run_slam_batched, scan_steps_batched,
)
from pre3_tpu_torch.eval.trajectory import ate_rmse
from pre3_tpu_torch.frontend.pipeline import (
    Features, extract_features_sift, extract_sequences,
)
from pre3_tpu_torch.geometry.camera import sr4000_camera
from pre3_tpu_torch.ops.matching import match_descriptors_k2
from pre3_tpu_torch.ops.ransac_score import score_hypotheses

N_LANDMARKS = 256
CFG = SlamConfig(min_measured=50, max_update_slots=96)


def render_batch(n_frames: int, n_seq: int):
    """The B corridor sequences: numpy (intensity, xyz, confidence), each
    [B, F, ...] (xyz without NaNs), and the ground-truth positions [F, 3]
    of each sequence in its first camera's frame."""
    drift = 0.03 * 0.5 * n_frames
    seqs, gts = [], []
    for b in range(n_seq):
        frames, traj, _ = render_sequence(
            n_frames=n_frames, n_points=832, noise=0.004,
            x_range=(-1.8, drift + 1.8), scene_seed=b, traj_seed=100 + b)
        seqs.append([np.stack([f.intensity for f in frames]),
                     np.nan_to_num(np.stack([f.xyz for f in frames])),
                     np.stack([f.confidence for f in frames])])
        gts.append((traj.t - traj.t[0]) @ traj.r[0])
    return [np.stack(x) for x in zip(*seqs)], gts


def generators(n_seq: int, seed: int, device) -> list[torch.Generator]:
    """One generator per sequence, seeded from (seed, sequence)."""
    return [torch.Generator(device).manual_seed(1000 * seed + s)
            for s in range(n_seq)]


@contextlib.contextmanager
def sync_checked(on: bool):
    """Inside, a host sync on the card raises (``on`` only)."""
    if on:
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        if on:
            torch.cuda.set_sync_debug_mode("default")


def pipeline(images, n_landmarks: int, seed: int, cam=None,
             check: bool = False, peaks: dict | None = None):
    """Frontend over the B·F frames, then run_slam_batched: (trajectory,
    features, frontend seconds, SLAM seconds), each time on the host
    clock around a synchronize. With ``check`` a host sync inside either
    call raises. On the card ``peaks`` gets each stage's peak device
    memory in MiB (``frontend``, ``slam``) and the memory reserved after
    the frontend (``frontend_reserved``: its programs' graph pool and
    buffers and the allocator's cache, which the allocated peak does not
    see)."""
    cam = sr4000_camera() if cam is None else cam
    device = images[0].device
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    peak = cuda and peaks is not None

    def stage_peak(name):
        if peak:
            peaks[name] = torch.cuda.max_memory_allocated() / 2**20
            torch.cuda.reset_peak_memory_stats()

    sync()
    stage_peak("before")
    t0 = time.perf_counter()
    with sync_checked(check and cuda):
        feats = extract_sequences(extract_features_sift, *images)
    sync()
    t1 = time.perf_counter()
    stage_peak("frontend")
    if peak:
        peaks["frontend_reserved"] = torch.cuda.memory_reserved() / 2**20
    gens = generators(len(images[0]), seed, device)
    with sync_checked(check and cuda):
        out = run_slam_batched(cam, feats, CFG, n_landmarks=n_landmarks,
                               generators=gens)
    sync()
    t2 = time.perf_counter()
    stage_peak("slam")
    return out, feats, t1 - t0, t2 - t1


def profile_step(feats: Features, n_landmarks: int):
    """(launches, device busy ms, idle share) per batched step: the F−1
    steps of ``run_slam_batched`` on ``feats`` ([S, F, ...]) after their
    bootstraps (``scan_steps_batched``: the per-call and per-block
    copies, the draw runs and a graph replay per step), profiled; the
    idle share is that run's, 1 − busy / its wall time."""
    from pre3_tpu_torch.utils.profile_slice import _profiled

    cam = sr4000_camera()
    n_seq, n_frames = feats.uv.shape[:2]
    gens = generators(n_seq, 0, feats.uv.device)
    state = bootstrap_batched(cam, Features(*(x[:, 0] for x in feats)), CFG,
                              n_landmarks, generators=gens)
    steps = n_frames - 1
    launches, busy_us, wall, _ = _profiled(lambda: scan_steps_batched(
        cam, state, feats, CFG, n_landmarks, generators=gens))
    return (launches / steps, busy_us / 1e3 / steps,
            1.0 - busy_us / 1e6 / wall)


def measure(images, gts, n_landmarks: int = N_LANDMARKS, reps: int = 3,
            sync_check: bool = False, warmup: bool = True) -> dict:
    """One B: a warm-up run, ``reps`` timed runs (the last with host
    syncs raising when ``sync_check``), and on the card the profiled
    launches and device busy per step. Returns the figures as a dict;
    ``trajectory`` is the last timed run's, whose K1 and K2 launches are
    counted from 0."""
    n_seq, n_frames = images[0].shape[:2]
    steps = n_frames - 1
    cuda = images[0].device.type == "cuda"
    if warmup:
        pipeline(images, n_landmarks, seed=0)
    walls, fronts, slams, peaks = [], [], [], {}
    for r in range(reps):
        score_hypotheses.launches = match_descriptors_k2.launches = 0
        out, feats, t_fe, t_slam = pipeline(
            images, n_landmarks, seed=r + 1,
            check=sync_check and r == reps - 1, peaks=peaks)
        walls.append(t_fe + t_slam)
        fronts.append(t_fe)
        slams.append(t_slam)
    k1, k2 = score_hypotheses.launches, match_descriptors_k2.launches
    wall = statistics.median(walls)
    t = out.t.cpu().numpy()
    ates = [float(ate_rmse(t[b], gts[b], align=False)) for b in range(n_seq)]
    res = dict(
        batch=n_seq, frames=n_frames, landmarks=n_landmarks,
        aggregate_fps=n_seq * n_frames / wall, per_seq_fps=n_frames / wall,
        wall_s=wall, frontend_share=statistics.median(fronts) / wall,
        host_ms_per_step=1e3 * statistics.median(slams) / steps,
        ate_mean=float(np.mean(ates)), ate_max=float(np.max(ates)),
        ates=ates, k1_per_step=k1 / steps, k2_per_step=k2 / steps,
        k1=k1, k2=k2, valid_per_frame=float(
            feats.valid.sum(-1).float().mean()),
        peak_mib=None, frontend_peak_mib=None, slam_peak_mib=None,
        frontend_reserved_mib=None,
        launches_per_step=None, busy_ms_per_step=None, idle_share=None,
        trajectory=out)
    if cuda:
        res.update(peak_mib=max(peaks["frontend"], peaks["slam"]),
                   frontend_peak_mib=peaks["frontend"],
                   frontend_reserved_mib=peaks["frontend_reserved"],
                   slam_peak_mib=peaks["slam"])
        launches, busy, idle = profile_step(feats, n_landmarks)
        res.update(launches_per_step=launches, busy_ms_per_step=busy,
                   idle_share=idle)
    return res


def describe(res: dict) -> str:
    def fmt(key, spec, unit=""):
        if res[key] is None:
            return "not measured"
        return format(res[key], spec) + unit

    return (f"B={res['batch']:2d}: aggregate {res['aggregate_fps']:.2f} "
            f"frames/s ({res['per_seq_fps']:.2f} per sequence; frontend "
            f"{res['frontend_share']:.1%}), host {res['host_ms_per_step']:.1f}"
            f" ms per step; ATE mean {res['ate_mean']:.4f} max "
            f"{res['ate_max']:.4f} m; K1 {res['k1_per_step']:.2f} and K2 "
            f"{res['k2_per_step']:.2f} launches per step; launches per step "
            f"{fmt('launches_per_step', '.1f')}; device busy "
            f"{fmt('busy_ms_per_step', '.3f', ' ms')} per step; idle share "
            f"{fmt('idle_share', '.4f')}; peak memory "
            f"{fmt('peak_mib', '.1f', ' MiB')} (frontend "
            f"{fmt('frontend_peak_mib', '.1f', ' MiB')}, "
            f"{fmt('frontend_reserved_mib', '.1f', ' MiB')} reserved after "
            f"it, SLAM "
            f"{fmt('slam_peak_mib', '.1f', ' MiB')}, the last timed run)")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=256)
    ap.add_argument("k", nargs="?", type=int, default=N_LANDMARKS)
    ap.add_argument("batches", nargs="*", type=int, default=[1, 4, 8, 16])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("measure_batch: no CUDA device; --device cpu "
                             "runs it on the CPU")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    host, gts = render_batch(args.n_frames, max(args.batches))
    print(f"rendered {max(args.batches)}x{args.n_frames} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    results = []
    for b in args.batches:
        images = [torch.as_tensor(x[:b], device=device) for x in host]
        res = measure(images, gts[:b], args.k, args.reps)
        print(describe(res), flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    main()
