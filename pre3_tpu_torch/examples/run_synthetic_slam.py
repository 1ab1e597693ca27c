"""End-to-end walkthrough: synthetic SR4000 sequence → SIFT frontend → VO
→ EKF-SLAM → keyframe BA → plots + map export.

Port of ``examples/run_synthetic_slam.py``, the full-engine walkthrough
(BASELINE configs #1–#4 in one run): renders a ground-truth scene (32
frames, 400 points, noise 0.004), extracts SIFT features of every frame
in one batched call, dead-reckons VO (config #1), runs the EKF-SLAM
filter (config #3), refines keyframes with the Schur-complement BA on
the filter's observation records and smooths the corrections back onto
every frame (config #4). It writes the trajectory and stats plots (where
matplotlib imports; the run says which) and the BA map as PLY.

Run from the root of a checkout (on the card; ``--device cpu`` for the
CPU):

    python3 -m pre3_tpu_torch.examples.run_synthetic_slam [out_dir] \\
        [--frames 32] [--device cuda]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import tempfile
import time

import numpy as np
import torch

from pre3_tpu_torch.backend.ba import bundle_adjust
from pre3_tpu_torch.backend.ekf_ba import ba_problem_from_slam
from pre3_tpu_torch.backend.keyframes import select_keyframes
from pre3_tpu_torch.backend.smoothing import apply_ba_corrections
from pre3_tpu_torch.data.synthetic import render_sequence
from pre3_tpu_torch.ekf.slam import run_slam
from pre3_tpu_torch.eval.trajectory import ate_rmse, rpe_translation
from pre3_tpu_torch.eval.viz import export_ply, plot_slam_stats, plot_trajectory
from pre3_tpu_torch.frontend.pipeline import extract_features_sift
from pre3_tpu_torch.geometry.camera import sr4000_camera
from pre3_tpu_torch.vo.dead_reckoning import run_sequence


def main(out_dir: str, n_frames: int = 32,
         device: torch.device | str = "cuda") -> dict:
    """One run of the walkthrough into ``out_dir``. Returns the VO, SLAM,
    RPE and smoothed ATEs, the BA cost per iteration, the keyframes, the
    BA map's point count, the files written and each stage's seconds."""
    device = torch.device(device)
    cam = sr4000_camera()
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}")
    seconds = {}

    t0 = time.perf_counter()
    frames, traj, _ = render_sequence(n_frames=n_frames, n_points=400,
                                      noise=0.004)
    gt = (traj.t - traj.t[0]) @ traj.r[0]
    seconds["render"] = time.perf_counter() - t0
    print(f"rendered {n_frames} frames in {seconds['render']:.1f}s")

    t0 = time.perf_counter()
    feats = extract_features_sift(*(
        torch.as_tensor(np.stack([getattr(f, a) for f in frames])).to(device)
        for a in ("intensity", "xyz", "confidence")))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds["features"] = time.perf_counter() - t0
    print(f"features in {seconds['features']:.1f}s")

    # config #1: VO dead reckoning
    t0 = time.perf_counter()
    vo = run_sequence(feats, batch=1024,
                      generator=torch.Generator(device).manual_seed(0))
    ate_vo = ate_rmse(vo.t.cpu().numpy(), gt, align=False)
    seconds["vo"] = time.perf_counter() - t0
    print(f"VO: {seconds['vo']:.1f}s, ATE {ate_vo:.4f} m")

    # configs #2/#3: EKF-SLAM
    t0 = time.perf_counter()
    out = run_slam(cam, feats, n_landmarks=64,
                   generator=torch.Generator(device).manual_seed(1))
    slam_t = out.t.cpu().numpy()
    ate_slam = ate_rmse(slam_t, gt, align=False)
    rpe = rpe_translation(slam_t, gt)
    seconds["slam"] = time.perf_counter() - t0
    print(f"SLAM: {seconds['slam']:.1f}s, ATE {ate_slam:.4f} m, "
          f"RPE {rpe:.4f} m")

    # config #4: keyframes + BA on the filter-vetted observation records
    t0 = time.perf_counter()
    ks = select_keyframes(out.t, out.q,
                          torch.ones(n_frames, dtype=torch.bool,
                                     device=device), max_keyframes=10)
    prob = ba_problem_from_slam(out, ks.indices, ks.valid)
    if prob is None:
        raise RuntimeError("ba_problem_from_slam found no landmark seen "
                           "from two keyframes")
    res = bundle_adjust(cam, prob, iters=10)
    cost = res.cost.cpu().numpy()
    seconds["ba"] = time.perf_counter() - t0
    print(f"BA: {int(ks.n)} keyframes, cost {cost[0]:.3f} -> {cost[-1]:.3f}")

    # propagate keyframe corrections to every frame
    sm_t, _ = apply_ba_corrections(out.t, out.q, ks.indices, ks.valid,
                                   res.kf_t, res.kf_q)
    ate_sm = ate_rmse(sm_t.cpu().numpy(), gt, align=False)
    print(f"smoothed full-trajectory ATE: {ate_sm:.4f} m")

    written = []
    if importlib.util.find_spec("matplotlib") is not None:
        written.append(os.path.join(out_dir, "trajectory.png"))
        plot_trajectory(written[-1], slam_t, gt,
                        title=f"EKF-SLAM (ATE {ate_slam:.3f} m)")
        written.append(os.path.join(out_dir, "stats.png"))
        plot_slam_stats(written[-1], out.stats)
    else:
        print("matplotlib is not installed: no plots written")
    points = res.points.cpu().numpy()
    written.append(os.path.join(out_dir, "ba_map.ply"))
    export_ply(written[-1], points)
    print(f"wrote {', '.join(written)}")
    return dict(ate_vo=float(ate_vo), ate_slam=float(ate_slam),
                rpe_slam=float(rpe), ate_smoothed=float(ate_sm), cost=cost,
                keyframes=ks.indices[ks.valid].tolist(),
                n_points=len(points), files=written, seconds=seconds)


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return main(args.out_dir or tempfile.mkdtemp(prefix="pre3_demo_"),
                n_frames=args.frames, device=args.device)


if __name__ == "__main__":
    cli()
