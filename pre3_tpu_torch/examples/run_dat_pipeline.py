"""End-to-end real-format pipeline: reference-layout `.dat` directory →
native C++ loader → OnlineSlam streaming → keyframes → Schur BA →
trajectory dumps.

Port of ``examples/run_dat_pipeline.py``: the reference's whole operating
mode (a directory of d1_NNNN.dat files, driven by a per-frame loop and
an offline keyframe pass) as one flow. The sequence is rendered and
exported into the on-disk format first (``data/export.py``), so every
byte passes through the parser. Frames are decoded by the native decoder
(``data/native_loader.py``) in ``OnlineSlam.run``'s prefetch thread while
the card runs the previous frame; the keyframes' frames are decoded again
for their features. The PNG plots are written only where matplotlib
imports; the run says which.

Run from the root of a checkout (on the card; ``--device cpu`` for the
CPU):

    python3 -m pre3_tpu_torch.examples.run_dat_pipeline [out_dir] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import tempfile

import numpy as np
import torch

from pre3_tpu_torch.backend.ba import bundle_adjust
from pre3_tpu_torch.backend.keyframes import select_keyframes
from pre3_tpu_torch.backend.smoothing import apply_ba_corrections
from pre3_tpu_torch.backend.tracks import make_ba_problem_from_tracks
from pre3_tpu_torch.data.export import export_dat_sequence
from pre3_tpu_torch.data.native_loader import (
    native_available, read_frame_native, read_sequence_native,
)
from pre3_tpu_torch.data.sr4000 import list_sequence
from pre3_tpu_torch.data.synthetic import render_sequence
from pre3_tpu_torch.ekf.slam import SlamConfig
from pre3_tpu_torch.eval.trajectory import ate_rmse
from pre3_tpu_torch.frontend.pipeline import extract_features
from pre3_tpu_torch.geometry.camera import sr4000_camera
from pre3_tpu_torch.runtime.online import OnlineSlam

FAST = {"threshold": 0.05, "max_features": 128}


def decode(path: str):
    """One frame's (intensity, xyz, confidence) by the native decoder."""
    return read_frame_native(path)[:3]


def run(data_dir: str, out_dir: str, n_frames: int = 48,
        device: torch.device | str = "cuda"):
    """Returns (online ATE, post-BA ATE), or (None, None) without ground
    truth."""
    cam = sr4000_camera()
    device = torch.device(device)

    # 1. dataset directory (render + export if absent)
    os.makedirs(data_dir, exist_ok=True)
    if not list_sequence(data_dir):
        print(f"rendering {n_frames} frames into {data_dir} ...")
        frames, traj, _ = render_sequence(
            n_frames=n_frames, n_points=400, noise=0.004
        )
        export_dat_sequence(frames, data_dir)
        gt = (traj.t - traj.t[0]) @ traj.r[0]
        np.save(os.path.join(data_dir, "gt_t.npy"), gt)
    paths = list_sequence(data_dir)
    gt_path = os.path.join(data_dir, "gt_t.npy")
    gt = np.load(gt_path) if os.path.exists(gt_path) else None

    # 2.–3. decode in the prefetch thread, stream through OnlineSlam
    print(f"decoding {len(paths)} .dat frames "
          f"(native={native_available()}) ...")
    slam = OnlineSlam(
        # initial_orientation: plane-fit gravity prior from frame 0 — the
        # reference's default startup (initialize_x_and_p.m:35-37)
        cam, cfg=SlamConfig(match_ratio=1.3, initial_orientation=True),
        n_landmarks=64, extractor_kwargs=FAST,
        generator=torch.Generator(device=device).manual_seed(0),
        device=device,
    )
    slam.run(paths, decode=decode, prefetch=2)
    ts, qs = slam.trajectory

    # 4. keyframes + BA on cross-keyframe tracks + smoothing
    t_d, q_d = torch.as_tensor(ts).to(device), torch.as_tensor(qs).to(device)
    ks = select_keyframes(t_d, q_d,
                          torch.ones(len(ts), dtype=torch.bool, device=device),
                          max_keyframes=16)
    kf_idx = ks.indices.cpu().numpy()
    kf_frames = read_sequence_native([paths[i] for i in kf_idx])
    kf_feats = extract_features(*(
        torch.as_tensor(np.stack([getattr(f, a) for f in kf_frames])).to(
            device) for a in ("intensity", "xyz", "confidence")), **FAST)
    idx = ks.indices.long()
    prob = make_ba_problem_from_tracks(kf_feats, t_d[idx], q_d[idx],
                                       ks.valid, max_tracks=128)
    res = bundle_adjust(cam, prob, iters=8)
    sm_t, _ = apply_ba_corrections(t_d, q_d, ks.indices, ks.valid,
                                   res.kf_t, res.kf_q)
    sm_t = sm_t.cpu().numpy()

    # 5. dumps
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "trajectory.npz"),
             t=ts, q=qs, t_ba=sm_t, kf_indices=kf_idx,
             kf_valid=ks.valid.cpu().numpy())
    if importlib.util.find_spec("matplotlib") is not None:
        from pre3_tpu_torch.eval.viz import plot_trajectory

        plot_trajectory(os.path.join(out_dir, "trajectory.png"), ts, gt_t=gt)
        plot_trajectory(os.path.join(out_dir, "trajectory_ba.png"), sm_t,
                        gt_t=gt, title="post-BA trajectory")
        print(f"plots written to {out_dir}")
    else:
        print("matplotlib is not installed: no plots written")

    if gt is not None:
        ate = ate_rmse(ts, gt, align=False)
        ate_ba = ate_rmse(sm_t, gt, align=False)
        print(f"online ATE {ate:.4f} m | post-BA ATE {ate_ba:.4f} m "
              f"| {int(ks.n)} keyframes | outputs in {out_dir}")
        return float(ate), float(ate_ba)
    print(f"done; outputs in {out_dir}")
    return None, None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    base = args.out_dir or tempfile.mkdtemp(prefix="pre3_dat_")
    run(os.path.join(base, "data"), os.path.join(base, "out"),
        device=args.device)


if __name__ == "__main__":
    main()
