"""Offline keyframing walkthrough, end to end with resumable caches:

  render sequence → `.dat` export → (cached) feature extraction →
  (cached) VO against the last accepted keyframe → keyframe acceptance
  (4° / 0.05 m) → renumbered KeyFrames/ dataset export → keyframe BA on
  tracks → correction smoothing.

Port of ``examples/run_offline_keyframing.py`` (24 frames, 400 points,
noise 0.003, 0.04 m per frame). The port's pass also exports the
rendered frames as `d1_NNNN.dat` and hands that directory to
``export_keyframe_dataset``, so KeyFrames/ holds the renumbered frames
beside the features and the manifest. Re-running with the same work_dir
resumes from the npz caches (``utils/cache.py``): the keyframe search
then reads every pair's VO from disk and launches nothing.

Run from the root of a checkout (on the card; ``--device cpu`` for the
CPU):

    python3 -m pre3_tpu_torch.examples.run_offline_keyframing [work_dir] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from pre3_tpu_torch.backend.ba import bundle_adjust
from pre3_tpu_torch.backend.keyframes import (
    export_keyframe_dataset, find_keyframes_vo,
)
from pre3_tpu_torch.backend.smoothing import apply_ba_corrections
from pre3_tpu_torch.backend.tracks import make_ba_problem_from_tracks
from pre3_tpu_torch.data.export import export_dat_sequence
from pre3_tpu_torch.data.sr4000 import list_sequence
from pre3_tpu_torch.data.synthetic import render_sequence
from pre3_tpu_torch.eval.trajectory import ate_rmse
from pre3_tpu_torch.frontend.pipeline import Features, extract_features
from pre3_tpu_torch.geometry.camera import sr4000_camera
from pre3_tpu_torch.utils.cache import FeatureCache, VoCache
from pre3_tpu_torch.vo.dead_reckoning import run_sequence


def _features(frame, device) -> Features:
    arrays = (frame.intensity, np.nan_to_num(frame.xyz), frame.confidence)
    out = extract_features(*(torch.as_tensor(a)[None].to(device)
                             for a in arrays), threshold=0.05,
                           max_features=256)
    return Features(*(x[0] for x in out))


def main(work_dir: str, n_frames: int = 24,
         device: torch.device | str = "cuda") -> dict:
    """One pass over ``work_dir`` (cold, or warm from its caches). Returns
    the keyframes (OfflineKeyframes), the VO and post-BA ATEs and the
    seconds of each stage."""
    device = torch.device(device)
    os.makedirs(work_dir, exist_ok=True)
    cam = sr4000_camera()
    frames, traj, _ = render_sequence(
        n_frames=n_frames, n_points=400, noise=0.003, step_t=0.04
    )
    gt = (traj.t - traj.t[0]) @ traj.r[0]
    data_dir = os.path.join(work_dir, "data")
    if not (os.path.isdir(data_dir) and list_sequence(data_dir)):
        export_dat_sequence(frames, data_dir)
    seconds = {}

    # cached per-frame features (tier 1)
    t0 = time.perf_counter()
    fcache = FeatureCache(work_dir, device=device)
    feats = [fcache.get(i, lambda f=f: _features(f, device))
             for i, f in enumerate(frames)]
    feats = Features(*(torch.stack(xs) for xs in zip(*feats)))
    seconds["features"] = time.perf_counter() - t0
    print(f"features (cached): {seconds['features']:.1f}s")

    # offline keyframe pass with cached pair VO (tier 2)
    t0 = time.perf_counter()
    kf = find_keyframes_vo(
        feats, vo_cache=VoCache(work_dir, device=device), batch=512,
        generator=torch.Generator(device=device).manual_seed(0))
    seconds["keyframes"] = time.perf_counter() - t0
    print(f"keyframes {kf.indices.tolist()} "
          f"({kf.n_vo_calls} VO calls, {seconds['keyframes']:.1f}s)")

    out = export_keyframe_dataset(
        kf.indices, os.path.join(work_dir, "KeyFrames"), src_dir=data_dir,
        feats=feats, deltas=kf,
    )
    print(f"exported keyframe dataset → {out}")

    # full-sequence VO for the non-keyframe poses
    t0 = time.perf_counter()
    vo = run_sequence(feats, batch=1024,
                      generator=torch.Generator(device=device).manual_seed(1))
    ate_vo = ate_rmse(vo.t.cpu().numpy(), gt, align=False)

    # keyframe BA on multi-view tracks + smoothing back onto all frames
    kf_idx = torch.as_tensor(kf.indices).to(device)
    kf_valid = torch.ones(len(kf.indices), dtype=torch.bool, device=device)
    kf_feats = Features(*(x[kf_idx] for x in feats))
    prob = make_ba_problem_from_tracks(kf_feats, vo.t[kf_idx], vo.q[kf_idx],
                                       kf_valid)
    res = bundle_adjust(cam, prob, iters=10)
    sm_t, _ = apply_ba_corrections(vo.t, vo.q, kf_idx, kf_valid, res.kf_t,
                                   res.kf_q)
    ate_ba = ate_rmse(sm_t.cpu().numpy(), gt, align=False)
    seconds["vo+ba"] = time.perf_counter() - t0
    cost = res.cost.cpu().numpy()
    print(f"ATE: VO {ate_vo:.4f} m → BA+smoothing {ate_ba:.4f} m "
          f"(cost {cost[0]:.4f} → {cost[-1]:.4f})")
    return dict(keyframes=kf, ate_vo=float(ate_vo), ate_ba=float(ate_ba),
                cost=cost, seconds=seconds, keyframe_dir=out)


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("work_dir", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    main(args.work_dir or tempfile.mkdtemp(prefix="pre3_keyframing_"),
         device=args.device)


if __name__ == "__main__":
    cli()
