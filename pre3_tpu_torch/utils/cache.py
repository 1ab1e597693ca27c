"""Disk caches for intermediate pipeline products (tiers 1–2 of SURVEY §5).

Port of ``pre3_tpu/utils/cache.py``. The reference pipelines its stages
through `.mat` caches under the dataset folder: per-frame SIFT results
(`FeatureExtractionMatching/SIFT_result%04d.mat`) and per-pair RANSAC pose
shifts (`RANSAC_pose_shift/RANSAC5_step_%d_%d.mat`), with OVERWRITE /
RECALCULATE flags controlling reuse.

Here the same two tiers are npz files of the engine's NamedTuples
(Features, VoStep), with the JAX package's directory names, file names
and fields, written by atomic rename: a cache written by either package
reads in the other. A cache hit loads onto the cache's device (the card
unless the caller names another); a miss calls ``compute()``, reads its
result back once and writes it.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.geometry.se3 import Pose
from pre3_tpu_torch.vo.dead_reckoning import VoStep

FEATURE_DIR = "FeatureExtractionMatching"  # config_file.m:40-68 dir names
VO_DIR = "RANSAC_pose_shift"


def _save_npz(path: str, arrays: dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: a crashed pass never leaves halves


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class FeatureCache:
    """Per-frame feature cache (tier 1: SIFT_result%04d analog).

    get(step, compute) returns the cached Features for `step` or calls
    `compute()` and persists the result. `overwrite=True` ignores and
    replaces existing entries (the reference's RECALCULATE flag).
    """

    def __init__(self, root: str, overwrite: bool = False,
                 device: torch.device | str = "cuda"):
        self.dir = os.path.join(root, FEATURE_DIR)
        os.makedirs(self.dir, exist_ok=True)
        self.overwrite = overwrite
        self.device = torch.device(device)

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"features_{step:04d}.npz")

    def get(self, step: int, compute: Callable[[], Features]) -> Features:
        p = self.path(step)
        if not self.overwrite and os.path.exists(p):
            with np.load(p) as z:
                return Features(**{f: torch.from_numpy(z[f]).to(self.device)
                                   for f in Features._fields})
        feats = compute()
        _save_npz(p, {f: _host(getattr(feats, f)) for f in Features._fields})
        return feats


class VoCache:
    """Per-frame-pair VO cache (tier 2: RANSAC5_step_%d_%d analog)."""

    def __init__(self, root: str, overwrite: bool = False,
                 device: torch.device | str = "cuda"):
        self.dir = os.path.join(root, VO_DIR)
        os.makedirs(self.dir, exist_ok=True)
        self.overwrite = overwrite
        self.device = torch.device(device)

    def path(self, step_pre: int, step_cur: int) -> str:
        return os.path.join(self.dir, f"vo_{step_pre}_{step_cur}.npz")

    def get(self, step_pre: int, step_cur: int,
            compute: Callable[[], VoStep]) -> VoStep:
        p = self.path(step_pre, step_cur)
        if not self.overwrite and os.path.exists(p):
            with np.load(p) as z:
                a = {k: torch.from_numpy(z[k]).to(self.device)
                     for k in ("t", "q", "ok", "n_inliers", "n_matches",
                               "cov")}
            return VoStep(delta=Pose(t=a["t"], q=a["q"]), ok=a["ok"],
                          n_inliers=a["n_inliers"],
                          n_matches=a["n_matches"], cov=a["cov"])
        step = compute()
        _save_npz(p, {
            "t": _host(step.delta.t), "q": _host(step.delta.q),
            "ok": _host(step.ok), "n_inliers": _host(step.n_inliers),
            "n_matches": _host(step.n_matches), "cov": _host(step.cov),
        })
        return step
