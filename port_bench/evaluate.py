"""ATE: position RMSE without alignment, the recipe of ``bench.py`` and
the port's ``eval/trajectory.py::ate_rmse(align=False)`` (a copy); and
the set-up's notes."""

from __future__ import annotations

import sys
import time

import numpy as np


def note(t_start: float, what: str) -> None:
    """A set-up step's end, in seconds since the run started, on
    standard error."""
    print(f"setup {time.perf_counter() - t_start:8.3f} s: {what}",
          file=sys.stderr, flush=True)


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray) -> float:
    """RMSE between estimated and ground-truth camera centres [F, 3]."""
    err = np.asarray(est_t, np.float64) - np.asarray(gt_t, np.float64)
    return float(np.sqrt((err**2).sum(-1).mean()))


def pooled_ate(pairs: list) -> float:
    """ATE over every frame of several (estimate, ground truth)
    trajectories pooled: the RMSE over all their frames together."""
    est = np.concatenate([np.asarray(e, np.float64) for e, _ in pairs])
    gt = np.concatenate([np.asarray(g, np.float64) for _, g in pairs])
    return ate_rmse(est, gt)
