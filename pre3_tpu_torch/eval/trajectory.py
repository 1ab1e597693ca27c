"""Trajectory evaluation: ATE / RPE metrics.

The reference has only hand-logged per-step error tables
(Modified_RANSAC/TestResults_*.m); this provides the standard metrics the
BASELINE targets are stated in: absolute trajectory error (ATE-RMSE, after
SE(3)/Sim(3) alignment, Horn/Umeyama) and relative pose error (RPE).
Host-side numpy — evaluation is offline.
"""

from __future__ import annotations

import numpy as np


def align_umeyama(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = False
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity/rigid alignment gt ≈ s·R·est + t."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / len(est)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    if with_scale:
        var_e = (ec**2).sum() / len(est)
        scale = float(np.trace(np.diag(d) @ s) / var_e)
    else:
        scale = 1.0
    t = mu_g - scale * r @ mu_e
    return r, t, scale


def ate_rmse(
    est_t: np.ndarray, gt_t: np.ndarray, align: bool = True
) -> float:
    """ATE-RMSE between estimated and ground-truth camera centers [F, 3]."""
    est_t = np.asarray(est_t, np.float64)
    gt_t = np.asarray(gt_t, np.float64)
    if align:
        r, t, s = align_umeyama(est_t, gt_t)
        est_t = est_t @ (s * r).T + t
    err = est_t - gt_t
    return float(np.sqrt((err**2).sum(-1).mean()))


def rpe_translation(
    est_t: np.ndarray, gt_t: np.ndarray, delta: int = 1
) -> float:
    """RMS per-step relative translation error (the reference's
    TestResults_2.m per-step error metric, computed properly)."""
    de = est_t[delta:] - est_t[:-delta]
    dg = gt_t[delta:] - gt_t[:-delta]
    err = np.linalg.norm(de - dg, axis=-1)
    return float(np.sqrt((err**2).mean()))
