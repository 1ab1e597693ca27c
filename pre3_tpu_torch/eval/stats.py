"""Run-level statistics aggregation — the StatData analog, done as data.

The reference accumulates a global `StatData` struct (mono_slam.m:37-38,
ransac_hypotheses.m:84-85, matching_sift_based.m:198-200, RANSAC_STAT in
vodometry_dr_ye.m:13-23) and renders it with plot_ransac_statistics.m.
Here the per-step StepStats pytree (ekf/slam.py) is the single source;
this module reduces it to the same aggregate quantities as a plain dict
(JSON-able, assertable in tests) and a printable report.

Port of ``pre3_tpu/eval/stats.py``: the same reductions, in numpy. The
port's StepStats hold tensors on the card, which ``np.asarray`` cannot
read, so each field is read back explicitly, once (``host_field``).
"""

from __future__ import annotations

import numpy as np
import torch


def host_field(stats, name: str, default=None) -> np.ndarray:
    """A field of a stats record as a host array (a tensor on any device
    is copied back; numpy and Python values pass through)."""
    v = getattr(stats, name, default)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def summarize_stats(stats) -> dict:
    """Aggregate a StepStats pytree (leading axis = steps) into the
    plot_ransac_statistics.m panel quantities."""
    g = lambda name: host_field(stats, name)  # noqa: E731
    n_ic = g("n_ic")
    n_li = g("n_li")
    n_hi = g("n_hi")
    inl = n_li + n_hi
    vo_ok = g("vo_ok").astype(bool)
    steps = int(n_ic.shape[0])
    with np.errstate(divide="ignore", invalid="ignore"):
        inlier_ratio = np.where(n_ic > 0, inl / np.maximum(n_ic, 1), 0.0)
    return {
        "steps": steps,
        "ic_matches_mean": float(n_ic.mean()),
        "ic_matches_min": int(n_ic.min()),
        "li_inliers_mean": float(n_li.mean()),
        "hi_inliers_mean": float(n_hi.mean()),
        "inlier_ratio_mean": float(inlier_ratio.mean()),
        "map_size_mean": float(g("n_active").mean()),
        "map_size_final": int(g("n_active")[-1]),
        "visible_mean": float(g("n_visible").mean()),
        "vo_ok_rate": float(vo_ok.mean()),
        "vo_inliers_mean": float(g("vo_inliers").mean()),
        "steps_without_update": int((inl == 0).sum()),
        # inliers silently dropped by an under-provisioned
        # max_update_slots bound — 0 means the bounded update was exact
        # on every step (ekf/update.py kalman_update)
        "update_overflow_total": int(
            host_field(stats, "update_overflow", 0).sum()
        ),
    }


def stats_report(stats) -> str:
    """Console dashboard (the cprintf/disp logging of the reference)."""
    s = summarize_stats(stats)
    lines = [f"{'metric':<24}{'value':>12}"]
    for k, v in s.items():
        lines.append(
            f"{k:<24}{v:>12.3f}" if isinstance(v, float)
            else f"{k:<24}{v:>12}"
        )
    return "\n".join(lines)
