"""Visualization & diagnostics dumps.

Host-side replacement for the reference's MATLAB graphics layer
(plots_complete.m, plots.m, plot_ransac_statistics.m:26-269,
plot_feature_performacne.m, draw_camera.m): trajectory plots, per-step
statistics dashboards, and map/point-cloud exports. Saves files instead of
opening windows (headless-friendly); the 53.7k-line Ford LCM viewer is out
of scope per SURVEY §2.3 (map/trajectory dumps + standard viewers suffice).

Port of ``pre3_tpu/eval/viz.py``: the plots and ``export_ply`` are its
numpy code; matplotlib stays a lazy import (``_mpl``), so a host without
it can import this module and export maps. The stats dashboard reads
StepStats tensors from any device, and ``export_map_ply`` the port's
EkfState.
"""

from __future__ import annotations

import os

import numpy as np

from pre3_tpu_torch.eval.stats import host_field


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(
    path: str,
    est_t: np.ndarray,
    gt_t: np.ndarray | None = None,
    title: str = "trajectory",
) -> None:
    """Top-down (x-z) + height profile, est vs optional ground truth
    (the plots_complete.m trajectory panel)."""
    plt = _mpl()
    est_t = np.asarray(est_t)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    ax = axes[0]
    ax.plot(est_t[:, 0], est_t[:, 2], "b.-", label="estimate", ms=3)
    if gt_t is not None:
        gt_t = np.asarray(gt_t)
        ax.plot(gt_t[:, 0], gt_t[:, 2], "k--", label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    ax.set_title(title)
    ax = axes[1]
    ax.plot(est_t[:, 1], "b.-", label="est y", ms=3)
    if gt_t is not None:
        ax.plot(gt_t[:, 1], "k--", label="gt y")
    ax.set_xlabel("frame")
    ax.set_ylabel("y [m]")
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_slam_stats(path: str, stats, title: str = "per-step stats") -> None:
    """Dashboard of the StepStats record (the plot_ransac_statistics.m
    analog): match/inlier counts, map size, VO health."""
    plt = _mpl()
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    g = lambda name: host_field(stats, name)  # noqa: E731
    ax = axes[0, 0]
    ax.plot(g("n_ic"), label="IC matches")
    ax.plot(g("n_li"), label="li inliers")
    ax.plot(g("n_hi"), label="hi inliers")
    ax.legend()
    ax.set_title("matching / 1-pt RANSAC")
    ax = axes[0, 1]
    ax.plot(g("n_active"), label="map landmarks")
    ax.plot(g("n_visible"), label="predicted visible")
    ax.legend()
    ax.set_title("map")
    ax = axes[1, 0]
    ax.plot(g("vo_inliers"), label="VO inliers")
    ax.legend()
    ax.set_title("VO")
    ax = axes[1, 1]
    ax.plot(g("vo_ok").astype(int), "r.-", label="VO ok")
    ax.set_ylim(-0.1, 1.1)
    ax.legend()
    ax.set_title("VO validity")
    fig.suptitle(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_feature_performance(path: str, perf,
                             title: str = "feature performance") -> None:
    """Per-landmark tracking statistics dashboard — the
    plot_feature_performacne.m / FeaturePerformance dumps analog
    (mono_slam.m:290-313). Takes a utils.replay.FeaturePerformance."""
    plt = _mpl()
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    ax = axes[0]
    ax.scatter(perf.times_predicted, perf.times_measured, s=14)
    lim = max(1, int(np.max(perf.times_predicted, initial=1)))
    ax.plot([0, lim], [0, lim], "k--", lw=0.8)
    ax.plot([0, lim], [0, 0.5 * lim], "r--", lw=0.8, label="deletion gate")
    ax.set_xlabel("times predicted")
    ax.set_ylabel("times measured")
    ax.legend()
    ax.set_title("tracking support")
    ax = axes[1]
    ax.hist(perf.track_ratio, bins=20, range=(0, 1.05))
    ax.set_xlabel("measured / predicted")
    ax.set_title("track ratio")
    ax = axes[2]
    ax.hist(perf.age, bins=20)
    ax.set_xlabel("age [frames]")
    ax.set_title("landmark age")
    fig.suptitle(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def export_ply(path: str, points: np.ndarray,
               colors: np.ndarray | None = None) -> None:
    """Write a point cloud as ASCII PLY (viewable in any standard tool —
    the lightweight alternative to the vendored LCM viewer)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]:.5f} {points[i, 1]:.5f} {points[i, 2]:.5f}"
            if colors is not None:
                c = np.clip(colors[i] * 255, 0, 255).astype(int)
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")


def export_map_ply(path: str, state) -> None:
    """Dump the EKF map (active landmarks as world points) to PLY. The
    state's tensors may lie on any device: the points are computed there
    and read back once."""
    import torch

    from pre3_tpu_torch.geometry.inverse_depth import (
        inverse_depth_to_cartesian,
    )

    lms = state.landmarks
    pts = torch.where(state.is_id[:, None], inverse_depth_to_cartesian(lms),
                      lms[:, :3])
    export_ply(path, pts[state.active].cpu().numpy())
