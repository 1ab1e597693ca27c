"""Deterministic record/replay + feature-performance analysis.

Port of ``pre3_tpu/utils/replay.py`` (the reference's DATA_PLAY mode,
mono_slam.m:265-427): a recording is a checkpoint (``utils/checkpoint.py``)
plus the input feature sequence; replay re-runs the same steps from the
saved state, and the feature-performance records come straight from the
masked state counters (the FeaturePerformance/ dumps of
mono_slam.m:290-313).

The reference replays bit for bit because every draw flows from the saved
PRNG key, split once per replayed step. Here the replayed steps are
``scan_steps``' program (one graph replay per step on the card), which
loads the checkpoint's state into its carry. Here a replayed step's draws are
injected (``draws``, the same stacked ``StepDraws`` a ``run_slam`` takes)
or come from the generator state the checkpoint holds. A checkpoint the
JAX package wrote holds a threefry key, which cannot seed a
``torch.Generator``: replaying it needs ``draws``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pre3_tpu_torch.ekf.slam import (
    SlamConfig, StepDraws, StepStats, _frame, scan_steps,
)
from pre3_tpu_torch.ekf.state import EkfState
from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.utils.checkpoint import load_state


class FeaturePerformance(NamedTuple):
    """Per-landmark tracking statistics (FeaturePerformance analog)."""

    slot: np.ndarray  # [M] landmark slot index
    times_predicted: np.ndarray  # [M]
    times_measured: np.ndarray  # [M]
    track_ratio: np.ndarray  # [M] measured / max(predicted, 1)
    age: np.ndarray  # [M] frames since init
    is_inverse_depth: np.ndarray  # [M]


def feature_performance(state: EkfState, step: int) -> FeaturePerformance:
    """The active landmarks' counters (read back from the state's device
    once)."""
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    active = host(state.active)
    slots = np.nonzero(active)[0]
    tp = host(state.times_predicted)[slots]
    tm = host(state.times_measured)[slots]
    return FeaturePerformance(
        slot=slots,
        times_predicted=tp,
        times_measured=tm,
        track_ratio=tm / np.maximum(tp, 1),
        age=step - host(state.init_frame)[slots],
        is_inverse_depth=host(state.is_id)[slots],
    )


def replay_sequence(
    cam_model,
    feats: Features,  # stacked over frames, leading axis F
    checkpoint_path: str,
    cfg: SlamConfig | None = None,
    n_frames: int | None = None,
    draws: StepDraws | None = None,  # stacked over steps 1..F-1
) -> tuple[list[tuple[np.ndarray, np.ndarray]], EkfState, list[StepStats]]:
    """Resume a SLAM run from a checkpoint and re-run the remaining frames
    deterministically (same state + same draws ⇒ identical trajectory).
    Runs on the features' device, through the steps ``run_slam`` runs,
    without per-frame images, as the reference replays. ``draws``: row
    k-1 holds step k's (the attitude update's ``heading`` is not used).

    Returns (list of (t, q) per replayed step as numpy, final state,
    per-step StepStats)."""
    cfg = cfg or SlamConfig()
    device = feats.uv.device
    state, start, gen_state, _ = load_state(checkpoint_path, device)
    total = feats.uv.shape[0] if n_frames is None else n_frames
    generator = None
    if draws is None:
        if gen_state is None:
            raise ValueError(
                f"{checkpoint_path} holds no torch.Generator state (a "
                "checkpoint of the JAX package holds a threefry key): pass "
                "the replayed steps' draws")
        generator = torch.Generator(device=device)
        generator.set_state(gen_state)
    else:
        draws = StepDraws(*(None if d is None else d[start:total - 1]
                            for d in draws))
    if start + 1 >= total:
        return [], state, []
    rest = Features(*(x[start + 1:total] for x in feats))
    steps = torch.arange(start + 1, total, dtype=torch.int32, device=device)
    state, (ts, qs, stats, _) = scan_steps(
        cam_model, state, _frame(feats, start), rest, steps, cfg,
        draws=draws, generator=generator, first_step=start + 1)
    ts, qs = ts.cpu().numpy(), qs.cpu().numpy()
    traj = [(ts[i], qs[i]) for i in range(len(ts))]
    return traj, state, [StepStats(*(x[i] for x in stats))
                         for i in range(len(ts))]
