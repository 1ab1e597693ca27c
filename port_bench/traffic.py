"""The traffic generator: one traffic file's parameters and ``--seed`` →
the sequences a run renders and the seeds it hands the program.

Every seed renders the same set of scenes and trajectories (``pool``
corridors, scene and trajectory seeds fixed in the traffic file), so
two seeds give the same work in another order: the seed draws the
order, each frame's sensor noise and every generator seed. A scene's
difficulty moves its ATE more than the draws do, so a seed that chose
the scenes would move the pooled ATE by more than any bound could hold.
"""

from __future__ import annotations

import numpy as np

from port_bench.render import Renders

MASK = 2**64 - 1


def derive(seed: int, *keys: int) -> int:
    """A 63-bit seed drawn from (seed, *keys)."""
    ss = np.random.SeedSequence([seed & MASK, *keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def corridor_job(scene: dict, index: int, n_frames: int, seed: int) -> dict:
    """``render_sequence`` arguments of pool corridor ``index``: the
    repo's synthetic SR4000 corridor (bench.py's at 256 frames), its
    x extent scaled with the trajectory's drift."""
    drift = scene["drift_per_frame"] * n_frames
    margin = scene["x_margin"]
    return dict(n_frames=n_frames, scene_seed=scene["scene_seed_base"] + index,
                traj_seed=scene["traj_seed_base"] + index,
                n_points=scene["n_points"], noise=scene["noise"],
                x_range=(-margin, drift + margin),
                noise_seed=derive(seed, 1, index) % 2**31)


def order(seed: int, n: int) -> list[int]:
    """The pool's order in a run: a permutation drawn from the seed."""
    rng = np.random.default_rng(derive(seed, 2))
    return [int(i) for i in rng.permutation(n)]


def generator_seed(seed: int, j: int) -> int:
    """The program's generator seed for the j-th sequence of
    a run."""
    return derive(seed, 3, j)


def sample(seed: int, n: int, k: int) -> list[int]:
    """k of range(n), drawn from the seed: what the check compares."""
    rng = np.random.default_rng(derive(seed, 4))
    return sorted(int(i) for i in rng.choice(n, size=min(k, n), replace=False))


def jobs(traffic: dict, seed: int) -> list[dict]:
    """The corridors a run renders: the ``pool`` at ``frames`` frames."""
    return [corridor_job(traffic["scene"], i, traffic["frames"], seed)
            for i in range(traffic["pool"])]


def start(traffic: dict, seed: int, workers: int = 8) -> Renders:
    """Start rendering the run's corridors (``jobs``) in the background."""
    return Renders(jobs(traffic, seed), workers)
