"""ATE band of config #3 (SIFT → run_slam) from the JAX package on the CPU.

The port's smoke run holds its SIFT EKF slice to the JAX reference's
accuracy on the same sequence and configuration: bench.py's corridor
(256 frames, 832 points, noise 0.004, x from -1.8 to 5.64), the SIFT
frontend's exact branch, K = 256 landmark slots and
SlamConfig(min_measured=50, max_update_slots=96), no xyz images (no plane
fit). This script runs it for keys 0..6 and prints the ATE (no alignment)
of each, as bench.py computes its ``slam_ate_rmse_m``.

    PYTHONPATH=. JAX_PLATFORMS=cpu python3 tools/jax_sift_ate_band.py [--keys 7]

from the root of a checkout (about 5 minutes on a CPU).

The frontend runs one frame per call (one compiled program), so the peak
memory stays that of a single frame's SIFT plus the scan.
"""

from __future__ import annotations

import argparse
import os
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["PRE3_SIFT_FAST_MATH"] = "0"  # the exact branch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pre3_tpu.data.synthetic import render_sequence  # noqa: E402
from pre3_tpu.ekf.slam import SlamConfig, run_slam  # noqa: E402
from pre3_tpu.eval.trajectory import ate_rmse  # noqa: E402
from pre3_tpu.frontend.pipeline import extract_features_sift  # noqa: E402
from pre3_tpu.geometry.camera import sr4000_camera  # noqa: E402

N_FRAMES, N_LANDMARKS = 256, 256
CFG = SlamConfig(min_measured=50, max_update_slots=96)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=7)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    drift = 0.03 * 0.5 * N_FRAMES
    frames, traj, _ = render_sequence(n_frames=N_FRAMES, n_points=832,
                                      noise=0.004, x_range=(-1.8, drift + 1.8))
    gt = (traj.t - traj.t[0]) @ traj.r[0]
    fe = jax.jit(extract_features_sift)
    t0 = time.perf_counter()
    per_frame = [jax.tree.map(np.asarray, fe(
        jnp.asarray(f.intensity), jnp.asarray(np.nan_to_num(f.xyz)),
        jnp.asarray(f.confidence))) for f in frames]
    feats = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *per_frame)
    print(f"frontend: {time.perf_counter() - t0:.1f} s for {N_FRAMES} "
          f"frames, valid keypoints per frame "
          f"{float(np.asarray(feats.valid).sum(-1).mean()):.1f}", flush=True)
    run = jax.jit(lambda f, k: run_slam(sr4000_camera(), f, k, cfg=CFG,
                                        n_landmarks=N_LANDMARKS))
    ates = []
    for key in range(args.keys):
        t0 = time.perf_counter()
        out = run(feats, jax.random.PRNGKey(key))
        ate = float(ate_rmse(np.asarray(out.t), gt, align=False))
        ates.append(ate)
        s = out.stats
        print(f"key {key}: ATE {ate:.4f} m, mean n_ic "
              f"{float(np.asarray(s.n_ic).mean()):.2f}, n_li "
              f"{float(np.asarray(s.n_li).mean()):.2f}, n_active "
              f"{float(np.asarray(s.n_active).mean()):.2f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"ATE over keys 0..{args.keys - 1}: min {min(ates):.4f}, max "
          f"{max(ates):.4f}, mean {np.mean(ates):.4f} m", flush=True)


if __name__ == "__main__":
    main()
