"""ATE bands of the port's slices from the JAX package on the CPU.

The port's smoke run holds its slices to the JAX reference's accuracy on
the same sequences and configurations. This script runs one of them for
keys 0..N-1 and prints the ATE (no alignment) of each, as bench.py
computes it. ``--config`` picks the slice:

  sift  config #3 as bench.py headlines it: bench.py's corridor (256
        frames, 832 points, noise 0.004, x from -1.8 to 5.64), the SIFT
        frontend's exact branch, K = 256 landmark slots and
        SlamConfig(min_measured=50, max_update_slots=96), no xyz images
        (no plane fit); ``slam_ate_rmse_m``;
  ncc   config #2 (bench.py ``fast_ncc_pipeline``): the same corridor,
        FAST at threshold 0.05 with 256 features, the warped-patch NCC
        matcher (ratio 1.3) with every frame's intensity and xyz image
        given (plane-fit prior on); ``slam_fast_ncc_ate_rmse_m``;
  ba    config #4 on the sift run: select_keyframes(max_keyframes=64) →
        ba_problem_from_slam(max_landmarks=512) → bundle_adjust(iters=10)
        → apply_ba_corrections; the post-BA ATE (``ba_ate_rmse_m``);
  loop  bench.py's out-and-back scene (256 frames, 600 points, x from
        -1.8 to 3.72, loop=True) through the sift run: the SLAM ATE, the
        post-BA ATE of bench.py's chain (``loop_ba_ate_rmse_m``), and the
        post-BA ATE with the keyframe tracks merged
        (``ba_problem_from_slam(kf_feats=...)``) and the mined keyframe
        loop closures added (``mine_keyframe_loop_closures`` +
        ``merge_lcp``, tools/measure_lcp.py's chain);
  dat   examples/run_dat_pipeline.py's chain with the key as its
        OnlineSlam key: 48 frames (400 points, noise 0.004) exported as
        d1_NNNN.dat and decoded by the numpy parser, OnlineSlam (FAST at
        0.05 with 128 features, K = 64, SlamConfig(match_ratio=1.3,
        initial_orientation=True)), then select_keyframes(16) →
        make_ba_problem_from_tracks(max_tracks=128) → bundle_adjust(8) →
        apply_ba_corrections; the online and the post-BA ATE;
  batch the multi-sequence path's corridors
        (pre3_tpu_torch/utils/measure_batch.py, the reference's
        tools/measure_batch.py): ``--sequences`` corridors of
        ``--frames`` frames (832 points, noise 0.004, x from -1.8 to
        0.015·F + 1.8, scene_seed=b, traj_seed=100 + b), the sift run on
        each; the ATE per sequence and over all of them.

The SIFT frontend runs its exact branch unless ``--fast-math`` is given,
which sets ``PRE3_SIFT_FAST_MATH=1`` (bf16 band filters and descriptor
taps, ``approx_max_k``) before anything is traced.

Run it from the root of a checkout:

    PYTHONPATH=. JAX_PLATFORMS=cpu python3 tools/jax_sift_ate_band.py \\
        [--config sift|ncc|ba|loop|dat|batch] [--keys 7] \\
        [--frames 32 --sequences 16] [--fast-math]

(a few minutes per configuration on a CPU). The SIFT frontend runs one
frame per call (one compiled program), so the peak memory stays that of
a single frame's SIFT plus the scan.
"""

from __future__ import annotations

import argparse
import os
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pre3_tpu.backend.ba import bundle_adjust  # noqa: E402
from pre3_tpu.backend.ekf_ba import ba_problem_from_slam  # noqa: E402
from pre3_tpu.backend.keyframes import select_keyframes  # noqa: E402
from pre3_tpu.backend.loop_detect import (  # noqa: E402
    merge_lcp, mine_keyframe_loop_closures,
)
from pre3_tpu.backend.smoothing import apply_ba_corrections  # noqa: E402
from pre3_tpu.data.synthetic import render_sequence  # noqa: E402
from pre3_tpu.ekf.slam import SlamConfig, run_slam  # noqa: E402
from pre3_tpu.eval.trajectory import ate_rmse  # noqa: E402
from pre3_tpu.frontend.pipeline import (  # noqa: E402
    extract_features, extract_features_sift,
)
from pre3_tpu.geometry.camera import sr4000_camera  # noqa: E402

N_FRAMES, N_LANDMARKS = 256, 256
CFG = SlamConfig(min_measured=50, max_update_slots=96)
CFG_NCC = CFG._replace(matcher="ncc_warp", match_ratio=1.3)


def _scene(loop: bool):
    if loop:
        drift = 0.03 * 0.5 * (N_FRAMES // 2)
        frames, traj, _ = render_sequence(
            n_frames=N_FRAMES, n_points=600, noise=0.004,
            x_range=(-1.8, drift + 1.8), loop=True)
    else:
        drift = 0.03 * 0.5 * N_FRAMES
        frames, traj, _ = render_sequence(
            n_frames=N_FRAMES, n_points=832, noise=0.004,
            x_range=(-1.8, drift + 1.8))
    gt = (traj.t - traj.t[0]) @ traj.r[0]
    return frames, gt


def _sift(frames):
    fe = jax.jit(extract_features_sift)
    t0 = time.perf_counter()
    per_frame = [jax.tree.map(np.asarray, fe(
        jnp.asarray(f.intensity), jnp.asarray(np.nan_to_num(f.xyz)),
        jnp.asarray(f.confidence))) for f in frames]
    feats = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *per_frame)
    print(f"frontend: {time.perf_counter() - t0:.1f} s for {len(frames)} "
          f"frames, valid keypoints per frame "
          f"{float(np.asarray(feats.valid).sum(-1).mean()):.1f}", flush=True)
    return feats


def _stats(out) -> str:
    s = out.stats
    return (f"mean n_ic {float(np.asarray(s.n_ic).mean()):.2f}, n_li "
            f"{float(np.asarray(s.n_li).mean()):.2f}, n_active "
            f"{float(np.asarray(s.n_active).mean()):.2f}")


def _post_ba(out, gt, kf_feats=None, mine=False):
    """bench.py's config-#4 chain on a run_slam output; with ``kf_feats``
    the keyframe tracks are merged, with ``mine`` the mined keyframe loop
    closures are added. Returns (post-BA ATE, description)."""
    cam = sr4000_camera()
    ks = select_keyframes(out.t, out.q, jnp.ones(N_FRAMES, bool),
                          max_keyframes=64)
    idx, valid = np.asarray(ks.indices), np.asarray(ks.valid)
    prob = ba_problem_from_slam(
        out, idx, valid, max_landmarks=512,
        kf_feats=None if kf_feats is None else jax.tree.map(
            lambda x: x[idx], kf_feats))
    n_lcp = 0 if prob.lcp_i is None else int(prob.lcp_i.shape[0])
    n_mined = 0
    if mine:
        mined = mine_keyframe_loop_closures(
            jax.tree.map(lambda x: x[idx], kf_feats),
            np.asarray(out.t)[idx], np.asarray(out.q)[idx], valid)
        n_mined = 0 if mined is None else len(mined[0])
        prob = merge_lcp(prob, mined)
    res = bundle_adjust(cam, prob, iters=10)
    sm_t, _ = apply_ba_corrections(out.t, out.q, ks.indices, ks.valid,
                                   res.kf_t, res.kf_q)
    ate = float(ate_rmse(np.asarray(sm_t), gt, align=False))
    m, l = np.asarray(prob.mask).shape
    desc = (f"M {m} (valid {int(valid.sum())}), L {l}, observations "
            f"{int(np.asarray(prob.mask).sum())}, lcp {n_lcp} + mined "
            f"{n_mined}, cost {float(res.cost[0]):.4f} -> "
            f"{float(res.cost[-1]):.4f}")
    return ate, desc


DAT_FRAMES = 48


def _dat_band(n_keys: int) -> None:
    """The dat config: examples/run_dat_pipeline.py's chain per key."""
    import tempfile

    from pre3_tpu.backend.tracks import make_ba_problem_from_tracks
    from pre3_tpu.data.export import export_dat_sequence
    from pre3_tpu.data.sr4000 import list_sequence, read_frame
    from pre3_tpu.runtime.online import OnlineSlam

    cam = sr4000_camera()
    frames, traj, _ = render_sequence(n_frames=DAT_FRAMES, n_points=400,
                                      noise=0.004)
    gt = (traj.t - traj.t[0]) @ traj.r[0]
    with tempfile.TemporaryDirectory() as d:
        export_dat_sequence(frames, d)
        frames = [read_frame(p) for p in list_sequence(d)]
    kf_fe = jax.jit(lambda i, x, c: extract_features(
        i, x, c, threshold=0.05, max_features=128))
    columns: dict[str, list[float]] = {}
    for key in range(n_keys):
        t0 = time.perf_counter()
        slam = OnlineSlam(
            cam, cfg=SlamConfig(match_ratio=1.3, initial_orientation=True),
            n_landmarks=64,
            extractor_kwargs={"threshold": 0.05, "max_features": 128},
            key=jax.random.PRNGKey(key))
        slam.run(frames, prefetch=2)
        ts, qs = slam.trajectory
        ks = select_keyframes(jnp.asarray(ts), jnp.asarray(qs),
                              jnp.ones(len(ts), bool), max_keyframes=16)
        kf_idx = np.asarray(ks.indices)
        kf_feats = jax.tree.map(lambda *xs: jnp.stack(xs), *[
            kf_fe(jnp.asarray(frames[i].intensity),
                  jnp.asarray(np.nan_to_num(frames[i].xyz)),
                  jnp.asarray(frames[i].confidence)) for i in kf_idx])
        prob = make_ba_problem_from_tracks(
            kf_feats, jnp.asarray(ts[kf_idx]), jnp.asarray(qs[kf_idx]),
            ks.valid, max_tracks=128)
        res = bundle_adjust(cam, prob, iters=8)
        sm_t, _ = apply_ba_corrections(jnp.asarray(ts), jnp.asarray(qs),
                                       ks.indices, ks.valid, res.kf_t,
                                       res.kf_q)
        row = {"online": float(ate_rmse(ts, gt, align=False)),
               "post-BA": float(ate_rmse(np.asarray(sm_t), gt, align=False))}
        print(f"key {key}: online ATE {row['online']:.4f} m, post-BA ATE "
              f"{row['post-BA']:.4f} m, {int(ks.n)} keyframes, cost "
              f"{float(res.cost[0]):.4f} -> {float(res.cost[-1]):.4f}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for name, v in row.items():
            columns.setdefault(name, []).append(v)
    for name, v in columns.items():
        print(f"dat {name} ATE over keys 0..{n_keys - 1}: min {min(v):.4f}, "
              f"max {max(v):.4f}, mean {np.mean(v):.4f}, std "
              f"{np.std(v):.4f} m ({', '.join(f'{x:.4f}' for x in v)})",
              flush=True)


def _batch_band(n_keys: int, n_frames: int, n_seq: int) -> None:
    """The batch config: each corridor's SLAM ATE over the keys."""
    cam = sr4000_camera()
    run = jax.jit(lambda f, k: run_slam(cam, f, k, cfg=CFG,
                                        n_landmarks=N_LANDMARKS))
    every = []
    for b in range(n_seq):
        frames, traj, _ = render_sequence(
            n_frames=n_frames, n_points=832, noise=0.004,
            x_range=(-1.8, 0.015 * n_frames + 1.8), scene_seed=b,
            traj_seed=100 + b)
        gt = (traj.t - traj.t[0]) @ traj.r[0]
        feats = _sift(frames)
        ates = [float(ate_rmse(np.asarray(run(feats, jax.random.PRNGKey(k)).t),
                               gt, align=False)) for k in range(n_keys)]
        every += ates
        print(f"batch sequence {b}: ATE over keys 0..{n_keys - 1}: min "
              f"{min(ates):.4f}, max {max(ates):.4f}, mean "
              f"{np.mean(ates):.4f} m", flush=True)
    print(f"batch, {n_seq} sequences x {n_frames} frames: ATE min "
          f"{min(every):.4f}, max {max(every):.4f}, mean "
          f"{np.mean(every):.4f} m", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("sift", "ncc", "ba", "loop", "dat",
                                         "batch"), default="sift")
    ap.add_argument("--keys", type=int, default=7)
    ap.add_argument("--frames", type=int, default=32)  # batch only
    ap.add_argument("--sequences", type=int, default=16)  # batch only
    ap.add_argument("--fast-math", action="store_true",
                    help="the SIFT frontend's fast-math branch")
    args = ap.parse_args()
    # read by the SIFT frontend when it is traced
    os.environ["PRE3_SIFT_FAST_MATH"] = "1" if args.fast_math else "0"
    jax.config.update("jax_platforms", "cpu")
    if args.config == "dat":
        _dat_band(args.keys)
        return
    if args.config == "batch":
        _batch_band(args.keys, args.frames, args.sequences)
        return
    cam = sr4000_camera()
    frames, gt = _scene(loop=args.config == "loop")
    if args.config == "ncc":
        intensity = jnp.asarray(np.stack([f.intensity for f in frames]))
        xyz = jnp.asarray(np.nan_to_num(np.stack([f.xyz for f in frames])))
        conf = jnp.asarray(np.stack([f.confidence for f in frames]))
        feats = jax.jit(jax.vmap(lambda i, x, c: extract_features(
            i, x, c, threshold=0.05, max_features=256)))(intensity, xyz, conf)
        run = jax.jit(lambda f, k: run_slam(
            cam, f, k, cfg=CFG_NCC, n_landmarks=N_LANDMARKS,
            images=intensity, xyz_imgs=xyz))
    else:
        feats = _sift(frames)
        run = jax.jit(lambda f, k: run_slam(cam, f, k, cfg=CFG,
                                            n_landmarks=N_LANDMARKS))
    columns: dict[str, list[float]] = {}
    for key in range(args.keys):
        t0 = time.perf_counter()
        out = run(feats, jax.random.PRNGKey(key))
        ate = float(ate_rmse(np.asarray(out.t), gt, align=False))
        row = {"slam": ate}
        print(f"key {key}: SLAM ATE {ate:.4f} m, {_stats(out)}", flush=True)
        if args.config in ("ba", "loop"):
            row["post-BA"], desc = _post_ba(out, gt)
            print(f"key {key}: post-BA ATE {row['post-BA']:.4f} m ({desc})",
                  flush=True)
        if args.config == "loop":
            row["post-BA tracks+mined"], desc = _post_ba(
                out, gt, kf_feats=feats, mine=True)
            print(f"key {key}: post-BA ATE with tracks and mined loop "
                  f"closures {row['post-BA tracks+mined']:.4f} m ({desc})",
                  flush=True)
        print(f"key {key}: {time.perf_counter() - t0:.1f} s", flush=True)
        for name, v in row.items():
            columns.setdefault(name, []).append(v)
    for name, v in columns.items():
        print(f"{args.config} {name} ATE over keys 0..{args.keys - 1}: min "
              f"{min(v):.4f}, max {max(v):.4f}, mean {np.mean(v):.4f} m "
              f"({', '.join(f'{x:.4f}' for x in v)})", flush=True)


if __name__ == "__main__":
    main()
