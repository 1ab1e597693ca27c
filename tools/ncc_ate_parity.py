"""Config #2 over the whole corridor: the port against the JAX reference,
both on the CPU, under the reference's own random draws.

The port's smoke run holds config #2's ATE to a band from the JAX
reference over keys 0..6 (tools/jax_sift_ate_band.py --config ncc), and
its CPU tests hold the NCC ``run_slam`` to the reference step by step
over 10 frames. This script runs the full 256-frame corridor for each
key: the reference's ``run_slam(key)``, then the port's ``run_slam`` fed
the same FAST features and the draws the reference takes from that key,
reproduced and injected. Beside them it runs the reference once more on
the same features with every point moved by one float32 ulp, which shows
how far rounding alone carries the reference from itself. It prints, per
key, the three ATEs (no alignment) and for each pair of runs where they
part: the first step whose counts or masks differ, the first step where
a measured landmark moved by more than 0.01 px (the NCC scan took a
neighbouring candidate), and the pose difference along the run; at the
port's first such step, its two best NCC scores of each landmark that
moved (how near the tie was).

Run it from the root of a checkout:

    PYTHONPATH=. python3 tools/ncc_ate_parity.py [--keys 0 1 2] [--frames 256]

(minutes per key on a CPU).
"""

from __future__ import annotations

import argparse
import inspect
import os
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pre3_tpu.data.synthetic import render_sequence  # noqa: E402
from pre3_tpu.ekf import slam as jslam  # noqa: E402
from pre3_tpu.eval.trajectory import ate_rmse  # noqa: E402
from pre3_tpu.frontend.pipeline import extract_features  # noqa: E402
from pre3_tpu.geometry.camera import sr4000_camera as jcamera  # noqa: E402
from pre3_tpu_torch.ekf import ncc_matching  # noqa: E402
from pre3_tpu_torch.ekf import slam as tslam  # noqa: E402
from pre3_tpu_torch.ekf.one_point_ransac import pool_size  # noqa: E402
from pre3_tpu_torch.geometry.camera import sr4000_camera  # noqa: E402
from pre3_tpu_torch.utils.interop import to_numpy, to_torch  # noqa: E402

N_FRAMES, N_LANDMARKS, KF = 256, 256, 256
CFG = dict(min_measured=50, max_update_slots=96, matcher="ncc_warp",
           match_ratio=1.3)
PLANE_BATCH = 512
N_REGION = (144 - int(144 * 0.6)) * 176  # floor_up_direction's region


def _gumbel(key, shape) -> torch.Tensor:
    return torch.as_tensor(np.array(jax.random.gumbel(key, shape)))


def reference_draws(key, cfg, n_frames: int):
    """The draws the reference's run_slam takes from ``key`` (xyz images
    given, no attitude update): split → bootstrap (plane fit, add
    sampling) and one key per step, split(·, 3) → VO, 1-PRE, add."""
    kboot, key = jax.random.split(key)
    kp, kboot = jax.random.split(kboot)
    m = pool_size(N_LANDMARKS, cfg.max_update_slots or None)
    steps = []
    for k in jax.random.split(key, n_frames - 1):
        kv, kr, ka = jax.random.split(k, 3)
        steps.append((_gumbel(kv, (cfg.vo_batch, KF)),
                      _gumbel(kr, (cfg.ransac_batch, m)),
                      _gumbel(ka, (KF,))))
    return tslam.SlamDraws(
        steps=tslam.StepDraws(*(torch.stack(f) for f in zip(*steps)),
                              heading=None),
        boot_add=_gumbel(kboot, (KF,)),
        plane=_gumbel(kp, (PLANE_BATCH, N_REGION)))


def recording_search(record: list):
    """The port's search_ic_matches_ncc, built from its own source, that
    also appends each call's [K, G²] candidate scores to ``record``."""
    src = inspect.getsource(ncc_matching.search_ic_matches_ncc)
    line = "    best = torch.argmax(ncc, dim=-1)"
    if src.count(line) != 1:
        raise RuntimeError("search_ic_matches_ncc no longer has its argmax "
                           "line; update recording_search")
    ns = dict(vars(ncc_matching), _record=record)
    exec(src.replace(line, "    _record.append(ncc.clone())\n" + line), ns)
    return ns["search_ic_matches_ncc"]


def divergence(a, b, n: int) -> dict:
    """Where two run_slam outputs part: the first step whose per-step
    stats or records (measured, visible, init_frame) differ, the first
    step where a landmark measured on both sides moved by > 0.01 px
    (the NCC scan took a neighbouring candidate), |Δt| along the run."""
    any_diff = np.zeros(n - 1, bool)
    for name in a.stats._fields:
        any_diff |= getattr(a.stats, name) != getattr(b.stats, name)
    for name in ("measured", "visible", "init_frame"):
        any_diff |= (getattr(a.records, name) != getattr(b.records, name)
                     ).reshape(n - 1, -1).any(-1)
    both = a.records.measured & b.records.measured
    dz = np.where(both, np.abs(a.records.z - b.records.z).max(-1),
                  0.0).max(-1)
    first = lambda m: int(np.flatnonzero(m)[0]) + 1 if m.any() else None
    jump = first(dz > 1e-2)
    dt = np.abs(a.t - b.t).max(-1)
    return dict(first_count=first(any_diff), first_jump=jump,
                dz_before=float(dz[:(jump or n) - 1].max(initial=0.0)),
                dt16=dt[::16], dt=float(dt.max()))


def report(label: str, d: dict, ate_a: float, ate_b: float) -> None:
    print(f"{label}: ATE {ate_a:.4f} vs {ate_b:.4f} m; first step with a "
          f"count or mask differing {d['first_count']}, with a measurement "
          f"moved > 0.01 px {d['first_jump']} (|Δz| before it ≤ "
          f"{d['dz_before']:.1e} px); |Δt| every 16 steps "
          f"{', '.join(f'{x:.1e}' for x in d['dt16'])}, max {d['dt']:.3e} m",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    n = args.frames
    drift = 0.03 * 0.5 * N_FRAMES  # bench.py's corridor, first n frames
    frames, traj, _ = render_sequence(n_frames=N_FRAMES, n_points=832,
                                      noise=0.004, x_range=(-1.8, drift + 1.8))
    gt = ((traj.t - traj.t[0]) @ traj.r[0])[:n]
    intensity, xyz, conf = (np.stack([getattr(f, a) for f in frames[:n]])
                            for a in ("intensity", "xyz", "confidence"))
    xyz = np.nan_to_num(xyz)
    feats = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda i, x, c: extract_features(i, x, c, threshold=0.05,
                                         max_features=KF)))(
        intensity, xyz, conf))
    # the same features, every point moved by one float32 ulp (relative
    # 2^-23): how far the reference departs from itself under rounding
    nudged = feats._replace(xyz=(feats.xyz * np.float32(1 + 2.0 ** -23))
                            .astype(np.float32))
    cfg = tslam.SlamConfig(**CFG)
    run_ref = jax.jit(lambda f, k: jslam.run_slam(
        jcamera(), f, k, cfg=jslam.SlamConfig(**CFG), n_landmarks=N_LANDMARKS,
        images=jnp.asarray(intensity), xyz_imgs=jnp.asarray(xyz)))
    ate = lambda out: float(ate_rmse(out.t, gt, align=False))
    rows = []
    for key in args.keys:
        t0 = time.perf_counter()
        ref, ref_nudged = (jax.tree.map(np.asarray, run_ref(
            jax.tree.map(jnp.asarray, f), jax.random.PRNGKey(key)))
            for f in (feats, nudged))
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        scores = []
        tslam.search_ic_matches_ncc = recording_search(scores)
        got = to_numpy(tslam.run_slam(
            sr4000_camera(), to_torch(feats, device="cpu"), cfg,
            n_landmarks=N_LANDMARKS,
            draws=reference_draws(jax.random.PRNGKey(key), cfg, n),
            images=torch.as_tensor(intensity), xyz_imgs=torch.as_tensor(xyz)))
        tslam.search_ic_matches_ncc = ncc_matching.search_ic_matches_ncc
        t_port = time.perf_counter() - t0
        rows.append((ate(ref), ate(got), ate(ref_nudged)))
        print(f"key {key}: {n} frames; ATE reference {rows[-1][0]:.4f} m, "
              f"port under its draws {rows[-1][1]:.4f} m, reference on "
              f"features one ulp off {rows[-1][2]:.4f} m; mean n_ic "
              f"{ref.stats.n_ic.mean():.2f} / {got.stats.n_ic.mean():.2f}, "
              f"n_li {ref.stats.n_li.mean():.2f} / "
              f"{got.stats.n_li.mean():.2f} (reference / port); "
              f"{t_ref:.1f} s (two reference runs) + {t_port:.1f} s",
              flush=True)
        d = divergence(got, ref, n)
        report(f"key {key} port vs reference", d, rows[-1][1], rows[-1][0])
        if d["first_jump"]:
            s = d["first_jump"] - 1  # row of the step's stats and records
            dz = np.abs(got.records.z[s] - ref.records.z[s]).max(-1)
            for lm in np.flatnonzero((dz > 1e-2) & got.records.measured[s]
                                     & ref.records.measured[s]):
                top = np.sort(scores[s][lm].numpy())[::-1][:2]
                print(f"key {key} step {s + 1} landmark {lm}: moved "
                      f"{dz[lm]:.3f} px; the port's two best NCC scores "
                      f"{top[0]:.8f}, {top[1]:.8f} (gap {top[0] - top[1]:.2e})",
                      flush=True)
        report(f"key {key} reference one ulp off vs reference",
               divergence(ref_nudged, ref, n), rows[-1][2], rows[-1][0])
    a = np.array(rows)
    for col, name in enumerate(("reference", "port under the same draws",
                                "reference on features one ulp off")):
        print(f"ncc ATE over keys {args.keys}, {name}: {a[:, col].min():.4f}"
              f"–{a[:, col].max():.4f} (mean {a[:, col].mean():.4f}; "
              f"{', '.join(f'{x:.4f}' for x in a[:, col])}) m", flush=True)
    print(f"max |ATE − reference's|: port {np.abs(a[:, 1] - a[:, 0]).max():.4f}"
          f", reference one ulp off {np.abs(a[:, 2] - a[:, 0]).max():.4f} m",
          flush=True)


if __name__ == "__main__":
    main()
