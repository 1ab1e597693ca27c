"""Where the EKF slices' time goes on one card, under ``torch.profiler``.

Parts of config #3, and config #2, each on the smoke run's corridor (832
points, noise 0.004, 1.5 cm per frame) cut to ``--frames`` frames:

  frontend  ``extract_features_sift`` over all frames at once;
  run_slam  ``run_slam`` at K=256 with bench.py's CFG on those features;
  online    ``OnlineSlam(extractor="sift", n_landmarks=64)`` (the
            __graft_entry__ configuration), ``process()`` per frame;
  ncc       config #2: ``run_slam`` at K=256 on FAST features with the
            warped-patch NCC matcher, every frame's intensity and xyz
            image given (bench.py ``fast_ncc_pipeline``);
  wrappers  the host time per eager call of K1's and K2's wrappers
            (``score_hypotheses``, ``match_descriptors_k2``) at every
            single-launch shape of chip_smoke.py phase 3, timed as there
            (``chip_smoke.wrapper_ms`` on ``scorer_problem`` /
            ``matcher_problem`` inputs).

For each: host time per frame unprofiled (host clock around a
synchronize, median of ``--reps``), and from one profiled run the kernel
launches per frame (runtime launch calls), the device busy time per frame
(kernels, copies and fills on the card) and the device's idle share,
1 − busy / unprofiled time. Then the kernels that take the most device
time in the last EKF part profiled. Run it from the root of a checkout:

    python3 -m pre3_tpu_torch.utils.profile_slice --frames 48 \
        [--parts frontend,run_slam,online,ncc,wrappers]

At 48 frames it takes ~14 minutes on an H100, most of it the profiler
collecting ~5000 launches per EKF step; the default 24 frames, about
half.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pre3_tpu_torch.data.synthetic import render_sequence
from pre3_tpu_torch.ekf.slam import SlamConfig, run_slam
from pre3_tpu_torch.frontend.pipeline import (
    extract_features, extract_features_sift,
)
from pre3_tpu_torch.geometry.camera import sr4000_camera
from pre3_tpu_torch.ops.matching import match_descriptors_k2
from pre3_tpu_torch.ops.ransac_score import score_hypotheses
from pre3_tpu_torch.runtime.online import OnlineSlam

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")


def _wall(fn, reps: int) -> float:
    """Median host seconds of ``fn`` followed by a synchronize."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def _profiled(fn):
    """(launch calls, device busy µs, key averages) of one run of fn."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    launches = sum(a.count for a in avgs if a.key in LAUNCHES)
    busy = sum(a.self_device_time_total for a in avgs
               if a.device_type == DeviceType.CUDA)
    return launches, busy, avgs


def report(name: str, fn, n: int, reps: int):
    wall = _wall(fn, reps)
    launches, busy_us, avgs = _profiled(fn)
    busy = busy_us / 1e3 / n
    per = 1e3 * wall / n
    idle = 1.0 - busy / per if per > 0 else float("nan")
    print(f"[{name}] {n} frames: host {per:.3f} ms per frame unprofiled "
          f"(median of {reps}); launches {launches / n:.1f} per frame; "
          f"device busy {busy:.4f} ms per frame; idle share {idle:.4f}",
          flush=True)
    return avgs


# K1's (B, N) and K2's (N1, N2, D) single-launch shapes in smoke phase 3
K1_SHAPES = ((512, 288), (512, 256), (1024, 256), (1024, 288), (512, 128),
             (2048, 288), (512, 96), (64, 64))
K2_SHAPES = ((288, 288, 128), (256, 288, 128), (512, 288, 128),
             (64, 288, 128), (256, 256, 121), (128, 128, 121), (64, 128, 121),
             (96, 96, 121), (24, 96, 121))


def wrappers() -> None:
    """Host µs per eager call of K1's and K2's wrappers, each shape as
    chip_smoke.py phase 3 times it."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs

    for b, n in K1_SHAPES:
        args = cs.scorer_problem(b, n, 10)
        us = 1e3 * cs.wrapper_ms(lambda: score_hypotheses(*args))
        print(f"[wrappers] K1 ({b}, {n}): {us:.1f} µs per call", flush=True)
    for n1, n2, d in K2_SHAPES:
        d1, d2, v1, v2 = cs.matcher_problem(n1, n2, d, 11)
        us = 1e3 * cs.wrapper_ms(
            lambda: match_descriptors_k2(d1, d2, v1, v2, ratio=1.3))
        print(f"[wrappers] K2 {n1}x{n2}x{d}: {us:.1f} µs per call",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--parts", default="frontend,run_slam,online")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    n = args.frames
    frames, _, _ = render_sequence(n_frames=n, n_points=832, noise=0.004,
                                   x_range=(-1.8, 0.015 * n + 1.8))
    host = [np.stack([getattr(f, a) for f in frames])
            for a in ("intensity", "xyz", "confidence")]
    host[1] = np.nan_to_num(host[1])
    im = [torch.as_tensor(a, device="cuda") for a in host]
    cam = sr4000_camera()
    cfg = SlamConfig(min_measured=50, max_update_slots=96)
    feats = extract_features_sift(*im)
    # warm-up: the kernels' first launches, cuBLAS/cuDNN plans
    run_slam(cam, type(feats)(*(x[:8] for x in feats)), cfg, n_landmarks=256,
             generator=torch.Generator("cuda").manual_seed(0))

    avgs = None
    if "wrappers" in parts:
        wrappers()
    if "frontend" in parts:
        report("frontend", lambda: extract_features_sift(*im), n, args.reps)
    if "run_slam" in parts:
        avgs = report("run_slam", lambda: run_slam(
            cam, feats, cfg, n_landmarks=256,
            generator=torch.Generator("cuda").manual_seed(1)), n - 1,
            args.reps)

    def online():
        slam = OnlineSlam(cam, cfg=SlamConfig(min_measured=50),
                          n_landmarks=64, extractor="sift")
        for i in range(n):
            slam.process(host[0][i], host[1][i], host[2][i])

    if "online" in parts:
        report("online", online, n, args.reps)
    if "ncc" in parts:
        fast = extract_features(*im, threshold=0.05, max_features=256)
        ncc_cfg = cfg._replace(matcher="ncc_warp", match_ratio=1.3)
        avgs = report("ncc", lambda: run_slam(
            cam, fast, ncc_cfg, n_landmarks=256,
            generator=torch.Generator("cuda").manual_seed(1), images=im[0],
            xyz_imgs=im[1]), n - 1, args.reps)
    if avgs is None:
        return

    kernels = sorted((a for a in avgs if a.device_type == DeviceType.CUDA),
                     key=lambda a: -a.self_device_time_total)
    total = sum(a.self_device_time_total for a in kernels)
    last = "ncc" if "ncc" in parts else "run_slam"
    print(f"[{last}] top {args.top} of {len(kernels)} device ops by time "
          f"(share of {total / 1e3:.1f} ms):", flush=True)
    for a in kernels[:args.top]:
        print(f"  {a.self_device_time_total / 1e3:9.3f} ms "
              f"{a.self_device_time_total / total:7.2%} {a.count:7d}× "
              f"{a.key[:90]}", flush=True)


if __name__ == "__main__":
    main()
