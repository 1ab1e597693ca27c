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
synchronize, median of ``--reps``), and from one profiled run the
host-issued launches per frame (kernel and graph launches, copies,
memsets), the device busy time per frame (kernels, copies and fills on
the card) and the device's idle share, 1 − busy / the profiled run's own
wall time. Then
the kernels that take the most device time in the last EKF part
profiled. ``run_slam`` and ``OnlineSlam`` replay their step programs
(``utils/graphs.py``): the first ``run_slam`` of a config captures its
program, and each ``online`` run's bootstrap and first frame (its
capture) are set-up, outside the timed and profiled frames. Run it from
the root of a checkout:

    python3 -m pre3_tpu_torch.utils.profile_slice --frames 48 \
        [--parts frontend,run_slam,online,ncc,wrappers]

Eager, before the step programs, 48 frames took ~14 minutes on an
H100, most of it the profiler collecting ~5000 launches per EKF step.
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
from torch.profiler import ProfilerActivity, profile, schedule

from pre3_tpu_torch.data.synthetic import render_sequence
from pre3_tpu_torch.ekf.slam import SlamConfig, run_slam
from pre3_tpu_torch.frontend.pipeline import (
    extract_features, extract_features_sift,
)
from pre3_tpu_torch.geometry.camera import sr4000_camera
from pre3_tpu_torch.ops.matching import match_descriptors_k2
from pre3_tpu_torch.ops.ransac_score import score_hypotheses
from pre3_tpu_torch.runtime.online import OnlineSlam

# What the host issues to the card: kernel launches, graph launches (a
# replayed step program is one) and copies and memsets.
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
            "cudaMemsetAsync")


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


def _profiled(fn, warm=None, between=None):
    """(launch calls, device busy µs, wall s, key averages) of one run of
    fn, in one profiler window: the profiler starts in a warm-up step
    that is not kept (``warm()``, by default a fill; then ``between()``)
    so that the window's first kernels are recorded, and the window's
    wall time runs from a synchronize before fn to one after it, so
    busy / wall is the device's busy share of that window."""
    marker = torch.zeros(1, device="cuda")
    kept = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: kept.append(p.key_averages())
                 ) as prof:
        if warm is None:
            marker.fill_(1.0)
        else:
            warm()
        torch.cuda.synchronize()
        if between is not None:
            between()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    avgs = kept[-1]
    launches = sum(a.count for a in avgs if a.key in LAUNCHES)
    busy = sum(a.self_device_time_total for a in device_ops(avgs))
    return launches, busy, wall, avgs


def device_ops(avgs):
    """The key averages of work on the card: kernels, copies and fills
    (not the profiler's own step span, which it also lists on the
    device)."""
    return [a for a in avgs if a.device_type == DeviceType.CUDA
            and not a.key.startswith("ProfilerStep")]


def report(name: str, fn, n: int, reps: int, setup=None):
    """Time ``fn`` (``setup()`` makes it, untimed, where given: a fresh
    one per run) and profile one more run."""
    make = setup or (lambda: fn)
    walls = []
    for _ in range(reps):
        run = make()
        walls.append(_wall(run, 1))
    wall = statistics.median(walls)
    launches, busy_us, window_s, avgs = _profiled(make())
    busy = busy_us / 1e3 / n
    per = 1e3 * wall / n
    idle = 1.0 - busy_us / 1e6 / window_s
    print(f"[{name}] {n} frames: host {per:.3f} ms per frame unprofiled "
          f"(median of {reps}); launches {launches / n:.1f} per frame; "
          f"device busy {busy:.4f} ms per frame; idle share {idle:.4f} "
          f"(of the profiled run, {1e3 * window_s / n:.3f} ms per frame)",
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
    # warm-up: the kernels' first launches, cuBLAS/cuDNN plans, the step
    # program's capture
    run_slam(cam, feats, cfg, n_landmarks=256,
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
        """A fresh OnlineSlam past its bootstrap and first frame (which
        captures its frame program), and the call that streams the
        remaining frames."""
        slam = OnlineSlam(cam, cfg=SlamConfig(min_measured=50),
                          n_landmarks=64, extractor="sift")
        for i in range(2):
            slam.process(host[0][i], host[1][i], host[2][i])
        return lambda: [slam.process(host[0][i], host[1][i], host[2][i])
                        for i in range(2, n)]

    if "online" in parts:
        report("online", None, n - 2, args.reps, setup=online)
    if "ncc" in parts:
        fast = extract_features(*im, threshold=0.05, max_features=256)
        ncc_cfg = cfg._replace(matcher="ncc_warp", match_ratio=1.3)

        def ncc():
            return run_slam(cam, fast, ncc_cfg, n_landmarks=256,
                            generator=torch.Generator("cuda").manual_seed(1),
                            images=im[0], xyz_imgs=im[1])

        ncc()  # the capture
        avgs = report("ncc", ncc, n - 1, args.reps)
    if avgs is None:
        return

    kernels = sorted(device_ops(avgs), key=lambda a: -a.self_device_time_total)
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
