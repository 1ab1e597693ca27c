"""Offline traffic: whole sequences back to back, closed loop.

Set-up renders the traffic file's ``pool`` corridors and uploads them,
and captures every program on the first one (one frontend chunk, a
three-frame ``run_slam``). The window then runs the pool in the seed's
order, one sequence at a time: the frontend (``extract_features[_sift]``
over its F frames), then ``run_slam``, and the trajectory copied to the
host, which completes the sequence. It ends at the first completion
after ``--seconds`` once the whole pool is done; past the pool it reuses
the corridors in the same order with new generator seeds.
``frames_per_s`` is every frame of every completed sequence over the
window's wall time; ``ate_rmse_m`` pools the pool's first pass (each
corridor once).

The check (after the window) takes ``CHECK_SEQUENCES`` of the pool's
first pass and, in each, the first and the last step and
``CHECK_STEPS`` more drawn from the seed: the program's drivers run the
sequence again with its generator seed, keeping the state before and
after each checked step (``System.states``).

With ``--trace 1`` every sequence is timed by spans with a synchronize
on each side of its frontend and of its ``run_slam``, and the second
sequence runs under the profiler instead (two windows: frontend, SLAM).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from port_bench import check, roofline, tracing, traffic
from port_bench.evaluate import note, pooled_ate
from port_bench.system import System

CHECK_SEQUENCES = 3  # of the pool's first pass
CHECK_STEPS = 6  # besides the first and the last step of each


def upload(seq, device):
    return tuple(torch.as_tensor(a, device=device) for a in (
        seq.intensity, np.nan_to_num(seq.xyz), seq.confidence))


def run(spec, seed: int, seconds: float, traced: bool, control: bool,
        device, t_start: float, renders) -> dict:
    config, tr = spec["config"], spec["traffic"]
    system = System(config, device)
    n_frames, pool = tr["frames"], tr["pool"]
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    # warm-up on the first corridor while the others render: one frontend
    # chunk and a three-frame run_slam capture every program the window
    # replays
    first = upload(renders.get(0), device)
    note(t_start, "first corridor rendered and uploaded")
    gen = torch.Generator(device).manual_seed(traffic.derive(seed, 5))
    im, xyz, conf = (x[:system.chunk] for x in first)
    feats = system.frontend(im, xyz, conf)
    sync()
    note(t_start, "frontend program captured")
    system.slam(type(feats)(*(x[:3] for x in feats)), gen, im, xyz)
    sync()
    note(t_start, "bootstrap and step programs captured")
    host = renders.all()
    dev = [first] + [upload(s, device) for s in host[1:]]
    note(t_start, f"{pool} corridors of {n_frames} frames rendered and "
         "uploaded")

    def one(k: int, gen: torch.Generator, spans: dict | None = None,
            windows: list | None = None):
        im, xyz, conf = dev[k]
        if windows is not None:
            feats, w_fe = tracing.profiled(
                lambda: system.frontend(im, xyz, conf), "bench.frontend")
            (t, q), w_slam = tracing.profiled(
                lambda: system.slam(feats, gen, im, xyz), "bench.slam")
            windows.extend([w_fe, w_slam])
            return feats, t.cpu(), q.cpu()
        if spans is not None:
            sync()
            a = time.perf_counter()
        feats = system.frontend(im, xyz, conf)
        if spans is not None:
            sync()
            b = time.perf_counter()
        t, q = system.slam(feats, gen, im, xyz)
        enqueued.append(time.perf_counter())
        t, q = t.cpu(), q.cpu()
        if spans is not None:
            spans["frontend_s"] += b - a
            spans["frontend_frames"] += n_frames
            spans["slam_s"] += time.perf_counter() - b
            spans["slam_steps"] += n_frames - 1
        return feats, t, q

    order = traffic.order(seed, pool)
    checked = set(traffic.sample(seed, pool, CHECK_SEQUENCES))
    spans = dict(frontend_s=0.0, frontend_frames=0, slam_s=0.0,
                 slam_steps=0) if traced else None
    windows: list = []
    kept, poses, ends, enqueued = {}, [], [], []
    t0 = time.perf_counter()
    j = 0
    while True:
        if j == pool:
            print(f"window: the pool's {pool} corridors are done; reusing "
                  f"them in the same order with new generator seeds",
                  file=sys.stderr, flush=True)
        k = order[j % pool]
        gseed = traffic.generator_seed(seed, j)
        gen = torch.Generator(device).manual_seed(gseed)
        feats, t, q = one(k, gen, spans,
                          windows if traced and j == 1 else None)
        if j < pool:
            poses.append((t.numpy(), host[k].gt))
            if j in checked:
                kept[j] = (k, gseed, feats, t, q)
        j += 1
        now = time.perf_counter()
        ends.append(now - t0)
        if now - t0 >= seconds and j >= pool:
            break
    window_s = now - t0
    print("window: sequences completed at " + ", ".join(
        f"{e:.3f}" for e in ends) + " s; their run_slam calls returned at "
        + ", ".join(f"{e - t0:.3f}" for e in enqueued) + " s",
        file=sys.stderr, flush=True)
    out = dict(setup_s=t0 - t_start, attempted=j, failed=0,
               metrics=dict(frames_per_s=j * n_frames / window_s,
                            ate_rmse_m=pooled_ate(poses)),
               window_s=window_s)
    if traced:
        n_feats, dim = host_dims(config)
        launches = roofline.step_launches(config, n_feats, dim)
        steps = n_frames - 1
        out["trace"] = dict(
            spans, window=tracing.merge(windows), frontend=windows[0],
            driver=windows[1], driver_steps=steps,
            bounds={k: [b for b, _ in v] * steps for k, v in launches.items()})
    out["peak_bytes"] = peak_bytes(device)
    out["check"] = lambda ref, control=None: compare(
        ref, system, dev, kept, seed, host_dims(config)[0], control)
    return out


def host_dims(config: dict) -> tuple[int, int]:
    """(features per frame, descriptor width) of the configuration's
    frontend."""
    fe = config["frontend"]
    if fe["extractor"] == "sift":
        return fe["n_octaves"] * fe["keypoints_per_octave"], 128
    return fe["max_features"], fe["patch"] ** 2


def peak_bytes(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def checked_steps(seed: int, j: int, n_frames: int) -> list[int]:
    """The first and the last step, and ``CHECK_STEPS`` more drawn from
    (seed, j)."""
    rng = np.random.default_rng(traffic.derive(seed, 6, j))
    inner = rng.choice(np.arange(2, n_frames - 1),
                       size=min(CHECK_STEPS, max(n_frames - 3, 0)),
                       replace=False)
    return sorted({1, n_frames - 1, *(int(i) for i in inner)})


def compare(ref: check.Reference, system: System, dev, kept: dict, seed: int,
            n_feats: int, control: check.Reference | None = None) -> dict:
    """The check's numbers over the kept sequences: the program's
    outputs against the reference's, or with ``control`` the control's
    outputs from the same inputs in the program's place."""
    runs = {}
    for j, (k, gseed, feats, t, q) in sorted(kept.items()):
        im, xyz, _ = dev[k]
        steps = checked_steps(seed, j, feats.uv.shape[0])
        gen = torch.Generator(system.device).manual_seed(gseed)
        run = system.states(feats, gen, [i for s in steps for i in (s, s + 1)],
                            im, xyz)
        runs[j] = (steps, check.clone_states(run))
    check.free_program(system.device)
    check.note("the program's states taken")
    stages, miss, total, fgap, replay = [], 0, 0, 0.0, 0.0
    side = control or ref
    for j, (k, gseed, feats, t, q) in sorted(kept.items()):
        im, xyz, conf = dev[k]
        steps, run = runs[j]
        replay = max(replay, float((run.t.cpu() - t).abs().max()),
                     float((run.q.cpu() - q).abs().max()))
        rf = ref.features(im, xyz, conf)
        pf = check.program_features(feats) if control is None else (
            control.features(im, xyz, conf))
        check.note("features recomputed")
        m, tot, g = check.feature_numbers(pf, rf, ref.per_octave)
        miss, total, fgap = miss + m, total + tot, max(fgap, g)
        r0 = ref.bootstrap(check.frame(rf, 0))
        p0 = run.state0 if control is None else control.bootstrap(
            check.frame(pf, 0))
        stages.append(check.state_gap(p0, r0))
        for i in steps:
            before = run.before[i]
            out = ref.step(before, check.frame(rf, i - 1), check.frame(rf, i),
                           i, ref.generator(gseed, i - 1, n_feats))
            after = run.before[i + 1] if control is None else side.step(
                before, check.frame(pf, i - 1), check.frame(pf, i), i,
                side.generator(gseed, i - 1, n_feats))
            stages.append(check.state_gap(after, out))
    return check.summarise(stages, miss, total, fgap, replay)
