"""The program's own trace of a ``--trace 1`` run: a pass with the port's
tracer on (``pre3_tpu_torch/utils/profiling.py``), and the readings that
the metrics ``slam_step.*_ms``, ``slam.replay_ms``,
``frontend.device_ms_per_frame`` and ``device.idle_share.probed`` take
from it.

The pass runs once, when the first of those metrics is read: after the
window, after its peak memory and the earlier metrics are read (their
readers come first in ``BENCHMARK.json``), before the check. It takes
the cell and the seed from the command line (``run.py``'s
``--workload`` and ``--seed``), renders the first
``PROGRAM_TRACE_SEQUENCES`` corridors of the seed's order again, turns
the tracer on, captures the traced variants as set-up does (one
frontend chunk and a three-frame ``run_slam`` on the first corridor),
then runs the corridors back to back with no profiler active and with
generator seeds the window never drew, a synchronize before the first
and after the last trajectory copy (the span ``bench.pass``, a span
``bench.sequence`` per corridor; the probes ``bench.pass.begin`` and
``.end`` mark the pass's probes). It turns the tracer off and keeps
``profiling.export()`` as ``trace["program"]``, with the readings.

Device times are the probes' (``%globaltimer``): a program's replay runs
from its ``<name>.begin`` probe to its ``.end`` probe, and a stage of
``slam_step`` from its probe to the next one. A port without the tracer,
and a run without a card, give nothing.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

import torch

PROGRAM_TRACE_SEQUENCES = 2
STAGES = ("vo", "predict", "match", "ransac", "update", "map")
FRONTENDS = ("extract_features_sift", "extract_features")


def reading(trace: dict, name: str):
    """The pass's reading ``name``, the pass run first if it has not
    run; None where there is none."""
    if "program" not in trace:
        trace["program"] = None
        try:
            trace["program"] = run_pass(trace)
        except Exception:  # noqa: BLE001 — the run goes on without it
            traceback.print_exc()
    prog = trace["program"]
    return None if prog is None else prog["readings"].get(name)


def _cell() -> tuple[str, int] | None:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    args, _ = ap.parse_known_args(sys.argv[1:])
    if args.workload is None or args.seed is None:
        return None
    return args.workload, args.seed


def run_pass(trace: dict) -> dict | None:
    """The traced pass (see the module docstring): the export with its
    ``readings``, or None."""
    from pre3_tpu_torch.utils import profiling

    cell = _cell()
    if not hasattr(profiling, "tracing") or cell is None or (
            not torch.cuda.is_available()):
        print("program trace: no tracer in this port, no card or no cell; "
              "no pass", file=sys.stderr)
        return None
    from port_bench import offline, traffic
    from port_bench.render import Renders
    from port_bench.run import load_spec
    from port_bench.system import System

    t0 = time.perf_counter()
    workload, seed = cell
    spec = load_spec(workload)
    tr = spec["traffic"]
    if tr["kind"] != "offline":
        return None
    device = torch.device("cuda")
    system = System(spec["config"], device)
    ks = traffic.order(seed, tr["pool"])[:PROGRAM_TRACE_SEQUENCES]
    jobs = traffic.jobs(tr, seed)
    renders = Renders([jobs[k] for k in ks], len(ks))
    try:
        dev = [offline.upload(s, device) for s in renders.all()]
    finally:
        renders.close()
    t_render = time.perf_counter()

    def gen(i: int) -> torch.Generator:
        return torch.Generator(device).manual_seed(traffic.derive(seed, 7, i))

    with profiling.tracing():
        im, xyz, conf = (x[:system.chunk] for x in dev[0])
        feats = system.frontend(im, xyz, conf)
        system.slam(type(feats)(*(x[:3] for x in feats)), gen(0), im, xyz)
        torch.cuda.synchronize()
        t_capture = time.perf_counter()
        with profiling.span("bench.pass"):
            profiling.probe("bench.pass.begin", device)
            for i, (im, xyz, conf) in enumerate(dev):
                with profiling.span("bench.sequence"):
                    feats = system.frontend(im, xyz, conf)
                    t, q = system.slam(feats, gen(i + 1), im, xyz)
                    t, q = t.cpu(), q.cpu()
            profiling.probe("bench.pass.end", device)
            torch.cuda.synchronize()
    out = profiling.export()
    frames = sum(x[0].shape[0] for x in dev)
    out["readings"], notes = readings(out, frames)
    window = _window_sequence_s(trace, tr["frames"])
    print(f"program trace: the pass took {time.perf_counter() - t0:.3f} s "
          f"(render and upload {t_render - t0:.3f} s, traced captures "
          f"{t_capture - t_render:.3f} s); " + "; ".join(notes) + (
              f"; the window's traced sequences took {window:.4f} s each"
              if window else ""), file=sys.stderr, flush=True)
    return out


def _window_sequence_s(trace: dict, n_frames: int) -> float | None:
    """The mean wall time of the window's sequences timed by spans."""
    n = trace.get("frontend_frames", 0) / n_frames
    if not n:
        return None
    return (trace["frontend_s"] + trace["slam_s"]) / n


def _intervals(probes: list) -> dict:
    """{program: [(begin probe, end probe)]} of the programs' replays."""
    open_at, out = {}, {}
    for p in probes:
        name, _, edge = p[0].rpartition(".")
        if edge == "begin":
            open_at[name] = p
        elif edge == "end" and name in open_at:
            out.setdefault(name, []).append((open_at.pop(name), p))
    return out


def _innermost(spans: list, at: int) -> str:
    inside = [s for s in spans if s["start_ns"] <= at <= s["end_ns"]
              and not s["name"].startswith("bench.")]
    if not inside:
        return "host (no program span)"
    return min(inside, key=lambda s: s["end_ns"] - s["start_ns"])["name"]


def readings(ex: dict, frames: int) -> tuple[dict, list[str]]:
    """The metrics' readings over the ``bench.pass`` span of an export
    (``frames``: the frames its frontend calls took), and the notes the
    run prints."""
    whole = next(s for s in ex["spans"] if s["name"] == "bench.pass")
    lo, hi = whole["start_ns"], whole["end_ns"]
    tags = [p[0] for p in ex["probes"]]
    probes = ex["probes"][tags.index("bench.pass.begin") + 1:
                          tags.index("bench.pass.end")]
    runs = _intervals(probes)
    steps = runs.get("scan_steps", [])
    out: dict = {}
    if steps:
        out["slam.replay_ms"] = sum(e[1] - b[1] for b, e in steps) / (
            1e6 * len(steps))
        stage_ns = dict.fromkeys(STAGES + ("out",), 0)
        for a, b in zip(probes, probes[1:]):
            kind, _, stage = a[0].partition(".")
            if kind == "slam_step" and stage in stage_ns:
                stage_ns[stage] += b[1] - a[1]
        for stage in STAGES:
            if stage_ns[stage]:
                out[f"slam_step.{stage}_ms"] = stage_ns[stage] / (
                    1e6 * len(steps))
        out_ms = stage_ns["out"] / (1e6 * len(steps))
    chunks = [r for name in FRONTENDS for r in runs.get(name, [])]
    if chunks and frames:
        out["frontend.device_ms_per_frame"] = sum(
            e[1] - b[1] for b, e in chunks) / (1e6 * frames)
    # the union of every replay, on the host clock, inside the pass
    spans_dev = sorted((max(b[2], lo), min(e[2], hi))
                       for r in runs.values() for b, e in r)
    busy, edge, gaps = 0, lo, []
    for a, b in spans_dev:
        if a > edge:
            gaps.append((edge, a))
        busy += max(0, b - max(a, edge))
        edge = max(edge, b)
    if hi > edge:
        gaps.append((edge, hi))
    if spans_dev:
        out["device.idle_share.probed"] = 1.0 - busy / (hi - lo)
    notes = []
    seqs = [s for s in ex["spans"] if s["name"] == "bench.sequence"]
    for i, s in enumerate(seqs):
        mine = [e[1] - b[1] for b, e in steps
                if s["start_ns"] <= b[2] <= s["end_ns"]]
        notes.append(
            f"sequence {i}: {(s['end_ns'] - s['start_ns']) / 1e9:.4f} s, "
            f"mean step replay {sum(mine) / max(len(mine), 1) / 1e6:.4f} ms "
            f"over {len(mine)} steps")
    captures = sum(1 for s in ex["spans"] if s["name"] == "graphs.capture"
                   and lo <= s["start_ns"] <= hi)
    notes.append(f"captures during the timed sequences {captures}")
    notes.append(f"probes dropped {ex['dropped']}")
    if steps:
        stages_ms = sum(v for k, v in out.items()
                        if k.startswith("slam_step.")) + out_ms
        notes.append(
            "stages " + ", ".join(f"{k.split('.')[1]} {v:.4f}"
                                  for k, v in out.items()
                                  if k.startswith("slam_step.")) +
            f", out {out_ms:.4f} ms: {stages_ms:.4f} against replay "
            f"{out['slam.replay_ms']:.4f} ms "
            f"({stages_ms / out['slam.replay_ms']:.4%})")
    clock = ex.get("clock") or {}
    diffs = [b[1] - a[1] for a, b in zip(probes, probes[1:]) if b[1] > a[1]]
    notes.append(
        f"clock offset uncertainty {clock.get('uncertainty_ns')} ns, drift "
        f"{clock.get('drift_ns')} ns; smallest nonzero probe difference "
        f"{min(diffs) if diffs else None} ns")
    gaps.sort(key=lambda g: g[0] - g[1])
    notes.append("longest idle gaps between replays: " + ", ".join(
        f"{_innermost(ex['spans'], (a + b) // 2)} {(b - a) / 1e6:.3f} ms"
        for a, b in gaps[:10]))
    return out, notes
