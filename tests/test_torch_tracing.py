"""The port's tracer (utils/profiling.py) on the CPU, at tiny sizes: off
it records nothing and builds nothing; the span tree (parents, request
ids, self time) and its Chrome trace; the host clock against
torch.profiler's; the clock mapping's arithmetic; a traced run_slam's
stage probes, its bit-equality with an untraced one and the ops both
dispatch; the NCC scan's two extra match probes; and the step program's
graphs keyed by tracing state."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from pre3_tpu_torch.data.synthetic import render_sequence
from pre3_tpu_torch.ekf import slam
from pre3_tpu_torch.frontend.pipeline import extract_features
from pre3_tpu_torch.geometry.camera import sr4000_camera
from pre3_tpu_torch.utils import graphs, profiling

N_FRAMES, K = 4, 32
CFG = slam.SlamConfig(match_ratio=1.3, min_measured=50, max_update_slots=24)


@pytest.fixture(scope="module")
def images():
    """The rendered frames' intensity, xyz and confidence images."""
    frames, _, _ = render_sequence(n_frames=N_FRAMES, n_points=300,
                                   noise=0.004)
    return [torch.as_tensor(np.nan_to_num(np.stack([getattr(f, a)
                                                    for f in frames])))
            for a in ("intensity", "xyz", "confidence")]


@pytest.fixture(scope="module")
def feats(images):
    return extract_features(*images, threshold=0.05, max_features=64)


def _run(feats):
    return slam.run_slam(sr4000_camera(), feats, CFG, K,
                         generator=torch.Generator().manual_seed(5))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_off_records_nothing_and_builds_no_kernel(feats, monkeypatch):
    def refuse(*_):
        raise AssertionError("the probe kernel was built or loaded")

    monkeypatch.setattr(profiling, "_lib", refuse)
    monkeypatch.setattr(profiling, "load_library", refuse)
    assert not profiling.on()
    assert profiling.span("x") is profiling.span("y")  # one shared no-op
    with profiling.span("x"):
        profiling.count("c")
        profiling.probe("p", torch.device("cpu"))
    assert profiling._REC is None
    with profiling.tracing():
        pass
    _run(feats)
    profiling.probe("late")
    ex = profiling.export()
    assert ex["spans"] == [] and ex["probes"] == [] and ex["counters"] == {}
    assert not ex["device"] and ex["clock"] is None


def test_span_tree_requests_and_self_time(tmp_path):
    with profiling.tracing():
        with profiling.span("outer", request=True):
            with profiling.span("a"):
                with profiling.span("leaf"):
                    profiling.count("leaves", 2)
            with profiling.span("a"):
                pass
        with profiling.span("next", request=True):
            profiling.probe("mark")
    ex = profiling.export()
    by = {s["name"]: s for s in ex["spans"]}
    ids = [s["id"] for s in ex["spans"]]
    assert len(set(ids)) == len(ids) == 5
    assert by["outer"]["parent"] == 0
    assert by["leaf"]["parent"] == ex["spans"][1]["id"]
    assert all(s["parent"] == by["outer"]["id"]
               for s in ex["spans"] if s["name"] == "a")
    assert {s["request"] for s in ex["spans"]
            if s["name"] != "next"} == {by["outer"]["request"]}
    assert by["next"]["request"] != by["outer"]["request"]
    n = ex["by_name"]
    assert n["a"]["count"] == 2 and n["leaf"]["count"] == 1
    assert n["outer"]["self_ns"] == n["outer"]["total_ns"] - n["a"]["total_ns"]
    assert n["a"]["self_ns"] == n["a"]["total_ns"] - n["leaf"]["total_ns"]
    assert ex["counters"] == {"leaves": 2}
    assert [p[0] for p in ex["probes"]] == ["mark"]
    assert by["next"]["start_ns"] <= ex["probes"][0][2] <= by["next"]["end_ns"]
    path = tmp_path / "trace.json"
    profiling.write_chrome_trace(path)
    events = json.loads(path.read_text())["traceEvents"]
    assert sorted(e["name"] for e in events if e["ph"] == "X") == [
        "a", "a", "leaf", "next", "outer"]
    assert [e["name"] for e in events if e["ph"] == "i"] == ["mark"]


def test_host_clock_is_the_profilers():
    """A span's start and end against the record_function range it
    enters under a profiler: within 50 µs on the profiler's own clock.
    The first range a process enters sets up the profiler's op (ms), so
    a span warms it first."""
    with profiling.tracing():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("tracing.warm"):
                pass
            for _ in range(3):
                with profiling.span("tracing.clock"):
                    torch.ones(64).sum()
    spans = [s for s in profiling.export()["spans"]
             if s["name"] == "tracing.clock"]
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "tracing.clock"),
                    key=lambda e: e.start_ns())
    assert len(events) == len(spans) == 3
    for s, e in zip(spans, events):
        assert abs(e.start_ns() - s["start_ns"]) < 50_000
        end = e.start_ns() + e.duration_ns()
        assert abs(end - s["end_ns"]) < 50_000


def test_clock_mapping_recovers_offset_and_drift():
    """Brackets around probes of a device clock 1000 ns ahead of the
    host at first and 1400 ns ahead at the second calibration: the
    offsets, their uncertainty and the interpolation between them."""
    cal, probes = [], []
    for base, off in ((10_000, 1000), (1_010_000, 1400)):
        brackets = []
        for i in range(4):
            h0 = base + 100 * i
            h1 = h0 + 40 + 10 * i
            probes.append([0, h0 + 20 + off])
            brackets.append((h0, h1))
        cal.append((None, brackets))
    m = profiling._clock_map(probes, cal)
    # per calibration the intersection is [off - 20, off + 20]
    assert m["offset_ns"] == 1000 and m["drift_ns"] == 400
    assert m["uncertainty_ns"] == 20 and m["calibrations"] == 2
    mid = (probes[0][1] + probes[4][1]) // 2
    assert abs(m["offset_at"](mid) - 1200) <= 1


def test_traced_run_slam_probes_each_stage_and_changes_nothing(feats):
    """On the CPU a probe records the host clock: the bootstrap's begin
    and end, then per step the program's begin, every stage of the 1PRE
    step in order and the program's end; the trajectory is bit-equal to
    an untraced run's, and the two runs dispatch the same aten ops."""
    untraced_ops, traced_ops = _Ops(), _Ops()
    with untraced_ops:
        plain = _run(feats)
    with profiling.tracing():
        with traced_ops:
            traced = _run(feats)
    ex = profiling.export()
    for a, b in zip(tree_leaves(plain), tree_leaves(traced)):
        assert torch.equal(a, b)
    assert traced_ops.ops == untraced_ops.ops
    step = (["scan_steps.begin"] + [f"slam_step.{s}" for s in slam.STAGES]
            + ["scan_steps.end"])
    tags = [p[0] for p in ex["probes"]]
    assert tags == ["bootstrap_state.begin", "bootstrap_state.end"] + step * (
        N_FRAMES - 1)
    times = [p[2] for p in ex["probes"]]
    assert times == sorted(times)
    names = [s["name"] for s in ex["spans"]]
    assert names.count("run_slam") == names.count("bootstrap_state") == 1
    assert names.count("graphs.copy_in") == N_FRAMES - 1
    assert names.count("scan.stage_rows") == 1
    run = next(s for s in ex["spans"] if s["name"] == "run_slam")
    assert all(s["request"] == run["request"] for s in ex["spans"])


@pytest.mark.parametrize("matcher,probes", [("desc", 1), ("ncc_warp", 3)])
def test_match_stage_probes_by_matcher(feats, images, matcher, probes):
    """The descriptor matcher's step probes its match stage once; the
    NCC scan's three times, all with the stage's tag (the stage, then
    the warp, then the scan), so the stage still runs to the RANSAC
    probe. Traced and untraced runs are bit-equal, and an untraced run
    records nothing."""
    cfg = CFG._replace(matcher=matcher)

    def run():
        return slam.run_slam(sr4000_camera(), feats, cfg, K,
                             generator=torch.Generator().manual_seed(5),
                             images=images[0], xyz_imgs=images[1])

    with profiling.tracing():
        traced = run()
    tags = [p[0] for p in profiling.export()["probes"]]
    plain = run()
    assert [p[0] for p in profiling.export()["probes"]] == tags
    for a, b in zip(tree_leaves(plain), tree_leaves(traced)):
        assert torch.equal(a, b)
    step = (["scan_steps.begin", "slam_step.vo", "slam_step.predict"]
            + ["slam_step.match"] * probes
            + [f"slam_step.{s}" for s in slam.STAGES[3:]]
            + ["scan_steps.end"])
    assert tags[2:] == step * (N_FRAMES - 1)


def test_skipped_stages_emit_no_probe(feats):
    """pure_ekf has no RANSAC stage: its steps probe the others only."""
    cfg = CFG._replace(est_method="pure_ekf")
    with profiling.tracing():
        slam.run_slam(sr4000_camera(), feats, cfg, K,
                      generator=torch.Generator().manual_seed(5))
    tags = [p[0] for p in profiling.export()["probes"]]
    assert "slam_step.ransac" not in tags
    assert tags.count("slam_step.update") == N_FRAMES - 1


def test_batched_step_probes_once_per_step(feats):
    """Under run_slam_batched's vmap a probe takes no tensor and fires
    once per batched step; the trajectories equal the untraced ones."""
    two = type(feats)(*(torch.stack([x, x]) for x in feats))

    def run():
        gens = [torch.Generator().manual_seed(i) for i in range(2)]
        return slam.run_slam_batched(sr4000_camera(), two, CFG, K,
                                     generators=gens)

    plain = run()
    with profiling.tracing():
        traced = run()
    assert torch.equal(plain.t, traced.t) and torch.equal(plain.q, traced.q)
    tags = [p[0] for p in profiling.export()["probes"]]
    assert tags.count("slam_step.vo") == tags.count("slam_step.out") == (
        N_FRAMES - 1)


class _Graph:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def replay(self):
        self.log.append(self.name)


def test_step_program_keys_traced_and_untraced_graphs_apart(monkeypatch):
    """A program's graphs by (variant, traced): the traced variant is
    captured apart, around the probed body, replayed while tracing is
    on, and dropped when it turns off."""
    log, bodies = [], []
    prog = graphs.StepProgram("tracing.test", {}, torch.device("cpu"))
    prog.cuda = True  # as on the card, with capture and replay faked
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)

    def capture(body, _generators):
        bodies.append(body)
        return graphs.Captured(_Graph(log, f"graph{len(bodies)}"), 0.0, 0)

    monkeypatch.setattr(prog, "_capture", capture)

    def body(b, g):
        pass

    prog.run("v", body)
    prog.run("v", body)
    with profiling.tracing():
        prog.run("v", body)
        prog.run("v", body)
        assert set(prog.graphs) == {("v", False), ("v", True)}
    assert bodies[0] is body and bodies[1] is not body
    assert log == ["graph1", "graph1", "graph2", "graph2"]
    assert set(prog.graphs) == {("v", False)}
    names = [s["name"] for s in profiling.export()["spans"]]
    assert names.count("graphs.replay") == 2
    assert profiling.export()["counters"] == {"graphs.replays": 2}
