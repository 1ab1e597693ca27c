"""The NCC matcher's split readings (port_bench/ncc_split.py and the
metrics ``ncc.warp_ms``, ``ncc.scan_ms``) on a synthetic export: they
read the second and third intervals of each step's match stage, give
nothing where a step probes the stage once, and leave the program
trace's six stage readings as they were."""

import pytest

from port_bench import program_trace, run

STEP = ("vo", "predict", "match", "ransac", "update", "map", "out")


def export(match_probes: int, steps: int = 2) -> dict:
    """An export of one pass: per step the program's begin, its stages
    and its end, each probe 1000 ns after the last. With three match
    probes the stage's 1000 ns are split: the warp's probe at +100, the
    scan's at +400, the RANSAC probe at +1000 as before."""
    probes, ns = [["bench.pass.begin", 0, 0]], 0

    def at(tag, gap):
        nonlocal ns
        ns += gap
        probes.append([tag, ns, ns])

    for _ in range(steps):
        at("scan_steps.begin", 1000)
        gap = 1000
        for stage in STEP:
            at(f"slam_step.{stage}", gap)
            gap = 1000
            if stage == "match" and match_probes == 3:
                at("slam_step.match", 100)
                at("slam_step.match", 300)
                gap = 600
        at("scan_steps.end", 1000)
    at("bench.pass.end", 1000)
    return dict(probes=probes, dropped=0, clock=None, spans=[
        dict(name="bench.pass", start_ns=0, end_ns=ns)])


def test_the_split_reads_the_second_and_third_intervals():
    got = {m: run.reader(m)({"program": export(3)})
           for m in ("ncc.warp_ms", "ncc.scan_ms")}
    # the warp: the second probe to the third (300 ns); the scan: the
    # third to the RANSAC probe (600 ns)
    assert got == {"ncc.warp_ms": pytest.approx(3e-4),
                   "ncc.scan_ms": pytest.approx(6e-4)}


@pytest.mark.parametrize("name", ["ncc.warp_ms", "ncc.scan_ms"])
def test_no_split_where_a_step_probes_the_match_once(name):
    assert run.reader(name)({"program": export(1)}) is None
    assert run.reader(name)({"program": None}) is None


def test_the_extra_probes_leave_the_stage_readings():
    plain, _ = program_trace.readings(export(1), 8)
    split, _ = program_trace.readings(export(3), 8)
    assert split == plain
    assert {f"slam_step.{s}_ms" for s in program_trace.STAGES} <= set(plain)
    assert plain["slam_step.match_ms"] == pytest.approx(1e-3)


def test_a_tiny_ncc_pass_splits_its_match_stage():
    """A traced pass of run_slam with the NCC scan on the CPU (the probes
    record the host clock): both parts read, and together they lie
    inside the match stage."""
    import numpy as np
    import torch

    from port_bench import ncc_split
    from pre3_tpu_torch.data.synthetic import render_sequence
    from pre3_tpu_torch.ekf import slam
    from pre3_tpu_torch.frontend.pipeline import extract_features
    from pre3_tpu_torch.geometry.camera import sr4000_camera
    from pre3_tpu_torch.utils import profiling

    frames, _, _ = render_sequence(n_frames=4, n_points=300, noise=0.004)
    im = [torch.as_tensor(np.nan_to_num(np.stack([getattr(f, a)
                                                  for f in frames])))
          for a in ("intensity", "xyz", "confidence")]
    cfg = slam.SlamConfig(match_ratio=1.3, min_measured=50,
                          max_update_slots=24, matcher="ncc_warp")
    with profiling.tracing():
        with profiling.span("bench.pass"):
            profiling.probe("bench.pass.begin")
            feats = extract_features(*im, threshold=0.05, max_features=64)
            slam.run_slam(sr4000_camera(), feats, cfg, 32,
                          generator=torch.Generator().manual_seed(1),
                          images=im[0], xyz_imgs=im[1])
            profiling.probe("bench.pass.end")
    ex = profiling.export()
    stages, _ = program_trace.readings(ex, 4)
    parts = ncc_split.split(ex["probes"])
    assert parts["warp"] > 0 and parts["scan"] > 0
    assert parts["warp"] + parts["scan"] < stages["slam_step.match_ms"]
