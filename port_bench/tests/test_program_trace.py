"""The program trace's readings (port_bench/program_trace.py) on the CPU,
where the port's probes record the host clock: a tiny pass of the
frontend and run_slam read as the nine metrics read it, and nothing
where the port has no tracer."""

import numpy as np
import pytest
import torch

from port_bench import program_trace
from pre3_tpu_torch.data.synthetic import render_sequence
from pre3_tpu_torch.ekf import slam
from pre3_tpu_torch.frontend.pipeline import extract_features
from pre3_tpu_torch.geometry.camera import sr4000_camera
from pre3_tpu_torch.utils import profiling


def test_readings_of_a_tiny_pass():
    frames, _, _ = render_sequence(n_frames=4, n_points=300, noise=0.004)
    im = [torch.as_tensor(np.nan_to_num(np.stack([getattr(f, a)
                                                  for f in frames])))
          for a in ("intensity", "xyz", "confidence")]
    cfg = slam.SlamConfig(match_ratio=1.3, min_measured=50,
                          max_update_slots=24)
    with profiling.tracing():
        with profiling.span("bench.pass"):
            profiling.probe("bench.pass.begin")
            for seed in (1, 2):
                with profiling.span("bench.sequence"):
                    feats = extract_features(*im, threshold=0.05,
                                             max_features=64)
                    slam.run_slam(sr4000_camera(), feats, cfg, 32,
                                  generator=torch.Generator().manual_seed(
                                      seed))
            profiling.probe("bench.pass.end")
    got, notes = program_trace.readings(profiling.export(), 8)
    stages = [f"slam_step.{s}_ms" for s in program_trace.STAGES]
    assert set(got) == {*stages, "slam.replay_ms",
                        "frontend.device_ms_per_frame",
                        "device.idle_share.probed"}
    assert all(got[k] > 0 for k in stages)
    # the stages and the write-out close the replay (the begin probe to
    # the first stage's is the rest)
    assert sum(got[k] for k in stages) < got["slam.replay_ms"]
    assert sum(got[k] for k in stages) > 0.9 * got["slam.replay_ms"]
    assert 0.0 <= got["device.idle_share.probed"] < 1.0
    assert "captures during the timed sequences 0" in notes
    assert "probes dropped 0" in notes
    assert sum("mean step replay" in n for n in notes) == 2


def test_no_reading_without_the_tracer(monkeypatch):
    monkeypatch.delattr(profiling, "tracing")
    trace = {}
    assert program_trace.reading(trace, "slam.replay_ms") is None
    assert trace["program"] is None


@pytest.mark.parametrize("name", ["slam_step.vo_ms", "slam.replay_ms",
                                  "device.idle_share.probed"])
def test_the_readers_read_the_pass(name):
    from port_bench import run

    trace = {"program": {"readings": {name: 1.5}}}
    assert run.reader(name)(trace) == 1.5
