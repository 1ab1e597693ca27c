"""The benchmark's CPU tests: its declaration, its files, its yardstick,
its reference, and a whole run at a tiny size with the timed path sound
and broken underneath (the faults a cell of this benchmark can have)."""

import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from port_bench import check, evaluate, roofline, run as bench, traffic
from port_bench.render import render_sequence

BENCHMARK = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units_use_the_allowed_characters():
    metrics = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [
        c["name"] for c in BENCHMARK["configs"]] + [
        w[k] for w in BENCHMARK["workloads"] for k in ("config", "traffic")]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert {m["better"] for m in metrics} <= {"lower", "higher"}
    ends = {m["name"] for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in ends
        moved = next(e for e in BENCHMARK["end_to_end"]
                     if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_finds_its_files(workload):
    spec = bench.load_spec(workload)
    assert spec["limits"] and spec["end_to_end"] and spec["per_layer"]
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    for m in spec["per_layer"]:
        assert callable(bench.reader(m["name"]))
    assert (bench.BENCH / f"{spec['traffic']['kind']}.py").exists()


def test_no_run_imports_jax_or_the_jax_package():
    code = ("import sys; sys.path.insert(0, '.');"
            "import port_bench.run, port_bench.offline, port_bench.check,"
            " port_bench.tracing, port_bench.reference.ekf;"
            "from pre3_tpu_torch.utils import graphs;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT,
                         capture_output=True, text=True, check=True).stdout
    top = set(eval(out))
    assert "pre3_tpu_torch" in top
    assert not top & bench.FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    for path in (bench.BENCH / "reference").rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(from|import)\s+pre3_tpu", text, re.M), path


def test_the_renderer_copy_gives_the_ports_frames():
    from pre3_tpu_torch.data.synthetic import render_sequence as port

    n = 4
    frames, traj, _ = port(n_frames=n, n_points=832, noise=0.004,
                           x_range=(-1.8, 0.015 * n + 1.8), scene_seed=2,
                           traj_seed=102)
    ours = render_sequence(n, 2, 102, 832, 0.004, (-1.8, 0.015 * n + 1.8))
    for field in ("intensity", "xyz", "confidence"):
        a = np.stack([getattr(f, field) for f in frames])
        assert np.array_equal(a, getattr(ours, field), equal_nan=True)
    assert np.array_equal((traj.t - traj.t[0]) @ traj.r[0], ours.gt)


def test_traffic_is_the_same_work_in_another_order():
    tr = json.loads((bench.BENCH / "workloads" / "corridor.json").read_text())
    a, b = traffic.jobs(tr, 1), traffic.jobs(tr, 2**31 + 5)
    key = ("scene_seed", "traj_seed", "n_frames", "x_range")
    assert [[j[k] for k in key] for j in a] == [[j[k] for k in key] for j in b]
    assert [j["noise_seed"] for j in a] != [j["noise_seed"] for j in b]
    assert sorted(traffic.order(7, 8)) == list(range(8))
    assert traffic.generator_seed(2**31 + 9, 3) == traffic.generator_seed(
        2**31 + 9, 3) < 2**63


def test_roofline_arithmetic():
    # K1 at (512, 288): 28 flops per pair at 67 TFLOP/s bounds it
    t, by = roofline.k1_bound(512, 288)
    assert by == "operations" and t == pytest.approx(28 * 512 * 288 / 67e12)
    # K2 at 288²×128: bytes at 3.35 TB/s bound it
    t, by = roofline.k2_bound(288, 288, 128)
    assert by == "bytes"
    assert t == pytest.approx((4 * 576 * 128 + 288 + 288 * 16) / 3.35e12)
    assert roofline.k2_bound(288, 288, 128, s=16)[0] == pytest.approx(16 * t)
    sift = json.loads((bench.BENCH / "configs" / "sift_ekf_k256.json")
                      .read_text())
    ncc = dict(sift, slam=dict(sift["slam"], matcher="ncc_warp"))
    assert [len(v) for v in roofline.step_launches(sift, 288, 128).values()
            ] == [1, 2]
    assert [len(v) for v in roofline.step_launches(ncc, 256, 121).values()
            ] == [1, 1]


def test_ate_arithmetic():
    gt = np.zeros((4, 3))
    est = np.array([[0, 0, 0], [3, 4, 0], [0, 0, 0], [0, 0, 0]], float)
    assert evaluate.ate_rmse(est, gt) == pytest.approx(2.5)
    assert evaluate.pooled_ate([(est, gt), (gt, gt)]) == pytest.approx(
        np.sqrt(25 / 8))


def test_gaps():
    a = torch.tensor([1.0, -4.0, 2.0])
    assert check.rel_gap(a, a) == 0.0
    assert check.rel_gap(a + 0.04, a) == pytest.approx(0.01)


def tiny(workload: str) -> dict:
    spec = bench.load_spec(workload)
    spec["config"]["n_landmarks"] = 48
    spec["traffic"].update(frames=8, pool=2)
    return spec


def tiny_run(workload: str, seed: int = 2**31 + 11) -> dict:
    return bench.run_cell(tiny(workload), seed, 0.5, False, device="cpu",
                          workers=2)


@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_run_of_the_port_is_correct(workload):
    res = tiny_run(workload)
    assert res["correct"], res["numbers"]
    n = res["numbers"]
    assert n.get("replay_gap", 0.0) == 0.0 and n["stages"] >= 8
    assert n["state_gap_max"] < 1e-5 and n["feature_miss_share"] == 0.0


def frames(n: int = 3):
    seq = render_sequence(n, 4, 104, 832, 0.004, (-1.8, 0.015 * n + 1.8))
    return (torch.as_tensor(seq.intensity),
            torch.as_tensor(np.nan_to_num(seq.xyz)),
            torch.as_tensor(seq.confidence))


def test_the_reference_frontend_agrees_with_the_port():
    from pre3_tpu_torch.frontend.pipeline import sift_features

    from port_bench.reference import sift

    im, xyz, conf = frames()
    prog = sift_features(im, xyz, conf, 3, 96, 0.004, True)
    ref = sift.sift_features(im, xyz, conf, 3, 96, 0.004)
    miss, total, gap = check.feature_numbers(prog, ref, 96)
    assert total > 600 and miss == 0 and gap < 1e-4


def test_feature_pairs_do_not_depend_on_slot_order():
    from port_bench.reference import sift

    im, xyz, conf = frames(2)
    ref = sift.sift_features(im, xyz, conf, 3, 96, 0.004)
    perm = torch.randperm(96, generator=torch.Generator().manual_seed(0))
    swapped = sift.Features(*(torch.cat([x[:, perm], x[:, 96:]], 1)
                              for x in ref))
    assert check.feature_numbers(swapped, ref, 96)[::2] == (0, 0.0)
    moved = swapped._replace(uv=swapped.uv + 0.02)
    miss, total, _ = check.feature_numbers(moved, ref, 96)
    assert miss == total


def test_the_reference_step_agrees_with_the_ports():
    from pre3_tpu_torch.ekf.slam import SlamConfig, bootstrap_body, slam_step
    from pre3_tpu_torch.frontend.pipeline import sift_features
    from pre3_tpu_torch.geometry.camera import sr4000_camera

    from port_bench.reference import ekf, sift

    im, xyz, conf = frames(3)
    pf = sift_features(im, xyz, conf, 3, 96, 0.004, True)
    rf = sift.sift_features(im, xyz, conf, 3, 96, 0.004)
    slam = dict(min_measured=50, max_update_slots=96, match_ratio=1.5)
    cfg, sets = SlamConfig(**slam), ekf.Settings.of(slam)
    cam, k = sr4000_camera(), 64
    gen = torch.Generator().manual_seed(5)
    st = bootstrap_body(cam, check.frame(pf, 0), cfg, k, generator=gen)
    gaps = [check.state_gap(st, ekf.bootstrap(check.frame(rf, 0), k, sets,
                                              torch.float64))]
    for i in (1, 2):
        before = gen.get_state()
        new, _ = slam_step(cam, st, check.frame(pf, i), check.frame(pf, i - 1),
                           torch.tensor(i, dtype=torch.int32), cfg,
                           generator=gen)
        g2 = torch.Generator()
        g2.set_state(before)
        ref = ekf.step(ekf.as_state(st, torch.float64), check.frame(rf, i - 1),
                       check.frame(rf, i), i, sets, g2)
        gaps.append(check.state_gap(new, ref))
        st = new
    assert max(gaps) < 1e-5, gaps


def _frozen_state(slam_step):
    def step(cam, state, *a, **k):
        return state, slam_step(cam, state, *a, **k)[1]
    return step


def _altered_pose(slam_step):
    def step(cam, state, *a, **k):
        new, out = slam_step(cam, state, *a, **k)
        return new._replace(x=new.x + torch.nn.functional.pad(
            torch.full((3,), 1e-2), (0, new.x.shape[0] - 3))), out
    return step


@pytest.mark.parametrize("fault", [_frozen_state, _altered_pose])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_comes_out_not_correct(monkeypatch, fault, workload):
    import pre3_tpu_torch.ekf.slam as slam

    monkeypatch.setattr(slam, "slam_step", fault(slam.slam_step))
    res = tiny_run(workload)
    assert not res["correct"], res["numbers"]


def test_an_altered_trajectory_comes_out_not_correct(monkeypatch):
    import pre3_tpu_torch.ekf.slam as slam

    from port_bench import system

    run_slam = slam.run_slam

    def altered(*a, **k):
        tr = run_slam(*a, **k)
        return tr._replace(t=tr.t + 1e-3)

    monkeypatch.setattr(system, "run_slam", altered)
    res = tiny_run(CELLS[0])
    assert not res["correct"] and res["numbers"]["replay_gap"] > 0


def test_altered_features_come_out_not_correct(monkeypatch):
    import pre3_tpu_torch.frontend.pipeline as pipeline

    body = pipeline.sift_features

    def altered(*a, **k):
        f = body(*a, **k)
        return f._replace(desc=f.desc.roll(1, dims=-1))

    monkeypatch.setattr(pipeline, "sift_features", altered)
    res = tiny_run("sift_ekf.corridor")
    assert not res["correct"], res["numbers"]


def test_a_run_without_a_card_refuses_to_measure():
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=bench.ROOT, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
