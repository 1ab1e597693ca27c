"""The full-engine walkthrough (``examples/run_synthetic_slam.py``) and its
port, ``pre3_tpu_torch/examples/run_synthetic_slam.py``, on the CPU.

16 frames, not fewer: the keyframe selection (4° / 0.05 m) takes two
keyframes from 8–12 of these frames, and frame 0's keyframe carries no
observation record, so ``ba_problem_from_slam`` finds no landmark seen
from two keyframes and returns None. The reference's walkthrough then
fails inside ``bundle_adjust`` and the port's raises; at 16 frames both
select 4 keyframes.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pre3_tpu_torch.examples import run_synthetic_slam

ROOT = Path(__file__).resolve().parents[1]
N_FRAMES = 16
# The reference's walkthrough in a subprocess (its own JAX process on the
# CPU): the keyframes it selects and the ATEs it prints, as one JSON line.
REFERENCE = """
import json, sys
from examples import run_synthetic_slam as ex

seen = {}
select = ex.select_keyframes

def recorded(*args, **kwargs):
    ks = select(*args, **kwargs)
    seen["keyframes"] = [int(i) for i, v in zip(ks.indices, ks.valid) if v]
    return ks

ex.select_keyframes = recorded
lines = []
print_ = print
ex.print = lambda *a, **k: lines.append(" ".join(map(str, a)))
ex.main(sys.argv[1], n_frames=int(sys.argv[2]))

def number(prefix, key):
    line = next(x for x in lines if x.startswith(prefix))
    return float(line.split(key)[1].split()[0])

seen.update(ate_vo=number("VO:", "ATE"), ate_slam=number("SLAM:", "ATE"),
            rpe_slam=number("SLAM:", "RPE"),
            ate_smoothed=number("smoothed", "ATE:"))
print_(json.dumps(seen))
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("port")
    return out, run_synthetic_slam.main(str(out), n_frames=N_FRAMES,
                                        device="cpu")


def _ply_vertices(path: Path) -> np.ndarray:
    lines = path.read_text().splitlines()
    assert lines[:2] == ["ply", "format ascii 1.0"]
    n = int(next(x for x in lines if x.startswith("element vertex")).split()[2])
    body = lines[lines.index("end_header") + 1:]
    assert len(body) == n
    return np.array([[float(v) for v in row.split()] for row in body])


def test_walkthrough_runs_every_stage(port):
    """The PLY parses and holds one vertex per BA landmark, the BA cost
    never rises, the ATEs are finite, the plots exist where matplotlib
    imports."""
    out, res = port
    pts = _ply_vertices(out / "ba_map.ply")
    assert pts.shape == (res["n_points"], 3) and res["n_points"] > 0
    assert np.isfinite(pts).all()
    cost = res["cost"]
    assert len(cost) == 11 and np.all(np.diff(cost) <= 0), cost
    assert cost[-1] < cost[0]
    for key in ("ate_vo", "ate_slam", "rpe_slam", "ate_smoothed"):
        assert np.isfinite(res[key]), key
    assert len(res["keyframes"]) >= 3 and res["keyframes"][0] == 0
    pngs = [out / "trajectory.png", out / "stats.png"]
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    assert all(p.is_file() for p in pngs) is has_mpl
    assert sorted(res["files"]) == sorted(
        str(p) for p in [out / "ba_map.ply"] + (pngs if has_mpl else []))


def test_walkthrough_agrees_with_reference(port, tmp_path):
    """The reference's walkthrough at the same frame count: the same
    keyframes (selected on the SLAM trajectory, which the two runs draw
    from different generators; on this sequence both select the same),
    and each ATE within 2× of the port's."""
    _, res = port
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(tmp_path), str(N_FRAMES)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])
    assert ref["keyframes"] == res["keyframes"]
    for key in ("ate_vo", "ate_slam", "rpe_slam", "ate_smoothed"):
        assert 0.5 <= res[key] / ref[key] <= 2.0, (key, res[key], ref[key])
