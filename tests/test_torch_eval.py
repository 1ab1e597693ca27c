"""Host-side evaluation modules of the port against their originals:
utils/config.py and eval/reference_port.py (copies; the reference-faithful
numpy loop run on both gives bit-equal outputs), the port's batched
RANSAC VO against reference_port.adaptive_ransac_vo (tests/
test_ransac_parity.py's statistical parity), eval/stats.py on the port's
StepStats tensors, and eval/viz.py (PLY exports of the same points;
plots written where matplotlib imports, as tests/test_viz.py).
"""

import dataclasses
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.eval import reference_port as jref
from pre3_tpu.eval import stats as jstats
from pre3_tpu.eval import viz as jviz
from pre3_tpu.utils import config as jconfig
from pre3_tpu_torch.data.synthetic import _rodrigues, render_sequence
from pre3_tpu_torch.ekf.slam import StepStats
from pre3_tpu_torch.ekf.state import init_state
from pre3_tpu_torch.eval import reference_port as tref
from pre3_tpu_torch.eval import stats as tstats
from pre3_tpu_torch.eval import viz as tviz
from pre3_tpu_torch.utils import config as tconfig
from pre3_tpu_torch.utils.interop import to_numpy
from pre3_tpu_torch.vo.ransac import ransac_rigid

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("module", ["data/sr4000.py", "utils/config.py",
                                    "eval/reference_port.py"])
def test_copies_equal_their_originals(module):
    """The numpy and dataclass modules are copies, word for word."""
    assert (REPO / "pre3_tpu_torch" / module).read_text() == (
        REPO / "pre3_tpu" / module).read_text()


def test_config_dataclasses_equal():
    """Every config class has the reference's fields and defaults, and
    stays frozen (hashable)."""
    for name in ("FrontendConfig", "VoConfig", "EkfConfig", "EngineConfig"):
        a, b = getattr(tconfig, name)(), getattr(jconfig, name)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert hash(a) == hash(getattr(tconfig, name)())
        with pytest.raises(dataclasses.FrozenInstanceError):
            a.__setattr__(dataclasses.fields(a)[0].name, None)


def test_run_reference_slam_copy_is_bit_equal():
    """run_reference_slam, the reference-faithful numpy loop, on 8 frames
    through both copies: the trajectories equal to the bit."""
    frames, _, _ = render_sequence(n_frames=8, n_points=300, noise=0.004)
    got, _ = tref.run_reference_slam(frames, min_measured=50, seed=0)
    ref, _ = jref.run_reference_slam(frames, min_measured=50, seed=0)
    assert got.shape == (8, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)


def make_vo_problem(n=120, outlier_rate=0.3, seed=0, noise=0.002):
    """tests/test_ransac_parity.py's matched sets with known inliers."""
    rng = np.random.default_rng(seed)
    r = _rodrigues(rng.normal(scale=0.05, size=3))
    t = rng.normal(scale=0.05, size=3)
    p2 = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.7, 0.7, n),
                   rng.uniform(1.0, 3.0, n)], axis=-1)
    p1 = p2 @ np.asarray(r).T + t + rng.normal(scale=noise, size=(n, 3))
    n_out = int(outlier_rate * n)
    out_idx = rng.choice(n, size=n_out, replace=False)
    p1[out_idx] += rng.uniform(0.15, 0.8, (n_out, 3)) * rng.choice(
        [-1, 1], (n_out, 3))
    true_inlier = np.ones(n, bool)
    true_inlier[out_idx] = False
    return (p1.astype(np.float32), p2.astype(np.float32), true_inlier,
            np.asarray(r), t)


@pytest.mark.parametrize("outlier_rate", [0.1, 0.3, 0.5])
def test_ransac_vo_parity_with_reference_port(outlier_rate):
    """The port's batched ransac_rigid (the reference's draws) against the
    sequential adaptive loop of the copied reference_port, over 5 seeds:
    recovery no worse by > 5 pp, spurious acceptance comparably low, mean
    support within 15% — tests/test_ransac_parity.py's bounds."""
    rec_a, rec_b, fp_a, fp_b, sup_a, sup_b = [], [], [], [], [], []
    for seed in range(5):
        p1, p2, true_in, _, _ = make_vo_problem(outlier_rate=outlier_rate,
                                                seed=seed)
        _, _, inl_a, _ = tref.adaptive_ransac_vo(
            p1.astype(float), p2.astype(float),
            np.random.default_rng(100 + seed))
        gumbel = np.array(jax.random.gumbel(jax.random.PRNGKey(seed),
                                            (1024, len(p1))))
        res = ransac_rigid(torch.as_tensor(p1), torch.as_tensor(p2),
                           torch.ones(len(p1), dtype=torch.bool), batch=1024,
                           gumbel=torch.as_tensor(gumbel))
        inl_b = res.inliers.numpy()
        rec_a.append((inl_a & true_in).sum() / true_in.sum())
        rec_b.append((inl_b & true_in).sum() / true_in.sum())
        fp_a.append((inl_a & ~true_in).sum() / max((~true_in).sum(), 1))
        fp_b.append((inl_b & ~true_in).sum() / max((~true_in).sum(), 1))
        sup_a.append(inl_a.sum())
        sup_b.append(int(res.n_inliers))
    assert np.mean(rec_b) >= np.mean(rec_a) - 0.05
    assert np.mean(fp_b) <= max(np.mean(fp_a) + 0.05, 0.10)
    assert abs(np.mean(sup_b) - np.mean(sup_a)) <= 0.15 * np.mean(sup_a)


def _stats(seed=0, n=12) -> StepStats:
    rng = np.random.default_rng(seed)
    i = lambda lo, hi: torch.as_tensor(rng.integers(lo, hi, n),  # noqa: E731
                                       dtype=torch.int32)
    n_ic = i(0, 30)
    n_ic[3] = 0
    return StepStats(n_visible=i(20, 40), n_ic=n_ic, n_li=i(0, 10),
                     n_hi=i(0, 4), n_active=i(25, 33),
                     vo_ok=torch.as_tensor(rng.uniform(size=n) > 0.2),
                     vo_inliers=i(10, 90), update_overflow=i(0, 2))


def test_summarize_stats_matches_jax():
    """summarize_stats and stats_report on the port's StepStats tensors
    equal the reference's on the same values as numpy."""
    st = _stats()
    got = tstats.summarize_stats(st)
    assert got == jstats.summarize_stats(to_numpy(st))
    assert got["steps"] == 12 and got["ic_matches_min"] == 0
    assert tstats.stats_report(st) == jstats.stats_report(to_numpy(st))


def _ply_points(path):
    lines = Path(path).read_text().splitlines()
    start = lines.index("end_header") + 1
    return lines[:start], lines[start:]


def test_export_ply_and_map_match_jax(tmp_path):
    """export_ply writes the reference's file; export_map_ply writes the
    same points for the same map (inverse-depth and Cartesian slots, some
    inactive)."""
    pts = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    cols = np.random.default_rng(2).uniform(size=(50, 3))
    tviz.export_ply(str(tmp_path / "a.ply"), pts, cols)
    jviz.export_ply(str(tmp_path / "b.ply"), pts, cols)
    assert (tmp_path / "a.ply").read_text() == (tmp_path / "b.ply").read_text()
    head, rows = _ply_points(tmp_path / "a.ply")
    assert head[0] == "ply" and "element vertex 50" in head[2]
    assert len(rows) == 50

    rng = np.random.default_rng(3)
    st = init_state(n_landmarks=16, desc_dim=8, device="cpu")
    lms = np.concatenate([rng.normal(scale=0.1, size=(16, 3)),
                          rng.uniform(-0.5, 0.5, (16, 2)),
                          rng.uniform(0.2, 1.0, (16, 1))], -1)
    lms[8:, :3] = rng.normal(size=(8, 3))
    x = torch.cat([st.x[:13], torch.as_tensor(lms.reshape(-1),
                                              dtype=torch.float32)])
    st = st._replace(
        x=x, active=torch.as_tensor(rng.uniform(size=16) > 0.25),
        is_id=torch.arange(16) < 8)
    tviz.export_map_ply(str(tmp_path / "map_t.ply"), st)
    jviz.export_map_ply(str(tmp_path / "map_j.ply"),
                        jax.tree.map(jnp.asarray, to_numpy(st)))
    a = _ply_points(tmp_path / "map_t.ply")
    b = _ply_points(tmp_path / "map_j.ply")
    assert a[0] == b[0] and len(a[1]) == int(st.active.sum())
    np.testing.assert_allclose(np.loadtxt(a[1]), np.loadtxt(b[1]), atol=2e-5)


@pytest.mark.parametrize("plot", ["trajectory", "stats", "performance"])
def test_plots_write_png(tmp_path, plot):
    """The plots of tests/test_viz.py on the port's inputs, where
    matplotlib imports (it stays a lazy import: the module imports
    without it)."""
    if importlib.util.find_spec("matplotlib") is None:
        pytest.skip("matplotlib is not installed")
    from pre3_tpu_torch.utils.replay import FeaturePerformance

    p = str(tmp_path / f"{plot}.png")
    if plot == "trajectory":
        t = np.cumsum(np.random.default_rng(0).normal(size=(20, 3)), axis=0)
        tviz.plot_trajectory(p, t, gt_t=t + 0.01)
    elif plot == "stats":
        tviz.plot_slam_stats(p, to_numpy(_stats()))
    else:
        rng = np.random.default_rng(0)
        tp = rng.integers(1, 30, 20)
        tm = (tp * rng.uniform(0.3, 1.0, 20)).astype(int)
        tviz.plot_feature_performance(p, FeaturePerformance(
            slot=np.arange(20), times_predicted=tp, times_measured=tm,
            track_ratio=tm / np.maximum(tp, 1), age=rng.integers(0, 25, 20),
            is_inverse_depth=rng.uniform(size=20) > 0.5))
    assert os.path.getsize(p) > 1000
