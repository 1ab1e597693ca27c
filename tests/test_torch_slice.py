"""The VO dead-reckoning slice end to end, port vs JAX reference, plus the
pins that keep the port standing alone: copied numpy modules equal to the
originals, and every port module importable without JAX."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.data import synthetic as jsyn
from pre3_tpu.eval import trajectory as jtraj
from pre3_tpu.frontend.pipeline import extract_features as jextract
from pre3_tpu.vo.dead_reckoning import run_sequence as jrun
from pre3_tpu_torch.data import synthetic as tsyn
from pre3_tpu_torch.eval import trajectory as ttraj
from pre3_tpu_torch.frontend.pipeline import extract_features as textract
from pre3_tpu_torch.utils.interop import to_numpy, to_torch
from pre3_tpu_torch.vo.dead_reckoning import run_sequence as trun

REPO = Path(__file__).resolve().parent.parent
K, BATCH, N_FRAMES = 128, 256, 8


def test_slice_matches_jax():
    """render → extract_features → run_sequence on 8 frames with the
    reference's own draws injected: ok and n_inliers equal, trajectory
    within 2e-5 m / 2e-5 (≤ 1e-6 per chained pair, seen 1.2e-6 total)."""
    frames, traj, _ = tsyn.render_sequence(n_frames=N_FRAMES, n_points=300,
                                           noise=0.004)
    stack = [np.stack([getattr(f, a) for f in frames])
             for a in ("intensity", "xyz", "confidence")]
    key = jax.random.PRNGKey(3)
    gumbel = np.stack([np.array(jax.random.gumbel(k, (BATCH, K)))
                       for k in jax.random.split(key, N_FRAMES - 1)])

    jfeats = jax.vmap(lambda i, x, c: jextract(
        i, x, c, threshold=0.05, max_features=K))(*stack)
    ref = jax.tree.map(np.asarray, jrun(jfeats, key, batch=BATCH))
    tfeats = textract(*(torch.as_tensor(a) for a in stack), threshold=0.05,
                      max_features=K)
    got = to_numpy(trun(tfeats, gumbel=torch.as_tensor(gumbel), batch=BATCH))

    np.testing.assert_array_equal(got.ok, ref.ok)
    assert got.ok.all()
    np.testing.assert_array_equal(got.n_inliers, ref.n_inliers)
    np.testing.assert_allclose(got.t, ref.t, atol=2e-5)
    np.testing.assert_allclose(got.q, ref.q, atol=2e-5)
    gt = (traj.t - traj.t[0]) @ traj.r[0]
    assert ttraj.ate_rmse(got.t, gt, align=False) < 0.05


RENDER_CASES = {
    "default": dict(n_frames=3),
    "corridor": dict(n_frames=3, n_points=832, noise=0.004,
                     x_range=(-1.8, 5.64)),
    "floor_tilt_loop": dict(n_frames=6, n_points=200, floor_y=1.2,
                            tilt_deg=12.0, loop=2),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_renderer_copy_is_byte_equal(case):
    """data/synthetic.py is a copy (the port cannot import pre3_tpu,
    whose package __init__ imports jax): the same seeds render the same
    bytes, trajectory and scene."""
    kw = RENDER_CASES[case]
    jf, jt, js = jsyn.render_sequence(**kw)
    tf, tt, ts = tsyn.render_sequence(**kw)
    for a, b in zip(jf, tf):
        for field in ("intensity", "xyz", "confidence"):
            assert getattr(a, field).tobytes() == getattr(b, field).tobytes()
        assert a.timestamp == b.timestamp
    assert jt.t.tobytes() == tt.t.tobytes() and jt.r.tobytes() == tt.r.tobytes()
    assert js.points.tobytes() == ts.points.tobytes()
    assert js.patterns.tobytes() == ts.patterns.tobytes()


def test_trajectory_metrics_copy_is_equal():
    rng = np.random.default_rng(0)
    est = rng.normal(size=(40, 3))
    gt = est @ jsyn._rodrigues(np.array([0.1, 0.2, -0.3])).T + 0.5 + (
        rng.normal(scale=0.01, size=(40, 3)))
    for align in (True, False):
        assert ttraj.ate_rmse(est, gt, align) == jtraj.ate_rmse(est, gt, align)
    for delta in (1, 3):
        assert ttraj.rpe_translation(est, gt, delta) == jtraj.rpe_translation(
            est, gt, delta)
    for a, b in zip(ttraj.align_umeyama(est, gt, True),
                    jtraj.align_umeyama(est, gt, True)):
        np.testing.assert_array_equal(a, b)


def test_port_imports_without_jax():
    """Every module of pre3_tpu_torch imports with jax blocked."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "pre3_tpu_torch").rglob("*.py")
    )
    modules = [m.removesuffix(".__init__") for m in modules]
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'pre3_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(sys.argv), 'ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 20


def test_interop_round_trip():
    """Reference NamedTuples (as numpy) → the port's types on a device →
    numpy, unchanged; unknown NamedTuples keep their type."""
    frames, _, _ = jsyn.render_sequence(n_frames=1)
    f = frames[0]
    jf = jax.tree.map(np.asarray, jextract(
        jnp.asarray(f.intensity), jnp.asarray(f.xyz),
        jnp.asarray(f.confidence), max_features=32))
    tf = to_torch(jf, device="cpu")
    assert type(tf).__module__ == "pre3_tpu_torch.frontend.pipeline"
    assert tf.valid.dtype == torch.bool and tf.uv.dtype == torch.float32
    back = to_numpy(tf)
    for name in jf._fields:
        np.testing.assert_array_equal(getattr(back, name), getattr(jf, name))
    assert type(to_torch(f._replace(timestamp=np.float32(0.0)),
                         device="cpu")).__name__ == "Frame"
