"""The port's multi-rank dry run: ``python3 -m
pre3_tpu_torch.parallel.dryrun`` at two CPU ranks over gloo runs the five
stages of the reference's ``dryrun_multichip`` and prints their ok lines;
and the problem builders it carries equal the test helpers they copy.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from pre3_tpu_torch.parallel import dryrun
from tests.test_ba import make_ba_problem
from tests.test_vo import make_rigid_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_two_ranks_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "pre3_tpu_torch.parallel.dryrun",
         "--world-size", "2", "--device", "cpu", "--timeout", "300"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun")]
    assert [ln.split(" ok:")[0] for ln in lines] == [
        "dryrun sharded-ransac", "dryrun sharded-ba",
        "dryrun pose-sharded-ba", "dryrun stage-pipeline",
        "dryrun multiprocess"], proc.stdout
    assert "2 ranks agree" in lines[-1]
    assert "global_lm=3" in lines[2]


# pixels: the camera model in f32 in another order (torch vs XLA)
UV_ATOL = 1e-4


def _equal(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, name
    if got.dtype == bool or name in ("points", "obs_xyz", "kf_t"):
        np.testing.assert_array_equal(got, ref, err_msg=name)
    else:
        np.testing.assert_allclose(got, ref, atol=UV_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(n_kf=5, n_lm=48, seed=21, t_noise=0.03, p_noise=0.03),
    dict(n_kf=4, n_lm=24, seed=21, t_noise=0.03, p_noise=0.03),
    dict(n_kf=6, n_lm=40, seed=3, px_noise=0.5),
])
def test_make_ba_problem_equals_test_helper(kw):
    got, got_gt = dryrun.make_ba_problem(**kw)
    ref, ref_gt = make_ba_problem(**kw)
    for name in ref._fields:
        r = getattr(ref, name)
        if r is not None:
            _equal(getattr(got, name).numpy(), r, name)
    for g, r, name in zip(got_gt, ref_gt, ("kf_t", "kf_q", "points")):
        _equal(g, r, name)


@pytest.mark.parametrize("kw", [
    dict(n=96, noise=0.003, outlier_frac=0.3, seed=11),
    dict(n=50, seed=0),
])
def test_make_rigid_problem_equals_test_helper(kw):
    got = dryrun.make_rigid_problem(**kw)
    ref = make_rigid_problem(**kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
