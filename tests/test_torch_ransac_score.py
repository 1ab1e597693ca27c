"""RANSAC support scorer: the port's plain version vs the JAX reference.

The port's ``score_hypotheses_torch`` is the CPU path and the oracle of the
CUDA kernel K1 (``pre3_tpu_torch/csrc/ransac_score.cu``); the kernel itself
is checked against it on the card by ``chip_smoke.py``. Here the plain
version is held against the reference's ``score_hypotheses_xla`` and its
Pallas kernel in interpret mode, on the same numpy-seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.data.synthetic import _rodrigues
from pre3_tpu.ops.ransac_score import (
    score_hypotheses_pallas, score_hypotheses_xla,
)
from pre3_tpu_torch.ops.ransac_score import (
    residuals_torch, score_hypotheses, score_hypotheses_torch,
)

THR = 0.01


def make_problem(b=100, n=90, seed=0):
    """Hypothesis 0 is the true motion (as tests/test_ransac_score.py)."""
    rng = np.random.default_rng(seed)
    r = np.stack([_rodrigues(rng.normal(scale=0.2, size=3)) for _ in range(b)])
    t = rng.normal(scale=0.1, size=(b, 3))
    p2 = rng.uniform(-1, 1, (n, 3))
    p1 = p2 @ r[0].T + t[0] + rng.normal(scale=0.01, size=(n, 3))
    valid = rng.uniform(size=n) > 0.2
    arrays = [a.astype(np.float32) for a in (r, t, p1, p2)] + [valid]
    return arrays


def _both(arrays):
    j = [jnp.asarray(a) for a in arrays] + [jnp.asarray(THR, jnp.float32)]
    t = [torch.as_tensor(a) for a in arrays] + [torch.tensor(THR)]
    return j, t


def _assert_scores_agree(arrays, s_ref, e_ref, s_t, e_t, band_abs, err_atol,
                         err_rtol):
    """Support must be equal, except that a point whose residual lies
    within ``band_abs`` of the threshold may fall either way; err is
    compared on the hypotheses without such points."""
    r, t, p1, p2, valid = (torch.as_tensor(a) for a in arrays)
    resid2 = residuals_torch(r, t, p1, p2)
    band = (valid[None] & ((resid2 - THR).abs() <= band_abs)).sum(-1).numpy()
    s_ref, e_ref = np.asarray(s_ref), np.asarray(e_ref)
    s_t, e_t = s_t.numpy(), e_t.numpy()
    assert np.all(np.abs(s_ref.astype(np.int64) - s_t) <= band)
    clean = band == 0
    assert clean.mean() > 0.9
    np.testing.assert_allclose(e_t[clean], e_ref[clean], rtol=err_rtol,
                               atol=err_atol)


@pytest.mark.parametrize("b,n,seed", [(100, 90, 0), (33, 250, 1),
                                      (1024, 256, 2), (512, 288, 3)])
def test_plain_matches_xla(b, n, seed):
    """Both compute the direct-difference residual in f32, in another
    summation order: residuals differ by a few ulp (|p| ≤ ~2, so
    ≤ 1e-6 absolute), and err by a relative 1e-5 at most."""
    arrays = make_problem(b, n, seed)
    j, t = _both(arrays)
    s_ref, e_ref = score_hypotheses_xla(*j)
    s_t, e_t = score_hypotheses_torch(*t)
    assert s_t.dtype == torch.int32 and e_t.dtype == torch.float32
    _assert_scores_agree(arrays, s_ref, e_ref, s_t, e_t, band_abs=1e-6,
                         err_atol=1e-9, err_rtol=1e-5)


@pytest.mark.parametrize("b,n,seed", [(100, 90, 0), (64, 200, 4)])
def test_plain_matches_pallas_interpret(b, n, seed):
    """The Pallas kernel (interpret mode, tile_b=32, as
    tests/test_ransac_score.py) uses the expanded form
    ‖pred‖² − 2·pred·p1 + ‖p1‖², which cancels: its residual error is
    ~eps·‖p‖² ≤ 1e-5 absolute here, hence the band and atol 1e-5 (the
    reference's own test tolerance for err). b=100 is not a tile multiple."""
    arrays = make_problem(b, n, seed)
    j, t = _both(arrays)
    s_ref, e_ref = score_hypotheses_pallas(*j, tile_b=32, interpret=True)
    s_t, e_t = score_hypotheses_torch(*t)
    _assert_scores_agree(arrays, s_ref, e_ref, s_t, e_t, band_abs=1e-5,
                         err_atol=1e-5, err_rtol=0.0)


def test_hypothesis_zero_wins():
    """Hypothesis 0 is the true motion → it has the most support."""
    _, t = _both(make_problem(seed=1))
    s, _ = score_hypotheses_torch(*t)
    assert int(torch.argmax(s)) == 0


def test_all_invalid():
    arrays = make_problem(seed=2)
    arrays[4] = np.zeros_like(arrays[4])
    j, t = _both(arrays)
    s, e = score_hypotheses_torch(*t)
    s_ref, _ = score_hypotheses_pallas(*j, tile_b=32, interpret=True)
    assert int(s.sum()) == 0 and int(np.sum(np.asarray(s_ref))) == 0
    assert torch.all(e == 0)


def test_wrapper_takes_plain_path_on_cpu():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; equality is exact (same function)."""
    _, t = _both(make_problem(b=40, n=70, seed=5))
    before = score_hypotheses.launches
    s, e = score_hypotheses(*t)
    s_p, e_p = score_hypotheses_torch(*t)
    assert torch.equal(s, s_p) and torch.equal(e, e_p)
    assert score_hypotheses.launches == before


def test_wrapper_has_no_fallback_for_other_devices():
    """A device without a kernel raises instead of running the plain path."""
    _, t = _both(make_problem(b=8, n=16, seed=6))
    with pytest.raises(ValueError, match="no kernel"):
        score_hypotheses(*(x.to("meta") for x in t))
