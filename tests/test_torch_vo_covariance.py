"""The IFT covariance's closed form (``ops/vo_covariance.py``, what kernel
K4 computes) against the ``torch.func`` derivatives of
``vo/covariance.py`` on the CPU. No JAX: ``tests/test_torch_ekf.py`` holds
the port's covariance to the reference's, and ``tests/test_torch_vo.py``'s
``test_vo_pair_matches_jax`` holds ``vo_pair``'s to it bit for bit.

The closed form computes in float64 whatever its inputs, as K4 does.
Tolerances, over max |torch.func| (0 with all weights 0, where both are
exactly 0): 1e-10 against torch.func in float64, where the two differ by
summation order only (~1e-14 seen). On float32 inputs: 1e-6 against
torch.func run in float64 on the same inputs (the output's rounding;
~1e-8 seen), and 1e-5 against torch.func in float32, whose own result
sits ~1e-6–7e-6 from the float64 value on a well-spread fit. On a fit of
3 inliers A is ill-conditioned, and float32 torch.func sits 2e-6–3e-4 from
the float64 value (1.3e-5 on this file's case): there the
float64 value is the yardstick, and the float32 path must lie farther
from it than the closed form.
"""

import numpy as np
import pytest
import torch

from pre3_tpu_torch.data.synthetic import _rodrigues
from pre3_tpu_torch.ops.vo_covariance import (
    _cov_op, _launch, vo_covariance, vo_covariance_closed_form,
)
from pre3_tpu_torch.vo.covariance import vo_covariance_torch

TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
TOL_F64 = 1e-6  # float32 inputs, against torch.func in float64
CASES = ("N=256", "N=288", "weights 0", "3 inliers", "rotation 1.2 rad")
ILL_CONDITIONED = {"3 inliers"}


def fit_problem(n: int, seed: int, angle: float = 0.05,
                n_inliers: int | None = None):
    """(r, t, p1, p2, w) as float64 numpy: a rotation by ``angle`` about
    a random axis, a few cm of translation, N points 1–4 m in front of
    the camera with 5 mm of noise, ~70% inliers (or the first
    ``n_inliers``)."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    r = _rodrigues(angle * axis / np.linalg.norm(axis))
    t = rng.normal(scale=0.05, size=3)
    p2 = np.c_[rng.uniform(-1.5, 1.5, (n, 2)), rng.uniform(1.0, 4.0, n)]
    p1 = p2 @ r.T + t + rng.normal(scale=0.005, size=(n, 3))
    w = (rng.uniform(size=n) < 0.7).astype(np.float64)
    if n_inliers is not None:
        w = np.zeros(n)
        w[:n_inliers] = 1.0
    return r, t, p1, p2, w


def _case(name: str):
    return {
        "N=256": lambda: fit_problem(256, 0),
        "N=288": lambda: fit_problem(288, 1),
        "weights 0": lambda: fit_problem(256, 2, n_inliers=0),
        "3 inliers": lambda: fit_problem(256, 3, n_inliers=3),
        "rotation 1.2 rad": lambda: fit_problem(288, 4, angle=1.2),
    }[name]()


def _gap(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max()) / float(
        ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", CASES)
def test_closed_form_matches_torch_func(name, dtype):
    """The closed form equals the hessian/jacfwd derivatives to summation
    order; with all weights 0 both are exactly 0 (module docstring)."""
    args = [torch.as_tensor(x, dtype=dtype) for x in _case(name)]
    ref = vo_covariance_torch(*args)
    got = vo_covariance_closed_form(*args)
    assert got.dtype == dtype and got.shape == (6, 6)
    assert torch.equal(got, got.mT)
    if name == "weights 0":
        assert not ref.any() and not got.any()
        return
    if dtype == torch.float32:
        ref64 = vo_covariance_torch(*(x.double() for x in args))
        assert _gap(got, ref64) <= TOL_F64, _gap(got, ref64)
        if name in ILL_CONDITIONED:
            assert _gap(ref, ref64) > _gap(got, ref64)
            return
    assert _gap(got, ref) <= TOL[dtype], _gap(got, ref)


def test_cpu_wrapper_is_the_torch_func_path():
    """On CPU tensors the production wrapper is the plain torch.func
    version, bit for bit, and launches nothing."""
    args = [torch.as_tensor(x, dtype=torch.float32)
            for x in fit_problem(288, 5)]
    vo_covariance.launches = 0
    assert torch.equal(vo_covariance(*args), vo_covariance_torch(*args))
    assert vo_covariance.launches == 0


def test_vmap_rule_matches_a_loop():
    """Under torch.func.vmap the custom op (the card's route: one launch
    for S sequences) equals a loop of the closed form over 3 sequences,
    bit for bit, with the fit batched and with it shared."""
    s = 3
    problems = [fit_problem(288, 10 + i) for i in range(s)]
    r, t, p1, p2, w = (torch.as_tensor(np.stack(x), dtype=torch.float32)
                       for x in zip(*problems))
    got = torch.func.vmap(_cov_op)(r, t, p1, p2, w)
    shared = torch.func.vmap(lambda a, b, c: _cov_op(r[1], t[1], a, b, c))(
        p1, p2, w)
    assert got.shape == (s, 6, 6)
    for i in range(s):
        assert torch.equal(got[i], vo_covariance_closed_form(
            r[i], t[i], p1[i], p2[i], w[i]))
        assert torch.equal(shared[i], vo_covariance_closed_form(
            r[1], t[1], p1[i], p2[i], w[i]))


def test_kernel_launch_refuses_cpu_tensors():
    """K4's launch takes CUDA tensors only: nothing falls back."""
    args = [torch.as_tensor(x, dtype=torch.float32)
            for x in fit_problem(8, 6)]
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        _launch(*args)
