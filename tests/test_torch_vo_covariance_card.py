"""K4 (``csrc/vo_covariance.cu``) against the plain ``torch.func`` version
on the card. Skips without a CUDA card. This file imports nothing of JAX,
so it runs on a host that has none; ``tests/conftest.py`` does, so leave
it out:

    python3 -m pytest tests/test_torch_vo_covariance_card.py \\
        --noconftest -o addopts="" -m card -s

Tolerances, over max |plain| (the gap itself where plain is 0): K4
within ``TOL_F64`` of the plain version run in float64 on the same inputs
(K4 computes in float64; ~1e-8 seen on the CPU's emulation), and within
``TOL`` of the plain version in float32, which sits up to ~7e-6 of max
|cov| from the float64 value on a well-spread fit. On the ill-conditioned
fit of 3 inliers the float32 plain version sits 2e-6–3e-4 from the float64
value (``tests/test_torch_vo_covariance.py``): there K4 is held to the
float64 value alone, and the float32 plain version's gap is printed.
"""

import numpy as np
import pytest
import torch

from pre3_tpu_torch.ops.vo_covariance import vo_covariance
from pre3_tpu_torch.vo.covariance import vo_covariance_torch
from test_torch_vo_covariance import fit_problem

TOL = 1e-5
TOL_F64 = 1e-6
ILL_CONDITIONED = {"3 inliers"}


@pytest.fixture
def card():
    """Skip unless a CUDA card is there (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(name):
    return {
        "N=288": lambda: fit_problem(288, 21),
        "N=256": lambda: fit_problem(256, 22),
        "N=1024": lambda: fit_problem(1024, 23),
        "weights 0": lambda: fit_problem(288, 24, n_inliers=0),
        "3 inliers": lambda: fit_problem(288, 25, n_inliers=3),
        "rotation 1.2 rad": lambda: fit_problem(256, 26, angle=1.2),
        "N=5": lambda: fit_problem(5, 27, n_inliers=5),
    }[name]()


def _gap(got, ref) -> float:
    """max |got − ref| ÷ max |ref| (the absolute gap where ref is 0)."""
    scale = float(ref.abs().max())
    diff = float((got - ref).abs().max())
    return diff / scale if scale else diff


@pytest.mark.card
@pytest.mark.parametrize("name", ["N=288", "N=256", "N=1024", "weights 0",
                                  "3 inliers", "rotation 1.2 rad", "N=5"])
def test_k4_matches_plain(card, name):
    """One launch per call, no fault at the synchronize, symmetric, within
    TOL_F64 of the plain version in float64 and, but on the ill-conditioned
    fit, within TOL of the plain version in float32, on the card."""
    args = [torch.as_tensor(x, dtype=torch.float32, device=card)
            for x in _case(name)]
    vo_covariance.launches = 0
    got = vo_covariance(*args)
    torch.cuda.synchronize()
    assert vo_covariance.launches == 1
    assert got.dtype == torch.float32 and torch.equal(got, got.mT)
    gap = _gap(got, vo_covariance_torch(*args))
    ref64 = vo_covariance_torch(*(x.double() for x in args))
    gap64 = _gap(got.double(), ref64)
    plain64 = _gap(vo_covariance_torch(*args).double(), ref64)
    print(f"K4 {name}: gap {gap:.3e} to plain f32, {gap64:.3e} to plain "
          f"f64 (plain f32 to f64 {plain64:.3e})", flush=True)
    assert gap64 <= TOL_F64, gap64
    assert name in ILL_CONDITIONED or gap <= TOL, gap


@pytest.mark.card
def test_k4_vmap_one_launch(card):
    """S = 16 sequences of N = 288 through torch.func.vmap: one launch,
    each sequence within TOL of the plain version on its own inputs."""
    s = 16
    problems = [fit_problem(288, 40 + i) for i in range(s)]
    r, t, p1, p2, w = (torch.as_tensor(np.stack(x), dtype=torch.float32,
                                       device=card) for x in zip(*problems))
    vo_covariance.launches = 0
    got = torch.func.vmap(vo_covariance)(r, t, p1, p2, w)
    torch.cuda.synchronize()
    assert vo_covariance.launches == 1
    worst = max(_gap(got[i], vo_covariance_torch(r[i], t[i], p1[i], p2[i],
                                                 w[i])) for i in range(s))
    worst64 = max(_gap(got[i].double(), vo_covariance_torch(
        *(x[i].double() for x in (r, t, p1, p2, w)))) for i in range(s))
    print(f"K4 vmap S={s}, N=288: worst gap {worst:.3e} to plain f32, "
          f"{worst64:.3e} to plain f64", flush=True)
    assert worst <= TOL and worst64 <= TOL_F64, (worst, worst64)


@pytest.mark.card
def test_k4_refuses_what_it_does_not_take(card):
    """A float64 or non-contiguous CUDA input raises; nothing falls
    back."""
    args = [torch.as_tensor(x, dtype=torch.float32, device=card)
            for x in fit_problem(16, 28)]
    with pytest.raises(ValueError, match="float32"):
        vo_covariance(*args[:2], args[2].double(), *args[3:])
    with pytest.raises(ValueError, match="contiguous"):
        vo_covariance(*args[:3], args[3].T.contiguous().T, args[4])
