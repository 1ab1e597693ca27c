"""K3 (``csrc/inverse_depth_init.cu``) against its plain version on the
card. Skips without a CUDA card. This file imports nothing of JAX, so it
runs on a host that has none; ``tests/conftest.py`` does, so leave it out:

    python3 -m pytest tests/test_torch_inverse_depth_init_card.py \\
        --noconftest -o addopts="" -m card -s

Tolerance: per output block (y, ∂y/∂cam, ∂y/∂uv, ∂y/∂ρ), the largest
|kernel − plain| over the block's largest |plain| entry stays under
``TOL``; NaNs (the pixel Jacobian exactly at the principal point, where
sqrt's tangent is 0/0 in both) must sit in the same places.
"""

import numpy as np
import pytest
import torch

from pre3_tpu_torch.geometry.camera import sr4000_camera
from pre3_tpu_torch.ops.inverse_depth_init import (
    inverse_depth_init, inverse_depth_init_torch,
)

CAM = sr4000_camera()
TOL = 1e-5
BLOCKS = ("y", "jc", "juv", "jr")


@pytest.fixture
def card():
    """Skip unless a CUDA card is there (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _camera(rng, q_norm=1.0):
    cam13 = rng.normal(scale=0.5, size=13)
    q = rng.normal(size=4)
    cam13[3:7] = q_norm * q / np.linalg.norm(q)
    return cam13


def _pixels(rng, a):
    return rng.uniform(0, [CAM.n_cols - 1, CAM.n_rows - 1], (a, 2))


def _case(name, rng):
    """(uv [A, 2], cam13 [13], rho [A]) as float64 numpy."""
    w, h = CAM.n_cols - 1, CAM.n_rows - 1
    rho = rng.uniform(0.1, 2.0, 8)
    if name == "principal point":
        uv = np.array([[CAM.cx, CAM.cy], [CAM.cx + 1e-3, CAM.cy - 1e-3],
                       [CAM.cx - 0.05, CAM.cy + 0.02], [CAM.cx + 0.5, CAM.cy]])
        return uv, _camera(rng), rho[:4]
    if name == "image corners":
        uv = np.array([[0.0, 0.0], [w, 0.0], [0.0, h], [w, h]])
        return uv, _camera(rng), rho[:4]
    if name == "non-unit q":
        return _pixels(rng, 8), _camera(rng, q_norm=1.37), rho
    if name == "rho 1e-3 and 10":
        return _pixels(rng, 8), _camera(rng), np.array([1e-3, 10.0] * 4)
    if name == "A=8":
        return _pixels(rng, 8), _camera(rng), rho
    if name == "A=32":
        return _pixels(rng, 32), _camera(rng), rng.uniform(0.1, 2.0, 32)
    raise KeyError(name)


def _gaps(got, ref) -> dict:
    """Per block: max |got − ref| ÷ max |ref| over the non-NaN entries;
    the NaN layouts must agree."""
    out = {}
    for name, g, r in zip(BLOCKS, got, ref):
        g, r = g.double().cpu(), r.double().cpu()
        assert torch.equal(torch.isnan(g), torch.isnan(r)), name
        ok = ~torch.isnan(r)
        scale = float(r[ok].abs().max()) if ok.any() else 0.0
        diff = float((g - r)[ok].abs().max()) if ok.any() else 0.0
        out[name] = diff / scale if scale else diff
    return out


@pytest.mark.card
@pytest.mark.parametrize("name", ["principal point", "image corners",
                                  "non-unit q", "rho 1e-3 and 10", "A=8",
                                  "A=32"])
def test_k3_matches_plain(card, name):
    """One launch per call, the kernel's blocks within TOL of the plain
    version's on the card."""
    uv, cam13, rho = (torch.as_tensor(x, dtype=torch.float32, device=card)
                      for x in _case(name, np.random.default_rng(7)))
    inverse_depth_init.launches = 0
    got = inverse_depth_init(CAM, uv, cam13, rho)
    assert inverse_depth_init.launches == 1
    gaps = _gaps(got, inverse_depth_init_torch(CAM, uv, cam13, rho))
    print(f"K3 {name} (A={uv.shape[0]}): " + ", ".join(
        f"{k} {v:.3e}" for k, v in gaps.items()), flush=True)
    assert all(v <= TOL for v in gaps.values()), gaps


@pytest.mark.card
def test_k3_vmap_one_launch(card):
    """S = 16 sequences of A = 8 through torch.func.vmap: one launch, each
    sequence within TOL of the plain version on its own inputs."""
    rng = np.random.default_rng(11)
    s, a = 16, 8
    uv = np.stack([_pixels(rng, a) for _ in range(s)])
    cam13 = np.stack([_camera(rng) for _ in range(s)])
    rho = rng.uniform(0.1, 2.0, (s, a))
    uv, cam13, rho = (torch.as_tensor(x, dtype=torch.float32, device=card)
                      for x in (uv, cam13, rho))
    inverse_depth_init.launches = 0
    got = torch.func.vmap(
        lambda u, c, r: inverse_depth_init(CAM, u, c, r))(uv, cam13, rho)
    assert inverse_depth_init.launches == 1
    worst = dict.fromkeys(BLOCKS, 0.0)
    for i in range(s):
        gaps = _gaps([g[i] for g in got],
                     inverse_depth_init_torch(CAM, uv[i], cam13[i], rho[i]))
        worst = {k: max(worst[k], gaps[k]) for k in BLOCKS}
    print(f"K3 vmap S={s}, A={a}: " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()), flush=True)
    assert all(v <= TOL for v in worst.values()), worst
