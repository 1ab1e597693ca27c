"""What the four hand kernels' custom ops share (``ops/kernel_op.py``),
held on the CPU, one case per kernel (K1–K4) and property:

  nested-vmap     a second vmap level over the op raises;
  vmapped-launch  a vmapped tensor that reaches the launch without the
                  op's vmap rule raises: nothing falls back to a loop;
  cpu-launch      the launch takes CUDA tensors only;
  vmap-rule       under torch.func.vmap the op (the card's route: one
                  launch for S sequences) equals a loop of the plain
                  version over 3 sequences, bit for bit, with every
                  argument batched (the first on axis 1) and with some
                  shared.

No JAX: the kernels themselves run only on the card (``chip_smoke.py``
and the ``*_card.py`` tests).
"""

import numpy as np
import pytest
import torch

from pre3_tpu_torch.geometry.camera import Camera, sr4000_camera
from pre3_tpu_torch.ops import (
    inverse_depth_init, matching, ransac_score, vo_covariance,
)
from test_torch_vo_covariance import fit_problem

CAM = sr4000_camera()
S = 3


def _k1(rng, lead):
    b, n = 16, 12
    return (torch.as_tensor(rng.normal(size=(*lead, b, 3, 3)),
                            dtype=torch.float32),
            torch.as_tensor(rng.normal(size=(*lead, b, 3)),
                            dtype=torch.float32),
            torch.as_tensor(rng.normal(size=(*lead, n, 3)),
                            dtype=torch.float32),
            torch.as_tensor(rng.normal(size=(*lead, n, 3)),
                            dtype=torch.float32),
            torch.as_tensor(rng.uniform(size=(*lead, n)) > 0.2),
            torch.as_tensor(rng.uniform(1.0, 3.0, lead),
                            dtype=torch.float32)), ()


def _k2(rng, lead):
    n1, n2, d = 20, 30, 16
    return (torch.as_tensor(rng.normal(size=(*lead, n1, d)),
                            dtype=torch.float32),
            torch.as_tensor(rng.normal(size=(*lead, n2, d)),
                            dtype=torch.float32),
            torch.as_tensor(rng.uniform(size=(*lead, n2)) > 0.1)), ()


def _k3(rng, lead):
    """Candidates over the whole image, a camera state with a unit q,
    depth priors across the corridor's range; the intrinsics as the op
    takes them."""
    a = 8
    uv = rng.uniform(0, [CAM.n_cols - 1, CAM.n_rows - 1], (*lead, a, 2))
    cam13 = rng.normal(scale=0.5, size=(*lead, 13))
    q = rng.normal(size=(*lead, 4))
    cam13[..., 3:7] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    rho = rng.uniform(0.1, 2.0, (*lead, a))
    return tuple(torch.as_tensor(x, dtype=torch.float32)
                 for x in (uv, cam13, rho)), (
        *(float(x) for x in CAM[:5]), int(CAM.n_rows), int(CAM.n_cols))


def _k4(rng, lead):
    n_seq = int(np.prod(lead))
    problems = [fit_problem(288, int(rng.integers(1 << 16)))
                for _ in range(n_seq)]
    return tuple(torch.as_tensor(np.stack(x).reshape(*lead, *x[0].shape),
                                 dtype=torch.float32)
                 for x in zip(*problems)), ()


def _k2_plain(d1, d2, valid2):
    m = matching.match_descriptors(d1, d2, valid2=valid2)
    return m.index, m.dist2, m.dist2_second


def _k3_plain(uv, cam13, rho, *intrinsics):
    return inverse_depth_init.inverse_depth_init_torch(
        Camera(*intrinsics), uv, cam13, rho)


# kernel: (its declaration, its launch, its inputs, the plain version
# the op computes on one sequence, the arguments shared in the vmap rule)
KERNELS = {
    "K1": (ransac_score.K1, ransac_score._launch, _k1,
           ransac_score.score_hypotheses_torch, (0, 1)),
    "K2": (matching.K2, matching._launch_k2, _k2, _k2_plain, (1,)),
    "K3": (inverse_depth_init.K3, inverse_depth_init._launch, _k3,
           _k3_plain, (1,)),
    "K4": (vo_covariance.K4, vo_covariance._launch, _k4,
           vo_covariance.vo_covariance_closed_form, (0, 1)),
}
PROPERTIES = ("nested-vmap", "vmapped-launch", "cpu-launch", "vmap-rule")


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("prop", PROPERTIES)
@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_op(name, prop):
    kernel, launch, make, plain, shared = KERNELS[name]
    rng = np.random.default_rng(list(KERNELS).index(name))
    vmap = torch.func.vmap
    if prop == "nested-vmap":
        args, extra = make(rng, (2, S))
        inner = vmap(lambda *xs: kernel.op(*xs, *extra))
        with pytest.raises(RuntimeError, match="nested vmap"):
            vmap(inner)(*args)
    elif prop == "vmapped-launch":
        args, extra = make(rng, (S,))
        with pytest.raises(RuntimeError, match="vmapped tensor reached"):
            vmap(lambda *xs: launch(*xs, *extra))(*args)
    elif prop == "cpu-launch":
        args, extra = make(rng, ())
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            launch(*args, *extra)
    else:
        args, extra = make(rng, (S,))
        moved = (args[0].movedim(0, 1), *args[1:])
        got = vmap(lambda *xs: kernel.op(*xs, *extra),
                   in_dims=(1,) + (0,) * (len(args) - 1))(*moved)
        dims = tuple(None if i in shared else 0 for i in range(len(args)))
        one = tuple(a[1] if i in shared else a for i, a in enumerate(args))
        got_shared = vmap(lambda *xs: kernel.op(*xs, *extra),
                          in_dims=dims)(*one)
        for s in range(S):
            ref = _outputs(plain(*(a[s] for a in args), *extra))
            ref_shared = _outputs(plain(*(
                a if i in shared else a[s] for i, a in enumerate(one)),
                *extra))
            for g, g_sh, r, r_sh in zip(_outputs(got), _outputs(got_shared),
                                        ref, ref_shared):
                assert torch.equal(g[s], r) and torch.equal(g_sh[s], r_sh)
