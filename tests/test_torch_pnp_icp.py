"""EPnP, DLS-PnP, ICP and GICP, port vs JAX reference: the 12 cases of
tests/test_pnp_icp.py on the same numpy-seeded inputs, each run through
the reference and through the port (CPU), with the reference's own
assertions on the port's result beside the comparison.

Tolerances: r, t, ok and err are compared, never the eigenvector bases
(unique up to sign and, for EPnP's null space, up to a rotation). The
port turns each EPnP control-point axis to have its largest component
positive (the reference keeps LAPACK's sign): on exact correspondences
the pose does not depend on that sign, on noisy pixels the linear
solution moves within the noise, seen 2.1e-4 on the noisy case, which is
held to AXIS_SIGN_TOL, AXIS_SIGN_ERR_TOL = 5e-4, 1e-5 in r and t. Both
sides are f32 with the same iteration counts; what differs is reduction
order and the eigensolver, so r and t agree to ~1e-5 on clean inputs and
to 1e-4 under noise (the GN steps of DLS and GICP amplify the seed's
rounding a little); ok is equal; err, a mean of small residuals, to 1e-6
absolute. ICP's rmse is the square root of an expanded ‖a‖² − 2a·b +
‖b‖² (f32, ‖a‖² up to ~20 m²), so near an exact fit it is that
expansion's rounding, ~sqrt(1.2e-7 · 20) ≈ 1.5e-3 m, on either side: it
is held to RMSE_TOL = 2e-3 m and n_inliers exactly. The RANSAC
cross-checks take the reference's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.geometry.camera import project, sr4000_camera
from pre3_tpu.geometry.quaternion import e2q, q2r
from pre3_tpu.vo import icp as jicp
from pre3_tpu.vo import pnp as jpnp
from pre3_tpu.vo.ransac import ransac_rigid as jransac
from pre3_tpu_torch.geometry.camera import sr4000_camera as tcamera
from pre3_tpu_torch.vo import icp as ticp
from pre3_tpu_torch.vo import pnp as tpnp
from pre3_tpu_torch.vo.ransac import ransac_rigid as transac

CAM = sr4000_camera()
R_TOL, T_TOL, ERR_TOL, RMSE_TOL = 1e-4, 1e-4, 1e-6, 2e-3
AXIS_SIGN_TOL, AXIS_SIGN_ERR_TOL = 5e-4, 1e-5


def scene(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.uniform(-1.0, 1.0, n), rng.uniform(-0.8, 0.8, n),
        rng.uniform(1.5, 4.0, n),
    ], axis=-1).astype(np.float32)


def pose(seed=1, t_scale=0.3, r_scale=0.15):
    rng = np.random.default_rng(seed)
    r = np.asarray(q2r(e2q(jnp.asarray(
        rng.uniform(-r_scale, r_scale, 3).astype(np.float32)))))
    t = rng.uniform(-t_scale, t_scale, 3).astype(np.float32)
    return r, t


def structured_scene(n=160, seed=20):
    """Points on two planes (tests/test_pnp_icp.py's GICP scene)."""
    rng = np.random.default_rng(seed)
    a = np.stack([rng.uniform(-1, 1, n // 2), rng.uniform(-1, 1, n // 2),
                  np.full(n // 2, 2.0)], -1)
    b = np.stack([rng.uniform(-1, 1, n - n // 2),
                  np.full(n - n // 2, 0.8),
                  rng.uniform(1.5, 2.5, n - n // 2)], -1)
    return np.concatenate([a, b]).astype(np.float32)


def angle_deg(r, r_ref) -> float:
    return float(np.degrees(np.arccos(np.clip(
        (np.trace(np.asarray(r) @ np.asarray(r_ref).T) - 1) / 2, -1, 1))))


def run_both(name, *args, **kw):
    """The reference's and the port's function of that name on the same
    numpy inputs: (reference result, port result), both as numpy."""
    jmod, tmod = (jpnp, tpnp) if hasattr(jpnp, name) else (jicp, ticp)
    ref = getattr(jmod, name)(*(jnp.asarray(a) for a in args), **kw)
    got = getattr(tmod, name)(*(torch.as_tensor(a) for a in args), **kw)
    return (type(ref)(*(np.asarray(x) for x in ref)),
            type(got)(*(x.numpy() for x in got)))


def assert_same(ref, got, r_tol=R_TOL, t_tol=T_TOL, err_tol=ERR_TOL):
    assert bool(got.ok) == bool(ref.ok)
    np.testing.assert_allclose(got.r, ref.r, atol=r_tol)
    np.testing.assert_allclose(got.t, ref.t, atol=t_tol)
    if hasattr(ref, "err"):
        np.testing.assert_allclose(got.err, ref.err, atol=err_tol)
    else:
        assert int(got.n_inliers) == int(ref.n_inliers)
        np.testing.assert_allclose(got.rmse, ref.rmse, atol=RMSE_TOL)


def _pnp_case(case):
    """(pw, uv, valid, r_gt, t_gt) of tests/test_pnp_icp.py's EPnP cases."""
    if case == "clean":
        pw, (r_gt, t_gt) = scene(), pose()
    elif case == "masked":
        pw, (r_gt, t_gt) = scene(), pose(seed=2)
    else:
        pw, (r_gt, t_gt) = scene(n=60, seed=3), pose(seed=4)
    pc = pw @ r_gt.T + t_gt
    uv = pc[:, :2] / pc[:, 2:3]
    valid = np.ones(len(pw), bool)
    if case == "masked":
        uv[30:] = 777.0  # corrupt masked-out entries
        valid[30:] = False
    if case == "noisy":
        uv = (uv + np.random.default_rng(5).normal(0, 5e-4, uv.shape))
    return pw, uv.astype(np.float32), valid, r_gt, t_gt


@pytest.mark.parametrize("case,r_atol,t_atol", [
    ("clean", 2e-3, 5e-3), ("masked", 5e-3, 1e-2), ("noisy", None, None)])
def test_epnp_matches_jax(case, r_atol, t_atol):
    """TestEpnp's three cases (clean, masked points ignored, noisy pixels):
    the reference's pose checks on the port's result, and r/t/ok/err equal
    to the reference's within R_TOL/T_TOL/ERR_TOL (AXIS_SIGN_TOL in r and
    t on noisy pixels)."""
    pw, uv, valid, r_gt, t_gt = _pnp_case(case)
    ref, got = run_both("epnp", pw, uv, valid)
    assert bool(got.ok)
    if r_atol is None:
        assert angle_deg(got.r, r_gt) < 0.5
        assert np.linalg.norm(got.t - t_gt) < 0.02
        assert_same(ref, got, AXIS_SIGN_TOL, AXIS_SIGN_TOL, AXIS_SIGN_ERR_TOL)
    else:
        np.testing.assert_allclose(got.r, r_gt, atol=r_atol)
        np.testing.assert_allclose(got.t, t_gt, atol=t_atol)
        assert_same(ref, got)


def test_epnp_pixel_interface_matches_jax():
    """epnp_camera: distorted pixels through the SR4000 model."""
    pw = scene(n=50, seed=6)
    r_gt, t_gt = pose(seed=7, t_scale=0.1, r_scale=0.05)
    pc = pw @ r_gt.T + t_gt
    uv_px = np.asarray(project(CAM, jnp.asarray(pc)))
    inb = ((uv_px[:, 0] > 2) & (uv_px[:, 0] < 173)
           & (uv_px[:, 1] > 2) & (uv_px[:, 1] < 141))
    ref = jpnp.epnp_camera(CAM, jnp.asarray(pw), jnp.asarray(uv_px),
                           jnp.asarray(inb))
    got = tpnp.epnp_camera(tcamera(), torch.as_tensor(pw),
                           torch.as_tensor(uv_px), torch.as_tensor(inb))
    ref = type(ref)(*(np.asarray(x) for x in ref))
    got = type(got)(*(x.numpy() for x in got))
    assert bool(got.ok)
    assert angle_deg(got.r, r_gt) < 1.0
    assert np.linalg.norm(got.t - t_gt) < 0.05
    assert_same(ref, got)


@pytest.mark.parametrize("case", ["known", "outliers"])
def test_icp_matches_jax(case):
    """TestIcp's known transform and partial overlap with 20% outliers."""
    if case == "known":
        p = scene(n=120, seed=8)
        r_gt, t_gt = pose(seed=9, t_scale=0.08, r_scale=0.06)
        q = (p - t_gt) @ r_gt
        kw = {}
    else:
        p = scene(n=150, seed=10)
        r_gt, t_gt = pose(seed=11, t_scale=0.05, r_scale=0.04)
        q = (p - t_gt) @ r_gt
        q[120:] = np.random.default_rng(12).uniform(-3, 3, (30, 3))
        kw = dict(trim_dist=0.15)
    ones = np.ones(len(p), bool)
    ref, got = run_both("icp", p, q.astype(np.float32), ones, ones, **kw)
    assert bool(got.ok)
    if case == "known":
        np.testing.assert_allclose(got.r, r_gt, atol=1e-3)
        np.testing.assert_allclose(got.t, t_gt, atol=2e-3)
        assert float(got.rmse) < 1e-3
    else:
        assert angle_deg(got.r, r_gt) < 1.0
        assert np.linalg.norm(got.t - t_gt) < 0.02
    assert_same(ref, got)


def _ransac_both(key, p, q, batch=256):
    """The reference's ransac_rigid under ``key`` and the port's under the
    same draws (jax.random.gumbel of the key, as the reference samples)."""
    valid = np.ones(len(p), bool)
    ref = jransac(key, jnp.asarray(p), jnp.asarray(q), jnp.asarray(valid),
                  batch=batch)
    gumbel = torch.as_tensor(np.array(jax.random.gumbel(key, (batch,
                                                              len(p)))))
    got = transac(torch.as_tensor(p), torch.as_tensor(q),
                  torch.as_tensor(valid), batch=batch, gumbel=gumbel)
    return ref, got


def test_icp_cross_checks_ransac_vo_matches_jax():
    """ICP_RANSAC.m as an assertion, on the port: its RANSAC (the
    reference's draws) and its ICP agree within 0.5° / 0.01 m, and each
    equals its reference counterpart."""
    p = scene(n=100, seed=13)
    r_gt, t_gt = pose(seed=14, t_scale=0.06, r_scale=0.05)
    q = ((p - t_gt) @ r_gt + np.random.default_rng(15).normal(
        0, 1e-3, p.shape)).astype(np.float32)
    rr_ref, rr = _ransac_both(jax.random.PRNGKey(0), p, q)
    ones = np.ones(len(p), bool)
    ri_ref, ri = run_both("icp", p, q, ones, ones)
    assert bool(rr.ok) and bool(ri.ok)
    assert angle_deg(rr.r.numpy(), ri.r) < 0.5
    assert np.linalg.norm(rr.t.numpy() - ri.t) < 0.01
    np.testing.assert_allclose(rr.r.numpy(), np.asarray(rr_ref.r), atol=R_TOL)
    np.testing.assert_allclose(rr.t.numpy(), np.asarray(rr_ref.t), atol=T_TOL)
    assert_same(ri_ref, ri)


def test_dls_pnp_recovers_pose_matches_jax():
    """TestDlsPnp clean: exact pose, object-space cost < 1e-8."""
    pw = scene(seed=5)
    r_gt, t_gt = pose(seed=6)
    pc = pw @ r_gt.T + t_gt
    uv = (pc[:, :2] / pc[:, 2:3]).astype(np.float32)
    ref, got = run_both("dls_pnp", pw, uv, np.ones(len(pw), bool))
    assert bool(got.ok)
    np.testing.assert_allclose(got.r, r_gt, atol=1e-3)
    np.testing.assert_allclose(got.t, t_gt, atol=2e-3)
    assert float(got.err) < 1e-8
    assert_same(ref, got)


def test_dls_pnp_refines_noisy_epnp_matches_jax():
    """TestDlsPnp noisy: GN on the object-space cost is no worse than its
    EPnP seed under that cost, and both equal the reference's."""
    rng = np.random.default_rng(7)
    pw = scene(n=60, seed=8)
    r_gt, t_gt = pose(seed=9)
    pc = pw @ r_gt.T + t_gt
    uv = (pc[:, :2] / pc[:, 2:3] + rng.normal(
        scale=2e-3, size=(len(pw), 2))).astype(np.float32)
    valid = np.ones(len(pw), bool)
    seed_ref, seed_res = run_both("epnp", pw, uv, valid)
    ref, res = run_both("dls_pnp", pw, uv, valid)

    v = np.concatenate([uv, np.ones((len(pw), 1), np.float32)], axis=-1)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    proj = np.eye(3)[None] - v[:, :, None] * v[:, None, :]

    def cost(r, t):
        e = np.einsum("nij,nj->ni", proj, pw @ np.asarray(r).T
                      + np.asarray(t))
        return float(np.sum(e * e))

    assert cost(res.r, res.t) <= cost(seed_res.r, seed_res.t) + 1e-10
    np.testing.assert_allclose(res.r, r_gt, atol=2e-2)
    assert_same(seed_ref, seed_res)
    assert_same(ref, res)


def test_gicp_aligns_known_transform_matches_jax():
    p = structured_scene()
    r_gt, t_gt = pose(seed=21, t_scale=0.06, r_scale=0.05)
    q = ((p - t_gt) @ r_gt).astype(np.float32)
    ones = np.ones(len(p), bool)
    ref, got = run_both("gicp", p, q, ones, ones)
    assert bool(got.ok)
    assert angle_deg(got.r, r_gt) < 1.0
    assert np.linalg.norm(got.t - t_gt) < 0.02
    assert_same(ref, got)


def test_gicp_cross_checks_icp_and_ransac_matches_jax():
    """GICP_test_each_camera.m: GICP, ICP and RANSAC VO agree on the port,
    and each equals its reference counterpart."""
    p = structured_scene(seed=22)
    r_gt, t_gt = pose(seed=23, t_scale=0.05, r_scale=0.04)
    q = ((p - t_gt) @ r_gt + np.random.default_rng(24).normal(
        0, 1e-3, p.shape)).astype(np.float32)
    ones = np.ones(len(p), bool)
    rg_ref, rg = run_both("gicp", p, q, ones, ones)
    ri_ref, ri = run_both("icp", p, q, ones, ones)
    rr_ref, rr = _ransac_both(jax.random.PRNGKey(2), p, q)
    assert bool(rg.ok) and bool(ri.ok) and bool(rr.ok)
    for other in (ri.r, rr.r.numpy()):
        assert angle_deg(rg.r, other) < 0.5
    assert np.linalg.norm(rg.t - ri.t) < 0.01
    assert_same(rg_ref, rg)
    assert_same(ri_ref, ri)
    np.testing.assert_allclose(rr.r.numpy(), np.asarray(rr_ref.r), atol=R_TOL)


def test_gicp_beats_icp_on_sliding_planes_matches_jax():
    """A dense plane and a sparse orthogonal wall, slid in plane: GICP
    pins the slide within 1 cm, as the reference's does."""
    rng = np.random.default_rng(25)
    a = np.stack([rng.uniform(-1, 1, 200), rng.uniform(-1, 1, 200),
                  np.full(200, 2.0)], -1)
    b = np.stack([np.full(30, 0.9), rng.uniform(-1, 1, 30),
                  rng.uniform(1.6, 2.4, 30)], -1)
    p = np.concatenate([a, b]).astype(np.float32)
    t_gt = np.array([0.05, 0.03, 0.0], np.float32)
    q = p - t_gt
    ones = np.ones(len(p), bool)
    ref, got = run_both("gicp", p, q, ones, ones, iters=30)
    assert np.linalg.norm(got.t - t_gt) < 0.01
    assert_same(ref, got)


def test_surface_covariances_invalid_rows_match_jax():
    """The k-NN PCA covariances with a third of the points invalid: the
    invalid rows' neighbourhoods are the lowest indices (all −inf rows,
    jax.lax.top_k's tie order), and every Σ equals the reference's (Σ
    does not see the eigenvectors' signs)."""
    p = structured_scene(n=60, seed=26)
    valid = np.random.default_rng(27).uniform(size=60) > 0.33
    ref = np.asarray(jicp.surface_covariances(jnp.asarray(p),
                                              jnp.asarray(valid)))
    got = ticp.surface_covariances(torch.as_tensor(p),
                                   torch.as_tensor(valid)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("flip", [0, 1, 2])
def test_epnp_does_not_depend_on_axis_signs(flip, monkeypatch):
    """An eigensolver returning an axis of the control points with the
    other sign (as the card's and LAPACK's do on some inputs) gives the
    same control points, hence the same pose on noisy pixels (to the
    rounding of CPU reductions, held to 1e-5; a kept sign moves it by
    ~2e-4)."""
    pw, uv, valid, _, _ = _pnp_case("noisy")
    args = [torch.as_tensor(a) for a in (pw, uv, valid)]
    base = tpnp.epnp(*args)
    eigh = tpnp.sym3_eigh  # the control points' eigensolver

    def flipped(a):
        eva, eve = eigh(a)
        if a.shape[-1] == 3:
            eve = eve.clone()
            eve[:, flip] = -eve[:, flip]
        return eva, eve

    monkeypatch.setattr(tpnp, "sym3_eigh", flipped)
    got = tpnp.epnp(*args)
    np.testing.assert_allclose(got.r.numpy(), base.r.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), base.t.numpy(), atol=1e-5)
