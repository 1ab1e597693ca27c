"""EKF modules of the port vs the JAX reference, module by module.

Every case feeds the same numpy-seeded inputs (or the reference's own
state, carried across with ``utils.interop``) to the JAX function and its
counterpart in pre3_tpu_torch. JAX's random draws are computed from its
keys and injected into the port. Tolerances are stated per test; the two
packages run the same float32 arithmetic and differ by the order of
reductions (a few ulp per step).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.backend import plane_fit as jplane
from pre3_tpu.data.synthetic import _rodrigues, render_sequence
from pre3_tpu.ekf import map_management as jmm
from pre3_tpu.ekf import measurement as jmeas
from pre3_tpu.ekf import one_point_ransac as jopr
from pre3_tpu.ekf import prediction as jpred
from pre3_tpu.ekf import update as jupd
from pre3_tpu.ekf.slam import SlamConfig as JCfg
from pre3_tpu.ekf.slam import bootstrap_state as jbootstrap
from pre3_tpu.ekf.state import init_state as jinit_state
from pre3_tpu.frontend.pipeline import extract_features as jextract
from pre3_tpu.geometry import camera as jcamera
from pre3_tpu.geometry import inverse_depth as jid
from pre3_tpu.ops.small_chol import chol_solve_unrolled as jchol
from pre3_tpu.vo.covariance import vo_covariance as jcov
from pre3_tpu.vo.dead_reckoning import vo_pair as jvo_pair
from pre3_tpu_torch.backend import plane_fit as tplane
from pre3_tpu_torch.ekf import map_management as tmm
from pre3_tpu_torch.ekf import measurement as tmeas
from pre3_tpu_torch.ekf import one_point_ransac as topr
from pre3_tpu_torch.ekf import prediction as tpred
from pre3_tpu_torch.ekf import update as tupd
from pre3_tpu_torch.ekf.state import EkfState, init_state as tinit_state
from pre3_tpu_torch.geometry import camera as tcamera
from pre3_tpu_torch.geometry import inverse_depth as tid
from pre3_tpu_torch.ops.small_chol import chol_solve_unrolled as tchol
from pre3_tpu_torch.ops.vo_covariance import vo_covariance as tcov
from pre3_tpu_torch.utils.interop import to_numpy, to_torch

JCAM = jcamera.sr4000_camera()
TCAM = tcamera.sr4000_camera()
K, KF = 24, 64


def _np(tree):
    return jax.tree.map(np.array, tree)  # writable numpy copies


def _jit(fn, *bound, **static):
    """The reference function compiled as one program: its eager
    op-by-op dispatch is what makes a CPU test slow."""
    return jax.jit(functools.partial(fn, *bound, **static))


def _gumbel(key, shape):
    return torch.as_tensor(np.array(jax.random.gumbel(key, shape)))


def _close(got, ref, atol, rtol=0.0, fields=None):
    """Port NamedTuple (tensors) vs reference NamedTuple (numpy), field
    by field; bool and int fields exactly."""
    got = to_numpy(got)
    for name in fields or ref._fields:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(ref, name))
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=rtol,
                                       err_msg=name)


@pytest.fixture(scope="module")
def case():
    """A real EKF situation: the reference bootstraps a 24-slot map from
    frame 0 of a rendered sequence, predicts with a small motion, and
    matches the map against frame 1. Everything as numpy."""
    frames, _, _ = render_sequence(n_frames=2, n_points=300, noise=0.004)
    feats = [_np(jextract(jnp.asarray(f.intensity), jnp.asarray(f.xyz),
                          jnp.asarray(f.confidence), threshold=0.05,
                          max_features=KF)) for f in frames]
    cfg = JCfg(match_ratio=1.3)
    st0 = _jit(jbootstrap, JCAM, cfg=cfg, n_landmarks=K)(
        jax.tree.map(jnp.asarray, feats[0]), jax.random.PRNGKey(0))
    vo = jvo_pair(*(jax.tree.map(jnp.asarray, f) for f in feats),
                  jax.random.PRNGKey(1), batch=256)
    assert bool(vo.ok)
    u = jnp.concatenate([vo.delta.t, vo.delta.q])
    st1 = jpred.predict(st0, u)
    obs = _jit(jmeas.predict_measurements, JCAM)(st1)
    obs, st1 = _jit(jmeas.search_ic_matches, ratio=1.3)(
        obs, st1, jax.tree.map(jnp.asarray, feats[1]))
    assert int(obs.ic.sum()) > 10
    return dict(st0=_np(st0), u=np.asarray(u), st1=_np(st1), obs=_np(obs),
                feats=feats)


# ---------------------------------------------------------------------------
# geometry/camera.py, geometry/inverse_depth.py
# ---------------------------------------------------------------------------


def test_camera_model_matches_jax():
    """distort/undistort/project/unproject/in_fov on random points:
    pixels within 2e-4 px (f32 at ~100 px), rays within 1e-6, gate equal."""
    rng = np.random.default_rng(0)
    pc = np.c_[rng.uniform(-1.5, 1.5, (200, 2)),
               rng.uniform(-0.5, 4.0, 200)].astype(np.float32)
    uvd = rng.uniform(-5, 180, (200, 2)).astype(np.float32)
    jt, tt = jnp.asarray, torch.as_tensor
    for jf, tf, arg, atol in (
        (jcamera.project_point, tcamera.project_point, pc, 2e-4),
        (jcamera.project, tcamera.project, pc, 2e-4),
        (jcamera.distort, tcamera.distort, uvd, 2e-4),
        (jcamera.undistort, tcamera.undistort, uvd, 2e-4),
        (jcamera.unproject, tcamera.unproject, uvd, 1e-6),
    ):
        np.testing.assert_allclose(tf(TCAM, tt(arg)).numpy(),
                                   np.asarray(jf(JCAM, jt(arg))), atol=atol,
                                   rtol=1e-6, err_msg=jf.__name__)
    uv_p = np.asarray(jcamera.project(JCAM, jt(pc)))
    np.testing.assert_array_equal(
        tcamera.in_fov(TCAM, tt(pc), tt(uv_p)).numpy(),
        np.asarray(jcamera.in_fov(JCAM, jt(pc), jt(uv_p))))


def test_inverse_depth_matches_jax():
    """All seven functions of geometry/inverse_depth.py on random
    landmarks: within 2e-6 (rtol 1e-5 where the values reach 1/ρ)."""
    rng = np.random.default_rng(1)
    n = 50
    y = np.c_[rng.normal(scale=0.5, size=(n, 3)), rng.uniform(-1, 1, (n, 2)),
              rng.uniform(0.2, 1.5, n)].astype(np.float32)
    t_wc = rng.normal(scale=0.3, size=3).astype(np.float32)
    q = rng.normal(size=4)
    q = (q / np.linalg.norm(q)).astype(np.float32)
    uvd = rng.uniform(10, 140, (n, 2)).astype(np.float32)
    sig = rng.uniform(0.001, 0.05, n).astype(np.float32)
    jt, tt = jnp.asarray, torch.as_tensor
    pairs = [
        (jid.ray_from_angles(jt(y[:, 3]), jt(y[:, 4])),
         tid.ray_from_angles(tt(y[:, 3]), tt(y[:, 4]))),
        (jid.angles_from_ray(jid.ray_from_angles(jt(y[:, 3]), jt(y[:, 4]))),
         tid.angles_from_ray(tid.ray_from_angles(tt(y[:, 3]), tt(y[:, 4])))),
        (jax.vmap(lambda uv, r: jid.inverse_depth_point(
            JCAM, uv, jt(t_wc), jt(q), r))(jt(uvd), jt(y[:, 5])),
         tid.inverse_depth_point(TCAM, tt(uvd), tt(t_wc), tt(q), tt(y[:, 5]))),
        (jid.inverse_depth_to_cartesian(jt(y)),
         tid.inverse_depth_to_cartesian(tt(y))),
        (jid.inverse_depth_camera_ray(jt(y), jt(t_wc), jt(q)),
         tid.inverse_depth_camera_ray(tt(y), tt(t_wc), tt(q))),
        (jid.linearity_index(jt(y), jt(sig), jt(t_wc)),
         tid.linearity_index(tt(y), tt(sig), tt(t_wc))),
        (jid.conversion_jacobian(jt(y)), tid.conversion_jacobian(tt(y))),
    ]
    for i, (ref, got) in enumerate(pairs):
        for r, g in zip(jax.tree.leaves(ref), jax.tree.leaves(
                tuple(got) if isinstance(got, tuple) else got)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-6,
                                       rtol=1e-5, err_msg=f"pair {i}")


def _four_passes(cam, uv, cam13, rho):
    """add_features' landmark initialization as it was written before
    ops/inverse_depth_init.py: the value and three vmap(jacfwd) passes."""
    from torch.func import jacfwd, vmap

    def y_of(c, uv_, rho_):
        return tid.inverse_depth_point(cam, uv_, c[0:3], c[3:7], rho_)

    return (y_of(cam13, uv, rho),
            vmap(lambda u, r: jacfwd(lambda c: y_of(c, u, r))(cam13))(uv, rho),
            vmap(lambda u, r: jacfwd(lambda uu: y_of(cam13, uu, r))(u))(
                uv, rho),
            vmap(lambda u, r: jacfwd(lambda rr: y_of(cam13, u, rr))(r))(
                uv, rho))


def _init_inputs(rng, lead, a):
    """Candidates over the whole image, a camera state with a unit q,
    depth priors across the corridor's range."""
    uv = rng.uniform(0, [TCAM.n_cols - 1, TCAM.n_rows - 1], (*lead, a, 2))
    cam13 = rng.normal(scale=0.5, size=(*lead, 13))
    q = rng.normal(size=(*lead, 4))
    cam13[..., 3:7] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    rho = rng.uniform(0.1, 2.0, (*lead, a))
    return [torch.as_tensor(x, dtype=torch.float32) for x in (uv, cam13, rho)]


@pytest.mark.parametrize("form,a", [("plain", 8), ("plain", 32)])
def test_inverse_depth_init_matches_four_passes(form, a):
    """ops/inverse_depth_init.py on the CPU: the plain version and the
    wrapper equal the four passes add_features ran before, bit for bit,
    at the step's A = 8 and the bootstrap's A = 32 (the custom op under
    vmap: tests/test_torch_kernel_op.py)."""
    from pre3_tpu_torch.ops.inverse_depth_init import (
        inverse_depth_init, inverse_depth_init_torch,
    )

    rng = np.random.default_rng(a)
    uv, cam13, rho = _init_inputs(rng, (), a)
    ref = _four_passes(TCAM, uv, cam13, rho)
    for got in (inverse_depth_init_torch(TCAM, uv, cam13, rho),
                inverse_depth_init(TCAM, uv, cam13, rho)):
        assert [g.shape for g in got] == [(a, 6), (a, 6, 13), (a, 6, 2),
                                          (a, 6)]
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


# ---------------------------------------------------------------------------
# vo/covariance.py, ops/small_chol.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_inliers", [6, 120])
def test_vo_covariance_matches_jax(n_inliers):
    """torch.func hessian/jacfwd vs jax: the 6×6 covariance within rtol
    1e-4 of its largest entry (an inverse of a 6×6 Hessian in f32)."""
    rng = np.random.default_rng(n_inliers)
    n = 128
    r = _rodrigues(rng.normal(scale=0.05, size=3)).astype(np.float32)
    t = rng.normal(scale=0.05, size=3).astype(np.float32)
    p2 = np.c_[rng.uniform(-1.5, 1.5, (n, 2)),
               rng.uniform(1.0, 4.0, n)].astype(np.float32)
    p1 = (p2 @ r.T + t + rng.normal(scale=0.005, size=(n, 3))).astype(
        np.float32)
    w = np.zeros(n, np.float32)
    w[:n_inliers] = 1.0
    args = (r, t, p1, p2, w)
    ref = np.asarray(jcov(*map(jnp.asarray, args)))
    got = tcov(*map(torch.as_tensor, args)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("n", [2, 6])
def test_small_chol_matches_jax(n):
    """Unrolled batched Cholesky solve: same recurrences, within 1e-5
    relative (SPD with a unit ridge, condition ≤ ~1e3)."""
    rng = np.random.default_rng(n)
    a = rng.normal(size=(64, n, n)).astype(np.float32)
    s = a @ np.swapaxes(a, -1, -2) + np.eye(n, dtype=np.float32)
    b = rng.normal(size=(64, n)).astype(np.float32)
    ref = np.asarray(jchol(jnp.asarray(s), jnp.asarray(b)))
    got = tchol(torch.as_tensor(s), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# ekf/state.py, ekf/prediction.py
# ---------------------------------------------------------------------------


def test_init_state_matches_jax():
    q0 = np.array([0.98, 0.1, -0.15, 0.05], np.float32)
    for q in (None, q0):
        ref = _np(jinit_state(n_landmarks=5, desc_dim=7,
                              q0=None if q is None else jnp.asarray(q)))
        got = tinit_state(n_landmarks=5, desc_dim=7,
                          q0=None if q is None else torch.as_tensor(q),
                          device="cpu")
        _close(got, ref, atol=0.0)


def test_process_noise_matches_jax():
    """The control-noise constant: f32 Jacobian, f64 product, to 1e-6
    relative of the largest entry."""
    ref = jpred.process_noise_u()
    got = tpred.process_noise_u().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max())


def test_predict_matches_jax(case):
    """Odometry and constant-velocity predictions from the reference's
    bootstrapped state: x within 1e-6, P within 1e-9 absolute (entries
    ≤ 1e-3)."""
    st0 = to_torch(case["st0"], device="cpu")
    jst0 = jax.tree.map(jnp.asarray, case["st0"])
    u = case["u"]
    _close(tpred.predict(st0, torch.as_tensor(u)),
           _np(jpred.predict(jst0, jnp.asarray(u))), atol=1e-6,
           fields=("x",))
    _close(tpred.predict(st0, torch.as_tensor(u)),
           _np(jpred.predict(jst0, jnp.asarray(u))), atol=1e-9,
           fields=("p",))
    pn = np.diag(np.arange(1, 8) * 1e-5).astype(np.float32)
    _close(tpred.predict(st0, torch.as_tensor(u), torch.as_tensor(pn)),
           _np(jpred.predict(jst0, jnp.asarray(u), jnp.asarray(pn))),
           atol=1e-6, fields=("x", "p"))
    _close(tpred.predict_cv(st0, dt=0.1), _np(jpred.predict_cv(jst0, dt=0.1)),
           atol=1e-6, fields=("x", "p"))


# ---------------------------------------------------------------------------
# ekf/measurement.py
# ---------------------------------------------------------------------------


def test_predict_measurements_matches_jax(case):
    """h within 2e-4 px, Jacobians within 2e-4 (entries ~250 px/m), S
    within 1e-4 relative; visibility exact. Inactive slots are NaN in
    both."""
    st1 = case["st1"]
    ref = _np(_jit(jmeas.predict_measurements, JCAM)(
        jax.tree.map(jnp.asarray, st1)))
    got = to_numpy(tmeas.predict_measurements(
        TCAM, to_torch(st1, device="cpu")))
    np.testing.assert_array_equal(got.visible, ref.visible)
    act = st1.active
    assert act.sum() > 10
    for name, atol in (("h", 2e-4), ("hc", 2e-4), ("hl", 2e-4)):
        np.testing.assert_allclose(getattr(got, name)[act],
                                   getattr(ref, name)[act], atol=atol,
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(got.s[act], ref.s[act], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("gate_first", [False, True])
def test_search_ic_matches_matches_jax(case, gate_first):
    """IC matching of the map against frame 1, with and without the gate
    before the ratio test: ic, z, z_xyz and the refreshed descriptors
    exact (same matches, gathered values)."""
    st1, frame = case["st1"], case["feats"][1]
    jst = jax.tree.map(jnp.asarray, st1)
    jobs = _jit(jmeas.predict_measurements, JCAM)(jst)
    ref_obs, ref_st = _np(_jit(
        jmeas.search_ic_matches, ratio=1.3, gate_first=gate_first)(
        jobs, jst, jax.tree.map(jnp.asarray, frame)))
    tobs = to_torch(_np(jobs), device="cpu")
    got_obs, got_st = tmeas.search_ic_matches(
        tobs, to_torch(st1, device="cpu"), to_torch(frame, device="cpu"),
        ratio=1.3,
        gate_first=gate_first)
    _close(got_obs, ref_obs, atol=0.0, fields=("ic", "z", "z_xyz"))
    _close(got_st, ref_st, atol=0.0, fields=("desc",))
    assert ref_obs.ic.sum() > 10


# ---------------------------------------------------------------------------
# ekf/update.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_slots", [None, 12])
def test_kalman_update_matches_jax(case, max_slots):
    """Full-width and bounded updates on the reference's IC matches: x
    within 2e-6, P within 1e-8 absolute (entries ≤ 1e-3; the port solves
    the gain by one triangular solve where JAX uses cho_solve, same
    algebra)."""
    st1, obs = case["st1"], case["obs"]
    use = obs.ic.copy()
    if max_slots is not None:
        use[np.flatnonzero(use)[max_slots - 2:]] = False  # under the bound
    ref = _np(_jit(jupd.kalman_update, max_slots=max_slots)(
        jax.tree.map(jnp.asarray, st1), jax.tree.map(jnp.asarray, obs),
        jnp.asarray(use)))
    got = tupd.kalman_update(to_torch(st1, device="cpu"),
                             to_torch(obs, device="cpu"),
                             torch.as_tensor(use), max_slots=max_slots)
    _close(got, ref, atol=2e-6, fields=("x",))
    _close(got, ref, atol=1e-8, fields=("p",))
    assert np.abs(ref.x - st1.x).max() > 1e-4  # the update did something


def test_kalman_update_overflowing_bound_matches_jax(case):
    """More used slots than max_slots: both drop the same (highest-index)
    surplus."""
    st1, obs = case["st1"], case["obs"]
    ref = _np(_jit(jupd.kalman_update, max_slots=6)(
        jax.tree.map(jnp.asarray, st1), jax.tree.map(jnp.asarray, obs),
        jnp.asarray(obs.ic)))
    got = tupd.kalman_update(to_torch(st1, device="cpu"),
                             to_torch(obs, device="cpu"),
                             torch.as_tensor(obs.ic), max_slots=6)
    _close(got, ref, atol=2e-6, fields=("x",))
    _close(got, ref, atol=1e-8, fields=("p",))


# ---------------------------------------------------------------------------
# ekf/one_point_ransac.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_points,max_slots", [(3, None), (1, None),
                                                (3, 16)])
def test_one_point_ransac_matches_jax(case, n_points, max_slots):
    """The reference's Gumbel draws injected: the same li set; then the
    hi rescue at the post-li state gives the same hi set."""
    st1, obs = case["st1"], case["obs"]
    key = jax.random.PRNGKey(n_points * 7 + (max_slots or 0))
    jst, jobs = jax.tree.map(jnp.asarray, st1), jax.tree.map(jnp.asarray, obs)
    ref = np.asarray(jax.jit(lambda k, s, o: jopr.one_point_ransac(
        k, JCAM, s, o, batch=64, n_points=n_points, max_slots=max_slots))(
        key, jst, jobs))
    m = topr.pool_size(K, max_slots)
    got = topr.one_point_ransac(TCAM, to_torch(st1, device="cpu"),
                                to_torch(obs, device="cpu"), batch=64,
                                n_points=n_points, max_slots=max_slots,
                                gumbel=_gumbel(key, (64, m)))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 5
    jpost = _jit(jupd.kalman_update)(jst, jobs, jnp.asarray(ref))
    ref_hi, _ = _jit(jopr.rescue_hi_inliers, JCAM)(jpost, jobs,
                                                   jnp.asarray(ref))
    got_hi, _ = topr.rescue_hi_inliers(TCAM,
                                       to_torch(_np(jpost), device="cpu"),
                                       to_torch(obs, device="cpu"), got)
    np.testing.assert_array_equal(got_hi.numpy(), np.asarray(ref_hi))


def test_one_point_ransac_noise_sources(case):
    st1 = to_torch(case["st1"], device="cpu")
    obs = to_torch(case["obs"], device="cpu")
    li = topr.one_point_ransac(TCAM, st1, obs, batch=32,
                               generator=torch.Generator().manual_seed(0))
    assert li.dtype == torch.bool and int(li.sum()) > 5
    with pytest.raises(ValueError, match="gumbel noise or a generator"):
        topr.one_point_ransac(TCAM, st1, obs, batch=32)
    with pytest.raises(ValueError, match="gumbel must have shape"):
        topr.one_point_ransac(TCAM, st1, obs, batch=32,
                              gumbel=torch.zeros(32, K + 1))


# ---------------------------------------------------------------------------
# ekf/map_management.py
# ---------------------------------------------------------------------------


def test_delete_and_convert_match_jax(case):
    """delete_features (ratio, age and invisibility rules) then
    convert_to_cartesian (linearity index, bounded strip rewrite): masks
    exact, x within 1e-6, P within 1e-9."""
    st = case["st1"]
    rng = np.random.default_rng(5)
    aged = st._replace(
        times_predicted=rng.integers(0, 12, K).astype(np.int32),
        times_measured=rng.integers(0, 12, K).astype(np.int32),
        last_visible=rng.integers(0, 30, K).astype(np.int32),
        init_frame=rng.integers(0, 4, K).astype(np.int32),
    )
    step = np.int32(40)
    for kw in (dict(), dict(max_age=38, max_invisible=15)):
        ref = _np(_jit(jmm.delete_features, **kw)(
            jax.tree.map(jnp.asarray, aged), jnp.asarray(step)))
        got = tmm.delete_features(to_torch(aged, device="cpu"),
                                  torch.as_tensor(step), **kw)
        _close(got, ref, atol=0.0)
    # a tight map makes the linearity test pass for the near landmarks
    tight = st._replace(p=(st.p * 1e-4).astype(np.float32))
    for thr, mc in ((0.1, 16), (10.0, 3)):
        ref = _np(_jit(jmm.convert_to_cartesian, threshold=thr,
                       max_conversions=mc)(jax.tree.map(jnp.asarray, tight)))
        got = tmm.convert_to_cartesian(to_torch(tight, device="cpu"),
                                       threshold=thr,
                                       max_conversions=mc)
        _close(got, ref, atol=1e-6, rtol=1e-6, fields=("x", "is_id"))
        _close(got, ref, atol=1e-9, fields=("p",))
        assert (ref.is_id != tight.is_id).sum() >= min(mc, 1)


@pytest.mark.parametrize("sampling,max_adds,quad", [
    ("topk", 8, True), ("topk", 8, False), ("weighted", 8, True),
    ("topk", 4 * K, True),  # max_adds > K: clamped to K
])
def test_add_features_matches_jax(case, sampling, max_adds, quad):
    """Batched covariance augmentation from frame 1 onto the predicted
    state, with ties everywhere (stable top-k): every field within 1e-6
    (x, P, descriptors), masks and counters exact."""
    st1, obs = case["st1"], case["obs"]
    frame = case["feats"][1]
    # free some slots so adds can land
    drop = np.zeros(K, bool)
    drop[[1, 4, 9, 15, 16, 22]] = True
    jst = jmm._deactivate(jax.tree.map(jnp.asarray, st1), jnp.asarray(drop))
    key = jax.random.PRNGKey(3)
    kw = dict(max_adds=max_adds, min_measured=25, depth_range_quadratic=quad,
              depth_range_d0=1.5, sampling=sampling)
    step, n_meas = np.int32(7), np.int32(4)
    ref = _np(jax.jit(lambda *a: jmm.add_features(JCAM, *a[:-1], key=a[-1],
                                                  **kw))(
        jst, jax.tree.map(jnp.asarray, frame), jnp.asarray(obs.h),
        jnp.asarray(step), jnp.asarray(n_meas), key))
    got = tmm.add_features(TCAM, to_torch(_np(jst), device="cpu"),
                           to_torch(frame, device="cpu"),
                           torch.as_tensor(obs.h), torch.as_tensor(step),
                           torch.as_tensor(n_meas),
                           gumbel=_gumbel(key, (KF,)), **kw)
    _close(got, ref, atol=1e-6, rtol=1e-6)
    assert ref.active.sum() > np.asarray(jst.active).sum()


# ---------------------------------------------------------------------------
# backend/plane_fit.py
# ---------------------------------------------------------------------------


def _tilted_floor_xyz(tilt_deg=-20.0):
    """Tilted-floor xyz image (the geometry of tests/test_plane_fit.py):
    lower rows see the floor plane 1 m below, upper rows a wall 4 m
    ahead. The plane-fit prior on it is a real, non-identity q0."""
    h, w = 144, 176
    tilt = _rodrigues(np.array([np.radians(tilt_deg), 0, 0]))
    up_cam = tilt.T @ np.array([0.0, -1.0, 0.0])
    rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    rays = np.stack([(cc - 88) / 250.0, (rr - 72) / 250.0,
                     np.ones_like(cc, float)], axis=-1)
    denom = rays @ up_cam
    hits = denom < -1e-3
    s = -1.0 / np.where(hits, denom, -1.0)
    is_floor = (rr > h * 0.55) & hits & (s > 0) & (s < 8)
    xyz = np.where(is_floor[..., None], rays * s[..., None], rays * 4.0)
    return xyz.astype(np.float32)


def test_plane_fit_matches_jax():
    """RANSAC plane + orientation prior with the reference's draws: the
    same winner, inliers and ok; normal and q0 within 1e-5."""
    xyz = _tilted_floor_xyz()
    key = jax.random.PRNGKey(4)
    n_reg = (144 - int(144 * 0.6)) * 176
    g = _gumbel(key, (512, n_reg))
    ref_fit = _np(jplane.floor_up_direction(key, jnp.asarray(xyz)))
    got_fit = tplane.floor_up_direction(torch.as_tensor(xyz), gumbel=g)
    _close(got_fit, ref_fit, atol=1e-5)
    assert bool(ref_fit.ok) and ref_fit.inliers.sum() > 1000
    ref_q, ref_ok = jplane.initial_orientation_from_floor(key,
                                                          jnp.asarray(xyz))
    got_q, got_ok = tplane.initial_orientation_from_floor(
        torch.as_tensor(xyz), gumbel=g)
    assert bool(got_ok) == bool(ref_ok) is True
    np.testing.assert_allclose(got_q.numpy(), np.asarray(ref_q), atol=1e-5)
    assert abs(float(ref_q[0])) < 0.999  # a real tilt, not identity
    # a wall-only scene fails the tilt gate: identity
    wall = np.zeros_like(xyz)
    wall[..., 0] = np.random.default_rng(1).uniform(-1, 1, xyz.shape[:2])
    wall[..., 1] = np.random.default_rng(2).uniform(-1, 1, xyz.shape[:2])
    wall[..., 2] = 2.0
    q, ok = tplane.initial_orientation_from_floor(torch.as_tensor(wall),
                                                  gumbel=g)
    assert not bool(ok) and q.tolist() == [1.0, 0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# utils/interop.py
# ---------------------------------------------------------------------------


def test_ekf_state_and_camera_round_trip(case):
    """A reference EkfState and Camera → the port's types → numpy,
    unchanged; the camera's intrinsics become Python numbers."""
    st = case["st1"]
    tst = to_torch(st, device="cpu")
    assert type(tst) is EkfState and tst.p.dtype == torch.float32
    back = to_numpy(tst)
    for name in st._fields:
        np.testing.assert_array_equal(getattr(back, name), getattr(st, name))
    assert type(st)(*back)._fields == st._fields
    cam = to_torch(JCAM, device="cpu")
    assert cam == TCAM and isinstance(cam.f, float)
    assert isinstance(cam.n_rows, int)
    jback = type(JCAM)(*to_numpy(cam))
    for a, b in zip(jback, JCAM):
        assert np.asarray(a) == np.asarray(b)
