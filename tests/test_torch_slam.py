"""The EKF-SLAM slice end to end, port vs JAX reference: one slam_step
under several configurations (the iterated update and the periodic
attitude update among them), a 10-frame run_slam with the plane-fit
orientation prior, the same with the warped-patch NCC matcher (config
#2) under three estimation options, and a SIFT-fed run_slam with the
periodic attitude update, each with the reference's random draws
reproduced from its keys and injected into the port.

The reference's run_slam is one jitted program; each run is made once
per process (tests/torch_reference.py), and every test of the sequence
reuses the module fixture's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.ekf import slam as jslam
from pre3_tpu.frontend.pipeline import extract_features as jextract
from pre3_tpu.frontend.pipeline import extract_features_sift as jextract_sift
from pre3_tpu.geometry.camera import sr4000_camera as jcamera
from pre3_tpu_torch.ekf import slam as tslam
from pre3_tpu_torch.ekf.one_point_ransac import pool_size
from pre3_tpu_torch.eval.trajectory import ate_rmse
from pre3_tpu_torch.geometry.camera import sr4000_camera as tcamera
from pre3_tpu_torch.utils.interop import to_numpy, to_torch
from test_torch_ekf import _tilted_floor_xyz
from torch_reference import reference

N_FRAMES, KF, K = 10, 64, 32
PLANE_BATCH = 512
N_REGION = (144 - int(144 * 0.6)) * 176  # floor_up_direction's region
# The bench operating point's options at a small map: bounded updates
# (max_update_slots < K) and the min_measured=50 re-init target.
CFG = dict(match_ratio=1.3, min_measured=50, max_update_slots=24)
# Poses: same f32 arithmetic in another reduction order; seen ≤ 9e-7 m
# over 9 chained steps. 2e-5 leaves room and still catches any wrong
# branch, tie or draw (those move poses by ≥ 1e-3).
POSE_ATOL = 2e-5


def _gumbel(key, shape):
    return torch.as_tensor(np.array(jax.random.gumbel(key, shape)))


def _step_draws(key, cfg, heading=False, kf=KF):
    """The reference's draws of one slam_step (split(key, 3) → VO,
    1-PRE, add sampling; fold_in(key, 7) → the attitude update's plane
    fit, where ``heading``)."""
    kv, kr, ka = jax.random.split(key, 3)
    m = pool_size(K, cfg.max_update_slots or None)
    return tslam.StepDraws(
        vo=_gumbel(kv, (cfg.vo_batch, kf)),
        ransac=_gumbel(kr, (cfg.ransac_batch, m)), add=_gumbel(ka, (kf,)),
        heading=_gumbel(jax.random.fold_in(key, 7), (PLANE_BATCH, N_REGION))
        if heading else None)


def _run_draws(key, cfg, n_frames, with_plane, kf=KF):
    """The reference's draws of run_slam: bootstrap (plane fit, add
    sampling) and every step's, from its key splits; the plane fits of
    the periodic attitude update stacked in step order."""
    kboot, key = jax.random.split(key)
    plane = None
    if with_plane:
        kp, kboot = jax.random.split(kboot)
        plane = _gumbel(kp, (PLANE_BATCH, N_REGION))
    every = cfg.heading_update_every
    steps = [_step_draws(k, cfg, every > 0 and i % every == 0, kf)
             for i, k in enumerate(jax.random.split(key, n_frames - 1), 1)]
    heading = [s.heading for s in steps if s.heading is not None]
    return tslam.SlamDraws(
        steps=tslam.StepDraws(
            *(torch.stack(f) for f in zip(*(s[:3] for s in steps))),
            heading=torch.stack(heading) if heading else None),
        boot_add=_gumbel(kboot, (kf,)), plane=plane)


@pytest.fixture(scope="module")
def seq():
    frames, traj, _ = render_sequence(n_frames=N_FRAMES, n_points=300,
                                      noise=0.004)
    stack = [np.stack([getattr(f, a) for f in frames])
             for a in ("intensity", "xyz", "confidence")]
    feats = jax.tree.map(np.array, jax.vmap(lambda i, x, c: jextract(
        i, x, c, threshold=0.05, max_features=KF))(*stack))
    gt = (traj.t - traj.t[0]) @ traj.r[0]
    xyz_imgs = np.stack([_tilted_floor_xyz()] * N_FRAMES)
    return feats, gt, xyz_imgs, stack[0]


@pytest.fixture(scope="module")
def jax_run(seq):
    """The reference's run_slam, compiled once."""
    feats, _, xyz_imgs, _ = seq
    return reference(jslam.run_slam, jcamera(),
                     jax.tree.map(jnp.asarray, feats), jax.random.PRNGKey(2),
                     cfg=jslam.SlamConfig(**CFG), n_landmarks=K,
                     xyz_imgs=jnp.asarray(xyz_imgs))


def test_run_slam_matches_jax(seq, jax_run):
    """10 frames, K=32, the plane-fit prior on: per-step stats equal
    (visible, IC, li, hi, active, VO ok/inliers, overflow), the measured
    sets equal, poses within POSE_ATOL, ATE of a tracking filter."""
    feats, gt, xyz_imgs, _ = seq
    cfg = tslam.SlamConfig(**CFG)
    draws = _run_draws(jax.random.PRNGKey(2), cfg, N_FRAMES, with_plane=True)
    got = to_numpy(tslam.run_slam(tcamera(), to_torch(feats, device="cpu"),
                                  cfg,
                                  n_landmarks=K, draws=draws,
                                  xyz_imgs=torch.as_tensor(xyz_imgs)))
    ref = jax_run
    for name in ref.stats._fields:
        np.testing.assert_array_equal(getattr(got.stats, name),
                                      getattr(ref.stats, name), err_msg=name)
    for name in ("measured", "visible", "init_frame"):
        np.testing.assert_array_equal(getattr(got.records, name),
                                      getattr(ref.records, name),
                                      err_msg=name)
    np.testing.assert_allclose(got.t, ref.t, atol=POSE_ATOL)
    np.testing.assert_allclose(got.q, ref.q, atol=POSE_ATOL)
    assert abs(ref.q[0, 0]) < 0.999  # the prior rotated q0
    assert ref.stats.vo_ok.all() and ref.stats.n_li.mean() > 10
    # the trajectory lives in the prior's frame: compare it aligned
    assert ate_rmse(got.t, gt, align=True) < 0.05


def test_run_slam_generator_draws(seq):
    """Without injected draws a torch.Generator supplies them: the filter
    still tracks (aligned ATE < 5 cm), and the same seed repeats exactly.
    Neither draws nor a generator is an error."""
    feats, gt, _, _ = seq
    tf = to_torch(feats, device="cpu")
    cfg = tslam.SlamConfig(**CFG)
    runs = [tslam.run_slam(tcamera(), tf, cfg, n_landmarks=K,
                           generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0].t, runs[1].t)
    assert ate_rmse(runs[0].t.numpy(), gt, align=False) < 0.05
    with pytest.raises(ValueError, match="gumbel noise or a generator"):
        tslam.run_slam(tcamera(), tf, cfg, n_landmarks=K)


@pytest.fixture(scope="module")
def boot_state(seq):
    """The reference's map bootstrapped from frame 2 (one compile, shared
    by every step case)."""
    feats = seq[0]
    return jax.jit(functools.partial(
        jslam.bootstrap_state, jcamera(), cfg=jslam.SlamConfig(**CFG),
        n_landmarks=K))(jax.tree.map(lambda x: jnp.asarray(x[2]), feats),
                        jax.random.PRNGKey(9))


STEP_CASES = {
    "1pre-bounded": dict(CFG),
    "1pre-weighted-cv-fallback": dict(
        match_ratio=1.3, init_sampling="weighted", min_measured=50,
        motion_model="odo_cv_fallback", ransac_points=1),
    "pure-ekf-const-noise": dict(match_ratio=1.3, est_method="pure_ekf",
                                 vo_noise_from_covariance=False,
                                 vo_range_weighted=False),
    "cv-only-predict": dict(match_ratio=1.3, motion_model="cv",
                            only_predict=True),
    "iekf": dict(match_ratio=1.3, est_method="iekf"),
    # step 3 is a multiple of 3: the floor-plane fit and attitude update
    # run, on a floor tilted 3° (inside the 4° gate of the identity prior)
    "1pre-heading": dict(CFG, heading_update_every=3),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_slam_step_matches_jax(seq, boot_state, name):
    """One step from the reference's bootstrapped map at frame 3, under
    each option the port carries: x within 2e-6 (the v/ω states, VO's
    translation / 0.1 s, within 2e-5), P within 1e-8 (entries ≤ 1e-3),
    every mask, counter and stat exact."""
    feats = seq[0]
    jcfg = jslam.SlamConfig(**STEP_CASES[name])
    cfg = tslam.SlamConfig(**STEP_CASES[name])
    heading = cfg.heading_update_every > 0
    xyz = _tilted_floor_xyz(-3.0) if heading else None
    frame = lambda i: jax.tree.map(lambda x: jnp.asarray(x[i]), feats)
    jst = boot_state
    key, step = jax.random.PRNGKey(11), np.int32(3)
    ref_st, (ref_stats, ref_rec) = jax.tree.map(np.asarray, jax.jit(
        functools.partial(jslam.slam_step, jcamera(), cfg=jcfg))(
        jst, frame(3), frame(2), jnp.asarray(step), key,
        xyz_img=None if xyz is None else jnp.asarray(xyz)))
    got_st, (got_stats, got_rec) = to_numpy(tslam.slam_step(
        tcamera(), to_torch(jax.tree.map(np.asarray, jst), device="cpu"),
        to_torch(type(feats)(*(x[3] for x in feats)), device="cpu"),
        to_torch(type(feats)(*(x[2] for x in feats)), device="cpu"),
        torch.as_tensor(step), cfg, draws=_step_draws(key, jcfg, heading),
        xyz_img=None if xyz is None else torch.as_tensor(xyz),
        host_step=int(step)))
    # the velocity states are the VO increment / dt: 10× its error
    np.testing.assert_allclose(got_st.x[7:13], ref_st.x[7:13], atol=2e-5)
    got_st = got_st._replace(x=np.r_[got_st.x[:7], got_st.x[13:]])
    ref_st = ref_st._replace(x=np.r_[ref_st.x[:7], ref_st.x[13:]])
    for name_, got_f, ref_f in ((n, getattr(got_st, n), getattr(ref_st, n))
                                for n in ref_st._fields):
        tol = 1e-8 if name_ == "p" else 2e-6
        if ref_f.dtype.kind in "biu":
            np.testing.assert_array_equal(got_f, ref_f, err_msg=name_)
        else:
            np.testing.assert_allclose(got_f, ref_f, atol=tol, err_msg=name_)
    for n in ref_stats._fields:
        np.testing.assert_array_equal(getattr(got_stats, n),
                                      getattr(ref_stats, n), err_msg=n)
    np.testing.assert_array_equal(got_rec.measured, ref_rec.measured)
    if heading:  # the attitude update was applied, not gated away
        off = to_numpy(tslam.slam_step(
            tcamera(), to_torch(jax.tree.map(np.asarray, jst), device="cpu"),
            to_torch(type(feats)(*(x[3] for x in feats)), device="cpu"),
            to_torch(type(feats)(*(x[2] for x in feats)), device="cpu"),
            torch.as_tensor(step), cfg._replace(heading_update_every=0),
            draws=_step_draws(key, jcfg)))[0]
        assert np.abs(off.x[3:7] - got_st.x[3:7]).max() > 1e-4


# The name dates from when the port raised on these options; it is kept so
# that each case's pass/fail history carries on under the same id.
@pytest.mark.parametrize("option", [
    dict(matcher="ncc_warp"), dict(matcher="ncc_warp", est_method="iekf"),
    dict(matcher="ncc_warp", heading_update_every=4),
])
def test_unported_options_raise(seq, option):
    """run_slam with the warped-patch NCC matcher (config #2): every
    frame's intensity image given (init patches at bootstrap and on every
    add, the NCC scan per step) and its xyz image (the plane-fit prior;
    the attitude update's fits), under the 1-point RANSAC update, the
    iterated update and the attitude update every 4 steps. 10 frames,
    K=32, the reference's draws injected: per-step stats and the
    measured sets equal, poses within POSE_ATOL (the NCC grid is bit-equal
    to the reference's jitted jnp.linspace)."""
    feats, gt, xyz_imgs, intensity = seq
    cfg = tslam.SlamConfig(**CFG, **option)
    ref = reference(
        jslam.run_slam, jcamera(), jax.tree.map(jnp.asarray, feats),
        jax.random.PRNGKey(6), cfg=jslam.SlamConfig(**CFG, **option),
        n_landmarks=K, images=jnp.asarray(intensity),
        xyz_imgs=jnp.asarray(xyz_imgs))
    draws = _run_draws(jax.random.PRNGKey(6), cfg, N_FRAMES, with_plane=True)
    got = to_numpy(tslam.run_slam(
        tcamera(), to_torch(feats, device="cpu"), cfg, n_landmarks=K,
        draws=draws, images=torch.as_tensor(intensity),
        xyz_imgs=torch.as_tensor(xyz_imgs)))
    for name in ref.stats._fields:
        np.testing.assert_array_equal(getattr(got.stats, name),
                                      getattr(ref.stats, name), err_msg=name)
    for name in ("measured", "visible", "init_frame"):
        np.testing.assert_array_equal(getattr(got.records, name),
                                      getattr(ref.records, name),
                                      err_msg=name)
    np.testing.assert_allclose(got.t, ref.t, atol=POSE_ATOL)
    np.testing.assert_allclose(got.q, ref.q, atol=POSE_ATOL)
    assert ref.stats.n_ic.mean() > 10 and ref.stats.n_li.mean() > 5
    assert ate_rmse(got.t, gt, align=True) < 0.05
    with pytest.raises(ValueError, match="needs the intensity image"):
        tslam.run_slam(tcamera(), to_torch(feats, device="cpu"), cfg,
                       n_landmarks=K, draws=draws)


SIFT_FRAMES, SIFT_KF = 6, 288
# bench.py's options at a small map, with the periodic attitude update
SIFT_CFG = dict(min_measured=50, max_update_slots=24, heading_update_every=2)


@pytest.fixture(scope="module")
def sift_seq():
    """The reference's SIFT features (its exact branch) of a short
    sequence, and a tilted floor as every frame's xyz image."""
    frames, traj, _ = render_sequence(n_frames=SIFT_FRAMES, n_points=300,
                                      noise=0.004)
    stack = [np.stack([getattr(f, a) for f in frames])
             for a in ("intensity", "xyz", "confidence")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRE3_SIFT_FAST_MATH", "0")
        feats = jax.tree.map(np.array, jax.jit(jax.vmap(jextract_sift))(
            *(jnp.asarray(a) for a in stack)))
    gt = (traj.t - traj.t[0]) @ traj.r[0]
    xyz_imgs = np.stack([_tilted_floor_xyz()] * SIFT_FRAMES)
    return feats, gt, xyz_imgs


def test_run_slam_sift_heading_matches_jax(sift_seq):
    """SIFT-fed run_slam (128-D descriptors, 288 slots per frame) with
    the plane-fit prior and the attitude update on every second step:
    per-step stats and measured sets equal, poses within POSE_ATOL."""
    feats, gt, xyz_imgs = sift_seq
    assert feats.desc.shape == (SIFT_FRAMES, SIFT_KF, 128)
    cfg = tslam.SlamConfig(**SIFT_CFG)
    ref = reference(
        jslam.run_slam, jcamera(), jax.tree.map(jnp.asarray, feats),
        jax.random.PRNGKey(4), cfg=jslam.SlamConfig(**SIFT_CFG),
        n_landmarks=K, xyz_imgs=jnp.asarray(xyz_imgs))
    draws = _run_draws(jax.random.PRNGKey(4), cfg, SIFT_FRAMES,
                       with_plane=True, kf=SIFT_KF)
    assert draws.steps.heading.shape[0] == 2  # steps 2 and 4
    got = to_numpy(tslam.run_slam(
        tcamera(), to_torch(feats, device="cpu"), cfg, n_landmarks=K,
        draws=draws, xyz_imgs=torch.as_tensor(xyz_imgs)))
    for name in ref.stats._fields:
        np.testing.assert_array_equal(getattr(got.stats, name),
                                      getattr(ref.stats, name), err_msg=name)
    np.testing.assert_array_equal(got.records.measured, ref.records.measured)
    np.testing.assert_allclose(got.t, ref.t, atol=POSE_ATOL)
    np.testing.assert_allclose(got.q, ref.q, atol=POSE_ATOL)
    assert ref.stats.n_li.mean() > 10
    assert ate_rmse(got.t, gt, align=True) < 0.05
