"""Config #4's backend, port vs JAX reference: keyframe selection (greedy
and VO-driven), the Schur-complement BA (its solver, its pair factors and
the LM loop), trajectory smoothing, the EKF-records → BA bridge with its
revisit events and keyframe tracks, and keyframe loop mining — on the
same numpy-seeded inputs, with the reference's random draws reproduced
from its keys and injected.

The bridge and the tracks run on a synthetic out-and-back scene whose
records and keyframe features are built in numpy (no run_slam compile):
six landmarks leave the view and are re-measured after 29 frames (a
revisit event, so loop-closure landmarks and a pose factor), others are
re-initialised in reused slots.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.backend import ba as jba
from pre3_tpu.backend import ekf_ba as jekf_ba
from pre3_tpu.backend import keyframes as jkeyframes
from pre3_tpu.backend import loop_detect as jloop
from pre3_tpu.backend import smoothing as jsmoothing
from pre3_tpu.backend import tracks as jtracks
from pre3_tpu.data.synthetic import _rodrigues
from pre3_tpu.ekf import slam as jslam
from pre3_tpu.frontend.pipeline import Features as JFeatures
from pre3_tpu.geometry.camera import project as jproject
from pre3_tpu.geometry.camera import sr4000_camera as jcamera
from pre3_tpu.geometry.quaternion import r2q as jr2q
from pre3_tpu_torch.backend import ba, ekf_ba, keyframes, loop_detect, tracks
from pre3_tpu_torch.backend import smoothing
from pre3_tpu_torch.ekf import slam as tslam
from pre3_tpu_torch.frontend.pipeline import Features, extract_features
from pre3_tpu_torch.geometry.camera import sr4000_camera as tcamera
from pre3_tpu_torch.utils.interop import to_numpy, to_torch
from test_ba import make_ba_problem

# f32 pose arithmetic in another order: ~1e-7 per op.
POSE_ATOL = 1e-5


def _t(x):
    return to_torch(x, device="cpu")


def _np(x):
    return jax.tree.map(np.asarray, x)


def _quats(rots: np.ndarray) -> np.ndarray:
    return np.stack([np.asarray(jr2q(jnp.asarray(r))) for r in rots])


def _random_walk(n: int, seed: int):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.normal(scale=0.02, size=(n, 3)), 0).astype(np.float32)
    rv = np.cumsum(rng.normal(scale=0.02, size=(n, 3)), 0)
    return t, _quats([_rodrigues(v) for v in rv]).astype(np.float32)


@pytest.mark.parametrize("max_keyframes", [6, 32])
def test_select_keyframes_matches_jax(max_keyframes):
    """Greedy selection over 40 frames with three invalid ones: indices,
    valid flags and count equal, at capacity (6) and padded (32)."""
    t, q = _random_walk(40, seed=0)
    ok = np.ones(40, bool)
    ok[[5, 6, 17]] = False
    ref = _np(jax.jit(functools.partial(
        jkeyframes.select_keyframes, max_keyframes=max_keyframes))(t, q, ok))
    got = to_numpy(keyframes.select_keyframes(
        torch.as_tensor(t), torch.as_tensor(q), torch.as_tensor(ok),
        max_keyframes))
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    # capacity reached at 6; padded slots at 32
    assert int(ref.n) == 6 if max_keyframes == 6 else not ref.valid.all()


def test_find_keyframes_vo_matches_jax():
    """The offline VO pass over 12 rendered frames (each candidate against
    the last keyframe), the reference's per-candidate draws injected:
    the same keyframes, increments within POSE_ATOL."""
    from pre3_tpu.data.synthetic import render_sequence

    frames, _, _ = render_sequence(n_frames=12, n_points=300, noise=0.004)
    feats = to_numpy(extract_features(
        *(torch.as_tensor(np.stack([getattr(f, a) for f in frames]))
          for a in ("intensity", "xyz", "confidence")),
        threshold=0.05, max_features=64))
    key, batch = jax.random.PRNGKey(3), 256
    ref = jkeyframes.find_keyframes_vo(jax.tree.map(jnp.asarray, feats), key,
                                       batch=batch)
    subs = []
    for _ in range(11):
        key, sub = jax.random.split(key)
        subs.append(np.asarray(jax.random.gumbel(sub, (batch, 64))))
    got = keyframes.find_keyframes_vo(_t(feats), batch=batch,
                                      gumbel=torch.as_tensor(np.stack(subs)))
    assert len(ref.indices) >= 3 and got.n_vo_calls == ref.n_vo_calls == 11
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.delta_t, ref.delta_t, atol=POSE_ATOL)
    np.testing.assert_allclose(got.delta_q, ref.delta_q, atol=POSE_ATOL)


def test_slerp_and_apply_ba_corrections_match_jax():
    """slerp (near-equal and far rotations, both hemispheres) and the
    keyframe corrections spread over 30 frames with two padded keyframe
    slots: within 1e-6."""
    rng = np.random.default_rng(1)
    q0 = _quats([_rodrigues(v) for v in rng.normal(scale=0.5, size=(8, 3))])
    q1 = q0.copy()
    q1[:4] = _quats([_rodrigues(v) for v in rng.normal(scale=0.5,
                                                       size=(4, 3))])
    q1[4] *= -1.0
    q1[5] += 1e-7
    u = rng.uniform(size=(8, 1)).astype(np.float32)
    ref = np.asarray(jax.jit(jsmoothing.slerp)(q0, q1, u))
    got = smoothing.slerp(*map(torch.as_tensor, (q0, q1, u))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)

    t, q = _random_walk(30, seed=2)
    idx = np.array([0, 4, 9, 15, 22, 29, 29], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 0, 0], bool)
    ba_t = t[idx] + rng.normal(scale=0.05, size=(7, 3)).astype(np.float32)
    ba_q = _quats([_rodrigues(v) for v in rng.normal(scale=0.03,
                                                     size=(7, 3))])
    ba_q = np.asarray(jax.vmap(lambda a, b: jsmoothing.qprod(a, b))(
        jnp.asarray(ba_q), jnp.asarray(q[idx]))).astype(np.float32)
    args = (t, q, idx, valid, ba_t, ba_q)
    ref = _np(jax.jit(jsmoothing.apply_ba_corrections)(*args))
    got = to_numpy(smoothing.apply_ba_corrections(*map(torch.as_tensor,
                                                       args)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-6)


def _normal_blocks(f: int, l: int, seed: int):
    rng = np.random.default_rng(seed)
    jc = rng.normal(size=(f, l, 5, 6))
    jp = rng.normal(size=(f, l, 5, 3))
    r = rng.normal(size=(f, l, 5))
    mask = rng.uniform(size=(f, l)) < 0.7
    jc, jp, r = (a * mask[..., None, None] if a.ndim == 4 else
                 a * mask[..., None] for a in (jc, jp, r))
    hcc = np.einsum("flab,flac->fbc", jc, jc) + 1e-3 * np.eye(6)
    hpp = np.einsum("flab,flac->lbc", jp, jp) + 1e-3 * np.eye(3)
    wcp = np.einsum("flab,flac->flbc", jc, jp)
    bc = -np.einsum("flab,fla->fb", jc, r)
    bp = -np.einsum("flab,fla->lb", jp, r)
    a = rng.normal(size=(6 * f, 6 * f))
    s_extra = (0.1 * a @ a.T).reshape(f, 6, f, 6)
    rhs_extra = rng.normal(size=(f, 6))
    return [x.astype(np.float32) for x in
            (hcc, hpp, wcp, bc, bp, s_extra, rhs_extra)]


def test_schur_solve_matches_dense_solve():
    """The Schur path (f32, Jacobi-normalised) against a float64 solve of
    the full [6F + 3L] system with keyframe 0 frozen, with camera-camera
    extra terms: relative error below 1e-4; and against the reference's
    schur_solve within 1e-5 of the solution's scale."""
    f, l = 5, 30
    hcc, hpp, wcp, bc, bp, s_extra, rhs_extra = _normal_blocks(f, l, seed=4)
    n = 6 * f
    h = np.zeros((n + 3 * l, n + 3 * l))
    for i in range(f):
        h[6 * i:6 * i + 6, 6 * i:6 * i + 6] = hcc[i]
    h[:n, :n] += s_extra.reshape(n, n)
    for j in range(l):
        h[n + 3 * j:n + 3 * j + 3, n + 3 * j:n + 3 * j + 3] = hpp[j]
    w = wcp.transpose(0, 2, 1, 3).reshape(n, 3 * l)
    h[:n, n:] = w
    h[n:, :n] = w.T
    b = np.r_[(bc + rhs_extra).reshape(-1), bp.reshape(-1)].astype(np.float64)
    h[:6, :] = 0.0
    h[:, :6] = 0.0
    h[:6, :6] = np.eye(6)
    b[:6] = 0.0
    x = np.linalg.solve(h, b)
    got = [a.numpy() for a in ba.schur_solve(
        *map(torch.as_tensor, (hcc, hpp, wcp, bc, bp)),
        s_extra=torch.as_tensor(s_extra), rhs_extra=torch.as_tensor(rhs_extra))]
    rel = np.abs(np.r_[got[0].reshape(-1), got[1].reshape(-1)] - x).max() / (
        np.abs(x).max())
    assert rel < 1e-4, rel
    ref = [np.asarray(a) for a in jax.jit(jba.schur_solve)(
        hcc, hpp, wcp, bc, bp, s_extra=s_extra, rhs_extra=rhs_extra)]
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, r, atol=1e-5 * np.abs(x).max())


@pytest.mark.parametrize("with_info", [False, True])
def test_pair_terms_accumulate_duplicate_pairs(with_info):
    """Keyframe-pair factors with (0, 2) listed twice (the same factor):
    every block and
    the right-hand side equal the reference's (within 1e-5 relative), and
    the duplicated pair contributes exactly twice one copy's terms."""
    t, q = _random_walk(4, seed=5)
    rng = np.random.default_rng(6)
    i_idx = np.array([0, 0, 1, 2], np.int32)
    j_idx = np.array([2, 2, 3, 3], np.int32)
    rel_t = rng.normal(scale=0.1, size=(4, 3)).astype(np.float32)
    rel_q = _quats([_rodrigues(v) for v in rng.normal(scale=0.05,
                                                      size=(4, 3))])
    w = np.array([1.0, 1.0, 0.5, 0.0], np.float32)
    info = (np.triu(rng.normal(size=(4, 6, 6))) + 5 * np.eye(6)).astype(
        np.float32) if with_info else None
    for a in (rel_t, rel_q) + (() if info is None else (info,)):
        a[1] = a[0]
    args = (t, q, i_idx, j_idx, rel_t, rel_q)
    ref = _np(jax.jit(jba._pair_terms)(*args, 20.0, 50.0, w, info))
    targs = [torch.as_tensor(a) for a in args]
    tinfo = None if info is None else torch.as_tensor(info)
    got = to_numpy(ba._pair_terms(*targs, 20.0, 50.0, torch.as_tensor(w),
                                  tinfo))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())
    assert int(got[3]) == 3
    single = ba._pair_terms(targs[0], targs[1], *(a[1:2] for a in targs[2:]),
                            20.0, 50.0, torch.as_tensor(w[1:2]),
                            None if tinfo is None else tinfo[1:2])
    double = ba._pair_terms(targs[0], targs[1], *(a[:2] for a in targs[2:]),
                            20.0, 50.0, torch.as_tensor(w[:2]),
                            None if tinfo is None else tinfo[:2])
    assert torch.equal(double[0], 2 * single[0])
    assert torch.equal(double[1], 2 * single[1])


def _ba_factors(prob, gt):
    """Odometry factors from the true poses (perturbed), two loop-closure
    landmarks and one loop-closure pose factor (0, 5) with a square-root
    information matrix."""
    rng = np.random.default_rng(8)
    gt_t, gt_q = (np.asarray(a) for a in gt[:2])
    from pre3_tpu.geometry.quaternion import qconj, qprod, qrotate

    odo_t = np.asarray(jax.vmap(qrotate)(qconj(jnp.asarray(gt_q[:-1])),
                                         jnp.asarray(gt_t[1:] - gt_t[:-1])))
    odo_q = np.asarray(jax.vmap(qprod)(qconj(jnp.asarray(gt_q[:-1])),
                                       jnp.asarray(gt_q[1:])))
    lc_t = np.asarray(qrotate(qconj(jnp.asarray(gt_q[0])),
                              jnp.asarray(gt_t[5] - gt_t[0])))
    lc_q = np.asarray(qprod(qconj(jnp.asarray(gt_q[0])), jnp.asarray(gt_q[5])))
    lc_lm = np.zeros(prob.mask.shape[1], bool)
    lc_lm[[3, 11]] = True
    cov = np.diag([1e-4] * 3 + [5e-5] * 3)
    return prob._replace(
        odo_t=jnp.asarray(odo_t + rng.normal(scale=0.005, size=odo_t.shape),
                          jnp.float32),
        odo_q=jnp.asarray(odo_q), odo_w=jnp.asarray([1, 1, 1, 0, 1],
                                                    jnp.float32),
        lc_lm=jnp.asarray(lc_lm), lcp_i=jnp.asarray([0], jnp.int32),
        lcp_j=jnp.asarray([5], jnp.int32), lcp_t=jnp.asarray(lc_t[None]),
        lcp_q=jnp.asarray(lc_q[None]), lcp_w=jnp.ones(1, jnp.float32),
        lcp_info=jnp.asarray(jloop.sqrt_information(cov)[None]))


@pytest.mark.parametrize("factors", [False, True])
def test_bundle_adjust_matches_jax(factors):
    """2 LM iterations on tests/test_ba.py's generator (6 keyframes, 40
    landmarks, perturbed poses and points, 0.3 px noise), without and
    with odometry, loop-closure landmark and pose factors (sqrt-info):
    every step accepted by a clear margin in both, costs within 1e-4
    relative, poses and points within 1e-4."""
    # 2 iterations: the third's change is at f32 noise, where accept or
    # reject may go either way
    prob, gt = make_ba_problem(n_kf=6, n_lm=40, seed=2, t_noise=0.02,
                               p_noise=0.02, px_noise=0.3)
    if factors:
        prob = _ba_factors(prob, gt)
    ref = _np(jba.bundle_adjust(jcamera(), prob, iters=2))
    got = to_numpy(ba.bundle_adjust(tcamera(), _t(_np(prob)), iters=2))
    # each step's accept decision is clear: the cost falls by > 0.1%
    assert (np.diff(ref.cost) < -1e-3 * ref.cost[:-1]).all(), ref.cost
    np.testing.assert_allclose(got.cost, ref.cost, rtol=1e-4)
    for name in ("kf_t", "kf_q", "points"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   atol=1e-4, err_msg=name)


# --------------------------------------------------------------------------
# The synthetic out-and-back scene of the bridge, the tracks and mining
# --------------------------------------------------------------------------

F, K_SLOTS, KF, D = 48, 16, 64, 32
LOOP_SLOTS = 6  # slots 0..5: measured on rows 0..9 and 38..46 only


class Scene(NamedTuple):
    t: np.ndarray  # [F, 3]
    q: np.ndarray  # [F, 4]
    records: tuple  # z, z_xyz, measured, init_frame, visible [F-1, K...]
    feats: tuple  # uv, desc, xyz, valid, score [F, KF, ...]


def _cam_points(points, t, rot):
    return (points - t) @ rot  # R_wcᵀ(p − t)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(10)
    n_pts = 72
    points = np.stack([rng.uniform(-1.2, 2.2, n_pts),
                       rng.uniform(-0.8, 0.8, n_pts),
                       rng.uniform(2.0, 4.0, n_pts)], -1)
    desc = rng.normal(size=(n_pts, D))
    desc[7] *= 0.3  # the smallest descriptor: every empty track row's pick
    f_idx = np.arange(F)
    t = np.stack([0.04 * np.minimum(f_idx, F - 1 - f_idx),
                  0.01 * np.sin(f_idx / 4), np.zeros(F)], -1)
    rots = [_rodrigues(np.array([0.0, 0.006 * np.sin(f / 5), 0.0]))
            for f in f_idx]
    q = _quats(rots)
    cam = jcamera()
    project = jax.jit(lambda p: jproject(cam, p))

    z = np.zeros((F - 1, K_SLOTS, 2))
    z_xyz = np.zeros((F - 1, K_SLOTS, 3))
    measured = np.zeros((F - 1, K_SLOTS), bool)
    init_frame = np.zeros((F - 1, K_SLOTS), np.int32)
    visible = np.zeros((F - 1, K_SLOTS), bool)
    for r in range(F - 1):
        fr = r + 1
        for s in range(K_SLOTS):
            if s < LOOP_SLOTS:  # a revisit: out of view in between
                pid, init = s, 0
                on = r < 10 or r >= 38
                visible[r, s] = on
            else:  # a slot re-initialised every 8 rows
                blk = r // 8
                pid, init = 6 + (s - LOOP_SLOTS) * 6 + blk, 8 * blk + 1
                on = (r + s) % 5 != 0
                visible[r, s] = True
            p_cam = _cam_points(points[pid], t[fr], rots[fr])
            init_frame[r, s] = init
            if on:
                measured[r, s] = True
                z_xyz[r, s] = p_cam + rng.normal(scale=1e-3, size=3)
                z[r, s] = np.asarray(project(p_cam))

    uv = np.zeros((F, KF, 2))
    fdesc = np.zeros((F, KF, D))
    fxyz = np.zeros((F, KF, 3))
    valid = np.zeros((F, KF), bool)
    score = np.zeros((F, KF))
    for fr in range(F):
        p_cam = _cam_points(points, t[fr], rots[fr])
        pix = np.asarray(project(p_cam))
        seen = np.nonzero((p_cam[:, 2] > 0.5) & (pix[:, 0] > 1)
                          & (pix[:, 0] < 174) & (pix[:, 1] > 1)
                          & (pix[:, 1] < 142))[0][:KF]
        n = len(seen)
        uv[fr, :n] = pix[seen]
        fdesc[fr, :n] = desc[seen] + rng.normal(scale=0.02, size=(n, D))
        fxyz[fr, :n] = p_cam[seen]
        valid[fr, :n] = True
        score[fr, :n] = rng.uniform(0.1, 1.0, n)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return Scene(f32(t), f32(q),
                 (f32(z), f32(z_xyz), measured, init_frame, visible),
                 (f32(uv), f32(fdesc), f32(fxyz), valid, f32(score)))


KF_IDX = np.array(list(range(0, 48, 4)) + [47, 47], np.int32)
KF_VALID = np.array([True] * 12 + [False] * 2)


def _jtraj(sc):
    return jslam.SlamTrajectory(t=sc.t, q=sc.q, stats=None,
                                records=jslam.StepRecord(*sc.records))


def _ttraj(sc):
    return tslam.SlamTrajectory(t=torch.as_tensor(sc.t),
                                q=torch.as_tensor(sc.q), stats=None,
                                records=_t(tslam.StepRecord(*sc.records)))


def _compare_problems(got, ref):
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if b is None:
            continue
        a, b = to_numpy(a), np.asarray(b)
        assert a.shape == b.shape, name
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif name == "lcp_info":  # an IFT covariance, float64 inverted
            np.testing.assert_allclose(a, b, rtol=2e-3,
                                       atol=2e-3 * np.abs(b).max())
        else:
            np.testing.assert_allclose(a, b, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("max_landmarks", [None, 10])
def test_ba_problem_from_slam_matches_jax(scene, max_landmarks):
    """The bridge on synthetic records: landmark ids in first-seen order,
    the landmark cap, the revisit scan (the six loop slots become
    loop-closure landmarks where kept, and their co-measured set one
    Kabsch pose factor with its square-root information), odometry
    factors with padded keyframes weighted 0 — all as the reference."""
    ref = jekf_ba.ba_problem_from_slam(_jtraj(scene), KF_IDX, KF_VALID,
                                       max_landmarks=max_landmarks)
    got = ekf_ba.ba_problem_from_slam(_ttraj(scene), torch.as_tensor(KF_IDX),
                                      torch.as_tensor(KF_VALID),
                                      max_landmarks=max_landmarks)
    _compare_problems(got, ref)
    assert ref.lcp_i is not None and len(ref.lcp_i) == 1
    assert got.kf_t.device.type == "cpu"
    if max_landmarks is None:
        assert np.asarray(ref.lc_lm).sum() == LOOP_SLOTS
    else:
        assert got.mask.shape[1] == max_landmarks


def _kf_feats(sc, idx):
    return tuple(a[idx] for a in sc.feats)


def test_ba_problem_from_slam_with_tracks_matches_jax(scene):
    """kf_feats given: the keyframe tracks (K2 once per keyframe on a
    card) are merged into the filter landmarks as the reference merges
    them, adding observations where the filter had none."""
    plain = jekf_ba.ba_problem_from_slam(_jtraj(scene), KF_IDX, KF_VALID)
    ref = jekf_ba.ba_problem_from_slam(
        _jtraj(scene), KF_IDX, KF_VALID,
        kf_feats=JFeatures(*map(jnp.asarray, _kf_feats(scene, KF_IDX))))
    got = ekf_ba.ba_problem_from_slam(
        _ttraj(scene), KF_IDX, KF_VALID,
        kf_feats=Features(*map(torch.as_tensor, _kf_feats(scene, KF_IDX))))
    _compare_problems(got, ref)
    assert np.asarray(ref.mask).sum() > np.asarray(plain.mask).sum()


def test_used_features_follows_xla_scatter():
    """The reference marks used features with ``zeros.at[index].set(
    matched)``; XLA's CPU scatter lets the last of duplicate indices win,
    which used_features reproduces (the highest row id wins) — on random
    duplicated indices with mixed values."""
    rng = np.random.default_rng(11)
    for _ in range(5):
        idx = rng.integers(0, 6, size=40)
        matched = rng.uniform(size=40) < 0.5
        ref = np.asarray(jax.jit(lambda i, m: jnp.zeros(8, bool).at[i].set(
            m, mode="drop"))(jnp.asarray(idx), jnp.asarray(matched)))
        got = tracks.used_features(torch.as_tensor(idx),
                                   torch.as_tensor(matched), 8).numpy()
        np.testing.assert_array_equal(got, ref)
        last = np.zeros(8, bool)
        for i, m in zip(idx, matched):
            last[i] = m
        np.testing.assert_array_equal(got, last)


def test_build_tracks_matches_jax(scene):
    """build_tracks over 6 keyframes (one padded): observations, masks and
    the table equal the reference's. The case holds duplicate indices
    with mixed values: every empty table row picks feature 7's smallest
    descriptor, which an active row also matches."""
    idx = np.array([0, 4, 8, 12, 16, 47], np.int32)
    valid = np.array([True] * 5 + [False])
    ref = _np(jtracks.build_tracks(
        JFeatures(*map(jnp.asarray, _kf_feats(scene, idx))),
        jnp.asarray(scene.t[idx]), jnp.asarray(scene.q[idx]),
        jnp.asarray(valid), max_tracks=96))
    kf = Features(*map(torch.as_tensor, _kf_feats(scene, idx)))
    got = to_numpy(tracks.build_tracks(kf, torch.as_tensor(scene.t[idx]),
                                       torch.as_tensor(scene.q[idx]),
                                       torch.as_tensor(valid), max_tracks=96))
    for name, a, b in zip(("obs_uv", "obs_xyz", "mask"), got[:3], ref[:3]):
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)
    for name in ref[3]._fields:
        np.testing.assert_allclose(getattr(got[3], name),
                                   getattr(ref[3], name), atol=1e-5,
                                   err_msg=name)
    # the duplicate-index case happened at keyframe 1
    from pre3_tpu_torch.ops.matching import match_descriptors_auto

    f1 = Features(*(x[1] for x in kf))
    first = tracks.build_tracks(Features(*(x[:1] for x in kf)),
                                torch.as_tensor(scene.t[idx[:1]]),
                                torch.as_tensor(scene.q[idx[:1]]),
                                torch.as_tensor(valid[:1]), max_tracks=96)[3]
    mt = match_descriptors_auto(first.desc, f1.desc, valid1=first.active,
                                valid2=f1.valid, ratio=1.3)
    dup = mt.index[~first.active]
    assert int(first.active.sum()) > 0
    assert bool((dup == dup[0]).all()) and bool(
        mt.accepted[first.active & (mt.index == dup[0])].any())
    tproblem = tracks.make_ba_problem_from_tracks(
        kf, torch.as_tensor(scene.t[idx]), torch.as_tensor(scene.q[idx]),
        torch.as_tensor(valid), max_tracks=96)
    rproblem = jtracks.make_ba_problem_from_tracks(
        JFeatures(*map(jnp.asarray, _kf_feats(scene, idx))),
        jnp.asarray(scene.t[idx]), jnp.asarray(scene.q[idx]),
        jnp.asarray(valid), max_tracks=96)
    _compare_problems(tproblem, rproblem)


def test_sqrt_information_matches_jax():
    """The copied sqrt_information gives the reference's bytes, and
    ‖L r‖² = rᵀ Σ⁻¹ r for Σ = 25·cov + floor."""
    rng = np.random.default_rng(12)
    for _ in range(3):
        a = rng.normal(scale=0.01, size=(6, 6))
        cov = (a @ a.T).astype(np.float32)
        got = loop_detect.sqrt_information(cov)
        np.testing.assert_array_equal(got, jloop.sqrt_information(cov))
        sig = 25.0 * cov.astype(np.float64) + loop_detect._COV_FLOOR
        r = rng.normal(size=6)
        np.testing.assert_allclose(np.sum((got @ r) ** 2),
                                   r @ np.linalg.solve(sig, r), rtol=1e-5)


def test_merge_lcp_matches_jax(scene):
    """Mined factors onto a problem's filter-event factors (one a
    duplicate pair, dropped), onto a problem with none, and None: as the
    reference."""
    ref_prob = jekf_ba.ba_problem_from_slam(_jtraj(scene), KF_IDX, KF_VALID)
    got_prob = _t(_np(ref_prob))
    i0, j0 = int(ref_prob.lcp_i[0]), int(ref_prob.lcp_j[0])
    rng = np.random.default_rng(13)
    mined = (np.array([i0, 1], np.int32), np.array([j0, 9], np.int32),
             rng.normal(size=(2, 3)).astype(np.float32),
             _quats([_rodrigues(v) for v in rng.normal(scale=0.1,
                                                       size=(2, 3))]),
             np.ones(2, np.float32),
             np.stack([np.eye(6, dtype=np.float32)] * 2))
    for prob_ref, prob_got in ((ref_prob, got_prob), (
            ref_prob._replace(lcp_i=None, lcp_j=None, lcp_t=None,
                              lcp_q=None, lcp_w=None, lcp_info=None),
            got_prob._replace(lcp_i=None, lcp_j=None, lcp_t=None,
                              lcp_q=None, lcp_w=None, lcp_info=None))):
        ref = jloop.merge_lcp(prob_ref, mined)
        got = loop_detect.merge_lcp(prob_got, mined)
        _compare_problems(got, ref)
    assert len(jloop.merge_lcp(ref_prob, mined).lcp_i) == 2
    assert loop_detect.merge_lcp(got_prob, None) is got_prob


def test_mine_keyframe_loop_closures_matches_jax(scene):
    """Keyframes at frames 0, 24 and 47 (min_gap 2): one candidate pair,
    the two ends of the loop; the reference's per-pair key split gives
    the RANSAC draws. The same factor (t, q within 1e-4, the square-root
    information within 2e-3 relative), one pair tried."""
    idx = np.array([0, 24, 47])
    valid = np.ones(3, bool)
    batch = 256
    feats = _kf_feats(scene, idx)
    ref = jloop.mine_keyframe_loop_closures(
        JFeatures(*map(jnp.asarray, feats)), scene.t[idx], scene.q[idx],
        valid, min_gap=2, batch=batch)
    key = jax.random.PRNGKey(0)
    _, k = jax.random.split(key)
    draws = np.asarray(jax.random.gumbel(k, (batch, KF)))[None]
    got = loop_detect.mine_keyframe_loop_closures(
        Features(*map(torch.as_tensor, feats)), torch.as_tensor(scene.t[idx]),
        torch.as_tensor(scene.q[idx]), torch.as_tensor(valid), min_gap=2,
        batch=batch, gumbel=torch.as_tensor(draws))
    # fewer factors than the budget: every pair of pairs_to_try was tried
    assert ref is not None and len(got[0]) < 16 and loop_detect.pairs_to_try(
        scene.t[idx], valid, min_gap=2) == [(0, 2)]
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-4)
    np.testing.assert_allclose(got[3], ref[3], atol=1e-4)
    np.testing.assert_array_equal(got[4], ref[4])
    np.testing.assert_allclose(got[5], ref[5], rtol=2e-3,
                               atol=2e-3 * np.abs(ref[5]).max())
