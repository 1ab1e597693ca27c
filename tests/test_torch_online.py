"""The port's online streaming driver (runtime/online.py) and checkpoints
(utils/checkpoint.py): per-frame and chunked streaming against the port's
run_slam, snapshot/resume determinism, a JAX snapshot read by the port,
and the JAX OnlineSlam against the port's, streaming and smooth(), with
its key splits reproduced and injected."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.ekf import slam as jslam
from pre3_tpu.ekf.state import init_state as jinit_state
from pre3_tpu.geometry.camera import sr4000_camera as jcamera
from pre3_tpu.runtime.online import OnlineSlam as JOnlineSlam
from pre3_tpu.utils.checkpoint import save_state as jsave_state
from pre3_tpu_torch.ekf import slam as tslam
from pre3_tpu_torch.ekf.one_point_ransac import pool_size
from pre3_tpu_torch.ekf.state import init_state
from pre3_tpu_torch.eval.trajectory import ate_rmse
from pre3_tpu_torch.frontend.pipeline import extract_features_sift
from pre3_tpu_torch.geometry.camera import sr4000_camera as tcamera
from pre3_tpu_torch.runtime.online import OnlineSlam
from pre3_tpu_torch.utils.checkpoint import load_state, save_state
from pre3_tpu_torch.utils.interop import to_torch
from test_torch_slam import N_REGION, PLANE_BATCH, POSE_ATOL, _gumbel

N_FRAMES, K = 7, 32
SIFT_KF = 288
# __graft_entry__'s configuration (OnlineSlam(extractor="sift",
# SlamConfig(min_measured=50))) at a 32-slot map, with the attitude
# update on every third step so the xyz images are carried too
CFG = tslam.SlamConfig(min_measured=50, heading_update_every=3)


@pytest.fixture(scope="module")
def seq():
    frames, traj, _ = render_sequence(n_frames=N_FRAMES, n_points=300,
                                      noise=0.004)
    gt = (traj.t - traj.t[0]) @ traj.r[0]
    return frames, gt


def _np_draws(n_frames, cfg, kf, seed):
    """Numpy-seeded Gumbel draws for every random choice of a run: the
    bootstrap's, and each step's with the plane fits of the attitude
    update's steps (1-based step i where i % N == 0) stacked in order."""
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.as_tensor(rng.gumbel(size=s).astype(np.float32))
    s = n_frames - 1
    every = cfg.heading_update_every
    n_fits = sum(1 for i in range(1, n_frames) if every and i % every == 0)
    return tslam.SlamDraws(
        steps=tslam.StepDraws(
            vo=g(s, cfg.vo_batch, kf),
            ransac=g(s, cfg.ransac_batch,
                     pool_size(K, cfg.max_update_slots or None)),
            add=g(s, kf),
            heading=g(n_fits, PLANE_BATCH, N_REGION) if n_fits else None),
        boot_add=g(kf), plane=g(PLANE_BATCH, N_REGION))


def _step_draws(draws, i):
    """Step i's (1-based) draws out of a run's SlamDraws."""
    st, every = draws.steps, CFG.heading_update_every
    fit = i % every == 0
    return tslam.StepDraws(vo=st.vo[i - 1], ransac=st.ransac[i - 1],
                           add=st.add[i - 1],
                           heading=st.heading[i // every - 1] if fit else None)


def _stack(frames, lo=0, hi=None):
    return [torch.as_tensor(np.stack([getattr(f, a) for f in frames[lo:hi]]))
            for a in ("intensity", "xyz", "confidence")]


def _online(**kw):
    return OnlineSlam(tcamera(), cfg=CFG, n_landmarks=K, extractor="sift",
                      device="cpu", **kw)


def test_per_frame_equals_run_slam(seq):
    """process() frame by frame (SIFT, plane-fit prior, attitude update)
    gives exactly run_slam's trajectory and stats under the same draws,
    run_slam fed the same per-frame frontend calls. Fed the frontend of
    all frames as one batch, whose sums may round otherwise (poses
    ~1e-7 apart), run_slam gives the same stats and poses within
    POSE_ATOL."""
    frames, gt = seq
    draws = _np_draws(N_FRAMES, CFG, SIFT_KF, seed=1)
    intensity, xyz, conf = _stack(frames)
    per_frame = [extract_features_sift(*(a[i:i + 1] for a in (intensity, xyz,
                                                             conf)))
                 for i in range(N_FRAMES)]
    runs = [tslam.run_slam(tcamera(), feats, CFG, n_landmarks=K, draws=draws,
                           xyz_imgs=torch.nan_to_num(xyz))
            for feats in (type(per_frame[0])(*map(torch.cat, zip(*per_frame))),
                          extract_features_sift(intensity, xyz, conf))]
    ref, batched = runs
    np.testing.assert_allclose(batched.t, ref.t, atol=POSE_ATOL)
    np.testing.assert_allclose(batched.q, ref.q, atol=POSE_ATOL)
    for a, b in zip(batched.stats, ref.stats):
        assert torch.equal(a, b)
    slam = _online()
    for i, f in enumerate(frames):
        res = slam.process(f.intensity, f.xyz, f.confidence,
                           draws=draws if i == 0 else _step_draws(draws, i))
        assert res.step == i and res.t.device.type == "cpu"
    ts, qs = slam.trajectory
    np.testing.assert_array_equal(ts, ref.t.numpy())
    np.testing.assert_array_equal(qs, ref.q.numpy())
    for i, r in enumerate(slam.results[1:]):
        for name in tslam.StepStats._fields:
            assert int(getattr(r.stats, name)) == int(
                getattr(ref.stats, name)[i]), (i, name)
    assert ate_rmse(ts, gt, align=True) < 0.05
    assert slam.timer.summary()["dispatch"]["count"] == N_FRAMES


def test_chunked_equals_per_frame(seq):
    """run() with chunk=3 (bootstrap per frame, then process_chunk over
    3 + 3 frames) draws from the generator in the same order as
    per-frame streaming: the same stats, and poses within POSE_ATOL (the
    chunk's frontend is one batch, whose sums may round otherwise)."""
    frames, _ = seq
    per_frame = _online(generator=torch.Generator().manual_seed(3))
    per_frame.run(frames, prefetch=2)
    chunked = _online(generator=torch.Generator().manual_seed(3))
    out = chunked.run(frames, chunk=3)
    assert [r.step for r in out] == list(range(N_FRAMES))
    assert chunked.timer.summary()["dispatch"]["count"] == 1 + 2
    assert chunked.timer.summary()["decode_wait"]["count"] == N_FRAMES
    for a, b in zip(per_frame.trajectory, chunked.trajectory):
        np.testing.assert_allclose(a, b, atol=POSE_ATOL)
    for a, b in zip(per_frame.results[1:], chunked.results[1:]):
        assert all(torch.equal(x, y) for x, y in zip(a.stats, b.stats))
    with pytest.raises(RuntimeError, match="bootstrap"):
        _online().process_chunk(*_stack(frames, 0, 2))


def test_snapshot_resume_deterministic(seq, tmp_path):
    """Mirrors tests/test_online.py: a run snapshotted every 4 steps, and a
    fresh driver resumed from step 4 (state, step and generator state)
    and primed with frame 3, stream the same poses from there on."""
    frames, _ = seq
    a = _online(generator=torch.Generator().manual_seed(7),
                snapshot_dir=str(tmp_path), snapshot_every=4)
    a.run(frames)
    ts_a, qs_a = a.trajectory
    b = _online()
    b.resume(str(tmp_path / "snapshot_00004.npz"))
    assert b.step_i == 4 and int(b._carry[1]) == 4
    with pytest.raises(RuntimeError, match="prime"):
        b.process(frames[4].intensity, frames[4].xyz, frames[4].confidence)
    f_prev = frames[b.step_i - 1]
    b.prime(f_prev.intensity, f_prev.xyz, f_prev.confidence)
    for f in frames[b.step_i:]:
        b.process(f.intensity, f.xyz, f.confidence)
    ts_b, qs_b = b.trajectory
    np.testing.assert_allclose(ts_b, ts_a[4:], atol=1e-5)
    np.testing.assert_allclose(qs_b, qs_a[4:], atol=1e-5)


def test_checkpoint_round_trip_and_jax_snapshot(tmp_path):
    """The port's save_state/load_state keep every field and the generator
    state; a snapshot written by the JAX package loads with the same
    ``state__*`` arrays and step, and no generator state."""
    q0 = np.array([0.9, 0.1, -0.3, 0.2], np.float32)
    q0 /= np.linalg.norm(q0)
    jst = jinit_state(n_landmarks=5, desc_dim=7, q0=jnp.asarray(q0))
    jsave_state(str(tmp_path / "jax.npz"), jst, 12, jax.random.PRNGKey(5))
    st, step, gen_state, meta = load_state(str(tmp_path / "jax.npz"),
                                           device="cpu")
    assert step == 12 and gen_state is None and meta == {}
    for name in jst._fields:
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)))
        assert getattr(st, name).dtype == to_torch(
            np.asarray(getattr(jst, name)), device="cpu").dtype

    gen = torch.Generator().manual_seed(11)
    torch.rand(3, generator=gen)
    save_state(str(tmp_path / "sub" / "port.npz"), st, 13, gen,
               extra={"note": "x"})
    st2, step2, gen_state2, meta2 = load_state(
        str(tmp_path / "sub" / "port.npz"), device="cpu")
    assert step2 == 13 and meta2 == {"note": "x"}
    for a, b in zip(st, st2):
        assert torch.equal(a, b)
    again = torch.Generator().set_state(gen_state2)
    assert torch.equal(torch.rand(4, generator=again),
                       torch.rand(4, generator=gen))


def test_entry_points_default_to_the_card():
    """init_state, to_torch, load_state and OnlineSlam put their tensors
    on the card unless the caller names another device."""
    for fn in (init_state, to_torch, load_state, OnlineSlam.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


FAST_KW = {"threshold": 0.05, "max_features": 64}
JCFG = dict(match_ratio=1.3, min_measured=50)
# 10 frames at ~4 cm per frame: five keyframes for the smoother
FAST_FRAMES, FAST_STEP_T = 10, 0.1


@pytest.fixture(scope="module")
def fast_online():
    """The JAX OnlineSlam (its fused per-frame program) and the port's,
    FAST frontend, over 10 frames: the reference's key splits reproduced
    (boot: fold_in(key, 3) for the plane fit, split for the add key; each
    step: split, then slam_step's split into three) and injected."""
    frames, traj, _ = render_sequence(n_frames=FAST_FRAMES, n_points=300,
                                      noise=0.004, step_t=FAST_STEP_T)
    key = jax.random.PRNGKey(1)
    ref = JOnlineSlam(jcamera(), cfg=jslam.SlamConfig(**JCFG), n_landmarks=K,
                      extractor_kwargs=FAST_KW, key=key)
    ref.run(frames, prefetch=1)

    cfg = tslam.SlamConfig(**JCFG)
    slam = OnlineSlam(tcamera(), cfg=cfg, n_landmarks=K,
                      extractor_kwargs=FAST_KW, device="cpu")
    kf = FAST_KW["max_features"]
    plane = _gumbel(jax.random.fold_in(key, 3), (PLANE_BATCH, N_REGION))
    key, sub = jax.random.split(key)
    f0 = frames[0]
    slam.process(f0.intensity, f0.xyz, f0.confidence, draws=tslam.SlamDraws(
        steps=tslam.StepDraws(), plane=plane, boot_add=_gumbel(sub, (kf,))))
    for f in frames[1:]:
        key, sub = jax.random.split(key)
        kv, kr, ka = jax.random.split(sub, 3)
        slam.process(f.intensity, f.xyz, f.confidence, draws=tslam.StepDraws(
            vo=_gumbel(kv, (cfg.vo_batch, kf)),
            ransac=_gumbel(kr, (cfg.ransac_batch, pool_size(K, None))),
            add=_gumbel(ka, (kf,))))
    return ref, slam, (traj.t - traj.t[0]) @ traj.r[0]


def test_online_matches_jax(fast_online):
    """The JAX OnlineSlam and the port's over 10 frames under the same
    draws: stats equal, poses within POSE_ATOL."""
    ref, slam, _ = fast_online
    ref_t, ref_q = ref.trajectory
    ts, qs = slam.trajectory
    for r_ref, r_got in zip(ref.results[1:], slam.results[1:]):
        for name in tslam.StepStats._fields:
            assert int(np.asarray(getattr(r_ref.stats, name))) == int(
                getattr(r_got.stats, name)), name
    np.testing.assert_allclose(ts, ref_t, atol=POSE_ATOL)
    np.testing.assert_allclose(qs, ref_q, atol=POSE_ATOL)
    assert int(np.asarray(ref.results[1].stats.n_li)) > 5


# smooth(): the filter trajectories differ by ~1e-6 and BA starts from
# there (seen: 1.3e-6 after it); 2 LM iterations, each accepting its step
# by a clear margin, so no accept/reject decision sits at f32 noise
SMOOTH_ITERS, SMOOTH_TOL = 2, POSE_ATOL


def test_smooth_matches_jax(fast_online):
    """OnlineSlam.smooth() over the 10 streamed frames (keyframes, the
    records → BA bridge, 2 LM iterations, corrections spread over every
    frame) against the JAX OnlineSlam.smooth() on the same frames and
    draws: within SMOOTH_TOL, and it moved the trajectory by centimetres
    towards the ground truth."""
    ref, slam, gt = fast_online
    ref_t, ref_q = ref.smooth(iters=SMOOTH_ITERS)
    got_t, got_q = slam.smooth(iters=SMOOTH_ITERS)
    np.testing.assert_allclose(got_t, ref_t, atol=SMOOTH_TOL)
    np.testing.assert_allclose(got_q, ref_q, atol=SMOOTH_TOL)
    ts, _ = slam.trajectory
    assert np.abs(got_t - ts).max() > 0.01
    assert ate_rmse(got_t, gt, align=True) < ate_rmse(ts, gt, align=True)


def test_stage_timer_and_device_trace(tmp_path):
    """StageTimer counts and sums per stage as the reference's does;
    while the tracer is on (its device trace, utils/profiling.py) each
    stage is also a span of its name, which the tracer's Chrome trace
    holds; off, a stage records no span."""
    from pre3_tpu.utils.profiling import StageTimer as JStageTimer
    from pre3_tpu_torch.utils import profiling
    from pre3_tpu_torch.utils.profiling import StageTimer

    timers = [StageTimer(), JStageTimer()]
    for timer in timers:
        for _ in range(3):
            with timer.stage("a"):
                pass
        timer.add("b", 0.25)
    got, ref = (t.summary() for t in timers)
    assert got.keys() == ref.keys() == {"a", "b"}
    assert got["a"]["count"] == 3 and got["b"] == ref["b"]
    assert timers[0].report().splitlines()[1].startswith("b")
    with profiling.tracing():
        with timers[0].stage("traced"):
            torch.ones(8).sum()
    assert timers[0].summary()["traced"]["count"] == 1
    assert [s["name"] for s in profiling.export()["spans"]] == ["traced"]
    profiling.write_chrome_trace(tmp_path / "trace.json")
    assert (tmp_path / "trace.json").stat().st_size > 0
