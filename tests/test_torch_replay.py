"""Record/replay, port vs JAX reference (utils/replay.py, mirroring
tests/test_replay.py): a 6-frame EKF run (K=32, FAST) checkpointed
before step 3 and replayed from there.

The port's replay is held to its own uninterrupted run bit for bit, with
the reference's draws injected and with the draws taken from the
generator state the checkpoint holds; to the reference's replay within
POSE_ATOL = 2e-5, tests/test_torch_slam.py's pose tolerance (f32 in
another reduction order). feature_performance is exact on the same
state. A JAX checkpoint holds a threefry key, not a generator state:
replaying it without draws raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.ekf import slam as jslam
from pre3_tpu.ekf.map_management import add_features as jadd
from pre3_tpu.ekf.measurement import predict_measurements as jpredict
from pre3_tpu.ekf.state import init_state as jinit
from pre3_tpu.geometry.camera import sr4000_camera as jcamera
from pre3_tpu.utils import checkpoint as jckpt
from pre3_tpu.utils import replay as jreplay
from pre3_tpu_torch.data.synthetic import render_sequence
from pre3_tpu_torch.ekf import slam as tslam
from pre3_tpu_torch.ekf.map_management import add_features
from pre3_tpu_torch.ekf.measurement import predict_measurements
from pre3_tpu_torch.ekf.state import init_state
from pre3_tpu_torch.frontend.pipeline import Features, extract_features
from pre3_tpu_torch.geometry.camera import sr4000_camera as tcamera
from pre3_tpu_torch.utils import checkpoint, replay
from pre3_tpu_torch.utils.interop import to_numpy, to_torch
from test_torch_slam import _step_draws

N_FRAMES, K, KF, CKPT = 6, 32, 64, 3  # checkpoint before step CKPT
CFG = dict(vo_batch=256, ransac_batch=128)
POSE_ATOL = 2e-5


@pytest.fixture(scope="module")
def feats():
    frames, _, _ = render_sequence(n_frames=N_FRAMES, n_points=250,
                                   noise=0.004)
    return to_numpy(extract_features(
        *(torch.as_tensor(np.stack([getattr(f, a) for f in frames]))
          for a in ("intensity", "xyz", "confidence")),
        threshold=0.05, max_features=KF))


def _port_boot(tf):
    cam = tcamera()
    st = init_state(n_landmarks=K, desc_dim=tf.desc.shape[-1], device="cpu")
    zero = torch.zeros((), dtype=torch.int32)
    first = Features(*(x[0] for x in tf))
    return add_features(cam, st, first, predict_measurements(cam, st).h,
                        zero, n_measured=zero, max_adds=24, min_measured=25)


def _port_run(tf, step_draws=None, generator=None, ckpt_path=None):
    """Steps 1..F-1 from the bootstrap; the state before step CKPT is
    saved to ckpt_path (with the generator's state). Returns (t per step,
    final state)."""
    state = _port_boot(tf)
    cfg = tslam.SlamConfig(**CFG)
    ts = []
    for k in range(1, N_FRAMES):
        if k == CKPT and ckpt_path:
            checkpoint.save_state(ckpt_path, state, CKPT - 1,
                                  generator=generator)
        state, _ = tslam.slam_step(
            tcamera(), state, Features(*(x[k] for x in tf)),
            Features(*(x[k - 1] for x in tf)),
            torch.tensor(k, dtype=torch.int32), cfg,
            draws=None if step_draws is None else step_draws[k - 1],
            generator=generator)
        ts.append(state.x[0:3].numpy().copy())
    return np.stack(ts), state


@pytest.fixture(scope="module")
def reference(feats, tmp_path_factory):
    """tests/test_replay.py's run of the reference: bootstrap, steps with
    one key split each, checkpoint before step CKPT, replay from it."""
    cam = jcamera()
    jf = jax.tree.map(jnp.asarray, feats)
    cfg = jslam.SlamConfig(**CFG)
    state = jinit(n_landmarks=K, desc_dim=feats.desc.shape[-1])
    first = jax.tree.map(lambda x: x[0], jf)
    state = jadd(cam, state, first, jpredict(cam, state).h,
                 jnp.asarray(0, jnp.int32),
                 n_measured=jnp.asarray(0, jnp.int32), max_adds=24,
                 min_measured=25)
    key = jax.random.PRNGKey(7)
    path = str(tmp_path_factory.mktemp("ref") / "snap.npz")
    subs, original = [], []
    # one compiled step for the run and for the replay (replay_sequence
    # looks slam_step up in its module at call time)
    orig = jslam.slam_step
    jitted = jax.jit(lambda s, f, p, k, sub: orig(cam, s, f, p, k, sub, cfg))

    def step(cam_, s, f, p, k, sub, cfg_):
        return jitted(s, f, p, k, sub)
    for k in range(1, N_FRAMES):
        key, sub = jax.random.split(key)
        subs.append(sub)
        if k == CKPT:
            jckpt.save_state(path, state, step=CKPT - 1, key=key)
        state, _ = step(cam, state, jax.tree.map(lambda x: x[k], jf),
                        jax.tree.map(lambda x: x[k - 1], jf),
                        jnp.asarray(k, jnp.int32), sub, cfg)
        original.append(np.asarray(state.x[0:3]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jslam, "slam_step", step)
        rep_traj, rep_state, _ = jreplay.replay_sequence(cam, jf, path,
                                                         cfg=cfg)
    np.testing.assert_allclose(np.stack([t for t, _ in rep_traj]),
                               np.stack(original[CKPT - 1:]), atol=1e-6)
    draws = [_step_draws(s, tslam.SlamConfig(**CFG), kf=KF) for s in subs]
    return dict(path=path, original=np.stack(original), draws=draws,
                rep_t=np.stack([t for t, _ in rep_traj]),
                rep_state=jax.tree.map(np.asarray, rep_state))


def test_replay_with_reference_draws(feats, reference, tmp_path):
    """The reference's draws injected: the port's uninterrupted run
    follows the reference's within POSE_ATOL; its replay from the
    checkpoint equals it bit for bit in every pose and the final state,
    and the reference's replay within POSE_ATOL."""
    tf = to_torch(feats, device="cpu")
    path = str(tmp_path / "snap.npz")
    steps = reference["draws"]
    ts, final = _port_run(tf, step_draws=steps, ckpt_path=path)
    np.testing.assert_allclose(ts, reference["original"], atol=POSE_ATOL)
    stacked = tslam.StepDraws(*(torch.stack([getattr(s, f) for s in steps])
                                for f in ("vo", "ransac", "add")))
    traj, state, stats = replay.replay_sequence(
        tcamera(), tf, path, cfg=tslam.SlamConfig(**CFG), draws=stacked)
    got_t = np.stack([t for t, _ in traj])
    assert len(traj) == len(stats) == N_FRAMES - CKPT
    np.testing.assert_array_equal(got_t, ts[CKPT - 1:])
    for a, b in zip(state, final):
        assert torch.equal(a, b)
    np.testing.assert_allclose(got_t, reference["rep_t"], atol=POSE_ATOL)


def test_replay_from_generator_state(feats, tmp_path):
    """No draws: the replay takes them from the generator state saved in
    the checkpoint, and equals the uninterrupted run bit for bit."""
    tf = to_torch(feats, device="cpu")
    path = str(tmp_path / "snap.npz")
    ts, final = _port_run(tf, generator=torch.Generator().manual_seed(3),
                          ckpt_path=path)
    traj, state, _ = replay.replay_sequence(tcamera(), tf, path,
                                            cfg=tslam.SlamConfig(**CFG))
    np.testing.assert_array_equal(np.stack([t for t, _ in traj]),
                                  ts[CKPT - 1:])
    for a, b in zip(state, final):
        assert torch.equal(a, b)
    assert checkpoint.load_state(path, "cpu")[2] is not None


def test_jax_checkpoint_without_draws_raises(feats, reference):
    """A checkpoint the JAX package wrote loads (state and step), but its
    threefry key cannot seed a generator: replay without draws raises."""
    tf = to_torch(feats, device="cpu")
    state, step, gen, _ = checkpoint.load_state(reference["path"], "cpu")
    assert step == CKPT - 1 and gen is None
    with pytest.raises(ValueError, match="no torch.Generator state"):
        replay.replay_sequence(tcamera(), tf, reference["path"],
                               cfg=tslam.SlamConfig(**CFG))


def test_feature_performance_matches_jax(reference):
    """feature_performance on the reference's replayed final state (as
    the port's tensors) equals the reference's, and its track ratios are
    at most 1."""
    rs = reference["rep_state"]
    ref = jreplay.feature_performance(rs, step=N_FRAMES - 1)
    got = replay.feature_performance(to_torch(rs, device="cpu"),
                                     step=N_FRAMES - 1)
    assert len(got.slot) > 5
    assert np.all(got.track_ratio <= 1.0)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
