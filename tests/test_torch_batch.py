"""The multi-sequence path, port vs JAX reference: ``run_slam_batched``
(one ``torch.func.vmap(slam_step)`` per step over S sequences) against
the reference's ``jax.vmap(run_slam)``, as tools/measure_batch.py runs
it, and against S single ``run_slam`` calls; the kernels' wrappers
under vmap; the frontend over S·F frames; the ``measure_batch`` tool.

The reference is compiled once, in a module fixture (FAST features, so
the compile stays small; the batched step is the same for SIFT's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.ekf import slam as jslam
from pre3_tpu.frontend.pipeline import extract_features as jextract
from pre3_tpu.geometry.camera import sr4000_camera as jcamera
from pre3_tpu_torch.ekf import slam as tslam
from pre3_tpu_torch.frontend.pipeline import (
    Features, extract_features_sift, extract_sequences,
)
from pre3_tpu_torch.geometry.camera import sr4000_camera as tcamera
from pre3_tpu_torch.ops import matching, ransac_score
from pre3_tpu_torch.utils import measure_batch
from pre3_tpu_torch.utils.interop import to_numpy, to_torch
from test_torch_slam import CFG, K, KF, POSE_ATOL, _run_draws

S, N_FRAMES = 3, 8
# A batched run against single runs of the same arithmetic: only the
# order of a few reductions differs under vmap; seen ≤ 3e-8 over 7 steps.
SINGLE_ATOL = 1e-6


def _sequences(n_seq, n_frames):
    """measure_batch's corridors: scene_seed=b, traj_seed=100 + b."""
    out = []
    for b in range(n_seq):
        frames, _, _ = render_sequence(
            n_frames=n_frames, n_points=832, noise=0.004,
            x_range=(-1.8, 0.015 * n_frames + 1.8), scene_seed=b,
            traj_seed=100 + b)
        out.append([np.stack([getattr(f, a) for f in frames])
                    for a in ("intensity", "xyz", "confidence")])
    return [np.stack(x) for x in zip(*out)]


@pytest.fixture(scope="module")
def seqs():
    """S FAST feature sequences of N_FRAMES (the reference's frontend)."""
    images = _sequences(S, N_FRAMES)
    fe = jax.vmap(lambda i, x, c: jextract(i, x, c, threshold=0.05,
                                           max_features=KF))
    feats = [jax.tree.map(np.array, fe(*(x[b] for x in images)))
             for b in range(S)]
    return jax.tree.map(lambda *xs: np.stack(xs), *feats)


@pytest.fixture(scope="module")
def keys():
    return jax.random.split(jax.random.PRNGKey(0), S)


@pytest.fixture(scope="module")
def jax_run(seqs, keys):
    """The reference's jax.vmap(run_slam) over the S sequences."""
    cfg = jslam.SlamConfig(**CFG)
    out = jax.jit(jax.vmap(lambda f, k: jslam.run_slam(
        jcamera(), f, k, cfg=cfg, n_landmarks=K)))(
        jax.tree.map(jnp.asarray, seqs), keys)
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def draws(keys):
    """Each key's run_slam draws, stacked on a leading S axis."""
    cfg = tslam.SlamConfig(**CFG)
    per = [_run_draws(k, cfg, N_FRAMES, with_plane=False) for k in keys]
    return tslam.SlamDraws(
        steps=tslam.StepDraws(*(
            None if f[0] is None else torch.stack(f)
            for f in zip(*(d.steps for d in per)))),
        boot_add=torch.stack([d.boot_add for d in per]))


def _seq_draws(draws, s):
    return tslam.SlamDraws(
        steps=tslam.StepDraws(*(None if f is None else f[s]
                                for f in draws.steps)),
        boot_add=draws.boot_add[s])


@pytest.fixture(scope="module")
def batched(seqs, draws):
    """The port's run_slam_batched over the S sequences with each key's
    draws, read by (a) and (b)."""
    return tslam.run_slam_batched(
        tcamera(), to_torch(seqs, device="cpu"), tslam.SlamConfig(**CFG),
        n_landmarks=K, draws=draws)


def test_run_slam_batched_matches_jax_vmap(jax_run, batched):
    """(a) S = 3 sequences, K = 32, each key's draws: stats and the
    measured/visible/init_frame records equal, poses within POSE_ATOL."""
    got = to_numpy(batched)
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
    assert got.t.shape == (S, N_FRAMES, 3)
    assert ref.stats.vo_ok.all() and ref.stats.n_li.mean() > 10


@pytest.mark.parametrize("source", ["draws", "generators"])
def test_run_slam_batched_matches_single_runs(seqs, draws, batched, source):
    """(b) run_slam_batched against S single run_slam calls, with the
    same injected draws, then with the same per-sequence generators
    (draw_step draws outside the vmap in run_slam's order): stats and
    records' masks equal, poses within SINGLE_ATOL."""
    cam, cfg = tcamera(), tslam.SlamConfig(**CFG)
    feats = to_torch(seqs, device="cpu")

    def gens():
        return [torch.Generator().manual_seed(7 + s) for s in range(S)]

    if source == "draws":
        singles = [tslam.run_slam(cam, Features(*(x[s] for x in feats)), cfg,
                                  K, draws=_seq_draws(draws, s))
                   for s in range(S)]
    else:
        batched = tslam.run_slam_batched(cam, feats, cfg, K,
                                         generators=gens())
        singles = [tslam.run_slam(cam, Features(*(x[s] for x in feats)), cfg,
                                  K, generator=g)
                   for s, g in enumerate(gens())]
    for s, one in enumerate(singles):
        for name in one.stats._fields:
            assert torch.equal(getattr(batched.stats, name)[s],
                               getattr(one.stats, name)), (s, name)
        for name in ("measured", "visible", "init_frame"):
            assert torch.equal(getattr(batched.records, name)[s],
                               getattr(one.records, name)), (s, name)
        torch.testing.assert_close(batched.t[s], one.t, rtol=0,
                                   atol=SINGLE_ATOL)
        torch.testing.assert_close(batched.q[s], one.q, rtol=0,
                                   atol=SINGLE_ATOL)


def test_run_slam_batched_rejects_per_frame_options(seqs):
    """The NCC matcher and the periodic attitude update need per-frame
    images, which the batched path does not take."""
    feats = to_torch(seqs, device="cpu")
    for opt in (dict(matcher="ncc_warp"), dict(heading_update_every=2)):
        with pytest.raises(ValueError, match="run_slam_batched"):
            tslam.run_slam_batched(tcamera(), feats,
                                   tslam.SlamConfig(**CFG, **opt), K)


def _vmap_nofallback(fn, in_dims, *args):
    with tslam.no_vmap_fallback():
        return torch.func.vmap(fn, in_dims=in_dims)(*args)


@pytest.mark.parametrize("shared", [(), ("threshold",), ("p1", "p2", "valid"),
                                    ("r", "t")])
def test_k1_vmap_rule(shared):
    """(c) K1's wrapper under vmap, with the named arguments shared
    (unbatched) and the rest batched on axis 0 or 1: bitwise the plain
    version per sequence. On CPU tensors the wrapper is the plain version,
    batched by vmap as run_slam_batched runs it (the custom op under vmap:
    tests/test_torch_kernel_op.py)."""
    rng = np.random.default_rng(0)
    n_seq, b, n = 3, 64, 40
    full = dict(
        r=rng.normal(size=(n_seq, b, 3, 3)), t=rng.normal(size=(n_seq, b, 3)),
        p1=rng.normal(size=(n_seq, n, 3)), p2=rng.normal(size=(n_seq, n, 3)),
        valid=rng.uniform(size=(n_seq, n)) > 0.2,
        threshold=rng.uniform(1.0, 3.0, size=n_seq))
    names = list(full)
    args, dims = [], []
    for name in names:
        x = torch.as_tensor(full[name])
        x = x.float() if x.dtype == torch.float64 else x
        if name in shared:
            args.append(x[0])
            dims.append(None)
        elif name == "r":  # batched on another axis than the first
            args.append(x.movedim(0, 1))
            dims.append(1)
        else:
            args.append(x)
            dims.append(0)
    sup, err = _vmap_nofallback(ransac_score.score_hypotheses, tuple(dims),
                                *args)
    for s in range(n_seq):
        one = [a if d is None else a.select(d, s) for a, d in zip(args, dims)]
        ref = ransac_score.score_hypotheses_torch(*one)
        assert torch.equal(sup[s], ref[0]) and torch.equal(err[s], ref[1])


@pytest.mark.parametrize("case", ["all-batched", "shared-d2", "no-valid2",
                                  "batched-on-axis-1"])
def test_k2_vmap_rule(case):
    """(c) K2's wrapper under vmap (d2 shared, valid2 absent, a
    batch axis not in front): bitwise the plain matcher per sequence,
    ratio test and valid1 applied after it as on a single call. On CPU
    tensors the wrapper is the plain matcher, batched by vmap."""
    rng = np.random.default_rng(1)
    n_seq, n1, n2, d = 3, 20, 30, 16
    d1 = torch.as_tensor(rng.normal(size=(n_seq, n1, d)), dtype=torch.float32)
    d2 = torch.as_tensor(rng.normal(size=(n_seq, n2, d)), dtype=torch.float32)
    v1 = torch.as_tensor(rng.uniform(size=(n_seq, n1)) > 0.1)
    v2 = torch.as_tensor(rng.uniform(size=(n_seq, n2)) > 0.1)
    if case == "shared-d2":
        args, dims = (d1, d2[0], v1, v2[0]), (0, None, 0, None)
    elif case == "no-valid2":
        args, dims = (d1, d2, v1, None), (0, 0, 0, None)
    elif case == "batched-on-axis-1":
        args, dims = (d1.movedim(0, 1), d2, v1, v2), (1, 0, 0, 0)
    else:
        args, dims = (d1, d2, v1, v2), (0, 0, 0, 0)
    got = _vmap_nofallback(
        lambda a, b, c, e: matching.match_descriptors_k2(a, b, c, e,
                                                         ratio=1.3),
        dims, *args)
    for s in range(n_seq):
        one = [None if a is None else (a if dd is None else a.select(dd, s))
               for a, dd in zip(args, dims)]
        ref = matching.match_descriptors(*one, ratio=1.3)
        for name, g, r in zip(ref._fields, got, ref):
            assert torch.equal(g[s], r), (s, name)


def test_frontend_over_sequences():
    """(d) extract_features_sift over the S·F frames at once, reshaped to
    [S, F, ...], against per-sequence extraction: keypoints, depth,
    validity and score equal; descriptors within 1e-7 (the frame batch
    of the separable blur's matmul changes its CPU blocking: seen 4e-9)."""
    images = [torch.as_tensor(x) for x in _sequences(2, 4)]
    got = extract_sequences(extract_features_sift, *images)
    assert got.desc.shape == (2, 4, 288, 128)
    for s in range(2):
        one = extract_features_sift(*(x[s] for x in images))
        for name in ("uv", "xyz", "valid", "score"):
            assert torch.equal(getattr(got, name)[s], getattr(one, name)), name
        torch.testing.assert_close(got.desc[s], one.desc, rtol=0, atol=1e-7)


def test_measure_batch_cpu(capsys):
    """(e) the measure_batch tool on the CPU at B = 2, 4 frames, K = 16:
    a line per B, finite trajectories that track, device figures not
    measured."""
    (res,) = measure_batch.main(["4", "16", "2", "--device", "cpu",
                                 "--reps", "1"])
    out = capsys.readouterr().out
    assert "B= 2: aggregate" in out and "idle share not measured" in out
    traj = res["trajectory"]
    assert traj.t.shape == (2, 4, 3) and torch.isfinite(traj.t).all()
    assert res["aggregate_fps"] > 0 and res["ate_max"] < 0.1
    assert res["k1"] == res["k2"] == 0  # the CPU launches no kernel
    assert res["valid_per_frame"] > 50
