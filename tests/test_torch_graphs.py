"""The port's step programs (utils/graphs.py) on the CPU, where each step
runs eagerly on the program's buffers: ``scan_steps``/``run_slam``,
``OnlineSlam.process``, ``run_slam_batched`` and VO ``run_sequence``
against plain Python loops of the step each replays on the card, bit for
bit; the in-place carry; resume and prime; the step's cached constants;
the op trail that names a capture's failing op; and the program
``run_slam`` against the JAX reference's on the same numpy-seeded
features and draws.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.ekf import slam as jslam
from pre3_tpu.frontend.pipeline import Features as JFeatures
from pre3_tpu.geometry.camera import sr4000_camera as jcamera
from pre3_tpu_torch.ekf import slam as tslam
from pre3_tpu_torch.ekf.ncc_matching import grid_unit
from pre3_tpu_torch.ekf.one_point_ransac import pool_size
from pre3_tpu_torch.ekf.prediction import process_noise_on, process_noise_u
from pre3_tpu_torch.frontend import scalespace, sift
from pre3_tpu_torch.frontend.pipeline import (
    Features, extract_features, extract_features_sift, extract_sequences,
)
from pre3_tpu_torch.geometry.camera import sr4000_camera as tcamera
from pre3_tpu_torch.geometry.quaternion import qnormalize, qprod, qrotate
from pre3_tpu_torch.runtime.online import OnlineSlam
from pre3_tpu_torch.utils import graphs
from pre3_tpu_torch.utils.interop import to_numpy
from pre3_tpu_torch.vo.dead_reckoning import Trajectory, run_sequence, vo_pair
from pre3_tpu_torch.vo.ransac import ransac_rigid
from test_torch_ekf import _tilted_floor_xyz
from test_torch_slam import N_REGION, PLANE_BATCH, POSE_ATOL, _run_draws
from torch_reference import reference

N_FRAMES, K, KF = 6, 32, 64
CFG = dict(match_ratio=1.3, min_measured=50, max_update_slots=24)
CONFIGS = {
    "sift": dict(),
    "fast": dict(),
    "ncc": dict(matcher="ncc_warp"),
    "iekf": dict(est_method="iekf"),
    "heading": dict(heading_update_every=2),
}


@pytest.fixture(scope="module")
def seq():
    """Corridor frames as tensors, FAST and SIFT features (K=KF and 96),
    the tilted-floor xyz images for the attitude update."""
    frames, _, _ = render_sequence(n_frames=N_FRAMES, n_points=300,
                                   noise=0.004)
    im = [torch.as_tensor(np.nan_to_num(np.stack([getattr(f, a)
                                                  for f in frames])))
          for a in ("intensity", "xyz", "confidence")]
    fast = extract_features(*im, threshold=0.05, max_features=KF)
    sift_f = extract_features_sift(*im, keypoints_per_octave=32)
    floor = torch.as_tensor(np.stack([_tilted_floor_xyz()] * N_FRAMES))
    return dict(frames=frames, im=im, fast=fast, sift=sift_f, floor=floor)


def _case(seq, name):
    """(features, cfg, images, xyz images) of a config."""
    cfg = tslam.SlamConfig(**CFG, **CONFIGS[name])
    feats = seq["sift" if name == "sift" else "fast"]
    images = seq["im"][0] if name == "ncc" else None
    xyz = {"ncc": seq["im"][1], "heading": seq["floor"]}.get(name)
    return feats, cfg, images, xyz


def _np_draws(cfg, kf, seed, n_frames=N_FRAMES):
    """Numpy-seeded Gumbel draws of a run (the plane fits of the
    attitude update's steps stacked in order)."""
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.as_tensor(  # noqa: E731
        rng.gumbel(size=s).astype(np.float32))
    every = cfg.heading_update_every
    fits = sum(1 for i in range(1, n_frames) if every and i % every == 0)
    s = n_frames - 1
    return tslam.SlamDraws(
        steps=tslam.StepDraws(
            vo=g(s, cfg.vo_batch, kf),
            ransac=g(s, cfg.ransac_batch,
                     pool_size(K, cfg.max_update_slots or None)),
            heading=g(fits, PLANE_BATCH, N_REGION) if fits else None),
        boot_add=None, plane=g(PLANE_BATCH, N_REGION))


def _step_loop(cam, feats, cfg, k, draws=None, generator=None, images=None,
               xyz=None):
    """run_slam as a plain Python loop of slam_step: (trajectory, the
    state after each step)."""
    pick = lambda x, i: None if x is None else x[i]  # noqa: E731
    draws = draws or tslam.SlamDraws(tslam.StepDraws())
    state = tslam.bootstrap_state(
        cam, tslam._frame(feats, 0), cfg, k, xyz_img=pick(xyz, 0),
        image=pick(images, 0), plane_gumbel=draws.plane,
        add_gumbel=draws.boot_add, generator=generator)
    q0 = state.x[3:7]
    every = cfg.heading_update_every
    ts, qs, stats, recs, states, fits = [], [], [], [], [], 0
    for i in range(1, feats.uv.shape[0]):
        fit = every > 0 and i % every == 0
        d = draws.steps
        sd = tslam.StepDraws(
            vo=pick(d.vo, i - 1), ransac=pick(d.ransac, i - 1),
            add=pick(d.add, i - 1),
            heading=pick(d.heading, fits) if fit else None)
        fits += fit
        state, (st, rec) = tslam.slam_step(
            cam, state, tslam._frame(feats, i), tslam._frame(feats, i - 1),
            torch.tensor(i, dtype=torch.int32), cfg, draws=sd,
            generator=generator, image=pick(images, i), xyz_img=pick(xyz, i),
            host_step=i)
        ts.append(state.x[0:3])
        qs.append(state.x[3:7])
        stats.append(st)
        recs.append(rec)
        states.append(state)
    stack = lambda rows, cls: cls(*map(torch.stack, zip(*rows)))  # noqa: E731
    return tslam.SlamTrajectory(
        t=torch.cat([torch.zeros((1, 3)), torch.stack(ts)]),
        q=torch.cat([q0[None], torch.stack(qs)]),
        stats=stack(stats, tslam.StepStats),
        records=stack(recs, tslam.StepRecord)), states


def _bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert (x is None) == (y is None)
        assert x is None or (x.dtype == y.dtype and torch.equal(x, y))


@pytest.mark.parametrize("mode", ["draws", "generator"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_slam_program_equals_step_loop(seq, name, mode):
    """run_slam (bootstrap, then scan_steps' program: each step's frame,
    index and draws copied into its input row, the carry updated in
    place, the output row copied out) against the plain loop of
    slam_step: t, q, stats and records bit for bit, with every draw
    injected and with a generator. With the attitude update every 2
    steps both variants run, the plane fits' draws packed into their
    steps' rows."""
    feats, cfg, images, xyz = _case(seq, name)
    kf = feats.uv.shape[1]
    cam = tcamera()
    kw = dict(images=images, xyz_imgs=xyz)
    if mode == "draws":
        draws = _np_draws(cfg, kf, seed=3)
        got = tslam.run_slam(cam, feats, cfg, K, draws=draws, **kw)
        ref, _ = _step_loop(cam, feats, cfg, K, draws=draws, images=images,
                            xyz=xyz)
    else:
        got = tslam.run_slam(cam, feats, cfg, K,
                             generator=torch.Generator().manual_seed(4), **kw)
        ref, _ = _step_loop(cam, feats, cfg, K,
                            generator=torch.Generator().manual_seed(4),
                            images=images, xyz=xyz)
    _bit_equal(got, ref)
    assert int(got.stats.n_li.sum()) > 0


def test_scan_carry_is_updated_in_place(seq, monkeypatch):
    """scan_steps' program keeps its carry in the same buffers across
    steps and calls (data_ptr), and after each step the carry holds the
    state the eager loop reaches; the returned state is a copy the next
    call does not touch."""
    feats, cfg, _, _ = _case(seq, "fast")
    cam = tcamera()
    seen = []
    run = graphs.StepProgram.run

    def spy(self, variant, body, generators=()):
        out = run(self, variant, body, generators)
        if self.name == "scan_steps":
            st = self.buffers["state"]
            seen.append(([t.data_ptr() for t in st],
                         tslam.EkfState(*(t.clone() for t in st))))
        return out

    monkeypatch.setattr(graphs.StepProgram, "run", spy)
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    g = gen()
    state0 = tslam.bootstrap_state(cam, tslam._frame(feats, 0), cfg, K,
                                   generator=g)
    rest = Features(*(x[1:] for x in feats))
    steps = torch.arange(1, N_FRAMES, dtype=torch.int32)
    final, _ = tslam.scan_steps(cam, state0, tslam._frame(feats, 0), rest,
                                steps, cfg, generator=g, first_step=1)
    _, states = _step_loop(cam, feats, cfg, K, generator=gen())
    assert len(seen) == N_FRAMES - 1
    assert all(ptrs == seen[0][0] for ptrs, _ in seen)
    for (_, carry), ref in zip(seen, states):
        _bit_equal(tuple(carry), tuple(ref))
    kept = tslam.EkfState(*(t.clone() for t in final))
    tslam.scan_steps(cam, state0, tslam._frame(feats, 0), rest, steps, cfg,
                     generator=gen(), first_step=1)
    assert seen[-1][0] == seen[0][0]
    _bit_equal(tuple(final), tuple(kept))
    assert final.p.data_ptr() not in seen[0][0]


def _online(**kw):
    return OnlineSlam(tcamera(), cfg=tslam.SlamConfig(**CFG), n_landmarks=K,
                      extractor="fast",
                      extractor_kwargs=dict(threshold=0.05, max_features=KF),
                      device="cpu", **kw)


def _host(seq, i):
    f = seq["frames"][i]
    return f.intensity, f.xyz, f.confidence


def test_online_process_equals_fused_fn(seq):
    """OnlineSlam.process, one frame program per frame, against its own
    boot_fn and fused_fn run eagerly frame by frame: t, q, stats and
    records bit for bit; the carry (``state``) stays in the program's
    buffers; results are rows of per-step storage, not the program's
    buffers."""
    slam = _online(generator=torch.Generator().manual_seed(6))
    ptrs = []
    for i in range(N_FRAMES):
        slam.process(*_host(seq, i))
        if i:
            ptrs.append([t.data_ptr() for t in slam.state])
    assert all(p == ptrs[0] for p in ptrs)
    (prog, _), = slam.programs.values()
    packed = prog.buffers["packed"]
    assert all(r.t.untyped_storage().data_ptr()
               != packed.untyped_storage().data_ptr()
               for r in slam.results[1:])

    ref = _online(generator=torch.Generator().manual_seed(6))
    frames = [[torch.as_tensor(np.asarray(a), dtype=torch.float32)
               for a in _host(seq, i)] for i in range(N_FRAMES)]
    state, step, prev, t, q = ref.boot_fn(*frames[0],
                                          generator=ref.generator)
    rows, recs = [(t, q)], []
    for i in range(1, N_FRAMES):
        state, step, prev, t, q, st, rec = ref.fused_fn(
            state, step, prev, *frames[i], generator=ref.generator,
            host_step=i)
        rows.append((t, q, st))
        recs.append(rec)
    _bit_equal([(r.t, r.q) if r.stats is None else (r.t, r.q, r.stats)
                for r in slam.results], rows)
    _bit_equal(tslam.StepRecord(*map(torch.as_tensor,
                                     slam._stacked_records())),
               tslam.StepRecord(*map(torch.stack, zip(*recs))))
    _bit_equal(tuple(slam.state), tuple(state))


@pytest.mark.parametrize("live", [False, True])
def test_resumed_and_primed_equals_uninterrupted(seq, tmp_path, live):
    """A run snapshotted after 4 steps; a second driver resumed from it
    (fresh, or with a live carry of its own that resume copies into)
    and primed with frame 3 streams the remaining frames bit-equal to the
    uninterrupted run, and ends in the same state."""
    a = _online(generator=torch.Generator().manual_seed(7),
                snapshot_dir=str(tmp_path), snapshot_every=4)
    for i in range(N_FRAMES):
        a.process(*_host(seq, i))
    b = _online()
    if live:
        for i in range(2):
            b.process(*_host(seq, i))
        carry = [t.data_ptr() for t in b.state]
    b.resume(str(tmp_path / "snapshot_00004.npz"))
    if live:
        assert [t.data_ptr() for t in b.state] == carry
    b.prime(*_host(seq, 3))
    for i in range(4, N_FRAMES):
        b.process(*_host(seq, i))
    _bit_equal([(r.t, r.q, r.stats) for r in a.results[4:]],
               [(r.t, r.q, r.stats) for r in b.results[-(N_FRAMES - 4):]])
    _bit_equal(tuple(a.state), tuple(b.state))


@pytest.mark.parametrize("draw_block", [tslam.DRAW_BLOCK, 2])
def test_run_slam_batched_program_equals_loop(monkeypatch, draw_block):
    """run_slam_batched (S=3; one batched step program: the S generators'
    draws made ahead by its draw variants, one vmap of slam_step, the
    carry, the output row) against the plain loop of draw_batched and
    slam_step_batched; with blocks of 2 steps the 5 steps cross two
    block boundaries and the last block takes the 1-step draw."""
    monkeypatch.setattr(tslam, "DRAW_BLOCK", draw_block)
    s, n = 3, 6
    images = []
    for b in range(s):
        frames, _, _ = render_sequence(n_frames=n, n_points=300, noise=0.004,
                                       scene_seed=b, traj_seed=100 + b)
        images.append([np.nan_to_num(np.stack([getattr(f, a)
                                               for f in frames]))
                       for a in ("intensity", "xyz", "confidence")])
    im = [torch.as_tensor(np.stack(x)) for x in zip(*images)]
    feats = extract_sequences(extract_features, *im, threshold=0.05,
                              max_features=KF)
    cfg = tslam.SlamConfig(**CFG)
    cam = tcamera()
    gens = lambda: [torch.Generator().manual_seed(20 + q)  # noqa: E731
                    for q in range(s)]
    got = tslam.run_slam_batched(cam, feats, cfg, K, generators=gens())

    g = gens()
    state = tslam.bootstrap_batched(cam, Features(*(x[:, 0] for x in feats)),
                                    cfg, K, generators=g)
    q0 = state.x[:, 3:7]
    ts, qs, stats, recs = [], [], [], []
    for i in range(1, n):
        d = tslam.draw_batched(cfg, KF, K, g, "cpu")
        state, (st, rec) = tslam.slam_step_batched(
            cam, state, Features(*(x[:, i] for x in feats)),
            Features(*(x[:, i - 1] for x in feats)),
            torch.tensor(i, dtype=torch.int32), cfg, d)
        ts.append(state.x[:, 0:3])
        qs.append(state.x[:, 3:7])
        stats.append(st)
        recs.append(rec)
    stack = lambda rows, cls: cls(*(torch.stack(f, 1)  # noqa: E731
                                    for f in zip(*rows)))
    ref = tslam.SlamTrajectory(
        t=torch.cat([torch.zeros((s, 1, 3)), torch.stack(ts, 1)], 1),
        q=torch.cat([q0[:, None], torch.stack(qs, 1)], 1),
        stats=stack(stats, tslam.StepStats),
        records=stack(recs, tslam.StepRecord))
    _bit_equal(got, ref)


@pytest.mark.parametrize("mode", ["gumbel", "generator"])
def test_vo_run_sequence_program_equals_loop(seq, mode):
    """VO run_sequence (one pair program: frame i+1 and the pair's noise
    in its input row, frame i and the pose in the carry, the chained pose
    out) against the plain loop of vo_pair, with injected noise and with
    a generator."""
    feats, batch = seq["fast"], 256
    rng = np.random.default_rng(8)
    gumbel = torch.as_tensor(rng.gumbel(size=(N_FRAMES - 1, batch, KF))
                             .astype(np.float32))
    kw = (dict(gumbel=gumbel) if mode == "gumbel"
          else dict(generator=torch.Generator().manual_seed(9)))
    got = run_sequence(feats, batch=batch, **kw)
    gen = torch.Generator().manual_seed(9)
    t_w, q_w = torch.zeros(3), torch.tensor([1.0, 0.0, 0.0, 0.0])
    rows = [(t_w, q_w, torch.tensor(True), torch.tensor(0, dtype=torch.int32))]
    for i in range(1, N_FRAMES):
        s = vo_pair(tslam._frame(feats, i - 1), tslam._frame(feats, i),
                    gumbel=gumbel[i - 1] if mode == "gumbel" else None,
                    generator=gen, batch=batch)
        dt = torch.where(s.ok, s.delta.t, torch.zeros(3))
        dq = torch.where(s.ok, s.delta.q, torch.tensor([1.0, 0, 0, 0]))
        t_w = t_w + qrotate(q_w, dt)
        q_w = qnormalize(qprod(q_w, dq))
        rows.append((t_w, q_w, s.ok, s.n_inliers))
    _bit_equal(got, Trajectory(*map(torch.stack, zip(*rows))))


CONSTANTS = {
    "gaussian_taps": (
        lambda: scalespace.gaussian_blur(torch.ones(1, 8, 8), 1.3),
        ("gaussian_taps", 1.3, torch.float32),
        lambda: torch.from_numpy(scalespace.gaussian_kernel(1.3))),
    "band_matrix": (
        lambda: sift._tri_sepconv(torch.ones(6, 7, 2), 2.5),
        ("band_matrix", 7, 2.5),
        lambda: torch.from_numpy(sift._band_matrix(7, 2.5))),
    "process_noise": (
        lambda: process_noise_on("cpu"), "process_noise_u", process_noise_u),
    "ncc_grid": (lambda: grid_unit(13), ("ncc_grid", 13, torch.float32),
                 None),
}


@pytest.mark.parametrize("name", list(CONSTANTS))
def test_step_constants_are_cached(name):
    """Each constant the step used to copy to the device on every call is
    built once per (key, device) and is the same tensor on every later
    call, bit-equal to its builder's value."""
    from pre3_tpu_torch.utils.device import _CONSTANTS

    use, key, build = CONSTANTS[name]
    use()
    cached = _CONSTANTS[(key, torch.device("cpu"))]
    use()
    assert _CONSTANTS[(key, torch.device("cpu"))] is cached
    if name == "ncc_grid":
        assert grid_unit(13) is cached
    else:
        assert torch.equal(cached, build())


def test_ransac_float_threshold_is_a_device_fill():
    """A Python-float support threshold is filled on the device (no host
    copy): the same fit as the same threshold given as a tensor."""
    rng = np.random.default_rng(10)
    p2 = torch.as_tensor(rng.normal(size=(40, 3)).astype(np.float32))
    p1 = p2 + 0.5
    valid = torch.ones(40, dtype=torch.bool)
    g = torch.as_tensor(rng.gumbel(size=(64, 40)).astype(np.float32))
    a = ransac_rigid(p1, p2, valid, batch=64, support_threshold=0.01,
                     gumbel=g)
    b = ransac_rigid(p1, p2, valid, batch=64,
                     support_threshold=torch.tensor(0.01), gumbel=g)
    _bit_equal(a, b)


def test_op_trail_names_the_failing_op():
    """The dispatch mode a capture runs under remembers the last op, so a
    capture that fails names it."""
    trail = graphs._OpTrail()
    with pytest.raises(RuntimeError, match="boom"), trail:
        x = torch.ones(3) * 2
        torch.nonzero(x)
        raise RuntimeError("boom")
    assert "nonzero" in trail.last


def test_op_trail_keeps_the_batched_step(seq):
    """Under the op trail (as during a capture) the batched step — vmap,
    jacfwd and the kernels' custom ops inside — gives the same bits."""
    feats = Features(*(torch.stack([x, x]) for x in seq["fast"]))
    cfg = tslam.SlamConfig(**CFG)
    cam = tcamera()
    state = tslam.bootstrap_batched(cam, Features(*(x[:, 0] for x in feats)),
                                    cfg, K, generators=[
                                        torch.Generator().manual_seed(q)
                                        for q in range(2)])
    d = tslam.draw_batched(cfg, KF, K, [torch.Generator().manual_seed(q)
                                        for q in range(2)], "cpu")
    step = functools.partial(
        tslam.slam_step_batched, cam, state,
        Features(*(x[:, 1] for x in feats)),
        Features(*(x[:, 0] for x in feats)),
        torch.tensor(1, dtype=torch.int32), cfg, d)
    ref = step()
    with graphs._OpTrail() as trail:
        got = step()
    _bit_equal(got, ref)
    assert trail.last != "no op"


def test_program_run_slam_matches_jax():
    """The program run_slam against the reference's run_slam on the same
    numpy-seeded FAST features (K=32, 6 frames) and the reference's own
    draws injected: the same per-step stats, poses within POSE_ATOL."""
    frames, _, _ = render_sequence(n_frames=N_FRAMES, n_points=300,
                                   noise=0.004, scene_seed=12)
    im = [np.nan_to_num(np.stack([getattr(f, a) for f in frames]))
          for a in ("intensity", "xyz", "confidence")]
    feats = extract_features(*map(torch.as_tensor, im), threshold=0.05,
                             max_features=KF)
    cfg = tslam.SlamConfig(**CFG)
    key = jax.random.PRNGKey(13)
    ref = reference(jslam.run_slam, jcamera(),
                    JFeatures(*map(jnp.asarray, to_numpy(feats))), key,
                    cfg=jslam.SlamConfig(**CFG), n_landmarks=K)
    draws = _run_draws(key, cfg, N_FRAMES, with_plane=False)
    got = to_numpy(tslam.run_slam(tcamera(), feats, cfg, n_landmarks=K,
                                  draws=draws))
    for name in ref.stats._fields:
        np.testing.assert_array_equal(getattr(got.stats, name),
                                      getattr(ref.stats, name), err_msg=name)
    np.testing.assert_allclose(got.t, ref.t, atol=POSE_ATOL)
    np.testing.assert_allclose(got.q, ref.q, atol=POSE_ATOL)


def test_one_program_serves_every_length(seq):
    """Programs are keyed by one step's shapes: run_slam over 6 frames and
    then over 4 and 3 uses the one step program of the first call (and
    its one bootstrap program), each run bit-equal to the plain loop; VO
    run_sequence likewise."""
    feats, cfg, _, _ = _case(seq, "fast")
    cam = tcamera()
    graphs.clear()
    cut = lambda n: Features(*(x[:n] for x in feats))  # noqa: E731
    for n in (N_FRAMES, 4, 3):
        got = tslam.run_slam(cam, cut(n), cfg, K,
                             generator=torch.Generator().manual_seed(14))
        ref, _ = _step_loop(cam, cut(n), cfg, K,
                            generator=torch.Generator().manual_seed(14))
        _bit_equal(got, ref)
        assert [p.name for p in graphs.programs()] == ["bootstrap_state",
                                                       "scan_steps"]
    for n in (N_FRAMES, 3):
        run_sequence(cut(n), generator=torch.Generator().manual_seed(15),
                     batch=64)
    assert sorted(p.name for p in graphs.programs()) == [
        "bootstrap_state", "run_sequence", "scan_steps"]


def test_packing_round_trip():
    """A Packing lays a tree (NamedTuples, None leaves, f32/i32/i64/bool)
    into one byte row per step: rows with leading axes unpack to views of
    the same values, and None stays None."""
    rng = np.random.default_rng(16)
    one = tslam.StepDraws(
        vo=torch.as_tensor(rng.normal(size=(3, 5)).astype(np.float32)),
        ransac=None,
        add=torch.as_tensor(rng.integers(0, 9, size=7), dtype=torch.int64),
        heading=torch.as_tensor(rng.random(3) < 0.5))
    packing = graphs.Packing((one, torch.tensor(3, dtype=torch.int32)))
    assert packing.nbytes % 16 == 0
    stacked = tslam.StepDraws(*(None if x is None else torch.stack([x, x])
                                for x in one))
    steps = torch.tensor([3, 4], dtype=torch.int32)
    rows = packing.rows(2, device="cpu")
    packing.pack((stacked, steps), rows)
    got, got_steps = packing.unpack(rows)
    assert got.ransac is None
    _bit_equal((got, got_steps), (stacked, steps))
    row, step = packing.unpack(rows[1])
    _bit_equal((row, step), (one, steps[1]))


def test_draw_blocks_cover_every_length():
    """The batched draw variants (1, 2, 4, … steps) that fill a block of
    n steps: powers of two, largest first, summing to n."""
    for n in range(1, 2 * tslam.DRAW_BLOCK + 1):
        parts = tslam._blocks(n)
        assert sum(parts) == n and parts == sorted(parts, reverse=True)
        assert all(p & (p - 1) == 0 for p in parts)
        assert len(parts) == len(set(parts))


def test_launch_count_on_the_cpu():
    """A counted wrapper calls its function; on the CPU no kernel runs,
    so its count stays where it was set; ``uncounted`` is per thread and
    nests."""
    from pre3_tpu_torch.utils import launch_count

    f = launch_count.Counted(lambda x: x + 1)
    assert f(1) == 2 and f.launches == 0
    f.launches = 5
    assert f(2) == 3 and f.launches == 5
    with launch_count.uncounted():
        with launch_count.uncounted():
            assert launch_count._LOCAL.off
        assert launch_count._LOCAL.off
    assert not launch_count._LOCAL.off
