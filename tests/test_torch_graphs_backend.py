"""Config #4's step programs on the CPU, where each runs eagerly on the
program's buffers: ``bundle_adjust`` (its ``cost0`` and ``iteration``
variants), ``build_tracks`` (one keyframe per run), the loop-mining pair
of ``mine_keyframe_loop_closures`` and the pair of ``find_keyframes_vo``.
Each is held to a plain loop of its body, bit for bit; one program serves
every ``iters``, keyframe count and number of pairs; no result aliases a
program buffer; and the key holds everything a body bakes in (weights,
``fixed_first``). The bodies' parity with the JAX reference is
``tests/test_torch_backend.py``'s; this file compiles nothing of JAX.

Inputs are numpy-seeded: tests/test_ba.py's BA generator at F = 6, L = 40
rebuilt with the port's geometry, and an out-and-back scene of 8 frames
with 32 features each (descriptors, camera-frame points) for the tracks,
the mining and the keyframe search.
"""

import os

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from pre3_tpu_torch.backend import ba, keyframes, loop_detect, tracks
from pre3_tpu_torch.backend.ba import BaProblem, BaResult
from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.geometry.camera import project, sr4000_camera
from pre3_tpu_torch.geometry.quaternion import qconj, qprod, qrotate, v2q
from pre3_tpu_torch.utils import graphs
from pre3_tpu_torch.utils.cache import VoCache

CAM = sr4000_camera()
F_BA, L_BA, ITERS = 6, 40, 3
N_FRAMES, KF, N_POINTS, D = 8, 32, 48, 32
BATCH = 64
WEIGHTS = dict(depth_weight=50.0, odo_weight_t=20.0, odo_weight_r=50.0,
               depth_range_ref=0.0, lcp_weight_t=20.0, lcp_weight_r=50.0)


def _bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)


def _clone(tree):
    return [x.clone() if isinstance(x, torch.Tensor) else np.copy(x)
            for x in tree_leaves(tree)]


def _buffers():
    """The storages of every program's buffers."""
    return {t.untyped_storage().data_ptr() for p in graphs.programs()
            for t in tree_leaves(p.buffers) if t is not None}


def _owns_nothing(tree):
    """No tensor of ``tree`` lies in a program buffer."""
    held = _buffers()
    assert all(t.untyped_storage().data_ptr() not in held
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


# --------------------------------------------------------------------------
# bundle_adjust
# --------------------------------------------------------------------------

def _ba_problem(seed: int = 2) -> BaProblem:
    """tests/test_ba.py's generator in the port's geometry: F_BA keyframes
    along x, L_BA points 2–4 m ahead, 0.3 px noise, poses and points
    perturbed by 2 cm (keyframe 0 exact), RGB-D observations."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    points = f32(np.stack([rng.uniform(-1.5, 1.5, L_BA),
                           rng.uniform(-1.0, 1.0, L_BA),
                           rng.uniform(2.0, 4.0, L_BA)], -1))
    i = np.arange(F_BA)
    kf_t = f32(np.stack([0.08 * i, 0.02 * np.sin(i), 0 * i], -1))
    kf_q = v2q(f32(np.stack([0 * i, 0.01 * i, 0.005 * i], -1)))
    p_cam = qrotate(qconj(kf_q)[:, None], points[None] - kf_t[:, None])
    uv = project(CAM, p_cam)
    mask = ((p_cam[..., 2] > 0.5) & (uv[..., 0] > 2) & (uv[..., 0] < 173)
            & (uv[..., 1] > 2) & (uv[..., 1] < 141))
    t_init = kf_t + f32(rng.normal(scale=0.02, size=(F_BA, 3)))
    t_init[0] = kf_t[0]
    return BaProblem(
        obs_uv=uv + f32(rng.normal(scale=0.3, size=uv.shape)), mask=mask,
        kf_t=t_init, kf_q=kf_q,
        points=points + f32(rng.normal(scale=0.02, size=(L_BA, 3))),
        obs_xyz=p_cam, mask_xyz=mask)


def _with(prob: BaProblem, variant: str) -> BaProblem:
    """The problem with one factor set: none, depth, odometry, lcp (scalar
    weights or square-root information), loop-closure landmarks."""
    rng = np.random.default_rng(3)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    base = prob._replace(obs_xyz=None, mask_xyz=None)
    if variant in ("obs_xyz", "depth_range_ref"):
        return prob
    if variant == "odo":
        q = prob.kf_q
        return base._replace(
            odo_t=qrotate(qconj(q[:-1]), prob.kf_t[1:] - prob.kf_t[:-1])
            + f32(rng.normal(scale=0.005, size=(F_BA - 1, 3))),
            odo_q=qprod(qconj(q[:-1]), q[1:]),
            odo_w=f32([1, 1, 1, 0, 1]))
    if variant in ("lcp", "lcp_info"):
        a = rng.normal(scale=0.01, size=(2, 6, 6))
        info = f32(np.stack([loop_detect.sqrt_information(x @ x.T)
                             for x in a]))
        q = prob.kf_q
        return base._replace(
            lcp_i=torch.tensor([0, 1], dtype=torch.int32),
            lcp_j=torch.tensor([5, 4], dtype=torch.int32),
            lcp_t=qrotate(qconj(q[[0, 1]]), prob.kf_t[[5, 4]]
                          - prob.kf_t[[0, 1]]),
            lcp_q=qprod(qconj(q[[0, 1]]), q[[5, 4]]), lcp_w=f32([1, 0.5]),
            lcp_info=info if variant == "lcp_info" else None)
    if variant == "lc_lm":
        lc = torch.zeros(L_BA, dtype=torch.bool)
        lc[[3, 11]] = True
        return base._replace(lc_lm=lc)
    return base


BA_VARIANTS = ["plain", "obs_xyz", "odo", "lcp", "lcp_info", "lc_lm",
               "depth_range_ref"]


def _ba_loop(prob: BaProblem, iters: int, damping: float = 1e-3,
             fixed_first: bool = True, **kw) -> BaResult:
    """bundle_adjust as a plain loop of its bodies: the initial cost, then
    ``_lm_step`` ``iters`` times."""
    w = {**WEIGHTS, **kw}
    terms = ba._terms(prob, w["depth_weight"], w["odo_weight_t"],
                      w["odo_weight_r"], w["depth_range_ref"],
                      w["lcp_weight_t"], w["lcp_weight_r"])
    c0 = ba._problem_cost(CAM, prob, terms, prob.kf_t, prob.kf_q,
                          prob.points)
    state = (prob.kf_t, prob.kf_q, prob.points, torch.full((), damping), c0)
    costs = [c0]
    for _ in range(iters):
        state = ba._lm_step(CAM, prob, terms, fixed_first, *state)
        costs.append(state[4])
    return BaResult(*state[:3], cost=torch.stack(costs))


@pytest.mark.parametrize("variant", BA_VARIANTS)
def test_bundle_adjust_program_equals_loop(variant):
    """The BA program (the problem copied into its buffers, ``cost0`` once,
    ``iteration`` ITERS times on the carry, each kept cost copied out)
    against the plain loop of its bodies, for every factor set: kf_t,
    kf_q, points and cost bit for bit, and the cost falls."""
    prob = _with(_ba_problem(), variant)
    kw = dict(depth_range_ref=3.0) if variant == "depth_range_ref" else {}
    got = ba.bundle_adjust(CAM, prob, iters=ITERS, **kw)
    _bit_equal(got, _ba_loop(prob, ITERS, **kw))
    assert got.cost.shape == (ITERS + 1,) and got.cost[-1] < got.cost[0]
    _owns_nothing(got)


@pytest.mark.parametrize("change", [
    dict(depth_weight=10.0), dict(odo_weight_t=5.0), dict(odo_weight_r=9.0),
    dict(lcp_weight_t=3.0), dict(lcp_weight_r=7.0),
    dict(depth_range_ref=2.5), dict(fixed_first=False), dict(damping=0.5)])
def test_bundle_adjust_key_holds_what_the_graph_bakes(change):
    """Two solves of problems with the same shapes, the second with one
    weight (or ``fixed_first``, or the damping that seeds λ) changed:
    each gives its own plain loop's answer, and the two differ. Weights
    and ``fixed_first`` each key their own program; the damping is a
    fill of the carry and shares the program."""
    base = _ba_problem()
    lcp = _with(base, "lcp")  # scalar weights: lcp_weight_t/r apply
    prob = _with(base, "odo")._replace(
        obs_xyz=base.obs_xyz, mask_xyz=base.mask_xyz,
        **{k: getattr(lcp, k) for k in ("lcp_i", "lcp_j", "lcp_t", "lcp_q",
                                        "lcp_w")})
    graphs.clear()
    first = ba.bundle_adjust(CAM, prob, iters=2)
    second = ba.bundle_adjust(CAM, prob, iters=2, **change)
    _bit_equal(first, _ba_loop(prob, 2))
    _bit_equal(second, _ba_loop(prob, 2, **change))
    assert not torch.equal(first.kf_t, second.kf_t)
    names = [p.name for p in graphs.programs()]
    assert names == ["bundle_adjust"] * (1 if "damping" in change else 2)


def test_bundle_adjust_one_program_serves_every_iters():
    """Solves of 0, 1 and 4 iterations replay the one program of the
    first (never keyed by ``iters``), each equal to its plain loop; a
    problem with another factor set keys a second program."""
    prob = _ba_problem()
    graphs.clear()
    for iters in (0, 1, 4):
        _bit_equal(ba.bundle_adjust(CAM, prob, iters=iters),
                   _ba_loop(prob, iters))
        assert len(graphs.programs()) == 1
    ba.bundle_adjust(CAM, _with(prob, "odo"), iters=1)
    assert [p.name for p in graphs.programs()] == ["bundle_adjust"] * 2


def test_bundle_adjust_result_is_a_copy():
    """A second solve on another problem of the same shapes overwrites the
    program's buffers, not the first solve's BaResult."""
    first = ba.bundle_adjust(CAM, _ba_problem(seed=2), iters=2)
    kept = _clone(first)
    _owns_nothing(first)
    second = ba.bundle_adjust(CAM, _ba_problem(seed=5), iters=2)
    _bit_equal(tree_leaves(first), kept)
    assert not torch.equal(first.points, second.points)


# --------------------------------------------------------------------------
# The out-and-back scene: tracks, loop mining, keyframe search
# --------------------------------------------------------------------------

def _scene(seed: int = 0):
    """(Features [N_FRAMES, KF, ...], t [N_FRAMES, 3], q [N_FRAMES, 4]):
    frames 3 cm apart out along x and back, each seeing KF of N_POINTS
    points in its own random order, with noisy descriptors and points."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    points = f32(np.stack([rng.uniform(-1.0, 1.3, N_POINTS),
                           rng.uniform(-0.7, 0.7, N_POINTS),
                           rng.uniform(2.0, 3.5, N_POINTS)], -1))
    desc = rng.normal(size=(N_POINTS, D))
    i = np.arange(N_FRAMES)
    t = f32(np.stack([0.03 * np.minimum(i, N_FRAMES - 1 - i),
                      0.01 * np.sin(i), 0 * i], -1))
    q = v2q(f32(np.stack([0 * i, 0.02 * np.sin(i / 2), 0 * i], -1)))
    p_cam = qrotate(qconj(q)[:, None], points[None] - t[:, None])
    uv, xyz, fdesc = [], [], []
    for fr in range(N_FRAMES):
        pick = rng.permutation(N_POINTS)[:KF]
        uv.append(project(CAM, p_cam[fr, pick]))
        xyz.append(p_cam[fr, pick] + f32(rng.normal(scale=1e-3,
                                                    size=(KF, 3))))
        fdesc.append(f32(desc[pick] + rng.normal(scale=0.02, size=(KF, D))))
    valid = torch.ones((N_FRAMES, KF), dtype=torch.bool)
    valid[1, -3:] = False
    feats = Features(uv=torch.stack(uv), desc=torch.stack(fdesc),
                     xyz=torch.stack(xyz), valid=valid,
                     score=f32(rng.uniform(0.1, 1.0, (N_FRAMES, KF))))
    return feats, t, q


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _cut(feats, n):
    return Features(*(x[:n] for x in feats))


def _tracks_loop(feats, t, q, valid, max_tracks=48, adds=16):
    """build_tracks as a plain loop of ``track_step``."""
    l = max_tracks
    table = tracks.TrackTable(torch.zeros((l, D)),
                              torch.zeros(l, dtype=torch.bool),
                              torch.zeros((l, 3)))
    rows = []
    for i in range(feats.uv.shape[0]):
        table, obs = tracks.track_step(
            table, Features(*(x[i] for x in feats)), t[i], q[i], valid[i],
            adds, 1.3, 25.0)
        rows.append(obs)
    return (*map(torch.stack, zip(*rows)), table)


def test_build_tracks_program_equals_loop(scene):
    """build_tracks (the table carried in one row, each keyframe staged
    into the input row, its observations copied out) against the plain
    loop of track_step over 6 keyframes, one of them invalid: the
    observations, masks and final table bit for bit; tracks spawned and
    re-observed."""
    feats, t, q = scene
    valid = torch.tensor([True] * 4 + [False, True])
    f6 = _cut(feats, 6)
    got = tracks.build_tracks(f6, t[:6], q[:6], valid, max_tracks=48,
                              adds_per_frame=16)
    _bit_equal(got, _tracks_loop(f6, t[:6], q[:6], valid))
    assert int(got[3].active.sum()) > 0 and int(got[2].sum(0).max()) >= 3
    _owns_nothing(got)


def test_build_tracks_one_program_serves_every_count(scene):
    """6, 4 and 2 keyframes replay one program (keyed by one keyframe's
    shapes), each equal to its loop; another table size keys a second.
    A later call leaves the earlier call's tensors unchanged."""
    feats, t, q = scene
    valid = torch.ones(N_FRAMES, dtype=torch.bool)
    graphs.clear()
    outs = []
    for m in (6, 4, 2):
        got = tracks.build_tracks(_cut(feats, m), t[:m], q[:m], valid[:m],
                                  max_tracks=48, adds_per_frame=16)
        _bit_equal(got, _tracks_loop(_cut(feats, m), t[:m], q[:m],
                                     valid[:m]))
        outs.append((got, _clone(got)))
        assert len(graphs.programs()) == 1
    for got, kept in outs:
        _bit_equal(tree_leaves(got), kept)
    tracks.build_tracks(_cut(feats, 2), t[:2], q[:2], valid[:2],
                        max_tracks=64, adds_per_frame=16)
    assert [p.name for p in graphs.programs()] == ["build_tracks"] * 2


def _draws(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.gumbel(size=(n, BATCH, KF)).astype(np.float32))


# The mining's keyframe estimate: a zigzag that revisits x = 0 and 0.3 m
# (3 candidate pairs over 8 keyframes, 2 over 6); the scene's frames all
# see one set of points, so every pair's fit has support.
MINE_T = torch.tensor(np.stack([0.3 * (np.arange(N_FRAMES) % 2),
                                0.01 * np.arange(N_FRAMES),
                                np.zeros(N_FRAMES)], -1), dtype=torch.float32)


def _pairs(m: int):
    return loop_detect.pairs_to_try(MINE_T[:m],
                                    torch.ones(m, dtype=torch.bool),
                                    min_gap=2, max_dist=0.5)


def _mine(feats, m, **kw):
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).expand(m, 4)
    return loop_detect.mine_keyframe_loop_closures(
        _cut(feats, m), MINE_T[:m], q, torch.ones(m, dtype=torch.bool),
        min_gap=2, max_dist=0.5, batch=BATCH, **kw)


def _mine_loop(feats, m, max_pairs=16, gumbel=None, generator=None):
    """The mining as a plain loop of ``pair_fit`` over pairs_to_try."""
    side = lambda i: (feats.desc[i], feats.xyz[i], feats.valid[i])  # noqa
    rows = []
    for n, (a, b) in enumerate(_pairs(m)):
        if len(rows) >= max_pairs:
            break
        _r, tt, qq, ok, _n, _e, cov = loop_detect.pair_fit(
            side(a), side(b), None if gumbel is None else gumbel[n],
            generator, batch=BATCH)
        if bool(ok):
            rows.append((a, b, tt.numpy(), qq.numpy(),
                         loop_detect.sqrt_information(cov.numpy())))
    if not rows:
        return None
    a, b, tt, qq, info = zip(*rows)
    return (np.asarray(a, np.int32), np.asarray(b, np.int32), np.stack(tt),
            np.stack(qq), np.ones(len(a), np.float32), np.stack(info))


@pytest.mark.parametrize("mode", ["gumbel", "generator"])
def test_mining_program_equals_loop(scene, mode):
    """The mining (each candidate pair staged into the pair program's
    input row with its draws, or drawing from the program's generator;
    the output row read back once) against the plain loop of pair_fit:
    the same factors, bit for bit, with the budget cutting the pairs and
    without."""
    feats, _, _ = scene
    n = len(_pairs(N_FRAMES))
    kw = lambda: (dict(gumbel=_draws(n, 4)) if mode == "gumbel"  # noqa
                  else dict(generator=torch.Generator().manual_seed(4)))
    for max_pairs in (16, 1):
        got = _mine(feats, N_FRAMES, max_pairs=max_pairs, **kw())
        ref = _mine_loop(feats, N_FRAMES, max_pairs=max_pairs, **kw())
        assert got is not None and len(got[0]) == min(n, max_pairs)
        _bit_equal(got, ref)


def test_mining_one_program_serves_every_pair_count(scene):
    """Mining over all 8 keyframes and over the first 6 (fewer candidate
    pairs) replays one program; the first call's arrays stay as they
    were."""
    feats, _, _ = scene
    graphs.clear()
    gen = lambda: torch.Generator().manual_seed(6)  # noqa: E731
    first = _mine(feats, N_FRAMES, generator=gen())
    kept = _clone(first)
    assert len(_pairs(N_FRAMES)) > len(_pairs(6)) > 0
    second = _mine(feats, 6, generator=gen())
    _bit_equal(second, _mine_loop(feats, 6, generator=gen()))
    _bit_equal(tree_leaves(first), kept)
    assert [p.name for p in graphs.programs()] == [
        "mine_keyframe_loop_closures"]


def _search_loop(feats, gumbel=None, generator=None):
    """find_keyframes_vo as a plain loop of vo_pair and motion."""
    rot = float(np.radians(keyframes.ROT_THRESH_DEG))
    frame = lambda i: Features(*(x[i] for x in feats))  # noqa: E731
    last, idx, dts, dqs = 0, [0], [np.zeros(3, np.float32)], [
        np.array([1.0, 0, 0, 0], np.float32)]
    for i in range(1, feats.uv.shape[0]):
        s = keyframes.vo_pair(frame(last), frame(i),
                              gumbel=None if gumbel is None else gumbel[i - 1],
                              generator=generator, batch=BATCH, min_inliers=8)
        ang, dist = keyframes.motion(s.delta.t, s.delta.q)
        if bool(s.ok) and (float(ang) >= rot
                           or float(dist) >= keyframes.TRANS_THRESH_M):
            idx.append(i)
            dts.append(s.delta.t.numpy())
            dqs.append(s.delta.q.numpy())
            last = i
    return keyframes.OfflineKeyframes(np.asarray(idx, np.int64),
                                      np.stack(dts), np.stack(dqs),
                                      feats.uv.shape[0] - 1)


@pytest.mark.parametrize("mode", ["gumbel", "generator"])
def test_keyframe_search_program_equals_loop(scene, mode):
    """The 8-frame keyframe search (the last keyframe and the candidate
    copied into the pair program's buffers, its output row read back
    once per pair) against the plain loop of vo_pair: the same keyframes
    and increments, bit for bit; some candidates skipped."""
    feats, _, _ = scene
    kw = lambda: (dict(gumbel=_draws(N_FRAMES - 1, 7)) if mode == "gumbel"  # noqa
                  else dict(generator=torch.Generator().manual_seed(7)))
    got = keyframes.find_keyframes_vo(feats, batch=BATCH, **kw())
    ref = _search_loop(feats, **kw())
    _bit_equal(tuple(got[:3]), tuple(ref[:3]))
    assert got.n_vo_calls == ref.n_vo_calls == N_FRAMES - 1
    assert 2 <= len(got.indices) < N_FRAMES


def test_keyframe_search_copies_and_one_program(scene, tmp_path):
    """A cold search through a VoCache, then searches over fewer frames
    and a warm one: one program for every length; the cache entries and
    the first OfflineKeyframes stay as they were; the warm pass equals
    the cold one."""
    feats, _, _ = scene
    gen = lambda: torch.Generator().manual_seed(8)  # noqa: E731
    graphs.clear()
    cold = keyframes.find_keyframes_vo(
        feats, vo_cache=VoCache(str(tmp_path), device="cpu"), batch=BATCH,
        generator=gen())
    kept = _clone(tuple(cold[:3]))
    vo_dir = tmp_path / "RANSAC_pose_shift"
    files = {n: (vo_dir / n).read_bytes() for n in sorted(os.listdir(vo_dir))}
    assert len(files) == N_FRAMES - 1
    short = keyframes.find_keyframes_vo(_cut(feats, 5), batch=BATCH,
                                        generator=gen())
    _bit_equal(tuple(short[:3]), tuple(_search_loop(_cut(feats, 5),
                                                    generator=gen())[:3]))
    assert [p.name for p in graphs.programs()] == ["find_keyframes_vo"]
    _bit_equal(tree_leaves(tuple(cold[:3])), kept)
    assert files == {n: (vo_dir / n).read_bytes()
                     for n in sorted(os.listdir(vo_dir))}
    warm = keyframes.find_keyframes_vo(
        feats, vo_cache=VoCache(str(tmp_path), device="cpu"), batch=BATCH,
        generator=gen())
    _bit_equal(tuple(warm[:3]), tuple(cold[:3]))
