"""The standalone frontends' and the sharded BAs' step programs on the
CPU, where each runs eagerly on the program's buffers.

``extract_features`` and ``extract_features_sift`` run their frames in
chunks of ``sift.FRAME_CHUNK``, one program per chunk's frame count: the
chunked result is one batch of the plain body's, no result aliases a
program buffer, and SIFT's fast-math branch is a variant of the same
program. A program run inside another's capture raises. Both sharded
BAs serve every ``iters`` from one program. The bodies' parity with the
JAX reference is ``tests/test_torch_{frontend,sift,parallel,
parallel_pose}.py``'s; this file compiles nothing of JAX.
"""

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from pre3_tpu_torch.data.synthetic import render_sequence
from pre3_tpu_torch.frontend import pipeline, sift
from pre3_tpu_torch.parallel import dryrun
from pre3_tpu_torch.parallel.ba_pose_sharded import (
    bundle_adjust_pose_sharded,
)
from pre3_tpu_torch.parallel.ba_sharded import bundle_adjust_sharded
from pre3_tpu_torch.parallel.mesh import make_mesh
from pre3_tpu_torch.runtime.online import OnlineSlam
from pre3_tpu_torch.utils import graphs

N_FRAMES, CHUNK = 10, 4
FAST = dict(threshold=0.05, max_features=64)
SIFT = dict(keypoints_per_octave=32)
FRONTENDS = {
    "extract_features": (pipeline.extract_features, pipeline.fast_features,
                         FAST),
    "extract_features_sift": (pipeline.extract_features_sift,
                              pipeline.sift_features, SIFT),
}


@pytest.fixture(scope="module")
def frames():
    """Two windows of a rendered corridor, [F, H, W] ... each."""
    fr, _, _ = render_sequence(n_frames=2 * N_FRAMES, n_points=300,
                               noise=0.004)
    stack = [torch.as_tensor(np.stack([getattr(f, a) for f in fr]))
             for a in ("intensity", "xyz", "confidence")]
    return [x[:N_FRAMES] for x in stack], [x[N_FRAMES:] for x in stack]


@pytest.fixture
def chunk4(monkeypatch):
    monkeypatch.setattr(sift, "FRAME_CHUNK", CHUNK)
    graphs.clear()
    yield
    graphs.clear()


def _programs(name):
    return [p for p in graphs.programs() if p.name == name]


def _buffers():
    return {t.untyped_storage().data_ptr() for p in graphs.programs()
            for t in tree_leaves(p.buffers) if t is not None}


# SIFT's descriptor band filter is a batched torch.matmul over the
# chunk's frames, which the CPU blocks by batch size: a descriptor
# summed in another order moves by up to ~2e-8 (1.9e-8 at chunks of 4
# here; chunks of 2 and 5 are bit-equal). The keypoints do not move.
SIFT_DESC_ATOL = 1e-6


@pytest.mark.parametrize("name", list(FRONTENDS))
def test_chunks_equal_one_batch_of_the_body(frames, chunk4, name,
                                            monkeypatch):
    """F = 10 in chunks of 4: programs at 4 and 2 frames, whose results
    equal one call of the plain body over all 10 frames (no op mixes
    frames): to the bit, SIFT's descriptors within SIFT_DESC_ATOL."""
    monkeypatch.setenv("PRE3_SIFT_FAST_MATH", "0")
    entry, body, kw = FRONTENDS[name]
    first, _ = frames
    got = entry(*first, **kw)
    progs = _programs(name)
    assert sorted(p.buffers["inp"][0].shape[0] for p in progs) == [2, 4]
    ref = body(*first, **kw)
    for f in pipeline.Features._fields:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.shape[0] == N_FRAMES and a.dtype == b.dtype
        if name == "extract_features_sift" and f == "desc":
            torch.testing.assert_close(a, b, rtol=0, atol=SIFT_DESC_ATOL)
        else:
            assert torch.equal(a, b), f


@pytest.mark.parametrize("name", list(FRONTENDS))
def test_results_do_not_alias_the_programs(frames, chunk4, name):
    """A second call with other frames leaves the first call's features
    as they were: each call's features are its own storage."""
    entry, _, kw = FRONTENDS[name]
    first, second = frames
    got = entry(*first, **kw)
    kept = [x.clone() for x in got]
    assert not {x.untyped_storage().data_ptr() for x in got} & _buffers()
    other = entry(*second, **kw)
    assert len(_programs(name)) == 2
    assert not all(torch.equal(a, b) for a, b in zip(other, kept))
    for a, b in zip(got, kept):
        assert torch.equal(a, b)


def test_fast_math_is_a_variant_of_one_program(frames, monkeypatch):
    """PRE3_SIFT_FAST_MATH, read once per call, picks a variant of the
    chunk's program, not another program; each call equals the body of
    its branch."""
    graphs.clear()
    part = [x[:2] for x in frames[0]]
    out = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("PRE3_SIFT_FAST_MATH", flag)
        out[flag] = pipeline.extract_features_sift(*part, **SIFT)
        assert len(_programs("extract_features_sift")) == 1
        ref = pipeline.sift_features(*part, **SIFT, fast=flag == "1")
        for a, b in zip(out[flag], ref):
            assert torch.equal(a, b)
    assert not torch.equal(out["0"].desc, out["1"].desc)
    graphs.clear()


def test_program_run_inside_a_capture_raises(monkeypatch):
    """A program entered while the current stream captures another
    program raises, naming both, and runs nothing: a captured body must
    call the plain function (OnlineSlam's frame body calls the
    frontend's). Looking a program up raises there too, before its
    buffers are made."""
    ran = []
    inner = graphs.StepProgram("extract_features_sift", {}, "cuda")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(graphs, "_CAPTURING", ["OnlineSlam.process"])
    with pytest.raises(RuntimeError, match="extract_features_sift.*"
                       "OnlineSlam.process"):
        inner.run(False, lambda b, g: ran.append(1))
    assert not ran and not inner.graphs
    graphs.clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="extract_features.*"
                       "OnlineSlam.process"):
        graphs.program(("extract_features", 1), lambda: ran.append(1))
    assert not ran and not graphs.programs()
    slam = OnlineSlam(None, extractor="sift", device="cpu")
    assert slam._extract_body.func is pipeline.sift_features
    assert slam._extract.func is pipeline.extract_features_sift


@pytest.fixture(scope="module")
def ba_problem():
    prob, (gt_t, gt_q, _) = dryrun.make_ba_problem(
        n_kf=6, n_lm=40, seed=3, t_noise=0.03, p_noise=0.03)
    return dryrun.with_odometry(prob, gt_t, gt_q)


def _landmark(prob, iters):
    return bundle_adjust_sharded(make_mesh(1, axis="lm", device="cpu"),
                                 dryrun.CAM, prob, iters=iters)


def _pose(prob, iters):
    return bundle_adjust_pose_sharded(make_mesh(1, axis="blk", device="cpu"),
                                      dryrun.CAM, prob, iters=iters,
                                      cg_iters=16, sep=1)[0]


@pytest.mark.parametrize("name,solve", [
    ("bundle_adjust_sharded", _landmark),
    ("bundle_adjust_pose_sharded", _pose)])
def test_sharded_ba_iters_share_one_program(ba_problem, name, solve):
    """iters 3 and 5 run one program (the key is never ``iters``); the
    first three iterations are the same bits; a later solve leaves an
    earlier result as it was."""
    graphs.clear()
    short = solve(ba_problem, 3)
    kept = [x.clone() for x in short]
    assert not {x.untyped_storage().data_ptr() for x in short} & _buffers()
    long = solve(ba_problem, 5)
    assert len(_programs(name)) == 1
    assert short.cost.shape == (4,) and long.cost.shape == (6,)
    assert torch.equal(long.cost[:4], short.cost)
    for a, b in zip(short, kept):
        assert torch.equal(a, b)
    assert float(long.cost[-1]) < float(long.cost[0])
    graphs.clear()
