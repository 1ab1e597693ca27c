"""The pose-sharded (keyframe-block) BA, port vs JAX reference: spawned
CPU ranks over gloo at world sizes 2 and 4 (at two ranks both ring
neighbours are the same rank) and this process at world size 1 (every
halo permutation a self-permutation), on tests/test_distributed.py's
corridor problems sized to give each world the reference tests' block
layouts.

The reference's pose-sharded program compiles for ~20 s per problem on
the CPU, so it is run at the same mesh size on the global-landmark
problem (every path of the solver: halos, the global group, the
all-gathered poses); the other layouts are held to the single-device
optimizer with the reference test's bounds.
"""

import functools

import numpy as np
import pytest

from pre3_tpu.backend.ba import bundle_adjust as jbundle_adjust
from pre3_tpu.parallel.ba_pose_sharded import (
    bundle_adjust_pose_sharded as jpose_sharded,
)
from pre3_tpu.parallel.mesh import make_mesh as jmake_mesh
from pre3_tpu_torch.backend.ba import BaProblem, bundle_adjust
from pre3_tpu_torch.parallel import dryrun
from pre3_tpu_torch.parallel.ba_pose_sharded import (
    bundle_adjust_pose_sharded,
)
from pre3_tpu_torch.parallel.mesh import make_mesh
from tests.test_ba import CAM as JCAM
from test_torch_parallel import (
    BA_ATOL, CAM, check_ranks_agree, check_states, corridor, out,
    per_iteration, port, spawn, with_lcp,
)
from torch_reference import reference

# The reference test's bounds against the single-device optimizer (CG
# at a fixed trip count): 2e-3 on a window-local corridor, 3e-3 where
# blocks are tiny or padded, 8e-3 (and 5e-3) against the ground truth.
LOCAL_ATOL, LAYOUT_ATOL, GT_ATOL = 2e-3, 3e-3, 8e-3
POSE = dict(iters=8, cg_iters=96, sep=3)
CG_ITERS = 16  # the collective-count cases' trip count


@functools.cache
def _problems(world):
    """name → (problem, gt kf_t, options) at this world size: the
    reference tests' layouts — fb < sep (2 poses per block), a whole
    block of padded poses (4 ranks only: at 2 the last block always owns
    a pose), a partial last block at fb = 4 (at 4 ranks one real pose
    and 3 padded, at 2 ranks three and one)."""
    lcp, lcp_gt = corridor(n_kf=16, seed=13)
    out = {
        "corridor": (*corridor(), POSE),
        "fb_lt_sep": (*corridor(n_kf=2 * world, seed=5), POSE),
        "partial": (*corridor(n_kf=13 if world == 4 else 7, seed=9), POSE),
        "global": (*corridor(n_kf=16, span=6, seed=11),
                   dict(POSE, cg_iters=128)),
        "lcp": (with_lcp(lcp, lcp_gt), lcp_gt, dict(POSE, cg_iters=128)),
    }
    if world == 4:
        out["empty"] = (*corridor(n_kf=5, seed=7), POSE)
    return out


def _cases(world):
    cases = [{"name": name, "kind": "pose_ba", "mesh": {"axis": "blk"},
              "args": {"problem": port(prob), **opts}}
             for name, (prob, _, opts) in _problems(world).items()]
    # the collectives of one LM iteration (5 iterations less 3) on the
    # dry run's problem: global landmarks and a loop-closure factor
    prob, _ = dryrun.make_pose_ba_problem(world, np.random.default_rng(0))
    for iters in (3, 5):
        cases.append({"name": f"pose_iters{iters}", "kind": "pose_ba",
                      "mesh": {"axis": "blk"},
                      "args": {"problem": prob._asdict(), "iters": iters,
                               "cg_iters": CG_ITERS}})
    return cases


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = spawn(n, _cases(n))
        return cache[n]

    return get


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, runs):
    return request.param, runs(request.param)


@pytest.fixture(scope="module")
def world4(runs):
    return runs(4)


_SINGLE: dict = {}


def _single(world, name):
    """The port's single-device bundle_adjust on a case's problem."""
    prob, _, opts = _problems(world)[name]
    key = (name, prob.mask.shape)
    if key not in _SINGLE:
        _SINGLE[key] = bundle_adjust(CAM, BaProblem(**port(prob)),
                                     iters=opts["iters"])
    return _SINGLE[key]


def _check_layout(n, results, name, atol):
    got = out(results, name)
    _, gt, _ = _problems(n)[name]
    assert int(got["dropped_obs"]) == 0
    np.testing.assert_allclose(got["kf_t"], _single(n, name).kf_t, atol=atol)
    np.testing.assert_allclose(got["kf_t"], gt, atol=GT_ATOL)
    return got


def test_window_local_corridor(world):
    """Every landmark local to a block: kf_t within 2e-3 of bundle_adjust
    and 5e-3 of the ground truth, points within 5e-3."""
    n, results = world
    got = _check_layout(n, results, "corridor", LOCAL_ATOL)
    np.testing.assert_allclose(got["kf_t"], _problems(n)["corridor"][1],
                               atol=5e-3)
    np.testing.assert_allclose(got["points"], _single(n, "corridor").points,
                               atol=5e-3)


def test_fb_smaller_than_sep(world):
    """F = 2n: two poses per block, sep clamped 3 → 2, window 6."""
    n, results = world
    got = _check_layout(n, results, "fb_lt_sep", LAYOUT_ATOL)
    assert int(got["fb"]) == 2 and int(got["window"]) == 6


def test_partial_last_block(world):
    """fb = 4 and the last block partly padded."""
    n, results = world
    got = _check_layout(n, results, "partial", LAYOUT_ATOL)
    assert int(got["fb"]) == 4
    assert 0 < 4 * n - _problems(n)["partial"][0].mask.shape[0] < 4


def test_uneven_f_with_empty_blocks(world4):
    """F = 5 on 4 blocks (fb = 2): the last block owns no real pose."""
    got = _check_layout(4, world4, "empty", LAYOUT_ATOL)
    assert int(got["fb"]) == 2


def _jax_pose_sharded(n, prob, opts):
    """The reference's pose-sharded BA on a mesh of n: (state, report)."""
    return jpose_sharded(jmake_mesh(n, axis="blk"), JCAM, prob, **opts)


def test_global_landmarks_match_jax(world):
    """Observation spans of 13 keyframes, wider than any window: the
    global factor group over the all-gathered poses. kf_t, kf_q, points,
    the cost history and the report against the reference's pose-sharded
    BA at the same mesh size; and bundle_adjust's bounds."""
    n, results = world
    prob, gt, opts = _problems(n)["global"]
    ref, report = reference(_jax_pose_sharded, n, prob, opts)
    got = out(results, "global")
    for k, v in report.items():
        assert int(got[k]) == v, k
    assert report["global_lm"] > 0 and report["global_obs"] > 0
    check_states(got, ref, atol=BA_ATOL)
    single = _single(n, "global")
    np.testing.assert_allclose(got["kf_t"], single.kf_t, atol=LAYOUT_ATOL)
    np.testing.assert_allclose(got["points"], single.points, atol=5e-3)
    np.testing.assert_allclose(got["kf_t"], gt, atol=GT_ATOL)


def test_lcp_pose_factors_all_three_paths(world):
    """The loop-closure pose factor through the pose-sharded path, the
    reference's single-device bundle_adjust and the port's: cost[0]
    equal, kf_t within the reference test's bound."""
    n, results = world
    prob, _, _ = _problems(n)["lcp"]
    ref = reference(jbundle_adjust, JCAM, prob, iters=8)
    single = _single(n, "lcp")
    got = out(results, "lcp")
    np.testing.assert_allclose(single.kf_t, ref.kf_t, atol=BA_ATOL)
    np.testing.assert_allclose(got["kf_t"], ref.kf_t, atol=LAYOUT_ATOL)
    np.testing.assert_allclose(got["cost"][0], ref.cost[0], rtol=1e-4)


def test_cost_history_includes_initial_cost(world):
    """cost[0] is the pre-optimisation cost; len == iters + 1."""
    n, results = world
    got = out(results, "corridor")["cost"]
    assert got.shape == (POSE["iters"] + 1,)
    np.testing.assert_allclose(got[0], float(_single(n, "corridor").cost[0]),
                               rtol=1e-4)
    assert got[-1] < got[0]


def test_world1_self_permutation():
    """One rank: every halo permutation is a local copy and the ring's
    wraparound is masked by win_valid; the global group is empty (one
    window covers every keyframe) and the loop-closure factor still
    rides the gathered poses."""
    prob, gt = corridor(n_kf=16, seed=13)
    prob = BaProblem(**port(with_lcp(prob, gt)))
    mesh = make_mesh(1, axis="blk", device="cpu")
    got, report = bundle_adjust_pose_sharded(mesh, CAM, prob, iters=8,
                                             cg_iters=128, sep=3)
    single = bundle_adjust(CAM, prob, iters=8)
    assert report["global_lm"] == 0 and report["dropped_obs"] == 0
    np.testing.assert_allclose(got.kf_t, single.kf_t, atol=LOCAL_ATOL)
    np.testing.assert_allclose(got.kf_t, gt, atol=5e-3)
    comm = mesh.comm.take()
    assert comm["ppermute/local"]["count"] > 0
    assert comm["all_gather/local"]["count"] > 0


def test_collectives_per_iteration(world):
    """One LM iteration's collectives, as the eager solve issued them
    (the parent's CommLog at these shapes), over gloo: ``ppermute`` slabs
    of sep poses for the halo exchanges of t and q, the halo reduces of
    the rhs and the Jacobi blocks, 2 per CG iteration each way, the
    back-substitution's exchange and the trial cost's t and q; a scalar
    all-reduce per dot product (2 per CG iteration) and the PCG's first,
    and the cost's pair; an all-gather of the poses (t, q, each CG iteration's p,
    the solution, the trial t and q)."""
    n, results = world
    rep = out(results, "pose_iters5")
    fb, sep = int(rep["fb"]), (int(rep["window"]) - int(rep["fb"])) // 2
    assert int(rep["global_lm"]) > 0
    slabs = 2 * sep * 4 * (3 + 4 + 6 + 36 + 2 * 6 * CG_ITERS + 6 + 3 + 4)
    gathers = fb * 4 * (3 + 4 + 6 * CG_ITERS + 6 + 3 + 4)
    assert per_iteration(results, "pose_iters") == {
        "ppermute/gloo": (4 + 4 + 4 * CG_ITERS + 2 + 4, slabs),
        "all_reduce/gloo": (2 + 2 * CG_ITERS, 4 * (1 + 2 * CG_ITERS + 2)),
        "all_gather/gloo": (2 + CG_ITERS + 1 + 2, gathers)}


def test_ranks_agree(world):
    check_ranks_agree(world[1])
