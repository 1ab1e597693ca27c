"""The multi-device modules, port vs JAX reference: the process mesh,
hypothesis-sharded RANSAC and landmark-sharded BA, run by spawned CPU
ranks over gloo at world sizes 2 and 4 against the reference's shard_map
programs on meshes of the same size (8 virtual CPU devices), and in this
process at world size 1; the hybrid 2×2 mesh of tests/mp_worker.py.
The pose-sharded BA is tests/test_torch_parallel_pose.py's.

Each world size spawns its ranks once (``parallel/dryrun.run`` with a
list of cases), every rank runs every case, and the tests read the
ranks' outputs; ``dryrun.run`` fails if two ranks' outputs of a case
differ in a single bit. The reference's draws are reproduced from its
keys and injected.

The reference's sharded programs compile for ~10 s each on the CPU, so
the cases that add a factor kind to a problem the reference covers
(padding, loop-closure pose factors) are held to the single-device
optimizers of both packages instead.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.backend.ba import bundle_adjust as jbundle_adjust
from pre3_tpu.geometry.quaternion import qconj, qprod, qrotate
from pre3_tpu.parallel.ba_sharded import bundle_adjust_sharded as jba_sharded
from pre3_tpu.parallel.mesh import make_mesh as jmake_mesh
from pre3_tpu.parallel.vo_sharded import sharded_ransac_rigid as jsharded
from pre3_tpu_torch.backend.ba import BaProblem, bundle_adjust
from pre3_tpu_torch.geometry.camera import sr4000_camera
from pre3_tpu_torch.parallel import dryrun
from pre3_tpu_torch.parallel.ba_sharded import bundle_adjust_sharded
from pre3_tpu_torch.parallel.mesh import make_mesh
from pre3_tpu_torch.parallel.vo_sharded import sharded_ransac_rigid
from pre3_tpu_torch.utils.interop import to_torch
from pre3_tpu_torch.vo.ransac import ransac_rigid
from tests import test_distributed
from tests.test_ba import CAM as JCAM
from tests.test_ba import make_ba_problem
from tests.test_vo import make_rigid_problem
from torch_reference import reference

CAM = sr4000_camera()
RANSAC_BATCH = 512
# RANSAC: the same samples and winner as the reference; R and t from the
# same closed-form refit in another reduction order.
POSE_ATOL = 1e-5
# Sharded BA vs the reference's at the same mesh size: the same LM
# decisions; the states in f32 summed in another order (the port's
# bundle_adjust holds the reference's to 1e-4, tests/test_torch_backend).
BA_ATOL = 1e-4
# The cost history: the first step's cost (a 4-decade drop in one step,
# solved in f32 at cond ~1e8) agrees to 2e-4 relative; the converged tail
# is f32 noise (~1e-11).
COST_RTOL, COST_ATOL = 1e-3, 1e-9
# With this gate the tied hypotheses of _tie_problem have different
# inlier sets, so the winner shows.
TIE_THRESHOLD = 1e-6


@functools.cache
def corridor(**kw):
    """tests/test_distributed.py's corridor: (problem, gt kf_t)."""
    prob, gt = test_distributed.TestPoseShardedBa()._corridor_problem(**kw)
    return prob, np.asarray(gt)


def with_lcp(prob, gt_t, i=2, j=13):
    """A loop-closure factor between keyframes i and j with the
    ground-truth relative pose (the reference test's)."""
    rel_t = qrotate(qconj(prob.kf_q[i]), gt_t[j] - gt_t[i])
    rel_q = qprod(qconj(prob.kf_q[i]), prob.kf_q[j])
    return prob._replace(
        lcp_i=jnp.asarray([i], jnp.int32), lcp_j=jnp.asarray([j], jnp.int32),
        lcp_t=rel_t[None], lcp_q=rel_q[None], lcp_w=jnp.ones(1, jnp.float32))


def with_odo(prob, gt_t, gt_q, odo_w):
    n = len(odo_w)
    odo_t = jnp.stack([qrotate(qconj(gt_q[i]), gt_t[i + 1] - gt_t[i])
                       for i in range(n)])
    odo_q = jnp.stack([qprod(qconj(gt_q[i]), gt_q[i + 1]) for i in range(n)])
    return prob._replace(odo_t=odo_t, odo_q=odo_q, odo_w=jnp.asarray(odo_w))


def port(prob) -> dict:
    """A reference BaProblem as the port's, a dict of CPU tensors."""
    return to_torch(jax.tree.map(np.asarray, prob), device="cpu")._asdict()


def f64(prob: dict) -> dict:
    return {k: v.double() if v is not None and v.is_floating_point() else v
            for k, v in prob.items()}


def spawn(n, cases):
    return dryrun.run(n, backend="gloo", device="cpu", cases=cases,
                      stages=False, timeout=600)


def out(results, name, rank=0):
    return {k: v.numpy() for k, v in results[rank]["outputs"][name].items()}


def check_states(got, ref, atol=BA_ATOL):
    np.testing.assert_allclose(got["cost"], ref.cost, rtol=COST_RTOL,
                               atol=COST_ATOL)
    for f in ("kf_t", "kf_q", "points"):
        np.testing.assert_allclose(got[f], getattr(ref, f), atol=atol,
                                   err_msg=f)


def check_ranks_agree(results):
    """Every replicated output of every case equal to the bit on every
    rank, and every case ran its collectives over gloo."""
    for name, res in results[0]["outputs"].items():
        for r in results[1:]:
            other = r["outputs"][name]
            if res is None or other is None:
                continue
            for k, v in res.items():
                assert torch.equal(v, other[k]), (name, k, r["rank"])
        if res is not None:
            comm = results[0]["records"][name]["comm"]
            assert any(k.endswith("/gloo") for k in comm), (name, comm)


@functools.cache
def _rigid():
    p1, p2, _, _, _ = make_rigid_problem(n=96, noise=0.003, outlier_frac=0.3,
                                         seed=11)
    return np.asarray(p1), np.asarray(p2)


def _tie_problem():
    """Near-collinear points: every 4-point sample is ill-conditioned, so
    hypotheses tie at score -1 across the ranks, while the samples' fits,
    and so the winner's inlier set, differ."""
    rng = np.random.default_rng(5)
    n = 32
    p2 = np.stack([rng.uniform(-1, 1, n), 1e-3 * rng.normal(size=n),
                   1e-3 * rng.normal(size=n)], -1).astype(np.float32)
    p1 = (p2 + [0.1, 0.0, 0.0] + rng.normal(scale=2e-3, size=(n, 3))
          ).astype(np.float32)
    gumbel = rng.gumbel(size=(RANSAC_BATCH, n)).astype(np.float32)
    return p1, p2, gumbel


@functools.cache
def _gumbel():
    return np.asarray(jax.random.gumbel(jax.random.PRNGKey(0),
                                        (RANSAC_BATCH, 96)))


def _ransac_args(p1, p2, gumbel, thr):
    return {"p1": torch.as_tensor(p1), "p2": torch.as_tensor(p2),
            "valid": torch.ones(p1.shape[0], dtype=torch.bool),
            "gumbel": torch.as_tensor(gumbel), "batch": RANSAC_BATCH,
            "support_threshold": thr}


@functools.cache
def _problems():
    """name → reference problem of the landmark-sharded cases."""
    basic, _ = make_ba_problem(n_kf=5, n_lm=48, seed=21, t_noise=0.03,
                               p_noise=0.03)
    pad, _ = make_ba_problem(n_kf=4, n_lm=41, seed=22, t_noise=0.02,
                             p_noise=0.02)
    odo, (gt_t, gt_q, _) = make_ba_problem(n_kf=5, n_lm=48, seed=24,
                                           t_noise=0.03, p_noise=0.03)
    lcp, lcp_gt = corridor(n_kf=16, seed=13)
    return {"ba": basic, "ba_pad": pad,
            "ba_odo": with_odo(odo, gt_t, gt_q, [1.0, 1.0, 0.0, 1.0]),
            "ba_lcp": with_lcp(lcp, lcp_gt)}


def _cases(world):
    p1, p2 = _rigid()
    cases = [{"name": "ransac", "kind": "ransac", "mesh": {"axis": "hyp"},
              "args": _ransac_args(p1, p2, _gumbel(), 1e-3)}]
    t1, t2, tg = _tie_problem()
    cases.append({"name": "ransac_tie", "kind": "ransac",
                  "mesh": {"axis": "hyp"},
                  "args": _ransac_args(t1, t2, tg, TIE_THRESHOLD)})
    for name, prob in _problems().items():
        cases.append({"name": name, "kind": "ba", "mesh": {"axis": "lm"},
                      "args": {"problem": port(prob), "iters": 8}})
    # ba_odo again in f64, where the ranks' sum reorders only f64 rounding
    cases.append({"name": "ba_odo64", "kind": "ba", "mesh": {"axis": "lm"},
                  "args": {"problem": f64(port(_problems()["ba_odo"])),
                           "iters": 8}})
    # the collectives of one LM iteration: 5 iterations less 3
    for iters in (3, 5):
        cases.append({"name": f"ba_iters{iters}", "kind": "ba",
                      "mesh": {"axis": "lm"},
                      "args": {"problem": port(_problems()["ba_odo"]),
                               "iters": iters}})
    if world == 4:
        # tests/mp_worker.py's layout: a 2×2 (hosts × local) mesh, BA over
        # "lm", RANSAC over "hyp"; and a 2-rank submesh of the 4 ranks
        prob, (gt_t, gt_q, _) = make_ba_problem(n_kf=4, n_lm=24, seed=21,
                                                t_noise=0.03, p_noise=0.03)
        cases.append({"name": "hybrid_ba", "kind": "ba",
                      "mesh": {"hybrid": 2},
                      "args": {"problem": port(with_odo(prob, gt_t, gt_q,
                                                        [1.0] * 3)),
                               "iters": 8, "axis": "lm"}})
        cases.append({"name": "hybrid_ransac", "kind": "ransac",
                      "mesh": {"hybrid": 2},
                      "args": {**_ransac_args(p1, p2, _gumbel(), 1e-3),
                               "axis": "hyp"}})
        sub, _ = make_ba_problem(n_kf=4, n_lm=40, seed=23, t_noise=0.02,
                                 p_noise=0.02)
        cases.append({"name": "submesh_ba", "kind": "ba",
                      "mesh": {"axis": "lm", "n": 2},
                      "args": {"problem": port(sub), "iters": 8}})
    return cases


@pytest.fixture(scope="module")
def runs():
    """world size → every rank's result; each world's ranks are spawned
    once and run every case."""
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = spawn(n, _cases(n))
        return cache[n]

    return get


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, runs):
    """(world size, every rank's result)."""
    return request.param, runs(request.param)


@pytest.fixture(scope="module")
def world4(runs):
    return runs(4)


# ---- the mesh ----------------------------------------------------------

def test_make_mesh_raises_on_too_few_ranks():
    """Like the reference, make_mesh never truncates: one process cannot
    make a mesh of two."""
    assert make_mesh(1, device="cpu").size == 1
    with pytest.raises(ValueError, match="only 1 rank"):
        make_mesh(2, device="cpu")


def test_submesh_of_four_ranks(world4):
    """make_mesh(2) in a 4-rank world: ranks 0 and 1 solve, 2 and 3 are
    outside the submesh."""
    assert [r["outputs"]["submesh_ba"] is None for r in world4] == [
        False, False, True, True]
    cost = out(world4, "submesh_ba")["cost"]
    assert cost[-1] < 1e-3 and cost[-1] < cost[0]


def test_hybrid_mesh_two_by_two(world4):
    """tests/mp_worker.py's 2×2 layout: BA over "lm" (2 hosts) against
    the single-device optimizer and the ground truth, as
    tests/test_multiprocess.py holds it; RANSAC over "hyp" (2 local
    ranks) against the reference's on a 2-device mesh."""
    prob, (gt_t, gt_q, _) = make_ba_problem(n_kf=4, n_lm=24, seed=21,
                                            t_noise=0.03, p_noise=0.03)
    prob = BaProblem(**port(with_odo(prob, gt_t, gt_q, [1.0] * 3)))
    single = bundle_adjust(CAM, prob, iters=8)
    got = out(world4, "hybrid_ba")
    assert got["cost"][-1] < 1e-3
    np.testing.assert_allclose(got["kf_t"], single.kf_t, atol=BA_ATOL)
    np.testing.assert_allclose(got["kf_t"], np.asarray(gt_t), atol=5e-3)
    rr, jr = out(world4, "hybrid_ransac"), _jax_ransac(2)
    np.testing.assert_array_equal(rr["inliers"], jr.inliers)
    np.testing.assert_allclose(rr["t"], jr.t, atol=POSE_ATOL)


# ---- hypothesis-sharded RANSAC -------------------------------------------

def _sharded_ransac(n):
    """The reference's hypothesis-sharded RANSAC on a mesh of n."""
    p1, p2 = _rigid()
    m = jmake_mesh(n, axis="hyp")
    with jax.set_mesh(m):
        return jax.jit(lambda k: jsharded(
            m, k, jnp.asarray(p1), jnp.asarray(p2), jnp.ones(96, bool),
            batch=RANSAC_BATCH, support_threshold=1e-3))(jax.random.PRNGKey(0))


def _jax_ransac(n):
    return reference(_sharded_ransac, n)


def test_sharded_ransac_matches_jax(world):
    """Same samples, winner and inlier set as the reference's sharded
    RANSAC at the same mesh size; R and t within 1e-5."""
    n, results = world
    got, ref = out(results, "ransac"), _jax_ransac(n)
    assert bool(got["ok"]) and bool(ref.ok)
    np.testing.assert_array_equal(got["inliers"], ref.inliers)
    assert int(got["n_inliers"]) == int(ref.n_inliers)
    assert int(got["best_support"]) == int(ref.best_support)
    np.testing.assert_allclose(got["r"], ref.r, atol=POSE_ATOL)
    np.testing.assert_allclose(got["t"], ref.t, atol=POSE_ATOL)


def _ransac_world1(p1, p2, gumbel, thr):
    return ransac_rigid(torch.as_tensor(p1), torch.as_tensor(p2),
                        torch.ones(p1.shape[0], dtype=torch.bool),
                        batch=RANSAC_BATCH, support_threshold=thr,
                        gumbel=torch.as_tensor(gumbel))


def test_sharded_ransac_world1_is_ransac_rigid():
    """At one rank the sharded RANSAC is ransac_rigid to the bit."""
    p1, p2 = _rigid()
    args = _ransac_args(p1, p2, _gumbel(), 1e-3)
    got = sharded_ransac_rigid(make_mesh(1, device="cpu"), args.pop("p1"),
                               args.pop("p2"), args.pop("valid"), **args)
    ref = _ransac_world1(p1, p2, _gumbel(), 1e-3)
    for name in ref._fields:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_sharded_ransac_tie_picks_lowest_index(world):
    """Hypotheses tie across ranks: the winner is the lowest global
    index, as argmax picks it (ransac_rigid's result to the bit);
    another rank's first hypothesis would give another inlier set."""
    n, results = world
    p1, p2, gumbel = _tie_problem()
    ref = _ransac_world1(p1, p2, gumbel, TIE_THRESHOLD)
    shifted = _ransac_world1(p1, p2, np.roll(gumbel, -RANSAC_BATCH // n, 0),
                             TIE_THRESHOLD)
    assert not torch.equal(ref.inliers, shifted.inliers)
    got = out(results, "ransac_tie")
    for name in ref._fields:
        np.testing.assert_array_equal(got[name], getattr(ref, name).numpy(),
                                      err_msg=name)


# ---- landmark-sharded BA ---------------------------------------------------

def _jax_ba(n, name):
    return reference(jba_sharded, jmake_mesh(n, axis="lm"), JCAM,
                     _problems()[name], iters=8)


@pytest.mark.parametrize("name", ["ba", "ba_odo"])
def test_ba_sharded_matches_jax(world, name):
    """kf_t, kf_q, points and the cost history against the reference's
    landmark-sharded BA at the same mesh size (with one odometry factor
    disabled in ba_odo)."""
    n, results = world
    got = out(results, name)
    check_states(got, _jax_ba(n, name))
    assert got["cost"][-1] < 1e-3


@pytest.mark.parametrize("name", ["ba_pad", "ba_lcp"])
def test_ba_sharded_matches_single_device(world, name):
    """41 landmarks (the padding path: 41 divides neither 2 nor 4) and a
    loop-closure pose factor: against the reference's single-device
    bundle_adjust, which its sharded BA equals. On the lcp corridor the
    LM decisions may part where a step's cost equals the current one to
    f32 noise (a plateau at 1.994e-4, left one iteration apart), so that
    case is held to its first step, its converged cost and its kf_t
    within the reference test's landmark-sharded bound, 1e-3 (seen:
    1.3e-4 at two ranks)."""
    n, results = world
    got = out(results, name)
    assert got["points"].shape[0] == _problems()[name].points.shape[0]
    ref = reference(jbundle_adjust, JCAM, _problems()[name], iters=8)
    if name == "ba_pad":
        check_states(got, ref)
    else:
        np.testing.assert_allclose(got["cost"][:2], ref.cost[:2],
                                   rtol=COST_RTOL)
        np.testing.assert_allclose(got["kf_t"], ref.kf_t, atol=1e-3)
        assert got["cost"][-1] < 1e-6 and ref.cost[-1] < 1e-6


def test_ba_sharded_initial_cost(world):
    """cost[0] is the pre-optimisation cost: bundle_adjust's cost[0]."""
    n, results = world
    single = bundle_adjust(CAM, BaProblem(**port(_problems()["ba"])), iters=0)
    got = out(results, "ba")["cost"]
    assert got.shape == (9,)
    np.testing.assert_allclose(got[0], float(single.cost[0]), rtol=1e-5)


def test_ba_sharded_world1():
    """One rank: the system is the single-device one; every LM decision
    and the states agree with bundle_adjust."""
    prob = BaProblem(**port(_problems()["ba_odo"]))
    got = bundle_adjust_sharded(make_mesh(1, axis="lm", device="cpu"), CAM,
                                prob, iters=8)
    ref = bundle_adjust(CAM, prob, iters=8)
    np.testing.assert_allclose(got.cost, ref.cost, rtol=1e-4, atol=COST_ATOL)
    for f in ("kf_t", "kf_q", "points"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   atol=1e-5, err_msg=f)


def test_ba_sharded_f64_matches_single_device(world):
    """In f64 the all-reduce's order moves the states by rounding alone
    (≤ 1.2e-14 here, the cost history ≤ 5e-17), so they agree with
    bundle_adjust in f64 to 1e-10. This holds a fault that stays inside
    the f32 cases' noise: the damping kept on every rank moves this
    case's cost history by 2e-10 (two ranks) and 6e-10 (four)."""
    n, results = world
    got = out(results, "ba_odo64")
    ref = bundle_adjust(CAM, BaProblem(**f64(port(_problems()["ba_odo"]))),
                        iters=8)
    assert got["kf_t"].dtype == np.float64
    np.testing.assert_allclose(got["cost"], ref.cost, rtol=1e-9, atol=1e-15)
    for f in ("kf_t", "kf_q", "points"):
        np.testing.assert_allclose(got[f], getattr(ref, f), rtol=0,
                                   atol=1e-10, err_msg=f)


def per_iteration(results, name, iters=(3, 5)):
    """The collectives one LM iteration adds: {"op/transport": (count,
    bytes)} of the case at iters[1] less the one at iters[0], per
    iteration."""
    a, b = (results[0]["records"][f"{name}{i}"]["comm"] for i in iters)
    n = iters[1] - iters[0]
    return {k: ((v["count"] - a.get(k, {"count": 0})["count"]) / n,
                (v["bytes"] - a.get(k, {"bytes": 0})["bytes"]) / n)
            for k, v in b.items()
            if v != a.get(k)}


def test_ba_sharded_collectives_per_iteration(world):
    """One LM iteration all-reduces [S | rhs] (F·6·F·6 + F·6 floats) and
    the cost pair, over gloo, and nothing else, as the eager solve did
    (the parent's CommLog at these shapes); the solve's other
    collectives (the problem's broadcasts, cost0's all-reduce, the final
    gather) do not grow with iters."""
    n, results = world
    f = _problems()["ba_odo"].mask.shape[0]
    assert per_iteration(results, "ba_iters") == {
        "all_reduce/gloo": (2, 4 * (f * 6 * f * 6 + f * 6 + 2))}
    comm = results[0]["records"]["ba_iters5"]["comm"]
    assert comm["all_reduce/gloo"]["count"] == 1 + 2 * 5
    assert comm["all_gather/gloo"]["count"] == 1


def test_ranks_agree(world):
    check_ranks_agree(world[1])
