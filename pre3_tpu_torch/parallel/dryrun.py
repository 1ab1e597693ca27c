"""Multi-rank dry run of the engine's parallel paths.

Port of ``__graft_entry__.py::dryrun_multichip`` and of
``tests/mp_worker.py``: N ranks, spawned here, join one process group and
run the reference's five stages on the reference's shapes and seeds:

  1. hypothesis-sharded RANSAC ("hyp" axis, K1 on the card);
  2. landmark-sharded BA with odometry factors ("lm" axis);
  3. pose-sharded BA: keyframe blocks with halo exchange, 3 landmarks
     seen from both ends of the corridor (the global factor group) and
     one loop-closure pose factor ("blk" axis);
  4. the stage pipeline over 9 rendered frames with FAST ("frame" axis);
  5. tests/mp_worker.py's run (landmark BA across the ranks, RANSAC over
     the local axis, the sharded frontend feeding run_slam), and the
     ranks' agreement: every output of every stage equal to the bit on
     every rank.

Besides the stages, ``run`` takes a file of cases (``cases=``): each names
a parallel entry point, its mesh and its inputs, and every rank runs it
and returns its outputs, the collectives it ran and the kernel launches
it made. A record also lists the graphs the case captured (program, variant,
seconds, pool bytes). A case may ask for its step programs' bodies to
run eagerly (``"eager": True``, ``graphs.eager()``: the plain loop the
programs are held to) and for one more run in a profiler window
(``"profile": True`` on the card: host-issued launches, device busy and
wall time, read on rank 0). The
tests and the smoke run the parallel modules this way.

    python3 -m pre3_tpu_torch.parallel.dryrun --world-size 2 --device cpu
    python3 -m pre3_tpu_torch.parallel.dryrun --world-size 1   # NCCL

On one GPU, NCCL runs at world size 1; two ranks share the card with
``--backend gloo``. The parent joins the ranks with a timeout and fails
if any rank exits non-zero.

The problem builders of stage 5 are copies of the test helpers
``tests/test_ba.py::make_ba_problem`` and ``tests/test_vo.py::
make_rigid_problem`` (pinned equal by ``tests/test_torch_dryrun.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import socket
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pre3_tpu_torch.backend.ba import BaProblem
from pre3_tpu_torch.data.synthetic import _rodrigues, render_sequence
from pre3_tpu_torch.ekf.slam import SlamConfig, SlamDraws, StepDraws, run_slam
from pre3_tpu_torch.geometry.camera import project, sr4000_camera
from pre3_tpu_torch.geometry.quaternion import qconj, qprod, qrotate, r2q
from pre3_tpu_torch.ops.matching import match_descriptors_k2
from pre3_tpu_torch.ops.ransac_score import score_hypotheses
from pre3_tpu_torch.parallel.ba_pose_sharded import bundle_adjust_pose_sharded
from pre3_tpu_torch.parallel.ba_sharded import bundle_adjust_sharded
from pre3_tpu_torch.parallel.distributed import (
    global_landmark_mesh, globalize_replicated, hybrid_mesh,
    initialize_distributed,
)
from pre3_tpu_torch.parallel.mesh import CommLog, make_mesh
from pre3_tpu_torch.parallel.vo_sharded import sharded_ransac_rigid
from pre3_tpu_torch.runtime.stage_pipeline import (
    run_slam_pipelined, sharded_extract,
)
from pre3_tpu_torch.utils import graphs

CAM = sr4000_camera()
FAST = {"threshold": 0.05, "max_features": 96}


# ---- problem builders (copies of the test helpers) -------------------

def _project(p_cam: np.ndarray) -> np.ndarray:
    return project(CAM, torch.as_tensor(p_cam)).numpy()


def make_ba_problem(n_kf=6, n_lm=40, seed=0, t_noise=0.0, p_noise=0.0,
                    px_noise=0.0):
    """(BaProblem of CPU tensors, (gt kf_t, gt kf_q, gt points) numpy)."""
    rng = np.random.default_rng(seed)
    points = np.stack(
        [rng.uniform(-1.5, 1.5, n_lm), rng.uniform(-1.0, 1.0, n_lm),
         rng.uniform(2.0, 4.0, n_lm)], axis=-1
    ).astype(np.float32)
    kf_t = np.zeros((n_kf, 3), np.float32)
    kf_r = np.zeros((n_kf, 3, 3), np.float32)
    for i in range(n_kf):
        kf_t[i] = [0.08 * i, 0.02 * np.sin(i), 0.0]
        kf_r[i] = _rodrigues(np.array([0.0, 0.01 * i, 0.005 * i]))
    kf_q = np.stack([r2q(torch.as_tensor(r)).numpy() for r in kf_r])

    obs = np.zeros((n_kf, n_lm, 2), np.float32)
    obs_xyz = np.zeros((n_kf, n_lm, 3), np.float32)
    mask = np.zeros((n_kf, n_lm), bool)
    for f in range(n_kf):
        p_cam = (points - kf_t[f]) @ kf_r[f]  # R_wcᵀ(p−t) = (p−t)·R
        uv = _project(p_cam)
        ok = (
            (p_cam[:, 2] > 0.5)
            & (uv[:, 0] > 2) & (uv[:, 0] < 173)
            & (uv[:, 1] > 2) & (uv[:, 1] < 141)
        )
        obs[f] = uv + rng.normal(scale=px_noise, size=uv.shape)
        obs_xyz[f] = p_cam
        mask[f] = ok

    gt = (kf_t.copy(), kf_q.copy(), points.copy())
    kf_t_init = kf_t + rng.normal(scale=t_noise, size=kf_t.shape)
    kf_t_init[0] = kf_t[0]  # gauge
    p_init = points + rng.normal(scale=p_noise, size=points.shape)
    prob = BaProblem(
        obs_uv=torch.as_tensor(obs), mask=torch.as_tensor(mask),
        kf_t=torch.as_tensor(kf_t_init.astype(np.float32)),
        kf_q=torch.as_tensor(kf_q),
        points=torch.as_tensor(p_init.astype(np.float32)),
        obs_xyz=torch.as_tensor(obs_xyz), mask_xyz=torch.as_tensor(mask),
    )
    return prob, gt


def with_odometry(prob: BaProblem, gt_t, gt_q, odo_w=None) -> BaProblem:
    """The ground truth's odometry chain as factors (mp_worker's)."""
    gt_t, gt_q = torch.as_tensor(gt_t), torch.as_tensor(gt_q)
    n = gt_t.shape[0] - 1
    odo_t = torch.stack([qrotate(qconj(gt_q[i]), gt_t[i + 1] - gt_t[i])
                         for i in range(n)])
    odo_q = torch.stack([qprod(qconj(gt_q[i]), gt_q[i + 1])
                         for i in range(n)])
    odo_w = torch.ones(n) if odo_w is None else torch.as_tensor(odo_w)
    return prob._replace(odo_t=odo_t, odo_q=odo_q,
                         odo_w=odo_w.to(torch.float32))


def make_rigid_problem(n=50, seed=0, noise=0.0, outlier_frac=0.0):
    """(p1, p2, r, t, outlier indices), numpy."""
    rng = np.random.default_rng(seed)
    q2 = rng.uniform(-1, 1, (n, 3)).astype(np.float32) * 2.0
    a = rng.normal(size=3)
    a = a / np.linalg.norm(a) * rng.uniform(0.1, 1.0)
    r = _rodrigues(a).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32) * 0.5
    p1 = q2 @ r.T + t
    if noise > 0:
        p1 = p1 + rng.normal(scale=noise, size=p1.shape).astype(np.float32)
    n_out = int(outlier_frac * n)
    if n_out:
        out_idx = rng.choice(n, n_out, replace=False)
        p1[out_idx] += rng.uniform(0.5, 2.0, (n_out, 3)).astype(np.float32)
    else:
        out_idx = np.array([], int)
    return p1, q2, r, t, out_idx


# ---- the ranks ---------------------------------------------------------

def _to(x, device):
    """Tensors of a nested dict/list/tuple (NamedTuples kept) on device."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def _cpu(nt) -> dict:
    """A NamedTuple's tensor fields as a dict of CPU tensors."""
    return {k: v.detach().cpu() for k, v in nt._asdict().items()
            if torch.is_tensor(v)}


def _launches() -> tuple[int, int]:
    return score_hypotheses.launches, match_descriptors_k2.launches


def _mesh(spec: dict, device):
    if spec.get("hybrid"):
        return hybrid_mesh(spec["hybrid"], device=device)
    return make_mesh(spec.get("n"), axis=spec["axis"], device=device)


def _slam_draws(d) -> SlamDraws:
    return SlamDraws(steps=StepDraws(**d["steps"]), boot_add=d["boot_add"],
                     plane=d["plane"])


def run_case(mesh, kind: str, args: dict, device) -> dict:
    """One parallel entry point on this rank: its outputs as CPU tensors."""
    a = dict(args)
    if kind == "ransac":
        res = sharded_ransac_rigid(mesh, a.pop("p1"), a.pop("p2"),
                                   a.pop("valid"), **a)
        return _cpu(res)
    if kind == "ba":
        res = bundle_adjust_sharded(mesh, CAM, BaProblem(**a.pop("problem")),
                                    **a)
        return _cpu(res)
    if kind == "pose_ba":
        res, report = bundle_adjust_pose_sharded(
            mesh, CAM, BaProblem(**a.pop("problem")), **a)
        return {**_cpu(res), **{k: torch.tensor(v)
                                for k, v in report.items()}}
    if kind == "extract":
        return _cpu(sharded_extract(mesh, a.pop("intensity"), a.pop("xyz"),
                                    a.pop("conf"), **a))
    if kind == "pipeline":
        cfg = SlamConfig(**a.pop("cfg", {}))
        out = run_slam_pipelined(
            CAM, a.pop("intensity"), a.pop("xyz"), a.pop("conf"), mesh=mesh,
            cfg=cfg, draws=_slam_draws(a.pop("draws")), **a)
        return {"t": out.t.cpu(), "q": out.q.cpu(),
                **{f"stats.{k}": v for k, v in _cpu(out.stats).items()}}
    raise ValueError(f"unknown case kind {kind!r}")


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun {msg}")


def _stage_ransac(n, rng, device, comm, lines):
    mesh = make_mesh(n, axis="hyp", device=device)
    mesh.comm = comm
    m = 64
    p2 = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    t_true = np.array([0.05, -0.02, 0.01], np.float32)
    p1 = p2 + t_true
    batch = max(8 * n, 64)
    fitted = sharded_ransac_rigid(
        mesh, torch.as_tensor(p1, device=device),
        torch.as_tensor(p2, device=device),
        torch.ones(m, dtype=torch.bool, device=device), batch=batch,
        support_threshold=1e-4,
        generator=torch.Generator(device=device).manual_seed(0))
    np.testing.assert_allclose(fitted.t.cpu().numpy(), t_true, atol=1e-3)
    _check(bool(fitted.ok), "sharded RANSAC: not ok")
    lines.append(f"dryrun sharded-ransac ok: {n} devices, batch={batch}, "
                 f"n_inliers={int(fitted.n_inliers)}")
    return _cpu(fitted)


def _stage_ba(n, rng, device, comm, lines):
    n_kf, n_lm = 4, max(2 * n, 16)
    points = np.stack(
        [rng.uniform(-1, 1, n_lm), rng.uniform(-0.7, 0.7, n_lm),
         rng.uniform(2.0, 3.5, n_lm)], axis=-1
    ).astype(np.float32)
    kf_t = np.zeros((n_kf, 3), np.float32)
    kf_t[:, 0] = 0.05 * np.arange(n_kf)
    kf_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n_kf, 1))
    obs = np.zeros((n_kf, n_lm, 2), np.float32)
    obs_xyz = np.zeros((n_kf, n_lm, 3), np.float32)
    for f in range(n_kf):
        p_cam = points - kf_t[f]
        obs[f] = _project(p_cam)
        obs_xyz[f] = p_cam
    mask = np.ones((n_kf, n_lm), bool)
    kf_t_init = kf_t + rng.normal(scale=0.02, size=kf_t.shape).astype(
        np.float32)
    kf_t_init[0] = kf_t[0]
    t = torch.as_tensor
    prob = BaProblem(
        obs_uv=t(obs), mask=t(mask), kf_t=t(kf_t_init), kf_q=t(kf_q),
        points=t(points + rng.normal(scale=0.02, size=points.shape).astype(
            np.float32)),
        obs_xyz=t(obs_xyz), mask_xyz=t(mask),
        odo_t=t(kf_t[1:] - kf_t[:-1]), odo_q=t(kf_q[1:]),
        odo_w=torch.ones(n_kf - 1))
    mesh = make_mesh(n, axis="lm", device=device)
    mesh.comm = comm
    res = bundle_adjust_sharded(mesh, CAM, _to(prob, device), iters=5)
    cost = res.cost.cpu().numpy()
    _check(cost[-1] < 1e-2, f"sharded BA: final cost {cost[-1]}")
    np.testing.assert_allclose(res.kf_t.cpu().numpy(), kf_t, atol=5e-3)
    lines.append(f"dryrun sharded-ba ok: {n} devices, {n_lm} landmarks, "
                 f"cost {cost[0]:.3f} -> {cost[-1]:.2e}")
    return _cpu(res)


def make_pose_ba_problem(n, rng):
    """(BaProblem of CPU tensors, gt kf_t) of the pose-sharded stage at n
    ranks: a corridor of F = max(2n, 8) keyframes, 3 landmarks seen from
    both ends, one loop-closure pose factor. With fewer keyframes one or
    two block windows cover the whole corridor and the global group is
    empty; at one rank it always is (one block covers every keyframe)."""
    n_kf = max(2 * n, 8)
    kf_t = np.zeros((n_kf, 3), np.float32)
    kf_t[:, 0] = 0.12 * np.arange(n_kf)
    kf_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n_kf, 1))
    pts, obs, oxyz, msk = [], [], [], []

    def observe(pp, frames):
        ruv = np.zeros((n_kf, 2), np.float32)
        rxyz = np.zeros((n_kf, 3), np.float32)
        rm = np.zeros(n_kf, bool)
        for fk in frames:
            pc = pp - kf_t[fk]
            uv = _project(pc)
            if 2 < uv[0] < 173 and 2 < uv[1] < 141:
                ruv[fk], rxyz[fk], rm[fk] = uv, pc, True
        pts.append(pp)
        obs.append(ruv)
        oxyz.append(rxyz)
        msk.append(rm)

    for c in range(n_kf):
        for _ in range(4):
            observe(np.array([kf_t[c, 0] + rng.uniform(-0.4, 0.4),
                              rng.uniform(-0.7, 0.7), rng.uniform(2.0, 3.2)],
                             np.float32),
                    range(max(0, c - 2), min(n_kf, c + 3)))
    # long-baseline landmarks seen from both corridor ends: no block
    # window covers them, so they route to the replicated global group
    span_x = kf_t[-1, 0]
    for _ in range(3):
        observe(np.array([span_x / 2 + rng.uniform(-0.1, 0.1),
                          rng.uniform(-0.3, 0.3), rng.uniform(2.8, 3.4)],
                         np.float32),
                list(range(2)) + list(range(n_kf - 2, n_kf)))
    m2 = np.stack(msk, axis=1)
    keep = m2.sum(0) >= 2
    # one loop-closure pose factor between distant keyframes
    t = torch.as_tensor
    prob = BaProblem(
        obs_uv=t(np.stack(obs, axis=1)[:, keep]), mask=t(m2[:, keep]),
        kf_t=t(kf_t + rng.normal(scale=0.02, size=kf_t.shape).astype(
            np.float32) * (np.arange(n_kf) > 0)[:, None]),
        kf_q=t(kf_q),
        points=t((np.stack(pts)[keep] + rng.normal(
            scale=0.02, size=(int(keep.sum()), 3))).astype(np.float32)),
        obs_xyz=t(np.stack(oxyz, axis=1)[:, keep]), mask_xyz=t(m2[:, keep]),
        odo_t=t(kf_t[1:] - kf_t[:-1]), odo_q=t(kf_q[1:]),
        odo_w=torch.ones(n_kf - 1),
        lcp_i=t(np.array([1], np.int32)),
        lcp_j=t(np.array([n_kf - 2], np.int32)),
        lcp_t=t((kf_t[n_kf - 2] - kf_t[1])[None].astype(np.float32)),
        lcp_q=t(np.array([[1.0, 0, 0, 0]], np.float32)),
        lcp_w=torch.ones(1))
    return prob, kf_t


def _stage_pose_ba(n, rng, device, comm, lines):
    prob, kf_t = make_pose_ba_problem(n, rng)
    n_kf = kf_t.shape[0]
    mesh = make_mesh(n, axis="blk", device=device)
    mesh.comm = comm
    res, rep = bundle_adjust_pose_sharded(mesh, CAM, _to(prob, device),
                                          iters=6, cg_iters=96, sep=3)
    _check(rep["dropped_obs"] == 0, f"pose-sharded BA: {rep}")
    _check((rep["global_lm"] >= 1) if n > 1 else rep["global_lm"] == 0,
           f"pose-sharded BA: {rep}")
    np.testing.assert_allclose(res.kf_t.cpu().numpy(), kf_t, atol=8e-3)
    lines.append(f"dryrun pose-sharded-ba ok: {n} keyframe blocks, F={n_kf}, "
                 f"halo sep=3, dropped_obs=0, global_lm={rep['global_lm']}, "
                 f"lcp_factors=1")
    return _cpu(res)


def _frames(n_frames, n_points, device):
    frames, traj, _ = render_sequence(n_frames=n_frames, n_points=n_points,
                                      noise=0.004)
    stack = [torch.as_tensor(np.stack([getattr(f, a) for f in frames]),
                             device=device)
             for a in ("intensity", "xyz", "confidence")]
    stack[1] = torch.nan_to_num(stack[1])
    return stack, (traj.t - traj.t[0]) @ traj.r[0]


def _stage_pipeline(n, device, comm, lines):
    (intensity, xyz, conf), gt = _frames(9, 250, device)
    mesh = make_mesh(n, axis="frame", device=device)
    mesh.comm = comm
    out = run_slam_pipelined(
        CAM, intensity, xyz, conf, mesh=mesh,
        cfg=SlamConfig(match_ratio=1.3), n_landmarks=24, chunk=n,
        extractor="fast", extractor_kwargs=FAST,
        generator=torch.Generator(device=device).manual_seed(2))
    err = float(np.sqrt(np.mean(np.sum(
        (out.t.cpu().numpy() - gt) ** 2, axis=1))))
    _check(err < 0.1, f"stage pipeline: ATE {err}")
    lines.append(f"dryrun stage-pipeline ok: {n}-way sharded frontend, "
                 f"chunked backend, ate {err:.4f}")
    return {"t": out.t.cpu(), "q": out.q.cpu()}


def _stage_multiprocess(device, comm):
    """tests/mp_worker.py's run over a (ranks × 1) hybrid mesh: the
    landmark all-reduce crosses the ranks, the hypothesis axis is each
    rank's own; the sharded frontend feeds run_slam on every rank."""
    mesh = hybrid_mesh(1, device=device)
    mesh.comm = comm
    prob, (gt_t, gt_q, _) = make_ba_problem(n_kf=4, n_lm=24, seed=21,
                                            t_noise=0.03, p_noise=0.03)
    prob = with_odometry(prob, gt_t, gt_q)
    ba = bundle_adjust_sharded(mesh, CAM, _to(prob, device), iters=8,
                               axis="lm")
    p1, p2, _, _, _ = make_rigid_problem(n=96, noise=0.003,
                                         outlier_frac=0.3, seed=11)
    g = lambda x: globalize_replicated(mesh, x)  # noqa: E731
    res = sharded_ransac_rigid(
        mesh, g(p1), g(p2), g(np.ones(96, bool)), batch=512,
        support_threshold=0.001,
        generator=torch.Generator(device=device).manual_seed(0))
    (intensity, xyz, conf), _ = _frames(8, 250, device)
    fmesh = global_landmark_mesh(axis="frame", device=device)
    fmesh.comm = comm
    feats = sharded_extract(fmesh, intensity, xyz, conf, extractor="fast",
                            extractor_kwargs=FAST)
    traj = run_slam(CAM, feats, SlamConfig(match_ratio=1.3), n_landmarks=24,
                    generator=torch.Generator(device=device).manual_seed(5))
    return {"pipeline_t": traj.t.cpu(), "ba_kf_t": ba.kf_t.cpu(),
            "ba_points": ba.points.cpu(), "ba_cost": ba.cost.cpu(),
            "ransac_ok": res.ok.cpu(), "ransac_r": res.r.cpu(),
            "ransac_t": res.t.cpu(), "ransac_n_inliers": res.n_inliers.cpu()}


def rank_main(rank: int, world: int, port: int, backend: str | None,
              device: str, out_dir: str, cases_path: str | None,
              stages: bool, timeout_s: float) -> None:
    """One rank: join the group, run the stages and the cases, write
    ``rank<r>.pt`` to ``out_dir``."""
    if device == "cpu":
        torch.set_num_threads(1)
    dev = initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                 device=device, backend=backend,
                                 timeout=timedelta(seconds=timeout_s))
    result = {"rank": rank, "device": str(dev), "lines": [], "records": {},
              "outputs": {}}

    comm = CommLog()

    def record(name, fn, eager=False, profile=False):
        """Run ``fn`` (its programs' bodies eagerly with ``eager``); keep
        its outputs, seconds, K1/K2 launches and collectives; with
        ``profile`` on the card, run it once more, on rank 0 in a
        profiler window (its launches, device busy ms and wall ms kept),
        on the others plainly, for the collectives."""
        mode = graphs.eager() if eager else contextlib.nullcontext()
        before = {(id(p), v) for p in graphs.programs() for v in p.graphs}
        with mode:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            k1, k2 = _launches()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            k1b, k2b = _launches()
            rec = result["records"][name] = {
                "seconds": time.perf_counter() - t0, "k1": k1b - k1,
                "k2": k2b - k2, "comm": comm.take(),
                "captures": [(p.name, str(v), c.capture_s, c.pool_bytes)
                             for p in graphs.programs()
                             for v, c in p.graphs.items()
                             if (id(p), v) not in before]}
            if profile and dev.type == "cuda" and rank == 0:
                from pre3_tpu_torch.utils.profile_slice import _profiled

                launches, busy, wall, _ = _profiled(fn)
                rec.update(launches=launches, busy_ms=busy / 1e3,
                           wall_ms=1e3 * wall)
            elif profile and dev.type == "cuda":
                fn()
            comm.take()  # the profiled run's collectives
        result["outputs"][name] = out

    if stages:
        rng = np.random.default_rng(0)
        lines = result["lines"]
        for name, fn in (
                ("sharded-ransac", _stage_ransac),
                ("sharded-ba", _stage_ba),
                ("pose-sharded-ba", _stage_pose_ba)):
            record(name, lambda: fn(world, rng, dev, comm, lines))
        record("stage-pipeline",
               lambda: _stage_pipeline(world, dev, comm, lines))
        record("multiprocess", lambda: _stage_multiprocess(dev, comm))
    if cases_path:
        for case in torch.load(cases_path):
            mesh = _mesh(case["mesh"], dev)
            if mesh is None:  # this rank lies outside the case's submesh
                result["outputs"][case["name"]] = None
                continue
            mesh.comm = comm
            args = _to(case["args"], dev)
            record(case["name"], lambda: run_case(mesh, case["kind"], args,
                                                  dev),
                   eager=case.get("eager", False),
                   profile=case.get("profile", False))
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _equal(a, b) -> bool:
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and (
            a.shape == b.shape) and bool(torch.equal(a, b) or (
                a.is_floating_point()
                and torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _equal(a[k], b[k]) for k in a)
    return a == b


def run(world_size: int, backend: str | None = None, device: str = "cuda",
        cases: list | None = None, stages: bool = True,
        timeout: float = 600.0) -> list[dict]:
    """Spawn ``world_size`` ranks, run the stages and ``cases`` (a list of
    {"name", "kind", "mesh", "args"} with CPU tensors) on each, and return
    each rank's result. Fails if a rank fails or outlives ``timeout``
    seconds, or if the ranks' outputs of a case or stage differ."""
    with tempfile.TemporaryDirectory(prefix="pre3_dryrun_") as tmp:
        cases_path = None
        if cases:
            cases_path = os.path.join(tmp, "cases.pt")
            torch.save(cases, cases_path)
        ctx = mp.start_processes(
            rank_main, args=(world_size, _free_port(), backend, device, tmp,
                             cases_path, stages, timeout),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"dryrun: ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        results = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                   for r in range(world_size)]
    for r in results[1:]:
        for name, out in results[0]["outputs"].items():
            if out is not None and r["outputs"][name] is not None and (
                not _equal(out, r["outputs"][name])
            ):
                raise AssertionError(
                    f"dryrun: rank {r['rank']}'s {name} differs from rank 0's")
    if stages:
        mp_out = results[0]["outputs"]["multiprocess"]
        cost = float(mp_out["ba_cost"][-1])
        if cost >= 1e-3 or not bool(mp_out["ransac_ok"]):
            raise AssertionError(f"dryrun multiprocess: BA cost {cost}, "
                                 f"RANSAC ok {bool(mp_out['ransac_ok'])}")
        results[0]["lines"].append(
            f"dryrun multiprocess ok: {world_size} ranks agree, ba_cost "
            f"{cost:.2e}, ransac inliers {int(mp_out['ransac_n_inliers'])}")
        for line in results[0]["lines"]:
            print(line, flush=True)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    run(a.world_size, a.backend, a.device, timeout=a.timeout)


if __name__ == "__main__":
    main()
