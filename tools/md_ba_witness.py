"""How far the landmark-sharded BA's f32 result moves between one and two
ranks, and why.

At two ranks ``bundle_adjust_sharded`` sums the two shards' reduced camera
systems with an all-reduce, so its f32 additions run in another order
than at one rank, and the Jacobi-scaled solve carries that rounding into
the poses. This script runs the port's landmark-sharded BA on a saved
``BaProblem`` at one rank and at two ranks, each in f32 and in f64, with
``backend/ba.py::bundle_adjust`` beside them, and prints:

  - the one-vs-two-rank gap in f32 and in f64: in f64 the rounding is
    2^-29 times smaller, so the f64 gap says whether the two ranks solve
    the same system;
  - each f32 run's distance from the f64 run at the same world size (the
    f32 solve's own error, the scale the f32 gap has when nothing is at
    fault);
  - the 2-norm condition number of the Jacobi-scaled reduced camera
    system at the first LM state, in f64.

Every run is made twice, to show whether a reading repeats.

    python3 tools/md_ba_witness.py --problem P.pt [--device cuda|cpu]

P.pt holds a dict of BaProblem fields as CPU tensors (``torch.save``).
On one GPU the one-rank run is an NCCL group and the two ranks share
cuda:0 over gloo, as in chip_smoke.py's phase 21.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pre3_tpu_torch.backend.ba import (  # noqa: E402
    BaProblem, _build_normal_eqs, _depth_weights, _odo_terms, _pair_terms,
    bundle_adjust,
)
from pre3_tpu_torch.geometry.camera import sr4000_camera  # noqa: E402
from pre3_tpu_torch.parallel import dryrun  # noqa: E402

ITERS, REPEATS = 10, 2  # chip_smoke.py's BA_ITERS


def as_dtype(problem: dict, dtype) -> dict:
    return {k: None if v is None else (v.to(dtype) if v.is_floating_point()
                                       else v)
            for k, v in problem.items()}


def reduced_condition(cam, problem: dict) -> float:
    """2-norm condition number of the Jacobi-scaled, gauge-fixed reduced
    camera system of ``bundle_adjust``'s first step (damping 1e-3), in
    f64, as ``backend/ba.py::schur_solve`` builds it."""
    p = BaProblem(**as_dtype(problem, torch.float64))
    kf_t, kf_q, points = p.kf_t, p.kf_q, p.points
    f = p.mask.shape[0]
    w_xyz = _depth_weights(p.mask & p.mask_xyz, p.obs_xyz, 50.0, 0.0,
                           torch.float64)
    hub = (torch.where(p.lc_lm[None, :], 1e6, 3.0).double()
           if p.lc_lm is not None else 3.0)
    hcc, hpp, wcp, bc, bp = _build_normal_eqs(
        cam, kf_t, kf_q, points, p.obs_uv, p.mask, p.obs_xyz, w_xyz,
        torch.tensor(1e-3, dtype=torch.float64), huber_delta=hub)
    hpp_inv = torch.linalg.inv(hpp)
    s = -torch.einsum("flab,lbc,gldc->fagd", wcp, hpp_inv, wcp)
    ar = torch.arange(f)
    s[ar, :, ar, :] += hcc
    if p.odo_t is not None:
        s = s + _odo_terms(kf_t, kf_q, p.odo_t, p.odo_q, 20.0, 50.0,
                           p.odo_w)[0]
    if p.lcp_i is not None:
        w = p.lcp_w if p.lcp_w is not None else torch.ones(
            p.lcp_i.shape[0], dtype=torch.float64)
        s = s + _pair_terms(kf_t, kf_q, p.lcp_i, p.lcp_j, p.lcp_t, p.lcp_q,
                            20.0, 50.0, w, p.lcp_info)[0]
    keep = torch.ones(f, dtype=torch.float64)
    keep[0] = 0.0
    s = s * keep[:, None, None, None] * keep[None, None, :, None]
    s[0, :, 0, :] = torch.eye(6, dtype=torch.float64)
    sd = s.reshape(f * 6, f * 6)
    d = torch.sqrt(torch.clamp(torch.diagonal(sd), min=1e-12))
    return float(torch.linalg.cond(sd / d[:, None] / d[None, :]))


def gap(a: dict, b: dict) -> dict:
    return {k: float((a[k].double() - b[k].double()).abs().max())
            for k in ("kf_t", "kf_q", "points")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--problem", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    cuda = a.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("md_ba_witness: no CUDA device; pass --device cpu")
    cam = sr4000_camera()
    prob = torch.load(a.problem)
    cases = [{"name": f"ba{bits}", "kind": "ba", "mesh": {"axis": "lm"},
              "args": {"problem": as_dtype(prob, dtype), "iters": ITERS}}
             for bits, dtype in ((32, torch.float32), (64, torch.float64))]
    out = {"problem": os.path.basename(a.problem), "device": a.device,
           "shape": list(prob["mask"].shape), "iters": ITERS}
    if cuda:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        print(out["card"], flush=True)

    single = {}
    for bits, dtype in ((32, torch.float32), (64, torch.float64)):
        p = BaProblem(**{k: None if v is None else v.to(a.device)
                         for k, v in as_dtype(prob, dtype).items()})
        res = bundle_adjust(cam, p, iters=ITERS)
        single[bits] = {k: getattr(res, k).cpu()
                        for k in ("kf_t", "kf_q", "points", "cost")}

    runs = []
    for rep in range(REPEATS):
        for world, backend in ((1, "nccl" if cuda else "gloo"), (2, "gloo")):
            res = dryrun.run(world, backend=backend, device=a.device,
                             cases=cases, stages=False, timeout=600)
            runs.append({"repeat": rep, "world": world,
                         "outputs": res[0]["outputs"]})

    readings = []
    for rep in range(REPEATS):
        one, two = [r["outputs"] for r in runs if r["repeat"] == rep]
        row = {"repeat": rep,
               "f32_1_vs_2": gap(one["ba32"], two["ba32"]),
               "f64_1_vs_2": gap(one["ba64"], two["ba64"]),
               "f32_vs_f64_1": gap(one["ba32"], one["ba64"]),
               "f32_vs_f64_2": gap(two["ba32"], two["ba64"]),
               "f32_1_vs_bundle_adjust": gap(one["ba32"], single[32]),
               "f64_1_vs_bundle_adjust": gap(one["ba64"], single[64])}
        readings.append(row)
        for k, v in row.items():
            if k != "repeat":
                print(f"repeat {rep} {k}: max |Δkf_t| {v['kf_t']:.3e} m, "
                      f"max |Δkf_q| {v['kf_q']:.3e}, max |Δpoints| "
                      f"{v['points']:.3e} m", flush=True)
    for rep in range(1, REPEATS):
        same = all(torch.equal(runs[2 * rep + i]["outputs"][c][k],
                               runs[i]["outputs"][c][k])
                   for i in (0, 1) for c in ("ba32", "ba64")
                   for k in ("kf_t", "kf_q", "points", "cost"))
        print(f"repeat {rep} equal to repeat 0 to the bit: {same}",
              flush=True)
        readings[rep]["equal_to_repeat_0"] = same
    out["readings"] = readings

    out["cond"] = reduced_condition(cam, prob)
    print(f"condition number of the Jacobi-scaled reduced system at the "
          f"first state (f64): {out['cond']:.3e}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
