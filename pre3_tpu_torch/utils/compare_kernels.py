"""Other versions of the CUDA kernels against the checkout's, on one card.

Times each version of K1 (``ransac_score``) and K2 (``match_stream``) by
graph-replayed device time (``chip_smoke.device_ms``), the kernel alone
with its outputs preallocated, in turns (versions, then the same in
reverse), at the main path's shapes and at map scale; K2's versions are
also held against an exact (float64) matcher. Run it from the root of a
checkout, with the other versions' sources in a directory:

    mkdir -p build/old
    git show HEAD~1:pre3_tpu_torch/csrc/match_stream.cu > build/old/match_stream.cu
    git show HEAD~1:pre3_tpu_torch/csrc/ransac_score.cu > build/old/ransac_score.cu
    python3 -m pre3_tpu_torch.utils.compare_kernels build/old --rounds 2

Every ``ransac_score*.cu`` and ``match_stream*.cu`` there is a version,
with the same C launch interface as the checkout's (the launch counter,
the last argument, is passed null: a version without it ignores it);
each is built with the package's nvcc flags beside its source.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from pre3_tpu_torch.ops.matching import BIG, _best_two, _pairwise_dist2
from pre3_tpu_torch.utils.cuda_build import NVCC_FLAGS, build_library, find_nvcc

ROOT = Path(__file__).resolve().parents[2]
P, I = ctypes.c_void_p, ctypes.c_int
K1_ARGS = [P] * 6 + [I] * 3 + [P] * 4
K2_ARGS = [P] * 3 + [I] * 4 + [P] * 5


def _build(src: Path) -> ctypes.CDLL:
    out = src.with_name(f"lib{src.stem}.so")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def _k1(lib, args):
    r, t, p1, p2, valid, thr = args
    b, n = r.shape[0], p1.shape[0]
    support = torch.empty(b, dtype=torch.int32, device="cuda")
    err = torch.empty(b, dtype=torch.float32, device="cuda")
    ptrs = [x.data_ptr() for x in args]

    def launch():
        rc = lib.ransac_score_launch(*ptrs, 1, b, n, support.data_ptr(),
                                     err.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream,
                                     None)
        if rc:
            raise RuntimeError(f"ransac_score launch failed: cudaError {rc}")
        return support, err
    return launch


def _k2(lib, d1, d2, valid2):
    (n1, d), n2 = d1.shape, d2.shape[0]
    idx = torch.empty(n1, dtype=torch.int64, device="cuda")
    best = torch.empty(n1, dtype=torch.float32, device="cuda")
    second = torch.empty(n1, dtype=torch.float32, device="cuda")

    def launch():
        rc = lib.match_stream_launch(
            d1.data_ptr(), d2.data_ptr(), valid2.data_ptr(), 1, n1, n2, d,
            idx.data_ptr(), best.data_ptr(), second.data_ptr(),
            torch.cuda.current_stream().cuda_stream, None)
        if rc:
            raise RuntimeError(f"match_stream launch failed: cudaError {rc}")
        return idx, best, second
    return launch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", type=Path,
                    help="directory with other versions' .cu sources")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    srcs = sorted(args.versions.glob("ransac_score*.cu")) + sorted(
        args.versions.glob("match_stream*.cu"))
    with ThreadPoolExecutor(len(srcs) + 2) as pool:
        built = {s.stem: pool.submit(_build, s) for s in srcs}
        new = {n: pool.submit(build_library, n)
               for n in ("ransac_score", "match_stream")}
        libs = {name: f.result() for name, f in built.items()}
        for n, f in new.items():
            libs[f"{n}(checkout)"] = ctypes.CDLL(str(f.result()))
    k1s = [n for n in libs if n.startswith("ransac_score")]
    k2s = [n for n in libs if n.startswith("match_stream")]
    for names, fn, argtypes in ((k1s, "ransac_score_launch", K1_ARGS),
                                (k2s, "match_stream_launch", K2_ARGS)):
        for n in names:
            getattr(libs[n], fn).argtypes = argtypes
            getattr(libs[n], fn).restype = ctypes.c_int

    for n, d in ((256, 121), (4096, 128)):
        d1, d2, _, v2 = cs.matcher_problem(n, n, d, 11)
        exact = torch.where(v2[None], _pairwise_dist2(d1.double(),
                                                      d2.double()), BIG)
        ei, eb, _ = _best_two(exact)
        _, pb, _ = _best_two(torch.where(v2[None], _pairwise_dist2(d1, d2),
                                         BIG))
        print(f"accuracy {n}x{n}x{d}: plain f32 max|best - exact| "
              f"{float((pb.double() - eb).abs().max()):.3e}", flush=True)
        for name in k2s:
            i, b, _ = _k2(libs[name], d1, d2, v2)()
            print(f"accuracy {n}x{n}x{d}: {name} max|best - exact| "
                  f"{float((b.double() - eb).abs().max()):.3e}, index != "
                  f"exact {int((i != ei).sum())}", flush=True)

    for rnd in range(args.rounds):
        for b, n in ((1024, 256), (512, 256)):
            p = cs.scorer_problem(b, n, 10)
            times = [f"{name} {cs.device_ms(_k1(libs[name], p)):.5f}"
                     for name in k1s + k1s[::-1]]
            print(f"K1 {b}x{n} round {rnd} (ms): " + ", ".join(times),
                  flush=True)
        for n, d in ((256, 121), (4096, 128), (8192, 128)):
            d1, d2, _, v2 = cs.matcher_problem(n, n, d, 11)
            times = [f"{name} {cs.device_ms(_k2(libs[name], d1, d2, v2)):.5f}"
                     for name in k2s + k2s[::-1]]
            plain = cs.device_ms(lambda: _best_two(torch.where(
                v2[None, :], _pairwise_dist2(d1, d2), BIG)))
            mm = cs.device_ms(lambda: torch.mm(d1, d2.T))
            print(f"K2 {n}x{n}x{d} round {rnd} (ms): " + ", ".join(times)
                  + f"; plain {plain:.5f}; torch.mm {mm:.5f}", flush=True)


if __name__ == "__main__":
    main()
