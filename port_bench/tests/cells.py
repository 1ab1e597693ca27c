"""The cells the benchmark's tests run: every cell of ``BENCHMARK.json``,
and config #2's (``ncc_ekf.corridor``), whose configuration and limits
are under ``port_bench/`` whether or not ``BENCHMARK.json`` lists it."""

import json

from port_bench import run as bench

BENCHMARK = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
NCC = "ncc_ekf.corridor"
NCC_CONFIG = json.loads((bench.BENCH / "configs" / "ncc_ekf_k256.json")
                        .read_text())
CHECKED = CELLS + [NCC] * (NCC not in CELLS)


def spec_of(workload: str) -> dict:
    """The cell's spec; for config #2's cell where BENCHMARK.json does not
    list it, the SIFT corridor cell's with config #2's configuration and
    limits (the same traffic)."""
    if workload in CELLS:
        return bench.load_spec(workload)
    spec = bench.load_spec("sift_ekf.corridor")
    spec["config"] = json.loads(json.dumps(NCC_CONFIG))
    spec["limits"] = json.loads(
        (bench.BENCH / "limits" / f"{workload}.json").read_text())
    return spec
