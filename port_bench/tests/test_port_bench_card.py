"""The check's control on the card, at each cell's own size: the plain
reference computed with TF32 on (the nearest precision below the
configurations' float32 with TF32 off) put in the program's place must
come out not correct on every seed. Prints each seed's readings.

    python3 -m pytest port_bench/tests -m card -o addopts="" -s
"""

import json

import pytest

from port_bench import run as bench

CELLS = [w["name"] for w in json.loads(
    (bench.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2147483701, 2147483702, 2147483703)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(card, workload):
    spec = bench.load_spec(workload)
    for seed in SEEDS:
        res = bench.run_cell(spec, seed, 2.0, False, device=card,
                             control=True)
        print(f"control {workload} seed {seed}: {res['numbers']} "
              f"limits {spec['limits']}", flush=True)
        assert not res["correct"], res["numbers"]
