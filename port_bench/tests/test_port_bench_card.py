"""The check's control on the card, at each cell's own size (every cell
of BENCHMARK.json, and config #2's, ``cells.CHECKED``): the plain
reference computed with TF32 on (the nearest precision below the
configurations' float32 with TF32 off) put in the program's place must
come out not correct on every seed. Prints each seed's readings.

    python3 -m pytest port_bench/tests -m card -o addopts="" -s
"""

import pytest

from port_bench import run as bench
from port_bench.tests.cells import CHECKED, spec_of

SEEDS = (2147483701, 2147483702, 2147483703)


@pytest.mark.card
@pytest.mark.parametrize("workload", CHECKED)
def test_control_fails(card, workload):
    spec = spec_of(workload)
    for seed in SEEDS:
        res = bench.run_cell(spec, seed, 2.0, False, device=card,
                             control=True)
        print(f"control {workload} seed {seed}: {res['numbers']} "
              f"limits {spec['limits']}", flush=True)
        assert not res["correct"], res["numbers"]
