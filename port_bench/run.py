"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 port_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration ``port_bench/configs/<config>.json``, its traffic
``port_bench/workloads/<traffic>.json`` (whose ``kind`` names the window
that drives it, ``port_bench/<kind>.py``), the limits of its check
``port_bench/limits/<cell>.json`` and each per-layer metric's reader
``port_bench/metrics/<metric>.py``. With ``--trace 0`` the run reports
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.
After the window the plain reference checks the outputs
(``port_bench/check.py``); the numbers compared and their limits are the
last lines on standard error and the last key of the result line, the
last line on standard output.

The run measures the port (``pre3_tpu_torch``) on CUDA devices only: it
exits with an error and prints no result where there is no card, where
there are fewer than the cell asks for, and where ``jax``, ``jaxlib``,
``flax`` or the JAX package ``pre3_tpu`` has been imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "port_bench"
# Top-level module names no run may import: JAX and the JAX package
# (compared whole: ``pre3_tpu_torch`` is the port, not ``pre3_tpu``).
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pre3_tpu"})


def fixed_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the kernels' own build directory is ``build/kernels``)."""
    cache = ROOT / "build" / "port_bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def load_spec(workload: str) -> dict:
    """The cell, its configuration, traffic and limits, and the metrics
    of ``BENCHMARK.json`` that the cell reports."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"run.py: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    return dict(
        cell=cell, bench=bench,
        config=json.loads((ROOT / entry["file"]).read_text()),
        traffic=json.loads(
            (BENCH / "workloads" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((BENCH / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def reader(name: str):
    """The ``read(trace)`` function of a per-layer metric."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(spec: dict, seed: int, seconds: float, tracing: bool,
             device="cuda", control: bool = False, t_start: float = T_START,
             renders=None, workers: int = 8) -> dict:
    """One run of the cell; returns the result line's fields (without the
    device's) and the check's numbers beside their limits. ``renders``:
    the run's corridors, already rendering (``traffic.start``)."""
    from port_bench import check, traffic

    if renders is None:
        renders = traffic.start(spec["traffic"], seed, workers)
    try:
        kind = spec["traffic"]["kind"]
        window = importlib.import_module(f"port_bench.{kind}")
        from port_bench.evaluate import note
        note(t_start, "the port imported")
        res = window.run(spec, seed, seconds, tracing, control, device,
                         t_start, renders)
    finally:
        renders.close()
    print("render workers: " + "; ".join(renders.notes), file=sys.stderr)
    units = {m["name"]: m["unit"] for m in
             spec["bench"]["end_to_end"] + spec["bench"]["per_layer"]}
    metrics = {}
    if tracing:
        from port_bench.roofline import KERNELS
        from port_bench.tracing import kernel_time

        tr = res["trace"]
        print("trace: kernel launches seen / made by the shapes: " + ", ".join(
            f"{k} {kernel_time(tr['driver'], name)[0]} / {len(tr['bounds'][k])}"
            for k, name in KERNELS.items()), file=sys.stderr)
        for m in spec["per_layer"]:
            value = reader(m["name"])(res["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(res["metrics"], setup_s=res["setup_s"])
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": units[m["name"]]}
    # the window's check frees the program's graphs before the
    # reference runs
    ref = check.Reference(spec["config"], device)
    ctl = check.Reference(spec["config"], device, control=True) \
        if control else None
    t_check = time.perf_counter()
    try:
        numbers = res["check"](ref, ctl)
        ok = True
    except Exception:  # noqa: BLE001 — a check that cannot finish fails
        traceback.print_exc()
        numbers, ok = {}, False
    print(f"check: {time.perf_counter() - t_check:.3f} s after the window",
          file=sys.stderr, flush=True)
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in spec["limits"].items()}
    correct = ok and res["failed"] == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    out = dict(correct=correct, attempted=res["attempted"],
               failed=res["failed"], metrics=metrics,
               peak_bytes=res["peak_bytes"], checks=checks,
               numbers=numbers, window_s=res["window_s"])
    if tracing:
        out["window"] = res["trace"]["window"]
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the package by its name from the checkout's root, not this
    # script's folder by its modules' bare names
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != BENCH]
    fixed_caches()
    spec = load_spec(args.workload)
    chips = spec["cell"]["chips"]

    import torch

    from port_bench import traffic

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s), the machine "
              f"has {count}; nothing measured", file=sys.stderr)
        return 3
    # the corridors render in worker processes while the port loads
    renders = traffic.start(spec["traffic"], args.seed,
                            min(8, os.cpu_count() or 1))
    try:
        print(f"card: {card_line()}", file=sys.stderr, flush=True)
        res = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                       renders=renders)
    finally:
        renders.close()
    from port_bench import tracing

    found = sorted(FORBIDDEN & {m.split(".")[0] for m in sys.modules})
    if found:
        print(f"run.py: the run imported {', '.join(found)}; no result",
              file=sys.stderr)
        return 4
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=chips, memory_peak_bytes=res["peak_bytes"])
    line = dict(correct=res["correct"], attempted=res["attempted"],
                failed=res["failed"], metrics=res["metrics"], device=device)
    if args.trace:
        w = res["window"]
        device.update(busy_s=w.busy_s, window_s=w.wall_s)
        line["breakdown"] = tracing.breakdown(w)
    line["checks"] = res["checks"]
    print(f"window: {res['window_s']:.3f} s; every number the check "
          f"computed: {res['numbers']}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
