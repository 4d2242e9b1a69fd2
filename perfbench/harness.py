"""The benchmark's harness, led by data.

A run of cell `name` reads, under the benchmark's directory:

* `workloads/<name>.json`: the cell's configuration, traffic mix, chips,
  why, and the limits of its correctness check;
* `configs/<config>.json`: the model configuration as it is run;
* `traffic/<mix>.json`: the mix's parameters and its `kind`, whose code
  is `traffic/<kind>.py`;
* `metrics/<metric>.py`: one reader per per-layer metric, `read(record,
  work)`, for the metrics that BENCHMARK.json lists for the cell;

and BENCHMARK.json at the root of the checkout for the metrics' units and
which end-to-end metrics the cell reports.

A run makes the weights and inputs from the seed, warms up (that and the
imports are `setup_s`), measures a closed loop for `seconds`, and with
`trace` 1 profiles a further stretch; then it reads the peak memory, frees
the program's state, checks the outputs against the reference and prints
one JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "rangeldm_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A Python file of the benchmark loaded by path under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that are JAX, its libraries or the
    JAX package, compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def derived_seeds(seed: int, stream: int, n: int) -> List[int]:
    """n 31-bit seeds of stream `stream` of the run's seed."""
    seq = np.random.SeedSequence([seed & (2 ** 64 - 1), stream])
    return [int(s) & 0x7FFFFFFF for s in seq.generate_state(n)]


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q % of the values at or below it."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(units: float, seconds: float) -> float:
    return units / seconds


class Cell:
    """A cell's files: the cell, its configuration and its traffic mix."""

    def __init__(self, name: str, root: Path = BENCH_DIR):
        self.root = root
        self.name = name
        self.spec = load_json(root / "workloads" / f"{name}.json")
        self.config = load_json(root / "configs" /
                                f"{self.spec['config']}.json")
        self.mix = load_json(root / "traffic" /
                             f"{self.spec['traffic']}.json")
        self.kind = self.mix["kind"]

    def traffic(self, device, seed: int):
        module = load_module(self.root / "traffic" / f"{self.kind}.py",
                             f"perfbench_traffic_{self.kind}")
        return module.Traffic(self.config, self.mix, device, seed)

    def metrics(self, benchmark: dict) -> Tuple[List[dict], List[dict]]:
        """The end-to-end and per-layer metrics of BENCHMARK.json that this
        cell reports."""
        def mine(m):
            return "workloads" not in m or self.name in m["workloads"]
        return ([m for m in benchmark["end_to_end"] if mine(m)],
                [m for m in benchmark["per_layer"] if mine(m)])


def device_block(device, count: int, peak: int) -> dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(peak)}


def checks_text(checks: List[Tuple[str, float, float]]) -> List[str]:
    return [f"{name} {value!r} limit {limit!r}"
            for name, value, limit in checks]


def run(workload: str, seed: int, seconds: float, trace: bool,
        device=None, root: Path = BENCH_DIR,
        t_start: Optional[float] = None, count: int = 1) -> dict:
    """One run of a cell; returns the result line's object. `device` is
    the card the caller checked, or the CPU in tests."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    benchmark = load_json(root.parent / "BENCHMARK.json")
    cell = Cell(workload, root)
    e2e_metrics, layer_metrics = cell.metrics(benchmark)
    device = torch.device(device or "cuda")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    drv = cell.traffic(device, seed)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    window = drv.window(seconds)
    record = None
    if trace:
        record = drv.profiled()
        record["unprofiled"] = {"units": window["units"],
                                "wall_s": window["wall_s"]}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    attempted, failed = window["attempted"], window["failed"]
    drv.release()
    checks = drv.check(cell.spec["limits"])
    correct = bool(checks) and all(v <= lim for _, v, lim in checks) and \
        failed == 0
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    metrics: Dict[str, dict] = {}
    if trace:
        work = drv.work()
        for m in layer_metrics:
            reader = load_module(root / "metrics" / f"{m['name']}.py",
                                 "perfbench_metric_" + m["name"].replace(
                                     ".", "_"))
            value = reader.read(record, work)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        for m in e2e_metrics:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = device_block(device, count, peak)
    if trace:
        out["device"]["busy_s"] = record["busy_s"]
        out["device"]["window_s"] = record["window_s"]
        out["breakdown"] = record["breakdown"]
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in checks}
    return out
