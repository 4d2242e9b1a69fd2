"""The readings the inpainting cell's limits are set from, for many seeds
in one process (the benchmark's own runs never run this):

    python3 perfbench/calibrate_inpaint.py --workload inpaint_train_b32 \
        --seeds 1,2,3 [--phases 8] [--out readings.jsonl]

For each seed: the cell's set-up from that seed (its checked steps at the
cell's own sizes), then the numbers a run compares for
* `program`: the program as the cell runs it;
* `fp8`: the reference with float8 e4m3 operands in every product
  (perfbench/reference/precision.py FP8), the precision below the
  configuration's bfloat16;
* `zero_condition`: the reference with the condition all zeros;
* `half_batch`: the reference on the first half of each batch's rows
  (perfbench/calibrate.py `train_fault`).

With --phases n, before the check: the device ms a step by phase of n
replayed steps (perfbench/graph_phases.py, as the cell's reader takes
them), then the median over EAGER_STEPS eager steps at the same shapes,
each device operation given to the innermost span that launched it
(perfbench/span_device.py), for the cross-check of the two attributions,
with the graph's device operations and the operations each replay showed
(`phases`).

Prints one JSON line per seed. Needs the card unless --device cpu.
"""

import argparse
import collections
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[0] = str(HERE.parent)
EAGER_STEPS = 3


def phases(drv, steps: int) -> dict:
    """Device ms a step by phase: `steps` replays of the cell's graph, and
    the median of EAGER_STEPS eager steps, the graphs dropped before each."""
    from torch.profiler import ProfilerActivity, profile
    from perfbench import graph_phases, span_device
    from perfbench import spans as bench_spans

    def profiled(work):
        drv.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work()
            drv.sync()
        return prof

    prof = profiled(lambda: drv.fit(drv.feed(steps=steps)))
    graph = drv.captured_step()
    split = graph_phases.by_phase(prof, graph)
    replay = ({k: v / split["replays"] for k, v in split["ms"].items()}
              if split else None)
    ops, launches = graph_phases.from_profile(prof)
    per_launch = collections.Counter(c for _, _, c in ops if c in launches)

    def eager_steps():
        for _ in range(EAGER_STEPS):
            # a step of a key the step function has not seen runs eager
            drv.trainer.train_step.graphs.clear()
            drv.fit(drv.feed(steps=1))

    prof = profiled(eager_steps)
    ops, launched = span_device.from_profile(prof)
    main = span_device.main_thread_spans(bench_spans.ring() or [],
                                         "train_step")
    roots = [(a, b) for name, a, b in main if name == "train_step"]
    eager = [span_device.attribute(ops, launched, [
        s for s in main if a <= s[1] and s[2] <= b]) for a, b in
        roots[-EAGER_STEPS:]]
    return {"replay_ms": replay,
            "eager_ms": {name: statistics.median(e.get(name, 0.0)
                                                 for e in eager)
                         for name in eager[0]} if eager else None,
            "device_ops": getattr(graph, "device_ops", None),
            "ops_per_launch": sorted(per_launch.values())}


def readings(cell, seed: int, device, phase_steps: int = 0) -> dict:
    import torch
    from perfbench import calibrate
    from perfbench.reference.precision import FP8
    t0 = time.perf_counter()
    drv = cell.traffic(device, seed)
    drv.setup()
    row = {"workload": cell.name, "seed": seed}
    if phase_steps:
        row["phases"] = phases(drv, phase_steps)
    drv.release()
    ref = drv.reference()
    row["program"] = drv.numbers(drv.program_result(), ref)
    for key, make in (
            ("fp8", lambda: drv.reference(FP8)),
            ("zero_condition", lambda: drv.reference(zero_condition=True)),
            ("half_batch", lambda: calibrate.train_fault(drv,
                                                         "half_batch"))):
        row[key] = drv.numbers(make(), ref)
    row["seconds"] = time.perf_counter() - t0
    if device.type == "cuda":
        row["card"] = torch.cuda.get_device_name(device)
        del drv
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="inpaint_train_b32")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--phases", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    cell = harness.Cell(args.workload, Path(args.root))
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(cell, seed, device, args.phases))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
