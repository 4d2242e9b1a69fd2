"""The readings that the limits of the correctness check are set from, for
many seeds in one process (the benchmark's own runs never run this):

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control] [--fault half_batch] [--out readings.jsonl]

For each seed: the cell's set-up from that seed, the program's checked
calls or steps (as many as a run checks, at the cell's own sizes), then
the numbers a run compares (`program`) and, with --control, the same
numbers for the reference computed with float8 e4m3 operands in the
program's place (`control`); with --fault, for the reference with the
named fault planted (`fault`):

* half_batch: each step's loss and gradients over the first half of the
  batch's rows, the draws made for those rows (training cells);
* unchanged: the state left as it was, each denoising step returning its
  input (sampling cells).

Prints one JSON line per seed. Needs the card unless --device cpu.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[0] = str(HERE.parent)


def sampling_fault(drv, k, fault):
    from perfbench.reference import schedule as ref_schedule
    if fault != "unchanged":
        raise ValueError(f"no fault {fault!r} for a sampling cell")
    original = ref_schedule.sample
    ref_schedule.sample = lambda schedule, model, x, steps, method: x
    try:
        return drv.reference(k)
    finally:
        ref_schedule.sample = original


def train_fault(drv, fault):
    if fault != "half_batch":
        raise ValueError(f"no fault {fault!r} for a training cell")
    pool, batch = drv.pool, drv.batch
    drv.pool = pool[:, :batch // 2]
    try:
        return drv.reference()
    finally:
        drv.pool = pool


def readings(cell, seed: int, device, control: bool = False,
             fault: str = None) -> dict:
    """One seed's numbers: the program's, and the control's or a planted
    fault's where asked for."""
    import torch
    from perfbench.reference.precision import FP8
    t0 = time.perf_counter()
    drv = cell.traffic(device, seed)
    drv.setup()
    row = {"workload": cell.name, "seed": seed}
    if cell.kind == "sampling":
        calls = int(cell.mix["check_calls"])
        for k in range(calls):
            drv.outputs[k] = drv.call(k, drv.steps)
        drv.release()
        refs = {k: drv.reference(k) for k in range(calls)}
        row["program"] = {"scan_gap": max(
            drv.scan_gap(drv.outputs[k], refs[k]) for k in refs)}
        if control:
            row["control"] = {"scan_gap": max(
                drv.scan_gap(drv.reference(k, FP8), refs[k]) for k in refs)}
        if fault:
            row["fault"] = {"scan_gap": max(
                drv.scan_gap(sampling_fault(drv, k, fault), refs[k])
                for k in refs)}
    else:
        drv.release()
        ref = drv.reference()
        row["program"] = drv.numbers(drv.program_result(), ref)
        if control:
            row["control"] = drv.numbers(drv.reference(FP8), ref)
        if fault:
            row["fault"] = drv.numbers(train_fault(drv, fault), ref)
    row["fault_name"] = fault
    row["seconds"] = time.perf_counter() - t0
    if device.type == "cuda":
        row["card"] = torch.cuda.get_device_name(device)
        del drv
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
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
        row = readings(cell, seed, device, args.control, args.fault)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
