"""The readings the VAE-GAN cell's limits are set from, for many seeds in
one process (the benchmark's own runs never run this):

    python3 perfbench/calibrate_vae_gan.py --workload vae_gan_train_b16 \
        --seeds 1,2,3 [--only program,bf16_ref] [--out readings.jsonl]

For each seed: the cell's set-up from that seed (its checked steps at the
cell's own sizes), then the numbers a run compares for
* `program`: the program as the cell runs it;
* `fp8`: the reference with float8 e4m3 operands in every product
  (perfbench/reference/precision.py FP8);
* `bf16_ref`: the reference with bfloat16 operands, the precision next
  below the configuration's TF32;
* `bf16_run`: the program with `mixed_precision: bf16` (autocast of the
  VAE's and the discriminator's forwards), from the same weights and data;
* `half_batch`: the reference on the first half of each batch's rows
  (perfbench/calibrate.py `train_fault`);
* `disc_skipped`: the reference with the discriminator's update left out.

`--only a,b` takes the program's readings and those named (default all).
Prints one JSON line per seed. Needs the card unless --device cpu.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[0] = str(HERE.parent)

VARIANTS = ("program", "fp8", "bf16_ref", "half_batch", "disc_skipped",
            "bf16_run")


def readings(cell, seed: int, device, only=VARIANTS) -> dict:
    import torch
    from perfbench import calibrate
    from perfbench.reference.precision import FP8
    from perfbench.reference.vae_gan import BF16
    t0 = time.perf_counter()
    drv = cell.traffic(device, seed)
    drv.setup()
    drv.release()
    ref = drv.reference()
    row = {"workload": cell.name, "seed": seed,
           "program": drv.numbers(drv.program_result(), ref),
           "reference_scalars": {k: ref[k] for k in drv.results}}
    for key, make in (
            ("fp8", lambda: drv.reference(FP8)),
            ("bf16_ref", lambda: drv.reference(BF16)),
            ("half_batch", lambda: calibrate.train_fault(drv, "half_batch")),
            ("disc_skipped", lambda: drv.reference(fault="disc_skipped"))):
        if key in only:
            row[key] = drv.numbers(make(), ref)
    bf16 = None
    if "bf16_run" in only:
        bf16 = cell.traffic(device, seed)
        bf16.cfg = dict(bf16.cfg, mixed_precision="bf16")
        bf16.setup()
        bf16.release()
        row["bf16_run"] = drv.numbers(bf16.program_result(), ref)
    row["seconds"] = time.perf_counter() - t0
    if device.type == "cuda":
        row["card"] = torch.cuda.get_device_name(device)
        row["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        del drv, bf16
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--only", default=",".join(VARIANTS))
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
        row = readings(cell, seed, device, args.only.split(","))
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
