"""Where the time of a training step goes on the card, from torch.profiler.

    python -m rangeldm_tpu_torch.utils.profiling [--model rangedm_kitti360
                                                  --batch 8]

Builds `LdmTrainer` on a zoo model (default the flagship
`rangeldm_kitti360` at batch 32; pixel-space RangeDM trains at batch 8 in
its shipped YAML) in bf16 with seeded random weights and the trainer's
defaults for the rest, runs WARMUP fit steps on seeded synthetic range
images, times STEPS more on the host clock, then profiles STEPS more.
Prints one JSON line: wall time per step without and with the profiler,
device busy time per step (the union of the kernels' intervals), the
device's idle share (against the unprofiled wall time: the profiler slows
the host, not the kernels), and device time per step by kernel group and
by kernel name. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import tempfile
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

WARMUP, STEPS, TOP = 3, 5, 20
# kernel-name patterns, first match wins
GROUPS = [
    ("attention_bwd", r"attention_bwd"),
    ("attention_fwd", r"attention_fwd"),
    ("optimizer_ema", r"multi_tensor|foreach|adam"),
    ("group_norm", r"group_norm|GroupNorm|welford"),
    ("batch_norm", r"batch_norm|bn_fw|bn_bw"),
    ("convolution", r"conv|cudnn|implicit|dgrad|wgrad|fprop|xmma"),
    ("matmul", r"gemm|cutlass|cublas|sm90_"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
    ("reduction", r"reduce|Reduce"),
    ("copy", r"copy|Memcpy|Memset|cat|CatArray"),
]


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if re.search(pattern, name):
            return group
    return "other"


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals in µs, as ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def device_time(prof, steps: int, wall_ms: float) -> dict:
    """A profile of `steps` steps -> device busy ms per step (the union of
    the kernels' intervals), the idle share against `wall_ms` (the
    unprofiled wall time of a step: the profiler slows the host, not the
    kernels), kernels per step, and device ms per step by kernel group and
    by kernel name."""
    # device events, without the annotations that span them (such as the
    # optimizer's step range)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name, by_group = defaultdict(float), defaultdict(float)
    counts = defaultdict(int)
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / steps
        by_name[e.name] += ms
        by_group[group_of(e.name)] += ms
        counts[e.name] += 1
    busy = busy_ms([(e.time_range.start, e.time_range.end)
                    for e in kernels]) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "device_busy_ms_per_step": busy,
        "device_idle_share": (1 - busy / wall_ms) if kernels else None,
        "kernels_per_step": len(kernels) / steps,
        "device_ms_per_step_by_group": dict(
            sorted(by_group.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms_per_step": ms,
                         "launches_per_step": counts[n] / steps}
                        for n, ms in top]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="rangeldm_kitti360")
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    from rangeldm_tpu_torch.train_ldm import LdmTrainer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = LdmTrainer({"model": args.model,
                              "mixed_precision": "bf16",
                              "lr_warmup_steps": 2, "output_dir": tmp})
        h, w = trainer.spec.image_size
        gen = torch.Generator(device="cuda").manual_seed(0)
        images = [torch.randn((args.batch, h, w, 2), generator=gen,
                              device="cuda")
                  for _ in range(WARMUP + 2 * STEPS)]
        batches = iter({"jpg": x} for x in images)

        def steps(until: int) -> float:
            """ms per step of fit up to step `until`, host clock."""
            n = until - trainer.state.step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.fit(batches, max_steps=until, log_every=n)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        steps(WARMUP)
        wall = steps(WARMUP + STEPS)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_profiled = steps(WARMUP + 2 * STEPS)
    result = {"card": smi, "model": args.model, "batch": args.batch,
              "steps": STEPS, "dtype": "bfloat16", "wall_ms_per_step": wall,
              "wall_ms_per_step_profiled": wall_profiled,
              **device_time(prof, STEPS, wall)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
