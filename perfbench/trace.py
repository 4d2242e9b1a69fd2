"""The reduction of a torch.profiler trace to what the per-layer metrics
read: device operations, the time the device was busy (the union of their
intervals), time by kernel name and by kernel group, and the longest idle
gaps labelled by what the host was doing.

`GROUPS` and the busy time (the union of the operations' intervals) are
copies of the program's step profile (rangeldm_tpu_torch/utils/
profiling.py `GROUPS`, `busy_ms`), kept here so that a change to the
program does not move the yardstick.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

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
TOP = 10


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if re.search(pattern, name):
            return group
    return "other"


def union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def is_kernel(name: str) -> bool:
    """A device operation that is a kernel, not a copy or a set issued by
    the runtime."""
    return not name.startswith(("Memcpy", "Memset"))


# host events of the profiler itself, not of the program
PROFILER_EVENTS = ("Activity Buffer Request",)


def _innermost(host: List[Tuple[float, float, str]], starts: List[float],
               at: float) -> str:
    """The name of the shortest host event that spans `at`, with its
    enclosing event's name where it is a runtime call (cudaLaunchKernel,
    cudaStreamSynchronize, ...); where none spans it, the host was
    between operators: "after" the last one that ended before `at`."""
    spans, last = [], None
    i = bisect.bisect_right(starts, at)
    for s, e, name in host[max(0, i - 4000):i]:
        if s <= at < e:
            spans.append((e - s, name))
        elif e <= at and (last is None or e > last[0]):
            last = (e, name)
    if not spans:
        return f"after {last[1]}" if last else "no host event"
    spans.sort()
    inner = spans[0][1]
    if inner.startswith("cuda") and len(spans) > 1:
        return f"{spans[1][1]} > {inner}"
    return inner


def reduce(device: List[Tuple[str, float, float]],
           host: List[Tuple[float, float, str]]) -> dict:
    """`device`: (name, start_s, end_s) of each device operation of the
    profiled stretch; `host`: (start_s, end_s, name) of each host event.
    Returns the operations' count, kernels' count, busy seconds, seconds by
    name and by group, and the longest idle gaps between device
    operations, each labelled by the innermost host event running at its
    middle."""
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in device:
        by_name[name] += e - s
    by_group: Dict[str, float] = defaultdict(float)
    for name, sec in by_name.items():
        by_group[group_of(name)] += sec
    merged = union((s, e) for _, s, e in device)
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                   for a, b in zip(merged, merged[1:])), reverse=True)[:TOP]
    host = sorted(host)
    starts = [h[0] for h in host]
    return {
        "operations": len(device),
        "kernels": sum(1 for name, _, _ in device if is_kernel(name)),
        "busy_s": sum(e - s for s, e in merged),
        "time_by_name": dict(by_name),
        "time_by_group": dict(by_group),
        "idle_gaps": [[_innermost(host, starts, mid), gap]
                      for gap, mid in gaps],
    }


def from_profile(prof) -> Tuple[List[Tuple[str, float, float]],
                                List[Tuple[float, float, str]]]:
    """(device operations, host events) of a finished torch.profiler
    profile, times in seconds, from its Kineto events."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            continue
        start = ev.start_ns() / 1e9
        end = start + ev.duration_ns() / 1e9
        if ev.device_type() == cuda:
            device.append((ev.name(), start, end))
        elif ev.name() not in PROFILER_EVENTS:
            host.append((start, end, ev.name()))
    return device, host


def breakdown(reduced: dict) -> dict:
    """The result line's `breakdown`: device seconds by the largest kernel
    groups and kernels (at most 10 entries together), and the longest idle
    gaps."""
    groups = sorted(reduced["time_by_group"].items(), key=lambda kv: -kv[1])
    names = sorted(reduced["time_by_name"].items(), key=lambda kv: -kv[1])
    ops = [[f"group:{g}", s] for g, s in groups[:4]] + [
        [n[:160], s] for n, s in names[:TOP - min(4, len(groups))]]
    return {"device_ops": ops, "idle_gaps": reduced["idle_gaps"][:TOP]}
