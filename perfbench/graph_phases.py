"""Device time by phase of a replayed CUDA graph.

A replay is one host call, `cudaGraphLaunch`, and a profile gives every
device operation of the graph that call's correlation id, so attribution
by launch (perfbench/span_device.py) files a whole step under the replay's
span. The program's capture keeps where each span's work lies in the graph
(rangeldm_tpu_torch/utils/graphs.py `Captured.phases`: the span's name and
the graph's count of device operations as it began and as it ended;
`Captured.device_ops`, the graph's whole count). A one-stream capture is a
chain, run in the order of capture, so a replay's device operations in
order of start, k = 0, 1, ..., belong to the phases whose [begin, end)
holds k. Nested spans (a `condition` inside `encode`) each get theirs.

A replay whose trace shows another number of device operations than the
capture counted cannot be placed and is left out: the profiler can lose
records of a session's first operations (seen on an H100, a few of a
replay's 3,330 in a long-lived process). The split reads None where no
replay is whole, or where the program keeps no phases (an older
program).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def from_profile(prof) -> Tuple[List[Tuple[int, int, int]], Set[int]]:
    """(device operations as (start_ns, end_ns, correlation id), the
    correlation ids of the graph launches) of a finished torch.profiler
    profile."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops, launches = [], set()
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            continue
        if ev.device_type() == cuda:
            ops.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                        ev.correlation_id()))
        elif ev.name().startswith(GRAPH_LAUNCHES) and ev.correlation_id():
            launches.add(ev.correlation_id())
    return ops, launches


def split(ops: List[Tuple[int, int, int]], launches: Set[int],
          device_ops: int, phases: List[Tuple[str, int, int]]
          ) -> Optional[dict]:
    """{"replays": the graph launches whose operations number
    `device_ops`, "ms": {phase: device ms summed over them}}, or None
    where there is no such launch."""
    runs: Dict[int, list] = defaultdict(list)
    for start, end, corr in ops:
        if corr in launches:
            runs[corr].append((start, end))
    whole = [run for run in runs.values() if len(run) == device_ops]
    if not whole or not phases:
        return None
    ms: Dict[str, float] = defaultdict(float)
    for run in whole:
        run.sort()
        for name, begin, end in phases:
            ms[name] += sum(e - s for s, e in run[begin:end]) / 1e6
    return {"replays": len(whole), "ms": dict(ms)}


def by_phase(prof, graph) -> Optional[dict]:
    """`split` of a finished profile by the phases of `graph`, a captured
    graph of the program (None where the program keeps no phases)."""
    phases = getattr(graph, "phases", None)
    if not phases:
        return None
    ops, launches = from_profile(prof)
    return split(ops, launches, graph.device_ops, phases)
