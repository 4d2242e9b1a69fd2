"""Device time by span: each device operation of a profiled stretch given
to the innermost of the program's spans (perfbench/spans.py) that was open
when the operation was launched.

The launch is the host's runtime call (`cudaLaunchKernel`,
`cudaMemcpyAsync`, ...) that carries the operation's correlation id.
Autograd launches the backward's kernels from a thread of its own, so a
launch is matched by its time against the spans of the thread that opened
the stretch's root spans (the main thread), not against its own thread's.
An instant of device time counts once: an operation that overlaps those
before it counts only its part past their end, so that the spans' times
add up to the stretch's busy time (perfbench/trace.py `busy_s`).
Operations with no launch found, or launched outside every span of the
main thread, go to "(none)".
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

NONE = "(none)"


def from_profile(prof) -> Tuple[List[Tuple[int, int, int]], Dict[int, int]]:
    """(device operations as (start_ns, end_ns, correlation id),
    {correlation id: launch start_ns}) of a finished torch.profiler
    profile; a launch is a runtime call (`cuda...`, `cu...`)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops, launches = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            continue
        if ev.device_type() == cuda:
            ops.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                        ev.correlation_id()))
        elif ev.name().startswith("cu") and ev.correlation_id():
            launches[ev.correlation_id()] = ev.start_ns()
    return ops, launches


def innermost(spans: Iterable, times: List[int]) -> List[Optional[str]]:
    """For each time (sorted or not), the name of the innermost of the
    properly nested `spans` (name, start_ns, end_ns) open at it, or None."""
    ordered = sorted(spans, key=lambda s: (s[1], -s[2]))
    out: List[Optional[str]] = [None] * len(times)
    stack: list = []
    j = 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(ordered) and ordered[j][1] <= t:
            while stack and stack[-1][2] <= ordered[j][1]:
                stack.pop()
            stack.append(ordered[j])
            j += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out


def attribute(ops: List[Tuple[int, int, int]], launches: Dict[int, int],
              spans: Iterable) -> Dict[str, float]:
    """Device ms by span name: `ops` and `launches` as `from_profile`
    gives them, `spans` the main thread's (name, start_ns, end_ns)."""
    launched_at = [launches.get(corr) for _, _, corr in ops]
    names = innermost(spans, [a or 0 for a in launched_at])
    out: Dict[str, float] = defaultdict(float)
    covered = float("-inf")
    for k in sorted(range(len(ops)), key=lambda k: ops[k][0]):
        start, end = ops[k][0], ops[k][1]
        part = end - max(start, covered)
        covered = max(covered, end)
        if part > 0:
            name = (names[k] if launched_at[k] is not None and names[k]
                    else NONE)
            out[name] += part / 1e6
    return dict(out)


def main_thread_spans(ring: list, root: str) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every span of the thread that opened the
    last `root` span."""
    roots = [s for s in ring if s.name == root and s.parent == 0]
    if not roots:
        return []
    thread = roots[-1].thread
    return [(s.name, s.start_ns, s.end_ns) for s in ring
            if s.thread == thread]


def by_span(prof, root: str = "train_step") -> Optional[Dict[str, float]]:
    """Device ms by innermost span over a finished profile, or None where
    the program keeps no spans or none named `root`."""
    from perfbench import spans as bench_spans
    main = main_thread_spans(bench_spans.ring() or [], root)
    if not main:
        return None
    ops, launches = from_profile(prof)
    return attribute(ops, launches, main)
