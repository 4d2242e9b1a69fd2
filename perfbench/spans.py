"""The program's spans, as the per-layer metrics of host time read them.

The program keeps its last spans in a ring (rangeldm_tpu_torch/utils/
profiling.py `spans()`): name, id, parent id (0 for a root), thread,
start and end in `time.time_ns()`. A run of the harness makes the set-up,
then the unprofiled window, then the profiled stretch, in that order; so
of the last `unprofiled.units + units` root spans of the cell's unit
(`sample_call` or `train_step`), the first `unprofiled.units` are the
window's, timed without the profiler's host overhead.

`window` returns None where the program keeps no spans (an older
program) or the ring holds too few roots; each reader then returns None.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional


def ring() -> Optional[list]:
    """The program's spans, oldest first, or None where it keeps none."""
    try:
        from rangeldm_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def window(record: dict, root: str
           ) -> Optional[List[Dict[str, List[float]]]]:
    """For each unit of the unprofiled window, {name: [ms, ...]}: the
    durations of the root span's descendants by name, and the root's own
    under `root`."""
    spans = ring()
    un = record.get("unprofiled") or {}
    n, m = int(un.get("units") or 0), int(record.get("units") or 0)
    if spans is None or n < 1:
        return None
    roots = [s for s in spans if s.name == root and s.parent == 0]
    if len(roots) < n + m:
        return None
    chosen = roots[len(roots) - n - m:][:n]
    parent = {s.id: s.parent for s in spans}
    units = {r.id: defaultdict(list) for r in chosen}
    for s in spans:
        top = s.id
        while parent.get(top, 0):
            top = parent[top]
        if top in units:
            units[top][s.name].append((s.end_ns - s.start_ns) / 1e6)
    return [dict(units[r.id]) for r in chosen]


def sums(record: dict, root: str, names) -> Optional[List[float]]:
    """Per unit of the window, the ms of the spans named `names` in it."""
    units = window(record, root)
    if units is None:
        return None
    return [sum(sum(u.get(name, ())) for name in names) for u in units]
