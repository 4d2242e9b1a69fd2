"""Profiling hooks and the program's spans: host time by layer.

The JAX package's hooks (rangeldm_tpu/utils/profiling.py) on
torch.profiler:

    with maybe_trace("runs/x/trace", enabled=cfg.get("profile")):
        with step_annotation("vae_encode"):
            ...
    trace_op_breakdown("runs/x/trace", {"attention": ("attention",)})
    device_memory_stats()

`step_annotation(name)` is the program's span. Each records its name, an
id, its parent's id (0 for a root; from a stack local to the thread), the
thread and its start and end in `time.time_ns()` into a ring of the last
RING_LEN spans. While a profiler runs, a span also enters a
`_RecordFunctionFast` range: a host event of the trace (category
`cpu_op`, not a user annotation) on the same clock as the ring. With no
profiler a span costs two clock reads, a check that no profiler runs and
one tuple appended to the ring (about 1 us). Spans sit at layer
boundaries only:

    sample_call > unet_eval (> unet_graph_replay, unet_graph_capture or
                  unet_eager), sampler_update, vae_decode, to_host
    train_step > batch_wait (> loader_wait), to_device, one of
                 train_graph_replay, train_graph_capture or train_eager
                 (the last two > encode, forward, backward, clip, adamw,
                 ema), log_sync, checkpoint, sample_dump
    trainer_init > build_models, optimizer, ema_clone

`spans()` reads the ring, `span_summary()` sums it by name beside
`ops.kernels.LAUNCHES`, the launch counter of the hand-written kernels.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import itertools
import json
import os
import re
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

TOP = 20
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


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str], enabled: bool = False):
    """A torch.profiler trace of the block, the host's operators and, where
    there is a card, its kernels, written under `log_dir` as a Chrome trace
    (`<worker>.<ms>.pt.trace.json`: plain JSON, no TensorBoard package
    needed). Nothing when disabled or without a directory."""
    if not enabled or not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


# -- spans ------------------------------------------------------------------

RING_LEN = 65536


class Span(NamedTuple):
    """One finished span: `parent` is the id of the span that was open on
    the same thread when it began (0 for a root); times are
    `time.time_ns()`, the clock of torch.profiler's Kineto events."""
    name: str
    id: int
    parent: int
    thread: int
    start_ns: int
    end_ns: int


# finished spans as plain tuples in Span's field order, oldest first
_RING: "collections.deque[tuple]" = collections.deque(maxlen=RING_LEN)
_IDS = itertools.count(1)
_FAST = torch._C._profiler._RecordFunctionFast
_PROFILING = torch._C._autograd._profiler_enabled
_LOCAL = threading.local()


def _thread() -> tuple:
    """(the ids of the spans open on this thread, innermost last; the
    thread's id). A plain thread-local read is faster than an attribute of
    a threading.local subclass."""
    try:
        return _LOCAL.state
    except AttributeError:
        _LOCAL.state = ([], threading.get_ident())
        return _LOCAL.state


class step_annotation:
    """A span around a block: `with step_annotation("adamw"): ...`. It is
    appended to the ring when the block ends, unless `discard()` was
    called; while a profiler runs it also enters a fast record-function
    range, which torch.profiler traces as a host event."""

    __slots__ = ("name", "id", "parent", "start", "_thread", "_range",
                 "_keep")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "step_annotation":
        thread = self._thread = _thread()
        stack = thread[0]
        self.parent = stack[-1] if stack else 0
        self.id = next(_IDS)
        stack.append(self.id)
        self._keep = True
        self._range = _FAST(self.name) if _PROFILING() else None
        if self._range is not None:
            self._range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = time.time_ns()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        stack, ident = self._thread
        stack.pop()
        if self._keep:
            _RING.append((self.name, self.id, self.parent, ident,
                          self.start, end))

    def discard(self) -> None:
        """Record nothing of this span (an exhausted iterator's last pull
        is no step)."""
        self._keep = False


def record_span(name: str, start_ns: int, end_ns: int) -> None:
    """Append a span the caller timed itself with `time.time_ns()`, as a
    child of the span open on this thread; it makes no trace event."""
    stack, ident = _thread()
    _RING.append((name, next(_IDS), stack[-1] if stack else 0, ident,
                  start_ns, end_ns))


def spans() -> List[Span]:
    """The ring, oldest first."""
    return [Span(*t) for t in list(_RING)]


def _nearest_rank(ordered: List[float], q: float) -> float:
    return ordered[max(1, -(-len(ordered) * q // 100)) - 1]


def span_summary(names: Optional[Iterable[str]] = None) -> dict:
    """{"spans": {name: {"count", "total_ms", "self_ms", "p50_ms",
    "p95_ms"}}, "launches": the hand-written kernels' launch counts} over
    the ring, for the names given (default every name in it). A span's
    self time is its duration less its children's."""
    from rangeldm_tpu_torch.ops.kernels import LAUNCHES

    ring = spans()
    child_ns: Dict[int, int] = defaultdict(int)
    for s in ring:
        if s.parent:
            child_ns[s.parent] += s.end_ns - s.start_ns
    durations, selves = defaultdict(list), defaultdict(int)
    for s in ring:
        durations[s.name].append(s.end_ns - s.start_ns)
        selves[s.name] += s.end_ns - s.start_ns - child_ns.get(s.id, 0)
    wanted = list(durations) if names is None else [
        n for n in names if n in durations]
    out = {}
    for name in wanted:
        ordered = sorted(durations[name])
        out[name] = {"count": len(ordered), "total_ms": sum(ordered) / 1e6,
                     "self_ms": selves[name] / 1e6,
                     "p50_ms": _nearest_rank(ordered, 50) / 1e6,
                     "p95_ms": _nearest_rank(ordered, 95) / 1e6}
    return {"spans": out, "launches": dict(LAUNCHES)}


# Chrome-trace categories of the device's work
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _outermost(events: list) -> list:
    """The events of a host trace not nested in another on their thread,
    so that their durations add up without counting a child twice."""
    out, ends = [], {}
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        key = (e.get("pid"), e.get("tid"))
        if e["ts"] >= ends.get(key, float("-inf")):
            out.append(e)
            ends[key] = e["ts"] + e["dur"]
    return out


def trace_op_breakdown(trace_dir: str, groups: Optional[dict] = None
                       ) -> dict:
    """The newest trace `maybe_trace` wrote under `trace_dir`, as time by op
    group: {"plane", "total_ms", "groups": {g: ms}, "events": {g: count},
    "top_ops": [[name, ms], ...]}.

    groups: {group: (name substring, ...)}; an op whose name holds one of
    the substrings (case-insensitive) counts in that group, the first
    matching group only. Without it, the groups of `GROUPS` and "other"
    (`group_of`). The device's kernels, copies and sets where the trace has
    any (plane "/device:cuda:<index>"), else the host's outermost
    operators (plane "/host:cpu"), as the JAX package falls back to its
    host plane: fine for tests, not for claims. The program's spans are
    host events too; the fallback leaves out every name the ring holds."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace .json under {trace_dir}")
    with open(paths[-1]) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in _DEVICE_CATEGORIES]
    if device:
        plane = f"/device:cuda:{device[0].get('args', {}).get('device', 0)}"
    else:
        span_names = {t[0] for t in list(_RING)}
        device = _outermost([e for e in events if e.get("cat") == "cpu_op"
                             and e["name"] not in span_names])
        plane = "/host:cpu"
    if not device:
        raise ValueError(f"no device or host operator in {paths[-1]}")
    per_op, counts = defaultdict(float), defaultdict(int)
    for e in device:
        per_op[e["name"]] += e["dur"] / 1e3
        counts[e["name"]] += 1
    if groups is None:
        names, group = [g for g, _ in GROUPS] + ["other"], group_of
    else:
        names = list(groups)

        def group(name: str) -> Optional[str]:
            low = name.lower()
            return next((g for g, subs in groups.items()
                         if any(sub.lower() in low for sub in subs)), None)
    out_groups, out_events = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for name, ms in per_op.items():
        g = group(name)
        if g is not None:
            out_groups[g] += ms
            out_events[g] += counts[name]
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    return {"plane": plane, "total_ms": round(sum(per_op.values()), 3),
            "groups": {g: round(v, 3) for g, v in out_groups.items()},
            "events": out_events,
            "top_ops": [[n, round(ms, 3)] for n, ms in top]}


def device_memory_stats() -> dict:
    """For each visible card, {"cuda:<i>": {"name", "bytes_in_use",
    "bytes_limit", "peak_bytes_in_use"}}: the caching allocator's bytes in
    use and their peak, and the card's memory; {} without a card."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "name": torch.cuda.get_device_name(i),
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}
    return out


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
