"""CUDA graphs of repeated calls: one capture per key, replayed after.

The sampling loop's UNet evaluation (pipelines/graphs.py `GraphedUNet`)
and the training step (training/ldm_trainer.py) run the same work on the
same shapes again and again. Issued op by op from Python, that work is
thousands of kernel launches, which take the host longer than the kernels
take the card. Both callers keep a `GraphCache`:

* a key's first call runs eager, so that cuDNN's choice of algorithms,
  the kernels' one-time attributes, the libraries' lazy set-up and any
  state made at first use (device tables, optimizer moments) happen
  outside a capture;
* its second call is captured (`Captured`, on a side stream of its
  device) and replayed;
* every later call is replayed.

At most MAX_GRAPHS graphs are kept, the least recently used dropped first,
so that varied shapes do not pile up memory pools. Each call records one
span, `<name>_graph_replay`, `<name>_graph_capture` (the capture and its
first replay) or `<name>_eager`. A replay passes through none of the
hand-written kernels' Python wrappers, so it adds to `ops.kernels.LAUNCHES`
the launches that its capture counted.

A replay leaves no host spans, and a profiler files all of its work under
the one launch of the graph. So the capture keeps where each span's work
lies in the graph (`Captured.phases`): the spans opened while capturing
(encode, condition, forward, ...), each with the number of device
operations (kernel, copy and set nodes) the graph held as it began and as
it ended. A one-stream capture is a chain, which a replay runs in the
order of capture, so the operations of a replay's trace in order of start
split by these counts (perfbench/graph_phases.py).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Callable, Dict, Hashable, Iterable, List, Tuple

import torch

from rangeldm_tpu_torch.ops import kernels
from rangeldm_tpu_torch.utils.profiling import observe_spans, step_annotation

MAX_GRAPHS = 4
# CUgraphNodeType of the nodes that run on the device as one operation
# each: kernel, memcpy, memset (cuda.h)
DEVICE_NODE_TYPES = (0, 1, 2)


@functools.lru_cache(maxsize=None)
def _driver() -> ctypes.CDLL:
    """The CUDA driver's library, with the entry points the capture's
    bookkeeping calls."""
    lib = ctypes.CDLL("libcuda.so.1")
    p, u = ctypes.c_void_p, ctypes.POINTER
    lib.cuStreamGetCaptureInfo_v2.argtypes = [p, u(ctypes.c_int), p, u(p),
                                              p, p]
    lib.cuGraphGetNodes.argtypes = [p, p, u(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [p, u(ctypes.c_int)]
    for fn in (lib.cuStreamGetCaptureInfo_v2, lib.cuGraphGetNodes,
               lib.cuGraphNodeGetType):
        fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUresult {err}")


class _NodeCounter:
    """The device operations a stream's capture holds so far."""

    def __init__(self, stream: torch.cuda.Stream):
        self.lib = _driver()
        status = ctypes.c_int()
        graph = ctypes.c_void_p()
        _check(self.lib.cuStreamGetCaptureInfo_v2(
            stream.cuda_stream, ctypes.byref(status), None,
            ctypes.byref(graph), None, None), "cuStreamGetCaptureInfo")
        if status.value != 1:           # CU_STREAM_CAPTURE_STATUS_ACTIVE
            raise RuntimeError("the stream is not capturing")
        self.graph = graph
        self.ops = 0
        self.seen = 0

    def __call__(self) -> int:
        """Nodes are only added while capturing: each is typed once."""
        n = ctypes.c_size_t()
        _check(self.lib.cuGraphGetNodes(self.graph, None, ctypes.byref(n)),
               "cuGraphGetNodes")
        if n.value > self.seen:
            nodes = (ctypes.c_void_p * n.value)()
            _check(self.lib.cuGraphGetNodes(self.graph, nodes,
                                            ctypes.byref(n)),
                   "cuGraphGetNodes")
            kind = ctypes.c_int()
            for node in nodes[self.seen:n.value]:
                _check(self.lib.cuGraphNodeGetType(node, ctypes.byref(kind)),
                       "cuGraphNodeGetType")
                self.ops += kind.value in DEVICE_NODE_TYPES
            self.seen = n.value
        return self.ops


class Captured:
    """One call of `fn()` captured into a CUDA graph on a side stream of
    `device`. `out` is what the call returned: static tensors that every
    replay overwrites. `launches` counts the hand-written kernels' launches
    of the call. The default generator is registered by every capture;
    `generators` are registered beside it, so that a replay draws what the
    call would have drawn at the generators' state and advances them as
    the call would have. `phases` lists (span name, device operations
    before it, device operations at its end) for each span the call
    opened, in the order they ended, and `device_ops` the graph's device
    operations (module docstring)."""

    def __init__(self, fn: Callable, device: torch.device,
                 generators: Iterable[torch.Generator] = ()):
        self.device = device
        self.phases: List[Tuple[str, int, int]] = []
        self.device_ops = 0
        before = dict(kernels.LAUNCHES)
        self.out = self._capture(fn, generators)
        self.launches: Dict[str, int] = {
            name: n - before.get(name, 0)
            for name, n in kernels.LAUNCHES.items()
            if n != before.get(name, 0)}

    def _capture(self, fn: Callable, generators):
        """The capture itself: `fn()` recorded, not run."""
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        stream = torch.cuda.Stream(self.device)
        with torch.cuda.device(self.device):
            with torch.cuda.graph(self.graph, stream=stream):
                count = _NodeCounter(stream)
                open_at: list = []

                def observe(name: str, entering: bool) -> None:
                    if entering:
                        open_at.append(count())
                    elif open_at:
                        self.phases.append((name, open_at.pop(), count()))

                with observe_spans(observe):
                    out = fn()
                self.device_ops = count()
                return out

    def replay(self) -> None:
        """Launch the graph on the current stream of its device."""
        with torch.cuda.device(self.device):
            self.graph.replay()


class GraphCache:
    """The graphs of one caller by key (module docstring); spans named
    after `name`."""

    def __init__(self, name: str):
        self.spans = tuple(f"{name}_{kind}" for kind in (
            "graph_replay", "graph_capture", "eager"))
        # key -> graph, least recently used first
        self._graphs: "collections.OrderedDict[Hashable, object]" = (
            collections.OrderedDict())
        self._warm = set()          # keys called once, eagerly

    def clear(self) -> None:
        self._graphs.clear()
        self._warm.clear()

    def captured(self) -> list:
        """The graphs kept, least recently used first."""
        return list(self._graphs.values())

    def run(self, key: Hashable, eager: Callable, capture: Callable,
            replay: Callable):
        """`eager()` at the key's first call; `replay(capture())` at its
        second, keeping the graph; `replay(graph)` after. A graph is
        anything with `launches`, a dict of the kernels' launches its
        capture counted."""
        replay_span, capture_span, eager_span = self.spans
        graph = self._graphs.get(key)
        if graph is not None:
            with step_annotation(replay_span):
                self._graphs.move_to_end(key)
                out = replay(graph)
                for name, n in graph.launches.items():
                    kernels.LAUNCHES[name] = kernels.LAUNCHES.get(name, 0) + n
                return out
        if key not in self._warm:
            self._warm.add(key)
            with step_annotation(eager_span):
                return eager()
        with step_annotation(capture_span):
            graph = self._graphs[key] = capture()
            if len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
            return replay(graph)
