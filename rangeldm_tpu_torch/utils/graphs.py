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
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Hashable, Iterable

import torch

from rangeldm_tpu_torch.ops import kernels
from rangeldm_tpu_torch.utils.profiling import step_annotation

MAX_GRAPHS = 4


class Captured:
    """One call of `fn()` captured into a CUDA graph on a side stream of
    `device`. `out` is what the call returned: static tensors that every
    replay overwrites. `launches` counts the hand-written kernels' launches
    of the call. The default generator is registered by every capture;
    `generators` are registered beside it, so that a replay draws what the
    call would have drawn at the generators' state and advances them as
    the call would have."""

    def __init__(self, fn: Callable, device: torch.device,
                 generators: Iterable[torch.Generator] = ()):
        self.device = device
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
        with torch.cuda.device(self.device):
            with torch.cuda.graph(self.graph,
                                  stream=torch.cuda.Stream(self.device)):
                return fn()

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
