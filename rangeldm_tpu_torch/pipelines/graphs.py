"""One UNet evaluation of the sampling loop, replayed from a CUDA graph.

`samplers.denoise` evaluates the UNet at every step on the same shapes;
only the latent and the timestep change. Issued op by op from Python, an
evaluation of the flagship UNet is about 960 kernel launches, which take
the host longer than the kernels take the card. `GraphedUNet(unet)` is a
`model_fn(x, t)` over one replica's UNet that captures one evaluation per
input shape into a CUDA graph and replays it at every later step: the same
kernels, the hand-written attention kernel among them, issued by one
launch. The pipeline keeps one per replica (`sample_ldm.unet_fns`), so its
graphs outlive the sampler of a call.

It graphs where it can, judging from what it is given: `x` a contiguous
CUDA tensor, `t` a Python integer, grad off (inference mode or no_grad) and
autocast off for CUDA (autocast's cache of cast weights cannot be
captured). Anywhere else it calls the module as it is.

A key (device, shape, dtype) runs eager at its first evaluation, so that
cuDNN's choice of algorithms, the kernels' one-time attributes and the
libraries' lazy set-up happen outside a capture; its second evaluation is
captured, on a side stream of its device, and replayed; every later one is
replayed. A replay copies `x` into the graph's static input, writes `t`
into its static timestep on the device (no copy from the host), replays
and returns a copy of the static output, which the next replay overwrites.
Random draws stay outside: the samplers draw their noise around the model
function. At most MAX_GRAPHS graphs are kept per replica, the least
recently used dropped first, so varied batch sizes do not pile up memory
pools.

Each evaluation records one span, a child of the caller's `unet_eval`:
`unet_graph_replay`, `unet_graph_capture` (the capture and its first
replay) or `unet_eager`. A replay passes through none of the kernels'
Python wrappers, so it adds to `ops.kernels.LAUNCHES` the launches that its
capture counted.
"""

from __future__ import annotations

import collections
from typing import Dict, Tuple

import torch

from rangeldm_tpu_torch.ops import kernels
from rangeldm_tpu_torch.utils.profiling import step_annotation

MAX_GRAPHS = 4


def _graphable(x: torch.Tensor, t) -> bool:
    """Whether an evaluation at (x, t) can be captured and replayed."""
    return (x.is_cuda and x.is_contiguous() and isinstance(t, int)
            and not torch.is_grad_enabled()
            and not torch.is_autocast_enabled("cuda"))


class _Graph:
    """One captured evaluation of `module` at x's shape and dtype: its
    static input, timestep and output, and the hand-written kernels'
    launches that one evaluation counts."""

    def __init__(self, module, x: torch.Tensor):
        self.x = torch.empty_like(x)
        self.t = torch.empty((), dtype=torch.int64, device=x.device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(x.device):
            before = dict(kernels.LAUNCHES)
            with torch.cuda.graph(self.graph,
                                  stream=torch.cuda.Stream(x.device)):
                self.out = module(self.x, self.t)
        self.launches: Dict[str, int] = {
            name: n - before.get(name, 0)
            for name, n in kernels.LAUNCHES.items()
            if n != before.get(name, 0)}

    def run(self, x: torch.Tensor, t: int) -> torch.Tensor:
        with torch.cuda.device(x.device):
            self.x.copy_(x)
            self.t.fill_(t)
            self.graph.replay()
            return self.out.clone()


class GraphedUNet:
    """`model_fn(x, t)` over one UNet replica that replays a captured CUDA
    graph of the evaluation where it can (module docstring)."""

    def __init__(self, module: torch.nn.Module):
        self.module = module
        # key -> _Graph, least recently used first
        self._graphs: "collections.OrderedDict[Tuple, _Graph]" = (
            collections.OrderedDict())
        self._warm = set()          # keys evaluated once, eagerly

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        if not _graphable(x, t):
            with step_annotation("unet_eager"):
                return self.module(x, t)
        key = (x.device, tuple(x.shape), x.dtype)
        graph = self._graphs.get(key)
        if graph is not None:
            with step_annotation("unet_graph_replay"):
                self._graphs.move_to_end(key)
                out = graph.run(x, t)
                for name, n in graph.launches.items():
                    kernels.LAUNCHES[name] = kernels.LAUNCHES.get(name, 0) + n
                return out
        if key not in self._warm:
            self._warm.add(key)
            with step_annotation("unet_eager"):
                return self.module(x, t)
        with step_annotation("unet_graph_capture"):
            graph = self._graphs[key] = _Graph(self.module, x)
            if len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
            return graph.run(x, t)
