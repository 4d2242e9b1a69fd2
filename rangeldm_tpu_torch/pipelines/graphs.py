"""One UNet evaluation of the sampling loop, replayed from a CUDA graph.

`samplers.denoise` evaluates the UNet at every step on the same shapes;
only the latent and the timestep change. Issued op by op from Python, an
evaluation of the flagship UNet is about 960 kernel launches, which take
the host longer than the kernels take the card. `GraphedUNet(unet)` is a
`model_fn(x, t)` over one replica's UNet that captures one evaluation per
input shape into a CUDA graph and replays it at every later step: the same
kernels, the hand-written attention kernel among them, issued by one
launch. The pipeline keeps one per replica (`pipeline.replicas`), so its
graphs outlive the sampler of a call.

It graphs where it can, judging from what it is given: `x` a contiguous
CUDA tensor, `t` a Python integer, grad off (inference mode or no_grad) and
autocast off for CUDA (autocast's cache of cast weights cannot be
captured). Anywhere else it calls the module as it is.

A key (device, shape, dtype) runs eager at its first evaluation, is
captured at its second and replayed at every later one, at most MAX_GRAPHS
keys a replica (utils/graphs.py `GraphCache`, which the training step
shares). A replay copies `x` into the graph's static input, writes `t` into
its static timestep on the device (no copy from the host), replays and
returns a copy of the static output, which the next replay overwrites.
Random draws stay outside: the samplers draw their noise around the model
function.

Each evaluation records one span, a child of the caller's `unet_eval`:
`unet_graph_replay`, `unet_graph_capture` (the capture and its first
replay) or `unet_eager`; a replay adds to `ops.kernels.LAUNCHES` the
launches that its capture counted.
"""

from __future__ import annotations

import torch

from rangeldm_tpu_torch.utils.graphs import MAX_GRAPHS, Captured, GraphCache
from rangeldm_tpu_torch.utils.profiling import step_annotation


def _graphable(x: torch.Tensor, t) -> bool:
    """Whether an evaluation at (x, t) can be captured and replayed."""
    return (x.is_cuda and x.is_contiguous() and isinstance(t, int)
            and not torch.is_grad_enabled()
            and not torch.is_autocast_enabled("cuda"))


class _Graph(Captured):
    """One captured evaluation of `module` at x's shape and dtype, with
    its static input and timestep."""

    def __init__(self, module, x: torch.Tensor):
        self.x = torch.empty_like(x)
        self.t = torch.empty((), dtype=torch.int64, device=x.device)
        super().__init__(lambda: module(self.x, self.t), x.device)

    def run(self, x: torch.Tensor, t: int) -> torch.Tensor:
        self.x.copy_(x)
        self.t.fill_(t)
        self.replay()
        return self.out.clone()


class GraphedUNet(GraphCache):
    """`model_fn(x, t)` over one UNet replica that replays a captured CUDA
    graph of the evaluation where it can (module docstring)."""

    def __init__(self, module: torch.nn.Module):
        super().__init__("unet")
        self.module = module

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        if not _graphable(x, t):
            with step_annotation("unet_eager"):
                return self.module(x, t)
        return self.run((x.device, tuple(x.shape), x.dtype),
                        eager=lambda: self.module(x, t),
                        capture=lambda: _Graph(self.module, x),
                        replay=lambda graph: graph.run(x, t))
