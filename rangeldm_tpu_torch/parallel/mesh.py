"""Data parallelism over torch.distributed, in place of the JAX package's
`data` mesh axis (rangeldm_tpu/parallel/mesh.py).

Training runs one process per GPU under torchrun (`python -m
torch.distributed.run --nproc_per_node N -m rangeldm_tpu_torch.train_ldm
...`). Each rank loads its own slice of every epoch (`RangeLoader(...,
shard_by_process=True)`) at the config's batch, so the global batch is
batch x world, as with the JAX package's per-process loaders; gradients
are averaged over the ranks with one all-reduce of a flattened buffer
(`all_reduce_mean_`), which equals JAX's mean over the global array.
Without WORLD_SIZE in the environment nothing here starts a group and a
CLI runs as one process on one device.

Sampling splits its work on two levels, as the JAX package does: the
sample range over the processes (`process_shard`), and each batch over a
local mesh, a tuple of this process's devices (`local_devices`,
`largest_divisible_prefix`), one model replica on each; one device is a
mesh of one.
"""

from __future__ import annotations

import os
from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist


def distributed() -> bool:
    """Whether a process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def process_shard() -> Tuple[int, int]:
    """(rank, world size) of this process: the process group's when one is
    initialized, else torchrun's RANK and WORLD_SIZE when they are set
    (the sampling CLIs need no group), else (0, 1)."""
    if distributed():
        return dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" in os.environ:
        return int(os.environ.get("RANK", 0)), int(os.environ["WORLD_SIZE"])
    return 0, 1


def is_primary() -> bool:
    """Rank 0, the one process that writes shared files."""
    return process_shard()[0] == 0


def default_cuda_device() -> torch.device:
    """The card of this process: cuda:{LOCAL_RANK} under torchrun, which
    must exist (a rank is never moved to another card), else the current
    CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    if "WORLD_SIZE" not in os.environ:
        return torch.device("cuda", torch.cuda.current_device())
    local = int(os.environ.get("LOCAL_RANK", 0))
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK {local} has no card: {torch.cuda.device_count()} "
            f"visible; start at most that many processes per node, or pass "
            f"--device")
    return torch.device("cuda", local)


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device, which must exist: cuda:{LOCAL_RANK}
    under torchrun, else the current one; "cpu" must be asked for
    explicitly."""
    if device is None:
        return default_cuda_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    return dev


def init_distributed(device: torch.device, backend: str = None
                     ) -> Tuple[int, int]:
    """Join the process group torchrun describes in the environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT); returns (rank, world size).
    The backend is NCCL for a CUDA device and gloo for the CPU unless
    `backend` names one (gloo also all-reduces CUDA tensors, through the
    host, where NCCL refuses two ranks on one card). Without WORLD_SIZE,
    or with a group already up, it starts nothing."""
    if "WORLD_SIZE" in os.environ and not distributed():
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method="env://")
    return process_shard()


def barrier(tag: str) -> None:
    """Wait for every rank (no-op without a group); `tag` names the point
    in the error if a rank fails to arrive."""
    if not distributed():
        return
    kw = {}
    if dist.get_backend() == "nccl":
        kw["device_ids"] = [torch.cuda.current_device()]
    try:
        dist.barrier(**kw)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r} failed") from e


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average `tensors` over the ranks in place, with one all-reduce of
    one flattened buffer (no-op without a group). All tensors share one
    dtype and device."""
    tensors = list(tensors)
    if not distributed() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    for t, f in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(f.view_as(t))


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose gradient is the sum over the ranks of
    the incoming gradients, so that each rank differentiates the sum of
    every rank's loss."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable (x without a group)."""
    return _AllReduceSum.apply(x) if distributed() else x


def global_draw(draw: Callable[[tuple], torch.Tensor],
                shape: Sequence[int]) -> torch.Tensor:
    """This rank's rows of a draw for the global batch: `draw(shape)` with
    the batch axis times the world size, from the step's generator (equal
    on every rank), sliced to this rank's rows. N ranks then draw what one
    process draws for the global batch; one process draws `shape`."""
    rank, world = process_shard()
    if world == 1:
        return draw(tuple(shape))
    b = shape[0]
    return draw((b * world, *shape[1:]))[rank * b:(rank + 1) * b]


_HOST_GROUP = None     # gloo beside an NCCL group, made at first use


def any_rank(flag: bool) -> bool:
    """Whether `flag` is set on any rank (`flag` without a group): one MAX
    all-reduce of one int over gloo on the host, so that it waits for no
    card's queue. Every rank calls it at the same point of its loop."""
    global _HOST_GROUP
    if not distributed():
        return bool(flag)
    group = None
    if dist.get_backend() != "gloo":
        if _HOST_GROUP is None:
            _HOST_GROUP = dist.new_group(backend="gloo")
        group = _HOST_GROUP
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite `tensors` with rank `src`'s (no-op without a group)."""
    if distributed():
        for t in tensors:
            dist.broadcast(t, src)


def local_devices(device: torch.device) -> Tuple[torch.device, ...]:
    """The devices a local mesh may use, `device` first: every visible card
    for a CUDA device in a process that owns the node; `device` alone on
    the CPU or under torchrun, where each rank owns one card."""
    device = torch.device(device)
    if device.type != "cuda" or "WORLD_SIZE" in os.environ:
        return (device,)
    first = (device.index if device.index is not None
             else torch.cuda.current_device())
    return (device,) + tuple(
        torch.device("cuda", i) for i in range(torch.cuda.device_count())
        if i != first)


def largest_divisible_prefix(n: int, batch_size: int) -> int:
    """Largest k <= n with batch_size % k == 0 — THE 'auto' inference-mesh
    policy (`pipelines.pipeline.resolve_sampling_mesh`, which the sampling
    CLIs and RangePipeline's mesh="auto" share)."""
    if batch_size <= 0:
        # 0 % k == 0 for every k, so a degenerate batch would silently
        # select the FULL mesh; fail at the policy layer instead
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    n = int(n)
    while n > 1 and batch_size % n:
        n -= 1
    return max(n, 1)


def split_batch(x: torch.Tensor, mesh: Sequence[torch.device]
                ) -> List[torch.Tensor]:
    """`x`'s batch chunks, one on each device of `mesh` (the batch divides
    over it: `pipelines.pipeline.sampling_mesh` checks)."""
    return [c.to(d) for c, d in zip(x.chunk(len(mesh)), mesh)]
