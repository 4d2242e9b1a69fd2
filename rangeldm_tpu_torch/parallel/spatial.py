"""Spatial parallelism over the circular azimuth axis, on a local mesh.

The counterpart of the JAX package's `parallel/spatial.py`: an activation
is split into equal azimuth shards, one on each device of a local mesh (a
tuple of devices, `parallel/mesh.py`; a mesh may name one device more than
once), and a circular convolution becomes a halo exchange with the ring
neighbours plus a shard-local convolution. The azimuth axis is a ring, so
the wrap padding of `CircularConv` and the neighbour exchange coincide.

One process drives every shard, as one JAX program drives a `shard_map`:
a halo moves by `.to(neighbour_device, non_blocking=True)`, a peer copy
between cards and no copy at all on one device. Nothing here writes into a
tensor in place: on a mesh that repeats a device, shards may alias.

Layout (B, C, W=azimuth, H=beams); shards split dim 2.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from rangeldm_tpu_torch.models.layers import CircularConv

Shards = List[torch.Tensor]


def shard_azimuth(x: torch.Tensor, mesh: Sequence[torch.device]) -> Shards:
    """`x` split into len(mesh) equal azimuth shards, shard i on mesh[i]."""
    n, w = len(mesh), x.shape[2]
    if w % n:
        raise ValueError(f"azimuth width {w} does not divide over {n} "
                         f"shards")
    return [c.to(d) for c, d in zip(x.chunk(n, dim=2), mesh)]


def gather_azimuth(shards: Shards, device: torch.device) -> torch.Tensor:
    """The shards put back together along the azimuth, on `device`."""
    return torch.cat([s.to(device) for s in shards], dim=2)


def halo_exchange_w(shards: Shards, lo: int, hi: int) -> Shards:
    """Each shard with `lo` columns of its left ring neighbour before it and
    `hi` of its right after it, wrap-around included, so that the global
    result is circular padding."""
    n = len(shards)
    width = min(s.shape[2] for s in shards)
    if lo > width or hi > width:
        raise ValueError(f"a halo of ({lo}, {hi}) columns is wider than a "
                         f"shard of {width}")
    out = []
    for i, x in enumerate(shards):
        parts = []
        if lo:
            parts.append(shards[(i - 1) % n][:, :, -lo:].to(
                x.device, non_blocking=True))
        parts.append(x)
        if hi:
            parts.append(shards[(i + 1) % n][:, :, :hi].to(
                x.device, non_blocking=True))
        out.append(torch.cat(parts, dim=2) if len(parts) > 1 else x)
    return out


def halo_conv_local(shards: Shards, conv: CircularConv) -> Shards:
    """`conv` applied to an azimuth-sharded activation, shard by shard: a
    halo of the conv's own azimuth padding (w_lo, w_hi), zeros (h_lo, h_hi)
    on the beams, the conv's stride, its weight and bias as they are. One
    path for the 3x3 convs, the 1x1 shortcuts (halo 0) and the asymmetric
    stride-2 downsample ((0, 1), (0, 1)): each shard's outputs are the
    global output's columns of that shard when its width divides by the
    stride and it gives width / stride columns."""
    if conv.coord:
        raise NotImplementedError("coordconv is not supported sharded")
    if not conv.circular and (conv.w_lo or conv.w_hi):
        raise NotImplementedError(
            "a sharded conv needs circular azimuth padding (the ring halo "
            "exchange is wrap padding)")
    k, s = conv.weight.shape[2], conv.stride[0]
    for x in shards:
        w = x.shape[2]
        if w % s or (w + conv.w_lo + conv.w_hi - k) // s + 1 != w // s:
            raise ValueError(
                f"a shard of azimuth width {w} does not map onto whole "
                f"output columns of a conv with kernel {k}, stride {s} and "
                f"halo ({conv.w_lo}, {conv.w_hi})")
    out = []
    for x in halo_exchange_w(shards, conv.w_lo, conv.w_hi):
        weight = conv.weight.to(x.device)
        bias = None if conv.bias is None else conv.bias.to(x.device)
        out.append(F.conv2d(F.pad(x, (conv.h_lo, conv.h_hi)), weight, bias,
                            conv.stride))
    return out


def sharded_circular_conv2d(x: torch.Tensor, conv: CircularConv,
                            mesh: Sequence[torch.device]) -> torch.Tensor:
    """`conv(x)` computed over `mesh` with `x` split on the azimuth: shard,
    halo exchange and local conv, gather onto x's device."""
    return gather_azimuth(halo_conv_local(shard_azimuth(x, mesh), conv),
                          x.device)
