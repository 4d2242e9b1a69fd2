"""Plain layers on the (B, C, W=azimuth, H=beams) layout of the published
torch checkpoints: 3x3 convolutions wrap the azimuth and zero-pad the
beams, weights are (O, I, k_azimuth, k_beam)."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Precision

Params = Dict[str, torch.Tensor]

# every attention the reference computes, as (N = batch x heads, D, T),
# while a list is installed here (work.py reads the shapes on the meta
# device)
ATTENTION_SHAPES: Optional[List[Tuple[int, int, int]]] = None


def wrap_azimuth(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Circular padding of the azimuth axis (dim 2) by lo and hi columns."""
    parts = ([x[:, :, x.shape[2] - lo:]] if lo else []) + [x] + (
        [x[:, :, :hi]] if hi else [])
    return torch.cat(parts, dim=2) if len(parts) > 1 else x


def conv(pr: Precision, p: Params, name: str, x: torch.Tensor,
         stride: int = 1, beams: Tuple[int, int] = (1, 1),
         azimuth: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """The convolution `name`: azimuth wrapped, beams zero-padded, then an
    unpadded product."""
    x = wrap_azimuth(x, *azimuth)
    if beams != (0, 0):
        x = F.pad(x, beams)
    return F.conv2d(pr.q(x), pr.q(p[name + ".weight"]), p.get(name + ".bias"),
                    stride)


def conv1x1(pr: Precision, p: Params, name: str,
            x: torch.Tensor) -> torch.Tensor:
    return conv(pr, p, name, x, beams=(0, 0), azimuth=(0, 0))


def linear(pr: Precision, p: Params, name: str,
           x: torch.Tensor) -> torch.Tensor:
    return F.linear(pr.q(x), pr.q(p[name + ".weight"]), p[name + ".bias"])


def group_norm(p: Params, name: str, x: torch.Tensor,
               eps: float) -> torch.Tensor:
    return F.group_norm(x, 32, p[name + ".weight"], p[name + ".bias"], eps)


def attention(pr: Precision, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """softmax(q^T k / sqrt(D)) v^T per head on (N, D, T) operands."""
    if ATTENTION_SHAPES is not None:
        ATTENTION_SHAPES.append(tuple(q.shape))
    logits = torch.einsum("ndt,nds->nts", pr.q(q), pr.q(k)) * (
        q.shape[1] ** -0.5)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("nds,nts->ndt", pr.q(v), pr.q(probs))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' sinusoidal embedding with flip_sin_to_cos and shift 0:
    [cos, sin] of t * 10000^(-i / (dim / 2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    arg = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
