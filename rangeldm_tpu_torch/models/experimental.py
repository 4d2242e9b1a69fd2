"""Experimental modules of the reference's research surface, the
counterpart of the JAX package's models/experimental.py. No shipped config
builds them.

  * `EdgeConv` / `EdgeConvResnetBlock` / `range_downsample`
    (vae/sgm/modules/diffusionmodules/model.py:127-299): a graph-style conv
    over the rolled 3x3 neighbourhoods with range positional encodings,
    and a 2x2 pooling that keeps the pixel whose range is nearest the
    block's mean.
  * `PerRowConv`: an exploratory conv with its own 2D filter for every beam
    row (not the reference's SlicedConv, which is in models/sliced.py).
  * `SparseRangeImageEncoder` (ldm/encoders.py:58-84): the learned
    condition encoder, two circular convs of stride 2 on the azimuth (the
    shipped configs use the parameter-free pixel unshuffle,
    layers.PixelUnshuffleAzimuth).

Layout (B, C, W=azimuth, H=beams): a roll on (beams, azimuth) is on dims
(3, 2); a range image `r` is (B, 1, W, H).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rangeldm_tpu_torch.models.layers import (
    CircularConv, group_norm, nonlinearity,
)


class EdgeConv(nn.Module):
    """The max over the 3x3 rolled neighbourhoods of
    mlp([x_shifted, x, pe]) (model.py:177-231), pe the shifted point's
    position relative to the centre from the ranges and the beam (`inc`)
    and azimuth (`azi`) steps in radians."""

    def __init__(self, in_channels: int, out_channels: int, azi: float,
                 inc: float, act: str = "relu"):
        super().__init__()
        self.azi, self.inc = azi, inc
        self.mlp = nn.Sequential(
            CircularConv(2 * in_channels + 3, out_channels, 1, 1, 0,
                         circular=False),
            {"relu": nn.ReLU, "silu": nn.SiLU}[act](),
            CircularConv(out_channels, out_channels, 1, 1, 0,
                         circular=False))

    def forward(self, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        out = None
        for shift_h in (-1, 0, 1):          # beams
            for shift_w in (-1, 0, 1):      # azimuth
                x_s = torch.roll(x, (shift_h, shift_w), dims=(3, 2))
                r_s = torch.roll(r, (shift_h, shift_w), dims=(3, 2))
                ca, sa = math.cos(shift_w * self.azi), math.sin(
                    shift_w * self.azi)
                ci, si = math.cos(shift_h * self.inc), math.sin(
                    shift_h * self.inc)
                feat = torch.cat([x_s, x, r_s * (ca * ci) - r,
                                  r_s * (ca * si), r_s * sa], dim=1)
                h = self.mlp(feat)
                out = h if out is None else torch.maximum(out, h)
        return out


class EdgeConvResnetBlock(nn.Module):
    """model.py:234-299: GN -> act -> EdgeConv -> GN -> act -> dropout ->
    EdgeConv, a 1x1 `nin_shortcut` on a channel change."""

    def __init__(self, in_channels: int, out_channels: int, azi: float,
                 inc: float, dropout: float = 0.0, act: str = "relu"):
        super().__init__()
        self.act = act
        self.norm1 = group_norm(in_channels)
        self.conv1 = EdgeConv(in_channels, out_channels, azi, inc, act)
        self.norm2 = group_norm(out_channels)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = EdgeConv(out_channels, out_channels, azi, inc, act)
        if in_channels != out_channels:
            self.nin_shortcut = CircularConv(in_channels, out_channels, 1, 1,
                                             0, circular=False)

    def forward(self, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        h = self.conv1(nonlinearity(self.norm1(x), self.act), r)
        h = self.dropout(nonlinearity(self.norm2(h), self.act))
        h = self.conv2(h, r)
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


def range_downsample(x: torch.Tensor, r: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2 pooling of (x, r) that keeps, in each block, the pixel whose
    range lies nearest the block's mean (model.py:127-148); ties go to the
    first pixel in (beam, azimuth) order, as in the JAX package."""
    b, c, w, h = x.shape

    def blocks(t):         # (B, C, W/2, H/2, 4), index 2 * d_beam + d_azi
        t = t.reshape(t.shape[0], t.shape[1], w // 2, 2, h // 2, 2)
        return t.permute(0, 1, 2, 4, 5, 3).reshape(
            t.shape[0], t.shape[1], w // 2, h // 2, 4)

    xb, rb = blocks(x), blocks(r)
    idx = torch.argmin((rb - rb.mean(-1, keepdim=True)) ** 2, dim=-1,
                       keepdim=True)
    r_out = torch.take_along_dim(rb, idx, dim=-1)[..., 0]
    x_out = torch.take_along_dim(xb, idx.expand(b, c, -1, -1, 1),
                                 dim=-1)[..., 0]
    return x_out, r_out


class PerRowConv(nn.Module):
    """Every one of the `height` beam rows has its own k x k filter over a
    neighbourhood circular on the azimuth and zero-padded on the beams.
    `weight` is (height, out, in, k_azimuth, k_beam), each row's the torch
    conv layout; `bias` (height, out)."""

    def __init__(self, in_channels: int, out_channels: int, height: int,
                 kernel_size: int = 3):
        super().__init__()
        k = kernel_size
        self.kernel_size = k
        self.weight = nn.Parameter(torch.empty(height, out_channels,
                                               in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(height, out_channels))
        bound = 1.0 / math.sqrt(in_channels * k * k)
        nn.init.uniform_(self.weight, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, pad = self.kernel_size, self.kernel_size // 2
        xp = F.pad(F.pad(x, (pad, pad)), (0, 0, pad, pad), mode="circular")
        # (B, C, W, H, k_azimuth, k_beam) windows
        windows = xp.unfold(2, k, 1).unfold(3, k, 1)
        y = torch.einsum("bcwhij,hocij->bowh", windows, self.weight)
        return y + self.bias.t()[None, :, None, :]


class SparseRangeImageEncoder(nn.Module):
    """ldm/encoders.py:58-84: two 3x3 convs of stride 2 on the azimuth,
    padded circular (0, 1) on the azimuth and with zeros (1, 1) on the
    beams, a SiLU between them."""

    def __init__(self, in_channels: int = 2, outdim: int = 4,
                 middle: int = 32):
        super().__init__()
        self.conv1 = CircularConv(in_channels, middle, 3, (2, 1),
                                  ((1, 1), (0, 1)), circular=True)
        self.conv2 = CircularConv(middle, outdim, 3, (2, 1),
                                  ((1, 1), (0, 1)), circular=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.silu(self.conv1(x)))
