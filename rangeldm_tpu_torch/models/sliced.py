"""Sliced (beam-row-grouped) conv VAE variants: the reference's
`SlicedConv` / `SlicedDownsample` / `SlicedUpsample` / `SlicedResnetBlock` /
`SlicedEncoder` / `SlicedDecoder` (vae/sgm/modules/diffusionmodules/
model.py:1059-1517), the counterpart of the JAX package's models/sliced.py.

No shipped config builds them (dead code upstream), but they are part of
the component inventory, with the reference's semantics:

  * `SlicedConv` is the reference's module: a grouped `nn.Conv1d` with
    padding_mode 'circular' over the (B, H*C, W) flattening, one group per
    PAIR of beam rows, each with its own k-wide filter over the azimuth
    (model.py:1087-1100). Its state dict is the reference's
    (`conv.weight` of shape (out, 2*in, k)).
  * `padding` (0/1) adds one phantom zero row at the top and the bottom,
    and is toggled between consecutive convs so that the row pairs shift
    by one row. The trim after the conv is in flat channel space, which
    keeps the reference's half-group offset of the stride-2, p=1 case
    (model.py:1096-1097).
  * stride 2 right-pads the azimuth with one zero (circular padding is
    inert at conv padding 0) and merges each row pair into one row.

Layout (B, C, W=azimuth, H=beams); module names follow the sgm grammar
(conv_in, down.{i}.block.{j}, down.{i}.downsample, mid.block_1, ...), so a
reference state dict loads strict.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rangeldm_tpu_torch.models.layers import (
    VaeAttnBlock, group_norm, nonlinearity, upsample_nearest,
)


class SlicedConv(nn.Module):
    """The reference SlicedConv (model.py:1059-1101) on (B, C, W, H) with
    H == height."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 height: int = 64):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"stride must be 1 or 2, got {stride}")
        rows = height + 2 * padding
        self.in_channels, self.out_channels = in_channels, out_channels
        self.stride, self.padding, self.height = stride, padding, height
        self.conv = nn.Conv1d(
            in_channels * rows, out_channels // stride * rows, kernel_size,
            stride, padding=kernel_size // 2 if stride == 1 else 0,
            padding_mode="circular", groups=rows // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[3] != self.height:
            raise ValueError(f"SlicedConv of height {self.height} got "
                             f"{x.shape[3]} beam rows")
        x = torch.flatten(x.permute(0, 3, 1, 2), start_dim=1, end_dim=2)
        if self.padding:
            x = F.pad(x, (0, 0, self.in_channels, self.in_channels))
        if self.stride == 2:
            x = F.pad(x, (0, 1))
        x = self.conv(x)
        if self.padding:
            off = self.out_channels // self.stride
            x = x[:, off:off * (1 + self.height)]
        b, _, w = x.shape
        return x.reshape(b, -1, self.out_channels, w).permute(0, 2, 3, 1)


class SlicedDownsample(nn.Module):
    """model.py:1120-1134: a sliced stride-2 conv, or 2x2 average pooling."""

    def __init__(self, channels: int, with_conv: bool = True,
                 padding: int = 0, height: int = 64):
        super().__init__()
        if with_conv:
            self.conv = SlicedConv(channels, channels, 3, 2, padding, height)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "conv"):
            return self.conv(x)
        return F.avg_pool2d(x, 2, 2)


class SlicedUpsample(nn.Module):
    """model.py:1106-1118: nearest 2x, then a sliced conv at the doubled
    height (`height` is the input's)."""

    def __init__(self, channels: int, with_conv: bool = True,
                 padding: int = 0, height: int = 64):
        super().__init__()
        if with_conv:
            self.conv = SlicedConv(channels, channels, 3, 1, padding,
                                   2 * height)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_nearest(x)
        return self.conv(x) if hasattr(self, "conv") else x


class SlicedResnetBlock(nn.Module):
    """model.py:1136-1196: GN -> act -> sliced conv (p) -> GN -> act ->
    dropout -> sliced conv (1 - p), and a sliced 1x1 `nin_shortcut` (p), or
    a 3x3 `conv_shortcut`, on a channel change."""

    def __init__(self, in_channels: int, out_channels: int, padding: int = 0,
                 height: int = 64, dropout: float = 0.0, act: str = "relu",
                 use_conv_shortcut: bool = False):
        super().__init__()
        p = padding
        self.act = act
        self.norm1 = group_norm(in_channels)
        self.conv1 = SlicedConv(in_channels, out_channels, 3, 1, p, height)
        self.norm2 = group_norm(out_channels)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = SlicedConv(out_channels, out_channels, 3, 1, 1 - p,
                                height)
        if in_channels != out_channels:
            if use_conv_shortcut:
                self.conv_shortcut = SlicedConv(in_channels, out_channels, 3,
                                                1, p, height)
            else:
                self.nin_shortcut = SlicedConv(in_channels, out_channels, 1,
                                               1, p, height)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(nonlinearity(self.norm1(x), self.act))
        h = self.dropout(nonlinearity(self.norm2(h), self.act))
        h = self.conv2(h)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        elif hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


@dataclasses.dataclass(frozen=True)
class SlicedConfig:
    """The JAX package's defaults: attention-free (the reference classes
    default to a vanilla mid attention; pass attn_type='vanilla' for it),
    relu, 64 beam rows (the sliced axis)."""
    in_channels: int = 2
    out_ch: int = 2
    ch: int = 64
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    double_z: bool = True
    attn_type: str = "none"
    attn_resolutions: Tuple[int, ...] = ()
    resolution: int = 64
    dropout: float = 0.0
    act: str = "relu"
    resamp_with_conv: bool = True
    tanh_out: bool = False
    give_pre_end: bool = False


def _attn(cfg: SlicedConfig, res: int) -> bool:
    return cfg.attn_type != "none" and res in cfg.attn_resolutions


class _Mid(nn.Module):
    def __init__(self, cfg: SlicedConfig, channels: int, p: int, rows: int):
        super().__init__()
        self.block_1 = SlicedResnetBlock(channels, channels, p, rows,
                                         cfg.dropout, cfg.act)
        if cfg.attn_type != "none":
            self.attn_1 = VaeAttnBlock(channels)
        self.block_2 = SlicedResnetBlock(channels, channels, 1 - p, rows,
                                         cfg.dropout, cfg.act)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.block_1(h)
        if hasattr(self, "attn_1"):
            h = self.attn_1(h)
        return self.block_2(h)


class _Level(nn.Module):
    """One resolution level: `block` (and `attn`) lists and an optional
    `downsample` / `upsample`, built by the encoder or the decoder."""

    def blocks(self, h: torch.Tensor) -> torch.Tensor:
        for j, blk in enumerate(self.block):
            h = blk(h)
            if hasattr(self, "attn"):
                h = self.attn[j](h)
        return h


class SlicedEncoder(nn.Module):
    """model.py:1200-1346, with the reference's padding toggle: p starts at
    0 and flips after conv_in, after each channel-changing res block, after
    each conv resample and after each mid block."""

    def __init__(self, cfg: SlicedConfig):
        super().__init__()
        self.act = cfg.act
        p, rows = 0, cfg.resolution
        self.conv_in = SlicedConv(cfg.in_channels, cfg.ch, 3, 1, p, rows)
        p = 1 - p
        self.down = nn.ModuleList()
        cin = cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            cout = cfg.ch * mult
            level = _Level()
            level.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                level.block.append(SlicedResnetBlock(
                    cin, cout, p, rows, cfg.dropout, cfg.act))
                if cin != cout:
                    p = 1 - p
                cin = cout
            if _attn(cfg, rows):
                level.attn = nn.ModuleList(
                    VaeAttnBlock(cout) for _ in range(cfg.num_res_blocks))
            if i != len(cfg.ch_mult) - 1:
                level.downsample = SlicedDownsample(
                    cin, cfg.resamp_with_conv, p, rows)
                if cfg.resamp_with_conv:
                    p = 1 - p
                rows //= 2
            self.down.append(level)
        self.mid = _Mid(cfg, cin, p, rows)
        self.norm_out = group_norm(cin)
        self.conv_out = SlicedConv(
            cin, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels,
            3, 1, p, rows)     # p flipped twice by the mid blocks

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            h = level.blocks(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(nonlinearity(self.norm_out(h), self.act))


class SlicedDecoder(nn.Module):
    """model.py:1349-1517: the encoder's toggle discipline, mirrored; `up[i]`
    is level i, built in reverse as the sgm code builds it."""

    def __init__(self, cfg: SlicedConfig):
        super().__init__()
        self.cfg = cfg
        n = len(cfg.ch_mult)
        cin = cfg.ch * cfg.ch_mult[-1]
        p, rows = 0, cfg.resolution // 2 ** (n - 1)
        self.conv_in = SlicedConv(cfg.z_channels, cin, 3, 1, p, rows)
        p = 1 - p
        self.mid = _Mid(cfg, cin, p, rows)
        levels = [None] * n
        for i in reversed(range(n)):
            cout = cfg.ch * cfg.ch_mult[i]
            level = _Level()
            level.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(SlicedResnetBlock(
                    cin, cout, p, rows, cfg.dropout, cfg.act))
                if cin != cout:
                    p = 1 - p
                cin = cout
            if _attn(cfg, rows):
                level.attn = nn.ModuleList(
                    VaeAttnBlock(cout) for _ in range(cfg.num_res_blocks + 1))
            if i != 0:
                level.upsample = SlicedUpsample(cin, cfg.resamp_with_conv, p,
                                                rows)
                if cfg.resamp_with_conv:
                    p = 1 - p
                rows *= 2
            levels[i] = level
        self.up = nn.ModuleList(levels)
        if not cfg.give_pre_end:
            self.norm_out = group_norm(cin)
            self.conv_out = SlicedConv(cin, cfg.out_ch, 3, 1, p, rows)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level.blocks(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        if self.cfg.give_pre_end:
            return h
        h = self.conv_out(nonlinearity(self.norm_out(h), self.cfg.act))
        return torch.tanh(h) if self.cfg.tanh_out else h
