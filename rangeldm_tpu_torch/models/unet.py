"""Diffusion UNet in the diffusers `UNet2DModel` grammar.

The features the reference configs use (ldm/configs/*.yaml): DownBlock2D /
AttnDownBlock2D / UpBlock2D / AttnUpBlock2D, UNetMidBlock2D, sinusoidal
timestep embedding (flip_sin_to_cos, freq_shift 0), GroupNorm-32 eps 1e-5,
attention head_dim 8, silu, every 3x3 conv circular on azimuth.

Layout (B, C, W=azimuth, H=beams); module names follow the diffusers state
dict keys (down_blocks.0.resnets.1.conv1, mid_block.attentions.0.to_q, ...)
so `load_state_dict(strict=True)` takes a diffusers checkpoint as it is.
`sample_size` is (beams, azimuth), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rangeldm_tpu_torch.models.layers import (
    CircularConv, norm_act, norm_act_conv, timestep_embedding,
    upsample_nearest,
)
from rangeldm_tpu_torch.ops.attention import (
    attention_t_reference, fused_attention_t,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: Tuple[int, int] = (16, 256)       # (beams, azimuth)
    in_channels: int = 5
    out_channels: int = 4
    layers_per_block: int = 2
    block_out_channels: Tuple[int, ...] = (128, 128, 256, 256)
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "AttnUpBlock2D", "AttnUpBlock2D", "AttnUpBlock2D", "UpBlock2D")
    attention_head_dim: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    add_mid_attention: bool = True
    circular: bool = True
    dropout: float = 0.0
    # None or True: every attention layer goes through fused_attention_t
    # (the CUDA kernel on the card, its plain version on the CPU);
    # False: the plain einsum path everywhere
    use_fused_attention: Optional[bool] = None

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def from_reference(cls, model_config: dict, circular: bool = True):
        """Build from a diffusers / ldm `model_config` dict, whose
        sample_size is [azimuth, beams]."""
        mc = dict(model_config)
        w, h = mc.pop("sample_size")
        return cls(sample_size=(h, w),
                   in_channels=mc["in_channels"],
                   out_channels=mc["out_channels"],
                   layers_per_block=mc.get("layers_per_block", 2),
                   block_out_channels=tuple(mc["block_out_channels"]),
                   down_block_types=tuple(mc["down_block_types"]),
                   up_block_types=tuple(mc["up_block_types"]),
                   attention_head_dim=mc.get("attention_head_dim") or 8,
                   circular=circular)


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D ('default' time scale shift): GN -> silu ->
    conv -> (+ temb projection) -> GN -> silu -> dropout -> conv, with a
    1x1 shortcut when the channel count changes."""

    def __init__(self, in_channels: int, out_channels: int, temb: int,
                 eps: float = 1e-5, groups: int = 32, dropout: float = 0.0,
                 circular: bool = True):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = CircularConv(in_channels, out_channels, 3, 1, 1,
                                  circular)
        self.time_emb_proj = nn.Linear(temb, out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = CircularConv(out_channels, out_channels, 3, 1, 1,
                                  circular)
        if in_channels != out_channels:
            self.conv_shortcut = CircularConv(in_channels, out_channels, 1,
                                              1, 0, circular=False)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = norm_act_conv(self.norm1, x, "silu", self.conv1)
        h = norm_act_conv(self.norm2, h, "silu", self.conv2,
                          shift=self.time_emb_proj(F.silu(temb)),
                          dropout=self.dropout)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


def _channel_linear(layer: nn.Linear, yt: torch.Tensor) -> torch.Tensor:
    """A Linear applied on the channel axis of a (B, C, T) tensor, giving
    (B, C_out, T) without a transpose. The bias is added in the product's
    dtype, as a Linear does: under autocast the product is bf16, and an f32
    bias would promote the sum (and the attention after it) to f32."""
    y = torch.matmul(layer.weight, yt)
    return y + layer.bias[:, None].to(y.dtype)


class Attention(nn.Module):
    """diffusers Attention in its deprecated-AttnBlock configuration:
    GN -> linear q/k/v -> multi-head softmax attention -> linear out, plus
    the residual.

    The block runs channel-major: the (B, C, W, H) input is already
    (B, C, T) with tokens in (W, H) order, the projections act on the
    channel axis, and the head split (B, C, T) -> (B * heads, D, T) with
    channel = head * head_dim + d is a free reshape onto the layout
    `fused_attention_t` takes. The JAX package flattens tokens in (H, W)
    order instead; attention has no positional term, so the two agree."""

    def __init__(self, channels: int, head_dim: int = 8, groups: int = 32,
                 eps: float = 1e-5, use_fused: Optional[bool] = None):
        super().__init__()
        self.heads = max(channels // head_dim, 1)
        self.use_fused = use_fused
        self.group_norm = nn.GroupNorm(groups, channels, eps=eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, w, h = x.shape
        t = w * h
        hd = c // self.heads
        yt = norm_act(self.group_norm, x).reshape(b, c, t)
        qt, kt, vt = (_channel_linear(m, yt).reshape(b * self.heads, hd, t)
                      for m in (self.to_q, self.to_k, self.to_v))
        attend = (attention_t_reference if self.use_fused is False
                  else fused_attention_t)
        ot = attend(qt, kt, vt, hd ** -0.5).reshape(b, c, t)
        return _channel_linear(self.to_out[0], ot).reshape(b, c, w, h) + x


class Downsample2D(nn.Module):
    """diffusers Downsample2D with the circular swap: 3x3 stride 2,
    symmetric padding 1 (wrapping on azimuth)."""

    def __init__(self, channels: int, circular: bool = True):
        super().__init__()
        self.conv = CircularConv(channels, channels, 3, 2, 1, circular)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """diffusers Upsample2D: nearest 2x + 3x3 circular conv."""

    def __init__(self, channels: int, circular: bool = True):
        super().__init__()
        self.conv = CircularConv(channels, channels, 3, 1, 1, circular)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest(x))


class _Block(nn.Module):
    """Shared constructor of the down and up blocks: `resnets`, optional
    `attentions`, and an optional `downsamplers` / `upsamplers` list."""

    def __init__(self, res_in: List[int], out_channels: int, temb: int,
                 with_attn: bool, cfg: UNetConfig):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(cin, out_channels, temb, cfg.norm_eps,
                          cfg.norm_num_groups, cfg.dropout, cfg.circular)
            for cin in res_in)
        if with_attn:
            self.attentions = nn.ModuleList(
                Attention(out_channels, cfg.attention_head_dim,
                          cfg.norm_num_groups, cfg.norm_eps,
                          cfg.use_fused_attention)
                for _ in res_in)

    def _layer(self, j: int, x: torch.Tensor,
               temb: torch.Tensor) -> torch.Tensor:
        x = self.resnets[j](x, temb)
        if hasattr(self, "attentions"):
            x = self.attentions[j](x)
        return x


class DownBlock2D(_Block):
    def __init__(self, in_channels: int, out_channels: int, temb: int,
                 with_attn: bool, add_downsample: bool, cfg: UNetConfig):
        n = cfg.layers_per_block
        super().__init__([in_channels] + [out_channels] * (n - 1),
                         out_channels, temb, with_attn, cfg)
        if add_downsample:
            self.downsamplers = nn.ModuleList(
                [Downsample2D(out_channels, cfg.circular)])

    def forward(self, x, temb):
        skips = []
        for j in range(len(self.resnets)):
            x = self._layer(j, x, temb)
            skips.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class UpBlock2D(_Block):
    def __init__(self, prev_channels: int, out_channels: int,
                 skip_channels: int, temb: int, with_attn: bool,
                 add_upsample: bool, cfg: UNetConfig):
        n = cfg.layers_per_block + 1
        res_in = [(prev_channels if j == 0 else out_channels)
                  + (skip_channels if j == n - 1 else out_channels)
                  for j in range(n)]
        super().__init__(res_in, out_channels, temb, with_attn, cfg)
        if add_upsample:
            self.upsamplers = nn.ModuleList(
                [Upsample2D(out_channels, cfg.circular)])

    def forward(self, x, skips, temb):
        for j in range(len(self.resnets)):
            x = self._layer(j, torch.cat([x, skips.pop()], dim=1), temb)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class UNetMidBlock2D(nn.Module):
    def __init__(self, channels: int, temb: int, cfg: UNetConfig):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(channels, channels, temb, cfg.norm_eps,
                          cfg.norm_num_groups, cfg.dropout, cfg.circular)
            for _ in range(2))
        if cfg.add_mid_attention:
            self.attentions = nn.ModuleList(
                [Attention(channels, cfg.attention_head_dim,
                           cfg.norm_num_groups, cfg.norm_eps,
                           cfg.use_fused_attention)])

    def forward(self, x, temb):
        x = self.resnets[0](x, temb)
        if hasattr(self, "attentions"):
            x = self.attentions[0](x)
        return self.resnets[1](x, temb)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class UNet2D(nn.Module):
    """UNet2DModel equivalent: forward(sample (B, C, W, H), timesteps (B,)
    or scalar) -> (B, out_channels, W, H)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.block_out_channels
        n = len(ch)
        temb = cfg.time_embed_dim
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.conv_in = CircularConv(cfg.in_channels, ch[0], 3, 1, 1,
                                    cfg.circular)
        self.down_blocks = nn.ModuleList()
        out_c = ch[0]
        for i, btype in enumerate(cfg.down_block_types):
            in_c, out_c = out_c, ch[i]
            self.down_blocks.append(DownBlock2D(
                in_c, out_c, temb, btype == "AttnDownBlock2D", i != n - 1,
                cfg))
        self.mid_block = UNetMidBlock2D(ch[-1], temb, cfg)
        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList()
        out_c = rev[0]
        for i, btype in enumerate(cfg.up_block_types):
            prev_c, out_c = out_c, rev[i]
            self.up_blocks.append(UpBlock2D(
                prev_c, out_c, rev[min(i + 1, n - 1)], temb,
                btype == "AttnUpBlock2D", i != n - 1, cfg))
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, ch[0],
                                          eps=cfg.norm_eps)
        self.conv_out = CircularConv(ch[0], cfg.out_channels, 3, 1, 1,
                                     cfg.circular)

    def forward(self, sample: torch.Tensor,
                timesteps: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        emb = timestep_embedding(timesteps, c.block_out_channels[0],
                                 c.flip_sin_to_cos, c.freq_shift,
                                 dtype=sample.dtype)
        temb = self.time_embedding(emb)

        x = self.conv_in(sample)
        skips = [x]
        for blk in self.down_blocks:
            x, blk_skips = blk(x, temb)
            skips += blk_skips
        x = self.mid_block(x, temb)
        for blk in self.up_blocks:
            x = blk(x, skips, temb)
        assert not skips
        return norm_act_conv(self.conv_norm_out, x, "silu", self.conv_out)
