"""The diffusion UNet of the reference configurations (diffusers
UNet2DModel: ResnetBlock2D, AttnDownBlock2D / AttnUpBlock2D with the
deprecated attention block, UNetMidBlock2D, GroupNorm-32 with eps 1e-5,
head size 8, SiLU, sinusoidal timestep embedding) on the (B, C, W, H)
layout, every 3x3 convolution circular on azimuth.

`model_config` is the reference's own dict (ldm/configs/*.yaml
`model_config`); weights come as a dict under diffusers' state-dict names.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.layers import (
    Params, attention, conv, conv1x1, group_norm, linear, timestep_embedding,
    upsample2x,
)
from perfbench.reference.precision import Precision

EPS = 1e-5
HEAD_DIM = 8


def param_shapes(mc: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape for `model_config` `mc`."""
    ch = list(mc["block_out_channels"])
    temb = ch[0] * 4
    out: Dict[str, Tuple[int, ...]] = {}

    def add_conv(name, cin, cout, k=3):
        out[name + ".weight"] = (cout, cin, k, k)
        out[name + ".bias"] = (cout,)

    def add_linear(name, cin, cout):
        out[name + ".weight"] = (cout, cin)
        out[name + ".bias"] = (cout,)

    def add_norm(name, c):
        out[name + ".weight"] = (c,)
        out[name + ".bias"] = (c,)

    def add_resnet(name, cin, cout):
        add_norm(name + ".norm1", cin)
        add_conv(name + ".conv1", cin, cout)
        add_linear(name + ".time_emb_proj", temb, cout)
        add_norm(name + ".norm2", cout)
        add_conv(name + ".conv2", cout, cout)
        if cin != cout:
            add_conv(name + ".conv_shortcut", cin, cout, 1)

    def add_attention(name, c):
        add_norm(name + ".group_norm", c)
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            add_linear(f"{name}.{proj}", c, c)

    layers = mc.get("layers_per_block", 2)
    add_linear("time_embedding.linear_1", ch[0], temb)
    add_linear("time_embedding.linear_2", temb, temb)
    add_conv("conv_in", mc["in_channels"], ch[0])
    out_c = ch[0]
    for i, kind in enumerate(mc["down_block_types"]):
        in_c, out_c = out_c, ch[i]
        for j in range(layers):
            add_resnet(f"down_blocks.{i}.resnets.{j}", in_c if j == 0
                       else out_c, out_c)
            if kind == "AttnDownBlock2D":
                add_attention(f"down_blocks.{i}.attentions.{j}", out_c)
        if i != len(ch) - 1:
            add_conv(f"down_blocks.{i}.downsamplers.0.conv", out_c, out_c)
    for j in range(2):
        add_resnet(f"mid_block.resnets.{j}", ch[-1], ch[-1])
    add_attention("mid_block.attentions.0", ch[-1])
    rev = ch[::-1]
    out_c = rev[0]
    for i, kind in enumerate(mc["up_block_types"]):
        prev_c, out_c = out_c, rev[i]
        skip_c = rev[min(i + 1, len(ch) - 1)]
        n = layers + 1
        for j in range(n):
            cin = ((prev_c if j == 0 else out_c)
                   + (skip_c if j == n - 1 else out_c))
            add_resnet(f"up_blocks.{i}.resnets.{j}", cin, out_c)
            if kind == "AttnUpBlock2D":
                add_attention(f"up_blocks.{i}.attentions.{j}", out_c)
        if i != len(ch) - 1:
            add_conv(f"up_blocks.{i}.upsamplers.0.conv", out_c, out_c)
    add_norm("conv_norm_out", ch[0])
    add_conv("conv_out", ch[0], mc["out_channels"])
    return out


def _resnet(pr: Precision, p: Params, name: str, x: torch.Tensor,
            temb: torch.Tensor) -> torch.Tensor:
    h = conv(pr, p, name + ".conv1", F.silu(group_norm(p, name + ".norm1",
                                                       x, EPS)))
    h = h + linear(pr, p, name + ".time_emb_proj", F.silu(temb))[
        :, :, None, None]
    h = conv(pr, p, name + ".conv2", F.silu(group_norm(p, name + ".norm2",
                                                       h, EPS)))
    if name + ".conv_shortcut.weight" in p:
        x = conv1x1(pr, p, name + ".conv_shortcut", x)
    return x + h


def _channel_linear(pr: Precision, p: Params, name: str,
                    y: torch.Tensor) -> torch.Tensor:
    """A linear layer on the channel axis of (B, C, T)."""
    return linear(pr, p, name, y.transpose(1, 2)).transpose(1, 2)


def _attention(pr: Precision, p: Params, name: str,
               x: torch.Tensor) -> torch.Tensor:
    """GroupNorm, q/k/v projections, heads of size 8 over the W*H tokens,
    the output projection and the residual."""
    b, c, w, h = x.shape
    heads = c // HEAD_DIM
    y = group_norm(p, name + ".group_norm", x, EPS).reshape(b, c, w * h)
    q, k, v = (_channel_linear(pr, p, f"{name}.{m}", y).reshape(
        b * heads, HEAD_DIM, w * h) for m in ("to_q", "to_k", "to_v"))
    o = attention(pr, q, k, v).reshape(b, c, w * h)
    return _channel_linear(pr, p, name + ".to_out.0", o).reshape(
        b, c, w, h) + x


def forward(mc: dict, p: Params, x: torch.Tensor, t: torch.Tensor,
            pr: Precision) -> torch.Tensor:
    """The UNet's output (B, out_channels, W, H) for input x (B,
    in_channels, W, H) at timesteps t (B,)."""
    ch = list(mc["block_out_channels"])
    layers = mc.get("layers_per_block", 2)
    emb = timestep_embedding(t, ch[0])
    temb = linear(pr, p, "time_embedding.linear_2",
                  F.silu(linear(pr, p, "time_embedding.linear_1", emb)))
    x = conv(pr, p, "conv_in", x)
    skips: List[torch.Tensor] = [x]
    for i, kind in enumerate(mc["down_block_types"]):
        for j in range(layers):
            x = _resnet(pr, p, f"down_blocks.{i}.resnets.{j}", x, temb)
            if kind == "AttnDownBlock2D":
                x = _attention(pr, p, f"down_blocks.{i}.attentions.{j}", x)
            skips.append(x)
        if i != len(ch) - 1:
            x = conv(pr, p, f"down_blocks.{i}.downsamplers.0.conv", x,
                     stride=2)
            skips.append(x)
    x = _resnet(pr, p, "mid_block.resnets.0", x, temb)
    x = _attention(pr, p, "mid_block.attentions.0", x)
    x = _resnet(pr, p, "mid_block.resnets.1", x, temb)
    for i, kind in enumerate(mc["up_block_types"]):
        for j in range(layers + 1):
            x = _resnet(pr, p, f"up_blocks.{i}.resnets.{j}",
                        torch.cat([x, skips.pop()], dim=1), temb)
            if kind == "AttnUpBlock2D":
                x = _attention(pr, p, f"up_blocks.{i}.attentions.{j}", x)
        if i != len(ch) - 1:
            x = conv(pr, p, f"up_blocks.{i}.upsamplers.0.conv",
                     upsample2x(x))
    x = F.silu(group_norm(p, "conv_norm_out", x, EPS))
    return conv(pr, p, "conv_out", x)
