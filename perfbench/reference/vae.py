"""The KL autoencoder of the reference configurations (sgm Encoder and
Decoder, vae/configs/kitti360.yaml: no attention, SiLU, GroupNorm-32 with
eps 1e-6, circular convolutions) on the (B, C, W, H) layout, with weights
under the sgm state-dict names (encoder.down.0.block.1.conv1, ...)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.layers import (
    Params, conv, conv1x1, group_norm, upsample2x,
)
from perfbench.reference.precision import Precision

EPS = 1e-6


def _check(vc: dict) -> None:
    if vc.get("attn_type", "none") != "none" or vc.get("use_quant_conv") \
            or vc.get("coord") or not vc.get("double_z", True):
        raise ValueError("the reference VAE covers the shipped KITTI-360 "
                         "layout: no attention, no quant convs, no coord "
                         "channel, double_z")


def param_shapes(vc: dict) -> Dict[str, Tuple[int, ...]]:
    _check(vc)
    ch, mult, nres = vc["ch"], list(vc["ch_mult"]), vc["num_res_blocks"]
    z = vc["z_channels"]
    out: Dict[str, Tuple[int, ...]] = {}

    def add_conv(name, cin, cout, k=3):
        out[name + ".weight"] = (cout, cin, k, k)
        out[name + ".bias"] = (cout,)

    def add_norm(name, c):
        out[name + ".weight"] = (c,)
        out[name + ".bias"] = (c,)

    def add_block(name, cin, cout):
        add_norm(name + ".norm1", cin)
        add_conv(name + ".conv1", cin, cout)
        add_norm(name + ".norm2", cout)
        add_conv(name + ".conv2", cout, cout)
        if cin != cout:
            add_conv(name + ".nin_shortcut", cin, cout, 1)

    add_conv("encoder.conv_in", vc["in_channels"], ch)
    cin = ch
    for i, m in enumerate(mult):
        cout = ch * m
        for j in range(nres):
            add_block(f"encoder.down.{i}.block.{j}", cin if j == 0 else cout,
                      cout)
        if i != len(mult) - 1:
            add_conv(f"encoder.down.{i}.downsample.conv", cout, cout)
        cin = cout
    add_block("encoder.mid.block_1", cin, cin)
    add_block("encoder.mid.block_2", cin, cin)
    add_norm("encoder.norm_out", cin)
    add_conv("encoder.conv_out", cin, 2 * z)

    cin = ch * mult[-1]
    add_conv("decoder.conv_in", z, cin)
    add_block("decoder.mid.block_1", cin, cin)
    add_block("decoder.mid.block_2", cin, cin)
    for i in reversed(range(len(mult))):
        cout = ch * mult[i]
        for j in range(nres + 1):
            add_block(f"decoder.up.{i}.block.{j}", cin if j == 0 else cout,
                      cout)
        if i != 0:
            add_conv(f"decoder.up.{i}.upsample.conv", cout, cout)
        cin = cout
    add_norm("decoder.norm_out", cin)
    add_conv("decoder.conv_out", cin, vc["out_ch"])
    return out


def _block(pr: Precision, p: Params, name: str,
           x: torch.Tensor) -> torch.Tensor:
    h = conv(pr, p, name + ".conv1", F.silu(group_norm(p, name + ".norm1",
                                                       x, EPS)))
    h = conv(pr, p, name + ".conv2", F.silu(group_norm(p, name + ".norm2",
                                                       h, EPS)))
    if name + ".nin_shortcut.weight" in p:
        x = conv1x1(pr, p, name + ".nin_shortcut", x)
    return x + h


def encode_moments(vc: dict, p: Params, x: torch.Tensor,
                   pr: Precision) -> torch.Tensor:
    """Posterior moments (B, 2Z, W/f, H/f) of images x (B, C, W, H)."""
    _check(vc)
    levels = len(vc["ch_mult"])
    h = conv(pr, p, "encoder.conv_in", x)
    for i in range(levels):
        for j in range(vc["num_res_blocks"]):
            h = _block(pr, p, f"encoder.down.{i}.block.{j}", h)
        if i != levels - 1:
            # stride 2, padded only after the last beam and azimuth
            h = conv(pr, p, f"encoder.down.{i}.downsample.conv", h, stride=2,
                     beams=(0, 1), azimuth=(0, 1))
    h = _block(pr, p, "encoder.mid.block_1", h)
    h = _block(pr, p, "encoder.mid.block_2", h)
    h = F.silu(group_norm(p, "encoder.norm_out", h, EPS))
    return conv(pr, p, "encoder.conv_out", h)


def decode(vc: dict, p: Params, z: torch.Tensor,
           pr: Precision) -> torch.Tensor:
    """Images (B, out_ch, W, H) of latents z (B, Z, W/f, H/f)."""
    _check(vc)
    levels = len(vc["ch_mult"])
    h = conv(pr, p, "decoder.conv_in", z)
    h = _block(pr, p, "decoder.mid.block_1", h)
    h = _block(pr, p, "decoder.mid.block_2", h)
    for i in reversed(range(levels)):
        for j in range(vc["num_res_blocks"] + 1):
            h = _block(pr, p, f"decoder.up.{i}.block.{j}", h)
        if i != 0:
            h = conv(pr, p, f"decoder.up.{i}.upsample.conv", upsample2x(h))
    h = F.silu(group_norm(p, "decoder.norm_out", h, EPS))
    return conv(pr, p, "decoder.conv_out", h)


def posterior_sample(moments: torch.Tensor,
                     noise: torch.Tensor) -> torch.Tensor:
    """mean + exp(logvar / 2) * noise, logvar clamped to [-30, 20]."""
    mean, logvar = torch.chunk(moments, 2, dim=1)
    return mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * noise
