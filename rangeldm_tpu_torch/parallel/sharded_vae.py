"""The VAE's encoder and decoder with every activation azimuth-sharded.

The counterpart of the JAX package's `parallel/sharded_vae.py`: the whole
sgm Encoder / Decoder of the port's `AutoencoderKL` runs on a list of
azimuth shards, one on each device of a local mesh (`parallel/spatial.py`):

  * every circular conv exchanges halos with its ring neighbours
    (`halo_conv_local`), the asymmetric stride-2 downsample included;
  * GroupNorm adds its per-shard sums of x and x^2 over the mesh (on
    mesh[0]) and takes var = E[x^2] - mean^2, the JAX package's formula
    (flax's), in float32 also under autocast;
  * nearest-2x upsampling and the 1x1 shortcuts are shard-local.

The functions walk the model's own submodules, so no weight is copied on a
mesh of one card. Only attention-free, dropout-free, circular configs
without coordconv are taken (both shipped VAEs), with the JAX package's
errors; `halo_conv_local` refuses coordconv at every conv.

This is the path for range images too wide for one card's activations
(the Waymo-scale decode of 2656 columns); on one card it only checks the
path.
"""

from __future__ import annotations

import torch

from rangeldm_tpu_torch.models.layers import (
    VaeResnetBlock, nonlinearity, upsample_nearest,
)
from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
from rangeldm_tpu_torch.parallel.spatial import Shards, halo_conv_local


def _group_norm(shards: Shards, norm: torch.nn.GroupNorm) -> Shards:
    """GroupNorm of the whole azimuth ring: per-shard float32 sums of x and
    x^2 for each (sample, group), summed on the first shard's device and
    sent back; var = E[x^2] - mean^2, as the JAX package computes it."""
    g, home = norm.num_groups, shards[0].device
    groups = [x.float().reshape(x.shape[0], g, -1) for x in shards]
    s, ss = torch.stack([torch.stack([xg.sum(-1), xg.square().sum(-1)])
                         .to(home) for xg in groups]).sum(0)
    count = sum(xg.shape[-1] for xg in groups)
    mean = s / count
    inv = torch.rsqrt(ss / count - mean.square() + norm.eps)
    out = []
    for x, xg in zip(shards, groups):
        m, i = mean.to(x.device), inv.to(x.device)
        weight = norm.weight.to(x.device, torch.float32)
        bias = norm.bias.to(x.device, torch.float32)
        xn = ((xg - m[..., None]) * i[..., None]).reshape(x.shape)
        out.append(xn * weight[:, None, None] + bias[:, None, None])
    return out


def _act(shards: Shards, kind: str) -> Shards:
    return [nonlinearity(x, kind) for x in shards]


def _resnet(shards: Shards, block: VaeResnetBlock) -> Shards:
    h = halo_conv_local(_act(_group_norm(shards, block.norm1), block.act),
                        block.conv1)
    h = halo_conv_local(_act(_group_norm(h, block.norm2), block.act),
                        block.conv2)
    if hasattr(block, "conv_shortcut"):
        shards = halo_conv_local(shards, block.conv_shortcut)
    elif hasattr(block, "nin_shortcut"):
        shards = halo_conv_local(shards, block.nin_shortcut)
    return [x + y for x, y in zip(shards, h)]


def _check(cfg: VaeConfig) -> None:
    if cfg.attn_type != "none":
        raise NotImplementedError(
            "sharded VAE forwards support the shipped attention-free "
            "configs only (attn_type 'none')")
    if cfg.dropout:
        raise NotImplementedError("dropout is not supported in the sharded "
                                  "forward")
    if not cfg.circular:
        # the halo exchange is circular wrap; a zero-padded-azimuth VAE
        # would silently diverge at the first and last shards' edges
        raise NotImplementedError(
            "sharded VAE forwards require circular=True (the ring halo "
            "exchange implements wrap padding)")


def _tail(shards: Shards, module) -> Shards:
    """norm_out, the activation and conv_out of an encoder or decoder."""
    return halo_conv_local(_act(_group_norm(shards, module.norm_out),
                                module.act), module.conv_out)


def sharded_vae_decode(vae: AutoencoderKL, z_shards: Shards) -> Shards:
    """The decoder forward on azimuth shards of a latent; returns the
    decoded range image's shards."""
    _check(vae.cfg)
    dec = vae.decoder
    h = z_shards
    if vae.cfg.use_quant_conv:
        h = halo_conv_local(h, vae.post_quant_conv)
    h = halo_conv_local(h, dec.conv_in)
    h = _resnet(_resnet(h, dec.mid.block_1), dec.mid.block_2)
    for level in reversed(dec.up):
        for block in level.block:
            h = _resnet(h, block)
        if hasattr(level, "upsample"):
            h = [upsample_nearest(x) for x in h]
            h = halo_conv_local(h, level.upsample.conv)
    return _tail(h, dec)


def sharded_vae_encode(vae: AutoencoderKL, x_shards: Shards) -> Shards:
    """The encoder forward (image -> posterior moments) on azimuth shards;
    returns the moments' shards. Every shard's width must be equal and
    divide by the encoder's down factor: an odd width at some level would
    put the stride-2 downsample out of phase."""
    cfg = vae.cfg
    _check(cfg)
    widths = {x.shape[2] for x in x_shards}
    w = sum(x.shape[2] for x in x_shards)
    n = len(x_shards)
    if len(widths) != 1 or w // n % cfg.down_factor:
        raise ValueError(
            f"sharded_vae_encode: W={w} over {n} shards gives local width "
            f"{w / n}, which must be an integer divisible by the encoder "
            f"down factor {cfg.down_factor}")
    enc = vae.encoder
    h = halo_conv_local(x_shards, enc.conv_in)
    for level in enc.down:
        for block in level.block:
            h = _resnet(h, block)
        if hasattr(level, "downsample"):
            h = halo_conv_local(h, level.downsample.conv)
    h = _resnet(_resnet(h, enc.mid.block_1), enc.mid.block_2)
    h = _tail(h, enc)
    if cfg.use_quant_conv:
        h = halo_conv_local(h, vae.quant_conv)
    return h
