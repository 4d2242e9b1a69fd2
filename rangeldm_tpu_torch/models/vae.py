"""Range-image KL autoencoder in the sgm grammar.

The reference Encoder / Decoder (vae/sgm/modules/diffusionmodules/
model.py:707-1057) and the diagonal-Gaussian posterior
(vae/sgm/modules/distributions/distributions.py:24-72) on the layout
(B, C, W=azimuth, H=beams). Module names follow the sgm state dict
(encoder.down.0.block.1.conv1, decoder.mid.block_2, ...).

Shipped KITTI-360 config (vae/configs/kitti360.yaml): ch 64, ch_mult
(1, 2, 4), two res blocks, z 4, double_z, no attention, silu, circular.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from rangeldm_tpu_torch.models.layers import (
    CircularConv, VaeAttnBlock, VaeDownsample, VaeResnetBlock, VaeUpsample,
    group_norm, nonlinearity,
)


@dataclasses.dataclass(frozen=True)
class VaeConfig:
    in_channels: int = 2
    out_ch: int = 2
    ch: int = 64
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    double_z: bool = True
    attn_type: str = "none"          # 'none' | 'vanilla'
    attn_resolutions: Tuple[int, ...] = ()
    resolution: int = 256            # seeds the attention-resolution count
    dropout: float = 0.0
    act: str = "silu"
    circular: bool = True
    coord: bool = False
    scaling_factor: float = 0.18215
    use_quant_conv: bool = False

    @property
    def down_factor(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)

    def _has_attn(self, res: int) -> bool:
        return self.attn_type != "none" and res in self.attn_resolutions


def _resblock(cfg: VaeConfig, cin: int, cout: int) -> VaeResnetBlock:
    return VaeResnetBlock(cin, cout, cfg.dropout, cfg.act, cfg.circular,
                          cfg.coord)


class _Mid(nn.Module):
    def __init__(self, cfg: VaeConfig, channels: int):
        super().__init__()
        self.block_1 = _resblock(cfg, channels, channels)
        if cfg.attn_type != "none":
            self.attn_1 = VaeAttnBlock(channels)
        self.block_2 = _resblock(cfg, channels, channels)

    def forward(self, h):
        h = self.block_1(h)
        if hasattr(self, "attn_1"):
            h = self.attn_1(h)
        return self.block_2(h)


class _Level(nn.Module):
    """One resolution level: `block` res blocks, optional `attn`, and an
    optional `downsample` / `upsample`."""

    def __init__(self, cfg: VaeConfig, cin: int, cout: int, n_blocks: int,
                 with_attn: bool):
        super().__init__()
        self.block = nn.ModuleList(
            _resblock(cfg, cin if j == 0 else cout, cout)
            for j in range(n_blocks))
        if with_attn:
            self.attn = nn.ModuleList(VaeAttnBlock(cout)
                                      for _ in range(n_blocks))

    def blocks(self, h):
        for j, blk in enumerate(self.block):
            h = blk(h)
            if hasattr(self, "attn"):
                h = self.attn[j](h)
        return h


class Encoder(nn.Module):
    """sgm Encoder (model.py:707-896)."""

    def __init__(self, cfg: VaeConfig):
        super().__init__()
        self.conv_in = CircularConv(cfg.in_channels, cfg.ch, 3, 1, 1,
                                    cfg.circular, cfg.coord)
        self.down = nn.ModuleList()
        res, cin = cfg.resolution, cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            cout = cfg.ch * mult
            level = _Level(cfg, cin, cout, cfg.num_res_blocks,
                           cfg._has_attn(res))
            if i != len(cfg.ch_mult) - 1:
                level.downsample = VaeDownsample(cout, cfg.circular,
                                                 cfg.coord)
                res //= 2
            self.down.append(level)
            cin = cout
        self.mid = _Mid(cfg, cin)
        self.norm_out = group_norm(cin)
        self.act = cfg.act
        self.conv_out = CircularConv(
            cin, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels,
            3, 1, 1, cfg.circular, cfg.coord)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            h = level.blocks(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(nonlinearity(self.norm_out(h), self.act))


class Decoder(nn.Module):
    """sgm Decoder (model.py:899-1057): num_res_blocks + 1 blocks per level
    and nearest-2x upsampling between levels. `up[i]` is level i, built in
    reverse as the sgm code builds it."""

    def __init__(self, cfg: VaeConfig):
        super().__init__()
        n = len(cfg.ch_mult)
        cin = cfg.ch * cfg.ch_mult[-1]
        res = cfg.resolution // 2 ** (n - 1)
        self.conv_in = CircularConv(cfg.z_channels, cin, 3, 1, 1,
                                    cfg.circular, cfg.coord)
        self.mid = _Mid(cfg, cin)
        levels = [None] * n
        for i in reversed(range(n)):
            cout = cfg.ch * cfg.ch_mult[i]
            level = _Level(cfg, cin, cout, cfg.num_res_blocks + 1,
                           cfg._has_attn(res))
            if i != 0:
                level.upsample = VaeUpsample(cout, cfg.circular, cfg.coord)
                res *= 2
            levels[i] = level
            cin = cout
        self.up = nn.ModuleList(levels)
        self.norm_out = group_norm(cin)
        self.act = cfg.act
        self.conv_out = CircularConv(cin, cfg.out_ch, 3, 1, 1, cfg.circular,
                                     cfg.coord)

    def forward(self, z: torch.Tensor, pre_end: bool = False) -> torch.Tensor:
        """pre_end=True returns the activations feeding conv_out (after
        norm_out and the activation)."""
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level.blocks(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        h = nonlinearity(self.norm_out(h), self.act)
        return h if pre_end else self.conv_out(h)


def gaussian_params(moments: torch.Tensor):
    """Split encoder moments (B, 2Z, ...) on the channel axis into (mean,
    logvar), logvar clamped to [-30, 20]."""
    mean, logvar = torch.chunk(moments, 2, dim=1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def gaussian_sample(moments: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None):
    """A posterior draw mean + std * noise; `noise` (standard normal of the
    mean's shape) is drawn from `generator` unless given."""
    mean, logvar = gaussian_params(moments)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            dtype=mean.dtype, device=mean.device)
    return mean + torch.exp(0.5 * logvar) * noise


def gaussian_mode(moments: torch.Tensor) -> torch.Tensor:
    return gaussian_params(moments)[0]


def gaussian_kl(moments: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0, 1)) summed over the non-batch axes."""
    mean, logvar = gaussian_params(moments)
    return 0.5 * torch.sum(mean ** 2 + torch.exp(logvar) - 1.0 - logvar,
                           dim=tuple(range(1, mean.dim())))


class AutoencoderKL(nn.Module):
    """Encoder + decoder (+ optional quant convs) of the sgm KL
    autoencoder; the sampling path only decodes, VAE training runs
    `forward` (training/vae_trainer.py)."""

    def __init__(self, cfg: VaeConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        if cfg.use_quant_conv:
            self.quant_conv = CircularConv(2 * cfg.z_channels,
                                           2 * cfg.z_channels, 1, 1, 0,
                                           circular=False)
            self.post_quant_conv = CircularConv(cfg.z_channels,
                                                cfg.z_channels, 1, 1, 0,
                                                circular=False)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        m = self.encoder(x)
        return self.quant_conv(m) if self.cfg.use_quant_conv else m

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        if self.cfg.use_quant_conv:
            z = self.post_quant_conv(z)
        return self.decoder(z)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                sample_posterior: bool = True):
        """(reconstruction, z, moments): encode, a posterior draw (`noise`,
        else drawn from `generator`) or the posterior mode, decode (the
        sgm engine's forward, vae/sgm/models/autoencoder.py:170-184)."""
        moments = self.encode_moments(x)
        z = (gaussian_sample(moments, generator, noise) if sample_posterior
             else gaussian_mode(moments))
        return self.decode(z), z, moments
