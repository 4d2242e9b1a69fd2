"""Core layers on the reference's torch layout (B, C, W=azimuth, H=beams).

`CircularConv` wraps the azimuth axis and zero-pads the beam axis (the
reference's Conv2d, vae/sgm/modules/diffusionmodules/model.py:93-108). Its
weight is the torch state-dict layout (O, I, k_azimuth, k_beam), so released
checkpoints load as they are.

`norm_act` and `norm_act_conv` run every GroupNorm of the UNet and the VAE
through `ops.group_norm.group_norm_act`: the norm, its activation and, where
the next conv takes it, that conv's azimuth wrap in one pass; the conv then
runs with `wrapped=True` and pads nothing.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from rangeldm_tpu_torch.ops.group_norm import group_norm_act

Padding = Union[int, Tuple[int, int], Tuple[Tuple[int, int], Tuple[int, int]]]


def _pads(padding: Padding):
    """(pad_h, pad_w), a single int, or ((h_lo, h_hi), (w_lo, w_hi)) ->
    ((h_lo, h_hi), (w_lo, w_hi)); h = beams, w = azimuth."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    if isinstance(padding[0], int):
        return (padding[0],) * 2, (padding[1],) * 2
    return tuple(padding[0]), tuple(padding[1])


class CircularConv(nn.Conv2d):
    """2D conv, circular on azimuth (W) and zero-padded on beams (H).

    `padding` is symmetric (an int or (pad_h, pad_w)) or
    ((h_lo, h_hi), (w_lo, w_hi)) for the stride-2 VAE downsampling pattern
    ((0, 1), (0, 1)). `circular=False` zero-pads both axes. `coord=True`
    appends a beam-coordinate channel in [-1, 1] before the conv
    (coordconv, model.py:94-98)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 padding: Padding = 1, circular: bool = True,
                 coord: bool = False, bias: bool = True):
        super().__init__(in_channels + int(coord), out_channels, kernel_size,
                         stride, 0, bias=bias)
        (self.h_lo, self.h_hi), (self.w_lo, self.w_hi) = _pads(padding)
        self.circular = circular
        self.coord = coord

    @property
    def takes_wrapped(self) -> bool:
        """Whether `forward(x, wrapped=True)` can take this conv's input:
        3x3, circular, one azimuth row of wrap on each side, no coordinate
        channel, equal beam padding."""
        return (self.circular and not self.coord
                and self.kernel_size == (3, 3) and self.w_lo == self.w_hi == 1
                and self.h_lo == self.h_hi)

    def forward(self, x: torch.Tensor, wrapped: bool = False) -> torch.Tensor:
        """`wrapped`: x is already (B, C, W + 2, H) with rows 0 and W + 1
        holding rows W - 1 and 0, as this conv would pad it
        (`takes_wrapped` convs only)."""
        if wrapped:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (0, self.h_lo))
        if self.coord:
            b, _, w, h = x.shape
            coords = torch.linspace(-1.0, 1.0, h, dtype=x.dtype,
                                    device=x.device)
            x = torch.cat([x, coords.expand(b, 1, w, h)], dim=1)
        if self.circular and (self.w_lo or self.w_hi):
            x = F.pad(x, (0, 0, self.w_lo, self.w_hi), mode="circular")
            w_pad = (0, 0)
        else:
            w_pad = (self.w_lo, self.w_hi)
        if self.h_lo == self.h_hi and w_pad[0] == w_pad[1]:
            # symmetric zero padding folds into the convolution itself
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (w_pad[0], self.h_lo))
        x = F.pad(x, (self.h_lo, self.h_hi, *w_pad))
        return F.conv2d(x, self.weight, self.bias, self.stride)


def group_norm(channels: int, eps: float = 1e-6,
               groups: int = 32) -> nn.GroupNorm:
    """GroupNorm with 32 groups; eps 1e-6 in the VAE (layers.py:105-109),
    1e-5 in the UNet (unet.py:48)."""
    return nn.GroupNorm(groups, channels, eps=eps)


def nonlinearity(x: torch.Tensor, kind: str = "silu") -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "relu":
        return F.relu(x)
    raise NotImplementedError(kind)


def norm_act(norm: nn.GroupNorm, x: torch.Tensor, act: str = "identity",
             shift: torch.Tensor = None, wrap: bool = False) -> torch.Tensor:
    """act(norm(x + shift[:, :, None, None])), azimuth-wrapped for a
    `CircularConv(..., wrapped=True)` when `wrap`, through
    `group_norm_act`."""
    return group_norm_act(x, norm.weight, norm.bias, norm.num_groups,
                          norm.eps, act, shift, wrap)


def norm_act_conv(norm: nn.GroupNorm, x: torch.Tensor, act: str,
                  conv: CircularConv, shift: torch.Tensor = None,
                  dropout: nn.Dropout = None) -> torch.Tensor:
    """conv(dropout(act(norm(x + shift)))). Where the conv takes a wrapped
    input and the dropout is the identity, the norm writes the conv's
    wrapped input and the conv runs without its pad."""
    if conv.takes_wrapped and (dropout is None or dropout.p == 0
                               or not dropout.training):
        return conv(norm_act(norm, x, act, shift, wrap=True), wrapped=True)
    y = norm_act(norm, x, act, shift)
    return conv(y if dropout is None else dropout(y))


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoidal embedding of diffusers `get_timestep_embedding`, computed
    in f32 and cast to `dtype` at the end."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of both spatial axes."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def attention_1head(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Single-head attention over tokens; q, k, v (B, T, C), softmax in
    f32."""
    logits = torch.einsum("btc,bsc->bts", q, k) * q.shape[-1] ** -0.5
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bts,bsc->btc", weights, v)


class VaeResnetBlock(nn.Module):
    """sgm ResnetBlock (model.py:301-362): GN -> act -> conv -> GN -> act ->
    dropout -> conv, with a 1x1 `nin_shortcut` (or 3x3 `conv_shortcut`)
    when the channel count changes."""

    def __init__(self, in_channels: int, out_channels: int,
                 dropout: float = 0.0, act: str = "silu",
                 circular: bool = True, coord: bool = False,
                 use_conv_shortcut: bool = False):
        super().__init__()
        self.act = act
        self.norm1 = group_norm(in_channels)
        self.conv1 = CircularConv(in_channels, out_channels, 3, 1, 1,
                                  circular, coord)
        self.norm2 = group_norm(out_channels)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = CircularConv(out_channels, out_channels, 3, 1, 1,
                                  circular, coord)
        if in_channels != out_channels:
            if use_conv_shortcut:
                self.conv_shortcut = CircularConv(in_channels, out_channels,
                                                  3, 1, 1, circular, coord)
            else:
                self.nin_shortcut = CircularConv(in_channels, out_channels,
                                                 1, 1, 0, circular=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = norm_act_conv(self.norm1, x, self.act, self.conv1)
        h = norm_act_conv(self.norm2, h, self.act, self.conv2,
                          dropout=self.dropout)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        elif hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class VaeAttnBlock(nn.Module):
    """sgm AttnBlock (model.py:372-412): single-head self-attention with 1x1
    conv projections and a residual."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = group_norm(channels)
        self.q, self.k, self.v, self.proj_out = (
            CircularConv(channels, channels, 1, 1, 0, circular=False)
            for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, w, h = x.shape
        y = norm_act(self.norm, x)
        q, k, v = ((m(y).reshape(b, c, w * h).transpose(1, 2))
                   for m in (self.q, self.k, self.v))
        o = attention_1head(q, k, v).transpose(1, 2).reshape(b, c, w, h)
        return x + self.proj_out(o)


class VaeDownsample(nn.Module):
    """sgm Downsample (model.py:151-175): stride-2 conv with asymmetric
    padding, wrap (0, 1) on azimuth and zeros (0, 1) on beams."""

    def __init__(self, channels: int, circular: bool = True,
                 coord: bool = False, with_conv: bool = True):
        super().__init__()
        if with_conv:
            self.conv = CircularConv(channels, channels, 3, 2,
                                     ((0, 1), (0, 1)), circular, coord)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "conv"):
            return self.conv(x)
        return F.avg_pool2d(x, 2, 2)


class VaeUpsample(nn.Module):
    """sgm Upsample (model.py:110-125): nearest 2x + circular conv."""

    def __init__(self, channels: int, circular: bool = True,
                 coord: bool = False, with_conv: bool = True):
        super().__init__()
        if with_conv:
            self.conv = CircularConv(channels, channels, 3, 1, 1, circular,
                                     coord)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_nearest(x)
        return self.conv(x) if hasattr(self, "conv") else x


def pixel_unshuffle_azimuth(x: torch.Tensor, factor: int = 4) -> torch.Tensor:
    """Function form of PixelUnshuffleAzimuth: (B, C, W, H) ->
    (B, factor*C, W/factor, H), output channel local_azimuth * C + c."""
    b, c, w, h = x.shape
    x = x.reshape(b, c, w // factor, factor, h).permute(0, 3, 1, 2, 4)
    return x.reshape(b, factor * c, w // factor, h)


class PixelUnshuffleAzimuth(nn.Module):
    """SparseRangeImageEncoder2 (ldm/encoders.py:86-95): the parameter-free
    azimuth pixel unshuffle of the beam-subsampled image to latent width."""

    def __init__(self, factor: int = 4):
        super().__init__()
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_unshuffle_azimuth(x, self.factor)
