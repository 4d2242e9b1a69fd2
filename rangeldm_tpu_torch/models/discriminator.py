"""PatchGAN discriminators of the VAE's GAN loss (the JAX package's
rangeldm_tpu/models/discriminator.py, after the reference's
vae/sgm/modules/autoencoding/lpips/model/model.py:18-373), on the layout
(B, C, W=azimuth, H=beams).

* `NLayerDiscriminator`: the pix2pix PatchGAN, zero-padded 4x4 convs,
  BatchNorm and LeakyReLU(0.2).
* `MetaKernel`: a range-conditioned 4x4 "conv". Every 4x4 patch of the
  input is weighted, per position and channel, by an MLP of the patch's
  relative xyz (from the range channel), then mixed by a 1x1 conv `coov`.
  Beams are padded with the constant 100 (range) or 0 (features), azimuth
  circularly. Patches are strided views (`Tensor.unfold`), flattened in
  the order (C, k_beam, k_azimuth) of the reference's reshape.
* `NLayerDiscriminatorMetaKernel` (every conv a MetaKernel, angular steps
  doubling at each stride-2 stage) and `NLayerDiscriminatorMetaKernel2`
  (two MetaKernel stages, then plain convs).

Module names follow the reference's state dict (`main.{i}` in the order
of its nn.Sequential, `main.{i}.mlp_coord.{0,2}`, `main.{i}.coov`), so the
`loss.discriminator.*` subtree of an sgm checkpoint maps by name.

`BatchNorm` keeps flax's statistics: in train mode it normalizes with the
batch's biased variance and moves the running variance towards that same
biased variance (momentum 0.9 in flax's convention, 0.1 in torch's);
torch's BatchNorm2d moves it towards the unbiased one.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

SLOPE = 0.2
# the reference's default angular steps (model.py:174-180): azimuth
# 2*pi/1024, inclination from the KITTI beam spacing
AZI = 0.00613592
INC = 0.0074594


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with flax's running-variance update (the biased batch
    variance); eps 1e-5, flax momentum 0.9 (torch momentum 0.1)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, SLOPE)


def _patches(v: torch.Tensor, fill: float, k: int, stride: int,
             pad: int) -> torch.Tensor:
    """(B, C, W, H) -> (B, C, Wo, Ho, k_beam, k_azimuth) windows: beams
    padded with `fill`, azimuth circularly."""
    v = F.pad(v, (pad, pad, 0, 0), value=fill)
    v = F.pad(v, (0, 0, pad, pad), mode="circular")
    return v.unfold(3, k, stride).unfold(2, k, stride)


class MetaKernel(nn.Module):
    """forward(x (B, C, W, H), r (B, 1, W, H) range in decametres) ->
    (y (B, out, Wo, Ho), the patch centres' range (B, 1, Wo, Ho))."""

    def __init__(self, in_channels: int, out_channels: int, azi: float,
                 inc: float, kernel_size: int = 4, stride: int = 2,
                 padding: int = 1):
        super().__init__()
        self.k, self.stride, self.padding = kernel_size, stride, padding
        c, k = in_channels, kernel_size
        self.mlp_coord = nn.Sequential(nn.Linear(3, c), nn.LeakyReLU(SLOPE),
                                       nn.Linear(c, c))
        self.coov = nn.Conv2d(c * k * k, out_channels, 1)
        offs = np.arange(k) - k // 2
        # (k_beam, k_azimuth) tables, float64 on the host, as the reference
        # builds them
        for name, table in (
                ("cos_azi", np.cos(azi * offs)[None, :]),
                ("sin_azi", np.sin(azi * offs)[None, :]),
                ("cos_inc", np.cos(inc * offs)[:, None]),
                ("sin_inc", np.sin(inc * offs)[:, None])):
            self.register_buffer(name, torch.tensor(table, dtype=torch.float32),
                                 persistent=False)

    def forward(self, x: torch.Tensor, r: torch.Tensor):
        k, s, p = self.k, self.stride, self.padding
        b, c = x.shape[:2]
        r_pat = _patches(r, 100.0, k, s, p)[:, 0]        # (B, Wo, Ho, kb, ka)
        r_center = r_pat[..., k // 2, k // 2]
        az_cos = self.cos_azi.to(r.dtype)
        pe = torch.stack([
            r_pat * az_cos * self.cos_inc.to(r.dtype)
            - r_center[..., None, None],
            r_pat * az_cos * self.sin_inc.to(r.dtype),
            r_pat * self.sin_azi.to(r.dtype)], dim=-1)
        w = self.mlp_coord(pe)                            # (B, Wo, Ho, kb, ka, C)
        x_pat = _patches(x, 0.0, k, s, p) * w.permute(0, 5, 1, 2, 3, 4)
        wo, ho = x_pat.shape[2:4]
        x_flat = x_pat.permute(0, 1, 4, 5, 2, 3).reshape(b, c * k * k, wo, ho)
        return self.coov(x_flat), r_center[:, None]


def _conv(cin: int, cout: int, stride: int, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 4, stride, 1, bias=bias)


def _init_weights(module: nn.Module) -> None:
    """weights_init (model.py:9-15): convs N(0, 0.02), BatchNorm scales
    N(1, 0.02), their biases 0; the MetaKernel MLPs keep torch's default."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.normal_(m.weight, 0.0, 0.02)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.normal_(m.weight, 1.0, 0.02)
            nn.init.zeros_(m.bias)


def _range_decametres(x: torch.Tensor, log_encoding: bool, mean: float,
                      std: float) -> torch.Tensor:
    """Channel 0, the normalized range, in decametres (model.py:255-264)."""
    r = x[:, :1]
    if log_encoding:
        return (64.0 ** torch.clamp(r, 0.0, 1.2) - 1.0) / 10.0
    return (r * std + mean) / 10.0


def _too_small(x: torch.Tensor, extent: int, what: str) -> ValueError:
    return ValueError(
        f"input {tuple(x.shape)} too small for a {what} (final feature "
        f"extent {extent})")


class NLayerDiscriminator(nn.Module):
    """The pix2pix PatchGAN (model.py:18-89): `n_layers` stride-2 4x4 convs,
    then two stride-1 ones; (B, C, W, H) -> (B, 1, Wo, Ho) logits."""

    def __init__(self, input_nc: int = 2, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        layers: List[nn.Module] = [_conv(input_nc, ndf, 2, bias=True),
                                   nn.LeakyReLU(SLOPE)]
        nf = 1
        for n in range(1, n_layers):
            prev, nf = nf, min(2 ** n, 8)
            layers += [_conv(ndf * prev, ndf * nf, 2), BatchNorm(ndf * nf),
                       nn.LeakyReLU(SLOPE)]
        prev, nf = nf, min(2 ** n_layers, 8)
        layers += [_conv(ndf * prev, ndf * nf, 1), BatchNorm(ndf * nf),
                   nn.LeakyReLU(SLOPE), _conv(ndf * nf, 1, 1, bias=True)]
        self.main = nn.Sequential(*layers)
        _init_weights(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        extent = min(x.shape[2:])
        for _ in range(self.n_layers):
            extent = (extent - 2) // 2 + 1
        if extent - 2 < 1:
            raise _too_small(x, extent - 2,
                             f"{self.n_layers}-layer PatchGAN")
        return self.main(x)


class _RangeDiscriminator(nn.Module):
    """The MetaKernel discriminators' shared parts: the range channel in
    decametres, and `main` run in index order, a MetaKernel passing its
    patch centres' range on to the next."""

    def __init__(self, log_encoding: bool, range_mean: float,
                 range_std: float):
        super().__init__()
        self.log_encoding = log_encoding
        self.range_mean, self.range_std = range_mean, range_std
        self.main = nn.ModuleDict()
        self.plan: List[Tuple[str, bool]] = []     # (index, LeakyReLU after)

    def add(self, index: int, module: nn.Module, act: bool) -> None:
        self.main[str(index)] = module
        self.plan.append((str(index), act))

    def run(self, x: torch.Tensor) -> torch.Tensor:
        r = _range_decametres(x, self.log_encoding, self.range_mean,
                              self.range_std)
        h = x
        for index, act in self.plan:
            m = self.main[index]
            if isinstance(m, MetaKernel):
                h, r = m(h, r)
            else:
                h = m(h)
            if act:
                h = _leaky(h)
        return h


class NLayerDiscriminatorMetaKernel(_RangeDiscriminator):
    """The MetaKernel PatchGAN (model.py:173-265): every conv a MetaKernel
    whose angular steps double at each stride-2 stage."""

    def __init__(self, input_nc: int = 2, ndf: int = 64, n_layers: int = 3,
                 azi: float = AZI, inc: float = INC,
                 log_encoding: bool = False, range_mean: float = 20.0,
                 range_std: float = 40.0):
        super().__init__(log_encoding, range_mean, range_std)
        self.n_layers = n_layers
        self.add(0, MetaKernel(input_nc, ndf, azi, inc, stride=2), True)
        azi, inc = azi * 2, inc * 2
        nf, idx = 1, 2
        for n in range(1, n_layers):
            prev, nf = nf, min(2 ** n, 8)
            self.add(idx, MetaKernel(ndf * prev, ndf * nf, azi, inc,
                                     stride=2), False)
            self.add(idx + 1, BatchNorm(ndf * nf), True)
            azi, inc = azi * 2, inc * 2
            idx += 3
        prev, nf = nf, min(2 ** n_layers, 8)
        self.add(idx, MetaKernel(ndf * prev, ndf * nf, azi, inc, stride=1),
                 False)
        self.add(idx + 1, BatchNorm(ndf * nf), True)
        idx += 3
        self.add(idx, MetaKernel(ndf * nf, 1, azi, inc, stride=1), False)
        _init_weights(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a clear error before a stage collapses to no extent
        eh, ew = x.shape[3], x.shape[2]
        for _ in range(self.n_layers):
            eh, ew = (eh - 2) // 2 + 1, (ew - 2) // 2 + 1
            if eh <= 0 or ew <= 0:
                raise ValueError(
                    f"input {tuple(x.shape)} too small for a "
                    f"{self.n_layers}-layer MetaKernel discriminator: a "
                    f"stride-2 stage collapses to zero spatial extent")
        if min(eh, ew) - 2 < 1:
            raise _too_small(x, min(eh, ew) - 2,
                             f"{self.n_layers}-layer MetaKernel "
                             f"discriminator")
        return self.run(x)


class NLayerDiscriminatorMetaKernel2(_RangeDiscriminator):
    """The hybrid (model.py:268-373): two MetaKernel stages, then plain
    zero-padded 4x4 convs; the `metakernel: 2` config."""

    def __init__(self, input_nc: int = 2, ndf: int = 64, n_layers: int = 3,
                 azi: float = AZI, inc: float = INC,
                 log_encoding: bool = False, range_mean: float = 20.0,
                 range_std: float = 40.0):
        super().__init__(log_encoding, range_mean, range_std)
        self.add(0, MetaKernel(input_nc, ndf, azi, inc, stride=2), True)
        self.add(2, MetaKernel(ndf, ndf * 2, azi * 2, inc * 2, stride=2),
                 False)
        self.add(3, BatchNorm(ndf * 2), True)
        nf, idx = 2, 5
        for n in range(2, n_layers):
            prev, nf = nf, min(2 ** n, 8)
            self.add(idx, _conv(ndf * prev, ndf * nf, 2), False)
            self.add(idx + 1, BatchNorm(ndf * nf), True)
            idx += 3
        prev, nf = nf, min(2 ** n_layers, 8)
        self.add(idx, _conv(ndf * prev, ndf * nf, 1), False)
        self.add(idx + 1, BatchNorm(ndf * nf), True)
        idx += 3
        self.add(idx, _conv(ndf * nf, 1, 1, bias=True), False)
        _init_weights(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run(x)
