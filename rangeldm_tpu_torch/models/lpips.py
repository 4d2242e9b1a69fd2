"""Perceptual losses of the VAE trainer (the JAX package's
rangeldm_tpu/models/lpips.py): VGG16-LPIPS and the darknet53 feature
distance.

* `LPIPS` (vae/sgm/modules/autoencoding/lpips/loss/lpips.py:12-123): the
  scaling layer, the five torchvision-vgg16 feature slices (relu1_2,
  relu2_2, relu3_3, relu4_3, relu5_3), unit-normalized channels, learned
  non-negative 1x1 `lin` weights, a spatial mean, summed over slices. Its
  state dict is the lpips package's (`net.slice{s}.{i}.weight`,
  `lin{k}.model.1.weight`, `scaling_layer.shift` / `.scale`), so a torch
  LPIPS checkpoint loads as it is.
* `DarknetFeatureLoss` (loss/darknet.py:195-224): the darknet53 backbone
  of metrics/rangenet.py (running BatchNorm statistics) on the 5-channel
  [range, x, y, z, remission] image; squared-difference means over the
  stem and the five encoder stages, summed. A RangeNet++ `backbone` file
  loads as it is.

Without a checkpoint both start from a seeded random init, with a warning,
as in the JAX package; nothing is downloaded.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from rangeldm_tpu_torch.convert import load_torch_state_dict
from rangeldm_tpu_torch.geometry.inverse import to_point_cloud
from rangeldm_tpu_torch.metrics.rangenet import DarknetBackbone

log = logging.getLogger(__name__)

# torchvision vgg16 'D' features and the lpips slices over their indices
_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512)
_SLICES = ((0, 4), (4, 9), (9, 16), (16, 23), (23, 30))
_LPIPS_CHNS = (64, 128, 256, 512, 512)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _vgg_features():
    """The torchvision vgg16.features layers, as (index, module)."""
    layers, cin = [], 3
    for v in _VGG_CFG:
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
            cin = v
    return list(enumerate(layers))


class VGG16Slices(nn.Module):
    """vgg16.features cut into the five lpips slices; forward returns each
    slice's output."""

    def __init__(self):
        super().__init__()
        layers = _vgg_features()
        for s, (lo, hi) in enumerate(_SLICES, start=1):
            seq = nn.Sequential()
            for i, m in layers[lo:hi]:
                seq.add_module(str(i), m)
            setattr(self, f"slice{s}", seq)

    def forward(self, x: torch.Tensor):
        outs = []
        for s in range(1, len(_SLICES) + 1):
            x = getattr(self, f"slice{s}")(x)
            outs.append(x)
        return outs


class ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None,
                                                           None])
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None,
                                                           None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.shift) / self.scale


class NetLinLayer(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(0.0),
                                   nn.Conv2d(channels, 1, 1, bias=False))


def normalize_tensor(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit norm over channels, eps inside the square root as well, so the
    gradient at an all-zero pixel is finite (rangeldm_tpu/models/lpips.py:
    68-76)."""
    norm = torch.sqrt(torch.sum(feat ** 2, dim=1, keepdim=True) + eps ** 2)
    return feat / (norm + eps)


class LPIPS(nn.Module):
    """forward(x, y): (B, 3, H, W) images in [-1, 1] -> (B,) distances."""

    def __init__(self):
        super().__init__()
        self.scaling_layer = ScalingLayer()
        self.net = VGG16Slices()
        for k, c in enumerate(_LPIPS_CHNS):
            lin = NetLinLayer(c)
            nn.init.ones_(lin.model[1].weight)
            setattr(self, f"lin{k}", lin)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        # one batched pass over [x; y]
        feats = self.net(self.scaling_layer(torch.cat([x, y], dim=0)))
        total = 0.0
        for k, f in enumerate(feats):
            diff = (normalize_tensor(f[:n]) - normalize_tensor(f[n:])) ** 2
            w = F.relu(getattr(self, f"lin{k}").model[1].weight)
            total = total + F.conv2d(diff, w).mean(dim=(1, 2, 3))
        return total


class DarknetFeatureLoss(nn.Module):
    """forward(x, y): (B, 5, H, W) [range, x, y, z, remission] images ->
    (B,) distances."""

    def __init__(self):
        super().__init__()
        self.backbone = DarknetBackbone()
        self.backbone.eval()

    def train(self, mode: bool = True) -> "DarknetFeatureLoss":
        """The backbone stays on its running statistics."""
        return super().train(False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        out, skips = self.backbone(torch.cat([x, y], dim=0))
        total = 0.0
        for f in [skips[k] for k in (1, 2, 4, 8, 16)] + [out]:
            total = total + ((f[:n] - f[n:]) ** 2).mean(dim=(1, 2, 3))
        return total


def _seeded(cls) -> nn.Module:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return cls()


def make_perceptual_fn(checkpoint: Optional[str] = None, kind: str = "vgg",
                       spec=None, device=None) -> Callable:
    """`perceptual_fn(x, y) -> (B,)` for the VAE loss, frozen.

    kind='vgg': (B, 3, H, W) images (the BEV three-channel construction);
    `checkpoint` is the state dict of a torch `lpips.LPIPS(net="vgg")`. kind='darknet': (B, C, W, H)
    range images in this package's layout; the 5-channel input is built
    with the inverse projection of `spec`, and `checkpoint` is a RangeNet++
    backbone state dict."""
    if kind == "vgg":
        model = _seeded(LPIPS)
    elif kind == "darknet":
        if spec is None:
            raise ValueError("darknet perceptual needs the sensor spec")
        model = _seeded(DarknetFeatureLoss)
    else:
        raise ValueError(kind)
    if checkpoint:
        target = model if kind == "vgg" else model.backbone
        target.load_state_dict(load_torch_state_dict(checkpoint),
                               strict=True)
    else:
        log.warning("%s perceptual loss: no checkpoint given; using "
                    "random-init features", kind)
    model = model.to(device).eval().requires_grad_(False)
    if kind == "vgg":
        return model

    def with_xyz(img: torch.Tensor) -> torch.Tensor:
        """(B, C, W, H) range image -> (B, 5, H, W) [range, x, y, z,
        remission] (the evident intent of the reference's missing
        to_range_image.with_xyz, losses/__init__.py:260-261)."""
        nhwc = img.permute(0, 3, 2, 1)
        b, h, w, c = nhwc.shape
        xyz = to_point_cloud(nhwc, spec)[..., :3].reshape(b, h, w, 3)
        rem = (nhwc[..., 1:2] if c > 1 else torch.zeros_like(nhwc[..., :1]))
        return torch.cat([nhwc[..., :1], xyz, rem], dim=-1).permute(
            0, 3, 1, 2)

    def fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return model(with_xyz(x), with_xyz(y))
    return fn
