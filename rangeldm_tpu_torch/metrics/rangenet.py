"""RangeNet++ darknet53 segmentation network, the FRD feature extractor
and the IoU/accuracy segmenter.

The vendored lidar-bonnetal model (metrics/rangenetpp/lidar_bonnetal_master/
train/backbones/darknet.py, tasks/semantic/decoders/darknet.py,
modules/segmentator.py) in its own layout: standard NCHW with H = 64
beams and W = 1024 azimuth (unlike the RangeLDM stack's (B, C, W, H)).
The sub-modules `backbone`, `decoder` and `head` carry the released key
grammar (`conv1.weight`, `enc{s}.residual_{b}.conv1.weight`,
`dec{s}.upconv.weight`, the head's `1.weight`), so the released
`backbone`, `segmentation_decoder` and `segmentation_head` files load with
`load_state_dict(strict=True)` and no remapping.

FRD reads the decoder's final 32-channel feature map (decoders/darknet.py:
122-134); IoU/accuracy read the head's argmax. The network only infers:
every BatchNorm uses its running statistics whatever `train()` was asked
for, so a scan's features do not depend on the batch it is in, and the
forward runs in full float32 (TF32 off, `utils.precision.tf32`).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from rangeldm_tpu_torch.utils.precision import tf32

# Sensor normalization from the darknet53-1024 arch config
# (lidar-bonnetal data/sensor: img_means/img_stds for [range, x, y, z,
# remission]).
KITTI_IMG_MEANS = np.array([12.12, 10.88, 0.23, -1.04, 0.21], np.float32)
KITTI_IMG_STDS = np.array([12.32, 11.47, 6.91, 0.86, 0.16], np.float32)

BLOCKS_53 = (1, 2, 8, 8, 4)
CHANNELS = (32, 64, 128, 256, 512, 1024)
BN_EPS = 1e-5
SLOPE = 0.1


class BasicBlock(nn.Module):
    """1x1 bottleneck + 3x3 conv, each with BN and LeakyReLU(0.1), plus the
    residual (backbones/darknet.py:10-33)."""

    def __init__(self, inplanes: int, planes: Sequence[int]):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes[0], 1, 1, 0, bias=False)
        self.bn1 = nn.BatchNorm2d(planes[0], eps=BN_EPS)
        self.relu1 = nn.LeakyReLU(SLOPE)
        self.conv2 = nn.Conv2d(planes[0], planes[1], 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes[1], eps=BN_EPS)
        self.relu2 = nn.LeakyReLU(SLOPE)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu1(self.bn1(self.conv1(x)))
        return self.relu2(self.bn2(self.conv2(out))) + x


def enc_layer(planes: Sequence[int], blocks: int) -> nn.Sequential:
    """A downsampling stage (backbones/darknet.py:129-148): a 3x3 conv with
    stride 2 on azimuth only, then `blocks` residual blocks."""
    layers = [("conv", nn.Conv2d(planes[0], planes[1], 3, (1, 2), 1,
                                 bias=False)),
              ("bn", nn.BatchNorm2d(planes[1], eps=BN_EPS)),
              ("relu", nn.LeakyReLU(SLOPE))]
    layers += [(f"residual_{i}", BasicBlock(planes[1], planes))
               for i in range(blocks)]
    return nn.Sequential(OrderedDict(layers))


def dec_layer(planes: Sequence[int]) -> nn.Sequential:
    """An upsampling stage (decoders/darknet.py:96-113): ConvTranspose2d
    (1, 4) with stride 2 on azimuth, BN, LeakyReLU, then one residual
    block widening to planes[0] and back."""
    return nn.Sequential(OrderedDict([
        ("upconv", nn.ConvTranspose2d(planes[0], planes[1], (1, 4),
                                      stride=(1, 2), padding=(0, 1))),
        ("bn", nn.BatchNorm2d(planes[1], eps=BN_EPS)),
        ("relu", nn.LeakyReLU(SLOPE)),
        ("residual", BasicBlock(planes[1], planes)),
    ]))


class DarknetBackbone(nn.Module):
    """The darknet53 encoder. Returns (features, skips): skips[os] is the
    input of the stage that takes the output stride from os to 2*os
    (run_layer, backbones/darknet.py:150-156)."""

    def __init__(self, in_channels: int = 5):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, CHANNELS[0], 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(CHANNELS[0], eps=BN_EPS)
        self.relu1 = nn.LeakyReLU(SLOPE)
        for s, blocks in enumerate(BLOCKS_53, start=1):
            self.add_module(f"enc{s}", enc_layer(CHANNELS[s - 1:s + 1],
                                                 blocks))

    def forward(self, x: torch.Tensor):
        x = self.relu1(self.bn1(self.conv1(x)))
        skips: Dict[int, torch.Tensor] = {}
        os = 1
        for s in range(1, len(BLOCKS_53) + 1):
            skips[os] = x
            os *= 2
            x = getattr(self, f"enc{s}")(x)
        return x, skips


class DarknetDecoder(nn.Module):
    """Five upsampling stages dec5 ... dec1, each followed by the skip of
    its output stride (decoders/darknet.py:115-134)."""

    def __init__(self):
        super().__init__()
        for s in range(len(BLOCKS_53), 0, -1):
            self.add_module(f"dec{s}", dec_layer((CHANNELS[s],
                                                  CHANNELS[s - 1])))

    def forward(self, x: torch.Tensor, skips: Dict[int, torch.Tensor]):
        os = 2 ** len(BLOCKS_53)
        for s in range(len(BLOCKS_53), 0, -1):
            x = getattr(self, f"dec{s}")(x)
            os //= 2
            x = x + skips[os]
        return x


def segmentation_head(n_classes: int = 20) -> nn.Sequential:
    """modules/segmentator.py's head: Dropout2d, then a 3x3 conv to the
    class logits (keys `1.weight`, `1.bias`)."""
    return nn.Sequential(nn.Dropout2d(0.0),
                         nn.Conv2d(CHANNELS[0], n_classes, 3, padding=1))


class RangeNet(nn.Module):
    """Backbone + decoder (+ optional head). forward((B, 5, H, W)) returns
    (features (B, 32, H, W), logits (B, n_classes, H, W) or None). W must
    divide by 32."""

    def __init__(self, n_classes: int = 20, with_head: bool = True):
        super().__init__()
        self.backbone = DarknetBackbone()
        self.decoder = DarknetDecoder()
        self.head = segmentation_head(n_classes) if with_head else None
        self.eval()

    @property
    def with_head(self) -> bool:
        return self.head is not None

    def train(self, mode: bool = True) -> "RangeNet":
        """Inference only: BatchNorm stays on its running statistics."""
        return super().train(False)

    def forward(self, x: torch.Tensor):
        with tf32(False):
            features = self.decoder(*self.backbone(x))
            logits = self.head(features) if self.head is not None else None
        return features, logits

    @classmethod
    def from_state_dicts(cls, backbone: Dict[str, torch.Tensor],
                         decoder: Dict[str, torch.Tensor],
                         head: Optional[Dict[str, torch.Tensor]] = None
                         ) -> "RangeNet":
        """A RangeNet from the released three state dicts (the head's may
        be None), each loaded with strict=True."""
        model = cls(n_classes=head["1.weight"].shape[0] if head else 20,
                    with_head=head is not None)
        model.backbone.load_state_dict(backbone, strict=True)
        model.decoder.load_state_dict(decoder, strict=True)
        if head is not None:
            model.head.load_state_dict(head, strict=True)
        return model.requires_grad_(False)


def preprocess_scan(proj_range, proj_xyz, proj_remission, proj_mask,
                    means=KITTI_IMG_MEANS, stds=KITTI_IMG_STDS):
    """Build the normalized 5-channel input
    (modules/kittiparser.py:386-395): cat([range, xyz, remission]),
    standardize, zero where no return. All inputs (H, W[, 3]) numpy; the
    result is (H, W, 5)."""
    proj = np.concatenate([proj_range[..., None], proj_xyz,
                           proj_remission[..., None]], axis=-1)
    proj = (proj - means) / stds
    return (proj * proj_mask[..., None]).astype(np.float32)
