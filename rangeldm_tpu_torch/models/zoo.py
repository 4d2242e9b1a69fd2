"""The model configurations of the reference (ldm/configs/*.yaml,
vae/configs/*.yaml) that the sampling path serves. Shapes are (beams,
azimuth)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from rangeldm_tpu_torch.diffusion.schedule import Schedule, ScheduleConfig
from rangeldm_tpu_torch.models.unet import UNetConfig
from rangeldm_tpu_torch.models.vae import VaeConfig

_ATTN4 = dict(
    down_block_types=("DownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D",
                      "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "AttnUpBlock2D", "AttnUpBlock2D",
                    "UpBlock2D"),
    block_out_channels=(128, 128, 256, 256),
)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    unet: UNetConfig
    vae: Optional[VaeConfig]               # None => pixel space
    image_size: Tuple[int, int]            # (beams, azimuth)
    sensor: str = "kitti360"
    pos_encoding: bool = True
    cond_channels: int = 0
    num_inference_steps: int = 50
    schedule: ScheduleConfig = ScheduleConfig()

    @property
    def latent_shape(self) -> Tuple[int, int, int]:
        h, w = self.unet.sample_size
        return (h, w, self.unet.out_channels)

    def make_schedule(self) -> Schedule:
        return Schedule(self.schedule)


def rangeldm_kitti360() -> ModelSpec:
    """ldm/configs/RangeLDM.yaml, the flagship: 64x1024 KITTI-360 latent
    diffusion on a 16x256x4 latent."""
    return ModelSpec(
        name="rangeldm_kitti360",
        unet=UNetConfig(sample_size=(16, 256), in_channels=5, out_channels=4,
                        **_ATTN4),
        vae=VaeConfig(),
        image_size=(64, 1024),
    )


def rangedm_kitti360() -> ModelSpec:
    """ldm/configs/RangeDM.yaml: pixel-space DDPM on the whole 64x1024x2
    range image, attention at the fifth level (4x64) and in the mid block
    (2x32)."""
    return ModelSpec(
        name="rangedm_kitti360",
        unet=UNetConfig(
            sample_size=(64, 1024), in_channels=3, out_channels=2,
            block_out_channels=(128, 128, 256, 256, 512, 512),
            down_block_types=("DownBlock2D",) * 4 + ("AttnDownBlock2D",
                                                     "DownBlock2D"),
            up_block_types=("UpBlock2D", "AttnUpBlock2D") + ("UpBlock2D",) * 4,
        ),
        vae=None,
        image_size=(64, 1024),
    )


def rangeldm_nuscenes() -> ModelSpec:
    """ldm/configs/nuscenes.yaml: 32x1024 nuScenes latent diffusion on an
    8x256x4 latent."""
    return ModelSpec(
        name="rangeldm_nuscenes",
        unet=UNetConfig(sample_size=(8, 256), in_channels=5, out_channels=4,
                        **_ATTN4),
        vae=VaeConfig(resolution=256),
        image_size=(32, 1024),
        sensor="nuscenes",
    )


def rangeldm_upsample() -> ModelSpec:
    """ldm/configs/upsample.yaml: 4x beam densification; the condition is
    the 8-channel pixel unshuffle of the 16-beam image
    (ldm/train_conditional.py:236)."""
    return ModelSpec(
        name="rangeldm_upsample",
        unet=UNetConfig(sample_size=(16, 256), in_channels=12, out_channels=4,
                        **_ATTN4),
        vae=VaeConfig(),
        image_size=(64, 1024),
        pos_encoding=False,
        cond_channels=8,
    )


def rangeldm_inpainting() -> ModelSpec:
    """ldm/configs/inpainting.yaml: azimuth-sector inpainting; the condition
    is the masked image's latent (4 channels) and the resized mask (1)."""
    return ModelSpec(
        name="rangeldm_inpainting",
        unet=UNetConfig(sample_size=(16, 256), in_channels=9, out_channels=4,
                        **_ATTN4),
        vae=VaeConfig(),
        image_size=(64, 1024),
        pos_encoding=False,
        cond_channels=5,
    )


ZOO = {
    "rangeldm_kitti360": rangeldm_kitti360,
    "rangedm_kitti360": rangedm_kitti360,
    "rangeldm_nuscenes": rangeldm_nuscenes,
    "rangeldm_upsample": rangeldm_upsample,
    "rangeldm_inpainting": rangeldm_inpainting,
}


def get_model_spec(name: str) -> ModelSpec:
    if name not in ZOO:
        raise KeyError(f"unknown model {name!r}; available: {sorted(ZOO)} "
                       f"(or pass an inline model_config)")
    return ZOO[name]()
