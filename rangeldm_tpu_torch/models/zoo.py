"""The model configurations of the reference (ldm/configs/*.yaml,
vae/configs/*.yaml) that the sampling path serves. Shapes are (beams,
azimuth)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from rangeldm_tpu_torch.diffusion.schedule import ScheduleConfig
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


# the unconditional configurations; the conditional ones (upsample,
# inpainting) come with conditional sampling and training
ZOO = {
    "rangeldm_kitti360": rangeldm_kitti360,
    "rangeldm_nuscenes": rangeldm_nuscenes,
}


def get_model_spec(name: str) -> ModelSpec:
    if name not in ZOO:
        raise KeyError(f"unknown model {name!r}; available: {sorted(ZOO)} "
                       f"(or pass an inline model_config)")
    return ZOO[name]()
