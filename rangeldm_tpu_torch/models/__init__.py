from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig  # noqa: F401
from rangeldm_tpu_torch.models.vae import (  # noqa: F401
    AutoencoderKL, Decoder, Encoder, VaeConfig,
)
from rangeldm_tpu_torch.models.zoo import (  # noqa: F401
    ModelSpec, rangedm_kitti360, rangeldm_inpainting, rangeldm_kitti360,
    rangeldm_nuscenes, rangeldm_upsample,
)
