from rangeldm_tpu_torch.pipelines.samplers import (  # noqa: F401
    conditional_latent_sample, ddim_sample, ddpm_sample, denoise,
    latent_sample, make_pos_encoding,
)
from rangeldm_tpu_torch.pipelines.api import RangePipeline  # noqa: F401
