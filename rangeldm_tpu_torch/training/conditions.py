"""The condition functions of the conditional LDMs (ldm/train_conditional.py:
418-447, ldm/pipelines.py:406-412), on tensors in the torch layout
(B, C, W=azimuth, H=beams):

  * upsample: the parameter-free azimuth pixel unshuffle of the
    beam-subsampled image to the latent width (SparseRangeImageEncoder2);
  * inpainting: the frozen VAE's posterior draw of the masked image, times
    the scaling factor, and the inpainting mask resized to the latent grid.

The resize is nearest with half-pixel centres (`jax.image.resize(method=
"nearest")` in the JAX package): torch's "nearest-exact", which takes rows
2, 6, 10 and 14 of 16 to 4, where torch's "nearest" would take 0, 4, 8, 12.

A condition function is `cond_fn(batch, generator=None,
posterior_noise=None)`: `batch` a dict of tensors, the posterior draw from
`generator` unless `posterior_noise` (standard normal of the latent's
shape) is given, so that a test can feed the JAX package's draw.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from rangeldm_tpu_torch.models.layers import pixel_unshuffle_azimuth
from rangeldm_tpu_torch.models.vae import gaussian_sample


def make_upsample_cond_fn(factor: int = 4) -> Callable:
    def cond_fn(batch, generator=None, posterior_noise=None):
        return pixel_unshuffle_azimuth(batch["down"], factor)
    return cond_fn


def _masked_image_cond(vae, scaling_factor: float, image: torch.Tensor,
                       mask: torch.Tensor, size: Optional[Tuple[int, int]],
                       generator: Optional[torch.Generator],
                       posterior_noise: Optional[torch.Tensor]):
    moments = vae.encode_moments(image)
    z = gaussian_sample(moments.float(), generator,
                        noise=posterior_noise) * scaling_factor
    mask = F.interpolate(mask.float(), size=size or tuple(z.shape[2:]),
                         mode="nearest-exact")
    return torch.cat([z, mask], dim=1)


def make_inpainting_cond_fn(vae, scaling_factor: float,
                            latent_hw: Tuple[int, int]) -> Callable:
    """`latent_hw` is the UNet's (beams, azimuth) sample size."""
    lh, lw = latent_hw

    def cond_fn(batch, generator=None, posterior_noise=None):
        return _masked_image_cond(vae, scaling_factor,
                                  batch["masked_image"],
                                  batch["inpainting_mask"], (lw, lh),
                                  generator, posterior_noise)
    return cond_fn


def encode_masked_image_cond(vae, scaling_factor: float,
                             image: torch.Tensor, mask: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             posterior_noise: Optional[torch.Tensor] = None):
    """The sampling-time condition (LDMUpscalePipelineRange.
    encode_masked_image): the mask is resized to the latent's grid. f32."""
    return _masked_image_cond(vae, scaling_factor, image, mask, None,
                              generator, posterior_noise)
