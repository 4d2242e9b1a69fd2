"""The operations of one VAE-GAN step (one generator and one discriminator
step), counted on the reference (perfbench/reference/vae_gan.py) on the
meta device, where nothing is computed, with `torch.utils.flop_counter`
as work.py counts the diffusion models: convolutions and linear layers,
forward and backward, a multiply-add counted as two. The MetaKernel's
patch products, the normalisations, the losses and the updates are
elementwise and not counted. Because the count comes from the reference,
it reads the same whatever later implements the step.
"""

from __future__ import annotations

import functools
import json
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import vae as ref_vae
from perfbench.reference import vae_gan as ref_gan
from perfbench.reference.precision import REFERENCE


def _meta(shapes) -> Dict[str, torch.Tensor]:
    return {n: torch.empty(s, device="meta") for n, s in shapes.items()}


@functools.lru_cache(maxsize=None)
def _counts(key: str, batch: int) -> Dict[str, float]:
    cfg = json.loads(key)
    vc, lc = cfg["vae"], cfg["loss"]
    h, w = cfg["image_size"]
    f = 2 ** (len(vc["ch_mult"]) - 1)
    vae_p = _meta(ref_vae.param_shapes(vc))
    disc_p = _meta(ref_gan.disc_param_shapes(lc))
    stats = ref_gan.disc_stats(lc, "meta")
    x = torch.empty((batch, vc["in_channels"], w, h), device="meta")
    noise = torch.empty((batch, vc["z_channels"], w // f, h // f),
                        device="meta")
    with FlopCounterMode(display=False) as disc_fwd:
        ref_gan.discriminator(cfg, disc_p, stats, x, REFERENCE)
    with FlopCounterMode(display=False) as gen:
        ref_gan.gen_step(cfg, vae_p, disc_p, stats, x, noise, 1.0,
                         REFERENCE)
    with FlopCounterMode(display=False) as disc:
        ref_gan.disc_step(cfg, vae_p, disc_p, stats, x, noise, 1.0,
                          REFERENCE)
    g, d = float(gen.get_total_flops()), float(disc.get_total_flops())
    return {"gen_step": g, "disc_step": d, "step": g + d,
            "disc_forward": float(disc_fwd.get_total_flops())}


def vae_gan_counts(cfg: dict, batch: int) -> Dict[str, float]:
    """Operations of a step at `batch`: `step`, its `gen_step` and
    `disc_step`, and one discriminator forward (`disc_forward`)."""
    key = json.dumps({k: cfg[k] for k in ("vae", "loss", "data",
                                          "image_size")}, sort_keys=True)
    return _counts(key, batch)


def step_flops(cfg: dict, batch: int) -> float:
    return vae_gan_counts(cfg, batch)["step"]
