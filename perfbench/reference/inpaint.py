"""The training step of the azimuth-sector inpainting model (RangeLDM's
ldm/configs/inpainting.yaml, trained by ldm/train_conditional.py:232-251,
418-447), in float32:

  frozen VAE encode of the scan -> posterior draw * scaling factor;
  frozen VAE encode of the masked scan -> posterior draw * scaling factor,
  and the mask resized to the latent grid: the condition;
  noise and timesteps -> add_noise -> [noisy latent, condition] (9
  channels, no position channel) -> UNet -> MSE against the noise ->
  gradients -> global-norm clip at 1 -> AdamW at the warm-up's learning
  rate -> EMA with diffusers' power decay.

The rows of a batch go through the networks in chunks whose gradients add
up to the batch's, as in perfbench/reference/train.py, whose draws,
learning rate and EMA decay this file shares.

Departures from train_conditional.py, each also the program's:
* every random number comes from one generator, in the program's order:
  the scan's posterior draw, the masked scan's, the noise, the timesteps
  (the published trainer draws from torch's global generator);
* the mask is resized by nearest with half-pixel centres, which takes rows
  and columns f*i + f/2 of the scan's grid for the VAE's factor f (4:
  2, 6, 10, ...), as the JAX package's `jax.image.resize(method=
  "nearest")`. For the published sector, azimuth columns 0-63 of 1024,
  constant over the beams, this and a resize from rows f*i agree: latent
  columns 0-15 are masked either way.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.reference import unet as ref_unet
from perfbench.reference import vae as ref_vae
from perfbench.reference.precision import Precision
from perfbench.reference.schedule import Schedule
from perfbench.reference.train import draws, ema_decay, learning_rate


def resize_mask(mask: torch.Tensor, factor: int) -> torch.Tensor:
    """The mask (B, 1, W, H) on the latent grid (B, 1, W/f, H/f): the
    entries at f*i + f/2 on both axes."""
    return mask[:, :, factor // 2::factor, factor // 2::factor].float()


def encode_latents(vc: dict, vae_params: Dict[str, torch.Tensor],
                   images: torch.Tensor, noise: torch.Tensor,
                   pr: Precision, chunk: int) -> torch.Tensor:
    """The scaled posterior draw of images (B, C, W, H) given its noise,
    encoded `chunk` rows at a time."""
    moments = torch.cat([ref_vae.encode_moments(vc, vae_params, x, pr)
                         for x in images.split(chunk)])
    return ref_vae.posterior_sample(moments, noise) * float(
        vc["scaling_factor"])


def train(cfg: dict, unet_params: Dict[str, torch.Tensor],
          vae_params: Dict[str, torch.Tensor],
          batches: List[Dict[str, torch.Tensor]],
          generator: torch.Generator, pr: Precision, chunk: int,
          zero_condition: bool = False) -> dict:
    """len(batches) training steps from `unet_params` on batches of
    `jpg`, `masked_image` (B, C, W, H) and `inpainting_mask` (B, 1, W, H),
    with the step's draws from `generator`. Returns each step's loss and
    condition, each parameter's gradient after the first step's clip (the
    gradient AdamW gets), and the parameters and the EMA after the last
    step. `zero_condition` plants a fault: the condition all zeros."""
    mc, vc = cfg["model_config"], cfg["vae_config"]
    sched = Schedule(int(cfg.get("ddpm_num_steps", 1000)))
    b1, b2 = float(cfg.get("adam_beta1", 0.95)), float(cfg.get(
        "adam_beta2", 0.999))
    eps, wd = float(cfg.get("adam_epsilon", 1e-8)), float(cfg.get(
        "adam_weight_decay", 1e-6))
    f = 2 ** (len(vc["ch_mult"]) - 1)
    names = list(unet_params)
    p = {n: unet_params[n].detach().clone().float() for n in names}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    ema = {n: t.clone() for n, t in p.items()}
    out = {"losses": [], "conditions": [], "first_grads": None}
    for step, batch in enumerate(batches):
        images = batch["jpg"]
        b, _, w, h = images.shape
        latent_shape = (b, vc["z_channels"], w // f, h // f)
        with torch.no_grad():
            post = torch.randn(latent_shape, generator=generator,
                               device=images.device)
            cond_post = torch.randn(latent_shape, generator=generator,
                                    device=images.device)
            _, noise, t = draws(generator, latent_shape, None, sched.T)
            latents = encode_latents(vc, vae_params, images, post, pr, chunk)
            cond = torch.cat([
                encode_latents(vc, vae_params, batch["masked_image"],
                               cond_post, pr, chunk),
                resize_mask(batch["inpainting_mask"], f)], 1)
            if zero_condition:
                cond = torch.zeros_like(cond)
        out["conditions"].append(cond)
        leaves = {n: t_.detach().requires_grad_(True) for n, t_ in p.items()}
        total = latents.numel()
        loss = 0.0
        for lat, cd, nz, tt in zip(latents.split(chunk), cond.split(chunk),
                                   noise.split(chunk), t.split(chunk)):
            inp = torch.cat([sched.add_noise(lat, nz, tt), cd], 1)
            pred = ref_unet.forward(mc, leaves, inp, tt, pr)
            part = ((pred - nz) ** 2).sum() / total
            part.backward()
            loss += float(part.detach())
        out["losses"].append(loss)
        with torch.no_grad():
            grads = {n: leaves[n].grad for n in names}
            norm = torch.sqrt(sum(g.double().pow(2).sum()
                                  for g in grads.values()))
            factor = 1.0 if float(norm) < 1.0 else 1.0 / float(norm)
            grads = {n: g * factor for n, g in grads.items()}
            if step == 0:
                out["first_grads"] = {n: float(g.norm())
                                      for n, g in grads.items()}
            lr = learning_rate(cfg, step)
            bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
            decay = ema_decay(cfg, step)
            for n in names:
                g = grads[n]
                m[n] = b1 * m[n] + (1 - b1) * g
                v[n] = b2 * v[n] + (1 - b2) * g * g
                new = p[n] * (1 - lr * wd)
                p[n] = new - (lr / bc1) * m[n] / (
                    torch.sqrt(v[n]) / math.sqrt(bc2) + eps)
                ema[n] = ema[n] - (1 - decay) * (ema[n] - p[n])
    out["params"] = p
    out["ema"] = ema
    return out
