"""The training step of the reference configurations, in float32:

  frozen VAE encode -> posterior draw * scaling factor (latent models) ->
  noise and timesteps -> add_noise -> [noisy, pos channel] -> UNet ->
  MSE against the noise -> gradients -> global-norm clip at 1 ->
  AdamW (bias-corrected, decoupled weight decay) at the warm-up's
  learning rate -> EMA with diffusers' power decay.

The rows of a batch go through the networks in chunks whose gradients
add up to the batch's, so that the reference fits beside nothing else.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import unet as ref_unet
from perfbench.reference import vae as ref_vae
from perfbench.reference.precision import Precision
from perfbench.reference.schedule import Schedule


def pos_channel(b: int, w: int, h: int, device) -> torch.Tensor:
    """The position channel (B, 1, W, H): 1 at azimuth column 0, else 0."""
    pos = torch.zeros((b, 1, w, h), device=device)
    pos[:, :, 0, :] = 1.0
    return pos


def draws(generator: torch.Generator, latent_shape, moments_shape,
          num_train_timesteps: int):
    """The random numbers of one step, in the order the program's step
    makes them from its generator: the posterior draw (latent models:
    `moments_shape` is not None), the noise, the timesteps."""
    dev = generator.device
    post = None
    if moments_shape is not None:
        b, c, *rest = moments_shape
        post = torch.randn((b, c // 2, *rest), generator=generator,
                           device=dev)
    noise = torch.randn(latent_shape, generator=generator,
                        dtype=torch.float32, device=dev)
    t = torch.randint(0, num_train_timesteps, (latent_shape[0],),
                      generator=generator, device=dev)
    return post, noise, t


def learning_rate(cfg: dict, step: int) -> float:
    """The warm-up and cosine decay of the shipped configs at update
    `step` (0 for the first update, whose learning rate is 0)."""
    peak = float(cfg.get("learning_rate", 1e-4))
    warm = int(cfg.get("lr_warmup_steps", 500))
    if step < warm:
        return peak * step / warm
    total = max(int(cfg.get("total_steps", 1_000_000)), warm + 1)
    frac = min(step - warm, total - warm) / (total - warm)
    if cfg.get("lr_scheduler", "cosine") == "constant":
        return peak
    return peak * 0.5 * (1 + math.cos(math.pi * frac))


def ema_decay(cfg: dict, step: int) -> float:
    """diffusers' EMA warm-up 1 - (1 + step / inv_gamma)^-power, clipped
    to [0, ema_max_decay], at the update's step count before it."""
    f32 = np.float32
    value = f32(1) - (f32(1) + f32(step) / f32(cfg.get("ema_inv_gamma", 1.0))
                      ) ** f32(-cfg.get("ema_power", 0.75))
    return float(np.clip(value, f32(0), f32(cfg.get("ema_max_decay",
                                                    0.9999))))


def train(cfg: dict, unet_params: Dict[str, torch.Tensor],
          vae_params: Optional[Dict[str, torch.Tensor]],
          batches: List[torch.Tensor], generator: torch.Generator,
          pr: Precision, chunk: int) -> dict:
    """len(batches) training steps from `unet_params` on images (B, C, W,
    H), with the step's draws from `generator`. Returns each step's loss,
    each parameter's gradient after the first step's clip (the gradient
    AdamW gets), and the parameters and the EMA after the last step."""
    mc, vc = cfg["model_config"], cfg.get("vae_config")
    sched = Schedule(int(cfg.get("ddpm_num_steps", 1000)))
    b1, b2 = float(cfg.get("adam_beta1", 0.95)), float(cfg.get(
        "adam_beta2", 0.999))
    eps, wd = float(cfg.get("adam_epsilon", 1e-8)), float(cfg.get(
        "adam_weight_decay", 1e-6))
    sf = float(vc["scaling_factor"]) if vc else 1.0
    names = list(unet_params)
    p = {n: unet_params[n].detach().clone().float() for n in names}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    ema = {n: t.clone() for n, t in p.items()}
    out = {"losses": [], "first_grads": None}
    for step, images in enumerate(batches):
        b = images.shape[0]
        with torch.no_grad():
            if vc is not None:
                moments = torch.cat([
                    ref_vae.encode_moments(vc, vae_params, x, pr)
                    for x in images.split(chunk)])
                post, noise, t = draws(generator, (b, vc["z_channels"],
                                                   *moments.shape[2:]),
                                       moments.shape, sched.T)
                latents = ref_vae.posterior_sample(moments, post) * sf
            else:
                latents = images.float()
                _, noise, t = draws(generator, latents.shape, None, sched.T)
        leaves = {n: t_.detach().requires_grad_(True) for n, t_ in p.items()}
        total = latents.numel()
        loss = 0.0
        for lat, nz, tt in zip(latents.split(chunk), noise.split(chunk),
                               t.split(chunk)):
            noisy = sched.add_noise(lat, nz, tt)
            inp = torch.cat([noisy, pos_channel(lat.shape[0], lat.shape[2],
                                                lat.shape[3], lat.device)], 1)
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
