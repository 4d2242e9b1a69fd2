"""Sampling loops (ldm/pipelines.py: DDPMPipelineRange, DDIMPipelineRange,
LDMPipelineRange).

Every function takes a `model_fn(x, t) -> model_out` closure over the
network, so it stays agnostic of the module plumbing. Tensors inside the
loop are in the torch layout (B, C, W=azimuth, H=beams); shapes given and
images returned are in the (B, H=beams, W=azimuth, C) layout of the JAX
package. Random numbers come from the caller's `torch.Generator`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from rangeldm_tpu_torch.diffusion.schedule import Schedule, f32


def to_bhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, W, H) -> (B, H, W, C)."""
    return x.permute(0, 3, 2, 1)


def to_bcwh(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, W, H), contiguous."""
    return x.permute(0, 3, 2, 1).contiguous()


def make_pos_encoding(batch: int, h: int, w: int,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> torch.Tensor:
    """The vertical-ambiguity-breaking channel, (B, 1, W, H): zeros except
    azimuth column 0 (ldm/train_unconditional.py:455-463)."""
    pos = torch.zeros((batch, 1, w, h), dtype=dtype, device=device)
    pos[:, :, 0, :] = 1.0
    return pos


def step_pairs(schedule: Schedule, num_steps: int):
    """(t, t_prev) per step: t_prev is the next timestep of the schedule,
    -1 after the last one."""
    ts = schedule.timesteps(num_steps)
    ts_prev = np.concatenate([ts[1:], [-1]])
    return [(int(t), int(tp)) for t, tp in zip(ts, ts_prev)]


def _randn_like(x: torch.Tensor, generator: Optional[torch.Generator]):
    return torch.randn(x.shape, generator=generator, dtype=x.dtype,
                       device=x.device)


def denoise(model_fn: Callable, schedule: Schedule, x: torch.Tensor,
            num_steps: int, generator: Optional[torch.Generator] = None, *,
            method: str = "ddim", eta: float = 0.0,
            pos_encoding: Optional[torch.Tensor] = None,
            cond: Optional[torch.Tensor] = None,
            collect_trajectory: bool = False):
    """Run the reverse process from x (B, C, W, H).

    `cond` and `pos_encoding` are concatenated on channels at every step.
    With collect_trajectory=True also returns the state before every step,
    (num_steps, B, C, W, H). method: 'ddpm' (ancestral), 'ddim' (the
    reference's default) or 'dpmpp' (DPM-Solver++ 2M)."""
    if method not in ("ddim", "ddpm", "dpmpp"):
        raise ValueError(f"unknown method {method!r}")
    extra = [u.to(x.dtype) for u in (cond, pos_encoding) if u is not None]
    traj = []
    prev_x0, h_prev = torch.zeros_like(x), f32(1.0)
    for i, (t, tp) in enumerate(step_pairs(schedule, num_steps)):
        if collect_trajectory:
            traj.append(x)
        out = model_fn(torch.cat([x, *extra], dim=1) if extra else x, t)
        if method == "dpmpp":
            x, prev_x0, h_prev = schedule.dpmpp_2m_step(
                out, t, tp, x, prev_x0, h_prev, i == 0)
        elif method == "ddpm":
            x = schedule.ddpm_step(out, t, tp, x, _randn_like(x, generator))
        else:
            noise = _randn_like(x, generator) if eta > 0.0 else None
            x = schedule.ddim_step(out, t, tp, x, eta=eta, noise=noise)
    if collect_trajectory:
        return x, torch.stack(traj)
    return x


def _initial_noise(shape, generator, dtype, device, noise):
    """x_T in the torch layout: `noise` (B, H, W, C) when given, else drawn
    from the generator."""
    b, h, w, c = shape
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise shape {tuple(noise.shape)} != {shape}")
        return to_bcwh(torch.as_tensor(noise).to(device=device, dtype=dtype))
    return torch.randn((b, c, w, h), generator=generator, dtype=dtype,
                       device=device)


def ddpm_sample(model_fn, schedule: Schedule, shape: Tuple[int, ...],
                generator: Optional[torch.Generator] = None,
                num_steps: int = 1000, pos_encoding: bool = False,
                dtype: torch.dtype = torch.float32, device=None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixel-space ancestral sampling (DDPMPipelineRange); `shape` and the
    result are (B, H, W, C)."""
    return ddim_sample(model_fn, schedule, shape, generator, num_steps,
                       pos_encoding=pos_encoding, dtype=dtype, device=device,
                       method="ddpm", noise=noise)


def ddim_sample(model_fn, schedule: Schedule, shape: Tuple[int, ...],
                generator: Optional[torch.Generator] = None,
                num_steps: int = 50, eta: float = 0.0,
                pos_encoding: bool = False,
                dtype: torch.dtype = torch.float32, device=None,
                method: str = "ddim",
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixel-space sampling (DDIMPipelineRange); method='dpmpp' swaps in
    the DPM-Solver++(2M) update. `shape` and the result are (B, H, W, C)."""
    x = _initial_noise(shape, generator, dtype, device, noise)
    b, h, w, _ = shape
    pos = (make_pos_encoding(b, h, w, dtype, x.device) if pos_encoding
           else None)
    return to_bhwc(denoise(model_fn, schedule, x, num_steps, generator,
                           method=method, eta=eta, pos_encoding=pos))


def latent_sample(model_fn, vae_decode: Callable, schedule: Schedule,
                  latent_shape: Tuple[int, ...], scaling_factor: float,
                  generator: Optional[torch.Generator] = None,
                  num_steps: int = 50, eta: float = 0.0,
                  method: str = "ddim", pos_encoding: bool = True,
                  cond: Optional[torch.Tensor] = None,
                  final_only: bool = True,
                  dtype: torch.dtype = torch.float32, device=None,
                  noise: Optional[torch.Tensor] = None):
    """Latent diffusion sampling + VAE decode (LDMPipelineRange).

    `latent_shape` is (B, H, W, C); `noise` optionally supplies x_T in that
    layout. Returns decoded images (B, H, W, C); with final_only=False also
    the decoded state before every step, (num_steps, B, H, W, C)
    (ldm/pipelines.py:350-355)."""
    latents = _initial_noise(latent_shape, generator, dtype, device, noise)
    latents = latents * schedule.init_noise_sigma
    b, h, w, _ = latent_shape
    pos = (make_pos_encoding(b, h, w, dtype, latents.device) if pos_encoding
           else None)
    out = denoise(model_fn, schedule, latents, num_steps, generator,
                  method=method, eta=eta, pos_encoding=pos, cond=cond,
                  collect_trajectory=not final_only)
    if final_only:
        return to_bhwc(vae_decode(out / scaling_factor))
    latents, traj = out
    image = to_bhwc(vae_decode(latents / scaling_factor))
    traj_images = torch.stack([to_bhwc(vae_decode(z / scaling_factor))
                               for z in traj])
    return image, traj_images


def conditional_latent_sample(model_fn, vae_decode: Callable,
                              schedule: Schedule,
                              latent_shape: Tuple[int, ...],
                              scaling_factor: float, cond: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              num_steps: int = 50, pos_encoding: bool = False,
                              **kw):
    """`latent_sample` with the condition (B, C_cond, W, H) mandatory and
    no pos channel by default (upsampling and inpainting,
    ldm/inference_conditional.py:160-170)."""
    return latent_sample(model_fn, vae_decode, schedule, latent_shape,
                         scaling_factor, generator, num_steps=num_steps,
                         pos_encoding=pos_encoding, cond=cond, **kw)
