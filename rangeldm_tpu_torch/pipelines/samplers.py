"""Sampling loops (ldm/pipelines.py: DDPMPipelineRange, DDIMPipelineRange,
LDMPipelineRange).

Every function takes `model_fn(x, t) -> model_out` closures over the
network, so it stays agnostic of the module plumbing. Tensors inside the
loop are in the torch layout (B, C, W=azimuth, H=beams); shapes given and
images returned are in the (B, H=beams, W=azimuth, C) layout of the JAX
package. Random numbers come from the caller's `torch.Generator`.

Every sampler runs on a local mesh (parallel/mesh.py): `mesh` is a tuple
of devices, one device a mesh of one, and `model_fns` and `vae_decodes`
hold one function per device, each closing over its replica there. The
batch splits into equal chunks, one per device; each step runs every
chunk on its device (launches are asynchronous, so the devices overlap),
and every draw is made once for the whole batch on the first device and
split, so the result does not depend on the mesh. It is gathered on the
first device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rangeldm_tpu_torch.diffusion.schedule import Schedule, f32
from rangeldm_tpu_torch.parallel.mesh import split_batch
from rangeldm_tpu_torch.utils.profiling import step_annotation


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


CPU = (torch.device("cpu"),)


def _randn_like(xs: Sequence[torch.Tensor],
                generator: Optional[torch.Generator]) -> List[torch.Tensor]:
    """Standard normal chunks like `xs`, drawn as one batch on the first
    chunk's device."""
    full = torch.randn((sum(x.shape[0] for x in xs), *xs[0].shape[1:]),
                       generator=generator, dtype=xs[0].dtype,
                       device=xs[0].device)
    return [c.to(x.device) for c, x in zip(
        full.split([x.shape[0] for x in xs]), xs)]


def _gather(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The chunks concatenated on the first one's device."""
    return torch.cat([x.to(xs[0].device) for x in xs])


def denoise(model_fns: Sequence[Callable], schedule: Schedule,
            xs: Sequence[torch.Tensor], num_steps: int,
            generator: Optional[torch.Generator] = None, *,
            method: str = "ddim", eta: float = 0.0,
            pos_encoding: Optional[Sequence[torch.Tensor]] = None,
            cond: Optional[Sequence[torch.Tensor]] = None,
            collect_trajectory: bool = False):
    """Run the reverse process from the chunks `xs` of x (B, C, W, H),
    chunk i through `model_fns[i]`.

    `cond` and `pos_encoding`, chunked as `xs`, are concatenated on
    channels at every step. Returns the result's chunks; with
    collect_trajectory=True also the chunks of the state before every
    step. method: 'ddpm' (ancestral), 'ddim' (the reference's default) or
    'dpmpp' (DPM-Solver++ 2M)."""
    if method not in ("ddim", "ddpm", "dpmpp"):
        raise ValueError(f"unknown method {method!r}")
    xs = list(xs)
    extras = [[u[j].to(x.dtype) for u in (cond, pos_encoding)
               if u is not None] for j, x in enumerate(xs)]
    traj = []
    state = [(torch.zeros_like(x), f32(1.0)) for x in xs]
    for i, (t, tp) in enumerate(step_pairs(schedule, num_steps)):
        if collect_trajectory:
            traj.append(list(xs))
        with step_annotation("unet_eval"):
            outs = [fn(torch.cat([x, *ex], dim=1) if ex else x, t)
                    for fn, x, ex in zip(model_fns, xs, extras)]
        with step_annotation("sampler_update"):
            if method == "dpmpp":
                for j, (out, x, (prev_x0, h_prev)) in enumerate(
                        zip(outs, xs, state)):
                    xs[j], prev_x0, h_prev = schedule.dpmpp_2m_step(
                        out, t, tp, x, prev_x0, h_prev, i == 0)
                    state[j] = (prev_x0, h_prev)
            elif method == "ddpm":
                xs = [schedule.ddpm_step(out, t, tp, x, nz) for out, x, nz in
                      zip(outs, xs, _randn_like(xs, generator))]
            else:
                noise = (_randn_like(xs, generator) if eta > 0.0
                         else [None] * len(xs))
                xs = [schedule.ddim_step(out, t, tp, x, eta=eta, noise=nz)
                      for out, x, nz in zip(outs, xs, noise)]
    return (xs, traj) if collect_trajectory else xs


def _initial_noise(shape, generator, dtype, mesh, noise):
    """The chunks of x_T in the torch layout: `noise` (B, H, W, C) when
    given, else drawn from the generator."""
    b, h, w, c = shape
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise shape {tuple(noise.shape)} != {shape}")
        x = to_bcwh(torch.as_tensor(noise).to(device=mesh[0], dtype=dtype))
    else:
        x = torch.randn((b, c, w, h), generator=generator, dtype=dtype,
                        device=mesh[0])
    return split_batch(x, mesh)


def _pos(shape, dtype, xs):
    """The pos channel of each chunk of `xs`."""
    _, h, w, _ = shape
    return [make_pos_encoding(x.shape[0], h, w, dtype, x.device) for x in xs]


def _decode(vae_decodes, zs, scaling_factor: float) -> torch.Tensor:
    """(B, H, W, C) images of the latent chunks `zs`, each through its
    device's decoder, gathered."""
    with step_annotation("vae_decode"):
        return to_bhwc(_gather([dec(z / scaling_factor)
                                for dec, z in zip(vae_decodes, zs)]))


def ddpm_sample(model_fns, schedule: Schedule, shape: Tuple[int, ...],
                generator: Optional[torch.Generator] = None,
                num_steps: int = 1000, pos_encoding: bool = False,
                dtype: torch.dtype = torch.float32, mesh=CPU,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixel-space ancestral sampling (DDPMPipelineRange); `shape` and the
    result are (B, H, W, C)."""
    return ddim_sample(model_fns, schedule, shape, generator, num_steps,
                       pos_encoding=pos_encoding, dtype=dtype, mesh=mesh,
                       method="ddpm", noise=noise)


def ddim_sample(model_fns, schedule: Schedule, shape: Tuple[int, ...],
                generator: Optional[torch.Generator] = None,
                num_steps: int = 50, eta: float = 0.0,
                pos_encoding: bool = False,
                dtype: torch.dtype = torch.float32, mesh=CPU,
                method: str = "ddim",
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixel-space sampling (DDIMPipelineRange); method='dpmpp' swaps in
    the DPM-Solver++(2M) update. `shape` and the result are (B, H, W, C)."""
    xs = _initial_noise(shape, generator, dtype, mesh, noise)
    pos = _pos(shape, dtype, xs) if pos_encoding else None
    return to_bhwc(_gather(denoise(model_fns, schedule, xs, num_steps,
                                   generator, method=method, eta=eta,
                                   pos_encoding=pos)))


def latent_sample(model_fns, vae_decodes, schedule: Schedule,
                  latent_shape: Tuple[int, ...], scaling_factor: float,
                  generator: Optional[torch.Generator] = None,
                  num_steps: int = 50, eta: float = 0.0,
                  method: str = "ddim", pos_encoding: bool = True,
                  cond: Optional[Sequence[torch.Tensor]] = None,
                  final_only: bool = True,
                  dtype: torch.dtype = torch.float32, mesh=CPU,
                  noise: Optional[torch.Tensor] = None):
    """Latent diffusion sampling + VAE decode (LDMPipelineRange).

    `latent_shape` is (B, H, W, C); `noise` optionally supplies x_T in that
    layout; `cond` holds the condition's chunks, one per device. Returns
    decoded images (B, H, W, C); with final_only=False also the decoded
    state before every step, (num_steps, B, H, W, C)
    (ldm/pipelines.py:350-355)."""
    latents = [x * schedule.init_noise_sigma for x in _initial_noise(
        latent_shape, generator, dtype, mesh, noise)]
    pos = _pos(latent_shape, dtype, latents) if pos_encoding else None
    out = denoise(model_fns, schedule, latents, num_steps, generator,
                  method=method, eta=eta, pos_encoding=pos, cond=cond,
                  collect_trajectory=not final_only)
    if final_only:
        return _decode(vae_decodes, out, scaling_factor)
    latents, traj = out
    return (_decode(vae_decodes, latents, scaling_factor),
            torch.stack([_decode(vae_decodes, zs, scaling_factor)
                         for zs in traj]))


def conditional_latent_sample(model_fns, vae_decodes, schedule: Schedule,
                              latent_shape: Tuple[int, ...],
                              scaling_factor: float,
                              cond: Sequence[torch.Tensor],
                              generator: Optional[torch.Generator] = None,
                              num_steps: int = 50, pos_encoding: bool = False,
                              **kw):
    """`latent_sample` with the condition's chunks (B/n, C_cond, W, H)
    mandatory and no pos channel by default (upsampling and inpainting,
    ldm/inference_conditional.py:160-170)."""
    return latent_sample(model_fns, vae_decodes, schedule, latent_shape,
                         scaling_factor, generator, num_steps=num_steps,
                         pos_encoding=pos_encoding, cond=cond, **kw)
