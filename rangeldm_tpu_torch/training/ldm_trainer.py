"""Latent / pixel diffusion training step (rangeldm_tpu/training/
ldm_trainer.py, the per-batch hot path of ldm/train_unconditional.py:
466-556):

  frozen-VAE encode -> scale -> noise and timesteps -> add_noise ->
  concat condition and pos-encoding -> UNet -> (min-SNR weighted) MSE ->
  backward -> clipped AdamW update -> EMA.

Tensors are in the torch layout (B, C, W=azimuth, H=beams). Under a bf16
compute dtype the parameters stay f32: the VAE encode and the UNet forward
run under `torch.autocast`, the loss in f32. On CUDA every attention layer
of the UNet goes through the fused kernels, forward and backward.

Randomness comes from the caller's `torch.Generator`; `noise`,
`timesteps`, `posterior_noise` and `cond_posterior_noise` may be given
instead, so that a test can feed the same draws to this step and to the
JAX package's.

Under torch.distributed each rank takes a local batch: every draw is made
for the global batch and sliced to the rank's rows (`parallel.mesh.
global_draw`), and the gradients and the loss are averaged over the ranks
before the clip (`all_reduce_mean_`), so that the clip sees the global
norm and N ranks take the step one process takes on the global batch.

On CUDA in one process, with no draws given, the whole step (encode and
posterior draw, condition, draws, `add_noise`, UNet forward, loss,
backward, clip, AdamW, EMA) is replayed from a CUDA graph: one launch
instead of thousands (utils/graphs.py `GraphCache`). A key (device, and
the shape and dtype of each batch entry) runs eager at its first step, is
captured at its second and replayed after; the graphs belong to the step
function and outlive a `fit` call. The captured body is the eager path's
function. What changes on the host from step to step stays outside it: the
learning rate and the EMA weight are written into 0-dim device tensors
before the step, the batch is copied into the graph's static batch, and
the step count is advanced after. The draws come from the caller's
generator, registered with the graph, so a replay draws what the eager
step would and leaves the generator where it would. The body zeroes the
gradients to None before the backward, so the captured backward owns
static gradient buffers. Under torch.distributed (the all-reduce), on the
CPU, and with draws given, the step stays eager. Each step leaves one
span: `train_graph_replay`, `train_graph_capture` or `train_eager`; the
`encode` (> `condition`, on a conditional step: the condition's posterior
draw and its encode, resize and concat), `forward`, `backward`, `clip`,
`adamw` and `ema` spans lie under the last two, and a replay has none.
`train_step.graphs` is the step's `GraphCache`: each captured graph keeps
where those spans' work lies in it (`Captured.phases`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch

from rangeldm_tpu_torch.diffusion.schedule import Schedule
from rangeldm_tpu_torch.models.vae import gaussian_sample
from rangeldm_tpu_torch.parallel.mesh import (
    all_reduce_mean_, distributed, global_draw,
)
from rangeldm_tpu_torch.pipelines.samplers import make_pos_encoding
from rangeldm_tpu_torch.training.ema import ema_update, ema_weight, power_decay
from rangeldm_tpu_torch.training.train_state import TrainState
from rangeldm_tpu_torch.utils.graphs import Captured, GraphCache
from rangeldm_tpu_torch.utils.profiling import step_annotation


@dataclasses.dataclass(frozen=True)
class LdmTrainConfig:
    pos_encoding: bool = True
    scaling_factor: float = 0.18215     # vae.config.scaling_factor
    shifting_factor: float = 0.0        # pixel-space option (train_unconditional.py:483-485)
    pixel_scaling: Optional[float] = None  # args.scaling_factor for RangeDM
    snr_gamma: Optional[float] = None
    ema_inv_gamma: float = 1.0
    ema_power: float = 0.75
    ema_max_decay: float = 0.9999
    grad_accum_steps: int = 1


def step_ema_weight(step: int, cfg: LdmTrainConfig) -> float:
    """The EMA's weight of the parameters, 1 - decay, at the pre-increment
    step count (diffusers' get_decay uses optimization_step - 1), so the
    first update copies the parameters into the shadow."""
    return ema_weight(power_decay(step, cfg.ema_inv_gamma, cfg.ema_power,
                                  max_decay=cfg.ema_max_decay))


def apply_updates_and_ema(state: TrainState, loss: torch.Tensor,
                          weight: Union[float, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """The epilogue of a step: the gradients and the loss averaged over
    the ranks, the optimizer update at the learning rate the optimizer
    holds, and the EMA update of weight `weight` (`step_ema_weight`, a
    float or a 0-dim tensor on the EMA's device). The caller writes the
    learning rate before (`TrainState.set_learning_rate`) and advances the
    step count after."""
    all_reduce_mean_([p.grad for p in state.model.parameters()
                      if p.grad is not None] + [loss])
    grad_norm = state.apply_gradients()
    if state.ema is not None:
        with step_annotation("ema"):
            ema_update(state.ema, state.model.parameters(), weight)
    return {"loss": loss, "grad_norm": grad_norm}


def _graphable(tensors, given) -> bool:
    """Whether a step on these batch tensors, with these draws given, is
    captured: every tensor on CUDA, one process, no draw given."""
    return (bool(tensors) and all(t.is_cuda for t in tensors)
            and not distributed() and all(d is None for d in given))


class _StepGraph(Captured):
    """One captured step at a batch's shapes: `step(batch)` on its static
    batch, a copy of the batch it was captured on, into which each replay
    copies the step's batch first."""

    def __init__(self, step: Callable, batch, generator):
        self.batch = ({k: v.clone() for k, v in batch.items()}
                      if isinstance(batch, dict) else batch.clone())
        device = _tensors(self.batch)[0].device
        super().__init__(lambda: step(self.batch), device,
                         () if generator is None else (generator,))

    def run(self, batch) -> Dict[str, torch.Tensor]:
        """Replay on `batch`: the loss and the gradient norm, as copies
        that the next replay does not overwrite."""
        if isinstance(batch, dict):
            for k, static in self.batch.items():
                static.copy_(batch[k])
        else:
            self.batch.copy_(batch)
        self.replay()
        return {k: v.clone() for k, v in self.out.items()}


def _tensors(batch) -> list:
    return list(batch.values()) if isinstance(batch, dict) else [batch]


def make_ldm_train_step(schedule: Schedule, cfg: LdmTrainConfig,
                        vae: Optional[torch.nn.Module] = None,
                        cond_fn: Optional[Callable] = None,
                        compute_dtype: torch.dtype = torch.float32):
    """Returns `train_step(state, batch, generator=None, *, noise=None,
    timesteps=None, posterior_noise=None, cond_posterior_noise=None) ->
    metrics`, which updates `state` (its model, optimizer, EMA and step) in
    place and returns the loss and the gradient norm before the clip as
    tensors of its own (a replay returns copies of the graph's). It keeps
    its CUDA graphs (module docstring) for one train state and generator:
    called with another, it drops them and starts again.

    batch: (B, C, W, H) range images (already normalized), or a dict with
    'jpg' images or 'moments', the frozen VAE's posterior moments
    (B, 2Z, W, H), and the condition inputs. `vae` is an AutoencoderKL
    whose encoder stays frozen; without one the images are the diffusion
    space (pixel diffusion). `cond_fn(batch, generator, posterior_noise)`
    (training/conditions.py) builds the condition channels once per step,
    without a gradient; they are concatenated after the noisy latents and
    before the pos channel (ldm/train_conditional.py:418-447).
    Given draws are for the whole batch: `noise` of the latents' shape,
    `timesteps` (B,), `posterior_noise` of the posterior mean's shape,
    `cond_posterior_noise` that of the condition's posterior draw."""
    prediction_type = schedule.cfg.prediction_type
    if prediction_type not in ("epsilon", "v_prediction"):
        raise ValueError(prediction_type)
    mixed = compute_dtype != torch.float32

    def autocast(device: torch.device):
        # no cache of cast weights: they change at every step, and a
        # capture cannot hold the cache
        return torch.autocast(device.type, dtype=compute_dtype,
                              enabled=mixed, cache_enabled=False)

    @torch.no_grad()
    def encode(batch, generator, posterior_noise) -> torch.Tensor:
        """f32 latents of the batch, without a gradient (the VAE is
        frozen)."""
        if isinstance(batch, dict) and "moments" in batch:
            moments = batch["moments"]
        else:
            images = batch["jpg"] if isinstance(batch, dict) else batch
            if vae is None:
                latents = images.float() - cfg.shifting_factor
                if cfg.pixel_scaling is not None:
                    latents = latents * cfg.pixel_scaling
                return latents
            with autocast(images.device):
                moments = vae.encode_moments(images)
        if posterior_noise is None:
            b, c, *rest = moments.shape
            posterior_noise = global_draw(lambda s: torch.randn(
                s, generator=generator, device=moments.device),
                (b, c // 2, *rest))
        return gaussian_sample(moments.float(),
                               noise=posterior_noise) * cfg.scaling_factor

    @torch.no_grad()
    def condition(batch, generator, posterior_noise):
        if not isinstance(batch, dict):
            raise ValueError("a conditional step takes a batch dict with "
                             "its condition inputs")
        device = next(iter(batch.values())).device
        with autocast(device):
            return cond_fn(batch, generator, posterior_noise)

    def draws(latents, generator, noise, timesteps):
        """The step's noise and timesteps, drawn where not given."""
        dev, b = latents.device, latents.shape[0]
        if noise is None:
            noise = global_draw(lambda s: torch.randn(
                s, generator=generator, dtype=latents.dtype, device=dev),
                latents.shape)
        if timesteps is None:
            timesteps = global_draw(lambda s: torch.randint(
                0, schedule.cfg.num_train_timesteps, s, generator=generator,
                device=dev), (b,))
        return noise, timesteps

    def loss_fn(model, latents, noise, t, cond) -> torch.Tensor:
        noisy = schedule.add_noise(latents, noise, t)
        target = (noise if prediction_type == "epsilon"
                  else schedule.get_velocity(latents, noise, t))
        inp = noisy
        if cond is not None:
            inp = torch.cat([inp, cond.to(inp.dtype)], dim=1)
        if cfg.pos_encoding:
            b, _, w, h = latents.shape
            inp = torch.cat([inp, make_pos_encoding(
                b, h, w, latents.dtype, latents.device)], dim=1)
        with autocast(latents.device):
            pred = model(inp, t)
        err = (pred.float() - target.float()) ** 2
        if cfg.snr_gamma is None:
            return err.mean()
        w = schedule.min_snr_weight(
            t, cfg.snr_gamma, velocity=prediction_type == "v_prediction")
        return (err.mean(dim=(1, 2, 3)) * w).mean()

    def scalars(state: TrainState) -> float:
        """The host's part of a step's update: its learning rate, written
        into the optimizer, and its EMA weight, returned."""
        state.set_learning_rate()
        return step_ema_weight(state.step, cfg)

    def body(state: TrainState, batch, generator, noise, timesteps,
             posterior_noise, cond_posterior_noise,
             weight: Optional[torch.Tensor]):
        """The step's work, eager or captured. On a graphed path `weight`
        is the device tensor that `scalars(state)` was written to before the
        step, so that a capture reads nothing of the host that changes from
        step to step; on an eager path it is None and the body takes
        `scalars(state)` itself, once the batch has passed the condition's
        checks."""
        with step_annotation("encode"):
            latents = encode(batch, generator, posterior_noise)
            cond = None
            if cond_fn is not None:
                with step_annotation("condition"):
                    dev = latents.device
                    if (cond_posterior_noise is None
                            and isinstance(batch, dict)
                            and "masked_image" in batch):
                        # the inpainting condition's posterior draw of the
                        # masked image (of the latents' shape)
                        cond_posterior_noise = global_draw(
                            lambda s: torch.randn(s, generator=generator,
                                                  device=dev), latents.shape)
                    cond = condition(batch, generator, cond_posterior_noise)
        if weight is None:
            weight = scalars(state)
        model = state.model
        k = cfg.grad_accum_steps
        if k == 1:
            with step_annotation("forward"):
                noise, timesteps = draws(latents, generator, noise,
                                         timesteps)
                state.optimizer.zero_grad(set_to_none=True)
                loss = loss_fn(model, latents, noise, timesteps, cond)
            with step_annotation("backward"):
                loss.backward()
            return apply_updates_and_ema(state, loss.detach(), weight)
        if latents.shape[0] % k:
            raise ValueError(f"batch {latents.shape[0]} is not divisible "
                             f"into {k} micro-batches")
        noise, timesteps = draws(latents, generator, noise, timesteps)
        state.optimizer.zero_grad(set_to_none=True)
        # micro-batch accumulation (the reference's accelerate.accumulate,
        # ldm/train_unconditional.py:503): sum the gradients, then average;
        # a forward and a backward span each
        loss = torch.zeros((), device=latents.device)
        conds = cond.chunk(k) if cond is not None else [None] * k
        for lat, nz, t, cd in zip(latents.chunk(k), noise.chunk(k),
                                  timesteps.chunk(k), conds):
            with step_annotation("forward"):
                micro = loss_fn(model, lat, nz, t, cd)
            with step_annotation("backward"):
                micro.backward()
            loss = loss + micro.detach()
        torch._foreach_div_([p.grad for p in model.parameters()
                             if p.grad is not None], k)
        return apply_updates_and_ema(state, loss / k, weight)

    graphs = GraphCache("train")
    # the state and generator the graphs update, and the device tensor of
    # the EMA weight that they read
    bound: list = [None, None, None]

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None, *,
                   noise: Optional[torch.Tensor] = None,
                   timesteps: Optional[torch.Tensor] = None,
                   posterior_noise: Optional[torch.Tensor] = None,
                   cond_posterior_noise: Optional[torch.Tensor] = None):
        given = (noise, timesteps, posterior_noise, cond_posterior_noise)
        tensors = _tensors(batch)
        if not _graphable(tensors, given):
            with step_annotation("train_eager"):
                out = body(state, batch, generator, *given, None)
        else:
            dev = tensors[0].device
            if bound[0] is not state or bound[1] is not generator:
                graphs.clear()
                bound[:] = [state, generator, torch.zeros((), device=dev)]
            weight = bound[2]
            weight.fill_(scalars(state))
            entries = (batch.items() if isinstance(batch, dict)
                       else [("", batch)])
            key = (dev, tuple(sorted((k, tuple(v.shape), v.dtype)
                                     for k, v in entries)))

            def step(b):
                return body(state, b, generator, *given, weight)

            out = graphs.run(
                key, eager=lambda: step(batch),
                capture=lambda: _StepGraph(step, batch, generator),
                replay=lambda graph: graph.run(batch))
        state.step += 1
        return out

    train_step.graphs = graphs
    return train_step
