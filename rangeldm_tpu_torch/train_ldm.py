"""LDM training (the JAX package's rangeldm_tpu/train_ldm.py, after
ldm/train_unconditional.py):

    from rangeldm_tpu_torch.train_ldm import LdmTrainer
    trainer = LdmTrainer(cfg)              # on CUDA; device="cpu" to ask
    trainer.fit(batches, max_steps=1000)   # for the CPU
    path = trainer.save_final()            # a diffusers-layout pipeline

`cfg` is a nested dict (or `Cfg`) with the keys of the JAX package's YAML
configs (rangeldm_tpu/configs/rangeldm_kitti360.yaml, upsample.yaml,
inpainting.yaml): a zoo `model:` or an inline `model_config:` /
`vae_config:`, the optimizer, schedule, EMA and `mixed_precision` keys, and
`upsample:` or `inpainting:` for the conditional models. `batches` is any
iterable of dicts in the (B, H, W, C) layout, as numpy arrays or tensors:
'jpg' range images or 'moments' (B, H, W, 2Z), with 'down' (upsample) or
'masked_image' and 'inpainting_mask' (inpainting), the batches of
`data.RangeLoader`.

Not ported yet: checkpoint and resume, the latent cache, in-training sample
dumps, the command-line `main` (it needs a config reader) and data-parallel
training.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Mapping, Optional

import torch

from rangeldm_tpu_torch.convert import (
    load_diffusers_vae, save_diffusers_pipeline,
)
from rangeldm_tpu_torch.diffusion.schedule import Schedule, ScheduleConfig
from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig
from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
from rangeldm_tpu_torch.models.zoo import ModelSpec, get_model_spec
from rangeldm_tpu_torch.pipelines.samplers import to_bcwh
from rangeldm_tpu_torch.sample_ldm import resolve_device
from rangeldm_tpu_torch.training import conditions
from rangeldm_tpu_torch.training.ldm_trainer import (
    LdmTrainConfig, make_ldm_train_step,
)
from rangeldm_tpu_torch.training.loggers import ScalarLogger
from rangeldm_tpu_torch.training.train_state import TrainState, make_adamw
from rangeldm_tpu_torch.utils.config import Cfg


def spec_from_cfg(cfg: Cfg) -> ModelSpec:
    """The model spec: a zoo name (`model:`), or, in the reference's own
    grammar (ldm/train_unconditional.py:237-242), an inline `model_config:`
    dict whose sample_size is [azimuth, beams], with an optional
    `vae_config:` dict for the latent autoencoder."""
    if not cfg.get("model_config"):
        return get_model_spec(cfg.model)
    conditional = bool(cfg.get("upsample") or cfg.get("inpainting"))
    vae = None
    if cfg.get("vae_config"):
        vae = VaeConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in dict(cfg.vae_config).items()})
    unet = UNetConfig.from_reference(dict(cfg.model_config))
    h, w = unet.sample_size
    factor = vae.down_factor if vae is not None else 1
    pos = bool(cfg.get("pos_encoding", True))
    # a conditional model's input channels beyond out (+ pos) are its
    # condition's
    cond = (unet.in_channels - unet.out_channels - int(pos) if conditional
            else 0)
    return ModelSpec(
        name=cfg.get("model", "custom"), unet=unet, vae=vae,
        image_size=tuple(cfg.get("image_size", (h * factor, w * factor))),
        pos_encoding=pos, cond_channels=cond)


def load_vae(path: str) -> AutoencoderKL:
    """A diffusers-layout VAE directory, or a pipeline directory holding
    one under vae/."""
    vae_dir = path if os.path.exists(os.path.join(path, "config.json")) \
        else os.path.join(path, "vae")
    if not os.path.isdir(vae_dir):
        raise ValueError(f"vae_checkpoint {path!r}: expected a diffusers-"
                         f"layout VAE or pipeline directory (sgm .ckpt and "
                         f"orbax directories are not read by this package)")
    cfg, sd = load_diffusers_vae(vae_dir)
    vae = AutoencoderKL(cfg)
    vae.load_state_dict(sd, strict=True)
    return vae


# the batch entries a step reads: images or moments, and the conditions
BATCH_KEYS = ("jpg", "moments", "down", "masked_image", "inpainting_mask")


class LdmTrainer:
    """Builds the UNet, the frozen VAE, the schedule, the optimizer and the
    EMA from `cfg`; `fit` consumes any iterable of batch dicts."""

    def __init__(self, cfg: Mapping, device=None):
        self.cfg = cfg = Cfg.wrap(dict(cfg))
        self.device = resolve_device(device)
        self.spec = spec_from_cfg(cfg)
        self.compute_dtype = (torch.bfloat16
                              if cfg.get("mixed_precision") == "bf16"
                              else torch.float32)
        self.schedule = Schedule(ScheduleConfig(
            num_train_timesteps=int(cfg.get("ddpm_num_steps", 1000)),
            beta_schedule=cfg.get("ddpm_beta_schedule", "linear"),
            prediction_type=cfg.get("prediction_type", "epsilon")))

        # seeded random initial weights, without touching the caller's RNG
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(cfg.get("seed", 0)))
            unet = UNet2D(self.spec.unet)
            with_vae = bool(cfg.get("with_vae", self.spec.vae is not None))
            vae = AutoencoderKL(self.spec.vae) if with_vae else None
        if vae is not None and cfg.get("vae_checkpoint"):
            vae = load_vae(cfg.vae_checkpoint)
        self.unet = unet.to(self.device).train()
        self.vae = (vae.to(self.device).eval().requires_grad_(False)
                    if vae is not None else None)

        tx = make_adamw(
            self.unet.parameters(),
            learning_rate=float(cfg.get("learning_rate", 1e-4)),
            warmup_steps=int(cfg.get("lr_warmup_steps", 500)),
            total_steps=int(cfg.get("total_steps", 1_000_000)),
            schedule=cfg.get("lr_scheduler", "cosine"),
            beta1=float(cfg.get("adam_beta1", 0.95)),
            beta2=float(cfg.get("adam_beta2", 0.999)),
            weight_decay=float(cfg.get("adam_weight_decay", 1e-6)),
            eps=float(cfg.get("adam_epsilon", 1e-8)))
        self.state = TrainState.create(
            self.unet, tx, with_ema=bool(cfg.get("use_ema", True)))

        self.train_cfg = LdmTrainConfig(
            pos_encoding=self.spec.pos_encoding and bool(
                cfg.get("pos_encoding", True)),
            scaling_factor=(self.spec.vae.scaling_factor if self.spec.vae
                            else 1.0),
            pixel_scaling=cfg.get("scaling_factor"),
            shifting_factor=float(cfg.get("shifting_factor", 0.0)),
            snr_gamma=cfg.get("snr_gamma"),
            ema_inv_gamma=float(cfg.get("ema_inv_gamma", 1.0)),
            ema_power=float(cfg.get("ema_power", 0.75)),
            ema_max_decay=float(cfg.get("ema_max_decay", 0.9999)),
            grad_accum_steps=int(cfg.get("gradient_accumulation_steps", 1)))
        self.cond_fn = self._cond_fn()
        self.train_step = make_ldm_train_step(
            self.schedule, self.train_cfg, self.vae, cond_fn=self.cond_fn,
            compute_dtype=self.compute_dtype)

        self.out_dir = cfg.get("output_dir") or "runs/default"
        os.makedirs(self.out_dir, exist_ok=True)

    def _cond_fn(self):
        """The condition of an upsample or inpainting config
        (rangeldm_tpu/train_ldm.py:163-184), else None."""
        cfg = self.cfg
        if cfg.get("upsample"):
            # the pixel unshuffle's azimuth factor is the VAE's down factor
            # (the reference's SparseRangeImageEncoder2 hardcodes its VAE's
            # 4, ldm/encoders.py:90-95); the beam densification factor must
            # equal it, or the condition cannot match the latent grid
            factor = (self.spec.vae.down_factor if self.spec.vae
                      else int(cfg.upsample))
            if int(cfg.upsample) != factor:
                raise ValueError(
                    f"upsample factor {cfg.upsample} != VAE down factor "
                    f"{factor}: the unshuffled condition "
                    f"(beams/{cfg.upsample}, azimuth/{factor}) cannot "
                    f"match the latent grid (the reference supports "
                    f"densification == 4 == its VAE factor only)")
            return conditions.make_upsample_cond_fn(factor)
        if cfg.get("inpainting"):
            return conditions.make_inpainting_cond_fn(
                self.vae, self.train_cfg.scaling_factor,
                self.spec.unet.sample_size)
        return None

    def _to_device(self, batch) -> dict:
        """A batch dict (or bare image array) in the loader's (B, H, W, C)
        layout -> f32 tensors on the device in the (B, C, W, H) layout."""
        if not isinstance(batch, Mapping):
            batch = {"jpg": batch}
        return {k: to_bcwh(torch.as_tensor(v).to(self.device, torch.float32))
                for k, v in batch.items() if k in BATCH_KEYS}

    def fit(self, batches, max_steps: Optional[int] = None,
            log_every: int = 50, loader=None) -> dict:
        """Train on `batches` until they run out or `max_steps` updates are
        made. Every `log_every` steps (and at the last) the loss, the
        gradient norm, the step and the steps per second since the start
        of this call are logged to <output_dir>/train_log.jsonl, with the
        `data_wait_frac` of `loader` (the RangeLoader feeding `batches`)
        when one is given; returns the last logged record."""
        cfg = self.cfg
        generator = torch.Generator(device=self.device).manual_seed(
            int(cfg.get("seed", 0)))
        logger = ScalarLogger(self.out_dir,
                              csv=bool(cfg.get("csv_log", False)))
        last = {}
        t0 = time.perf_counter()
        step0 = step = self.state.step
        self.unet.train()
        for batch in batches:
            metrics = self.train_step(self.state, self._to_device(batch),
                                      generator)
            step += 1
            done = bool(max_steps) and step >= max_steps
            if step % log_every == 0 or done:
                # float() waits for the device: only at log steps
                last = {k: float(v) for k, v in metrics.items()}
                last.update(step=step, sps=(
                    (step - step0) / max(time.perf_counter() - t0, 1e-9)))
                if loader is not None:
                    last["data_wait_frac"] = loader.wait_fraction
                logger.log(step, last)
            if done:
                break
        return last

    def save_final(self) -> str:
        """Write <output_dir>/pipeline in the diffusers layout (unet/,
        unet_ema/ when the EMA is kept, vae/, scheduler/), which
        `RangePipeline.from_pretrained` loads (EMA weights by default)."""
        path = os.path.join(self.out_dir, "pipeline")
        ema = (self.state.ema_state_dict() if self.state.ema is not None
               else None)
        save_diffusers_pipeline(path, self.unet, self.vae,
                                dataclasses.asdict(self.schedule.cfg),
                                unet_ema=ema)
        return path
