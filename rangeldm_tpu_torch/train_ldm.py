"""LDM training (the JAX package's rangeldm_tpu/train_ldm.py, after
ldm/train_unconditional.py and train_conditional.py). From the command
line, with YAML configs merged left to right:

    python -m rangeldm_tpu_torch.train_ldm \
        --cfg rangeldm_tpu/configs/rangedm_kitti360.yaml my_overrides.yaml \
        [--max_steps N] [--device cpu]

or from Python:

    from rangeldm_tpu_torch.train_ldm import LdmTrainer
    trainer = LdmTrainer(cfg)              # on CUDA; device="cpu" to ask
    trainer.resume()                       # for the CPU
    trainer.fit(batches, max_steps=1000)
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

`main` reads the configs with the package's own YAML reader
(utils/config.py), builds the dataset and loader from `data:` (with
`cache_latents`, over the frozen VAE's cached moments), resumes from
`resume_from_checkpoint`, trains with a rolling checkpoint every
`checkpointing_steps` (keeping `checkpoints_total_limit`), a sample grid
every `sample_every_steps` and a deferred checkpoint on SIGUSR1, and writes
the final pipeline with its run record (sensor and normalization), which
`RangePipeline.from_pretrained` honours.

`vae_checkpoint` is an sgm `.ckpt`, an sgm-grammar `.safetensors` (the
VAE trainer's, train_vae.py) or a diffusers-layout VAE or pipeline
directory.

Not ported yet: data-parallel training, reading orbax checkpoints, and
the TensorBoard and wandb sinks.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import logging
import os
import re
import time
from typing import Mapping, Optional

import torch

from rangeldm_tpu_torch.convert import (
    load_diffusers_vae, load_sgm_vae, save_diffusers_pipeline,
)
from rangeldm_tpu_torch.data.datasets import (
    DatasetConfig, RangeImageDataset, RangeLoader,
)
from rangeldm_tpu_torch.diffusion.schedule import Schedule, ScheduleConfig
from rangeldm_tpu_torch.geometry.sensors import get_spec
from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig
from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
from rangeldm_tpu_torch.models.zoo import ModelSpec, get_model_spec
from rangeldm_tpu_torch.pipelines.samplers import (
    conditional_latent_sample, ddim_sample, latent_sample, to_bcwh, to_bhwc,
)
from rangeldm_tpu_torch.sample_ldm import resolve_device
from rangeldm_tpu_torch.training import conditions
from rangeldm_tpu_torch.training.checkpoint import TrainCheckpointer
from rangeldm_tpu_torch.training.image_logger import save_range_image_grid
from rangeldm_tpu_torch.training.latent_cache import (
    MomentsDataset, params_fingerprint, precompute_moments,
)
from rangeldm_tpu_torch.training.ldm_trainer import (
    LdmTrainConfig, make_ldm_train_step,
)
from rangeldm_tpu_torch.training.loggers import (
    ScalarLogger, emergency_checkpoint,
)
from rangeldm_tpu_torch.training.train_state import TrainState, make_adamw
from rangeldm_tpu_torch.utils.config import Cfg, expand_env, load_config

log = logging.getLogger(__name__)


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


def load_vae(path: str, cfg: Optional[VaeConfig] = None) -> AutoencoderKL:
    """Every VAE artifact the first stage hands to the second
    (rangeldm_tpu/train_ldm.py:50-73): an sgm `.ckpt` or an sgm-grammar
    `.safetensors` (the VAE trainer's vae_sgm.safetensors), with the
    shapes read off the file and the other fields of `cfg`; or a
    diffusers-layout VAE directory, or a pipeline directory holding one
    under vae/. Orbax directories are not read."""
    if path.endswith((".ckpt", ".safetensors")):
        return load_sgm_vae(path, cfg)
    vae_dir = path if os.path.exists(os.path.join(path, "config.json")) \
        else os.path.join(path, "vae")
    if not os.path.isdir(vae_dir):
        raise ValueError(f"vae_checkpoint {path!r}: expected an sgm .ckpt "
                         f"or .safetensors file, or a diffusers-layout VAE "
                         f"or pipeline directory (orbax directories are "
                         f"not read by this package)")
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
            vae = load_vae(cfg.vae_checkpoint, self.spec.vae)
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
        # the noise and timesteps of every step; its state is checkpointed
        self.state.generator = torch.Generator(
            device=self.device).manual_seed(int(cfg.get("seed", 0)))

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
        self.ckpt = TrainCheckpointer(
            os.path.join(self.out_dir, "checkpoints"),
            total_limit=int(cfg.get("checkpoints_total_limit", 10)))
        self._dump_unet = None

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

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=self.compute_dtype,
                              enabled=self.compute_dtype != torch.float32)

    def resume(self) -> int:
        """Restore the checkpoint `resume_from_checkpoint` names, in
        accelerate's grammar (ldm/train_unconditional.py:560-585, as the JAX
        package reads it): None, False or "" start fresh; True or "latest"
        take this run's newest checkpoint, or start fresh when there is
        none (a preemptible job sets it before its first checkpoint); an
        int or a digit string is that step of this run (1 is step 1, not
        True); a path is a checkpoints root or one checkpoint_N directory.
        A checkpoint named explicitly that is missing raises
        FileNotFoundError. Returns the restored step (0 when fresh)."""
        want = self.cfg.get("resume_from_checkpoint")
        if want is None or want is False or want == "":
            return 0
        ckpt, step, explicit = self.ckpt, None, False
        # identity and string checks: 1 == True in Python
        if not (want is True or want == "latest"):
            explicit = True
            text = str(want)
            if text.isdigit():
                step = int(text)
            else:
                path = os.path.abspath(text.rstrip("/"))
                m = re.search(r"checkpoint[-_](\d+)$", os.path.basename(path))
                if m:
                    step = int(m.group(1))
                    path = os.path.dirname(path)
                ckpt = TrainCheckpointer(path)
        sd = ckpt.restore(step)
        if sd is None:
            if explicit:
                raise FileNotFoundError(
                    f"resume_from_checkpoint={want!r}: no such checkpoint "
                    f"under {ckpt.directory}")
            return 0
        self.state.load_state_dict(sd)
        return self.state.step

    # -- sample dumps (ldm/train_unconditional.py:597-652) ----------------
    def _dump_model(self) -> torch.nn.Module:
        """A copy of the UNet holding the EMA weights (the live ones when no
        EMA is kept), refreshed at every dump; the training UNet and its
        state are not touched."""
        if self._dump_unet is None:
            self._dump_unet = copy.deepcopy(self.unet).eval()
            self._dump_unet.requires_grad_(False)
        weights = (self.state.ema if self.state.ema is not None
                   else [p.detach() for p in self.unet.parameters()])
        with torch.no_grad():
            for p, w in zip(self._dump_unet.parameters(), weights):
                p.copy_(w)
        return self._dump_unet

    def make_sample_fn(self, batch_size: int = 8, num_steps: int = 50):
        """`sample(generator) -> (B, H, W, C)` images from the current EMA
        weights, under the training's autocast: DDIM in pixel space, or
        latent DDIM and the VAE decode."""
        h, w = self.spec.unet.sample_size
        shape = (batch_size, h, w, self.spec.unet.out_channels)
        kw = dict(num_steps=num_steps,
                  pos_encoding=self.train_cfg.pos_encoding,
                  device=self.device)

        @torch.no_grad()
        def sample(generator: torch.Generator) -> torch.Tensor:
            unet = self._dump_model()
            with self._autocast():
                if self.vae is not None:
                    return latent_sample(unet, self.vae.decode,
                                         self.schedule, shape,
                                         self.train_cfg.scaling_factor,
                                         generator, **kw)
                return ddim_sample(unet, self.schedule, shape, generator,
                                   **kw)
        return sample

    def make_cond_sample_fn(self, batch_size: int, num_steps: int = 50):
        """`sample(generator, cond_inputs) -> (B, H, W, C)`: the conditional
        dump (ldm/train_conditional.py:542-570), from a batch's condition
        inputs in the (B, C, W, H) layout."""
        h, w = self.spec.unet.sample_size
        shape = (batch_size, h, w, self.spec.unet.out_channels)

        @torch.no_grad()
        def sample(generator: torch.Generator, cond_inputs: dict):
            unet = self._dump_model()
            with self._autocast():
                cond = self.cond_fn(cond_inputs, generator)
                return conditional_latent_sample(
                    unet, self.vae.decode, self.schedule, shape,
                    self.train_cfg.scaling_factor, cond, generator,
                    num_steps=num_steps,
                    pos_encoding=self.train_cfg.pos_encoding,
                    device=self.device)
        return sample

    def _dump_norm(self):
        """(mean, std) that de-normalize dumped grids."""
        dcfg = self.cfg.get("data", {})
        sp = get_spec(dcfg.get("sensor", self.spec.sensor),
                      log=bool(dcfg.get("log", False)),
                      inverse=bool(dcfg.get("inverse", False)))
        return float(dcfg.get("mean", sp.mean)), float(dcfg.get("std",
                                                                 sp.std))

    def _norm_record(self) -> dict:
        dcfg = self.cfg.get("data", {})
        mean, std = self._dump_norm()
        return {"mean": mean, "std": std,
                "log": bool(dcfg.get("log", False)),
                "inverse": bool(dcfg.get("inverse", False))}

    def _generator(self, step: int) -> torch.Generator:
        """The dump's own generator, seeded with the step: a dump draws
        nothing from the training generator."""
        return torch.Generator(device=self.device).manual_seed(int(step))

    def _dump_conditional(self, step: int, cond_batch: dict) -> str:
        """Result, target and input grids from the conditions of a train
        batch (the reference's triplet layout, train_conditional.py:
        542-570). `cond_batch` is in the (B, C, W, H) layout."""
        keys = [k for k in ("down", "masked_image", "inpainting_mask")
                if k in cond_batch]
        n = min(int(cond_batch[keys[0]].shape[0]), 8)
        fn = self.make_cond_sample_fn(
            n, num_steps=int(self.cfg.get("ddpm_num_inference_steps", 50)))
        grids = {"result": fn(self._generator(step),
                              {k: cond_batch[k][:n] for k in keys})}
        if "jpg" in cond_batch:
            grids["target"] = to_bhwc(cond_batch["jpg"][:n])
        grids["input"] = to_bhwc(cond_batch[
            "down" if "down" in cond_batch else "masked_image"][:n])
        mean, std = self._dump_norm()
        base = os.path.join(self.out_dir, "samples")
        for name, imgs in grids.items():
            save_range_image_grid(
                imgs.float().cpu().numpy(),
                os.path.join(base, f"samples_step{step:08d}_{name}.png"),
                mean=mean, std=std)
        return os.path.join(base, f"samples_step{step:08d}_result.png")

    def dump_samples(self, step: int, cond_batch=None) -> Optional[str]:
        """Write <output_dir>/samples/samples_step{step:08d}.png (a
        conditional model: _result, _target and _input grids from
        `cond_batch`); returns the path, or None for a conditional model
        without a condition batch."""
        if self.spec.cond_channels:
            if cond_batch is None or self.cond_fn is None:
                log.warning("sample_every_steps needs a condition batch for "
                            "conditional models (use rangeldm_tpu_torch."
                            "sample_conditional offline, or call "
                            "dump_samples(cond_batch=...))")
                return None
            return self._dump_conditional(step, cond_batch)
        sample = self.make_sample_fn(
            num_steps=int(self.cfg.get("ddpm_num_inference_steps", 50)))
        images = sample(self._generator(step)).float().cpu().numpy()
        path = os.path.join(self.out_dir, "samples",
                            f"samples_step{step:08d}.png")
        mean, std = self._dump_norm()
        save_range_image_grid(images, path, mean=mean, std=std)
        return path

    def fit(self, batches, max_steps: Optional[int] = None,
            log_every: int = 50, loader=None) -> dict:
        """Train on `batches` until they run out or the step count reaches
        `max_steps`. Every `log_every` steps (and at the last) the loss,
        the gradient norm, the step and the steps per second since the
        start of this call go to <output_dir>/train_log.jsonl, with the
        `data_wait_frac` of `loader` (the RangeLoader feeding `batches`)
        when one is given. A checkpoint every `checkpointing_steps`, a
        sample dump every `sample_every_steps` (a conditional model samples
        from the current batch's conditions), and a checkpoint at the next
        step boundary after SIGUSR1 or when an exception escapes. Returns
        the last logged record."""
        cfg = self.cfg
        ckpt_steps = int(cfg.get("checkpointing_steps", 500))
        sample_steps = cfg.get("sample_every_steps")
        logger = ScalarLogger(self.out_dir,
                              csv=bool(cfg.get("csv_log", False)),
                              tensorboard=bool(cfg.get("tensorboard", True)),
                              wandb=bool(cfg.get("wandb", False)))
        last = {}
        t0 = time.perf_counter()
        step0 = step = self.state.step
        self.unet.train()

        def save_now():
            self.ckpt.save(self.state.step, self.state)

        with emergency_checkpoint(save_now) as melk:
            for batch in batches:
                batch = self._to_device(batch)
                metrics = self.train_step(self.state, batch,
                                          self.state.generator)
                melk()
                step += 1
                done = bool(max_steps) and step >= max_steps
                if step % log_every == 0 or done:
                    # float() waits for the device: only at log steps
                    last = {k: float(v) for k, v in metrics.items()}
                    last.update(step=step, sps=(
                        (step - step0)
                        / max(time.perf_counter() - t0, 1e-9)))
                    if loader is not None:
                        last["data_wait_frac"] = loader.wait_fraction
                    logger.log(step, last)
                if step % ckpt_steps == 0:
                    self.ckpt.save(step, self.state)
                if sample_steps and step % int(sample_steps) == 0:
                    self.dump_samples(step, cond_batch=(
                        batch if self.spec.cond_channels else None))
                    melk()   # serve a signal that came during the dump
                if done:
                    break
        return last

    def save_final(self) -> str:
        """Write <output_dir>/pipeline in the diffusers layout (unet/,
        unet_ema/ when the EMA is kept, vae/, scheduler/) with the run
        record in model_index.json: the model, the pos channel, the image
        size, the sensor and the range normalization it was trained with
        (rangeldm_tpu/train_ldm.py:496-527). `RangePipeline.from_pretrained`
        loads it (EMA weights by default) and back-projects with that
        sensor and normalization."""
        path = os.path.join(self.out_dir, "pipeline")
        ema = (self.state.ema_state_dict() if self.state.ema is not None
               else None)
        record = {"model": self.spec.name,
                  "pos_encoding": self.train_cfg.pos_encoding,
                  "image_size": list(self.spec.image_size),
                  "sensor": self.cfg.get("data", {}).get(
                      "sensor", self.spec.sensor),
                  "normalization": self._norm_record()}
        save_diffusers_pipeline(path, self.unet, self.vae,
                                dataclasses.asdict(self.schedule.cfg),
                                unet_ema=ema, record=record)
        return path


def build_dataset(cfg: Cfg) -> RangeImageDataset:
    """The training dataset of `data:`, with the JAX package's
    DatasetConfig fields (rangeldm_tpu/train_ldm.py:545-558)."""
    dcfg = cfg.get("data", {})
    return RangeImageDataset(DatasetConfig(
        root=dcfg.get("root", ""), sensor=dcfg.get("sensor", "kitti360"),
        width=int(dcfg.get("width", 1024)),
        used_feature=int(dcfg.get("used_feature", 2)),
        downsample=cfg.get("upsample"), inpainting=cfg.get("inpainting"),
        cache_compress=bool(dcfg.get("cache_compress", True)),
        mean=dcfg.get("mean"), std=dcfg.get("std"),
        # the same range encoding the frozen VAE was trained with
        log=bool(dcfg.get("log", False)),
        inverse=bool(dcfg.get("inverse", False))), train=True)


def main(argv=None) -> LdmTrainer:
    """The training command line; returns the trainer."""
    ap = argparse.ArgumentParser(
        description="Train a RangeLDM / RangeDM model from YAML configs.")
    ap.add_argument("--cfg", required=True, nargs="+",
                    help="YAML config(s), merged left to right: later files "
                         "override (vae/main.py:632-636)")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "must be asked for)")
    args = ap.parse_args(argv)
    cfg = Cfg.wrap(expand_env(load_config(*args.cfg)))

    ds = build_dataset(cfg)
    bs = int(cfg.get("train_batch_size", 32))
    trainer = LdmTrainer(cfg, device=args.device)
    if (cfg.get("cache_latents") and trainer.vae is not None
            and not cfg.get("upsample") and not cfg.get("inpainting")):
        # unconditional training with a frozen VAE: encode the dataset once
        # and train from the cached posterior moments; the tag carries the
        # encode dtype, since bf16 and f32 encodes differ
        dtype = torch.finfo(trainer.compute_dtype).dtype
        moments = precompute_moments(
            trainer.vae, ds, batch_size=bs,
            out_path=os.path.join(trainer.out_dir, "latent_moments.npy"),
            tag=f"{params_fingerprint(trainer.vae)}:{dtype}", log=print,
            dtype=trainer.compute_dtype)
        loader = RangeLoader(MomentsDataset(moments), batch_size=bs)
    else:
        if cfg.get("cache_latents"):
            print("[latent-cache] cache_latents ignored: it applies only "
                  "to unconditional training with a frozen VAE "
                  "(conditional runs need per-step images for conditions)")
        loader = RangeLoader(ds, batch_size=bs)

    if len(loader) == 0:
        raise ValueError(f"no training batch: {len(loader.dataset)} samples "
                         f"under data.root, batch size {bs}")
    start = trainer.resume()
    if start:
        print(f"[resume] restored step {start}")
    total = int(cfg.get("num_epochs", 1000)) * len(loader)

    def epochs():
        while True:
            yield from loader

    batches = epochs()
    try:
        trainer.fit(batches, max_steps=args.max_steps or total,
                    log_every=int(cfg.get("log_every", 50)), loader=loader)
    finally:
        batches.close()     # stops the loader's producer thread
    trainer.save_final()
    return trainer


if __name__ == "__main__":
    main()
