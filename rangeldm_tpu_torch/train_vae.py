"""VAE-GAN training, the first stage of RangeLDM (the JAX package's
rangeldm_tpu/train_vae.py, after vae/main.py). From the command line, with
YAML configs merged left to right:

    python -m rangeldm_tpu_torch.train_vae \
        --cfg rangeldm_tpu/configs/vae_kitti360.yaml my_overrides.yaml \
        [--max_steps N] [--device cpu]

or from Python:

    from rangeldm_tpu_torch.train_vae import VaeTrainer
    trainer = VaeTrainer(cfg)              # on CUDA; device="cpu" to ask
    trainer.resume()                       # for the CPU
    trainer.fit(batches, max_steps=1000)
    trainer.save_final()                   # vae_sgm{,_ema}.safetensors

`cfg` has the keys of the shipped VAE configs (vae_kitti360.yaml,
vae_nuscenes.yaml): `vae:` (ch, ch_mult, z_channels, act, circular),
`loss:` (VaeLossConfig's fields, `metakernel` true / 2 / false,
`disc_num_layers`, `disc_ndf`, `perceptual_kind`), `data:`, `batch_size`,
`base_learning_rate` and `scale_lr`, `mixed_precision`,
`checkpoint_every_steps`, `log_images_every`, `lpips_checkpoint`, `seed`,
`output_dir`, and this package's `log_every`. Per batch, one generator
step then one discriminator step; the learning rate is base_lr *
batch_size with scale_lr (vae/main.py:846-873).

Checkpoints are safetensors + JSON (training/checkpoint.py), rolling, every
`checkpoint_every_steps`, keeping three, and on SIGUSR1; `resume` restores
the newest. Each step's posterior noise comes from a generator seeded by
(seed, step, stream), and `main` moves the loader to the resumed step's
place in its epoch, so a resumed run equals an uninterrupted one bit for
bit on the CPU, and on the card under deterministic algorithms
(`torch.use_deterministic_algorithms(True)`, cuDNN deterministic and not
benchmarking, CUBLAS_WORKSPACE_CONFIG=:4096:8 set before CUDA starts),
which this module does not set: with cuDNN's default algorithms two runs
differ in the last bits. The final weights are the sgm-grammar
`vae_sgm.safetensors` and `vae_sgm_ema.safetensors` under output_dir,
which `train_ldm.load_vae` and `eval_vae` read; no orbax tree is written.

Not ported: data-parallel training (the JAX package's shard_by_process).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time
from typing import Mapping, Optional

import numpy as np
import torch

from rangeldm_tpu_torch.convert import write_safetensors
from rangeldm_tpu_torch.data.datasets import (
    DatasetConfig, RangeImageDataset, RangeLoader,
)
from rangeldm_tpu_torch.geometry import get_spec, to_voxel
from rangeldm_tpu_torch.models.discriminator import (
    NLayerDiscriminator, NLayerDiscriminatorMetaKernel,
    NLayerDiscriminatorMetaKernel2,
)
from rangeldm_tpu_torch.models.lpips import make_perceptual_fn
from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
from rangeldm_tpu_torch.pipelines.samplers import to_bcwh, to_bhwc
from rangeldm_tpu_torch.sample_ldm import resolve_device
from rangeldm_tpu_torch.training.checkpoint import TrainCheckpointer
from rangeldm_tpu_torch.training.image_logger import ImageLogger
from rangeldm_tpu_torch.training.loggers import (
    ScalarLogger, emergency_checkpoint,
)
from rangeldm_tpu_torch.training.vae_trainer import (
    VaeGanState, VaeLossConfig, make_vae_gan_steps, reconstruction_loss,
)
from rangeldm_tpu_torch.utils.config import Cfg, expand_env, load_config

GEN, DISC = 0, 1      # the noise streams of the two steps


def step_generator(seed: int, step: int, stream: int,
                   device) -> torch.Generator:
    """A generator seeded by (seed, step, stream) alone."""
    key = np.random.SeedSequence([seed, step, stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(key))


def loss_config(lcfg: Mapping, used_feature: int) -> VaeLossConfig:
    """VaeLossConfig from a config's `loss:` (rangeldm_tpu/train_vae.py:
    81-100)."""
    defaults = VaeLossConfig()
    fields = {f: type(getattr(defaults, f))(lcfg[f])
              for f in VaeLossConfig.__dataclass_fields__ if f in lcfg}
    return VaeLossConfig(**{**fields, "used_feature": used_feature})


class VaeTrainer:
    """Builds the VAE, the discriminator, the perceptual and BEV branches,
    both optimizers and the EMA from `cfg`; `fit` consumes any iterable of
    (B, H, W, C) images or {'jpg': ...} batches."""

    def __init__(self, cfg: Mapping, device=None):
        self.cfg = cfg = Cfg.wrap(dict(cfg))
        self.device = resolve_device(device)
        # opt-in bf16 autocast of the VAE's and discriminator's forwards
        self.compute_dtype = (torch.bfloat16
                              if cfg.get("mixed_precision") == "bf16"
                              else torch.float32)
        vcfg, dcfg = cfg.get("vae", {}), cfg.get("data", {})
        lcfg = cfg.get("loss", {})
        uf = int(dcfg.get("used_feature", 2))
        self.vae_cfg = VaeConfig(
            in_channels=uf, out_ch=uf, ch=int(vcfg.get("ch", 64)),
            ch_mult=tuple(vcfg.get("ch_mult", (1, 2, 4))),
            z_channels=int(vcfg.get("z_channels", 4)),
            act=vcfg.get("act", "silu"),
            circular=bool(vcfg.get("circular", True)))

        # one sensor spec drives the dataset's normalization, the
        # MetaKernel geometry and the BEV branches
        encoding = lcfg.get("encoding", "linear")
        spec_kw = {"width": int(dcfg.get("width", 1024)),
                   "log": encoding == "log", "inverse": encoding == "inverse"}
        for k in ("mean", "std"):
            if dcfg.get(k) is not None:
                spec_kw[k] = float(dcfg[k])
        self.sensor_spec = get_spec(dcfg.get("sensor", "kitti360"),
                                    **spec_kw)
        self.loss_cfg = lc = loss_config(lcfg, uf)

        mk = lcfg.get("metakernel", True)
        if lc.disc_bev and mk:
            raise ValueError(
                "loss.disc_bev requires loss.metakernel: false (the "
                "MetaKernel discriminator interprets channel 0 as a "
                "normalized range image, not a BEV density grid)")
        nl = int(lcfg.get("disc_num_layers", 3))
        sp = self.sensor_spec
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(cfg.get("seed", 0)))
            vae = AutoencoderKL(self.vae_cfg)
            if mk == 2:
                disc = NLayerDiscriminatorMetaKernel2(
                    uf, n_layers=nl, range_mean=sp.mean, range_std=sp.std)
            elif mk:
                disc = NLayerDiscriminatorMetaKernel(
                    uf, n_layers=nl, range_mean=sp.mean, range_std=sp.std)
            else:
                disc = NLayerDiscriminator(
                    2 if lc.disc_bev else uf,
                    ndf=int(lcfg.get("disc_ndf", 64)), n_layers=nl)

        bs = int(cfg.get("batch_size", 16))
        base_lr = float(cfg.get("base_learning_rate", 4.5e-6))
        self.lr = base_lr * bs if cfg.get("scale_lr", True) else base_lr
        self.state = VaeGanState.create(vae.to(self.device),
                                        disc.to(self.device), self.lr, lc)

        voxel_fn = None
        if lc.needs_voxels:
            def voxel_fn(img):
                return to_voxel(to_bhwc(img), sp)
        perceptual_fn = None
        if lc.perceptual_weight > 0:
            # darknet sees range images; VGG-LPIPS only ever the BEV
            # three-channel construction (losses/__init__.py:257-292)
            kind = lcfg.get("perceptual_kind",
                            "vgg" if lc.bev_perceptual else "darknet")
            if kind == "vgg" and not lc.bev_perceptual:
                raise ValueError(
                    "perceptual_kind: vgg needs loss.bev_perceptual: true "
                    "(the reference's non-BEV perceptual is pointcloud "
                    "3D-LPIPS, which needs pcdet CUDA ops and is out of "
                    "scope; use perceptual_kind: darknet for range images)")
            if kind == "darknet" and lc.bev_perceptual:
                raise ValueError(
                    "perceptual_kind: darknet needs loss.bev_perceptual: "
                    "false (the reference's darknet branch takes precedence "
                    "over bev_perceptual and sees range images, "
                    "losses/__init__.py:258-266)")
            perceptual_fn = make_perceptual_fn(
                cfg.get("lpips_checkpoint"), kind=kind, spec=sp,
                device=self.device)
        self.gen_step, self.disc_step = make_vae_gan_steps(
            lc, voxel_fn=voxel_fn, perceptual_fn=perceptual_fn,
            compute_dtype=self.compute_dtype)
        self.seed = int(cfg.get("seed", 0))

        self.out_dir = cfg.get("output_dir") or "runs/vae"
        os.makedirs(self.out_dir, exist_ok=True)
        self.ckpt = TrainCheckpointer(os.path.join(self.out_dir,
                                                   "checkpoints"),
                                      total_limit=3)
        self._eval_vae = None

    def _to_device(self, batch) -> torch.Tensor:
        x = batch["jpg"] if isinstance(batch, Mapping) else batch
        return to_bcwh(torch.as_tensor(x).to(self.device, torch.float32))

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=self.compute_dtype,
                              enabled=self.compute_dtype != torch.float32)

    def resume(self) -> int:
        """Restore the newest checkpoint under output_dir/checkpoints, if
        any; returns its step (0 when there is none)."""
        sd = self.ckpt.restore()
        if sd is None:
            return 0
        self.state.load_state_dict(sd)
        return self.state.step

    def train_step(self, x: torch.Tensor) -> dict:
        """One generator step, then one discriminator step, on the
        (B, C, W, H) batch `x`; their metrics, as tensors."""
        step = self.state.step
        gm = self.gen_step(self.state, x, generator=step_generator(
            self.seed, step, GEN, self.device))
        dm = self.disc_step(self.state, x, generator=step_generator(
            self.seed, step + 1, DISC, self.device))
        return {**gm, **dm}

    @torch.no_grad()
    def reconstruct(self, vae: AutoencoderKL, x: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
        with self._autocast():
            xrec, _, _ = vae(x, generator=generator)
        return xrec.float()

    def fit(self, batches, max_steps: Optional[int] = None,
            log_every: int = 50, loader=None) -> dict:
        """Train until `batches` run out or the step count reaches
        `max_steps`. Every `log_every` steps (and at the last) both steps'
        metrics, the step and the steps per second since the start of this
        call go to output_dir/train_log.jsonl (with the loader's
        `data_wait_frac` when `loader` is given); a checkpoint every
        `checkpoint_every_steps`, reconstruction grids every
        `log_images_every`, and a checkpoint at the next step boundary
        after SIGUSR1 or when an exception escapes. Returns the last logged
        record."""
        cfg = self.cfg
        ckpt_every = int(cfg.get("checkpoint_every_steps", 1020))
        image_logger = None
        if cfg.get("log_images_every"):
            image_logger = ImageLogger(
                os.path.join(self.out_dir, "images"),
                every=int(cfg.log_images_every),
                mean=float(self.sensor_spec.mean),
                std=float(self.sensor_spec.std))
        logger = ScalarLogger(self.out_dir,
                              tensorboard=bool(cfg.get("tensorboard", True)),
                              csv=bool(cfg.get("csv_log", False)),
                              wandb=bool(cfg.get("wandb", False)))
        last = {}
        t0 = time.perf_counter()
        step0 = step = self.state.step

        def save_now():
            self.ckpt.save(self.state.step, self.state)

        with emergency_checkpoint(save_now) as melk:
            for batch in batches:
                x = self._to_device(batch)
                metrics = self.train_step(x)
                melk()
                step += 1
                if image_logger is not None and image_logger.should_log(step):
                    xrec = self.reconstruct(
                        self.state.vae, x,
                        torch.Generator(self.device).manual_seed(step))
                    image_logger.log(
                        step, inputs=to_bhwc(x).cpu().numpy(),
                        reconstructions=to_bhwc(xrec).cpu().numpy())
                    melk()
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
                if step % ckpt_every == 0:
                    self.ckpt.save(step, self.state)
                if done:
                    break
        return last

    def ema_vae(self) -> AutoencoderKL:
        """A copy of the VAE holding the EMA weights, refreshed at every
        call; the training VAE is not touched."""
        if self._eval_vae is None:
            self._eval_vae = copy.deepcopy(self.state.vae).eval()
            self._eval_vae.requires_grad_(False)
        with torch.no_grad():
            for p, e in zip(self._eval_vae.parameters(), self.state.ema):
                p.copy_(e)
        return self._eval_vae

    def validate(self, batches, max_batches: int = 50) -> dict:
        """The mean reconstruction loss of the live and the EMA weights
        over at most `max_batches` batches, one posterior draw per batch
        shared by both (rangeldm_tpu/train_vae.py:281-316; the reference
        caps at limit_val_batches 50)."""
        lc = self.loss_cfg
        live = self.state.vae
        ema = self.ema_vae()
        totals = {"val/rec_loss": 0.0, "val/rec_loss_ema": 0.0}
        gen = torch.Generator(self.device).manual_seed(1234)
        n = 0
        for batch in batches:
            if n >= max_batches:
                break
            x = self._to_device(batch)
            state = gen.get_state()
            for key, vae in (("val/rec_loss", live),
                             ("val/rec_loss_ema", ema)):
                gen.set_state(state)
                xrec = self.reconstruct(vae, x, gen)
                totals[key] += float(reconstruction_loss(x, xrec, lc).mean())
            n += 1
        return {k: v / max(n, 1) for k, v in totals.items()}

    def save_final(self) -> str:
        """Write output_dir/vae_sgm.safetensors (the live weights) and
        vae_sgm_ema.safetensors (the EMA's) in the sgm key grammar; returns
        the first path."""
        path = os.path.join(self.out_dir, "vae_sgm.safetensors")
        write_safetensors(self.state.vae.state_dict(), path)
        write_safetensors(self.state.ema_state_dict(), os.path.join(
            self.out_dir, "vae_sgm_ema.safetensors"))
        return path


def dataset_config(cfg: Cfg) -> DatasetConfig:
    """The dataset of `data:`, in the VAE's range encoding
    (rangeldm_tpu/train_vae.py:357-368)."""
    dcfg = cfg.get("data", {})
    encoding = cfg.get("loss", {}).get("encoding", "linear")
    return DatasetConfig(
        root=dcfg.get("root", ""), sensor=dcfg.get("sensor", "kitti360"),
        width=int(dcfg.get("width", 1024)),
        used_feature=int(dcfg.get("used_feature", 2)),
        log=encoding == "log", inverse=encoding == "inverse",
        cache_compress=bool(dcfg.get("cache_compress", True)),
        mean=dcfg.get("mean"), std=dcfg.get("std"))


def main(argv=None) -> VaeTrainer:
    """The training command line; returns the trainer."""
    ap = argparse.ArgumentParser(
        description="Train the RangeLDM range-image VAE (VAE-GAN) from "
                    "YAML configs.")
    ap.add_argument("--cfg", required=True, nargs="+",
                    help="YAML config(s), merged left to right: later files "
                         "override (vae/main.py:632-636)")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "must be asked for)")
    args = ap.parse_args(argv)
    cfg = Cfg.wrap(expand_env(load_config(*args.cfg)))

    ds_config = dataset_config(cfg)
    bs = int(cfg.get("batch_size", 16))
    loader = RangeLoader(RangeImageDataset(ds_config, train=True),
                         batch_size=bs)
    if len(loader) == 0:
        raise ValueError(f"no training batch: {len(loader.dataset)} samples "
                         f"under data.root, batch size {bs}")
    trainer = VaeTrainer(cfg, device=args.device)
    start = trainer.resume()
    if start:
        print(f"[resume] restored step {start}")
    loader.seek(start)
    total = int(cfg.get("max_epochs", 1000)) * len(loader)

    def epochs():
        while True:
            yield from loader

    batches = epochs()
    try:
        trainer.fit(batches, max_steps=args.max_steps or total,
                    log_every=int(cfg.get("log_every", 50)), loader=loader)
    finally:
        batches.close()     # stops the loader's producer thread

    # the held-out split (drives 0000/0002), as vae/main.py:905-906's
    # trainer.test: live and EMA reconstruction losses
    val_ds = RangeImageDataset(ds_config, train=False)
    if len(val_ds):
        val = trainer.validate(RangeLoader(val_ds, batch_size=bs,
                                           shuffle=False, drop_last=False))
        print("[val]", json.dumps(val))
        with open(os.path.join(trainer.out_dir, "val_metrics.json"),
                  "w") as f:
            json.dump({"step": trainer.state.step, **val}, f)
    trainer.save_final()
    return trainer


if __name__ == "__main__":
    main()
