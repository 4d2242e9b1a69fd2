"""The sampling pipeline under `RangePipeline` (api.py) and the sampling
CLIs: a pipeline directory loaded into a pipe dict (`meta`, `unet`,
`unet_cfg`, `vae`, `vae_cfg`, `schedule`, `device`, `dtype`), the facts
derived from it, the samplers built over it and the files their samples
are written to. Only this module adds the dict's two caches, `replicas`
and `graphed` (`replicas`).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from rangeldm_tpu_torch.convert import (
    RECORD_KEYS, WEIGHT_FILES, load_diffusers_unet, load_diffusers_vae,
)
from rangeldm_tpu_torch.diffusion.schedule import Schedule, ScheduleConfig
from rangeldm_tpu_torch.geometry.inverse import to_point_cloud_masked
from rangeldm_tpu_torch.geometry.sensors import SensorSpec
from rangeldm_tpu_torch.geometry.voxelize import to_voxel
from rangeldm_tpu_torch.models.layers import pixel_unshuffle_azimuth
from rangeldm_tpu_torch.models.unet import UNet2D
from rangeldm_tpu_torch.models.vae import AutoencoderKL
from rangeldm_tpu_torch.parallel.mesh import (
    largest_divisible_prefix, local_devices, resolve_device, split_batch,
)
from rangeldm_tpu_torch.pipelines.graphs import GraphedUNet
from rangeldm_tpu_torch.pipelines.samplers import (
    conditional_latent_sample, ddim_sample, latent_sample, to_bcwh,
)
from rangeldm_tpu_torch.training.conditions import encode_masked_image_cond
from rangeldm_tpu_torch.utils.png import write_png_gray


def is_diffusers_pipeline(path: str) -> bool:
    """The released layout: unet/ holds torch weights."""
    return any(os.path.exists(os.path.join(path, "unet", f))
               for f in WEIGHT_FILES)


def _ready(module: torch.nn.Module, device, dtype) -> torch.nn.Module:
    return module.to(device=device, dtype=dtype).eval().requires_grad_(False)


def load_diffusers_pipeline(path: str, dtype: torch.dtype = torch.bfloat16,
                            device=None, use_ema: bool = True,
                            pos_encoding: Optional[bool] = None) -> dict:
    """Load a released RangeLDM pipeline directory (diffusers layout:
    {unet, unet_ema, vae, scheduler}/) onto `device` in `dtype`. Each state
    dict loads with strict=True. A pipeline written by `LdmTrainer` also
    holds its run record in model_index.json (RECORD_KEYS: the sensor, the
    range normalization, the pos channel, ...), which goes into `meta`;
    an explicit `pos_encoding` wins over the record."""
    if not is_diffusers_pipeline(path):
        raise ValueError(f"{path} is not a diffusers-layout pipeline "
                         f"directory (unet/{WEIGHT_FILES[0]}); an orbax "
                         f"pipeline of the JAX package is exported with "
                         f"tools/export_pipeline.py first")
    device = resolve_device(device)
    which = "unet_ema" if use_ema and os.path.isdir(
        os.path.join(path, "unet_ema")) else "unet"
    unet_cfg, sd = load_diffusers_unet(os.path.join(path, which))
    unet_cfg = dataclasses.replace(unet_cfg, circular=True)
    unet = UNet2D(unet_cfg)
    unet.load_state_dict(sd, strict=True)
    unet = _ready(unet, device, dtype)

    vae = vae_cfg = None
    vae_dir = os.path.join(path, "vae")
    if os.path.isdir(vae_dir):
        vae_cfg, vsd = load_diffusers_vae(vae_dir)
        vae = AutoencoderKL(vae_cfg)
        vae.load_state_dict(vsd, strict=True)
        vae = _ready(vae, device, dtype)

    sched_cfg = {}
    sched_path = os.path.join(path, "scheduler", "scheduler_config.json")
    if os.path.exists(sched_path):
        with open(sched_path) as f:
            sched_cfg = json.load(f)
    schedule = Schedule(ScheduleConfig(**{
        k: v for k, v in sched_cfg.items()
        if k in ScheduleConfig.__dataclass_fields__}))
    record = {}
    index_path = os.path.join(path, "model_index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            record = {k: v for k, v in json.load(f).items()
                      if k in RECORD_KEYS}
    if pos_encoding is None:
        # released pipelines record nothing about extra input channels; in
        # every released config an in-out gap of exactly 1 is the pos
        # channel
        pos_encoding = record.get("pos_encoding", (
            unet_cfg.in_channels - unet_cfg.out_channels) == 1)
    meta = {**record, "pos_encoding": bool(pos_encoding),
            "source": "diffusers", "schedule": sched_cfg}
    return dict(meta=meta, unet=unet, unet_cfg=unet_cfg, vae=vae,
                vae_cfg=vae_cfg, schedule=schedule, device=device,
                dtype=dtype)


def pipe_image_size(pipe):
    """(H, W) of the generated image: the UNet sample size times the VAE's
    down factor."""
    f = pipe["vae_cfg"].down_factor if pipe["vae_cfg"] else 1
    h, w = pipe["unet_cfg"].sample_size
    return int(h) * f, int(w) * f


def pipe_pos_encoding(pipe) -> bool:
    """Whether the UNet takes the pos-encoding channel: the loader's record,
    else an in-out channel gap of exactly 1."""
    meta = pipe.get("meta") or {}
    if "pos_encoding" in meta:
        return bool(meta["pos_encoding"])
    cfg = pipe["unet_cfg"]
    return (cfg.in_channels - cfg.out_channels) == 1


def sampling_mesh(pipe, batch_size: int, mesh) -> tuple:
    """`mesh` as a tuple of devices starting at the pipeline's device (None:
    that device alone); the batch must split evenly over it."""
    mesh = tuple(torch.device(d) for d in mesh) if mesh else (
        pipe["device"],)
    if mesh[0] != pipe["device"]:
        raise ValueError(f"a sampling mesh starts at the pipeline's device "
                         f"{pipe['device']}, not {mesh[0]}")
    if batch_size % len(mesh):
        raise ValueError(
            f"batch_size {batch_size} not divisible by mesh size "
            f"{len(mesh)}; pick a multiple so every chip gets equal work")
    return mesh


def replicas(pipe, mesh) -> tuple:
    """(model functions, VAEs) on each device of `mesh`, made once and kept
    in the pipe dict: the models under `replicas` (the pipeline's own
    device holds its own modules), and over each UNet its `GraphedUNet`
    under `graphed`, so that its CUDA graphs outlive the sampler that each
    call builds (pipelines/graphs.py)."""
    store = pipe.setdefault("replicas", {str(pipe["device"]): (
        pipe["unet"], pipe["vae"])})
    graphed = pipe.setdefault("graphed", {})
    for dev in map(str, mesh):
        if dev not in store:
            store[dev] = tuple(
                None if m is None else copy.deepcopy(m).to(dev)
                for m in (pipe["unet"], pipe["vae"]))
        if dev not in graphed:
            graphed[dev] = GraphedUNet(store[dev][0])
    return (tuple(graphed[str(d)] for d in mesh),
            tuple(store[str(d)][1] for d in mesh))


def build_sampler(pipe, batch_size: int, num_steps: int = 50,
                  method: str = "ddim", eta: float = 0.0,
                  final_only: bool = True, mesh=None):
    """A function `sample(generator) -> (B, H, W, C)` images on the
    pipeline's device, in its dtype. `eta` is the DDIM stochasticity.
    final_only=False (latent pipelines) makes it return (images, decoded
    state before every step) as `latent_sample` does. `mesh`, a tuple of
    devices from the pipeline's on (`resolve_sampling_mesh`), splits every
    batch over them, one replica of the models on each, with the same
    result (pipelines/samplers.py). Each replica's UNet runs through its
    `GraphedUNet` (`replicas`)."""
    mesh = sampling_mesh(pipe, batch_size, mesh)
    unets, vaes = replicas(pipe, mesh)
    cfg = pipe["unet_cfg"]
    h, w = cfg.sample_size
    shape = (batch_size, h, w, cfg.out_channels)
    kw = dict(num_steps=num_steps, eta=eta, method=method,
              pos_encoding=pipe_pos_encoding(pipe), dtype=pipe["dtype"],
              mesh=mesh)

    if pipe["vae"] is not None:
        sf = pipe["vae_cfg"].scaling_factor

        @torch.inference_mode()
        def sample(generator: Optional[torch.Generator] = None):
            return latent_sample(unets, [v.decode for v in vaes],
                                 pipe["schedule"], shape,
                                 sf, generator, final_only=final_only,
                                 **kw)
    elif not final_only:
        raise ValueError("final_only=False needs a latent pipeline")
    else:
        # pixel space: ddim_sample runs every method, ddpm included
        @torch.inference_mode()
        def sample(generator: Optional[torch.Generator] = None):
            return ddim_sample(unets, pipe["schedule"], shape, generator,
                               **kw)
    return sample


MODES = ("upsample", "inpainting")    # the conditional samplers


def build_conditional_sampler(pipe, batch_size: int, mode: str,
                              num_steps: int = 50, factor: int = 4,
                              method: str = "ddim", mesh=None):
    """A function `sample(generator, cond_inputs) -> (B, H, W, C)` images on
    the pipeline's device, in its dtype. `cond_inputs` holds 'down'
    (upsample) or 'masked_image' and 'inpainting_mask' (inpainting), each
    (B, H', W, C') in the loader's layout, as arrays or tensors. The
    generator draws the masked image's posterior noise, then x_T.
    method: 'ddim' or 'dpmpp' (DPM-Solver++ 2M). `mesh` splits the batch
    (the condition's encode, the denoise loop and the decode) over its
    devices, with the same result (`build_sampler`)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if pipe["vae"] is None:
        raise ValueError("conditional sampling needs a latent pipeline")
    mesh = sampling_mesh(pipe, batch_size, mesh)
    unets, vaes = replicas(pipe, mesh)
    cfg, vcfg = pipe["unet_cfg"], pipe["vae_cfg"]
    sf, dtype, device = vcfg.scaling_factor, pipe["dtype"], pipe["device"]
    h, w = cfg.sample_size
    shape = (batch_size, h, w, cfg.out_channels)
    # a conditional model trained with the pos channel needs it here too
    # (the shipped conditional configs have none)
    pos = pipe_pos_encoding(pipe)

    def chunks(v) -> list:
        v = torch.as_tensor(v)
        if v.shape[0] != batch_size:
            raise ValueError(f"condition batch {v.shape[0]} != sampler "
                             f"batch {batch_size}")
        return split_batch(to_bcwh(v.to(device=device, dtype=dtype)), mesh)

    @torch.inference_mode()
    def sample(generator: Optional[torch.Generator], cond_inputs: dict):
        if mode == "upsample":
            cond = [pixel_unshuffle_azimuth(d, factor)
                    for d in chunks(cond_inputs["down"])]
        else:
            # each chunk encoded on its device; the posterior noise drawn
            # for the batch, as one encode of the batch would draw it
            images = chunks(cond_inputs["masked_image"])
            _, _, iw, ih = images[0].shape
            f = vcfg.down_factor
            noise = torch.randn((batch_size, vcfg.z_channels, iw // f,
                                 ih // f), generator=generator, device=device)
            cond = [encode_masked_image_cond(vae, sf, im, mk,
                                             posterior_noise=nz)
                    for vae, im, mk, nz in zip(
                        vaes, images, chunks(cond_inputs["inpainting_mask"]),
                        split_batch(noise, mesh))]
        return conditional_latent_sample(
            unets, [v.decode for v in vaes], pipe["schedule"], shape, sf,
            cond, generator, num_steps=num_steps, pos_encoding=pos,
            method=method, dtype=dtype, mesh=mesh)

    return sample


def resolve_sampling_mesh(mesh_devices: str, batch_size: int,
                          device) -> tuple:
    """The CLIs' local mesh policy (rangeldm_tpu/sample_ldm.py:262-278):
    'auto' takes the largest prefix of this process's devices
    (`parallel.mesh.local_devices`) that divides the batch; an integer
    pins the count."""
    local = local_devices(device)
    if str(mesh_devices).strip().lower() == "auto":
        n = largest_divisible_prefix(len(local), batch_size)
    else:
        n = int(mesh_devices)
        if n > len(local):
            raise ValueError(f"--mesh_devices {n} > {len(local)} local "
                             f"devices")
    return tuple(local[:max(n, 1)])


def apply_meta_normalization(spec: SensorSpec, meta) -> SensorSpec:
    """The artifact's own range normalization record, when it has one."""
    norm = (meta or {}).get("normalization")
    if not norm:
        return spec
    return spec.replace(**{k: norm[k] for k in ("mean", "std", "log",
                                                 "inverse") if k in norm})


def adapt_spec_to_model(spec: SensorSpec, image_size) -> SensorSpec:
    """Reduce a sensor spec to a model's (H, W): keep the top H beams'
    tables and scale the BEV grid with the azimuth count."""
    h, w = int(image_size[0]), int(image_size[1])
    if (spec.n_beams, spec.width) == (h, w):
        return spec
    kw = {"width": w}
    if w != spec.width:
        kw["grid_sizes"] = (1, max(2, spec.grid_sizes[1] * w // spec.width),
                            max(2, spec.grid_sizes[2] * w // spec.width))
    if h != spec.n_beams:
        kw.update(n_beams=h, height=spec.height[:h], zenith=spec.zenith[:h])
    print(f"note: sensor '{spec.name}' reduced to model resolution "
          f"{h}x{w}", file=sys.stderr)
    return spec.replace(**kw)


def save_outputs(images, spec: SensorSpec, out_dir: str, start_idx: int,
                 max_depth: float = 90.0, write_png: bool = True) -> None:
    """Back-project and write .bin (and, with write_png, .png) files per
    sample (ldm/inference.py:159-183). `images` (B, H, W, C) are processed
    on the device they lie on."""
    imgs = torch.as_tensor(images).float()
    with torch.inference_mode():
        pcs, valid = to_point_cloud_masked(imgs, spec, max_depth=max_depth)
    pcs, valid = pcs.cpu().numpy(), valid.cpu().numpy()
    os.makedirs(out_dir, exist_ok=True)
    for j in range(imgs.shape[0]):
        pcs[j][valid[j]].astype(np.float32).tofile(
            os.path.join(out_dir, f"{start_idx + j}.bin"))
    if not write_png:
        return
    with torch.inference_mode():
        bev = to_voxel(imgs, spec)
    bev = (torch.clamp(bev[:, 0], 0, 1) * 255).to(torch.uint8).cpu().numpy()
    rng = torch.clamp((imgs[..., 0] * spec.std + spec.mean) / spec.range_fill,
                      0, 1) * 255
    rng = rng.to(torch.uint8).cpu().numpy()
    for j in range(imgs.shape[0]):
        write_png_gray(os.path.join(out_dir, f"{start_idx + j}_bev.png"),
                       bev[j])
        write_png_gray(os.path.join(out_dir, f"{start_idx + j}_range.png"),
                       rng[j])


def batch_generator(device: torch.device, seed: int,
                    batch_index: int) -> torch.Generator:
    """The generator of one batch: seeded from (seed, batch index), so each
    batch's samples do not depend on which batches ran before it."""
    state = np.random.SeedSequence([seed, batch_index]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))
