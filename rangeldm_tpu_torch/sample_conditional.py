"""Conditional sampling CLI (ldm/inference_conditional.py): 4x beam
densification or azimuth-sector inpainting of held-out scans.

    python -m rangeldm_tpu_torch.sample_conditional \
        --pipeline runs/up/pipeline --mode upsample \
        --data $KITTI360_DATASET --out exp/ --samples 100

Writes the triplets the MAE metrics read (ldm/inference_conditional.py:
141-210), per sample index i:
  {prefix}_result/{i}.npy   the generated range image (H, W, C)
  {prefix}_target/{i}.npy   the ground truth
  {prefix}_input/{i}.npy    the condition (sparse beams or masked image)
with prefix `densification` (upsample) or `inpainting`. One process; runs
on CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch

from rangeldm_tpu_torch.data.datasets import (
    DatasetConfig, RangeImageDataset, RangeLoader,
)
from rangeldm_tpu_torch.models.layers import pixel_unshuffle_azimuth
from rangeldm_tpu_torch.pipelines.samplers import (
    conditional_latent_sample, to_bcwh,
)
# a module reference, not names: sample_ldm imports the pipelines package,
# whose API imports this module in turn
from rangeldm_tpu_torch import sample_ldm
from rangeldm_tpu_torch.training.conditions import encode_masked_image_cond

MODES = ("upsample", "inpainting")
COND_KEYS = ("down", "masked_image", "inpainting_mask")


def build_conditional_sampler(pipe, batch_size: int, mode: str,
                              num_steps: int = 50, factor: int = 4,
                              method: str = "ddim"):
    """A function `sample(generator, cond_inputs) -> (B, H, W, C)` images on
    the pipeline's device, in its dtype. `cond_inputs` holds 'down'
    (upsample) or 'masked_image' and 'inpainting_mask' (inpainting), each
    (B, H', W, C') in the loader's layout, as arrays or tensors. The
    generator draws the masked image's posterior noise, then x_T.
    method: 'ddim' or 'dpmpp' (DPM-Solver++ 2M)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if pipe["vae"] is None:
        raise ValueError("conditional sampling needs a latent pipeline")
    unet, cfg = pipe["unet"], pipe["unet_cfg"]
    vae, sf = pipe["vae"], pipe["vae_cfg"].scaling_factor
    dtype, device = pipe["dtype"], pipe["device"]
    h, w = cfg.sample_size
    shape = (batch_size, h, w, cfg.out_channels)
    # a conditional model trained with the pos channel needs it here too
    # (the shipped conditional configs have none)
    pos = sample_ldm.pipe_pos_encoding(pipe)

    def tensor(v) -> torch.Tensor:
        v = torch.as_tensor(v)
        if v.shape[0] != batch_size:
            raise ValueError(f"condition batch {v.shape[0]} != sampler "
                             f"batch {batch_size}")
        return to_bcwh(v.to(device=device, dtype=dtype))

    @torch.inference_mode()
    def sample(generator: Optional[torch.Generator], cond_inputs: dict):
        if mode == "upsample":
            cond = pixel_unshuffle_azimuth(tensor(cond_inputs["down"]),
                                           factor)
        else:
            cond = encode_masked_image_cond(
                vae, sf, tensor(cond_inputs["masked_image"]),
                tensor(cond_inputs["inpainting_mask"]), generator)
        return conditional_latent_sample(
            unet, vae.decode, pipe["schedule"], shape, sf, cond, generator,
            num_steps=num_steps, pos_encoding=pos, method=method,
            dtype=dtype, device=device)

    return sample


def conditional_dataset_config(pipe, data_root: str, sensor: str, mode: str,
                               factor: int, mask_rate: float) -> DatasetConfig:
    """The dataset that gives the conditions in the normalization, width
    and channel count the model was trained with: the artifact's
    meta['normalization'] record where it has one, else the sensor's
    defaults."""
    norm = (pipe.get("meta") or {}).get("normalization") or {}
    _, model_w = sample_ldm.pipe_image_size(pipe)
    used = pipe["vae_cfg"].in_channels if pipe["vae_cfg"] else 2
    return DatasetConfig(
        root=data_root, sensor=sensor, width=model_w, used_feature=used,
        downsample=factor if mode == "upsample" else None,
        inpainting=mask_rate if mode == "inpainting" else None,
        mean=norm.get("mean"), std=norm.get("std"),
        log=bool(norm.get("log", False)),
        inverse=bool(norm.get("inverse", False)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline", required=True)
    ap.add_argument("--mode", choices=MODES, required=True)
    ap.add_argument("--data", default=os.environ.get("KITTI360_DATASET", ""))
    ap.add_argument("--sensor", default="kitti360")
    ap.add_argument("--out", default="cond_samples")
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--method", default="ddim", choices=["ddim", "dpmpp"])
    ap.add_argument("--factor", type=int, default=4)
    ap.add_argument("--mask_rate", type=float, default=0.0625)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "must be asked for)")
    args = ap.parse_args(argv)

    device = sample_ldm.resolve_device(args.device)
    pipe = sample_ldm.load_diffusers_pipeline(args.pipeline, device=device)
    sample = build_conditional_sampler(pipe, args.batch_size, args.mode,
                                       args.steps, args.factor,
                                       method=args.method)
    prefix = "densification" if args.mode == "upsample" else "inpainting"
    dirs = {sub: os.path.join(args.out, f"{prefix}_{sub}")
            for sub in ("result", "target", "input")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    ds = RangeImageDataset(
        conditional_dataset_config(pipe, args.data, args.sensor, args.mode,
                                   args.factor, args.mask_rate),
        train=False)
    loader = RangeLoader(ds, batch_size=args.batch_size, shuffle=True,
                         seed=0)
    written = 0
    for bi, batch in enumerate(loader):
        if written >= args.samples:
            break
        result = sample(sample_ldm.batch_generator(device, 0, bi),
                        {k: v for k, v in batch.items() if k in COND_KEYS})
        result = result.float().cpu().numpy()
        inputs = batch["down" if args.mode == "upsample" else "masked_image"]
        for j in range(min(len(result), args.samples - written)):
            idx = bi * args.batch_size + j
            np.save(os.path.join(dirs["result"], f"{idx}.npy"), result[j])
            np.save(os.path.join(dirs["target"], f"{idx}.npy"),
                    batch["jpg"][j])
            np.save(os.path.join(dirs["input"], f"{idx}.npy"), inputs[j])
            written += 1
    print(f"wrote {written} conditional samples to {args.out} on {device}")
    if written < args.samples:
        print(f"warning: dataset exhausted at {written} < requested "
              f"{args.samples} samples", file=sys.stderr)
    return written


if __name__ == "__main__":
    main()
