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
with prefix `densification` (upsample) or `inpainting`. Runs on CUDA
unless `--device cpu` is given. As in sample_ldm, each batch splits over a
local mesh (`--mesh_devices`) and the batches over the processes of a
torchrun launch, each writing its batches' files under their global
sample indices (rangeldm_tpu/sample_conditional.py:126-153).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rangeldm_tpu_torch.data.datasets import (
    DatasetConfig, RangeImageDataset, RangeLoader,
)
from rangeldm_tpu_torch.parallel.mesh import process_shard, resolve_device
from rangeldm_tpu_torch.pipelines.pipeline import (
    MODES, batch_generator, build_conditional_sampler,
    load_diffusers_pipeline, pipe_image_size, resolve_sampling_mesh,
)

COND_KEYS = ("down", "masked_image", "inpainting_mask")


def conditional_dataset_config(pipe, data_root: str, sensor: str, mode: str,
                               factor: int, mask_rate: float) -> DatasetConfig:
    """The dataset that gives the conditions in the normalization, width
    and channel count the model was trained with: the artifact's
    meta['normalization'] record where it has one, else the sensor's
    defaults."""
    norm = (pipe.get("meta") or {}).get("normalization") or {}
    _, model_w = pipe_image_size(pipe)
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
                    help="torch device (default: the CUDA device, "
                         "cuda:{LOCAL_RANK} under torchrun; 'cpu' must be "
                         "asked for)")
    ap.add_argument("--mesh_devices", default="auto",
                    help="local devices to split each batch over: 'auto' "
                         "(as many as divide the batch), an integer, or 1 "
                         "for none")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    pipe = load_diffusers_pipeline(args.pipeline, device=device)
    mesh = resolve_sampling_mesh(args.mesh_devices, args.batch_size, device)
    sample = build_conditional_sampler(pipe, args.batch_size, args.mode,
                                       args.steps, args.factor,
                                       method=args.method, mesh=mesh)
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
    # every process walks the same seed-0 order and samples its stride of
    # the batches, under global sample indices
    rank, world = process_shard()
    written = covered = 0
    for bi, batch in enumerate(loader):
        if covered >= args.samples:
            break
        covered = min((bi + 1) * args.batch_size, args.samples)
        if bi % world != rank:
            continue
        result = sample(batch_generator(device, 0, bi),
                        {k: v for k, v in batch.items() if k in COND_KEYS})
        result = result.float().cpu().numpy()
        inputs = batch["down" if args.mode == "upsample" else "masked_image"]
        for j in range(min(len(result),
                           args.samples - bi * args.batch_size)):
            idx = bi * args.batch_size + j
            np.save(os.path.join(dirs["result"], f"{idx}.npy"), result[j])
            np.save(os.path.join(dirs["target"], f"{idx}.npy"),
                    batch["jpg"][j])
            np.save(os.path.join(dirs["input"], f"{idx}.npy"), inputs[j])
            written += 1
    print(f"process {rank}/{world}: wrote {written} conditional samples to "
          f"{args.out} on {device}")
    if covered < args.samples:
        print(f"warning: dataset exhausted at {covered} < requested "
              f"{args.samples} samples", file=sys.stderr)
    return written


if __name__ == "__main__":
    main()
