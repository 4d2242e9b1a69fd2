"""Sampling CLI (ldm/inference.py), over pipelines/pipeline.py.

    python -m rangeldm_tpu_torch.sample_ldm --pipeline <diffusers dir> \
        --samples 1000 --batch_size 32 --out samples/ [--device cuda]

Writes per sample `{i}.bin` (the point cloud, depth < 90 m,
ldm/inference.py:173-177), `{i}_bev.png` (BEV density) and `{i}_range.png`
(the range channel). Runs on CUDA unless `--device cpu` is given; without a
CUDA device and without that flag it stops with an error.

The work splits as the JAX package's does (rangeldm_tpu/sample_ldm.py:
262-278, 369-402): each batch over a local mesh of this process's cards
(`--mesh_devices auto`: as many as divide the batch), and the batches over
the processes of a torchrun launch (`python -m torch.distributed.run
--nproc_per_node N -m rangeldm_tpu_torch.sample_ldm ...`, one card each),
rank r taking batches r, r + N, ... Batch b's noise comes from (seed, b)
alone, so any split writes the files one process writes.
"""

from __future__ import annotations

import argparse
import dataclasses

from rangeldm_tpu_torch.diffusion.schedule import Schedule
from rangeldm_tpu_torch.geometry.sensors import get_spec
from rangeldm_tpu_torch.parallel.mesh import process_shard, resolve_device
from rangeldm_tpu_torch.pipelines.pipeline import (
    adapt_spec_to_model, apply_meta_normalization, batch_generator,
    build_sampler, load_diffusers_pipeline, pipe_image_size,
    resolve_sampling_mesh, save_outputs,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline", required=True)
    ap.add_argument("--out", default="samples")
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--method", default="ddim",
                    choices=["ddim", "ddpm", "dpmpp"],
                    help="dpmpp = DPM-Solver++(2M): try --steps 20")
    ap.add_argument("--eta", type=float, default=0.0,
                    help="DDIM stochasticity (the reference pipelines' eta)")
    ap.add_argument("--timestep_spacing", default=None,
                    choices=["leading", "trailing"],
                    help="override the pipeline's timestep spacing")
    ap.add_argument("--sensor", default=None,
                    help="back-projection geometry (default kitti360)")
    ap.add_argument("--seed", type=int, default=0)
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
    if args.timestep_spacing:
        pipe["schedule"] = Schedule(dataclasses.replace(
            pipe["schedule"].cfg, timestep_spacing=args.timestep_spacing))
    mesh = resolve_sampling_mesh(args.mesh_devices, args.batch_size, device)
    sample = build_sampler(pipe, args.batch_size, args.steps, args.method,
                           eta=args.eta, mesh=mesh)
    sensor = args.sensor or pipe["meta"].get("sensor", "kitti360")
    spec = apply_meta_normalization(
        adapt_spec_to_model(get_spec(sensor), pipe_image_size(pipe)),
        pipe["meta"])

    # the sample range split over the processes (ldm/inference.py:159, 174)
    rank, world = process_shard()
    written = 0
    for b in range(rank, -(-args.samples // args.batch_size), world):
        imgs = sample(batch_generator(device, args.seed, b))
        start = b * args.batch_size
        imgs = imgs[:max(0, min(args.batch_size, args.samples - start))]
        if len(imgs):
            save_outputs(imgs, spec, args.out, start)
            written += len(imgs)
    print(f"process {rank}/{world} (mesh of {len(mesh)} "
          f"devices): wrote {written} samples to {args.out} on {device}")
    return written


if __name__ == "__main__":
    main()
