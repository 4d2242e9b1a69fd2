"""VAE reconstruction scores on held-out scans (the JAX package's
rangeldm_tpu/eval_vae.py, after ldm/convert_vae.py:193-271): MAE and PSNR
of the range (in units of the fill range) and intensity channels, and the
symmetric chamfer distance between the back-projected clouds, points
nearer than 70 m.

    python -m rangeldm_tpu_torch.eval_vae --vae runs/vae_kitti360/vae_sgm.safetensors \
        --data $KITTI360_DATASET --count 1000 [--device cpu]

`--vae` is anything `train_ldm.load_vae` reads: an sgm `.ckpt`, the VAE
trainer's `vae_sgm.safetensors` / `vae_sgm_ema.safetensors`, or a
diffusers-layout VAE or pipeline directory.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Iterable, Optional

import torch

from rangeldm_tpu_torch.data.datasets import (
    DatasetConfig, RangeImageDataset, RangeLoader,
)
from rangeldm_tpu_torch.geometry import to_point_cloud
from rangeldm_tpu_torch.metrics.chamfer import chamfer_distance
from rangeldm_tpu_torch.models.vae import AutoencoderKL
from rangeldm_tpu_torch.pipelines.samplers import to_bcwh, to_bhwc
from rangeldm_tpu_torch.sample_ldm import resolve_device
from rangeldm_tpu_torch.train_ldm import load_vae

MAX_RANGE = 70.0      # metres: the chamfer distance's points


@torch.no_grad()
def evaluate(vae: AutoencoderKL, batches, spec, count: int = 1000,
             sample_posterior: bool = True, seed: int = 0,
             noise: Optional[Iterable[torch.Tensor]] = None) -> dict:
    """Mean MAE, PSNR and chamfer distance over the first `count` scans of
    `batches` ({'jpg': (B, H, W, C)} or arrays), reconstructed on the
    VAE's device. The posterior draws come from a generator seeded with
    `seed`, or from `noise`, one (B, Z, W/f, H/f) draw per batch."""
    device = next(vae.parameters()).device
    gen = torch.Generator(device).manual_seed(seed)
    draws = iter(noise) if noise is not None else None
    mae = psnr = cd = 0.0
    seen = 0

    def to_unit(v):
        r = (v[..., 0] * spec.std + spec.mean) / spec.range_fill
        return torch.stack([r, v[..., 1]], dim=-1)

    for batch in batches:
        x = torch.as_tensor(batch["jpg"] if isinstance(batch, dict)
                            else batch).to(device, torch.float32)
        eps = None if draws is None else next(draws).to(device)
        xrec, _, _ = vae(to_bcwh(x), generator=gen, noise=eps,
                         sample_posterior=sample_posterior)
        xrec = to_bhwc(xrec.float())
        take = min(x.shape[0], count - seen)
        xu, ru = to_unit(x), to_unit(xrec)
        err = torch.mean(torch.abs(xu - ru), dim=(1, 2, 3))[:take]
        mse = torch.mean((xu - ru) ** 2, dim=(1, 2, 3))[:take]
        mae += float(err.sum())
        psnr += float(torch.sum(10 * torch.log10(
            1.0 / torch.clamp(mse, min=1e-12))))
        pc_in, pc_out = to_point_cloud(x, spec), to_point_cloud(xrec, spec)
        for j in range(take):
            a, b = pc_in[j, :, :3], pc_out[j, :, :3]
            cd += float(chamfer_distance(
                a, b, torch.linalg.vector_norm(a, dim=1) < MAX_RANGE,
                torch.linalg.vector_norm(b, dim=1) < MAX_RANGE))
        seen += take
        if seen >= count:
            break
    if seen == 0:
        raise SystemExit("no held-out eval scans found (check --data: the "
                         "eval split is drives 0000/0002)")
    return {"mae": mae / seen, "psnr": psnr / seen, "chamfer": cd / seen,
            "count": seen}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Score a range-image VAE's reconstructions of held-out "
                    "scans (MAE, PSNR, chamfer).")
    ap.add_argument("--vae", required=True)
    ap.add_argument("--data", default=os.environ.get("KITTI360_DATASET", ""))
    ap.add_argument("--sensor", default="kitti360")
    ap.add_argument("--count", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "must be asked for)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    vae = load_vae(args.vae).to(device).eval()
    ds = RangeImageDataset(DatasetConfig(root=args.data, sensor=args.sensor),
                           train=False)
    loader = RangeLoader(ds, batch_size=args.batch_size)
    out = evaluate(vae, loader, ds.spec, count=args.count)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
