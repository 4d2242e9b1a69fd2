#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`rangeldm_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   - require CUDA; the card's name and power limit; TF32 off
  2. build    - compile every CUDA kernel from rangeldm_tpu_torch/csrc/
  3. kernels  - each kernel against its plain PyTorch version at the
                flagship shapes (batch 4), f32 and bf16, with times, the
                bound and one PyTorch library call as a yardstick
  4. unet     - one flagship-width UNet forward (f32) through the kernel
                against the same UNet on the plain einsum path
  5. main     - a flagship pipeline directory with seeded random weights at
                full width, loaded with RangePipeline.from_pretrained and
                sampled with DDIM-50 and DPM-Solver++-20 in bf16, then
                to_point_clouds and the sampling CLI
Then the kernel summary line, the card line, and the result line. Any
failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # H100 SXM
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
UNET_TOL = 5e-4
BATCH = 4
SEED = 0
# (N = batch * heads, D, T) of the flagship UNet's attention layers at
# batch 4, with the number of such layers in one forward, plus one ragged
# case off the main path
FLAGSHIP_SHAPES = [((BATCH * 16, 8, 1024), 5), ((BATCH * 32, 8, 256), 5),
                   ((BATCH * 32, 8, 64), 6)]
RAGGED_SHAPE = (5, 8, 200)


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_work(shape, dtype) -> tuple:
    """(operations, bytes) of one call: 4 T^2 D flops per head; q, k, v
    read and out written once."""
    n, d, t = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 4.0 * t * t * d * n, 4.0 * n * d * t * itemsize


def bound(flops: float, nbytes: float, dtype) -> tuple:
    """Least time in ms, the larger of operations over the dtype's peak and
    bytes over the memory rate, and which of the two it is."""
    flop_ms = flops / PEAK_FLOPS[dtype] * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    return max(flop_ms, byte_ms), ("operations" if flop_ms >= byte_ms
                                   else "bytes")


def phase_device():
    require(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32="off (cudnn and matmul) for the f32 phases")
    return smi


def phase_build(kernels):
    t0 = time.perf_counter()
    reports = kernels.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in out.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, out in reports.items()}
    emit("build", seconds=round(seconds, 3), ptxas=ptxas)


def phase_kernels(attention):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for shape, layers in FLAGSHIP_SHAPES + [(RAGGED_SHAPE, 0)]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                                   dtype=dtype) for _ in range(3))
            scale = shape[1] ** -0.5
            got = attention.fused_attention_t(q, k, v, scale)
            want = attention.attention_t_reference(q, k, v, scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[dtype]
            ok = torch.allclose(got.float(), want.float(), rtol=tol,
                                atol=tol)
            qs, ks, vs = (u.transpose(1, 2) for u in (q, k, v))
            ms = cuda_ms(lambda: attention.fused_attention_t(q, k, v, scale),
                         20)
            plain_ms = cuda_ms(
                lambda: attention.attention_t_reference(q, k, v, scale), 5)
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                       scale=scale), 20)
            flops, nbytes = attention_work(shape, dtype)
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            row = dict(shape=list(shape), dtype=str(dtype).split(".")[1],
                       layers_per_unet_forward=layers, max_abs_err=err,
                       tol=tol, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by, flops=flops, bytes=nbytes)
            emit("kernels", kernel="attention_fwd", **row)
            require(ok, f"attention_fwd disagrees with its plain version at "
                        f"{shape} {dtype}: max abs err {err}")
            rows.append(row)
    return rows


def phase_unet(kernels, models):
    cfg = models.rangeldm_kitti360().unet
    torch.manual_seed(SEED)
    fused = models.UNet2D(cfg).cuda().eval()
    plain = models.UNet2D(dataclasses.replace(
        cfg, use_fused_attention=False)).cuda().eval()
    plain.load_state_dict(fused.state_dict())
    h, w = cfg.sample_size
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((BATCH, cfg.in_channels, w, h), generator=gen,
                    device="cuda")
    t = torch.tensor(500, device="cuda")
    with torch.inference_mode():
        kernels.reset_launches()
        got = fused(x, t)
        torch.cuda.synchronize()
        launches = kernels.LAUNCHES["attention_fwd"]
        want = plain(x, t)
    err = (got - want).abs().max().item()
    emit("unet", dtype="float32", batch=BATCH, latent=[h, w],
         max_abs_err=err, tol=UNET_TOL, launches=launches,
         out_absmax=want.abs().max().item())
    require(launches == 16, f"UNet forward launched attention_fwd "
                            f"{launches} times, expected 16")
    require(err <= UNET_TOL, f"UNet with the kernel differs from the "
                             f"einsum path by {err}")


def phase_main(kernels, models, smi):
    from rangeldm_tpu_torch.convert import save_diffusers_pipeline
    from rangeldm_tpu_torch.pipelines import RangePipeline
    from rangeldm_tpu_torch import sample_ldm

    spec = models.rangeldm_kitti360()
    torch.manual_seed(SEED)
    unet = models.UNet2D(spec.unet)
    vae = models.AutoencoderKL(spec.vae)
    sched = dataclasses.asdict(spec.schedule)
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pipeline")
        save_diffusers_pipeline(path, unet, vae, sched)
        pipe = RangePipeline.from_pretrained(path)
        require(pipe.device.type == "cuda", "pipeline is not on CUDA")
        require(next(pipe._p["unet"].parameters()).dtype == torch.bfloat16,
                "pipeline is not bf16 by default")
        pipe(batch_size=BATCH, num_inference_steps=2)       # warm-up

        rates = {}
        for method, steps in (("ddim", 50), ("dpmpp", 20)):
            kernels.reset_launches()
            t0 = time.perf_counter()
            images = pipe(batch_size=BATCH, num_inference_steps=steps,
                          method=method, seed=SEED)
            dt = time.perf_counter() - t0
            n = kernels.LAUNCHES["attention_fwd"]
            launches += n
            rates[method] = dict(steps=steps, seconds=dt,
                                 samples_per_s=BATCH / dt, launches=n)
            require(images.shape == (BATCH, 64, 1024, 2),
                    f"{method}: image shape {images.shape}")
            require(bool(np.isfinite(images).all()),
                    f"{method}: non-finite samples")
            require(n == 16 * steps, f"{method}: {n} kernel launches, "
                                     f"expected {16 * steps}")
        clouds = pipe.to_point_clouds(images)
        require(len(clouds) == BATCH and all(
            c.ndim == 2 and c.shape[1] == 4 and np.isfinite(c).all()
            for c in clouds), "bad point clouds")

        out = os.path.join(tmp, "samples")
        kernels.reset_launches()
        t0 = time.perf_counter()
        sample_ldm.main(["--pipeline", path, "--out", out, "--samples",
                         str(BATCH), "--batch_size", str(BATCH)])
        cli_s = time.perf_counter() - t0
        n = kernels.LAUNCHES["attention_fwd"]
        launches += n
        require(n == 16 * 50, f"sample_ldm.main: {n} kernel launches")
        files = sorted(os.listdir(out))
        want = sorted(f"{i}{s}" for i in range(BATCH)
                      for s in (".bin", "_bev.png", "_range.png"))
        require(files == want, f"sample_ldm.main wrote {files}")

        u, v = pipe._p["unet"], pipe._p["vae"]
        h, w = spec.unet.sample_size
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn((BATCH, spec.unet.in_channels, w, h), generator=gen,
                        device="cuda", dtype=torch.bfloat16)
        z = torch.randn((BATCH, spec.vae.z_channels, w, h), generator=gen,
                        device="cuda", dtype=torch.bfloat16)
        t = torch.tensor(500, device="cuda")
        with torch.inference_mode():
            unet_ms = cuda_ms(lambda: u(x, t), 10)
            vae_ms = cuda_ms(lambda: v.decode(z), 5)
    emit("main", dtype="bfloat16", batch=BATCH, card=smi, **rates,
         cloud_points=[int(c.shape[0]) for c in clouds],
         cli_seconds=cli_s, cli_files=len(files), unet_fwd_ms=unet_ms,
         vae_decode_ms=vae_ms)
    return launches


def summary(rows, launches):
    """One entry per kernel: time, plain time and library time summed over
    the attention layers of one flagship UNet forward in bf16 (the main
    path's dtype); the bound of that same work; and the largest
    disagreement with the plain version at those shapes."""
    main = [r for r in rows if r["dtype"] == "bfloat16"
            and r["layers_per_unet_forward"]]

    def total(key):
        return sum(r[key] * r["layers_per_unet_forward"] for r in main)

    bound_ms, bound_by = bound(total("flops"), total("bytes"),
                               torch.bfloat16)
    return {"kernels": [{
        "name": "attention_fwd", "route": "cuda",
        "source": "rangeldm_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "rangeldm_tpu/ops/attention.py:48",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": total("library_ms")}]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rangeldm_tpu_torch import models
    from rangeldm_tpu_torch.ops import attention, kernels

    smi = phase_device()
    phase_build(kernels)
    rows = phase_kernels(attention)
    phase_unet(kernels, models)
    launches = phase_main(kernels, models, smi)
    print(json.dumps(summary(rows, launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
