"""One-command released-weight parity gate.

    python -m rangeldm_tpu_torch.parity_gate --weights <pipeline_dir> \
        --data <dataset_root> [--rangenet <darknet53-1024 dir>] [--device cpu]

Runs the whole release check and prints PASS/FAIL:

  1. load - the weights through the diffusers-layout loader
     (`pipelines.pipeline.load_diffusers_pipeline`);
  2. stage report - VAE encode/decode round trip on held-out scans
     (recon MAE/PSNR, scaled-latent stats) and a UNet forward sanity check;
  3. sample - 50-step DDIM generation, back-projected to point-cloud .bin
     dumps (ldm/inference.py:159-183);
  4. score - MMD + JSD against the held-out reference split (and FRD when
     --rangenet is given), the `evaluate` metric path;
  5. gate - compare MMD/JSD against the published README numbers for the
     detected model within --tolerance (default 5%). Better than
     published always passes. Exit code 0 = PASS, 1 = FAIL, 2 = error.

Prints one JSON report line (and writes it to <out>/parity_report.json).
Runs on the CUDA device unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from rangeldm_tpu_torch.parallel.mesh import resolve_device
from rangeldm_tpu_torch.pipelines.pipeline import (
    adapt_spec_to_model, apply_meta_normalization, batch_generator,
    build_sampler, is_diffusers_pipeline, load_diffusers_pipeline,
    pipe_image_size, pipe_pos_encoding, resolve_sampling_mesh, save_outputs,
)

# Published numbers: the reference README's rows for RangeLDM KITTI-360,
# RangeDM KITTI-360 and RangeLDM nuScenes. FRD rows are report-only unless
# --gate_frd.
PUBLISHED = {
    "rangeldm_kitti360": {"mmd": 3.07e-5, "jsd": 0.045, "frd": 1074.9},
    "rangedm_kitti360": {"mmd": 4.14e-5, "jsd": 0.040, "frd": 899.0},
    "rangeldm_nuscenes": {"mmd": 1.9e-4, "jsd": 0.054},
}


def load_gate_pipeline(path: str, dtype: torch.dtype, device) -> dict:
    """A released (diffusers-layout) pipeline directory. A native orbax
    pipeline directory of the JAX package is refused by name, with the tool
    that exports it."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"--weights {path}: no such directory")
    if not is_diffusers_pipeline(path):
        raise ValueError(
            f"--weights {path} is not a diffusers-layout pipeline directory "
            f"(unet/diffusion_pytorch_model.*); a native orbax pipeline "
            f"directory written by the JAX package is read after "
            f"`python tools/export_pipeline.py {path} <out_dir>` on a "
            f"machine with JAX")
    return load_diffusers_pipeline(path, dtype=dtype, device=device)


def detect_target(pipe) -> str:
    """Which released model a loaded pipeline is, from its own
    architecture: no VAE -> the pixel-space RangeDM (the only released
    pixel model; family beats beam count), a 32-beam image -> the nuScenes
    RangeLDM, else the flagship KITTI-360 RangeLDM. --target overrides."""
    if pipe["vae"] is None:
        return "rangedm_kitti360"
    h, _ = pipe_image_size(pipe)
    return "rangeldm_nuscenes" if h == 32 else "rangeldm_kitti360"


@torch.inference_mode()
def vae_stage_report(pipe, scans, spec) -> Dict[str, float]:
    """Encode/decode round trip on real held-out scans: recon MAE in
    meters via the spec's normalization, PSNR, and scaled-latent stats (a
    converted VAE whose latents are far from unit scale would poison the
    UNet)."""
    from rangeldm_tpu_torch.geometry.projection import range_image_np
    from rangeldm_tpu_torch.models.vae import gaussian_mode
    from rangeldm_tpu_torch.pipelines.samplers import to_bcwh, to_bhwc

    vae, cfg = pipe["vae"], pipe["vae_cfg"]
    imgs = np.stack([range_image_np(s, spec)[0][..., :cfg.in_channels]
                     for s in scans])
    x = to_bcwh(torch.from_numpy(imgs).to(pipe["device"], pipe["dtype"]))
    z = gaussian_mode(vae.encode_moments(x))
    rec = to_bhwc(vae.decode(z)).float().cpu().numpy()
    z = (z * cfg.scaling_factor).float().cpu().numpy()
    err = rec[..., 0] - imgs[..., 0]
    mae_m = float(np.abs(err).mean() * spec.std)     # meters
    mse = float(np.mean(np.square(rec - imgs)))
    psnr = float(10 * np.log10(4.0 / max(mse, 1e-12)))  # range ~[-1, 1]
    return {"recon_mae_m": mae_m, "recon_psnr": psnr,
            "latent_mean": float(z.mean()), "latent_std": float(z.std()),
            "n_scans": int(len(scans))}


@torch.inference_mode()
def unet_stage_report(pipe) -> Dict[str, float]:
    """One UNet forward at mid-schedule on unit noise: finite and
    reasonably scaled output is the converted-weights sanity signal."""
    from rangeldm_tpu_torch.pipelines.samplers import make_pos_encoding

    cfg, dev, dtype = pipe["unet_cfg"], pipe["device"], pipe["dtype"]
    h, w = cfg.sample_size
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, cfg.out_channels, w, h), generator=gen, device=dev,
                    dtype=dtype)
    extra = cfg.in_channels - cfg.out_channels
    if pipe_pos_encoding(pipe) and extra == 1:
        x = torch.cat([x, make_pos_encoding(1, h, w, dtype, dev)], dim=1)
    elif extra > 0:
        x = torch.cat([x, torch.zeros((1, extra, w, h), dtype=dtype,
                                      device=dev)], dim=1)
    t = torch.full((1,), 500, dtype=torch.long, device=dev)
    eps = pipe["unet"](x, t).float().cpu().numpy()
    return {"eps_std": float(eps.std()), "eps_mean": float(eps.mean()),
            "finite": bool(np.isfinite(eps).all())}


def generate_samples(pipe, out_dir: str, spec, n_samples: int,
                     batch_size: int, steps: int, seed: int,
                     mesh_devices: str = "auto") -> int:
    """DDIM samples written as {i}.bin clouds; batch b draws from
    `batch_generator(seed, b)`, each batch split over the local mesh
    `mesh_devices` names (`resolve_sampling_mesh`)."""
    mesh = resolve_sampling_mesh(mesh_devices, batch_size, pipe["device"])
    sample = build_sampler(pipe, batch_size, steps, "ddim", mesh=mesh)
    written = 0
    for b in range(-(-n_samples // batch_size)):
        imgs = sample(batch_generator(pipe["device"], seed, b))
        start = b * batch_size
        imgs = imgs[:max(0, min(batch_size, n_samples - start))]
        save_outputs(imgs, spec, out_dir, start, write_png=False)
        written += len(imgs)
    return written


def score_samples(out_dir: str, data_root: str, nus: bool, limit: int,
                  rangenet: Optional[str], device=None) -> Dict[str, float]:
    from rangeldm_tpu_torch.evaluate import (
        histograms, kitti_reference_files, nuscenes_reference_files,
    )
    from rangeldm_tpu_torch.metrics.frd_pipeline import (
        compute_frd_for_dirs, generated_sample_files,
    )
    from rangeldm_tpu_torch.metrics.histogram import (
        kitti_histogram, nuscenes_histogram,
    )
    from rangeldm_tpu_torch.metrics.jsd import compute_jsd
    from rangeldm_tpu_torch.metrics.mmd import compute_mmd

    try:
        sample_files = generated_sample_files(out_dir, limit)
    except FileNotFoundError:
        raise RuntimeError(
            f"no generated .bin samples in {out_dir}: sampling wrote "
            f"nothing, or --skip_sampling pointed --out at the wrong dir")
    hist_fn = nuscenes_histogram if nus else kitti_histogram
    ref_files = (nuscenes_reference_files if nus else kitti_reference_files)(
        len(sample_files), root=data_root)
    if not ref_files:
        raise RuntimeError(f"no held-out reference scans under {data_root}")
    gen_h = histograms(sample_files, hist_fn)
    ref_h = histograms(ref_files, hist_fn, 5 if nus else 4)
    out = {"mmd": compute_mmd(ref_h, gen_h), "jsd": compute_jsd(ref_h, gen_h),
           "n_gen": len(sample_files), "n_ref": len(ref_files)}
    if rangenet and not nus:
        out["frd"] = compute_frd_for_dirs(
            out_dir, kitti_reference_files(limit, root=data_root), rangenet,
            limit=limit, device=device)
    return out


def main(argv=None):
    """Keeps the exit-code contract: 0 PASS, 1 FAIL, 2 error. An uncaught
    exception (a wrong --weights path, a missing data root, a crash
    mid-sampling) exits 2, not the interpreter's default 1, so a release
    check does not record an infrastructure error as failed parity."""
    try:
        return _main(argv)
    except SystemExit:
        raise
    except BaseException as e:
        import traceback
        traceback.print_exc()
        print(json.dumps({"pass": None, "error": f"{type(e).__name__}: {e}"}))
        return 2


def _main(argv=None):
    from rangeldm_tpu_torch.evaluate import (
        kitti_reference_files, load_bin, nuscenes_reference_files,
    )
    from rangeldm_tpu_torch.geometry.sensors import get_spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights", required=True,
                    help="released pipeline dir (diffusers layout)")
    ap.add_argument("--data", required=True,
                    help="KITTI-360 (or nuScenes) dataset root; the "
                         "held-out split is the reference distribution")
    ap.add_argument("--target", default="auto",
                    choices=["auto", *PUBLISHED],
                    help="which README row to gate against (auto-detected "
                         "from the loaded pipeline's shape)")
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="sample/report dir (default <weights>/parity_gate)")
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="allowed fractional excess over the published "
                         "MMD/JSD (within 5%%)")
    ap.add_argument("--rangenet", default=None,
                    help="darknet53-1024 dir: also compute FRD")
    ap.add_argument("--gate_frd", action="store_true",
                    help="include FRD in the PASS criterion (needs "
                         "--rangenet)")
    ap.add_argument("--mmd_target", type=float, default=None,
                    help="override the published MMD target")
    ap.add_argument("--jsd_target", type=float, default=None,
                    help="override the published JSD target")
    ap.add_argument("--frd_target", type=float, default=None,
                    help="override the published FRD target (used with "
                         "--gate_frd)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "must be asked for)")
    ap.add_argument("--mesh_devices", default="auto",
                    help="local devices to split each sample batch over: "
                         "'auto' (as many as divide the batch), an integer, "
                         "or 1 for none")
    ap.add_argument("--fp32", action="store_true",
                    help="sample in float32 instead of bfloat16")
    ap.add_argument("--skip_sampling", action="store_true",
                    help="score an existing --out dir (re-gate without "
                         "regenerating)")
    args = ap.parse_args(argv)
    if args.gate_frd and not args.rangenet:
        ap.error("--gate_frd needs --rangenet (the FRD criterion cannot "
                 "be evaluated without the darknet53 checkpoint)")

    device = resolve_device(args.device)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    out_dir = args.out or os.path.join(args.weights, "parity_gate")
    report: Dict = {"weights": args.weights, "data": args.data}

    # 1. load
    pipe = load_gate_pipeline(args.weights, dtype, device)
    os.makedirs(out_dir, exist_ok=True)
    target = args.target if args.target != "auto" else detect_target(pipe)
    nus = target == "rangeldm_nuscenes"
    report["target"] = target
    report["pipeline"] = {
        "source": pipe["meta"].get("source"),
        "unet": dataclasses.asdict(pipe["unet_cfg"]),
        "vae": (dataclasses.asdict(pipe["vae_cfg"]) if pipe["vae_cfg"]
                else None),
    }
    img_hw = pipe_image_size(pipe)
    report["image_size"] = list(img_hw)
    spec = apply_meta_normalization(adapt_spec_to_model(
        get_spec("nuscenes" if nus else "kitti360"), img_hw), pipe["meta"])

    # 2. per-stage numeric report
    ref_fn = nuscenes_reference_files if nus else kitti_reference_files
    if pipe["vae"] is not None:
        scan_files = ref_fn(4, root=args.data)
        scans = [load_bin(f, 5 if nus else 4) for f in scan_files]
        if nus:
            for s in scans:
                s[:, 3] /= 255.0   # ldm/nuscenes_range_image.py:78
        report["vae_stage"] = vae_stage_report(pipe, scans, spec)
        print(f"[gate] vae: {report['vae_stage']}", file=sys.stderr)
    report["unet_stage"] = unet_stage_report(pipe)
    print(f"[gate] unet: {report['unet_stage']}", file=sys.stderr)
    if not report["unet_stage"]["finite"]:
        report["pass"] = False
        report["error"] = "UNet forward produced non-finite output"
        print(json.dumps(report))
        return _finish(report, out_dir, 2)

    # 3. sample
    if not args.skip_sampling:
        n = generate_samples(pipe, out_dir, spec, args.samples,
                             args.batch_size, args.steps, args.seed,
                             args.mesh_devices)
        print(f"[gate] wrote {n} samples to {out_dir}", file=sys.stderr)
        report["n_sampled"] = n

    # 4. score
    scores = score_samples(out_dir, args.data, nus, args.samples,
                           args.rangenet, device)
    report["scores"] = scores

    # 5. gate
    targets = dict(PUBLISHED[target])
    if args.mmd_target is not None:
        targets["mmd"] = args.mmd_target
    if args.jsd_target is not None:
        targets["jsd"] = args.jsd_target
    if args.frd_target is not None:
        targets["frd"] = args.frd_target
    gated = ["mmd", "jsd"] + (["frd"] if args.gate_frd else [])
    checks = {}
    for k in gated:
        if k not in targets or k not in scores:
            continue
        bound = targets[k] * (1.0 + args.tolerance)
        checks[k] = {"score": scores[k], "published": targets[k],
                     "bound": bound, "ok": bool(scores[k] <= bound)}
    report["checks"] = checks
    report["tolerance"] = args.tolerance
    ok = bool(checks) and all(c["ok"] for c in checks.values())
    report["pass"] = ok

    print(json.dumps(report))
    return _finish(report, out_dir, 0 if ok else 1)


def _finish(report: Dict, out_dir: str, code: int) -> int:
    with open(os.path.join(out_dir, "parity_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    return code


if __name__ == "__main__":
    raise SystemExit(main())
