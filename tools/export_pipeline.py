"""Export a JAX package pipeline directory (orbax) to the diffusers layout
that the PyTorch port reads.

    python tools/export_pipeline.py <orbax_pipeline_dir> <out_dir> [--no-ema]

Needs JAX (the JAX package, `rangeldm_tpu`) on the machine that runs it;
the port itself never imports JAX. The tool loads the `unet`, the
`unet_ema` (unless --no-ema, or where the pipeline has none) and the `vae`
of a directory written by `rangeldm_tpu.training.checkpoint.save_pipeline`
in float32, carries their weights across with the port's converters
(`rangeldm_tpu_torch.convert.unet_state_dict_from_jax` /
`vae_state_dict_from_jax`) and writes {unet, unet_ema, vae, scheduler}/
with `convert.save_diffusers_pipeline`, the schedule and the run record of
model_index.json (`convert.RECORD_KEYS`) included.

The diffusers config files hold fewer fields than the JAX configs. The tool
writes into `<out_dir>.tmp`, reads the configs back with the port's own
loaders, and refuses, naming each field, a JAX `UNetConfig` or `VaeConfig`
value that the port would not restore (a relu VAE, a non-circular one,
coordconv, ...): it never leaves a pipeline that would decode differently.
Only then is `<out_dir>.tmp` renamed to `<out_dir>`. Training checkpoints
(`checkpoint_<step>/`) are not exported: their JAX PRNG key has no
`torch.Generator` counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys

# run from anywhere: the repo root is this file's parent directory
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The attention implementation switch: the same math either way, and the
# port sends every attention layer through its own kernel.
IGNORED_FIELDS = {"use_fused_attention"}


def unrestored_fields(jax_cfg, port_cfg) -> list:
    """Names of the fields of a JAX config whose value the port's config,
    as its loader restores it, does not hold."""
    return [f.name for f in dataclasses.fields(jax_cfg)
            if f.name not in IGNORED_FIELDS
            and getattr(jax_cfg, f.name) != getattr(port_cfg, f.name, None)]


def export_pipeline(src: str, out: str, use_ema: bool = True) -> str:
    """Export the orbax pipeline directory `src` to the diffusers-layout
    directory `out`, which must not exist yet; returns `out`. Raises
    ValueError naming the config fields the layout cannot hold, and writes
    nothing then."""
    import jax.numpy as jnp
    from rangeldm_tpu.sample_ldm import is_diffusers_pipeline, load_pipeline
    from rangeldm_tpu.training.checkpoint import load_pipeline_component

    from rangeldm_tpu_torch.convert import (
        RECORD_KEYS, load_diffusers_unet, load_diffusers_vae,
        save_diffusers_pipeline, unet_state_dict_from_jax,
        vae_state_dict_from_jax,
    )
    from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig
    from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig

    if os.path.exists(out):
        raise ValueError(f"{out} exists; the tool writes a new directory")
    if not os.path.exists(os.path.join(src, "model_index.json")):
        raise ValueError(f"{src} is not a pipeline directory of the JAX "
                         f"package (no model_index.json)")
    if is_diffusers_pipeline(src):
        raise ValueError(f"{src} is already in the diffusers layout; the "
                         f"port reads it as it is")
    pipe = load_pipeline(src, dtype=jnp.float32, use_ema=False)

    def port_config(jax_cfg, cls):
        return cls(**{f.name: getattr(jax_cfg, f.name)
                      for f in dataclasses.fields(cls)})

    unet = UNet2D(port_config(pipe["unet_cfg"], UNetConfig))
    unet.load_state_dict(unet_state_dict_from_jax(
        pipe["unet_params"]["params"]), strict=True)
    ema = None
    if use_ema and os.path.isdir(os.path.join(src, "unet_ema")):
        ema = unet_state_dict_from_jax(load_pipeline_component(
            src, "unet_ema", pipe["unet_params"]["params"]))
    vae = None
    if pipe["vae"] is not None:
        vae = AutoencoderKL(port_config(pipe["vae_cfg"], VaeConfig))
        vae.load_state_dict(vae_state_dict_from_jax(
            pipe["vae_params"]["params"]), strict=True)

    meta = pipe["meta"]
    tmp = os.path.abspath(out) + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    save_diffusers_pipeline(
        tmp, unet, vae, schedule=meta.get("schedule"), unet_ema=ema,
        record={k: meta[k] for k in RECORD_KEYS if k in meta})
    bad = {f"unet.{name}": getattr(pipe["unet_cfg"], name)
           for name in unrestored_fields(pipe["unet_cfg"], load_diffusers_unet(
               os.path.join(tmp, "unet"))[0])}
    if vae is not None:
        bad.update({f"vae.{name}": getattr(pipe["vae_cfg"], name)
                    for name in unrestored_fields(
                        pipe["vae_cfg"],
                        load_diffusers_vae(os.path.join(tmp, "vae"))[0])})
    if bad:
        shutil.rmtree(tmp)
        raise ValueError(
            f"{src}: the diffusers layout the port reads cannot hold "
            + ", ".join(f"{k}={v!r}" for k, v in bad.items())
            + "; nothing was exported")
    os.replace(tmp, out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="pipeline directory written by the JAX "
                                "package (orbax)")
    ap.add_argument("out", help="diffusers-layout directory to write")
    ap.add_argument("--no-ema", action="store_true",
                    help="leave out unet_ema/")
    args = ap.parse_args(argv)
    from rangeldm_tpu.utils.cache import honor_jax_platforms_env
    honor_jax_platforms_env()
    try:
        export_pipeline(args.src, args.out, use_ema=not args.no_ema)
    except ValueError as e:
        print(f"export_pipeline: {e}", file=sys.stderr)
        return 2
    print(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
