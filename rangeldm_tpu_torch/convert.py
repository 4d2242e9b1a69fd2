"""Weights in and out of the package.

* `read_safetensors` / `write_safetensors`: a small reader and writer of the
  safetensors format (an 8-byte little-endian header length, a JSON header,
  then the raw little-endian tensors), so no extra package is needed.
* `unet_state_dict_from_jax` / `vae_state_dict_from_jax`: the JAX package's
  params trees (numpy leaves) -> this package's state dicts, following the
  key grammar of rangeldm_tpu/convert/export.py;
  `sliced_state_dict_from_jax` / `experimental_state_dict_from_jax`: the
  research modules (models/sliced.py, models/experimental.py);
  `rangenet_state_dicts_from_jax`: the JAX RangeNet's variables -> the
  released RangeNet++ state dicts; `vae_gan_state_from_jax`: the JAX VAE
  trainer's state -> the VAE's, the discriminator's and the EMA's state
  dicts.
* sgm VAE checkpoints (Lightning `.ckpt`, or `.safetensors` in the sgm
  grammar): `load_sgm_vae`.
* The released diffusers pipeline layout ({unet, unet_ema, vae,
  scheduler}/, ldm/train_unconditional.py:654-682): `load_diffusers_unet`,
  `load_diffusers_vae` (diffusers VAE keys -> sgm keys) and
  `save_diffusers_pipeline`, which writes such a directory.
* `load_vae`: any VAE artifact the first stage hands to the second, an sgm
  file or a diffusers-layout directory.

Layouts: a JAX conv kernel is HWIO (k_beam, k_azimuth, I, O) and the torch
weight (O, I, k_azimuth, k_beam), the same permutation both ways; a JAX
Dense kernel is (I, O), the torch Linear weight (O, I).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import re
import struct
import sys
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from rangeldm_tpu_torch.metrics.rangenet import BLOCKS_53 as RANGENET_BLOCKS
from rangeldm_tpu_torch.models.unet import UNetConfig
from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig

StateDict = Dict[str, torch.Tensor]
# the run record a trainer writes into model_index.json
# (rangeldm_tpu/train_ldm.py:496-527); the loader reads these keys only,
# since a diffusers model_index.json holds other ones
RECORD_KEYS = ("model", "pos_encoding", "image_size", "sensor",
               "normalization")

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

def read_safetensors(path: str) -> StateDict:
    """All tensors of a .safetensors file, on the CPU."""
    if sys.byteorder != "little":
        raise RuntimeError("the safetensors reader assumes a little-endian "
                           "host")
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end > len(buf) or (end - start) % itemsize:
            raise ValueError(f"{path}: bad data offsets for {name}")
        flat = (torch.frombuffer(buf, dtype=dtype, count=(end - start)
                                 // itemsize, offset=start)
                if end > start else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def write_safetensors(tensors: StateDict, path: str) -> None:
    """Write tensors (any device) to a .safetensors file."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for data in blobs:
            f.write(data)


def load_torch_state_dict(path: str) -> StateDict:
    """A .safetensors file, or a torch pickle (.bin, .ckpt, .pth) read with
    weights_only=True. A Lightning checkpoint's {"state_dict": ...} wrapper
    is unwrapped (rangeldm_tpu/convert/torch_common.py:51-53). A pickle
    holding a global that weights_only refuses raises ValueError naming
    the file and the global; it is never read with weights_only=False."""
    if str(path).endswith(".safetensors"):
        return read_safetensors(path)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        found = re.search(r"GLOBAL (\S+)", str(e))
        raise ValueError(
            f"{path}: torch.load(weights_only=True) refused "
            f"{found.group(1) if found else 'a global'} (this package never "
            f"unpickles arbitrary objects; save the state dict alone, or "
            f"re-save the checkpoint as .safetensors)") from e
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


# ---------------------------------------------------------------------------
# JAX params trees -> state dicts
# ---------------------------------------------------------------------------

# JAX kernel -> torch weight: Dense (I, O); a sliced conv's grouped 1D
# kernel (k, I/groups, O); a conv HWIO (k_beam, k_azimuth, I, O); PerRowConv's
# (rows, k_beam, k_azimuth, I, O) -> (rows, O, I, k_azimuth, k_beam)
_KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 1, 0), 5: (0, 4, 3, 2, 1)}


def _flatten(tree: Dict, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _from_jax(params: Dict, rename) -> StateDict:
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, leaf in _flatten(params):
        *mods, leaf_name = path
        key = rename(".".join(mods))
        prefix = key + "." if key else ""
        if leaf_name == "kernel":
            w = leaf.transpose(_KERNEL_AXES[leaf.ndim])
            out[prefix + "weight"] = torch.from_numpy(np.array(w, order="C"))
        elif leaf_name in ("scale", "bias"):
            suffix = "weight" if leaf_name == "scale" else "bias"
            out[prefix + suffix] = torch.from_numpy(leaf.copy())
        else:
            raise ValueError(f"unexpected leaf {'/'.join(path)}")
    return out


def _unet_key(key: str) -> str:
    key = key.replace("time_embedding_linear_", "time_embedding.linear_")
    return re.sub(r"(down_blocks|up_blocks|resnets|attentions|downsamplers|"
                  r"upsamplers|to_out)_(\d+)", r"\1.\2", key)


def _vae_key(key: str) -> str:
    key = re.sub(r"(down|up)_(\d+)_(block|attn)_(\d+)", r"\1.\2.\3.\4", key)
    key = re.sub(r"(down|up)_(\d+)_(downsample|upsample)", r"\1.\2.\3", key)
    return re.sub(r"mid_(block_1|block_2|attn_1)", r"mid.\1", key)


def unet_state_dict_from_jax(params: Dict) -> StateDict:
    """The JAX UNet2D params tree -> this package's UNet2D state dict."""
    return _from_jax(params, _unet_key)


def vae_state_dict_from_jax(params: Dict) -> StateDict:
    """The JAX AutoencoderKL params tree -> this package's state dict."""
    return _from_jax(params, _vae_key)


def sliced_state_dict_from_jax(params: Dict) -> StateDict:
    """The JAX SlicedEncoder / SlicedDecoder params tree -> the state dict
    of models/sliced.py: the sgm key grammar, and each sliced conv's kernel
    as its Conv1d's weight under `.conv`."""
    if set(params) == {"params"}:
        params = params["params"]
    sliced = {".".join(path[:-1]) for path, leaf in _flatten(params)
              if path[-1] == "kernel" and leaf.ndim == 3}
    return _from_jax(params, lambda key: (
        f"{_vae_key(key)}.conv".lstrip(".") if key in sliced
        else _vae_key(key)))


def experimental_state_dict_from_jax(params: Dict) -> StateDict:
    """The params tree of a JAX module of models/experimental.py -> the
    port's state dict (EdgeConv's mlp_0 / mlp_2 -> mlp.0 / mlp.2)."""
    return _from_jax(params, lambda key: re.sub(r"mlp_(\d+)", r"mlp.\1",
                                                key))


def _disc_key(key: str) -> str:
    return re.sub(r"(main|mlp_coord)_(\d+)", r"\1.\2", key)


def disc_state_dict_from_jax(params: Dict, batch_stats: Dict) -> StateDict:
    """A JAX discriminator's params and batch_stats -> this package's
    discriminator state dict (models/discriminator.py): main_{i} ->
    main.{i}, mlp_coord_{j} -> mlp_coord.{j}, BatchNorm mean/var ->
    running_mean/running_var."""
    out = _from_jax(params, _disc_key)
    for path, leaf in _flatten(batch_stats):
        *mods, name = path
        key = _disc_key(".".join(mods))
        out[f"{key}.running_{name}"] = torch.from_numpy(leaf.copy())
        out[f"{key}.num_batches_tracked"] = torch.tensor(0)
    return out


def _numpy_tree(t) -> Dict:
    """A nested mapping (dict or FrozenDict) with array leaves -> nested
    dicts of float32 numpy arrays."""
    if hasattr(t, "items"):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return np.asarray(t, np.float32)


def vae_gan_state_from_jax(state) -> Dict:
    """A JAX `VaeGanState` (rangeldm_tpu/training/vae_trainer.py:61-69,
    numpy or array leaves) -> {"vae", "disc", "ema"} state dicts of this
    package's AutoencoderKL and discriminator, and "logvar" (a 0-dim
    tensor)."""
    def tree(t):
        return {} if t is None else _numpy_tree(t)

    gen = tree(state.gen_params)
    return {"vae": vae_state_dict_from_jax(gen["vae"]),
            "logvar": torch.tensor(float(np.asarray(gen["logvar"]))),
            "disc": disc_state_dict_from_jax(tree(state.disc_params),
                                             tree(state.disc_batch_stats)),
            "ema": vae_state_dict_from_jax(tree(state.ema_params))}


def _rangenet_tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def rangenet_state_dicts_from_jax(variables: Dict):
    """The JAX RangeNet's variables ({"params", "batch_stats"}, numpy or
    array leaves) -> (backbone, decoder, head) state dicts in the released
    lidar-bonnetal grammar, the inverse of the JAX package's
    `convert_rangenet_state_dict` (rangeldm_tpu/metrics/rangenet.py:
    198-257). Conv kernels go HWIO -> OIHW, the upconv (1, 4, in, out) ->
    (in, out, 1, 4), BatchNorm scale/bias/mean/var -> weight/bias/
    running_mean/running_var. The decoder's and head's dicts are None when
    the variables have none."""
    params, stats = variables["params"], variables.get("batch_stats", {})

    def node(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def conv(sd, key, path):
        sd[key + ".weight"] = _rangenet_tensor(
            np.transpose(node(params, path + ("kernel",)), (3, 2, 0, 1)))

    def bn(sd, key, path):
        p, s = node(params, path), node(stats, path)
        sd[key + ".weight"] = _rangenet_tensor(p["scale"])
        sd[key + ".bias"] = _rangenet_tensor(p["bias"])
        sd[key + ".running_mean"] = _rangenet_tensor(s["mean"])
        sd[key + ".running_var"] = _rangenet_tensor(s["var"])
        sd[key + ".num_batches_tracked"] = torch.tensor(0)

    def block(sd, key, path):
        for i in (1, 2):
            conv(sd, f"{key}.conv{i}", path + (f"c{i}", "conv"))
            bn(sd, f"{key}.bn{i}", path + (f"c{i}", "bn"))

    backbone: StateDict = {}
    conv(backbone, "conv1", ("backbone", "conv1", "conv"))
    bn(backbone, "bn1", ("backbone", "conv1", "bn"))
    for stage, nblocks in enumerate(RANGENET_BLOCKS, start=1):
        pre = f"enc{stage}"
        conv(backbone, f"{pre}.conv", ("backbone", f"{pre}_conv", "conv"))
        bn(backbone, f"{pre}.bn", ("backbone", f"{pre}_conv", "bn"))
        for b in range(nblocks):
            block(backbone, f"{pre}.residual_{b}",
                  ("backbone", f"{pre}_res{b}"))

    decoder: Optional[StateDict] = None
    if "dec5" in params:
        decoder = {}
        for s in range(len(RANGENET_BLOCKS), 0, -1):
            dec = f"dec{s}"
            up = params[dec]["upconv"]
            decoder[f"{dec}.upconv.weight"] = _rangenet_tensor(
                np.transpose(up["kernel"], (2, 3, 0, 1)))
            decoder[f"{dec}.upconv.bias"] = _rangenet_tensor(up["bias"])
            bn(decoder, f"{dec}.bn", (dec, "bn"))
            block(decoder, f"{dec}.residual", (dec, "residual"))

    head: Optional[StateDict] = None
    if "head_conv" in params:
        head = {}
        conv(head, "1", ("head_conv",))
        head["1.bias"] = _rangenet_tensor(params["head_conv"]["bias"])
    return backbone, decoder, head


# ---------------------------------------------------------------------------
# sgm VAE checkpoints (rangeldm_tpu/convert/sgm_vae.py)
# ---------------------------------------------------------------------------

def sgm_vae_state_dict(sd: StateDict) -> StateDict:
    """An sgm AutoencodingEngine state dict (a Lightning checkpoint's,
    already unwrapped) -> this package's VAE state dict: the
    `first_stage_model.` prefix of an LDM checkpoint stripped, the `loss.*`
    subtree (discriminator, LPIPS, logvar), the `model_ema.*` shadow and
    the quant convs (the RangeLDM VAEs have none, ldm/inference.py:90-92)
    left out, as the JAX package's converter does (sgm_vae.py:53-55).
    The key grammar is already this package's."""
    out = {}
    for key, val in sd.items():
        key = re.sub(r"^first_stage_model\.", "", key)
        if (key.startswith(("loss.", "model_ema.")) or "quant_conv" in key
                or not key.startswith(("encoder.", "decoder."))):
            continue
        out[key] = val
    return out


def vae_config_from_state_dict(sd: StateDict,
                               base: Optional[VaeConfig] = None) -> VaeConfig:
    """The shape fields of a VaeConfig (in and out channels, ch, ch_mult,
    num_res_blocks, z_channels, double_z, attention, quant convs) read off
    an sgm-grammar state dict; the others (act, circular, coord, ...) come
    from `base` (default: the shipped KITTI-360 VAE's)."""
    base = base or VaeConfig()
    conv_in = sd["encoder.conv_in.weight"]
    ch = int(conv_in.shape[0])
    n_levels = _n_levels(sd, r"encoder\.down\.(\d+)\.")
    ch_mult = tuple(
        int(sd[f"encoder.down.{i}.block.0.conv2.weight"].shape[0]) // ch
        for i in range(n_levels))
    n_blocks = _n_levels(sd, r"encoder\.down\.0\.block\.(\d+)\.")
    z = int(sd["decoder.conv_in.weight"].shape[1]) - int(base.coord)
    return dataclasses.replace(
        base, in_channels=int(conv_in.shape[1]) - int(base.coord),
        out_ch=int(sd["decoder.conv_out.weight"].shape[0]), ch=ch,
        ch_mult=ch_mult, num_res_blocks=n_blocks, z_channels=z,
        double_z=int(sd["encoder.conv_out.weight"].shape[0]) == 2 * z,
        attn_type=("vanilla" if any(".mid.attn_1." in k for k in sd)
                   else "none"),
        use_quant_conv="quant_conv.weight" in sd)


def load_sgm_vae(path: str, base: Optional[VaeConfig] = None):
    """An sgm VAE checkpoint (a Lightning `.ckpt`, or a `.safetensors` in
    the sgm grammar such as the VAE trainer's vae_sgm.safetensors) -> an
    AutoencoderKL on the CPU, loaded strict, its shapes read off the
    checkpoint and its other fields from `base`
    (`vae_config_from_state_dict`)."""
    sd = sgm_vae_state_dict(load_torch_state_dict(path))
    if not sd:
        raise ValueError(f"{path}: no encoder.* / decoder.* VAE keys")
    vae = AutoencoderKL(vae_config_from_state_dict(sd, base))
    vae.load_state_dict(sd, strict=True)
    return vae


# ---------------------------------------------------------------------------
# diffusers VAE grammar <-> sgm grammar (ldm/convert_vae.py:14-121)
# ---------------------------------------------------------------------------

_ATTN_FROM_DIFFUSERS = {"to_q": "q", "to_k": "k", "to_v": "v",
                        "to_out.0": "proj_out", "query": "q", "key": "k",
                        "value": "v", "proj_attn": "proj_out",
                        "group_norm": "norm"}


def _n_levels(keys, pattern: str) -> int:
    ids = {int(m.group(1)) for k in keys if (m := re.match(pattern, k))}
    return max(ids) + 1 if ids else 0


def vae_state_dict_from_diffusers(sd: StateDict) -> StateDict:
    """Diffusers AutoencoderKL keys -> sgm keys. Decoder blocks are stored
    in reverse level order, and attention projections are Linear weights
    that become 1x1 convs."""
    n_up = _n_levels(sd, r"decoder\.up_blocks\.(\d+)\.")
    out = {}
    for key, val in sd.items():
        k = re.sub(r"down_blocks\.(\d+)\.resnets\.(\d+)", r"down.\1.block.\2",
                   key)
        k = re.sub(r"down_blocks\.(\d+)\.downsamplers\.0", r"down.\1.downsample",
                   k)
        k = re.sub(r"up_blocks\.(\d+)\.resnets\.(\d+)",
                   lambda m: f"up.{n_up - 1 - int(m[1])}.block.{m[2]}", k)
        k = re.sub(r"up_blocks\.(\d+)\.upsamplers\.0",
                   lambda m: f"up.{n_up - 1 - int(m[1])}.upsample", k)
        k = k.replace("mid_block.resnets.0", "mid.block_1")
        k = k.replace("mid_block.resnets.1", "mid.block_2")
        k = k.replace("mid_block.attentions.0", "mid.attn_1")
        k = k.replace("conv_norm_out", "norm_out")
        k = k.replace("conv_shortcut", "nin_shortcut")
        m = re.match(r"(.*\.mid\.attn_1)\.(.+)\.(weight|bias)$", k)
        if m and m[2] in _ATTN_FROM_DIFFUSERS:
            k = f"{m[1]}.{_ATTN_FROM_DIFFUSERS[m[2]]}.{m[3]}"
            if val.dim() == 2:
                val = val[:, :, None, None]
        out[k] = val
    return out


def vae_state_dict_to_diffusers(sd: StateDict) -> StateDict:
    """sgm keys -> diffusers AutoencoderKL keys (the inverse of
    `vae_state_dict_from_diffusers`)."""
    n_up = _n_levels(sd, r"decoder\.up\.(\d+)\.")
    to_dif = {"q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0",
              "norm": "group_norm"}
    out = {}
    for key, val in sd.items():
        m = re.match(r"(.*\.mid\.attn_1)\.(q|k|v|proj_out|norm)\.(weight|bias)$",
                     key)
        if m:
            key = f"{m[1]}.{to_dif[m[2]]}.{m[3]}"
            if val.dim() == 4:
                val = val[:, :, 0, 0]
        k = re.sub(r"down\.(\d+)\.block\.(\d+)", r"down_blocks.\1.resnets.\2",
                   key)
        k = re.sub(r"down\.(\d+)\.downsample", r"down_blocks.\1.downsamplers.0",
                   k)
        k = re.sub(r"up\.(\d+)\.block\.(\d+)",
                   lambda m: f"up_blocks.{n_up - 1 - int(m[1])}.resnets.{m[2]}",
                   k)
        k = re.sub(r"up\.(\d+)\.upsample",
                   lambda m: f"up_blocks.{n_up - 1 - int(m[1])}.upsamplers.0",
                   k)
        k = k.replace("mid.block_1", "mid_block.resnets.0")
        k = k.replace("mid.block_2", "mid_block.resnets.1")
        k = k.replace("mid.attn_1", "mid_block.attentions.0")
        k = k.replace("norm_out", "conv_norm_out")
        k = k.replace("nin_shortcut", "conv_shortcut")
        out[k] = val
    return out


# ---------------------------------------------------------------------------
# diffusers pipeline directories
# ---------------------------------------------------------------------------

WEIGHT_FILES = ("diffusion_pytorch_model.safetensors",
                "diffusion_pytorch_model.bin")


def _weights(model_dir: str) -> str:
    for name in WEIGHT_FILES:
        p = os.path.join(model_dir, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no {' or '.join(WEIGHT_FILES)} in {model_dir}")


def load_diffusers_unet(model_dir: str) -> Tuple[UNetConfig, StateDict]:
    """A diffusers UNet2DModel directory (config.json with sample_size
    [azimuth, beams] + weights) -> (config, state dict)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    unet_cfg = UNetConfig.from_reference({
        k: cfg[k] for k in ("sample_size", "in_channels", "out_channels",
                            "layers_per_block", "block_out_channels",
                            "down_block_types", "up_block_types",
                            "attention_head_dim") if k in cfg})
    return unet_cfg, load_torch_state_dict(_weights(model_dir))


def load_diffusers_vae(vae_dir: str) -> Tuple[VaeConfig, StateDict]:
    """A diffusers AutoencoderKL directory -> (config, sgm state dict)."""
    with open(os.path.join(vae_dir, "config.json")) as f:
        vcfg = json.load(f)
    sd = vae_state_dict_from_diffusers(
        load_torch_state_dict(_weights(vae_dir)))
    ch = vcfg["block_out_channels"][0]
    cfg = VaeConfig(
        in_channels=vcfg.get("in_channels", 2),
        out_ch=vcfg.get("out_channels", 2),
        ch=ch,
        ch_mult=tuple(c // ch for c in vcfg["block_out_channels"]),
        num_res_blocks=vcfg.get("layers_per_block", 2),
        z_channels=vcfg.get("latent_channels", 4),
        attn_type="vanilla" if any(".mid.attn_1." in k for k in sd)
        else "none",
        scaling_factor=vcfg.get("scaling_factor", 0.18215),
        use_quant_conv="quant_conv.weight" in sd)
    return cfg, sd


def load_vae(path: str, cfg: Optional[VaeConfig] = None) -> AutoencoderKL:
    """Every VAE artifact the first stage hands to the second
    (rangeldm_tpu/train_ldm.py:50-73): an sgm `.ckpt` or an sgm-grammar
    `.safetensors` (the VAE trainer's vae_sgm.safetensors), with the
    shapes read off the file and the other fields of `cfg`; or a
    diffusers-layout VAE directory, or a pipeline directory holding one
    under vae/. An orbax pipeline directory of the JAX package is read
    after tools/export_pipeline.py has exported it."""
    if path.endswith((".ckpt", ".safetensors")):
        return load_sgm_vae(path, cfg)
    vae_dir = path if os.path.exists(os.path.join(path, "config.json")) \
        else os.path.join(path, "vae")
    if not os.path.isdir(vae_dir):
        raise ValueError(f"vae_checkpoint {path!r}: expected an sgm .ckpt "
                         f"or .safetensors file, or a diffusers-layout VAE "
                         f"or pipeline directory (orbax directories of the "
                         f"JAX package are not read; export a JAX pipeline "
                         f"directory with tools/export_pipeline.py)")
    cfg, sd = load_diffusers_vae(vae_dir)
    vae = AutoencoderKL(cfg)
    vae.load_state_dict(sd, strict=True)
    return vae


def save_diffusers_pipeline(path: str, unet: torch.nn.Module,
                            vae: Optional[torch.nn.Module] = None,
                            schedule: Optional[dict] = None,
                            unet_ema: Optional[StateDict] = None,
                            record: Optional[dict] = None) -> None:
    """Write a diffusers-layout pipeline directory: unet/, and (when given)
    unet_ema/ with the EMA weights of the same UNet and vae/, each with
    config.json + diffusion_pytorch_model.safetensors, and
    scheduler/scheduler_config.json. `record`, a trainer's run record
    (RECORD_KEYS), goes into model_index.json beside the schedule, as the
    JAX package's save_pipeline writes it."""
    u = unet.cfg
    unet_config = {"sample_size": list(u.sample_size)[::-1],
                   "in_channels": u.in_channels,
                   "out_channels": u.out_channels,
                   "layers_per_block": u.layers_per_block,
                   "block_out_channels": list(u.block_out_channels),
                   "down_block_types": list(u.down_block_types),
                   "up_block_types": list(u.up_block_types),
                   "attention_head_dim": u.attention_head_dim}
    weights = {"unet": unet.state_dict()}
    if unet_ema is not None:
        weights["unet_ema"] = unet_ema
    for name, sd in weights.items():
        d = os.path.join(path, name)
        write_safetensors(sd, os.path.join(d, WEIGHT_FILES[0]))
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(unet_config, f)
    if vae is not None:
        v = vae.cfg
        d = os.path.join(path, "vae")
        write_safetensors(vae_state_dict_to_diffusers(vae.state_dict()),
                          os.path.join(d, WEIGHT_FILES[0]))
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"in_channels": v.in_channels,
                       "out_channels": v.out_ch,
                       "block_out_channels": [v.ch * m for m in v.ch_mult],
                       "latent_channels": v.z_channels,
                       "layers_per_block": v.num_res_blocks,
                       "scaling_factor": v.scaling_factor}, f)
    d = os.path.join(path, "scheduler")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "scheduler_config.json"), "w") as f:
        json.dump(dict(schedule or {}, _class_name="DDPMScheduler"), f)
    if record is not None:
        with open(os.path.join(path, "model_index.json"), "w") as f:
            json.dump({"schedule": schedule, **record}, f, indent=2)
