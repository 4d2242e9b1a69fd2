"""Shared pieces of the parity tests between `rangeldm_tpu` (JAX, the
reference) and `rangeldm_tpu_torch` (the PyTorch port).

Inputs and weights are made with numpy from a seed, the weights as a JAX
params tree, and carried to the port with the port's own converter
(`rangeldm_tpu_torch.convert`). Everything runs on the CPU in float32. This
module holds helpers only; the tests live in the other test_torch_port_*
files.
"""

import dataclasses
import importlib.util
import json
import os
import sys
import types

import numpy as np
import torch
import jax

from rangeldm_tpu.convert.diffusers_unet import convert_diffusers_unet_state_dict
from rangeldm_tpu.convert.sgm_vae import convert_sgm_vae_state_dict
from rangeldm_tpu.models.unet import UNetConfig as JaxUNetConfig
from rangeldm_tpu.models.vae import VaeConfig as JaxVaeConfig
from test_convert import make_diffusers_unet_state_dict, make_sgm_vae_state_dict

from rangeldm_tpu_torch.convert import (
    unet_state_dict_from_jax, vae_state_dict_from_jax,
)
from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig
from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
from rangeldm_tpu_torch.training.event_file import event_files, read_scalars

# the flagship grammar (4 levels, attention at down 1-3 / mid / up 0-2) at
# narrow widths; the (16, 64) latent gives attention layers with T = 256,
# 64 and 16 tokens
TINY_UNET = dict(sample_size=(16, 64), in_channels=5, out_channels=4,
                 block_out_channels=(32, 32, 64, 64))
TINY_VAE = dict(ch=32, ch_mult=(1, 2), z_channels=4)


def nhwc_to_torch(x) -> torch.Tensor:
    """(B, H, W, C) numpy -> (B, C, W, H) tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 2, 1)))


def torch_to_nhwc(t: torch.Tensor) -> np.ndarray:
    """(B, C, W, H) tensor -> (B, H, W, C) numpy."""
    return t.detach().float().numpy().transpose(0, 3, 2, 1)


def perturb(params, seed: int, scale: float = 0.05):
    """Add seeded noise to every leaf, so biases and norm scales differ from
    their constant inits and a wrong mapping of any leaf shows."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (np.asarray(p, np.float32)
                   + scale * rng.standard_normal(np.shape(p))
                   .astype(np.float32)), params)


def numpy_params(module, *inputs, seed: int = 0):
    """Params of a flax `module` on `inputs`, drawn with numpy from `seed`
    in the tree and shapes `module.init` would give (traced, not run):
    kernels of standard deviation 1/sqrt(fan-in), norm scales near 1,
    biases near 0."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in = np.prod(shape[1:-1] if len(shape) == 5 else shape[:-1])
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.05 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jit_apply(module):
    """`module.apply` compiled at XLA's lowest backend optimization level,
    which about halves the compile of a small network on the CPU."""
    return jax.jit(module.apply, compiler_options={
        "xla_backend_optimization_level": 0})


def jax_unet_params(seed: int = 0, **overrides):
    """(JAX UNetConfig, params tree) of the tiny flagship-grammar UNet."""
    cfg = JaxUNetConfig(**{**TINY_UNET, **overrides})
    rng = np.random.default_rng(seed)
    params = convert_diffusers_unet_state_dict(
        make_diffusers_unet_state_dict(rng, cfg))
    return cfg, perturb(params, seed + 1)


def jax_vae_params(seed: int = 0, **overrides):
    """(JAX VaeConfig, params tree) of the tiny VAE."""
    cfg = JaxVaeConfig(**{**TINY_VAE, **overrides})
    rng = np.random.default_rng(seed)
    params = convert_sgm_vae_state_dict(make_sgm_vae_state_dict(rng, cfg))
    return cfg, perturb(params, seed + 1, scale=0.02)


def port_config(jax_cfg, cls):
    """The port's config dataclass with the JAX config's field values."""
    return cls(**{f.name: getattr(jax_cfg, f.name)
                  for f in dataclasses.fields(cls)})


def port_unet(jax_cfg, params) -> UNet2D:
    model = UNet2D(port_config(jax_cfg, UNetConfig))
    model.load_state_dict(unet_state_dict_from_jax(params), strict=True)
    return model.eval()


def port_vae(jax_cfg, params) -> AutoencoderKL:
    model = AutoencoderKL(port_config(jax_cfg, VaeConfig))
    model.load_state_dict(vae_state_dict_from_jax(params), strict=True)
    return model.eval()


def tb_scalars(logdir) -> list:
    """(step, tag, value) of every scalar in a directory's event files, read
    by TensorBoard's own loader (the event files stay in the order the
    port's reader sorts them). TensorBoard reads with its own stub of
    TensorFlow when a module `tensorboard.compat.notf` exists: importing
    TensorFlow, where it is installed, would take seconds."""
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader,
    )
    from tensorboard.util import tensor_util
    got = []
    for path in event_files(str(logdir)):
        for event in EventFileLoader(path).Load():
            for v in event.summary.value:
                got.append((event.step, v.tag,
                            float(tensor_util.make_ndarray(v.tensor))))
    return got


def assert_tb_equals_jsonl(out_dir) -> None:
    """<out_dir>/tb holds the rows of <out_dir>/train_log.jsonl: the same
    tags, steps and float32 values, read by the port's reader and, where
    the tensorboard package is installed, by TensorBoard's loader."""
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    want = [(r["step"], k, float(np.float32(v))) for r in rows
            for k, v in r.items() if k != "step"]
    assert want
    tb = os.path.join(out_dir, "tb")
    assert read_scalars(tb) == want
    if importlib.util.find_spec("tensorboard") is not None:
        assert tb_scalars(tb) == want
