"""tools/export_pipeline.py: a pipeline directory written by the JAX
package's own `save_pipeline` (orbax trees and a run record) exported to
the diffusers layout and loaded by the port's `load_diffusers_pipeline` and
`RangePipeline`. A 5-step DDIM chain from the same numpy noise matches the
JAX package's `load_any_pipeline` chain within 1e-3, the repo's chain
bound; the run record comes through; a config the layout cannot hold is
refused by name and nothing is written."""

import importlib.util
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import rangeldm_tpu.sample_ldm as jax_sample_ldm
from rangeldm_tpu.diffusion.schedule import ScheduleConfig as JaxScheduleConfig
from rangeldm_tpu.models.unet import UNetConfig as JaxUNetConfig
from rangeldm_tpu.models.vae import VaeConfig as JaxVaeConfig
from rangeldm_tpu.pipelines import samplers as js
from rangeldm_tpu.training.checkpoint import save_pipeline
from test_torch_port_common import (
    jax_unet_params, jax_vae_params, perturb,
)

from rangeldm_tpu_torch.convert import unet_state_dict_from_jax
from rangeldm_tpu_torch.models.unet import UNetConfig
from rangeldm_tpu_torch.models.vae import VaeConfig
from rangeldm_tpu_torch.pipelines import RangePipeline, pipeline
from rangeldm_tpu_torch.pipelines import samplers as ts

ROOT = Path(__file__).resolve().parent.parent
CHAIN_TOL = dict(rtol=1e-3, atol=1e-3)
RECORD = {"model": "custom", "pos_encoding": True, "image_size": [32, 128],
          "sensor": "nuscenes",
          "normalization": {"mean": 1.5, "std": 2.5, "log": True,
                            "inverse": False}}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "export_pipeline", ROOT / "tools" / "export_pipeline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


_TEMPLATES = {}


@pytest.fixture(autouse=True)
def _traced_templates(monkeypatch):
    """The JAX loader's templates by `jax.eval_shape` in place of its eager
    `init` on the CPU, traced once a model and input shape: the same tree
    and shapes for orbax to restore into, in a fraction of the time. The
    weights still come from the files."""
    def template(init, *args, **kw):
        key = (repr(init.__self__), repr(jax.tree.map(np.shape, (args, kw))))
        if key not in _TEMPLATES:
            _TEMPLATES[key] = jax.eval_shape(lambda: init(*args, **kw))
        return _TEMPLATES[key]

    monkeypatch.setattr(jax_sample_ldm, "init_on_cpu", template)


@pytest.fixture(scope="module")
def jax_pipeline(tmp_path_factory):
    """A tiny latent pipeline (a narrow 4-level UNet with its mid attention
    only, which keeps JAX's tracing short; a (1, 2) VAE) with an EMA that
    differs from the UNet, saved by the JAX package."""
    ucfg, uparams = jax_unet_params(seed=60,
                                    down_block_types=("DownBlock2D",) * 4,
                                    up_block_types=("UpBlock2D",) * 4)
    vcfg, vparams = jax_vae_params(seed=61)
    path = str(tmp_path_factory.mktemp("jax") / "pipeline")
    save_pipeline(path, unet_params=uparams, unet_cfg=ucfg,
                  ema_params=perturb(uparams, 62), vae_params=vparams,
                  vae_cfg=vcfg, schedule_cfg=JaxScheduleConfig(
                      prediction_type="v_prediction"),
                  extra=RECORD)
    return path


def test_exported_pipeline_samples_as_the_jax_one(jax_pipeline, tmp_path):
    out = _tool().export_pipeline(jax_pipeline, str(tmp_path / "out"))
    assert sorted(os.listdir(out)) == ["model_index.json", "scheduler",
                                       "unet", "unet_ema", "vae"]
    assert not os.path.exists(out + ".tmp")
    with open(os.path.join(out, "model_index.json")) as f:
        index = json.load(f)
    assert {k: index[k] for k in RECORD} == RECORD
    assert index["schedule"]["prediction_type"] == "v_prediction"

    jp = jax_sample_ldm.load_any_pipeline(jax_pipeline, dtype=jnp.float32)
    pipe = pipeline.load_diffusers_pipeline(out, dtype=torch.float32,
                                              device="cpu")
    assert pipe["schedule"].cfg.prediction_type == "v_prediction"
    h, w = jp["unet_cfg"].sample_size
    shape = (1, h, w, jp["unet_cfg"].out_channels)
    x_t = np.random.default_rng(63).standard_normal(shape).astype(
        np.float32)
    sf = jp["vae_cfg"].scaling_factor

    @jax.jit
    def jax_chain(x):
        z = js.denoise(
            lambda u, t: jp["unet"].apply(jp["unet_params"], u, t),
            jp["schedule"], x, 5, jax.random.PRNGKey(0), method="ddim",
            pos_encoding=js.make_pos_encoding(*shape[:3]))
        return jp["vae"].apply(jp["vae_params"], z / sf, method="decode")

    want = np.asarray(jax_chain(jnp.asarray(x_t)))
    with torch.no_grad():
        got = ts.latent_sample((pipe["unet"],), (pipe["vae"].decode,),
                               pipe["schedule"], shape, sf, num_steps=5,
                               noise=torch.from_numpy(x_t))
    assert got.shape == want.shape == (1, 2 * h, 2 * w, 2)
    np.testing.assert_allclose(got.numpy(), want, **CHAIN_TOL)

    rp = RangePipeline.from_pretrained(out, dtype=torch.float32,
                                       device="cpu")
    assert rp.sensor == "nuscenes" and rp.is_latent
    assert pipe["meta"]["normalization"] == RECORD["normalization"]


def test_no_ema_leaves_out_the_ema(jax_pipeline, tmp_path):
    out = str(tmp_path / "out")
    assert _tool().main([jax_pipeline, out, "--no-ema"]) == 0
    assert "unet_ema" not in os.listdir(out)
    jp = jax_sample_ldm.load_any_pipeline(jax_pipeline, dtype=jnp.float32,
                                          use_ema=False)
    pipe = pipeline.load_diffusers_pipeline(out, dtype=torch.float32,
                                              device="cpu")
    want = unet_state_dict_from_jax(jp["unet_params"])
    got = pipe["unet"].state_dict()
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name


def test_a_config_the_layout_cannot_hold_is_refused(jax_pipeline, tmp_path):
    """A relu VAE, named with its value; nothing is written."""
    src = str(tmp_path / "src")
    shutil.copytree(jax_pipeline, src)
    cfg_path = os.path.join(src, "vae", "config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    with open(cfg_path, "w") as f:
        json.dump(dict(cfg, act="relu"), f)
    out = str(tmp_path / "out")
    with pytest.raises(ValueError, match="cannot hold vae.act='relu';"):
        _tool().export_pipeline(src, out)
    assert sorted(os.listdir(tmp_path)) == ["src"]
    assert _tool().main([src, out]) == 2


def test_unrestored_fields_names_every_field_but_the_attention_switch():
    tool = _tool()
    jax_unet = JaxUNetConfig(flip_sin_to_cos=False, norm_eps=1e-6,
                             use_fused_attention=False)
    assert tool.unrestored_fields(jax_unet, UNetConfig()) == [
        "norm_eps", "flip_sin_to_cos"]
    jax_vae = JaxVaeConfig(coord=True, circular=False, double_z=False)
    assert tool.unrestored_fields(jax_vae, VaeConfig()) == [
        "double_z", "circular", "coord"]
    assert tool.unrestored_fields(JaxVaeConfig(), VaeConfig()) == []


def test_refuses_what_is_not_a_jax_pipeline_or_an_existing_out(jax_pipeline,
                                                               tmp_path):
    with pytest.raises(ValueError, match="model_index.json"):
        _tool().export_pipeline(str(tmp_path), str(tmp_path / "out"))
    with pytest.raises(ValueError, match="exists"):
        _tool().export_pipeline(jax_pipeline, str(tmp_path))
