"""Pixel-space RangeDM (`rangedm_kitti360`, the reference's RangeDM.yaml) in
the port against the JAX package, on the CPU in f32: the zoo spec field for
field, a narrow UNet of RangeDM's grammar (six levels, attention at the
fifth level and in the mid block) within 5e-4, and a pixel-space DDIM-50
chain from the same x_T within 1e-3 (the bounds of
tests/test_torch_port_models.py and test_torch_port_sampling.py). The
pixel train step is a case of tests/test_torch_port_training.py."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rangeldm_tpu.diffusion.schedule import Schedule as JaxSchedule
from rangeldm_tpu.diffusion.schedule import ScheduleConfig as JaxScheduleConfig
from rangeldm_tpu.models import zoo as jax_zoo
from rangeldm_tpu.models.unet import UNet2D as JaxUNet2D
from rangeldm_tpu.pipelines import samplers as js

from rangeldm_tpu_torch.diffusion.schedule import Schedule, ScheduleConfig
from rangeldm_tpu_torch.models import zoo
from rangeldm_tpu_torch.pipelines import samplers as ts
from test_torch_port_common import (
    jax_unet_params, nhwc_to_torch, port_unet, torch_to_nhwc,
)

# RangeDM's block types and layers at widths of 32 and 64 on a (32, 64)
# image: the five downsamples take it to (1, 2); attention (8 heads)
# sees 8 tokens at the fifth level and 2 in the mid block
SPEC = jax_zoo.rangedm_kitti360().unet
NARROW = dict(sample_size=(32, 64), block_out_channels=(32, 32, 32, 32, 64,
                                                        64))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_rangedm_spec_equals_jax():
    got, want = zoo.rangedm_kitti360(), jax_zoo.rangedm_kitti360()
    for f in dataclasses.fields(got):
        if f.name in ("unet", "schedule"):
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for f in dataclasses.fields(got.unet):
        if hasattr(want.unet, f.name):
            assert getattr(got.unet, f.name) == getattr(want.unet, f.name), \
                f.name
    assert dataclasses.asdict(got.schedule) == dataclasses.asdict(
        want.schedule)
    assert zoo.get_model_spec("rangedm_kitti360") == got
    assert got.vae is None and got.latent_shape == (64, 1024, 2)


@pytest.fixture(scope="module")
def narrow_rangedm():
    cfg, params = jax_unet_params(
        seed=70, **{**NARROW, **{k: getattr(SPEC, k) for k in (
            "in_channels", "out_channels", "down_block_types",
            "up_block_types")}})
    return dict(cfg=cfg, params=params, unet=port_unet(cfg, params),
                jax_apply=jax.jit(JaxUNet2D(cfg).apply))


def test_narrow_rangedm_unet_matches_jax(narrow_rangedm):
    m = narrow_rangedm
    assert [type(a).__name__ for a in m["unet"].modules()
            if type(a).__name__ == "Attention"] == ["Attention"] * 6
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, *NARROW["sample_size"], 3)).astype(np.float32)
    t = np.array([10, 900], np.int32)
    want = np.asarray(m["jax_apply"]({"params": m["params"]}, x, t))
    with torch.no_grad():
        got = m["unet"](nhwc_to_torch(x), torch.from_numpy(t.astype(np.int64)))
    np.testing.assert_allclose(torch_to_nhwc(got), want, rtol=5e-4,
                               atol=5e-4)


def test_pixel_ddim50_chain_matches_jax(narrow_rangedm):
    """`ddim_sample` with the pos channel, as RangeDM samples: the JAX
    chain's x_T is handed to the port."""
    m = narrow_rangedm
    shape = (1, *NARROW["sample_size"], 2)
    key = jax.random.PRNGKey(7)
    jschedule = JaxSchedule.create(JaxScheduleConfig())

    @jax.jit
    def jax_chain(key):
        x_t = jax.random.normal(jax.random.split(key)[1], shape, jnp.float32)
        out = js.ddim_sample(
            lambda u, t: m["jax_apply"]({"params": m["params"]}, u, t),
            jschedule, key, shape, num_steps=50, pos_encoding=True)
        return x_t, out

    x_t, want = (np.array(a) for a in jax_chain(key))
    with torch.no_grad():
        got = ts.ddim_sample((m["unet"],), Schedule(ScheduleConfig()), shape,
                             num_steps=50, pos_encoding=True,
                             noise=torch.from_numpy(x_t))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
