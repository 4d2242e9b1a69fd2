"""The port's experimental modules (rangeldm_tpu_torch/models/
experimental.py) against the JAX package's (rangeldm_tpu/models/
experimental.py) on the same numpy inputs, with the JAX weights carried
across by `convert.experimental_state_dict_from_jax`. f32 on the CPU,
within 1e-5."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rangeldm_tpu.models import experimental as je
from test_torch_port_common import (
    jit_apply, nhwc_to_torch, numpy_params, torch_to_nhwc,
)

from rangeldm_tpu_torch.convert import experimental_state_dict_from_jax
from rangeldm_tpu_torch.models import experimental as te

TOL = dict(rtol=1e-5, atol=1e-5)
AZI, INC = 2 * np.pi / 16, 0.4 * np.pi / 180 * 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def inputs(seed, c=4, h=8, w=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    r = rng.uniform(2.0, 40.0, (2, h, w, 1)).astype(np.float32)
    return x, r


def port(module, params):
    module.load_state_dict(experimental_state_dict_from_jax(params),
                           strict=True)
    return module.eval()


@pytest.mark.parametrize("act", ["relu", "silu"])
def test_edge_conv_matches_jax(act):
    x, r = inputs(0)
    jm = je.EdgeConv(6, AZI, INC, act)
    params = numpy_params(jm, x, r, seed=1)
    want = np.asarray(jit_apply(jm)(params, jnp.asarray(x), jnp.asarray(r)))
    with torch.no_grad():
        got = port(te.EdgeConv(4, 6, AZI, INC, act), params)(
            nhwc_to_torch(x), nhwc_to_torch(r))
    np.testing.assert_allclose(torch_to_nhwc(got), want, **TOL)


@pytest.mark.parametrize("out_channels", [32, 64])
def test_edge_conv_resnet_block_matches_jax(out_channels):
    """64 channels adds the nin_shortcut."""
    x, r = inputs(2, c=32)
    jm = je.EdgeConvResnetBlock(out_channels, AZI, INC)
    params = numpy_params(jm, x, r, seed=3)
    want = np.asarray(jit_apply(jm)(params, jnp.asarray(x), jnp.asarray(r)))
    with torch.no_grad():
        got = port(te.EdgeConvResnetBlock(32, out_channels, AZI, INC),
                   params)(nhwc_to_torch(x), nhwc_to_torch(r))
    assert got.shape == (2, out_channels, 16, 8)
    np.testing.assert_allclose(torch_to_nhwc(got), want, **TOL)


def test_range_downsample_matches_jax():
    """Bit-equal: a selection, with ties (equal ranges in a block) going to
    the same pixel."""
    x, r = inputs(4)
    r[0, :2, :2, 0] = 5.0                  # one block of four equal ranges
    r[1, 2:4, 4:6, 0] = [[1.0, 3.0], [3.0, 1.0]]   # two pixels at the mean
    want_x, want_r = je.range_downsample(jnp.asarray(x), jnp.asarray(r))
    got_x, got_r = te.range_downsample(nhwc_to_torch(x), nhwc_to_torch(r))
    np.testing.assert_array_equal(torch_to_nhwc(got_x), np.asarray(want_x))
    np.testing.assert_array_equal(torch_to_nhwc(got_r), np.asarray(want_r))


def test_per_row_conv_matches_jax():
    x, _ = inputs(5, c=3)
    jm = je.PerRowConv(5)
    params = numpy_params(jm, x, seed=6)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(te.PerRowConv(3, 5, height=8), params)(nhwc_to_torch(x))
    np.testing.assert_allclose(torch_to_nhwc(got), want, **TOL)


def test_sparse_range_image_encoder_matches_jax():
    """Stride 2 on the azimuth twice: (8, 32) -> (8, 8)."""
    x, _ = inputs(7, c=2, w=32)
    jm = je.SparseRangeImageEncoder(outdim=4, middle=8)
    params = numpy_params(jm, x, seed=8)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(te.SparseRangeImageEncoder(2, 4, 8), params)(
            nhwc_to_torch(x))
    assert got.shape == (2, 4, 8, 8)
    np.testing.assert_allclose(torch_to_nhwc(got), want, **TOL)
