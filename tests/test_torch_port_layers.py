"""The port's layers (rangeldm_tpu_torch/models/layers.py) against the JAX
package's (rangeldm_tpu/models/layers.py) on the same numpy inputs and the
same weights, carried across with the port's converter. f32 on the CPU;
1e-5 covers the different summation orders of the two convolutions."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as nn

from rangeldm_tpu.models import layers as jl

from rangeldm_tpu_torch.convert import vae_state_dict_from_jax
from rangeldm_tpu_torch.models import layers as tl
from test_torch_port_common import nhwc_to_torch, perturb, torch_to_nhwc

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _run_pair(jax_module, port_module, x, *extra, seed=0):
    """Init the JAX module, move its (perturbed) params into the port
    module with strict loading, and return both outputs in NHWC."""
    params = perturb(jax_module.init(jax.random.PRNGKey(seed),
                                     jnp.asarray(x), *extra), seed)
    want = np.asarray(jax_module.apply(params, jnp.asarray(x), *extra))
    port_module.load_state_dict(vae_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = torch_to_nhwc(port_module(nhwc_to_torch(x)))
    return got, want


@pytest.mark.parametrize("kernel,stride,padding,circular,coord", [
    (3, 1, 1, True, False),
    (3, 2, 1, True, False),
    (5, 1, (1, 2), True, False),
    (3, 2, ((0, 1), (0, 1)), True, False),
    (3, 1, 1, False, False),
    (1, 1, 0, False, False),
    (3, 1, 1, True, True),
])
def test_circular_conv(kernel, stride, padding, circular, coord):
    x = np.random.default_rng(kernel + stride).standard_normal(
        (2, 6, 16, 8)).astype(np.float32)
    jm = jl.CircularConv(12, kernel, stride, padding, circular=circular,
                         coord=coord)
    tm = tl.CircularConv(8, 12, kernel, stride, padding, circular, coord)
    got, want = _run_pair(jm, tm, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_group_norm_eps(eps):
    x = (3.0 * np.random.default_rng(2).standard_normal((2, 4, 8, 64))
         ).astype(np.float32)
    got, want = _run_pair(nn.GroupNorm(32, epsilon=eps),
                          tl.group_norm(64, eps), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_timestep_embedding():
    """The two libraries' f32 exp may differ by an ulp (~6e-8 relative);
    times t = 999 that moves a sine argument by up to ~1.2e-4 rad, hence
    atol 1.5e-4. Small t must agree to f32 rounding."""
    t = np.array([0, 1, 57, 500, 999], np.int32)
    for dim in (32, 33, 128):
        want = np.asarray(jl.timestep_embedding(jnp.asarray(t), dim))
        got = tl.timestep_embedding(torch.from_numpy(t), dim).numpy()
        assert got.shape == want.shape == (len(t), dim)
        np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-4)
        np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-6)


def test_upsample_nearest_is_exact():
    x = np.random.default_rng(3).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    want = np.asarray(jl.upsample_nearest(jnp.asarray(x)))
    got = torch_to_nhwc(tl.upsample_nearest(nhwc_to_torch(x)))
    np.testing.assert_array_equal(got, want)


def test_attention_1head():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 24, 16)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jl.attention_1head(*map(jnp.asarray, (q, k, v))))
    got = tl.attention_1head(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cin,cout,conv_shortcut", [
    (32, 32, False), (32, 64, False), (32, 64, True)])
def test_vae_resnet_block(cin, cout, conv_shortcut):
    x = np.random.default_rng(cin + cout).standard_normal(
        (2, 8, 16, cin)).astype(np.float32)
    jm = jl.VaeResnetBlock(cout, use_conv_shortcut=conv_shortcut)
    tm = tl.VaeResnetBlock(cin, cout, use_conv_shortcut=conv_shortcut)
    got, want = _run_pair(jm, tm, x)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_vae_attn_block():
    x = np.random.default_rng(5).standard_normal((2, 4, 8, 32)).astype(
        np.float32)
    got, want = _run_pair(jl.VaeAttnBlock(), tl.VaeAttnBlock(32), x)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_conv", [True, False])
def test_vae_downsample(with_conv):
    x = np.random.default_rng(6).standard_normal((2, 8, 16, 32)).astype(
        np.float32)
    got, want = _run_pair(jl.VaeDownsample(with_conv=with_conv),
                          tl.VaeDownsample(32, with_conv=with_conv), x)
    assert got.shape == (2, 4, 8, 32)
    np.testing.assert_allclose(got, want, **TOL)


def test_vae_upsample():
    x = np.random.default_rng(7).standard_normal((2, 4, 8, 32)).astype(
        np.float32)
    got, want = _run_pair(jl.VaeUpsample(), tl.VaeUpsample(32), x)
    assert got.shape == (2, 8, 16, 32)
    np.testing.assert_allclose(got, want, **TOL)
