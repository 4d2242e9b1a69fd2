"""The port's UNet2D and VAE (rangeldm_tpu_torch/models/) against the JAX
package's on the same numpy inputs, with the same weights carried across by
the port's converter. f32 on the CPU; 5e-4 is the repo's UNet bound
(tests/test_released_rehearsal.py), here covering a whole network's worth of
different summation orders."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rangeldm_tpu.models.unet import UNet2D as JaxUNet2D
from rangeldm_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from rangeldm_tpu.models.vae import gaussian_kl as jax_gaussian_kl
from rangeldm_tpu.models.vae import gaussian_mode as jax_gaussian_mode
from rangeldm_tpu.models.vae import gaussian_params as jax_gaussian_params

from rangeldm_tpu_torch.models import vae as tv
from test_torch_port_common import (
    jax_unet_params, jax_vae_params, nhwc_to_torch, port_unet, port_vae,
    torch_to_nhwc,
)

TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def unet_pair():
    cfg, params = jax_unet_params(seed=10)
    return cfg, params, port_unet(cfg, params)


@pytest.fixture(scope="module")
def jax_unet_apply(unet_pair):
    """The JAX UNet compiled once for the module (eager op-by-op dispatch
    compiles every op on its own)."""
    return jax.jit(JaxUNet2D(unet_pair[0]).apply)


@pytest.fixture(scope="module")
def vae_pair():
    cfg, params = jax_vae_params(seed=20)
    return cfg, params, port_vae(cfg, params)


@pytest.mark.parametrize("timesteps", [[3, 981], [500, 500]])
def test_unet_forward_matches_jax(unet_pair, jax_unet_apply, timesteps):
    """The tiny flagship-grammar UNet on a (16, 64) latent: attention
    layers at T = 256, 64 and 16, all through `fused_attention_t` (its plain
    version on the CPU)."""
    cfg, params, model = unet_pair
    h, w = cfg.sample_size
    x = np.random.default_rng(sum(timesteps)).standard_normal(
        (2, h, w, cfg.in_channels)).astype(np.float32)
    t = np.asarray(timesteps, np.int32)
    want = np.asarray(jax_unet_apply({"params": params}, jnp.asarray(x),
                                     jnp.asarray(t)))
    with torch.no_grad():
        got = torch_to_nhwc(model(nhwc_to_torch(x), torch.from_numpy(t)))
    assert got.shape == (2, h, w, cfg.out_channels)
    np.testing.assert_allclose(got, want, **TOL)


def test_unet_einsum_path_matches_kernel_path(unet_pair):
    """use_fused_attention=False (the einsum path) is the same function."""
    cfg, _, model = unet_pair
    plain = type(model)(dataclasses.replace(model.cfg,
                                            use_fused_attention=False))
    plain.load_state_dict(model.state_dict(), strict=True)
    h, w = cfg.sample_size
    x = torch.randn((1, cfg.in_channels, w, h),
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_allclose(plain.eval()(x, torch.tensor(7)).numpy(),
                                   model(x, torch.tensor(7)).numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pre_end", [False, True])
def test_decoder_matches_jax(vae_pair, pre_end):
    cfg, params, model = vae_pair
    z = np.random.default_rng(5).standard_normal((2, 16, 64, 4)).astype(
        np.float32)
    method = "decode_features" if pre_end else "decode"
    want = np.asarray(JaxAutoencoderKL(cfg).apply(
        {"params": params}, jnp.asarray(z), method=method))
    with torch.no_grad():
        got = torch_to_nhwc(model.decoder(nhwc_to_torch(z), pre_end=pre_end))
    assert got.shape == want.shape
    assert got.shape[1:3] == (32, 128)
    np.testing.assert_allclose(got, want, **TOL)


def test_encoder_moments_and_posterior_match_jax(vae_pair):
    """The encoder is on no sampling path, but it must load strictly and
    agree, so a released VAE state dict is taken whole."""
    cfg, params, model = vae_pair
    x = np.random.default_rng(6).standard_normal((2, 32, 128, 2)).astype(
        np.float32)
    want = np.asarray(JaxAutoencoderKL(cfg).apply(
        {"params": params}, jnp.asarray(x), method="encode_moments"))
    with torch.no_grad():
        moments = model.encode_moments(nhwc_to_torch(x))
    np.testing.assert_allclose(torch_to_nhwc(moments), want, **TOL)

    # the [-30, 20] clamp of the log-variance
    big = np.concatenate([np.zeros((1, 2, 2, 4)), np.full((1, 2, 2, 4), 50.0),
                          ], axis=-1).astype(np.float32)
    big[..., 4:6] = -50.0
    jmean, jlogvar = jax_gaussian_params(jnp.asarray(big))
    tmean, tlogvar = tv.gaussian_params(nhwc_to_torch(big))
    np.testing.assert_array_equal(torch_to_nhwc(tlogvar), np.asarray(jlogvar))
    np.testing.assert_array_equal(torch_to_nhwc(tmean), np.asarray(jmean))
    assert float(tlogvar.max()) == 20.0 and float(tlogvar.min()) == -30.0


def test_gaussian_posterior_functions():
    moments = (3.0 * np.random.default_rng(8).standard_normal(
        (2, 4, 8, 8))).astype(np.float32)
    t = nhwc_to_torch(moments)
    np.testing.assert_array_equal(torch_to_nhwc(tv.gaussian_mode(t)),
                                  np.asarray(jax_gaussian_mode(moments)))
    np.testing.assert_allclose(tv.gaussian_kl(t).numpy(),
                               np.asarray(jax_gaussian_kl(moments)),
                               rtol=1e-5)
    mean, logvar = tv.gaussian_params(t)
    g = torch.Generator().manual_seed(0)
    noise = torch.randn(mean.shape, generator=g)
    got = tv.gaussian_sample(t, torch.Generator().manual_seed(0))
    torch.testing.assert_close(got, mean + torch.exp(0.5 * logvar) * noise)
