"""The port's sliced conv VAE family (rangeldm_tpu_torch/models/sliced.py)
against the JAX package's (rangeldm_tpu/models/sliced.py) on the same numpy
inputs, with the JAX weights carried across by
`convert.sliced_state_dict_from_jax`; and against the inline torch twin of
the reference's SlicedConv (tests/test_sliced.py), whose state dict loads
strict. f32 on the CPU, within 1e-5."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rangeldm_tpu.models import sliced as js
from test_sliced import TorchSlicedConv
from test_torch_port_common import (
    jit_apply, nhwc_to_torch, numpy_params, torch_to_nhwc,
)

from rangeldm_tpu_torch.convert import sliced_state_dict_from_jax
from rangeldm_tpu_torch.models import sliced as ts

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("k,stride,padding", [
    (3, 1, 0), (3, 1, 1), (3, 2, 0), (3, 2, 1), (1, 1, 0), (1, 1, 1),
])
def test_sliced_conv_matches_jax_and_the_reference(k, stride, padding):
    b, hh, w, cin, cout = 2, 8, 16, 6, 4
    rng = np.random.default_rng(k * 10 + stride * 2 + padding)
    x = rng.standard_normal((b, hh, w, cin)).astype(np.float32)
    jm = js.SlicedConv(cout, k, stride, padding, hh)
    params = numpy_params(jm, x, seed=k + stride + padding)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))

    port = ts.SlicedConv(cin, cout, k, stride, padding, hh)
    port.load_state_dict(sliced_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = torch_to_nhwc(port(nhwc_to_torch(x)))
    assert got.shape == want.shape == (b, hh // stride, w // stride, cout)
    np.testing.assert_allclose(got, want, **TOL)

    twin = TorchSlicedConv(cin, cout, k, stride, padding, hh)
    twin.load_state_dict(port.state_dict(), strict=True)
    with torch.no_grad():
        ref = twin(nhwc_to_torch(x))
    np.testing.assert_array_equal(torch_to_nhwc(ref), got)


CFG = dict(ch=32, ch_mult=(1, 2, 2), num_res_blocks=1, z_channels=3,
           resolution=8)


@pytest.mark.parametrize("attn_type", ["none", "vanilla"])
def test_sliced_encoder_matches_jax(attn_type):
    """Two downsamples, a channel change, and the padding toggle through
    conv_in, the blocks, the resamples and the mid blocks; 'vanilla' adds
    the mid attention (the reference classes' default) and attention at
    the 4-row level."""
    cfg = dict(CFG, attn_type=attn_type, attn_resolutions=(4,))
    x = np.random.default_rng(0).standard_normal(
        (2, 8, 16, 2)).astype(np.float32)
    jm = js.SlicedEncoder(js.SlicedConfig(**cfg))
    params = numpy_params(jm, x, seed=3)
    want = np.asarray(jit_apply(jm)(params, jnp.asarray(x)))

    port = ts.SlicedEncoder(ts.SlicedConfig(**cfg)).eval()
    port.load_state_dict(sliced_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = torch_to_nhwc(port(nhwc_to_torch(x)))
    assert got.shape == want.shape == (2, 2, 4, 6)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("extra", [{}, {"tanh_out": True},
                                   {"give_pre_end": True}])
def test_sliced_decoder_matches_jax(extra):
    cfg = dict(CFG, **extra)
    z = np.random.default_rng(1).standard_normal(
        (2, 2, 4, 3)).astype(np.float32)
    jm = js.SlicedDecoder(js.SlicedConfig(**cfg))
    params = numpy_params(jm, z, seed=5)
    want = np.asarray(jit_apply(jm)(params, jnp.asarray(z)))

    port = ts.SlicedDecoder(ts.SlicedConfig(**cfg)).eval()
    port.load_state_dict(sliced_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = torch_to_nhwc(port(nhwc_to_torch(z)))
    channels = 32 if extra.get("give_pre_end") else 2
    assert got.shape == want.shape == (2, 8, 16, channels)
    np.testing.assert_allclose(got, want, **TOL)


def test_sliced_downsample_without_conv_pools():
    x = torch.randn(1, 4, 8, 6)
    down = ts.SlicedDownsample(4, with_conv=False)
    assert not list(down.parameters())
    torch.testing.assert_close(down(x), torch.nn.functional.avg_pool2d(
        x, 2, 2))


def test_sliced_conv_refuses_another_height():
    with pytest.raises(ValueError, match="height 8"):
        ts.SlicedConv(2, 4, 3, 1, 0, 8)(torch.zeros(1, 2, 16, 6))
