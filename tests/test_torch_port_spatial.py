"""The port's azimuth spatial parallelism on a local mesh
(rangeldm_tpu_torch/parallel/spatial.py, sharded_vae.py) against the JAX
package's shard_map versions (rangeldm_tpu/parallel/) on the 8 virtual CPU
devices, and against the port's unsharded modules, on the same numpy
inputs. The port's meshes repeat the CPU device, as JAX's repeat one host.
f32 on the CPU, within 1e-5."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from rangeldm_tpu.models.layers import CircularConv as JaxCircularConv
from rangeldm_tpu.parallel import sharded_vae as jsv
from rangeldm_tpu.parallel import spatial as jsp
from test_torch_port_common import (
    jax_vae_params, nhwc_to_torch, numpy_params, port_config, port_vae,
    torch_to_nhwc,
)

from rangeldm_tpu_torch.convert import vae_state_dict_from_jax
from rangeldm_tpu_torch.models.layers import CircularConv
from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
from rangeldm_tpu_torch.parallel.sharded_vae import (
    sharded_vae_decode, sharded_vae_encode,
)
from rangeldm_tpu_torch.parallel.spatial import (
    gather_azimuth, halo_exchange_w, shard_azimuth, sharded_circular_conv2d,
)

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("sp",))


def port_mesh(n):
    return (CPU,) * n


def test_halo_exchange_is_circular_padding_and_matches_jax():
    x = np.random.default_rng(0).standard_normal(
        (1, 4, 64, 3)).astype(np.float32)
    mesh = jax_mesh(8)
    f = jsp.shard_map(lambda v: jsp.halo_exchange_w(v, 1, 2, "sp"),
                      mesh=mesh, in_specs=P(None, None, "sp", None),
                      out_specs=P(None, None, "sp", None))
    want = torch.from_numpy(np.asarray(f(jax.device_put(
        jnp.asarray(x), jsp.spatial_sharding(mesh)))).copy())
    xt = nhwc_to_torch(x)
    got = halo_exchange_w(shard_azimuth(xt, port_mesh(8)), 1, 2)
    assert [s.shape[2] for s in got] == [11] * 8
    padded = F.pad(xt, (0, 0, 1, 2), mode="circular")
    for i, s in enumerate(got):
        torch.testing.assert_close(s, padded[:, :, 8 * i:8 * i + 11],
                                   rtol=0, atol=0)
        # JAX's block i, (1, 4, 11, 3) NHWC
        torch.testing.assert_close(
            s, want[:, :, 11 * i:11 * (i + 1)].permute(0, 3, 2, 1),
            rtol=0, atol=0)
    torch.testing.assert_close(gather_azimuth(shard_azimuth(
        xt, port_mesh(8)), CPU), xt, rtol=0, atol=0)


# (kernel, stride, padding of the port conv, JAX's strides, h_pad, w_halo)
CONVS = {
    "3x3": (3, 1, 1, (1, 1), (1, 1), (1, 1)),
    "vae_downsample": (3, 2, ((0, 1), (0, 1)), (2, 2), (0, 1), (0, 1)),
    "unet_downsample": (3, 2, 1, (2, 2), (1, 1), (1, 0)),
    "1x1": (1, 1, 0, (1, 1), (0, 0), (0, 0)),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_sharded_conv_matches_jax_and_the_unsharded_conv(name):
    """Stride 1, the VAE's asymmetric (0, 1) stride-2 downsample, the
    UNet's symmetric stride-2 one (the port takes the conv's own (1, 1)
    halo, JAX the (1, 0) its stride reads), and a 1x1 (halo 0)."""
    k, stride, padding, strides, h_pad, w_halo = CONVS[name]
    x = np.random.default_rng(1).standard_normal(
        (2, 8, 64, 6)).astype(np.float32)
    jm = JaxCircularConv(10, k, strides, padding if k > 1 else 0,
                         circular=True)
    params = numpy_params(jm, x, seed=2)["params"]
    mesh = jax_mesh(8)
    want = np.asarray(jsp.sharded_circular_conv2d(
        jax.device_put(jnp.asarray(x), jsp.spatial_sharding(mesh)),
        params["kernel"], params["bias"], mesh, strides=strides,
        h_pad=h_pad, w_halo=w_halo))

    conv = CircularConv(6, 10, k, stride, padding)
    conv.load_state_dict(vae_state_dict_from_jax(params), strict=True)
    xt = nhwc_to_torch(x)
    with torch.no_grad():
        got = sharded_circular_conv2d(xt, conv, port_mesh(8))
        whole = conv(xt)
    np.testing.assert_allclose(torch_to_nhwc(got), want, **TOL)
    np.testing.assert_allclose(torch_to_nhwc(whole), want, **TOL)


@pytest.fixture(scope="module")
def vae_pair():
    cfg, params = jax_vae_params(seed=30, ch_mult=(1, 2, 4))
    return cfg, params, port_vae(cfg, params)


def jax_sharded(fn, cfg, params, x, n):
    mesh = jax_mesh(n)
    return np.asarray(jax.jit(lambda v: fn(cfg, params, v, mesh))(
        jax.device_put(jnp.asarray(x), jsp.spatial_sharding(mesh))))


@pytest.mark.parametrize("shards", [4, 8])
def test_sharded_decode_matches_jax_and_the_unsharded_vae(vae_pair, shards):
    """A 4x16 latent to 16x64 at batch 2: 4 columns a shard at 4 shards, 2
    at 8, then 8 and 16 after the upsamples."""
    cfg, params, vae = vae_pair
    z = np.random.default_rng(31).standard_normal(
        (2, 4, 16, 4)).astype(np.float32)
    want = jax_sharded(jsv.sharded_vae_decode, cfg, params, z, shards)
    zt = nhwc_to_torch(z)
    with torch.no_grad():
        got = gather_azimuth(sharded_vae_decode(
            vae, shard_azimuth(zt, port_mesh(shards))), CPU)
        whole = vae.decode(zt)
    assert got.shape == (2, 2, 64, 16)
    np.testing.assert_allclose(torch_to_nhwc(got), want, **TOL)
    torch.testing.assert_close(got, whole, **TOL)


@pytest.mark.parametrize("shards", [4, 8])
def test_sharded_encode_matches_jax_and_the_unsharded_vae(vae_pair, shards):
    """16x64 images at batch 2 to moments 4x16: at 8 shards a shard is 8,
    4, then 2 columns wide through the two stride-2 downsamples."""
    cfg, params, vae = vae_pair
    x = np.random.default_rng(32).standard_normal(
        (2, 16, 64, 2)).astype(np.float32)
    want = jax_sharded(jsv.sharded_vae_encode, cfg, params, x, shards)
    xt = nhwc_to_torch(x)
    with torch.no_grad():
        got = gather_azimuth(sharded_vae_encode(
            vae, shard_azimuth(xt, port_mesh(shards))), CPU)
        whole = vae.encode_moments(xt)
    assert got.shape == (2, 8, 16, 4)
    np.testing.assert_allclose(torch_to_nhwc(got), want, **TOL)
    torch.testing.assert_close(got, whole, **TOL)


def test_quant_convs_and_channel_changes_sharded():
    """use_quant_conv: the 1x1 quant and post-quant convs and the
    nin_shortcuts of a (1, 2) VAE, sharded over 8, against the unsharded
    port VAE."""
    torch.manual_seed(33)
    vae = AutoencoderKL(VaeConfig(ch=32, ch_mult=(1, 2), z_channels=4,
                                  use_quant_conv=True)).eval()
    rng = np.random.default_rng(34)
    x = torch.from_numpy(rng.standard_normal((1, 2, 64, 8)).astype(
        np.float32))
    z = torch.from_numpy(rng.standard_normal((1, 4, 32, 4)).astype(
        np.float32))
    with torch.no_grad():
        m = gather_azimuth(sharded_vae_encode(
            vae, shard_azimuth(x, port_mesh(8))), CPU)
        d = gather_azimuth(sharded_vae_decode(
            vae, shard_azimuth(z, port_mesh(8))), CPU)
        torch.testing.assert_close(m, vae.encode_moments(x), **TOL)
        torch.testing.assert_close(d, vae.decode(z), **TOL)


def test_unsupported_configs_raise(vae_pair):
    """Where the JAX package's raise (tests/test_sharded_vae.py:91-111),
    with the same errors."""
    cfg, params, _ = vae_pair
    mesh = port_mesh(8)
    z = shard_azimuth(torch.zeros(1, 4, 32, 4), mesh)
    for bad, match in ((dict(attn_type="vanilla"), "attention"),
                       (dict(circular=False), "circular"),
                       (dict(coord=True), "coordconv"),
                       (dict(dropout=0.1), "dropout")):
        jcfg = dataclasses.replace(cfg, **bad)
        with pytest.raises(NotImplementedError, match=match):
            jsv.sharded_vae_decode(jcfg, params, jnp.zeros((1, 4, 32, 4)),
                                   jax_mesh(8))
        vae = AutoencoderKL(port_config(jcfg, VaeConfig))
        with pytest.raises(NotImplementedError, match=match):
            sharded_vae_decode(vae, z)
        with pytest.raises(NotImplementedError, match=match):
            sharded_vae_encode(vae, shard_azimuth(
                torch.zeros(1, 2, 128, 16), mesh))
    # the local width must divide by the down factor: 120 and 104 over 8
    # give 15 and 13 columns a shard
    port = vae_pair[2]
    for w in (120, 104):
        with pytest.raises(ValueError, match="down factor"):
            jsv.sharded_vae_encode(cfg, params, jnp.zeros((1, 16, w, 2)),
                                   jax_mesh(8))
        with pytest.raises(ValueError, match="down factor"):
            sharded_vae_encode(port, shard_azimuth(
                torch.zeros(1, 2, w, 16), mesh))


def test_shapes_that_do_not_map_onto_shards_raise():
    conv = CircularConv(2, 2, 3, 2, ((0, 1), (0, 1)))
    with pytest.raises(ValueError, match="does not divide"):
        shard_azimuth(torch.zeros(1, 2, 30, 4), port_mesh(4))
    with pytest.raises(ValueError, match="whole output columns"):
        sharded_circular_conv2d(torch.zeros(1, 2, 12, 4), conv,
                                port_mesh(4))        # 3 columns a shard
    with pytest.raises(ValueError, match="wider than a shard"):
        halo_exchange_w(shard_azimuth(torch.zeros(1, 2, 8, 4),
                                      port_mesh(8)), 2, 0)
    with pytest.raises(NotImplementedError, match="circular"):
        sharded_circular_conv2d(torch.zeros(1, 2, 16, 4), CircularConv(
            2, 2, 3, 1, 1, circular=False), port_mesh(4))
