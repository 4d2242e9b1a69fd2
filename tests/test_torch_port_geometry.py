"""The port's geometry (rangeldm_tpu_torch/geometry/) against the JAX
package's: sensor tables, range encoding, back-projection to point clouds
and the BEV splat, on the same numpy range images. f32 on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rangeldm_tpu import geometry as jg
from rangeldm_tpu.sample_ldm import adapt_spec_to_model as jax_adapt

from rangeldm_tpu_torch import geometry as tg
from rangeldm_tpu_torch.pipelines.pipeline import adapt_spec_to_model


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _same_spec(port, ref):
    for f in dataclasses.fields(port):
        if f.name in ("height", "zenith"):
            np.testing.assert_array_equal(getattr(port, f.name),
                                          getattr(ref, f.name))
        else:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("name", ["kitti360", "nuscenes"])
def test_sensor_specs_match(name):
    _same_spec(tg.get_spec(name), jg.get_spec(name))
    _same_spec(adapt_spec_to_model(tg.get_spec(name), (16, 256)),
               jax_adapt(jg.get_spec(name), (16, 256)))
    with pytest.raises(KeyError):
        tg.get_spec("no-such-sensor")


@pytest.mark.parametrize("log,inverse", [(False, False), (True, False),
                                         (False, True)])
def test_range_encoding(log, inverse):
    spec = tg.get_spec("kitti360").replace(log=log, inverse=inverse)
    jspec = jg.get_spec("kitti360").replace(log=log, inverse=inverse)
    r = np.random.default_rng(0).uniform(0.5, 80.0, (3, 7)).astype(
        np.float32)
    enc = tg.encode_range(torch.from_numpy(r), spec)
    np.testing.assert_allclose(enc.numpy(), jg.encode_range(r, jspec),
                               rtol=1e-6)
    dec = tg.decode_range(enc, spec)
    want = np.asarray(jg.decode_range(jnp.asarray(enc.numpy()), jspec))
    np.testing.assert_allclose(dec.numpy(), want, rtol=1e-5)
    if log or inverse:      # otherwise decoding also undoes the mean/std
        np.testing.assert_allclose(dec.numpy(), r, rtol=1e-4)


def _images(seed, b, h, w):
    rng = np.random.default_rng(seed)
    rng_ch = rng.normal(0.0, 0.6, (b, h, w, 1))
    rng_ch[:, :, :8] = -1.0        # negative ranges snap to the fill value
    rng_ch[:, :2, 8:16] = 4.0      # beyond the 90 m export filter
    intensity = rng.uniform(0.0, 1.0, (b, h, w, 1))
    return np.concatenate([rng_ch, intensity], axis=-1).astype(np.float32)


@pytest.mark.parametrize("name,h,w", [("kitti360", 64, 1024),
                                      ("nuscenes", 32, 1024),
                                      ("kitti360", 32, 128)])
@pytest.mark.parametrize("channels", [1, 2])
def test_point_cloud_masked(name, h, w, channels):
    spec = adapt_spec_to_model(tg.get_spec(name), (h, w))
    jspec = jax_adapt(jg.get_spec(name), (h, w))
    imgs = _images(h + w, 2, h, w)[..., :channels]
    jpc, jvalid = jg.to_point_cloud_masked(jnp.asarray(imgs), jspec)
    pc, valid = tg.to_point_cloud_masked(torch.from_numpy(imgs), spec)
    assert pc.shape == (2, h * w, 2 + channels)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jpc), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0 < valid.sum() < valid.numel()


def test_point_cloud_bf16_keeps_f32_azimuth():
    """A bf16 image is back-projected with an f32 column table: in bf16
    the column indices 512..1023 would round to multiples of 4."""
    spec = tg.get_spec("kitti360")
    imgs = torch.from_numpy(_images(3, 1, 64, 1024)).to(torch.bfloat16)
    pc = tg.to_point_cloud(imgs, spec)
    assert pc.dtype == torch.float32
    x, y = (pc[0, :, i].double().numpy().reshape(64, 1024) for i in (0, 1))
    want = (1024 - 0.5 - np.arange(1024)) / 1024 * 2.0 * np.pi - np.pi
    err = np.angle(np.exp(1j * (np.arctan2(y, x) - want)))
    far = np.hypot(x, y) > 1.0      # the angle of a point near 0 is noise
    assert far.mean() > 0.9
    assert np.abs(err[far]).max() < 1e-5


def test_splat_points_to_volumes():
    """The trilinear splat on the same points: only the order of the sums
    differs."""
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-1.1, 1.1, (2, 5000, 3)).astype(np.float32)
    feats = rng.uniform(0.0, 1.0, (2, 5000, 1)).astype(np.float32)
    mask = rng.uniform(size=(2, 5000)) < 0.8
    grid = (4, 32, 48)
    jf, jd = jg.splat_points_to_volumes(jnp.asarray(xyz), jnp.asarray(feats),
                                        grid, mask=jnp.asarray(mask))
    tf, td = tg.splat_points_to_volumes(torch.from_numpy(xyz),
                                        torch.from_numpy(feats), grid,
                                        mask=torch.from_numpy(mask))
    assert tf.shape == (2, 1, 4 * 32 * 48) and td.shape == (2, 4 * 32 * 48, 1)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name,h,w", [("kitti360", 64, 1024),
                                      ("kitti360", 32, 128)])
def test_to_voxel(name, h, w):
    """End to end from range images. The two back-projections differ by
    f32 rounding (up to ~5e-5 m at 80 m); the grid has ~20 cells per metre,
    so splat weights move by up to ~1e-3. The mean intensity is a ratio
    that is ill-conditioned where the density is tiny, so it is compared
    where at least half a point landed."""
    spec = adapt_spec_to_model(tg.get_spec(name), (h, w))
    jspec = jax_adapt(jg.get_spec(name), (h, w))
    imgs = _images(h, 2, h, w)
    want = np.asarray(jg.to_voxel(jnp.asarray(imgs), jspec))
    got = tg.to_voxel(torch.from_numpy(imgs), spec).numpy()
    _, gy, gx = spec.grid_sizes
    assert got.shape == want.shape == (2, 2, gy, gx)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=2e-3)
    dense = want[:, 0] > np.log(1.5)
    assert dense.sum() > 100
    np.testing.assert_allclose(got[:, 1][dense], want[:, 1][dense], rtol=0,
                               atol=1e-2)
