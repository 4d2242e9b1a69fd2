"""The port's weight loading and entry points (rangeldm_tpu_torch/convert.py,
pipelines/pipeline.py, sample_ldm.py, pipelines/api.py) against the JAX package's, on a released
diffusers-layout pipeline directory whose UNet weights the JAX package
exported. Everything runs on the CPU, asked for explicitly."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image
from safetensors.numpy import load_file as st_load_numpy
from safetensors.torch import load_file as st_load_torch
from safetensors.torch import save_file as st_save_torch

from rangeldm_tpu.convert.export import export_unet_state_dict, save_safetensors
from rangeldm_tpu.geometry import get_spec as jax_get_spec
from rangeldm_tpu.sample_ldm import adapt_spec_to_model as jax_adapt
from rangeldm_tpu.sample_ldm import load_diffusers_pipeline as jax_load
from rangeldm_tpu.sample_ldm import save_outputs as jax_save_outputs
from test_released_pipeline import build_fake_release

from rangeldm_tpu_torch import sample_ldm
from rangeldm_tpu_torch.pipelines import pipeline
from rangeldm_tpu_torch.convert import (
    load_diffusers_unet, read_safetensors, save_diffusers_pipeline,
    write_safetensors,
)
from rangeldm_tpu_torch.geometry import get_spec
from rangeldm_tpu_torch.models.unet import UNet2D
from rangeldm_tpu_torch.pipelines import RangePipeline
from test_torch_port_common import (
    TINY_UNET, TINY_VAE, jax_unet_params, jax_vae_params, nhwc_to_torch,
    port_unet, port_vae, torch_to_nhwc,
)

TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """A released-layout directory ({unet, unet_ema, vae, scheduler}/) with
    the UNet weights written by the JAX package's exporter."""
    from rangeldm_tpu.models.unet import UNetConfig as JaxUNetConfig
    from rangeldm_tpu.models.vae import VaeConfig as JaxVaeConfig
    rng = np.random.default_rng(0)
    root = build_fake_release(tmp_path_factory.mktemp("port"), rng,
                              ucfg=JaxUNetConfig(**TINY_UNET),
                              vcfg=JaxVaeConfig(**TINY_VAE))
    _, params = jax_unet_params(seed=50)
    sd = export_unet_state_dict(params)
    for name in ("unet", "unet_ema"):
        save_safetensors(sd, os.path.join(
            root, name, "diffusion_pytorch_model.safetensors"))
    return root


def _weight_files(root):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                  for f in fs if f.endswith(".safetensors"))


def test_safetensors_reader_matches_package(release):
    files = _weight_files(release)
    assert len(files) == 3
    for path in files:
        want = st_load_numpy(path)
        got = read_safetensors(path)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_safetensors_round_trip_with_package(tmp_path):
    """Mixed dtypes and shapes (bf16, an empty tensor, a scalar) both
    ways between the port's reader/writer and the package."""
    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(3, 5, generator=g),
               "h": torch.randn(7, generator=g).to(torch.bfloat16),
               "f16": torch.randn(2, 2, generator=g).half(),
               "i": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "empty": torch.zeros(0, 4), "scalar": torch.tensor(2.5)}
    write_safetensors(tensors, str(tmp_path / "port.safetensors"))
    back = st_load_torch(str(tmp_path / "port.safetensors"))
    st_save_torch(tensors, str(tmp_path / "pkg.safetensors"))
    mine = read_safetensors(str(tmp_path / "pkg.safetensors"))
    for k, v in tensors.items():
        for other in (back[k], mine[k]):
            assert other.dtype == v.dtype and other.shape == v.shape, k
            assert torch.equal(other, v), k


def test_released_directory_loads_strictly_and_matches_jax(release):
    port = pipeline.load_diffusers_pipeline(release, dtype=torch.float32,
                                              device="cpu")
    ref = jax_load(release, dtype=jnp.float32)
    assert port["unet_cfg"].sample_size == ref["unet_cfg"].sample_size
    assert port["vae_cfg"].ch_mult == ref["vae_cfg"].ch_mult
    assert port["schedule"].cfg.prediction_type == "epsilon"
    assert port["meta"]["pos_encoding"] is True
    assert pipeline.pipe_image_size(port) == (32, 128)

    h, w = port["unet_cfg"].sample_size
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, h, w, 5)).astype(np.float32)
    t = np.array([900, 40], np.int32)
    # compiled, not op by op: eager dispatch compiles every op on its own
    want = np.asarray(jax.jit(ref["unet"].apply)(
        ref["unet_params"], jnp.asarray(x), jnp.asarray(t)))
    z = rng.standard_normal((2, h, w, 4)).astype(np.float32)
    want_img = np.asarray(jax.jit(
        lambda p, zz: ref["vae"].apply(p, zz, method="decode"))(
            ref["vae_params"], jnp.asarray(z)))
    with torch.no_grad():
        got = torch_to_nhwc(port["unet"](nhwc_to_torch(x),
                                         torch.from_numpy(t)))
        got_img = torch_to_nhwc(port["vae"].decode(nhwc_to_torch(z)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_img, want_img, **TOL)


def test_bin_fallback_loads_the_same_weights(release, tmp_path):
    d = tmp_path / "unet"
    shutil.copytree(os.path.join(release, "unet"), d)
    sd = read_safetensors(str(d / "diffusion_pytorch_model.safetensors"))
    os.remove(d / "diffusion_pytorch_model.safetensors")
    torch.save(sd, d / "diffusion_pytorch_model.bin")
    cfg, got = load_diffusers_unet(str(d))
    UNet2D(cfg).load_state_dict(got, strict=True)
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_entry_points_need_cuda_or_an_explicit_cpu(release, monkeypatch,
                                                   tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RangePipeline.from_pretrained(release)
    with pytest.raises(RuntimeError, match="CUDA"):
        RangePipeline.from_pretrained(release, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        sample_ldm.main(["--pipeline", release, "--out", str(tmp_path)])
    pipe = RangePipeline.from_pretrained(release, device="cpu")
    assert pipe.device.type == "cpu"
    assert next(pipe._p["unet"].parameters()).dtype == torch.bfloat16


@pytest.mark.parametrize("method,steps", [("ddim", 3), ("dpmpp", 2),
                                          ("ddpm", 2)])
def test_range_pipeline_on_cpu(release, tmp_path, method, steps):
    pipe = RangePipeline.from_pretrained(release, device="cpu",
                                         dtype=torch.float32)
    imgs = pipe(batch_size=2, num_inference_steps=steps, method=method,
                seed=3)
    assert imgs.shape == (2, 32, 128, 2) and imgs.dtype == np.float32
    assert np.isfinite(imgs).all()
    again = pipe(batch_size=2, num_inference_steps=steps, method=method,
                 seed=3)
    np.testing.assert_array_equal(imgs, again)
    clouds = pipe.to_point_clouds(imgs)
    assert len(clouds) == 2 and all(c.shape[1] == 4 for c in clouds)
    pipe.save_outputs(imgs, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [
        "0.bin", "0_bev.png", "0_range.png", "1.bin", "1_bev.png",
        "1_range.png"]


def test_trajectory_from_the_pipeline(release):
    pipe = RangePipeline.from_pretrained(release, device="cpu",
                                         dtype=torch.float32)
    img, traj = pipe(batch_size=1, num_inference_steps=2, final_only=False)
    assert img.shape == (1, 32, 128, 2)
    assert traj.shape == (2, 1, 32, 128, 2)


def test_save_outputs_matches_jax(tmp_path):
    """The same images written by both packages: the same clouds, and the
    same PNGs from the port's own encoder (within one grey level, as the
    BEV densities differ by f32 rounding)."""
    rng = np.random.default_rng(4)
    imgs = np.concatenate([rng.normal(0, 0.6, (2, 32, 128, 1)),
                           rng.uniform(0, 1, (2, 32, 128, 1))],
                          axis=-1).astype(np.float32)
    spec = pipeline.adapt_spec_to_model(get_spec("kitti360"), (32, 128))
    jspec = jax_adapt(jax_get_spec("kitti360"), (32, 128))
    jax_save_outputs(imgs, jspec, str(tmp_path / "jax"), 5)
    pipeline.save_outputs(torch.from_numpy(imgs), spec,
                            str(tmp_path / "port"), 5)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert names[0] == "5.bin" and len(names) == 6
    for name in names:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".bin"):
            np.testing.assert_allclose(np.fromfile(b, np.float32),
                                       np.fromfile(a, np.float32),
                                       rtol=1e-5, atol=1e-4)
        else:
            pa, pb = (np.asarray(Image.open(p)) for p in (a, b))
            assert pb.dtype == np.uint8 and pb.shape == pa.shape
            assert np.abs(pa.astype(int) - pb.astype(int)).max() <= 1


def test_cli_writes_samples_on_cpu(release, tmp_path):
    out = tmp_path / "samples"
    n = sample_ldm.main(["--pipeline", release, "--out", str(out),
                         "--samples", "3", "--batch_size", "2", "--steps",
                         "2", "--method", "dpmpp", "--timestep_spacing",
                         "trailing", "--device", "cpu"])
    assert n == 3
    assert sorted(os.listdir(out)) == sorted(
        f"{i}{s}" for i in range(3) for s in (".bin", "_bev.png",
                                              "_range.png"))
    cloud = np.fromfile(out / "2.bin", np.float32).reshape(-1, 4)
    assert len(cloud) > 0 and np.isfinite(cloud).all()
    with open(os.path.join(release, "scheduler",
                           "scheduler_config.json")) as f:
        assert json.load(f)["_class_name"] == "DDPMScheduler"


def test_pixel_space_release(tmp_path):
    """A release without vae/ samples in pixel space; `ddpm` runs through
    `ddim_sample`, and `ddpm_sample` is the same loop."""
    from rangeldm_tpu.models.unet import UNetConfig as JaxUNetConfig
    from rangeldm_tpu_torch.pipelines import samplers
    ucfg = JaxUNetConfig(**{**TINY_UNET, "sample_size": (8, 32),
                            "in_channels": 3, "out_channels": 2})
    root = build_fake_release(tmp_path, np.random.default_rng(2), ucfg=ucfg,
                              vcfg=None)
    pipe = RangePipeline.from_pretrained(root, device="cpu",
                                         dtype=torch.float32)
    imgs = pipe(batch_size=2, num_inference_steps=2, method="ddpm", seed=1)
    assert imgs.shape == (2, 8, 32, 2) and np.isfinite(imgs).all()
    with pytest.raises(ValueError, match="latent"):
        pipe(batch_size=1, num_inference_steps=2, final_only=False)

    unet, sched = pipe._p["unet"], pipe._p["schedule"]
    with torch.no_grad():
        a = samplers.ddpm_sample((unet,), sched, (2, 8, 32, 2),
                                 torch.Generator().manual_seed(4),
                                 num_steps=2, pos_encoding=True)
        b = samplers.ddim_sample((unet,), sched, (2, 8, 32, 2),
                                 torch.Generator().manual_seed(4),
                                 num_steps=2, pos_encoding=True,
                                 method="ddpm")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_written_pipeline_reads_back_in_both_packages(tmp_path):
    """`save_diffusers_pipeline` (diffusers UNet keys, sgm -> diffusers VAE
    keys, [azimuth, beams] sample_size) gives a directory that the port and
    the JAX package both load, to the same functions."""
    ucfg, uparams = jax_unet_params(seed=60)
    vcfg, vparams = jax_vae_params(seed=70)
    unet, vae = port_unet(ucfg, uparams), port_vae(vcfg, vparams)
    root = str(tmp_path / "written")
    save_diffusers_pipeline(root, unet, vae, {"prediction_type": "epsilon"})
    port = pipeline.load_diffusers_pipeline(root, dtype=torch.float32,
                                              device="cpu")
    for a, b in ((unet, port["unet"]), (vae, port["vae"])):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    ref = jax_load(root, dtype=jnp.float32)
    z = np.random.default_rng(9).standard_normal((1, 16, 64, 4)).astype(
        np.float32)
    want = np.asarray(jax.jit(
        lambda p, zz: ref["vae"].apply(p, zz, method="decode"))(
            ref["vae_params"], jnp.asarray(z)))
    with torch.no_grad():
        got = torch_to_nhwc(port["vae"].decode(nhwc_to_torch(z)))
    np.testing.assert_allclose(got, want, **TOL)
    assert ref["unet_cfg"].sample_size == ucfg.sample_size
