"""The port's conditional slice against the JAX package, on the CPU in f32
with the same weights and the same random draws on both sides:

* the conditions (training/conditions.py, `pixel_unshuffle_azimuth`):
  the unshuffle and the mask resize bit-exact, the masked image's encode
  within 5e-4 with the JAX posterior draw;
* DDIM-50 and DPM-Solver++-20 chains with either condition plus the decode
  within 1e-3 of JAX `denoise(cond=...)` (tests/test_released_rehearsal.py);
* a conditional train step: loss within rtol 1e-5, every gradient within
  1e-4 of its own largest entry plus 1e-6 of the model's largest gradient
  (the bounds of tests/test_torch_port_training.py);
* the MAE metrics equal;
* `RangePipeline.upsample` / `.inpaint`, `sample_conditional.main` and
  `LdmTrainer` on conditional configs, run on the CPU at a toy size.

The toy models keep the shipped conditional grammar: a VAE with a down
factor of 4 over a 64-beam image, and UNets with 12 (upsample) and 9
(inpainting) input channels, at narrow widths and two levels.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml
import jax
import jax.numpy as jnp
import optax

from rangeldm_tpu.diffusion.schedule import Schedule as JaxSchedule
from rangeldm_tpu.diffusion.schedule import ScheduleConfig as JaxScheduleConfig
from rangeldm_tpu.metrics import mae as jax_mae
from rangeldm_tpu.models.layers import (
    pixel_unshuffle_azimuth as jax_unshuffle,
)
from rangeldm_tpu.models.unet import UNet2D as JaxUNet2D
from rangeldm_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from rangeldm_tpu.pipelines import samplers as jax_samplers
from rangeldm_tpu.training import conditions as jax_conditions
from rangeldm_tpu.training.ldm_trainer import (
    LdmTrainConfig as JaxLdmTrainConfig,
)
from rangeldm_tpu.training.ldm_trainer import (
    make_ldm_train_step as jax_make_ldm_train_step,
)
from rangeldm_tpu.training.train_state import TrainState as JaxTrainState

from conftest import synthetic_scan
from rangeldm_tpu_torch import sample_conditional
from rangeldm_tpu_torch.convert import (
    save_diffusers_pipeline, unet_state_dict_from_jax,
)
from rangeldm_tpu_torch.data.datasets import (
    DatasetConfig, RangeImageDataset, RangeLoader,
)
from rangeldm_tpu_torch.diffusion.schedule import Schedule, ScheduleConfig
from rangeldm_tpu_torch.metrics import mae
from rangeldm_tpu_torch.models.layers import (
    PixelUnshuffleAzimuth, pixel_unshuffle_azimuth,
)
from rangeldm_tpu_torch.ops import kernels
from rangeldm_tpu_torch.pipelines import RangePipeline
from rangeldm_tpu_torch.pipelines.samplers import conditional_latent_sample
from rangeldm_tpu_torch.training import conditions
from rangeldm_tpu_torch.training.ldm_trainer import (
    LdmTrainConfig, make_ldm_train_step,
)
from rangeldm_tpu_torch.training.train_state import TrainState, make_adamw
from test_torch_port_common import (
    jax_unet_params, jax_vae_params, nhwc_to_torch, port_unet, port_vae,
    torch_to_nhwc,
)

ROOT = Path(__file__).resolve().parent.parent
CHAIN_TOL = dict(rtol=1e-3, atol=1e-3)
MODES = ("upsample", "inpainting")
COND_UNET = dict(sample_size=(16, 32), out_channels=4,
                 block_out_channels=(32, 32), layers_per_block=1,
                 down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                 up_block_types=("AttnUpBlock2D", "UpBlock2D"))
IN_CHANNELS = {"upsample": 12, "inpainting": 9}
COND_VAE = dict(ch_mult=(1, 2, 2), num_res_blocks=1)
IMAGE = (64, 128)          # the VAE's down factor 4 -> the (16, 32) latent
FACTOR = 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    """JAX params and port modules of the two conditional UNets and their
    VAE."""
    vcfg, vparams = jax_vae_params(seed=50, **COND_VAE)
    jvae = JaxAutoencoderKL(vcfg)
    out = dict(vcfg=vcfg, vparams=vparams, vae=port_vae(vcfg, vparams),
               jax_decode=jax.jit(lambda z: jvae.apply(
                   {"params": vparams}, z, method="decode")))
    for i, mode in enumerate(MODES):
        ucfg, uparams = jax_unet_params(seed=60 + i,
                                        in_channels=IN_CHANNELS[mode],
                                        **COND_UNET)
        # one jitted apply per model: the chains of both samplers trace it
        # once
        out[mode] = dict(ucfg=ucfg, uparams=uparams,
                         unet=port_unet(ucfg, uparams),
                         jax_apply=jax.jit(JaxUNet2D(ucfg).apply))
    return out


def _cond_inputs(seed, batch=2, image=IMAGE):
    """Seeded numpy condition inputs in the loader's layout, as the
    dataset derives them from an image."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((batch, *image, 2)).astype(np.float32)
    mask = -np.ones((batch, *image, 1), np.float32)
    mask[:, :, :image[1] // 8] = 1.0
    return {"jpg": img, "down": img[:, FACTOR // 2::FACTOR],
            "masked_image": np.where(mask > 0, -1.0, img).astype(np.float32),
            "inpainting_mask": mask}


def test_pixel_unshuffle_is_bit_exact():
    x = np.random.default_rng(0).standard_normal((2, 16, 128, 2)).astype(
        np.float32)
    want = np.asarray(jax_unshuffle(jnp.asarray(x), FACTOR))
    got = pixel_unshuffle_azimuth(nhwc_to_torch(x), FACTOR)
    np.testing.assert_array_equal(torch_to_nhwc(got), want)
    np.testing.assert_array_equal(
        torch_to_nhwc(PixelUnshuffleAzimuth(FACTOR)(nhwc_to_torch(x))), want)


@pytest.mark.parametrize("src,dst", [((16, 64), (4, 16)),
                                     ((64, 1024), (16, 256)),
                                     ((64, 128), (16, 32))])
def test_nearest_exact_resize_is_bit_exact(src, dst):
    """The mask resize of the inpainting condition: random values, so that
    every picked pixel is checked."""
    x = np.random.default_rng(1).standard_normal((2, *src, 1)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 1),
                                       method="nearest"))
    got = F.interpolate(nhwc_to_torch(x), size=dst[::-1],
                        mode="nearest-exact")
    np.testing.assert_array_equal(torch_to_nhwc(got), want)


@pytest.mark.parametrize("mode", MODES)
def test_conditions_match_jax(models, mode):
    """The training condition of each mode and the sampling-time masked
    image encode, with JAX's posterior draw fed to the port."""
    m = models
    sf = m["vcfg"].scaling_factor
    jvae, vp = JaxAutoencoderKL(m["vcfg"]), {"params": m["vparams"]}
    inputs = _cond_inputs(2)
    batch = {k: nhwc_to_torch(v) for k, v in inputs.items()}
    key = jax.random.PRNGKey(3)
    lh, lw = IMAGE[0] // FACTOR, IMAGE[1] // FACTOR
    eps = np.asarray(jax.random.normal(key, (2, lh, lw, 4), jnp.float32))
    if mode == "upsample":
        want = jax_conditions.make_upsample_cond_fn(FACTOR)(
            {k: jnp.asarray(v) for k, v in inputs.items()}, key)
        got = conditions.make_upsample_cond_fn(FACTOR)(batch)
        np.testing.assert_array_equal(torch_to_nhwc(got), np.asarray(want))
        return
    train_fn = jax_conditions.make_inpainting_cond_fn(jvae, vp, sf, (lh, lw))

    @jax.jit
    def jax_conds(inp):
        return train_fn(inp, key), jax_conditions.encode_masked_image_cond(
            jvae, vp, sf, inp["masked_image"], inp["inpainting_mask"], key)

    want, want_inf = (np.asarray(v) for v in jax_conds(
        {k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        got = conditions.make_inpainting_cond_fn(m["vae"], sf, (lh, lw))(
            batch, posterior_noise=nhwc_to_torch(eps))
        got_inf = conditions.encode_masked_image_cond(
            m["vae"], sf, batch["masked_image"], batch["inpainting_mask"],
            posterior_noise=nhwc_to_torch(eps))
    for g, w in ((got, want), (got_inf, want_inf)):
        g = torch_to_nhwc(g)
        assert g.shape == w.shape == (2, lh, lw, 5)
        np.testing.assert_allclose(g[..., :4], w[..., :4], rtol=0, atol=5e-4)
        np.testing.assert_array_equal(g[..., 4], w[..., 4])
        assert set(np.unique(g[..., 4])) == {-1.0, 1.0}


@pytest.mark.parametrize("method,steps", [("ddim", 50), ("dpmpp", 20)])
@pytest.mark.parametrize("mode", MODES)
def test_conditional_chain_matches_jax(models, mode, method, steps):
    """A whole conditional chain from the same x_T with each side's own
    condition (the same posterior draw), then the decode."""
    m, u = models, models[mode]
    sf = m["vcfg"].scaling_factor
    h, w = COND_UNET["sample_size"]
    shape = (1, h, w, 4)
    inputs = _cond_inputs(10 + steps, batch=1)
    x_t = np.random.default_rng(steps).standard_normal(shape).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    eps = np.asarray(jax.random.normal(key, shape, jnp.float32))
    jvae, vp = JaxAutoencoderKL(m["vcfg"]), {"params": m["vparams"]}
    jschedule = JaxSchedule.create(JaxScheduleConfig())

    @jax.jit
    def jax_chain(x, inp):
        if mode == "upsample":
            cond = jax_unshuffle(inp["down"], FACTOR)
        else:
            cond = jax_conditions.encode_masked_image_cond(
                jvae, vp, sf, inp["masked_image"], inp["inpainting_mask"],
                key)
        return jax_samplers.denoise(
            lambda v, t: u["jax_apply"]({"params": u["uparams"]}, v, t),
            jschedule, x, steps, jax.random.PRNGKey(0), method=method,
            cond=cond)

    want_z = jax_chain(jnp.asarray(x_t),
                       {k: jnp.asarray(v) for k, v in inputs.items()})
    want_img = np.asarray(m["jax_decode"](want_z / sf))
    want_z = np.asarray(want_z)

    batch = {k: nhwc_to_torch(v) for k, v in inputs.items()}
    schedule = Schedule(ScheduleConfig())
    with torch.no_grad():
        if mode == "upsample":
            cond = pixel_unshuffle_azimuth(batch["down"], FACTOR)
        else:
            cond = conditions.encode_masked_image_cond(
                m["vae"], sf, batch["masked_image"], batch["inpainting_mask"],
                posterior_noise=nhwc_to_torch(eps))
        seen = []

        def decode(z):        # keeps the chain's last latents
            seen.append(z * sf)
            return m["vae"].decode(z)

        got_img = conditional_latent_sample(
            (u["unet"],), (decode,), schedule, shape, sf, (cond,),
            num_steps=steps,
            method=method, noise=torch.from_numpy(x_t))
    np.testing.assert_allclose(torch_to_nhwc(seen[0]), want_z, **CHAIN_TOL)
    assert got_img.shape == (1, *IMAGE, 2)
    np.testing.assert_allclose(got_img.numpy(), want_img, **CHAIN_TOL)


@pytest.mark.parametrize("encoding", ["log", "linear", "none"])
def test_mae_metrics_equal_jax(encoding):
    rng = np.random.default_rng(7)
    res, tgt = (rng.uniform(0.1, 0.9, (3, 16, 32)).astype(np.float32)
                for _ in range(2))
    kw = dict(encoding=encoding, mean=20.0, std=40.0)
    assert (mae.densification_mae(res, tgt, factor=4, **kw)
            == jax_mae.densification_mae(res, tgt, factor=4, **kw))
    assert (mae.inpainting_mae(res, tgt, masked_columns=8, **kw)
            == jax_mae.inpainting_mae(res, tgt, masked_columns=8, **kw))
    assert (mae.densification_mae(res, tgt, encoding="none")
            == jax_mae.densification_mae(res, tgt, decode_log=False))
    assert (mae.densification_mae(res, tgt)
            == jax_mae.densification_mae(res, tgt))
    labels = [rng.integers(0, 5, (4, 16, 32)) for _ in range(2)]
    assert (mae.segmentation_iou(*labels)
            == jax_mae.segmentation_iou(*labels))
    assert (mae.segmentation_accuracy(*labels)
            == jax_mae.segmentation_accuracy(*labels))


def _store_grads():
    """An optax transformation that makes no update and keeps the last
    gradients as its state, so a JAX train step returns its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_draws(rng, b, latent_hw, k):
    """The draws of the JAX step at step 0, in (B, H, W, C): the latents'
    posterior noise, the condition's, diffusion noise and timesteps."""
    rng_vae, rng_cond, rng_loss = jax.random.split(jax.random.fold_in(rng, 0),
                                                   3)
    shape = (b, *latent_hw, 4)
    post, cond_post = (jax.random.normal(r, shape, jnp.float32)
                       for r in (rng_vae, rng_cond))
    keys = [rng_loss] if k == 1 else list(jax.random.split(rng_loss, k))
    noise, ts = [], []
    for kk in keys:
        rn, rt = jax.random.split(kk)
        noise.append(jax.random.normal(rn, (b // k, *latent_hw, 4),
                                       jnp.float32))
        ts.append(jax.random.randint(rt, (b // k,), 0, 1000))
    return post, cond_post, jnp.concatenate(noise), jnp.concatenate(ts)


@pytest.mark.parametrize("mode,k", [("upsample", 1), ("inpainting", 2)])
def test_conditional_train_step_matches_jax(models, mode, k):
    m, u = models, models[mode]
    sf = m["vcfg"].scaling_factor
    image = (16, 64)            # a (4, 16) latent: the UNet is convolutional
    latent_hw = (image[0] // FACTOR, image[1] // FACTOR)
    inputs = _cond_inputs(20 + k, batch=4, image=image)
    keys = ("down",) if mode == "upsample" else (
        "masked_image", "inpainting_mask")
    inputs = {kk: inputs[kk] for kk in keys}
    # the latents from posterior moments (the encode of 'jpg' is the
    # unconditional tests'); the inpainting condition encodes its image
    inputs["moments"] = np.random.default_rng(k).standard_normal(
        (4, *latent_hw, 8)).astype(np.float32)

    jvae = JaxAutoencoderKL(m["vcfg"])
    vp = {"params": m["vparams"]}
    jcond = (jax_conditions.make_upsample_cond_fn(FACTOR)
             if mode == "upsample" else
             jax_conditions.make_inpainting_cond_fn(jvae, vp, sf, latent_hw))
    junet = JaxUNet2D(u["ucfg"])
    step_fn = jax_make_ldm_train_step(
        lambda p, x, t: junet.apply({"params": p}, x, t),
        JaxSchedule.create(JaxScheduleConfig()), _store_grads(),
        JaxLdmTrainConfig(pos_encoding=False, grad_accum_steps=k),
        vae_apply=lambda p, x: jvae.apply(p, x, method="encode_moments"),
        vae_params=vp, cond_fn=jcond)
    key = jax.random.PRNGKey(k)

    @jax.jit
    def jax_step(params, batch):
        """One compile for the state, the step and the draws."""
        state = JaxTrainState.create(params, _store_grads(), with_ema=False)
        state, metrics = step_fn(state, batch, key)
        return state.opt_state, metrics, _jax_draws(key, 4, latent_hw, k)

    grads, jmetrics, draws = jax.tree.map(np.asarray, jax_step(
        u["uparams"], {kk: jnp.asarray(v) for kk, v in inputs.items()}))
    want_grads = unet_state_dict_from_jax(grads)
    post, cond_post, noise, ts = draws

    model = port_unet(u["ucfg"], u["uparams"]).train()
    vae = m["vae"].requires_grad_(False)
    state = TrainState.create(model, make_adamw(model.parameters(),
                                                grad_clip=1e9),
                              with_ema=False)
    cond_fn = (conditions.make_upsample_cond_fn(FACTOR)
               if mode == "upsample" else
               conditions.make_inpainting_cond_fn(vae, sf, latent_hw))
    step = make_ldm_train_step(
        Schedule(ScheduleConfig()),
        LdmTrainConfig(pos_encoding=False, grad_accum_steps=k), vae,
        cond_fn=cond_fn)
    metrics = step(state, {kk: nhwc_to_torch(v) for kk, v in inputs.items()},
                   noise=nhwc_to_torch(noise),
                   timesteps=torch.from_numpy(ts.astype(np.int64)),
                   posterior_noise=nhwc_to_torch(post),
                   cond_posterior_noise=nhwc_to_torch(cond_post))
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want_grads)
    floor = 1e-6 * max(np.abs(g.numpy()).max() for g in want_grads.values())
    for name, g in got.items():
        ref = want_grads[name].numpy()
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + floor, (name, err)
    # conv_in's condition columns carry gradient: the condition reached it
    cond_cols = got["conv_in.weight"][:, 4:]
    assert cond_cols.abs().max() > 0


# -- the entry points, at the toy size on the CPU -------------------------

@pytest.fixture(scope="module")
def pipelines(models, tmp_path_factory):
    """A saved diffusers-layout pipeline directory per mode."""
    root = tmp_path_factory.mktemp("cond_pipes")
    paths = {}
    for mode in MODES:
        paths[mode] = str(root / mode)
        save_diffusers_pipeline(paths[mode], models[mode]["unet"],
                                models["vae"], {"prediction_type": "epsilon"})
    return paths


def _kitti_root(path, scans=4, n=6000):
    """Scans in the held-out drive (the sampling CLI's split) and a train
    drive."""
    rng = np.random.default_rng(0)
    for drive in ("0000_sync", "0003_sync"):
        d = (path / "data_3d_raw" / f"2013_05_28_drive_{drive}"
             / "velodyne_points" / "data")
        d.mkdir(parents=True)
        for i in range(scans):
            synthetic_scan(rng, n=n).tofile(d / f"{i:010d}.bin")
    return str(path)


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_conditional_methods_on_the_cpu(pipelines, mode):
    pipe = RangePipeline.from_pretrained(pipelines[mode], device="cpu",
                                         dtype=torch.float32)
    assert pipe.is_latent and pipe.vae_down_factor == FACTOR
    assert pipe.unet_config.in_channels == IN_CHANNELS[mode]
    assert pipe.cond_channels == IN_CHANNELS[mode] - 4
    with pytest.raises(ValueError, match=r"\.upsample\(\) / \.inpaint\(\)"):
        pipe(batch_size=1, num_inference_steps=1)
    inputs = _cond_inputs(30)
    launches = dict(kernels.LAUNCHES)
    if mode == "upsample":
        run = lambda seed: pipe.upsample(  # noqa: E731
            inputs["down"], num_inference_steps=2, seed=seed)
        with pytest.raises(ValueError, match="condition channels"):
            pipe.upsample(inputs["down"], num_inference_steps=1, factor=2)
    else:
        run = lambda seed: pipe.inpaint(  # noqa: E731
            inputs["masked_image"], inputs["inpainting_mask"],
            num_inference_steps=2, seed=seed, method="dpmpp")
    a, b, c = run(0), run(0), run(1)
    assert kernels.LAUNCHES == launches       # the CPU runs no kernel
    assert a.shape == (2, *IMAGE, 2) and a.dtype == np.float32
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("mode", MODES)
def test_sample_conditional_cli_writes_triplets(pipelines, tmp_path, mode):
    root = _kitti_root(tmp_path / "kitti")
    out = tmp_path / "out"
    argv = ["--pipeline", pipelines[mode], "--mode", mode, "--data", root,
            "--out", str(out), "--samples", "3", "--batch_size", "2",
            "--steps", "2"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sample_conditional.main(argv)
    assert sample_conditional.main(argv + ["--device", "cpu"]) == 3
    prefix = "densification" if mode == "upsample" else "inpainting"
    arrays = {}
    for sub in ("result", "target", "input"):
        d = out / f"{prefix}_{sub}"
        assert sorted(p.name for p in d.iterdir()) == ["0.npy", "1.npy",
                                                        "2.npy"]
        arrays[sub] = np.stack([np.load(d / f"{i}.npy") for i in range(3)])
    assert arrays["result"].shape == arrays["target"].shape == (3, *IMAGE, 2)
    assert arrays["input"].shape == ((3, IMAGE[0] // FACTOR, IMAGE[1], 2)
                                     if mode == "upsample"
                                     else (3, *IMAGE, 2))
    assert np.isfinite(arrays["result"]).all()
    res, tgt = arrays["result"][..., 0], arrays["target"][..., 0]
    if mode == "upsample":
        scores = mae.densification_mae(res, tgt, encoding="linear")
        assert all(np.isfinite(v) for v in scores.values())
    else:
        assert np.isfinite(mae.inpainting_mae(res, tgt, masked_columns=8,
                                              encoding="linear"))


def _trainer_cfg(mode, out_dir, data_root):
    return {
        "model": f"toy_{mode}", "output_dir": out_dir,
        "model_config": {"sample_size": [32, 16],
                         "in_channels": IN_CHANNELS[mode], "out_channels": 4,
                         "block_out_channels": [32, 32],
                         "layers_per_block": 1,
                         "down_block_types": ["DownBlock2D",
                                              "AttnDownBlock2D"],
                         "up_block_types": ["AttnUpBlock2D", "UpBlock2D"]},
        "vae_config": {"ch": 32, "ch_mult": [1, 2, 2], "z_channels": 4,
                       "num_res_blocks": 1},
        "pos_encoding": False, "lr_warmup_steps": 1,
        "data": {"root": data_root, "width": IMAGE[1]},
        "upsample": FACTOR if mode == "upsample" else None,
        "inpainting": 0.0625 if mode == "inpainting" else None,
    }


@pytest.mark.parametrize("mode", MODES)
def test_trainer_fits_conditional_configs_on_the_cpu(tmp_path, mode):
    """LdmTrainer on a conditional config, fed by the port's RangeLoader,
    then save_final and the reloaded pipeline's conditional method."""
    from rangeldm_tpu_torch.train_ldm import LdmTrainer
    root = _kitti_root(tmp_path / "kitti")
    cfg = _trainer_cfg(mode, str(tmp_path / "run"), root)
    tr = LdmTrainer(cfg, device="cpu")
    assert tr.spec.cond_channels == IN_CHANNELS[mode] - 4
    assert tr.cond_fn is not None
    ds = RangeImageDataset(DatasetConfig(
        root=root, width=IMAGE[1], downsample=cfg["upsample"],
        inpainting=cfg["inpainting"]))
    loader = RangeLoader(ds, batch_size=2, seed=0, num_threads=2)
    before = [p.detach().clone() for p in tr.unet.parameters()]
    last = tr.fit(loader, max_steps=2, log_every=1, loader=loader)
    assert last["step"] == 2 and np.isfinite(last["loss"])
    assert 0.0 <= last["data_wait_frac"] <= 1.0
    assert all(not torch.equal(a, b)
               for a, b in zip(before, tr.unet.parameters()))

    pipe = RangePipeline.from_pretrained(tr.save_final(), device="cpu",
                                         dtype=torch.float32)
    assert pipe.cond_channels == IN_CHANNELS[mode] - 4
    batch = next(iter(RangeLoader(ds, batch_size=2, shuffle=False)))
    out = (pipe.upsample(batch["down"], num_inference_steps=2)
           if mode == "upsample" else
           pipe.inpaint(batch["masked_image"], batch["inpainting_mask"],
                        num_inference_steps=2))
    assert out.shape == (2, *IMAGE, 2) and np.isfinite(out).all()


def test_trainer_rejects_an_upsample_factor_off_the_vae(tmp_path):
    from rangeldm_tpu_torch.train_ldm import LdmTrainer
    cfg = _trainer_cfg("upsample", str(tmp_path / "run"), "")
    with pytest.raises(ValueError, match="VAE down factor"):
        LdmTrainer(dict(cfg, upsample=2), device="cpu")


@pytest.mark.parametrize("name,yaml_name", [("UPSAMPLE_CFG", "upsample"),
                                            ("INPAINT_CFG", "inpainting")])
def test_chip_smoke_conditional_configs_are_the_shipped_yamls(name,
                                                              yaml_name):
    """chip_smoke.py's inline conditional configs are the shipped YAMLs
    but for a 2-step warm-up, and output_dir and data.root set at run
    time; the script cannot read YAML on the card."""
    import chip_smoke
    shipped = yaml.safe_load(
        (ROOT / "rangeldm_tpu" / "configs" / f"{yaml_name}.yaml")
        .read_text())
    inline = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in getattr(chip_smoke, name).items()}
    assert inline.pop("lr_warmup_steps") == 2
    assert inline.pop("output_dir") is None
    assert inline["data"].pop("root") is None
    shipped.pop("output_dir")
    shipped["data"].pop("root")
    assert inline == shipped
