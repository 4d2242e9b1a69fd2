"""The port's training slice (rangeldm_tpu_torch/training/, train_ldm.py,
the schedule's training functions) against the JAX package, on the CPU in
f32, with the same weights and the same random draws on both sides.

* One `make_ldm_train_step` on each side: the test re-derives the JAX step's
  draws from its key path (ldm_trainer.py:122-123, 63-65 and the posterior
  draw of models/vae.py:153-156) and hands them to the port in the
  (B, C, W, H) layout. Loss within rtol 1e-5; each gradient within 1e-4 of
  its own largest entry plus 1e-6 of the model's largest gradient (to_k.bias
  has an exact gradient of zero, so it holds rounding noise only).
* The optimizer chain, its schedules and the EMA against optax over 5 steps
  on the same gradients: parameters and EMA within 1e-6.
"""

from pathlib import Path

import numpy as np
import optax
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

from rangeldm_tpu.diffusion.schedule import Schedule as JaxSchedule
from rangeldm_tpu.diffusion.schedule import ScheduleConfig as JaxScheduleConfig
from rangeldm_tpu.models.unet import UNet2D as JaxUNet2D
from rangeldm_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from rangeldm_tpu.training import ema as jax_ema
from rangeldm_tpu.training.ldm_trainer import (
    LdmTrainConfig as JaxLdmTrainConfig,
)
from rangeldm_tpu.training.ldm_trainer import (
    make_ldm_train_step as jax_make_ldm_train_step,
)
from rangeldm_tpu.training.train_state import TrainState as JaxTrainState
from rangeldm_tpu.training.train_state import make_adamw as jax_make_adamw

from rangeldm_tpu_torch.convert import unet_state_dict_from_jax
from rangeldm_tpu_torch.diffusion.schedule import Schedule, ScheduleConfig
from rangeldm_tpu_torch.ops import kernels
from rangeldm_tpu_torch.pipelines import RangePipeline
from rangeldm_tpu_torch.training import conditions, ema
from rangeldm_tpu_torch.training.ldm_trainer import (
    LdmTrainConfig, apply_updates_and_ema, make_ldm_train_step,
    step_ema_weight,
)
from rangeldm_tpu_torch.training.train_state import TrainState, make_adamw
from test_torch_port_common import (
    jax_unet_params, jax_vae_params, nhwc_to_torch, port_unet, port_vae,
)

ROOT = Path(__file__).resolve().parent.parent
# the TINY spec of tests/test_train_e2e.py: an AttnDownBlock2D at (2, 16),
# so attention (T = 32, 4 heads) lies on the path, under an (8, 64) image
TINY_UNET = dict(sample_size=(4, 32), in_channels=5, out_channels=4,
                 block_out_channels=(32, 32),
                 down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                 up_block_types=("AttnUpBlock2D", "UpBlock2D"))
IMAGE = (8, 64)
BATCH = 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _store_grads():
    """An optax transformation that makes no update and keeps the last
    gradients as its state, so a JAX train step returns its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_draws(rng, b, latent_hw, z, k):
    """The draws of the JAX step at step 0, in (B, H, W, C): posterior
    noise, diffusion noise and timesteps."""
    key = jax.random.fold_in(rng, 0)
    rng_vae, _, rng_loss = jax.random.split(key, 3)
    h, w = latent_hw
    post = jax.random.normal(rng_vae, (b, h, w, z), jnp.float32)
    keys = [rng_loss] if k == 1 else list(jax.random.split(rng_loss, k))
    noise, ts = [], []
    for kk in keys:
        rn, rt = jax.random.split(kk)
        noise.append(jax.random.normal(rn, (b // k, h, w, z), jnp.float32))
        ts.append(jax.random.randint(rt, (b // k,), 0, 1000))
    return post, jnp.concatenate(noise), jnp.concatenate(ts)


CASES = {
    "epsilon": dict(prediction_type="epsilon"),
    "v_min_snr": dict(prediction_type="v_prediction", snr_gamma=5.0),
    "grad_accum_2": dict(prediction_type="epsilon", grad_accum_steps=2),
    "moments": dict(prediction_type="epsilon", moments=True),
    # pixel space (RangeDM): no VAE, the images shifted and scaled
    "pixel": dict(prediction_type="epsilon", pixel=True,
                  pixel_scaling=0.5, shifting_factor=0.1),
}
# the pixel case's UNet works on the (8, 64) image itself
PIXEL_UNET = dict(TINY_UNET, sample_size=IMAGE, in_channels=3,
                  out_channels=2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(case):
    opts = dict(CASES[case])
    pred = opts.pop("prediction_type")
    use_moments = opts.pop("moments", False)
    pixel = opts.pop("pixel", False)
    seed = sorted(CASES).index(case)
    ucfg, uparams = jax_unet_params(seed=30 + seed,
                                    **(PIXEL_UNET if pixel else TINY_UNET))
    vcfg, vparams = jax_vae_params(seed=40 + seed)
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((BATCH, *IMAGE, 2)).astype(np.float32)
    lat_hw = ucfg.sample_size
    z = ucfg.out_channels
    moments = rng.standard_normal((BATCH, *lat_hw, 8)).astype(np.float32)
    k = opts.get("grad_accum_steps", 1)

    # JAX
    jsched = JaxSchedule.create(JaxScheduleConfig(prediction_type=pred))
    junet = JaxUNet2D(ucfg)
    jvae = JaxAutoencoderKL(vcfg)
    step_fn = jax_make_ldm_train_step(
        lambda p, x, t: junet.apply({"params": p}, x, t), jsched,
        _store_grads(), JaxLdmTrainConfig(**opts),
        vae_apply=None if pixel else (
            lambda p, x: jvae.apply(p, x, method="encode_moments")),
        vae_params=None if pixel else {"params": vparams})
    key = jax.random.PRNGKey(seed)
    jbatch = {"moments": jnp.asarray(moments)} if use_moments \
        else jnp.asarray(images)

    @jax.jit
    def jax_step(params, batch):
        """One compile for the state, the step and the draws."""
        state = JaxTrainState.create(params, _store_grads(), with_ema=False)
        state, metrics = step_fn(state, batch, key)
        return state.opt_state, metrics, _jax_draws(key, BATCH, lat_hw, z, k)

    grads, jmetrics, (post, noise, ts) = jax.tree.map(
        np.asarray, jax_step(uparams, jbatch))
    want_grads = unet_state_dict_from_jax(grads)

    # the port, on the same weights and draws
    sched = Schedule(ScheduleConfig(prediction_type=pred))
    model = port_unet(ucfg, uparams).train()
    vae = None if pixel else port_vae(vcfg, vparams).requires_grad_(False)
    state = TrainState.create(model, make_adamw(model.parameters(),
                                                grad_clip=1e9),
                              with_ema=False)
    step = make_ldm_train_step(sched, LdmTrainConfig(**opts), vae)
    batch = {"moments": nhwc_to_torch(moments)} if use_moments \
        else nhwc_to_torch(images)
    metrics = step(state, batch, noise=nhwc_to_torch(noise),
                   timesteps=torch.from_numpy(ts.astype(np.int64)),
                   posterior_noise=nhwc_to_torch(post))
    assert state.step == 1

    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=1e-5)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want_grads)
    floor = 1e-6 * max(np.abs(g.numpy()).max() for g in want_grads.values())
    for name, g in got.items():
        ref = want_grads[name].numpy()
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + floor, (name, err)


def test_train_step_raises_on_conditional_training():
    """Conditional training is ported (tests/test_torch_port_conditional.py);
    a conditional step raises on a batch that lacks its condition: a bare
    image batch, or a dict without the condition's input."""
    step = make_ldm_train_step(Schedule(), LdmTrainConfig(pos_encoding=False),
                               cond_fn=conditions.make_upsample_cond_fn(4))
    images = torch.zeros((2, 2, 64, 16))
    with pytest.raises(ValueError, match="batch dict"):
        step(None, images)
    with pytest.raises(KeyError, match="down"):
        step(None, {"jpg": images})


PARAM_SHAPES = [(8, 4), (16,), (3, 3, 2, 2)]


@pytest.mark.parametrize("norm", [3.0, 0.5])
@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_optimizer_and_ema_match_optax(schedule, norm):
    """5 updates with gradients of global norm 3 (clipped) or 0.5 (not):
    learning rate 0 at the first update (warm-up 2), AdamW with weight
    decay, the EMA at the pre-increment step."""
    rng = np.random.default_rng(int(norm * 10))
    params = [rng.standard_normal(s).astype(np.float32) for s in PARAM_SHAPES]
    grads = []
    for _ in range(5):
        g = [rng.standard_normal(s).astype(np.float32) for s in PARAM_SHAPES]
        scale = norm / np.sqrt(sum(float((u ** 2).sum()) for u in g))
        grads.append([(u * scale).astype(np.float32) for u in g])
    hyper = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6,
                 schedule=schedule, weight_decay=0.1)
    cfg = LdmTrainConfig()

    tx = jax_make_adamw(**hyper)
    jp = [jnp.asarray(u) for u in params]
    opt_state = tx.init(jp)
    jema = list(jp)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update([jnp.asarray(u) for u in g],
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        decay = jax_ema.power_decay(jnp.asarray(i), cfg.ema_inv_gamma,
                                    cfg.ema_power,
                                    max_decay=cfg.ema_max_decay)
        jema = jax_ema.ema_update(jema, jp, decay)

    model = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(u.copy())) for u in params])
    state = TrainState.create(model, make_adamw(model.parameters(), **hyper))
    for g in grads:
        for p, u in zip(model, g):
            p.grad = torch.from_numpy(u.copy())
        state.set_learning_rate()
        out = apply_updates_and_ema(state, torch.zeros(()),
                                    step_ema_weight(state.step, cfg))
        state.step += 1
        np.testing.assert_allclose(float(out["grad_norm"]), norm, rtol=1e-5)
    assert state.step == 5
    for p, e, want_p, want_e in zip(model, state.ema, jp, jema):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want_p),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(e.numpy(), np.asarray(want_e), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedules_match_optax(schedule, warmup):
    jax_lr = jax_make_adamw(learning_rate=2e-3, warmup_steps=warmup,
                            total_steps=10, schedule=schedule)
    # the learning rate optax applies at each count: the last link of the
    # chain is adamw's scale_by_learning_rate, whose state counts updates
    p = [jnp.ones(3)]
    state = jax_lr.init(p)
    tx = make_adamw([torch.nn.Parameter(torch.ones(3))], learning_rate=2e-3,
                    warmup_steps=warmup, total_steps=10, schedule=schedule)
    for count in range(13):
        upd, state = jax_lr.update([jnp.zeros(3)], state, p)
        # with zero gradients and moments, the update is -lr * wd * p
        want = -float(upd[0][0]) / 1e-6
        np.testing.assert_allclose(tx.schedule(count), want, rtol=1e-5,
                                   atol=1e-12)


@pytest.mark.parametrize("step", [0, 1, 2, 10, 1000, 10 ** 7])
def test_ema_decays_match_jax(step):
    np.testing.assert_allclose(
        ema.power_decay(step), float(jax_ema.power_decay(jnp.asarray(step))),
        rtol=1e-7)
    np.testing.assert_allclose(
        ema.warmup_decay(step),
        float(jax_ema.warmup_decay(jnp.asarray(step))), rtol=1e-7)


@pytest.mark.parametrize("velocity", [False, True])
def test_schedule_training_functions_match_jax(velocity):
    rng = np.random.default_rng(int(velocity))
    x0, noise = (rng.standard_normal((6, 4, 5, 3)).astype(np.float32)
                 for _ in range(2))
    t = np.array([0, 1, 250, 500, 998, 999], np.int32)
    js = JaxSchedule.create(JaxScheduleConfig())
    ts = Schedule(ScheduleConfig())
    tt = torch.from_numpy(t.astype(np.int64))
    # alphas_cumprod of the two differ by up to 1e-5 relative (another
    # product order; tests/test_torch_port_sampling.py)
    for got, want in [
            (ts.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), tt),
             js.add_noise(x0, noise, t)),
            (ts.get_velocity(torch.from_numpy(x0), torch.from_numpy(noise),
                             tt), js.get_velocity(x0, noise, t)),
            (ts.snr(tt), js.snr(t)),
            (ts.min_snr_weight(tt, 5.0, velocity),
             js.min_snr_weight(t, 5.0, velocity))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-6)


TRAIN_CFG = {
    "model_config": {"sample_size": [32, 4], "in_channels": 5,
                     "out_channels": 4, "block_out_channels": [32, 32],
                     "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
                     "up_block_types": ["AttnUpBlock2D", "UpBlock2D"]},
    "vae_config": {"ch": 32, "ch_mult": [1, 2], "z_channels": 4},
    "train_batch_size": 4, "lr_warmup_steps": 1, "csv_log": True,
}


def test_trainer_fits_saves_and_reloads_on_the_cpu(tmp_path):
    from rangeldm_tpu_torch.train_ldm import LdmTrainer
    cfg = dict(TRAIN_CFG, output_dir=str(tmp_path / "run"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LdmTrainer(cfg)
    tr = LdmTrainer(cfg, device="cpu")
    before = [p.detach().clone() for p in tr.unet.parameters()]
    rng = np.random.default_rng(0)
    batches = ({"jpg": rng.standard_normal((4, *IMAGE, 2))
                .astype(np.float32)} for _ in range(5))
    launches = dict(kernels.LAUNCHES)
    last = tr.fit(batches, max_steps=3, log_every=2)
    assert kernels.LAUNCHES == launches      # the CPU runs no kernel
    assert last["step"] == 3 and np.isfinite(last["loss"])
    assert tr.state.step == 3
    assert all(not torch.equal(a, b) for a, b in
               zip(before, tr.unet.parameters()))
    assert all(not torch.equal(a, e) for a, e in zip(before, tr.state.ema))
    log = (tmp_path / "run" / "train_log.jsonl").read_text().splitlines()
    assert len(log) == 2          # steps 2 and 3
    assert (tmp_path / "run" / "metrics.csv").exists()

    path = tr.save_final()
    for d in ("unet", "unet_ema", "vae", "scheduler"):
        assert (Path(path) / d).is_dir(), d
    pipe = RangePipeline.from_pretrained(path, device="cpu",
                                         dtype=torch.float32)
    ema_sd = tr.state.ema_state_dict()
    for name, p in pipe._p["unet"].named_parameters():
        assert torch.equal(p, ema_sd[name]), name
    images = pipe(batch_size=2, num_inference_steps=2)
    assert images.shape == (2, *IMAGE, 2) and np.isfinite(images).all()

    # a later run takes the saved VAE as its frozen encoder
    again = LdmTrainer(dict(cfg, vae_checkpoint=path, seed=1), device="cpu")
    for (name, a), b in zip(tr.vae.state_dict().items(),
                            again.vae.state_dict().values()):
        assert torch.equal(a, b), name
    assert not again.vae.training and not any(
        p.requires_grad for p in again.vae.parameters())


def test_chip_smoke_trains_the_shipped_flagship_config():
    """chip_smoke.py's inline training config is the shipped YAML with only
    the warm-up (so the parameters move within 10 steps) and the output
    directory changed; the script itself cannot read YAML on the card."""
    import chip_smoke
    shipped = yaml.safe_load(
        (ROOT / "rangeldm_tpu" / "configs" / "rangeldm_kitti360.yaml")
        .read_text())
    inline = dict(chip_smoke.TRAIN_CFG)
    assert inline.pop("lr_warmup_steps") == 2
    assert inline.pop("output_dir") is None
    shipped.pop("lr_warmup_steps")
    shipped.pop("output_dir")
    assert inline == shipped
