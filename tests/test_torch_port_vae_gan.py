"""The port's VAE-GAN modules (models/discriminator.py, models/lpips.py,
training/vae_trainer.py, the sgm checkpoint reader and `instantiate`)
against the JAX package, on the CPU in f32.

Weights start on one side and are carried across: the VAE's from the
seeded sgm state dict of tests/test_convert.py, the discriminators' and
the perceptual networks' from the port's seeded init (JAX reads the
perceptual networks from the same torch checkpoint file; the port's
`vae_gan_state_from_jax` then carries the whole JAX train state back).
The port's steps are given the JAX side's own posterior noise, drawn from
its folded keys (vae_trainer.py:193, 343-348).

Bounds: discriminator logits and MetaKernel outputs 5e-4 max-abs (a
forward, as ROADMAP sets it); running statistics 1e-5; scalar metrics
within 2e-4 of their own size (d_weight 1e-3: a ratio of two gradient
norms); parameters after one Adam step within 1e-6 (an Adam update is
lr * g / (|g| + eps), the gradient's sign times lr wherever |g| >> eps);
the EMA, a convex mix of those, the same.
"""

import dataclasses
import functools
import re

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from rangeldm_tpu.convert.sgm_vae import convert_sgm_vae_state_dict
from rangeldm_tpu.convert.sgm_vae import load_sgm_vae as jax_load_sgm_vae
from rangeldm_tpu.geometry import get_spec as jax_get_spec
from rangeldm_tpu.geometry import to_voxel as jax_to_voxel
from rangeldm_tpu.models import discriminator as jdisc
from rangeldm_tpu.models.lpips import make_perceptual_fn as jax_perceptual
from rangeldm_tpu.models.vae import AutoencoderKL as JaxVae
from rangeldm_tpu.training import vae_trainer as jvt
from test_convert import make_sgm_vae_state_dict

from chip_smoke import adam_update_mismatches
from rangeldm_tpu_torch.convert import (
    disc_state_dict_from_jax, load_sgm_vae, load_torch_state_dict,
    vae_gan_state_from_jax,
)
from rangeldm_tpu_torch.geometry import get_spec, to_voxel
from rangeldm_tpu_torch.models import discriminator as tdisc
from rangeldm_tpu_torch.models import lpips as tlpips
from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
from rangeldm_tpu_torch.pipelines.samplers import to_bhwc
from rangeldm_tpu_torch.training import vae_trainer as tvt
from test_torch_port_common import (
    jax_vae_params, nhwc_to_torch, port_config, torch_to_nhwc,
)

IMAGE = (16, 64)          # beams, azimuth
BATCH = 2
LR = 1e-3
FWD_TOL = 5e-4
STATS_TOL = 1e-5
METRIC_RTOL = 2e-4
D_WEIGHT_RTOL = 1e-3
PARAM_TOL = 1e-6
GRAD_TOL = 1e-4
KINK_MARGIN = 2e-5
KEY = jax.random.PRNGKey(7)
# the JAX references' larger jits compile without LLVM's optimization
# passes: about half the compile time, the same arithmetic
FAST_COMPILE = {"xla_backend_optimization_level": 0}
DISCS = {"mk": (jdisc.NLayerDiscriminatorMetaKernel,
                tdisc.NLayerDiscriminatorMetaKernel),
         "mk2": (jdisc.NLayerDiscriminatorMetaKernel2,
                 tdisc.NLayerDiscriminatorMetaKernel2),
         "plain": (jdisc.NLayerDiscriminator, tdisc.NLayerDiscriminator)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def images(seed: int) -> np.ndarray:
    """(B, H, W, 2) normalized range in (0.1, 0.9), intensity in (0, 1):
    valid under the linear, log and inverse encodings alike."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.1, 0.9, (BATCH,) + IMAGE),
                     rng.uniform(0.0, 1.0, (BATCH,) + IMAGE)],
                    axis=-1).astype(np.float32)


def spec16(get, **kw):
    """KITTI-360's first 16 beams at width 64, on a 32x32 BEV grid."""
    sp = get("kitti360", width=IMAGE[1], **kw)
    return dataclasses.replace(sp, n_beams=IMAGE[0],
                               height=sp.height[:IMAGE[0]],
                               zenith=sp.zenith[:IMAGE[0]],
                               grid_sizes=(1, 32, 32))


def port_disc(kind: str, seed: int, n_layers: int = 2):
    """A port discriminator (ndf 8) with seeded weights and BatchNorm
    statistics away from their inits."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        disc = DISCS[kind][1](2, ndf=8, n_layers=n_layers)
        for name, buf in disc.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
        for name, p in disc.named_parameters():
            if name.endswith("bias"):
                p.data.normal_(0.0, 0.05)
    return disc


def jax_disc_variables(sd):
    """This package's discriminator state dict -> JAX variables, the
    inverse of `disc_state_dict_from_jax`."""
    params, stats = {}, {}
    for key, val in sd.items():
        v = val.detach().numpy().astype(np.float32)
        m = re.match(r"main\.(\d+)\.(?:(mlp_coord)\.(\d+)\.|(coov)\.)?(\w+)$",
                     key)
        idx, mlp, j, coov, leaf = m.groups()
        node = params.setdefault(f"main_{idx}", {})
        if mlp:
            node = node.setdefault(f"mlp_coord_{j}", {})
        elif coov:
            node = node.setdefault("coov", {})
        if leaf == "num_batches_tracked":
            continue
        if leaf.startswith("running_"):
            stats.setdefault(f"main_{idx}", {})[leaf[len("running_"):]] = v
        elif leaf == "bias":
            node["bias"] = v
        elif v.ndim == 4:
            node["kernel"] = v.transpose(3, 2, 1, 0)
        elif v.ndim == 2:
            node["kernel"] = v.T
        else:
            node["scale"] = v
    return {"params": params, "batch_stats": stats}


def vae_params(coord: bool = False, **overrides):
    """(JAX VaeConfig, params) of the step tests' VAE (ch 32, ch_mult
    (1, 2), one res block a level). A coordconv VAE's weights come from the
    port's seeded init through the JAX package's sgm converter (the seeded
    sgm state dict of tests/test_convert.py has no coordinate channel)."""
    cfg, params = jax_vae_params(0, num_res_blocks=1, coord=coord,
                                 **overrides)
    if coord:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(6)
            sd = AutoencoderKL(port_config(cfg, VaeConfig)).state_dict()
        params = convert_sgm_vae_state_dict(
            {k: v.numpy() for k, v in sd.items()})
    return cfg, params


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, f"{what}: max-abs {err} > {tol}"


def _stats_close(port_disc_module, jax_stats, what):
    want = disc_state_dict_from_jax({}, jax_stats)
    got = port_disc_module.state_dict()
    for k, v in want.items():
        if "running" in k:
            _close(got[k], v, STATS_TOL, f"{what} {k}")


# -- discriminators ---------------------------------------------------------

def test_metakernel_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, 8, 32, 6)).astype(np.float32)
    r = rng.uniform(0.5, 9.0, (BATCH, 8, 32, 1)).astype(np.float32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        mk = tdisc.MetaKernel(6, 5, azi=0.1, inc=0.2)
    params = jax_disc_variables(
        {f"main.0.{k}": v for k, v in mk.state_dict().items()})
    want_y, want_r = jax.jit(jdisc.MetaKernel(5, azi=0.1, inc=0.2).apply)(
        {"params": params["params"]["main_0"]}, x, r)
    y, rc = mk(nhwc_to_torch(x), nhwc_to_torch(r))
    _close(torch_to_nhwc(y), want_y, FWD_TOL, "MetaKernel output")
    _close(torch_to_nhwc(rc), want_r, 1e-6, "MetaKernel patch centres")


@pytest.mark.parametrize("kind", sorted(DISCS))
def test_discriminator_matches_jax(kind):
    """Logits of two train-mode passes (the second from the statistics the
    first left), the running statistics after both, an eval-mode pass on
    them, and the parameters' gradients of a weighted sum of both passes'
    logits (within GRAD_TOL of their tensor's largest entry plus the
    model's largest)."""
    x1, x2 = images(2), 1.5 * images(3) - 0.2
    disc = port_disc(kind, seed=5)
    sd = disc.state_dict()
    variables = jax_disc_variables(sd)
    assert all(torch.equal(sd[k], v) for k, v in disc_state_dict_from_jax(
        variables["params"], variables["batch_stats"]).items()
        if k in sd and "num_batches" not in k)
    jmod = DISCS[kind][0](ndf=8, n_layers=2)
    w1, w2 = np.random.default_rng(6).standard_normal((2, BATCH, 2, 14, 1))

    def passes(params, stats):
        y1, s1 = jmod.apply({"params": params, "batch_stats": stats}, x1,
                            mutable=["batch_stats"])
        y2, s2 = jmod.apply({"params": params,
                             "batch_stats": s1["batch_stats"]}, x2,
                            mutable=["batch_stats"])
        return jnp.sum(y1 * w1) + jnp.sum(y2 * w2), (y1, y2,
                                                     s2["batch_stats"])

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def run(v):
        (_, (y1, y2, stats)), grads = jax.value_and_grad(
            passes, has_aux=True)(v["params"], v["batch_stats"])
        return y1, y2, stats, grads, jmod.apply(
            {"params": v["params"], "batch_stats": stats}, x1, train=False)

    want1, want2, stats, grads, want_eval = run(variables)
    disc.train()
    y1, y2 = disc(nhwc_to_torch(x1)), disc(nhwc_to_torch(x2))
    _close(torch_to_nhwc(y1), want1, FWD_TOL, f"{kind} logits, pass 1")
    _close(torch_to_nhwc(y2), want2, FWD_TOL, f"{kind} logits, pass 2")
    _stats_close(disc, stats, kind)
    ((y1 * nhwc_to_torch(w1)).sum() + (y2 * nhwc_to_torch(w2)).sum()
     ).backward()
    want_g = disc_state_dict_from_jax(grads, {})
    scale = max(float(np.abs(v.numpy()).max()) for v in want_g.values())
    for name, p in disc.named_parameters():
        _close(p.grad, want_g[name], GRAD_TOL * (
            float(want_g[name].abs().max()) + scale), f"{kind} grad {name}")
    disc.eval()
    _close(torch_to_nhwc(disc(nhwc_to_torch(x1))), want_eval, FWD_TOL,
           f"{kind} eval logits")


def test_metakernel_discriminator_too_small_input_is_a_clear_error():
    disc = tdisc.NLayerDiscriminatorMetaKernel(2, ndf=8, n_layers=3)
    with pytest.raises(ValueError, match="too small"):
        disc(torch.zeros(1, 2, 32, 4))


# -- one generator step and one discriminator step ---------------------------

def _stand_in_perceptual(a, b):
    """A cheap perceptual distance, alike for both packages' arrays and
    layouts: the mean squared difference of each sample, as a (B, 1, 1)
    map. It drives the perceptual branch's wiring through the steps (the
    networks themselves are held to JAX in
    test_perceptual_networks_match_jax). A (B, 1, 1) map enters the loss
    once per pixel, without the used_feature multiplicity that a (B,)
    vector gets, in both packages; the (B,) case is
    test_per_sample_perceptual_term_counts_each_channel."""
    return ((a - b) ** 2).reshape(a.shape[0], -1).mean(-1)[:, None, None]


# (loss config, discriminator and its layers, VAE overrides, batches, the
#  seed of the first batch: one whose reconstructions keep away from the
#  loss's kinks, see _away_from_kinks). Each config keeps the adaptive
#  weight's ratio of gradient norms below its clip at 1e4 (a random
#  discriminator's gradient is small: the shipped weights put it at the
#  clip, where d_weight says nothing of either norm): lower channel
#  weights, or a higher starting logvar
CASES = {
    # the shipped loss but for the channel weights (JAX's fast path; the
    # steps treat the discriminator as a black box, and the MetaKernel ones
    # are held to JAX, gradients included, in
    # test_discriminator_matches_jax), disc_start 1 over two batches: the
    # GAN terms switch on at batch 2 on both the generator's and the
    # discriminator's side
    "linear": (dict(disc_start=1, range_weight=1.0, intensity_weight=0.25),
               ("plain", 2), {"ch_mult": (1,)}, 2, 118),
    # coordconv VAE (JAX's general path), log range with the true-range
    # L1, BEV reconstruction, a perceptual loss on the BEV grids, the
    # discriminator on BEV grids with the vanilla loss, a learned logvar
    "coord_log_bev": (dict(
        disc_start=0, encoding="log", use_rec_loss_true=True,
        bev_rec_weight=0.5, perceptual_weight=0.1, bev_perceptual=True,
        disc_bev=True, disc_loss="vanilla", learn_logvar=True,
        logvar_init=3.0), ("plain", 1), {"coord": True, "ch_mult": (1,)}, 1,
        100),
}


def _flat_state(jstate):
    """A JAX VaeGanState -> the port's flat `VaeGanState.state_dict()`:
    `vae_gan_state_from_jax`'s weights plus optax's Adam moments and
    counts."""
    w = vae_gan_state_from_jax(jstate)
    sd = {f"vae/{k}": v for k, v in w["vae"].items()}
    sd.update({f"disc/{k}": v for k, v in w["disc"].items()})
    sd.update({f"ema/{k}": v for k, v in w["ema"].items()})
    sd["logvar"] = w["logvar"]
    for prefix, opt, convert in (
            ("adam_gen", jstate.gen_opt[0], lambda t: vae_gan_state_from_jax(
                jstate.replace(gen_params=t))),
            ("adam_disc", jstate.disc_opt[0],
             lambda t: {"disc": disc_state_dict_from_jax(t, {})})):
        for key, tree in (("exp_avg", opt.mu), ("exp_avg_sq", opt.nu)):
            m = convert(tree)
            named = ({**m["vae"], "logvar": m["logvar"]}
                     if prefix == "adam_gen" else m["disc"])
            sd.update({f"{prefix}/{key}/{k}": v for k, v in named.items()})
        sd[f"{prefix}_count"] = int(opt.count)
    sd["step"] = int(jstate.step)
    sd["ema_updates"] = int(jstate.ema_updates)
    return sd


def _params_close(got_sd, want_sd, prefixes, what):
    """After an update: Adam's moments, then the parameters under
    `prefixes` (and the EMA's) against JAX's, within what one Adam step
    explains (chip_smoke.adam_update_mismatches: the moments within
    GRAD_TOL of their tensor's and the optimizer's largest entries, each
    parameter within PARAM_TOL plus lr times the update's sensitivity to
    the moments' differences)."""
    bad = adam_update_mismatches(got_sd, want_sd, prefixes, LR, PARAM_TOL,
                                 GRAD_TOL)
    assert not bad, f"{what}: {bad[:5]}"


def _away_from_kinks(vae, x, noise, what):
    """The gradients are compared where they exist: no reconstructed pixel
    lies within KINK_MARGIN of the L1 loss's kink (x == xrec), nor of the
    inverse encoding's clamp at 1e-4. Within rounding of a kink the two
    packages may take different sides, and one pixel's flipped sign moves
    every gradient by up to ~1e-2 of the largest."""
    with torch.no_grad():
        xrec = vae(x, noise=noise)[0]
    gap = float((x - xrec).abs().min())
    clamp = float((xrec[:, 0] - 1e-4).abs().min())
    assert min(gap, clamp) > KINK_MARGIN, \
        f"{what}: the test's batch puts a pixel at a loss kink ({gap}, {clamp})"


def _compare_metrics(jm, tm, what):
    for k, got in tm.items():
        want = float(jm[k])
        rtol = D_WEIGHT_RTOL if k == "d_weight" else METRIC_RTOL
        assert abs(float(got) - want) <= rtol * max(abs(want), 1e-3), \
            f"{what} {k}: {float(got)} against {want}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_steps_match_jax(name):
    """Each step from the state JAX's step started from (carried across,
    Adam moments included): every metric; after the generator step every
    VAE parameter, the logvar, the EMA shadow and the discriminator's
    running statistics; after the discriminator step its parameters and
    statistics."""
    overrides, (kind, layers), vae_kw, steps, seed = CASES[name]
    cfg = jvt.VaeLossConfig(**overrides)
    enc = dict(log=cfg.encoding == "log", inverse=cfg.encoding == "inverse")
    jspec, tspec = spec16(jax_get_spec, **enc), spec16(get_spec, **enc)
    vcfg, vparams = vae_params(**vae_kw)
    jmod = DISCS[kind][0](ndf=8, n_layers=layers)
    tx = optax.adam(LR)
    state = jvt.create_vae_gan_state(
        {"params": vparams}, jax_disc_variables(
            port_disc(kind, seed=11, n_layers=layers).state_dict()),
        tx, tx, cfg)
    jvox = ((lambda im: jax_to_voxel(im, jspec))
            if cfg.bev_rec_weight > 0 or cfg.bev_perceptual or cfg.disc_bev
            else None)
    jperc = _stand_in_perceptual if cfg.perceptual_weight > 0 else None
    steps_of = functools.partial(jvt.make_vae_gan_steps, JaxVae(vcfg),
                                 jvt.make_disc_apply(jmod), tx, tx, cfg,
                                 voxel_fn=jvox)
    gen, dstep = steps_of(perceptual_fn=jperc)

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def step(s, batch):
        s1, gm = gen(s, batch, KEY)
        s2, dm = dstep(s1, batch, KEY)
        return s1, s2, {**gm, **dm}

    tcfg = tvt.VaeLossConfig(**overrides)
    tstate = tvt.VaeGanState.create(
        AutoencoderKL(port_config(vcfg, VaeConfig)),
        DISCS[kind][1](2, ndf=8, n_layers=layers), LR, tcfg)
    tgen, tdisc_step = tvt.make_vae_gan_steps(
        tcfg, perceptual_fn=jperc and _stand_in_perceptual,
        voxel_fn=((lambda im: to_voxel(to_bhwc(im), tspec))
                  if tcfg.needs_voxels else None))
    zshape = (BATCH,) + tuple(n // vcfg.down_factor for n in IMAGE) + (
        vcfg.z_channels,)
    factors = []
    for i in range(steps):
        x, what = images(seed + i), f"{name} batch {i}"
        xt = nhwc_to_torch(x)
        s1, s2, jm = step(state, x)
        # the JAX steps' posterior draws (vae_trainer.py:193, 343-348)
        eg = jax.random.normal(jax.random.fold_in(KEY, i), zshape)
        ed = jax.random.normal(jax.random.fold_in(
            jax.random.fold_in(KEY, i + 1), 1), zshape)

        tstate.load_state_dict(_flat_state(state))
        _away_from_kinks(tstate.vae, xt, nhwc_to_torch(eg), what)
        tm = tgen(tstate, xt, noise=nhwc_to_torch(eg))
        _compare_metrics(jm, tm, what)
        assert 0 < float(tm["d_weight"]) < 1e4 * tcfg.disc_weight, \
            f"{what}: the adaptive weight sits at its clip"
        got, want = tstate.state_dict(), _flat_state(s1)
        _params_close(got, want, ("vae/", "ema/", "logvar"), what)
        for k, v in want.items():
            if k.startswith("disc/") and "running" in k:
                _close(got[k], v, STATS_TOL, f"{what} gen step {k}")
        assert got["step"] == want["step"]
        factors.append(float(tm["disc_factor"]))
        tstate.load_state_dict(want)
        tm = tdisc_step(tstate, xt, noise=nhwc_to_torch(ed))
        _compare_metrics(jm, tm, what)
        got, want = tstate.state_dict(), _flat_state(s2)
        _params_close(got, want, ("disc/",), what)
        for k, v in want.items():
            if k.startswith("disc/") and "running" in k:
                _close(got[k], v, STATS_TOL, f"{what} disc step {k}")
        factors.append(float(tm["disc_loss"] != 0))
        state = s2
    if name == "linear":
        # disc_start 1: both factors off at batch 1, on at batch 2
        assert factors == [0.0, 0.0, 1.0, 1.0]


LOSS_VARIANTS = {
    "linear": dict(),
    "one_channel": dict(used_feature=1),
    "log": dict(encoding="log"),
    "inverse": dict(encoding="inverse"),
    "log_true": dict(encoding="log", use_rec_loss_true=True),
    "inverse_true": dict(encoding="inverse", use_rec_loss_true=True),
    "log_true_power": dict(encoding="log", use_rec_loss_true_power=True,
                           rec_power=1.5),
}


@pytest.mark.parametrize("variant", sorted(LOSS_VARIANTS))
def test_losses_match_jax(variant):
    """reconstruction_loss, true_range_l1 (log and inverse), and both
    discriminator losses against the JAX package's, 1e-6 of their scale:
    the encodings' branches on their own."""
    kw = LOSS_VARIANTS[variant]
    jcfg, tcfg = jvt.VaeLossConfig(**kw), tvt.VaeLossConfig(**kw)
    x = images(30)
    rng = np.random.default_rng(31)
    xr = np.clip(x + 0.2 * rng.standard_normal(x.shape), -0.2, 1.2).astype(
        np.float32)
    pairs = [(jvt.reconstruction_loss, tvt.reconstruction_loss)]
    if jcfg.encoding != "linear":
        pairs.append((jvt.true_range_l1, tvt.true_range_l1))
    for jfn, tfn in pairs:
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(xr), jcfg))
        got = tfn(nhwc_to_torch(x), nhwc_to_torch(xr), tcfg)
        _close(got.numpy().transpose(0, 2, 1), want,
               1e-6 * float(np.abs(want).max()), f"{variant} {tfn.__name__}")
    real, fake = rng.standard_normal((2, 2, 1, 14, 3)).astype(np.float32)
    for jfn, tfn in ((jvt.hinge_d_loss, tvt.hinge_d_loss),
                     (jvt.vanilla_d_loss, tvt.vanilla_d_loss)):
        _close(tfn(torch.from_numpy(real), torch.from_numpy(fake)),
               jfn(jnp.asarray(real), jnp.asarray(fake)), 1e-6,
               tfn.__name__)


def test_per_sample_perceptual_term_counts_each_channel():
    """A per-sample (B,) perceptual distance enters the reference's
    elementwise (B, C, W, H) loss map once per element, so once per
    channel (losses/__init__.py:164-199): with the GAN term gated off,
    total_loss(weight 1) - total_loss(weight 0) = C * W * H * p for a
    constant p. The adaptive weight differentiates that same nll, as the
    reference's autograd.grad does: d_weight with the (B,) distance p
    equals d_weight with the (B, 1, 1) map C * p. (The JAX package's
    mirrored nll, vae_trainer.py:279-297, leaves the C out of d_weight: a
    known divergence, ROADMAP.md.)"""
    x = nhwc_to_torch(images(40))
    noise = torch.randn(BATCH, 4, IMAGE[1] // 2, IMAGE[0] // 2,
                        generator=torch.Generator().manual_seed(3))
    const = 0.37

    def run(weight, fn, disc_start=10 ** 9):
        state, _ = _port_state()
        cfg = tvt.VaeLossConfig(disc_start=disc_start,
                                perceptual_weight=weight)
        gen, _ = tvt.make_vae_gan_steps(cfg, perceptual_fn=fn)
        return gen(state, x, noise=noise)

    def flat(a, b):
        return const * torch.ones(a.shape[0])

    gap = float(run(1.0, flat)["total_loss"] - run(0.0, flat)["total_loss"])
    assert gap == pytest.approx(2 * IMAGE[0] * IMAGE[1] * const, rel=1e-4)
    per_sample = run(0.1, lambda a, b: ((a - b) ** 2).mean(dim=(1, 2, 3)), 0)
    as_map = run(0.1, lambda a, b: 2 * ((a - b) ** 2).mean(
        dim=(1, 2, 3))[:, None, None], 0)
    for k in ("total_loss", "nll_loss", "d_weight", "g_loss"):
        assert float(per_sample[k]) == pytest.approx(float(as_map[k]),
                                                      rel=1e-5), k


@pytest.fixture(scope="module")
def perceptual_ckpts(tmp_path_factory):
    """Torch checkpoints of the port's seeded random-init perceptual
    networks, read by both packages' make_perceptual_fn."""
    out = {}
    d = tmp_path_factory.mktemp("perceptual")
    for kind, sd in (("vgg", tlpips._seeded(tlpips.LPIPS).state_dict()),
                     ("darknet", tlpips._seeded(
                         tlpips.DarknetFeatureLoss).backbone.state_dict())):
        out[kind] = str(d / f"{kind}.pth")
        torch.save(sd, out[kind])
    return out


@pytest.mark.parametrize("kind", ["vgg", "darknet"])
def test_perceptual_networks_match_jax(kind, perceptual_ckpts):
    """make_perceptual_fn of both packages from one torch checkpoint of the
    port's random-init network: VGG-LPIPS on the BEV three-channel grids of
    two batches, darknet features on the range images; distances within
    5e-4 of their scale, and zero for identical inputs."""
    jspec, tspec = spec16(jax_get_spec), spec16(get_spec)
    jfn = jax_perceptual(perceptual_ckpts[kind], kind=kind, spec=jspec)
    tfn = tlpips.make_perceptual_fn(perceptual_ckpts[kind], kind=kind,
                                    spec=tspec)
    a, b = images(20), images(21)
    if kind == "vgg":
        bev = jax.jit(lambda v: jvt._bev_three_channel(jax_to_voxel(v,
                                                                     jspec)))
        ja, jb = bev(a), bev(b)
        ta, tb = (tvt.bev_three_channel(to_voxel(torch.from_numpy(v), tspec))
                  for v in (a, b))
    else:
        ja, jb = a, b
        ta, tb = nhwc_to_torch(a), nhwc_to_torch(b)
    want = np.asarray(jax.jit(jfn, compiler_options=FAST_COMPILE)(ja, jb))
    with torch.no_grad():
        got = tfn(ta, tb).numpy()
        same = tfn(ta, ta).numpy()
    assert want.shape == got.shape == (BATCH,)
    _close(got, want, FWD_TOL * max(float(np.abs(want).max()), 1.0),
           f"{kind} distance")
    assert np.abs(same).max() <= 1e-6 * max(float(np.abs(want).max()), 1.0)


# -- port-side invariants of the steps ---------------------------------------

def _port_state(kind="mk"):
    torch.manual_seed(0)
    vae = AutoencoderKL(VaeConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1))
    cfg = tvt.VaeLossConfig(disc_start=0)
    return tvt.VaeGanState.create(vae, port_disc(kind, 3), LR, cfg), cfg


def test_gen_step_moves_the_running_statistics_once():
    """The adaptive weight differentiates the step's own graph: the
    generator step runs the discriminator once, so its statistics end as
    one train-mode pass on the step's reconstruction leaves them."""
    state, cfg = _port_state()
    gen, _ = tvt.make_vae_gan_steps(cfg)
    x = nhwc_to_torch(images(4))
    noise = torch.randn(BATCH, 4, IMAGE[1] // 2, IMAGE[0] // 2,
                        generator=torch.Generator().manual_seed(1))
    ref = port_disc("mk", 3).train()
    with torch.no_grad():
        xrec, _, _ = state.vae(x, noise=noise)
        ref(xrec)
    gen(state, x, noise=noise)
    want = ref.state_dict()
    for k, v in state.disc.state_dict().items():
        if "running" in k or "num_batches" in k:
            assert torch.equal(v, want[k]), k


def test_steps_leave_no_gradient_on_the_other_model():
    state, cfg = _port_state()
    gen, disc = tvt.make_vae_gan_steps(cfg)
    x = nhwc_to_torch(images(5))
    g = torch.Generator().manual_seed(2)
    gen(state, x, generator=g)
    assert all(p.grad is None for p in state.disc.parameters())
    disc(state, x, generator=g)
    assert all(p.grad is None for p in state.vae.parameters())
    assert state.logvar.grad is None


# -- sgm checkpoints, the state-dict loader, instantiate ---------------------

class Hparams:
    """An object a Lightning checkpoint may pickle beside its tensors."""


def _lightning_ckpt(path, sd):
    """A Lightning-shaped LDM checkpoint: the VAE under first_stage_model.,
    the GAN loss's discriminator and logvar under loss., an EMA shadow."""
    wrapped = {(f"first_stage_model.{k}" if k.startswith(
        ("encoder.", "decoder.")) else k): torch.from_numpy(v)
        for k, v in sd.items()}
    wrapped["loss.discriminator.main.0.coov.weight"] = torch.zeros(
        8, 32, 1, 1)
    wrapped["model_ema.decay"] = torch.tensor(0.9999)
    wrapped["model_ema.encoderconv_inweight"] = torch.zeros(3)
    torch.save({"state_dict": wrapped, "epoch": 3, "global_step": 1020},
               path)


def test_load_sgm_vae_reads_a_lightning_ckpt(tmp_path):
    """`load_sgm_vae` reads a Lightning .ckpt into a VAE whose decode
    equals the JAX package's `load_sgm_vae`'s (5e-4)."""
    vcfg = port_config(jax_vae_params(0)[0], VaeConfig)
    sd = make_sgm_vae_state_dict(np.random.default_rng(3), vcfg)
    path = str(tmp_path / "last.ckpt")
    _lightning_ckpt(path, sd)
    vae = load_sgm_vae(path).eval()
    assert vae.cfg == vcfg
    z = np.random.default_rng(4).standard_normal(
        (BATCH, IMAGE[0] // 2, IMAGE[1] // 2, 4)).astype(np.float32)
    want = jax.jit(lambda p, zz: JaxVae(jax_vae_params(0)[0]).apply(
        p, zz, method="decode"))(jax_load_sgm_vae(path), z)
    with torch.no_grad():
        got = vae.decode(nhwc_to_torch(z))
    _close(torch_to_nhwc(got), want, FWD_TOL, "decode")


def test_state_dict_loader_unwraps_lightning_and_refuses_pickled_objects(
        tmp_path):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2)}
    torch.save(sd, tmp_path / "plain.pt")
    torch.save({"state_dict": sd, "epoch": 1}, tmp_path / "wrapped.ckpt")
    plain = load_torch_state_dict(str(tmp_path / "plain.pt"))
    wrapped = load_torch_state_dict(str(tmp_path / "wrapped.ckpt"))
    assert plain.keys() == wrapped.keys() == sd.keys()
    assert all(torch.equal(plain[k], wrapped[k]) for k in sd)
    torch.save({"state_dict": sd, "hparams": Hparams()},
               tmp_path / "objects.ckpt")
    with pytest.raises(ValueError, match=r"objects\.ckpt.*Hparams"):
        load_torch_state_dict(str(tmp_path / "objects.ckpt"))


def test_instantiate_builds_the_ports_counterpart():
    from rangeldm_tpu.utils.config import instantiate as jax_instantiate
    from rangeldm_tpu_torch.utils.config import instantiate

    spec = {"target": "rangeldm_tpu.models.discriminator.NLayerDiscriminator",
            "params": {"ndf": 8, "n_layers": 2}}
    ported = instantiate(spec, input_nc=2)
    assert type(ported) is tdisc.NLayerDiscriminator
    jax_mod = jax_instantiate(spec)
    assert type(jax_mod) is jdisc.NLayerDiscriminator
    assert ported.n_layers == jax_mod.n_layers == 2
    assert ported.main[0].out_channels == jax_mod.ndf == 8
    assert instantiate({"target": "collections.OrderedDict",
                        "params": {"a": 1}}) == {"a": 1}
