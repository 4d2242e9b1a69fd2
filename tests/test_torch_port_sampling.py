"""The port's noise schedules and sampling loops
(rangeldm_tpu_torch/diffusion/schedule.py, pipelines/samplers.py) against
the JAX package's, on the same numpy inputs. Where the JAX side draws noise
from a key, the same draw is handed to the port, so every comparison is
deterministic. f32 on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rangeldm_tpu.diffusion.schedule import Schedule as JaxSchedule
from rangeldm_tpu.diffusion.schedule import ScheduleConfig as JaxScheduleConfig
from rangeldm_tpu.models.unet import UNet2D as JaxUNet2D
from rangeldm_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from rangeldm_tpu.pipelines import samplers as js

from rangeldm_tpu_torch.diffusion.schedule import (
    Schedule, ScheduleConfig, make_betas,
)
from rangeldm_tpu_torch.pipelines import samplers as ts
from test_torch_port_common import (
    jax_unet_params, jax_vae_params, nhwc_to_torch, port_unet, port_vae,
    torch_to_nhwc,
)

# elementwise steps: both sides compute the scalar coefficients in f32 and
# may round them differently by an ulp; near t = 999 x0 is scaled by
# 1 / sqrt(acp) ~ 150, so the bound is relative
STEP_TOL = dict(rtol=2e-5, atol=2e-5)
CHAIN_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(**kw):
    return (Schedule(ScheduleConfig(**kw)),
            JaxSchedule.create(JaxScheduleConfig(**kw)))


def _arrays(seed, shape=(2, 4, 6, 8)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


PAIRS = [(980, 960), (500, 480), (20, 0), (0, -1), (999, 949), (49, -1)]


@pytest.mark.parametrize("beta_schedule", ["linear", "scaled_linear",
                                           "squaredcos_cap_v2"])
def test_betas_and_alphas_cumprod(beta_schedule):
    port, ref = _pair(beta_schedule=beta_schedule)
    np.testing.assert_array_equal(
        make_betas(port.cfg), np.asarray(ref.betas))
    # a cumulative product of 1000 f32 factors, taken in another order
    # (XLA scans in a tree): each product rounds by up to half an ulp
    np.testing.assert_allclose(port.alphas_cumprod,
                               np.asarray(ref.alphas_cumprod),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
def test_timesteps_exact(spacing):
    port, ref = _pair(timestep_spacing=spacing)
    for n in range(1, 1001):
        np.testing.assert_array_equal(port.timesteps(n), ref.timesteps(n))


@pytest.mark.parametrize("prediction_type,clip", [
    ("epsilon", False), ("v_prediction", False), ("sample", False),
    ("epsilon", True)])
@pytest.mark.parametrize("set_alpha_to_one", [True, False])
def test_ddim_step(prediction_type, clip, set_alpha_to_one):
    port, ref = _pair(prediction_type=prediction_type, clip_sample=clip,
                      set_alpha_to_one=set_alpha_to_one)
    out, x, _ = _arrays(1)
    for t, tp in PAIRS:
        want = ref.ddim_step(jnp.asarray(out), jnp.asarray(t),
                             jnp.asarray(tp), jnp.asarray(x))
        got = port.ddim_step(torch.from_numpy(out), t, tp,
                             torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **STEP_TOL, err_msg=f"t={t} tp={tp}")


def test_ddim_step_with_eta_and_injected_noise():
    port, ref = _pair()
    out, x, _ = _arrays(2)
    for i, (t, tp) in enumerate(PAIRS):
        key = jax.random.PRNGKey(i)
        want = ref.ddim_step(jnp.asarray(out), jnp.asarray(t),
                             jnp.asarray(tp), jnp.asarray(x), eta=0.7,
                             rng=key)
        noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
        got = port.ddim_step(torch.from_numpy(out), t, tp,
                             torch.from_numpy(x), eta=0.7,
                             noise=torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **STEP_TOL, err_msg=f"t={t} tp={tp}")
    with pytest.raises(ValueError):
        port.ddim_step(torch.from_numpy(out), 500, 480, torch.from_numpy(x),
                       eta=0.5)


@pytest.mark.parametrize("set_alpha_to_one", [True, False])
def test_ddpm_step_with_injected_noise(set_alpha_to_one):
    """DDPM's final boundary is alpha 1.0 whatever set_alpha_to_one says;
    at t = 0 no noise is added."""
    port, ref = _pair(set_alpha_to_one=set_alpha_to_one)
    out, x, _ = _arrays(3)
    for i, (t, tp) in enumerate(PAIRS):
        key = jax.random.PRNGKey(10 + i)
        want = ref.ddpm_step(key, jnp.asarray(out), jnp.asarray(t),
                             jnp.asarray(tp), jnp.asarray(x))
        noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
        got = port.ddpm_step(torch.from_numpy(out), t, tp,
                             torch.from_numpy(x), torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **STEP_TOL, err_msg=f"t={t} tp={tp}")


def test_dpmpp_2m_steps():
    """First-order first step, second-order interior steps seeded with the
    previous x0 and step size, first-order final step."""
    port, ref = _pair()
    out, x, prev = _arrays(4)
    for first in (True, False):
        for h_prev in (1.0, 0.37):
            for t, tp in PAIRS:
                jx, jx0, jh = ref.dpmpp_2m_step(
                    jnp.asarray(out), jnp.asarray(t), jnp.asarray(tp),
                    jnp.asarray(x), jnp.asarray(prev),
                    jnp.asarray(h_prev, jnp.float32), jnp.asarray(first))
                px, px0, ph = port.dpmpp_2m_step(
                    torch.from_numpy(out), t, tp, torch.from_numpy(x),
                    torch.from_numpy(prev), np.float32(h_prev), first)
                msg = f"t={t} tp={tp} first={first} h_prev={h_prev}"
                np.testing.assert_allclose(px.numpy(), np.asarray(jx),
                                           **STEP_TOL, err_msg=msg)
                np.testing.assert_allclose(px0.numpy(), np.asarray(jx0),
                                           **STEP_TOL, err_msg=msg)
                # h is a difference of two logs of alphas_cumprod, which
                # already differ by up to 1e-5 (see above)
                np.testing.assert_allclose(ph, float(jh), rtol=2e-5,
                                           atol=2e-6, err_msg=msg)


def test_pos_encoding_layout():
    want = np.asarray(js.make_pos_encoding(2, 4, 8))
    got = torch_to_nhwc(ts.make_pos_encoding(2, 4, 8))
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def tiny_ldm():
    ucfg, uparams = jax_unet_params(seed=30)
    vcfg, vparams = jax_vae_params(seed=40)
    jvae = JaxAutoencoderKL(vcfg)
    # the JAX UNet and decode traced once for both samplers' chains
    return dict(ucfg=ucfg, uparams=uparams, vcfg=vcfg, vparams=vparams,
                unet=port_unet(ucfg, uparams), vae=port_vae(vcfg, vparams),
                jax_apply=jax.jit(JaxUNet2D(ucfg).apply),
                jax_decode=jax.jit(lambda z: jvae.apply(
                    {"params": vparams}, z, method="decode")))


@pytest.mark.parametrize("method,steps", [("ddim", 50), ("dpmpp", 20)])
def test_latent_chain_matches_jax(tiny_ldm, method, steps):
    """A whole chain with the same x_T on both sides, then the decode."""
    m = tiny_ldm
    ucfg, vcfg = m["ucfg"], m["vcfg"]
    h, w = ucfg.sample_size
    shape = (1, h, w, ucfg.out_channels)
    x_t = np.random.default_rng(steps).standard_normal(shape).astype(
        np.float32)
    sf = vcfg.scaling_factor
    jschedule = JaxSchedule.create(JaxScheduleConfig())

    @jax.jit
    def jax_chain(x):
        return js.denoise(
            lambda u, t: m["jax_apply"]({"params": m["uparams"]}, u, t),
            jschedule, x, steps, jax.random.PRNGKey(0), method=method,
            pos_encoding=js.make_pos_encoding(*shape[:3]))

    want_z = jax_chain(jnp.asarray(x_t))
    want_img = np.asarray(m["jax_decode"](want_z / sf))
    want_z = np.asarray(want_z)

    schedule = Schedule(ScheduleConfig())
    seen = []

    def decode(z):            # keeps the chain's last latents
        seen.append(z * sf)
        return m["vae"].decode(z)

    with torch.no_grad():
        got_img = ts.latent_sample((m["unet"],), (decode,), schedule, shape,
                                   sf,
                                   num_steps=steps, method=method,
                                   noise=torch.from_numpy(x_t))
    np.testing.assert_allclose(torch_to_nhwc(seen[0]), want_z, **CHAIN_TOL)
    assert got_img.shape == (1, 2 * h, 2 * w, 2)
    np.testing.assert_allclose(got_img.numpy(), want_img, **CHAIN_TOL)


def test_latent_sample_trajectory(tiny_ldm):
    """final_only=False also returns the decoded state before every step;
    the first is the decoded x_T."""
    m = tiny_ldm
    h, w = m["ucfg"].sample_size
    shape = (2, h, w, 4)
    x_t = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    sf = m["vcfg"].scaling_factor
    sched = Schedule(ScheduleConfig())
    with torch.no_grad():
        img, traj = ts.latent_sample((m["unet"],), (m["vae"].decode,), sched,
                                     shape, sf, num_steps=3, noise=x_t,
                                     final_only=False)
        final = ts.latent_sample((m["unet"],), (m["vae"].decode,), sched,
                                 shape,
                                 sf, num_steps=3, noise=x_t)
        first = ts.to_bhwc(m["vae"].decode(ts.to_bcwh(x_t) / sf))
    assert img.shape == (2, 2 * h, 2 * w, 2)
    assert traj.shape == (3, 2, 2 * h, 2 * w, 2)
    torch.testing.assert_close(img, final, rtol=0, atol=0)
    torch.testing.assert_close(traj[0], first, rtol=1e-6, atol=1e-6)


def test_generator_makes_samples_reproducible(tiny_ldm):
    m = tiny_ldm
    h, w = m["ucfg"].sample_size
    sched = Schedule(dataclasses.replace(ScheduleConfig(),
                                         timestep_spacing="trailing"))

    def run(seed, method):
        with torch.no_grad():
            return ts.latent_sample(
                (m["unet"],), (m["vae"].decode,), sched, (1, h, w, 4),
                m["vcfg"].scaling_factor,
                torch.Generator().manual_seed(seed), num_steps=2,
                method=method, eta=0.5)

    for method in ("ddim", "ddpm"):
        a, b, c = run(0, method), run(0, method), run(1, method)
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert torch.isfinite(a).all()
