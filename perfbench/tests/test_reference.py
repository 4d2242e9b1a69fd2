"""The frozen reference against the program at a tiny size on the CPU, in
float32: the UNet, the VAE, the schedule's updates, and the control's
rounding. (A test may import both; the reference itself imports nothing
of the program.)"""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import weights as seeded
from perfbench.reference import schedule as ref_schedule
from perfbench.reference import unet as ref_unet
from perfbench.reference import vae as ref_vae
from perfbench.reference.precision import FP8, REFERENCE, fp8_round
from perfbench.tests.tiny import TINY_PIXEL, TINY_UNET, TINY_VAE


@pytest.fixture(autouse=True)
def fixed_inputs():
    """The same inputs on every run."""
    torch.manual_seed(0)


def weights(shapes, seed=0):
    return seeded.make(shapes, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("mc", [TINY_UNET, TINY_PIXEL])
def test_unet_matches_the_program(mc):
    from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig
    w = weights(ref_unet.param_shapes(mc))
    net = UNet2D(dataclasses.replace(UNetConfig.from_reference(mc),
                                     circular=True))
    net.load_state_dict(w, strict=True)
    az, beams = mc["sample_size"]
    x = torch.randn((3, mc["in_channels"], az, beams))
    t = torch.tensor([0, 517, 999])
    with torch.no_grad():
        want = net(x, t)
        got = ref_unet.forward(mc, w, x, t, REFERENCE)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


def test_vae_matches_the_program():
    from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
    w = weights(ref_vae.param_shapes(TINY_VAE))
    vae = AutoencoderKL(VaeConfig(**{k: tuple(v) if isinstance(v, list)
                                     else v for k, v in TINY_VAE.items()}))
    vae.load_state_dict(w, strict=True)
    x = torch.randn((2, 2, 32, 8))
    z = torch.randn((2, 4, 16, 4))
    with torch.no_grad():
        assert torch.allclose(ref_vae.encode_moments(TINY_VAE, w, x,
                                                     REFERENCE),
                              vae.encode_moments(x), rtol=1e-4, atol=1e-5)
        assert torch.allclose(ref_vae.decode(TINY_VAE, w, z, REFERENCE),
                              vae.decode(z), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("method,steps", [("ddim", 50), ("dpmpp", 20)])
def test_sampling_chain_matches_the_program(method, steps):
    """The same eps function through both chains."""
    from rangeldm_tpu_torch.diffusion.schedule import Schedule
    from rangeldm_tpu_torch.pipelines.samplers import denoise
    x = torch.randn((2, 4, 6, 3))
    proj = torch.randn((4, 4)) * 0.3

    def eps(x, t):
        return torch.tanh(torch.einsum("ij,bjwh->biwh", proj, x)
                          + t / 1000.0)

    want = denoise([eps], Schedule(), [x.clone()], steps,
                   method=method)[0]
    got = ref_schedule.sample(ref_schedule.Schedule(), eps, x.clone(),
                              steps, method)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_add_noise_and_timesteps_match_the_program():
    from rangeldm_tpu_torch.diffusion.schedule import Schedule
    prog, ref = Schedule(), ref_schedule.Schedule()
    assert list(prog.timesteps(50)) == ref.timesteps(50)
    assert list(prog.timesteps(20)) == ref.timesteps(20)
    gen = torch.Generator().manual_seed(0)
    x0, nz = (torch.randn((4, 2, 5, 3), generator=gen) for _ in range(2))
    t = torch.tensor([0, 10, 500, 999])
    # the reference's alpha_cumprod is a float64 product, the program's a
    # float32 one: they part by about 1e-6 at the last timesteps
    assert torch.allclose(ref.add_noise(x0, nz, t), prog.add_noise(x0, nz, t),
                          rtol=1e-4, atol=1e-5)


def test_learning_rate_and_ema_decay_match_the_program():
    from rangeldm_tpu_torch.training.ema import power_decay
    from rangeldm_tpu_torch.training.train_state import (
        warmup_cosine_schedule,
    )
    from perfbench.reference import train as ref_train
    cfg = {"learning_rate": 1e-4, "lr_warmup_steps": 500}
    lr = warmup_cosine_schedule(1e-4, 500, 1_000_000)
    for step in (0, 1, 2, 499, 500, 10_000):
        assert ref_train.learning_rate(cfg, step) == pytest.approx(lr(step))
        assert ref_train.ema_decay({}, step) == power_decay(step)


def test_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.linspace(-3.0, 3.0, 1001)
    r = fp8_round(x)
    rel = ((r - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 0.1]
    assert 0.01 < float(rel.max()) <= 2.0 ** -4 + 1e-6
    assert FP8.q(x).dtype == torch.float32
    # the gradient passes straight through
    y = x.clone().requires_grad_(True)
    fp8_round(y).sum().backward()
    assert torch.equal(y.grad, torch.ones_like(x))


def test_weights_are_the_seeds():
    shapes = ref_unet.param_shapes(TINY_UNET)
    a, b = weights(shapes, 3), weights(shapes, 3)
    assert all(torch.equal(a[n], b[n]) for n in shapes)
    assert torch.equal(a["conv_norm_out.weight"],
                       torch.ones_like(a["conv_norm_out.weight"]))
    w = a["conv_in.weight"]
    fan_in = int(np.prod(w.shape[1:]))
    assert float(w.abs().max()) <= fan_in ** -0.5
