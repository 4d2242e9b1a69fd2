"""The port's VAE-GAN training (train_vae.VaeTrainer, training/
vae_trainer.py, models/discriminator.py) against the benchmark's plain
reference (perfbench/reference/vae_gan.py) on the CPU in float32, at a
tiny size: a VAE of ch 32 and ch_mult (1, 2) (GroupNorm's 32 groups need
32 channels), the published 3-layer MetaKernel discriminator (ndf 64),
2 scans of 2x64x32 (beams x azimuth), weights drawn from a seed as the
benchmark draws them.

The steps run through the benchmark's own traffic kind
(perfbench/traffic/vae_gan_train.py), so the test also holds the cell's
set-up, its posterior draws and its check. Tolerances, each a gap as the
check defines it (perfbench/traffic/vae_gan_train.py):
* losses 1e-4: float32 sums over 8,192 pixels in other orders, and after
  the first update the states differ as below; the discriminator's hinge
  loss 2e-3 (1e-5 before its first update): the mean of 24 patch terms
  of a network that the updates below have moved;
* d_weight 2e-2: a ratio of two gradient norms of a discriminator whose
  LeakyReLUs flip where a pre-activation sits within rounding of 0;
* the first generator gradient 1e-5: one backward pass, no update yet;
* the changes of the VAE's parameters and the EMA 2e-2, the
  discriminator's 5e-2: Adam moves an element by about lr whatever its
  gradient's size, so elements whose gradient is rounding noise move by
  +-lr on either side, and the discriminator's 4 updates feed on each
  other's;
* BatchNorm's statistics after the first step 1e-6 (means in units of the
  spread): three float32 passes, sums in other orders.
"""

import copy
import json

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench import weights as seeded
from perfbench.reference import vae_gan as ref_gan
from perfbench.reference.precision import FP8, REFERENCE
from perfbench.reference.vae_gan import BF16
from rangeldm_tpu_torch import train_vae
from rangeldm_tpu_torch.models.discriminator import (
    NLayerDiscriminatorMetaKernel,
)

CELL = harness.Cell("vae_gan_train_b16")
KIND = harness.load_module(harness.BENCH_DIR / "traffic" /
                           "vae_gan_train.py", "vae_gan_train_kind")
TOL = {"loss_gap": 1e-4, "disc_loss_gap": 2e-3, "d_weight_gap": 2e-2,
       "grad_gap": 1e-5, "change_gap": 2e-2, "disc_change_gap": 5e-2,
       "ema_gap": 2e-2, "bn_mean_gap": 1e-6, "bn_var_gap": 1e-6}
SEED = 2 ** 31 + 17


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def tiny_cfg(**top) -> dict:
    cfg = copy.deepcopy(CELL.config)
    cfg["vae"].update(ch=32, ch_mult=[1, 2])
    cfg["image_size"] = [64, 32]
    cfg["data"]["width"] = 32
    cfg.update(top)
    return cfg


def traffic(start_step: int, steps: int = 4, seed: int = SEED,
            loss: dict = None, **top):
    cfg = tiny_cfg(**top)
    cfg["assumed"] = dict(cfg["assumed"], start_step=start_step)
    cfg["loss"] = dict(cfg["loss"], **(loss or {}))
    mix = {"kind": "vae_gan_train", "batch": 2, "pool": steps,
           "check_steps": steps, "trace_steps": 1}
    drv = KIND.Traffic(cfg, mix, torch.device("cpu"), seed)
    drv.setup()
    drv.release()
    return drv


def test_discriminator_forward_matches_the_reference():
    cfg = tiny_cfg()
    lc = cfg["loss"]
    shapes = ref_gan.disc_param_shapes(lc)
    w = seeded.make(shapes, torch.Generator().manual_seed(5))
    disc = NLayerDiscriminatorMetaKernel(2, n_layers=3, range_mean=20.0,
                                         range_std=40.0).train()
    stats = ref_gan.disc_stats(lc, "cpu")
    disc.load_state_dict({**w, **stats, **{
        n.rsplit(".", 1)[0] + ".num_batches_tracked":
        torch.zeros((), dtype=torch.long) for n in stats}})
    x = torch.randn((2, 2, 32, 64), generator=torch.Generator().manual_seed(6))
    got = disc(x).detach()
    want = ref_gan.discriminator(cfg, w, stats, x, REFERENCE)
    assert got.shape == want.shape == (2, 1, 2, 6)
    scale = want.abs().max()
    # float32 forwards of the same arithmetic, products in other orders
    assert float((got - want).abs().max() / scale) < 1e-5
    bufs = dict(disc.named_buffers())
    for name, t in stats.items():
        assert torch.allclose(bufs[name], t, rtol=1e-5, atol=1e-6), name


def test_one_step_before_disc_start_and_three_past_match_the_reference():
    start = int(CELL.config["loss"]["disc_start"]) - 1
    drv = traffic(start)
    got, ref = drv.program_result(), drv.reference()
    # before disc_start the discriminator's loss is 0 on both sides
    assert got["disc_losses"][0] == ref["disc_losses"][0] == 0.0
    assert all(v > 0 for v in ref["disc_losses"][1:])
    # the first step past disc_start, before the discriminator's update
    assert abs(got["disc_losses"][1] - ref["disc_losses"][1]) <= 1e-5 * \
        ref["disc_losses"][1]
    # the adaptive weight is computed every step
    for a, b in zip(got["d_weights"], ref["d_weights"]):
        assert abs(a - b) <= TOL["d_weight_gap"] * b
    numbers = drv.numbers(got, ref)
    assert set(numbers) == set(TOL)
    for k, v in numbers.items():
        assert v <= TOL[k], (k, v, numbers)


def test_the_adaptive_weight_below_its_clamp_matches_the_reference():
    """With the published channel weights (range 40, intensity 10) and
    random weights the ratio of the two gradient norms at conv_out lies
    above its clamp (1e4), here as at the cell's size, and d_weight reads
    the clamp on both sides; with the channel weights of chip_smoke's
    small step (range 1, intensity 0.25) it lies below, so the program's
    ratio is held to the reference's, on each of three steps past
    disc_start."""
    drv = traffic(int(CELL.config["loss"]["disc_start"]), steps=3,
                  loss={"range_weight": 1.0, "intensity_weight": 0.25})
    got, ref = drv.program_result(), drv.reference()
    clamp = 1e4 * float(CELL.config["loss"]["disc_weight"])
    assert all(0 < b < clamp / 3 for b in ref["d_weights"]), ref
    assert drv.numbers(got, ref)["d_weight_gap"] <= TOL["d_weight_gap"]


@pytest.fixture(scope="module")
def past_start():
    """Three steps from disc_start: the program and the reference."""
    torch.set_num_threads(2)
    drv = traffic(int(CELL.config["loss"]["disc_start"]), steps=3)
    return drv, drv.reference()


@pytest.mark.parametrize("control", [FP8, BF16], ids=lambda c: c.name)
def test_the_reference_in_a_lower_precision_fails_the_check(past_start,
                                                             control):
    """The controls, the reference computed with float8 or bfloat16
    operands, fail the cell's limits, and read far above the program."""
    drv, ref = past_start
    program = drv.numbers(drv.program_result(), ref)
    got = drv.numbers(drv.reference(control), ref)
    limits = CELL.spec["limits"]
    assert any(got[k] > v for k, v in limits.items()), got
    assert all(got[k] > 10 * program[k] for k in ("loss_gap", "grad_gap"))


def _skip_disc_update(monkeypatch):
    """The discriminator's update undone after each step."""
    step = train_vae.VaeTrainer.train_step

    def train_step(self, x):
        before = [p.detach().clone() for p in self.state.disc.parameters()]
        out = step(self, x)
        with torch.no_grad():
            for p, b in zip(self.state.disc.parameters(), before):
                p.copy_(b)
        return out
    monkeypatch.setattr(train_vae.VaeTrainer, "train_step", train_step)


def _half_batch(monkeypatch):
    to_device = train_vae.VaeTrainer._to_device

    def half(self, batch):
        x = to_device(self, batch)
        return x[:len(x) // 2]
    monkeypatch.setattr(train_vae.VaeTrainer, "_to_device", half)


@pytest.mark.parametrize("fault", ["half_batch", "disc_skipped"])
def test_the_check_fails_on_each_planted_fault(fault, monkeypatch):
    """The cell's own limits catch each fault planted in the program at
    this size too."""
    (_half_batch if fault == "half_batch" else _skip_disc_update)(
        monkeypatch)
    drv = traffic(int(CELL.config["loss"]["disc_start"]), steps=3)
    numbers = drv.numbers(drv.program_result(), drv.reference())
    limits = CELL.spec["limits"]
    assert any(numbers[k] > v for k, v in limits.items()), numbers


def test_the_sound_program_passes_the_cells_limits(past_start):
    drv, ref = past_start
    numbers = drv.numbers(drv.program_result(), ref)
    limits = CELL.spec["limits"]
    assert all(numbers[k] <= v for k, v in limits.items()), numbers


@pytest.mark.parametrize("caller_tf32", [False, True])
def test_the_step_runs_in_the_configured_precision(caller_tf32, tmp_path):
    """TF32 for (cuDNN, matrix products) inside a step is the published
    runs', cuDNN's on and matrix products' off, whether the caller turned
    both off or both on before; the caller's after."""
    cfg = tiny_cfg(batch_size=2, output_dir=str(tmp_path), tensorboard=False)
    trainer = train_vae.VaeTrainer(cfg, device="cpu")
    seen = []
    trainer.state.vae.decoder.conv_out.register_forward_pre_hook(
        lambda m, a: seen.append((torch.backends.cudnn.allow_tf32,
                                  torch.backends.cuda.matmul.allow_tf32)))
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    caller = (caller_tf32, caller_tf32)
    try:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = caller
        x = torch.randn((2, 2, 32, 64),
                        generator=torch.Generator().manual_seed(3))
        trainer.train_step(x)
        after = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert seen and all(s == (True, False) for s in seen)
    assert after == caller


def test_the_configuration_keeps_the_published_widths():
    cfg = CELL.config
    assert cfg["reduced"] == ["trainer_devices", "trainer_benchmark"]
    assert cfg["deployment"]["trainer_devices"] == 8
    assert cfg["deployment"]["trainer_benchmark"] is True
    assert cfg["vae"]["ch"] == 64 and cfg["vae"]["ch_mult"] == [1, 2, 4]
    assert cfg["image_size"] == [64, 1024]
    lc = cfg["loss"]
    assert (lc["disc_num_layers"], lc["disc_ndf"], lc["metakernel"]) == (
        3, 64, True)
    # the deployment's learning rate: 8 devices x 16 x base_learning_rate
    assert np.isclose(cfg["learning_rate"], 8 * cfg["batch_size"]
                      * cfg["base_learning_rate"])
    assert cfg["assumed"]["start_step"] == lc["disc_start"]
    json.dumps(cfg)
