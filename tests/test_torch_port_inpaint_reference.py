"""The port's inpainting training step (training/ldm_trainer.py
`make_ldm_train_step` with training/conditions.py
`make_inpainting_cond_fn`) against the benchmark's plain reference
(perfbench/reference/inpaint.py) on the CPU in float32, at a tiny size: a
VAE of ch 32 and ch_mult (1, 2, 2) (the published factor 4 between scan
and latent; GroupNorm's 32 groups need 32 channels), a two-level UNet of
4 + 5 input channels and no position channel, 2 scans of 16x64x2 (beams x
azimuth), weights drawn from a seed as the benchmark draws them, and the
step's draws from one generator on both sides.

The mask has random +-1 entries, so that every row and column the resize
picks matters: the published sector (azimuth columns 0-63 of 1024) ends
on a multiple of 4, where a resize from rows 4i and one from rows 4i + 2
agree.

Tolerances, each a relative distance (||a - b|| / ||b||), with what the
sound step reads:
* the first step's condition 1e-5 (1.6e-7): the same float32 encoder,
  convolutions and GroupNorm sums in other orders;
* each step's loss 1e-5 (5.7e-8): a mean over 2,048 latent values of a
  float32 UNet whose input differs as the condition does;
* the first step's clipped gradient, the vector of its parameters' norms,
  1e-5 (1.4e-7): one float32 backward through the UNet;
* the change of the parameters and of the EMA over the 3 steps 1e-4
  (3.8e-6, 4.5e-6), over the parameters whose reference gradient is at
  least a thousandth of the median parameter's: Adam moves an element by
  about the learning rate whatever its gradient's size, so elements whose
  gradient is rounding noise move by +-lr on either side (the benchmark's
  check makes the same cut, perfbench/traffic/train.py).
A zeroed condition and a resize that takes rows 0, 4, 8, 12 (torch's
"nearest") each fail it: the condition by 1.0 and 1.35, the loss by 4e-2
and 3e-2, the changes by more than 1.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench import weights as seeded
from perfbench.reference import inpaint as ref_inpaint
from perfbench.reference import unet as ref_unet
from perfbench.reference import vae as ref_vae
from perfbench.reference.precision import REFERENCE
from rangeldm_tpu_torch.diffusion.schedule import Schedule, ScheduleConfig
from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig
from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
from rangeldm_tpu_torch.training import conditions
from rangeldm_tpu_torch.training.ldm_trainer import (
    LdmTrainConfig, make_ldm_train_step,
)
from rangeldm_tpu_torch.training.train_state import TrainState, make_adamw

MC = {"sample_size": [16, 4], "in_channels": 9, "out_channels": 4,
      "layers_per_block": 1, "block_out_channels": [32, 32],
      "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
      "up_block_types": ["AttnUpBlock2D", "UpBlock2D"],
      "attention_head_dim": 8}
VC = {"in_channels": 2, "out_ch": 2, "ch": 32, "ch_mult": [1, 2, 2],
      "num_res_blocks": 1, "z_channels": 4, "double_z": True,
      "attn_type": "none", "act": "silu", "circular": True, "coord": False,
      "use_quant_conv": False, "scaling_factor": 0.18215}
CFG = {"model_config": MC, "vae_config": VC, "learning_rate": 1e-3,
       "lr_warmup_steps": 2, "adam_beta1": 0.95, "adam_beta2": 0.999,
       "adam_weight_decay": 1e-6, "adam_epsilon": 1e-8}
IMAGE = (64, 16)                # (W, H): a (16, 4) latent
BATCH, STEPS, SEED = 2, 3, 2 ** 31 + 29
TOL = {"condition": 1e-5, "loss": 1e-5, "grad": 1e-5, "change": 1e-4,
       "ema": 1e-4}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def weights():
    gen = torch.Generator().manual_seed(SEED)
    return (seeded.make(ref_unet.param_shapes(MC), gen),
            seeded.make(ref_vae.param_shapes(VC), gen))


def batches() -> list:
    g = torch.Generator().manual_seed(SEED + 1)
    out = []
    for _ in range(STEPS):
        images = torch.randn(BATCH, 2, *IMAGE, generator=g)
        mask = torch.where(torch.rand(BATCH, 1, *IMAGE, generator=g) < 0.5,
                           1.0, -1.0)
        out.append({"jpg": images, "inpainting_mask": mask,
                    "masked_image": torch.where(mask > 0, -1.0, images)})
    return out


def port_steps(unet_w, vae_w, data) -> dict:
    """STEPS steps of the port: each loss, the first step's condition (the
    UNet's input channels past the noisy latent) and the norm of each
    parameter's clipped gradient, and the parameters and the EMA after the
    last."""
    vae = AutoencoderKL(VaeConfig(**{k: tuple(v) if isinstance(v, list)
                                     else v for k, v in VC.items()}))
    vae.load_state_dict(vae_w, strict=True)
    vae = vae.eval().requires_grad_(False)
    unet = UNet2D(UNetConfig.from_reference(MC))
    unet.load_state_dict(unet_w, strict=True)
    state = TrainState.create(unet.train(), make_adamw(
        unet.parameters(), learning_rate=CFG["learning_rate"],
        warmup_steps=CFG["lr_warmup_steps"]))
    step = make_ldm_train_step(
        Schedule(ScheduleConfig()), LdmTrainConfig(pos_encoding=False), vae,
        cond_fn=conditions.make_inpainting_cond_fn(
            vae, VC["scaling_factor"], (4, 16)))
    generator = torch.Generator().manual_seed(SEED + 2)
    seen = []
    hook = unet.register_forward_pre_hook(
        lambda module, args: seen.append(args[0][:, 4:].detach().clone()))
    out = {"losses": []}
    for k, batch in enumerate(data):
        out["losses"].append(float(step(state, batch, generator)["loss"]))
        if k == 0:
            hook.remove()
            # the clip scales the gradients in place before the update
            out["first_grads"] = {n: float(p.grad.norm())
                                  for n, p in unet.named_parameters()}
    out["condition"] = seen[0]
    out["params"] = {n: p.detach().clone()
                     for n, p in unet.named_parameters()}
    out["ema"] = dict(zip(out["params"], state.ema))
    return out


def reference_steps(unet_w, vae_w, data) -> dict:
    out = ref_inpaint.train(CFG, unet_w, vae_w, data,
                            torch.Generator().manual_seed(SEED + 2),
                            REFERENCE, chunk=1)
    out["condition"] = out["conditions"][0]
    return out


def gaps(got: dict, ref: dict, w0: dict) -> dict:
    norms = list(ref["first_grads"])
    g_ref = ref["first_grads"]
    median = float(np.median(list(g_ref.values())))
    moving = [n for n in norms if g_ref[n] >= 1e-3 * median]

    def change(state):
        return torch.cat([(state[n] - w0[n]).flatten() for n in moving])

    return {
        "condition": rel(got["condition"], ref["condition"]),
        "loss": max(abs(a - b) / abs(b)
                    for a, b in zip(got["losses"], ref["losses"])),
        "grad": rel(torch.tensor([got["first_grads"][n] for n in norms]),
                    torch.tensor([g_ref[n] for n in norms])),
        "change": rel(change(got["params"]), change(ref["params"])),
        "ema": rel(change(got["ema"]), change(ref["ema"]))}


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(1)
    unet_w, vae_w = weights()
    data = batches()
    return unet_w, vae_w, data, reference_steps(unet_w, vae_w, data)


def test_the_step_matches_the_reference(case):
    unet_w, vae_w, data, ref = case
    got = gaps(port_steps(unet_w, vae_w, data), ref, unet_w)
    assert all(got[k] <= TOL[k] for k in TOL), got
    # the updates moved the parameters: the comparison is not of zeros
    assert all(float((ref["params"][n] - unet_w[n]).norm()) > 0
               for n in unet_w)


def _zeroed(original):
    def cond(*args, **kw):
        return torch.zeros_like(original(*args, **kw))
    return cond


class _NearestF:
    """torch.nn.functional with a resize that takes rows 0, 4, 8, 12."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def interpolate(x, size=None, mode=None):
        return F.interpolate(x, size=size, mode="nearest")


@pytest.mark.parametrize("fault", ["zero_condition", "nearest_resize"])
def test_planted_faults_fail_the_comparison(case, fault, monkeypatch):
    unet_w, vae_w, data, ref = case
    if fault == "zero_condition":
        monkeypatch.setattr(conditions, "_masked_image_cond",
                            _zeroed(conditions._masked_image_cond))
    else:
        monkeypatch.setattr(conditions, "F", _NearestF())
    got = gaps(port_steps(unet_w, vae_w, data), ref, unet_w)
    assert got["condition"] > 100 * TOL["condition"], got
    assert any(got[k] > TOL[k] for k in TOL if k != "condition"), got
