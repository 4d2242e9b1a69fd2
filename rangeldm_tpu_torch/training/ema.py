"""EMA of parameters, the two decay laws of the reference's EMAs.

* `power_decay`: diffusers EMAModel with use_ema_warmup
  (ldm/train_unconditional.py:320-329),
  decay(step) = clip(1 - (1 + step / inv_gamma)^-power, min, max), where
  `step` is optimization_step - 1 (diffusers' get_decay subtracts 1, so the
  first update has decay 0 and the EMA starts as a copy of the parameters).
  The LDM trainer passes its pre-increment step count for that reason.
* `warmup_decay`: sgm LitEma (vae/sgm/modules/ema.py:33-54),
  decay(n) = min(decay, (1 + n) / (10 + n)); the VAE trainer's law.

The decays are host floats computed in float32, as the JAX package computes
them; `ema_update` moves f32 shadow tensors in place with foreach kernels,
by the weight `ema_weight(decay)` = 1 - decay: a float, or a 0-dim tensor
on the shadow's device that a captured CUDA graph reads at each replay
(the training step writes it before the step).
"""

from __future__ import annotations

from typing import Iterable, List, Union

import numpy as np
import torch

f32 = np.float32


def power_decay(step: int, inv_gamma: float = 1.0, power: float = 0.75,
                min_decay: float = 0.0, max_decay: float = 0.9999) -> float:
    """diffusers EMAModel.get_decay; pass optimization_step - 1."""
    step = max(f32(step), f32(0))
    value = f32(1) - (f32(1) + step / f32(inv_gamma)) ** f32(-power)
    return float(np.clip(value, f32(min_decay), f32(max_decay)))


def warmup_decay(num_updates: int, decay: float = 0.9999) -> float:
    """LitEma warm-up: min(decay, (1 + n) / (10 + n))."""
    n = f32(num_updates)
    return float(min(f32(decay), (f32(1) + n) / (f32(10) + n)))


def ema_weight(decay: float) -> float:
    """1 - decay in float32: the parameters' weight in an EMA update."""
    return float(f32(1) - f32(decay))


@torch.no_grad()
def ema_update(shadow: List[torch.Tensor], params: Iterable[torch.Tensor],
               weight: Union[float, torch.Tensor]) -> None:
    """shadow <- shadow - weight * (shadow - param), in place, with
    weight = ema_weight(decay) as a float or a 0-dim float32 tensor on the
    shadow's device (the same update, bit for bit)."""
    diff = torch._foreach_sub(
        shadow, [p.detach().to(s.dtype) for s, p in zip(shadow, params)])
    torch._foreach_mul_(diff, weight)
    torch._foreach_sub_(shadow, diff)
