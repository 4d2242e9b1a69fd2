"""Train state and the optimizer of the LDM trainer.

`make_adamw` reproduces the JAX package's
`optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, ...))`
(rangeldm_tpu/training/train_state.py:27-48), the reference's AdamW with
gradient clipping and a warm-up learning-rate schedule
(ldm/train_unconditional.py:357-363, 394-399):

* the clip scales the gradients by max_norm / norm only when
  norm >= max_norm, as optax does (torch's `clip_grad_norm_` divides by
  norm + 1e-6 always);
* the learning rate of an update is the schedule at the count of updates
  made before it, so with a warm-up the first update has learning rate 0;
* `torch.optim.AdamW` makes optax's `adamw` update: bias-corrected moments,
  eps outside the square root, weight decay decoupled and scaled by the
  learning rate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional

import torch


def warmup_cosine_schedule(peak: float, warmup_steps: int, decay_steps: int,
                           end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps, end_value): linear from 0 to peak over warmup_steps, then a
    cosine from peak to end_value that ends at decay_steps."""
    alpha = 0.0 if peak == 0.0 else end_value / peak
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak * count / warmup_steps
        frac = min(count - warmup_steps, cosine_steps) / cosine_steps
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac))
                       + alpha)

    return schedule


def warmup_constant_schedule(peak: float,
                             warmup_steps: int) -> Callable[[int], float]:
    """optax.join_schedules([linear_schedule(0, peak, warmup_steps),
    constant_schedule(peak)], [warmup_steps])."""
    def schedule(count: int) -> float:
        return peak * count / warmup_steps if count < warmup_steps else peak

    return schedule


@dataclasses.dataclass
class Tx:
    """The optimizer chain: AdamW, its learning-rate schedule and the
    global-norm clip applied before it."""
    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    grad_clip: float


def make_adamw(params: Iterable[torch.nn.Parameter],
               learning_rate: float = 1e-4, warmup_steps: int = 500,
               total_steps: int = 1_000_000, schedule: str = "cosine",
               beta1: float = 0.95, beta2: float = 0.999,
               weight_decay: float = 1e-6, eps: float = 1e-8,
               grad_clip: float = 1.0) -> Tx:
    """AdamW + clip + learning-rate schedule over `params`, as the JAX
    package's `make_adamw`."""
    if schedule == "cosine":
        lr = warmup_cosine_schedule(learning_rate, warmup_steps,
                                    max(total_steps, warmup_steps + 1))
    elif schedule == "constant":
        lr = warmup_constant_schedule(learning_rate, warmup_steps)
    else:
        raise ValueError(schedule)
    opt = torch.optim.AdamW(params, lr=lr(0), betas=(beta1, beta2), eps=eps,
                            weight_decay=weight_decay)
    return Tx(opt, lr, float(grad_clip))


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@torch.no_grad()
def clip_by_global_norm_(tensors: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """Scale in place by max_norm / norm where norm >= max_norm; leave the
    tensors as they are below it. No host synchronisation."""
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(tensors, factor)


@dataclasses.dataclass
class TrainState:
    """The step count (updates made so far), the model, its optimizer and
    learning-rate schedule, and the EMA shadow of its parameters (f32
    tensors in `model.parameters()` order, or None)."""
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    ema: Optional[List[torch.Tensor]] = None
    grad_clip: float = 1.0

    @classmethod
    def create(cls, model: torch.nn.Module, tx: Tx,
               with_ema: bool = True) -> "TrainState":
        ema = ([p.detach().float().clone() for p in model.parameters()]
               if with_ema else None)
        return cls(0, model, tx.optimizer, tx.schedule, ema, tx.grad_clip)

    def apply_gradients(self) -> torch.Tensor:
        """One optimizer update from the parameters' gradients: the global
        norm (returned, taken before the clip), the clip, then AdamW at the
        learning rate of the pre-increment step. The step count is the
        caller's to advance."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        norm = global_norm(grads)
        clip_by_global_norm_(grads, self.grad_clip, norm)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        return norm

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The EMA shadow under the model's parameter names."""
        if self.ema is None:
            raise ValueError("this train state keeps no EMA")
        names = [n for n, _ in self.model.named_parameters()]
        return dict(zip(names, self.ema))
