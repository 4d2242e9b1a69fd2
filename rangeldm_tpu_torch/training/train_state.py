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
from typing import Any, Callable, Dict, Iterable, List, Optional

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


def adam_state_dict(optimizer: torch.optim.Optimizer, named_params,
                    prefix: str) -> Dict[str, Any]:
    """An Adam or AdamW optimizer's moments as CPU copies under
    '{prefix}/exp_avg/{name}' and '{prefix}/exp_avg_sq/{name}', and its
    update count under '{prefix}_count' (0 before the first update)."""
    names = {id(p): n for n, p in named_params}
    out: Dict[str, Any] = {}
    counts = set()
    for p, st in optimizer.state.items():
        for key in ("exp_avg", "exp_avg_sq"):
            out[f"{prefix}/{key}/{names[id(p)]}"] = st[key].detach().to(
                "cpu", copy=True)
        counts.add(int(st["step"]))
    if len(counts) > 1:
        raise ValueError(f"the optimizer's parameters disagree on the "
                         f"update count: {sorted(counts)}")
    out[f"{prefix}_count"] = counts.pop() if counts else 0
    return out


def load_adam_state(optimizer: torch.optim.Optimizer, named_params,
                    sd: Dict[str, Any], prefix: str) -> None:
    """Restore what `adam_state_dict` wrote, keeping the optimizer's
    parameter groups and hyperparameters."""
    opt = optimizer.state_dict()
    index = {id(p): i for i, p in enumerate(
        p for group in optimizer.param_groups for p in group["params"])}
    state = {}
    for name, p in named_params:
        if f"{prefix}/exp_avg/{name}" in sd:
            state[index[id(p)]] = {
                "step": torch.tensor(float(sd[f"{prefix}_count"])),
                "exp_avg": sd[f"{prefix}/exp_avg/{name}"],
                "exp_avg_sq": sd[f"{prefix}/exp_avg_sq/{name}"]}
    optimizer.load_state_dict({"state": state,
                               "param_groups": opt["param_groups"]})


@dataclasses.dataclass
class TrainState:
    """The step count (updates made so far), the model, its optimizer and
    learning-rate schedule, the EMA shadow of its parameters (f32 tensors
    in `model.parameters()` order, or None) and the generator the train
    step draws its noise and timesteps from (or None).

    The JAX package folds the step into a fixed key every step, so its
    draws follow from the step alone; here one generator advances every
    step, so its state is part of the train state and of a checkpoint."""
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    ema: Optional[List[torch.Tensor]] = None
    grad_clip: float = 1.0
    generator: Optional[torch.Generator] = None

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

    def state_dict(self) -> Dict[str, Any]:
        """Everything the next update, EMA update and draw read, as one
        flat dict of JSON scalars and CPU copies of the tensors: the
        model's state dict under 'model/', the EMA under 'ema/' and AdamW's
        moments under 'adam/exp_avg/' and 'adam/exp_avg_sq/' (each under
        the parameter's name), 'step', AdamW's update count 'adam_count',
        and the generator's state as hex under 'generator'. The EMA's decay
        and the learning rate are functions of 'step'."""
        def copy(t: torch.Tensor) -> torch.Tensor:
            return t.detach().to("cpu", copy=True)

        out: Dict[str, Any] = {f"model/{k}": copy(v) for k, v in
                               self.model.state_dict().items()}
        if self.ema is not None:
            for (name, _), e in zip(self.model.named_parameters(), self.ema):
                out[f"ema/{name}"] = copy(e)
        out.update(adam_state_dict(self.optimizer,
                                   self.model.named_parameters(), "adam"))
        out["step"] = int(self.step)
        if self.generator is not None:
            out["generator"] = bytes(
                self.generator.get_state().numpy()).hex()
        return out

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore what `state_dict` returned, in place: the model's and
        the EMA's tensors are copied into the existing ones, so the
        optimizer keeps its parameters."""
        self.model.load_state_dict(
            {k[len("model/"):]: v for k, v in sd.items()
             if k.startswith("model/")}, strict=True)
        named = list(self.model.named_parameters())
        if self.ema is not None:
            with torch.no_grad():
                for (name, _), e in zip(named, self.ema):
                    e.copy_(sd[f"ema/{name}"])
        load_adam_state(self.optimizer, named, sd, "adam")
        self.step = int(sd["step"])
        if self.generator is not None:
            if "generator" not in sd:
                raise ValueError("the checkpoint holds no generator state")
            self.generator.set_state(torch.tensor(
                list(bytes.fromhex(sd["generator"])), dtype=torch.uint8))
