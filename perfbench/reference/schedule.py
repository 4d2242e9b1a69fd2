"""The diffusers DDPM schedule of the reference configurations (1000
linear betas from 1e-4 to 0.02, epsilon prediction, no clipping, DDIM with
set_alpha_to_one and leading timestep spacing), its forward process, and
the DDIM (eta 0) and DPM-Solver++(2M) sampling chains of a latent
pipeline. Coefficients are float64 scalars; tensors are float32."""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch


class Schedule:
    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 1e-4, beta_end: float = 0.02):
        self.T = num_train_timesteps
        betas = np.linspace(beta_start, beta_end, self.T, dtype=np.float64)
        self.acp = np.cumprod(1.0 - betas)

    def alpha_bar(self, t: int) -> float:
        """alpha_cumprod[t]; 1.0 past the end (t < 0)."""
        return 1.0 if t < 0 else float(self.acp[t])

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        acp = torch.as_tensor(self.acp, dtype=torch.float32,
                              device=x0.device)[t.long()]
        shape = (-1,) + (1,) * (x0.dim() - 1)
        return (torch.sqrt(acp).reshape(shape) * x0
                + torch.sqrt(1.0 - acp).reshape(shape) * noise)

    def timesteps(self, n: int) -> List[int]:
        """Leading spacing: (0, T // n, 2 T // n, ...) reversed."""
        return [i * (self.T // n) for i in range(n)][::-1]

    def pairs(self, n: int):
        ts = self.timesteps(n)
        return list(zip(ts, ts[1:] + [-1]))

    def x0_of(self, eps: torch.Tensor, t: int, x: torch.Tensor):
        a = self.alpha_bar(t)
        return (x - math.sqrt(1.0 - a) * eps) / math.sqrt(a)

    def ddim(self, eps: torch.Tensor, t: int, t_prev: int,
             x: torch.Tensor) -> torch.Tensor:
        a_prev = self.alpha_bar(t_prev)
        return (math.sqrt(a_prev) * self.x0_of(eps, t, x)
                + math.sqrt(1.0 - a_prev) * eps)

    def half_log_snr(self, t: int) -> float:
        a = self.alpha_bar(t)
        return 0.5 * (math.log(a) - math.log1p(-a))


def sample(schedule: Schedule, model: Callable, x: torch.Tensor,
           num_steps: int, method: str) -> torch.Tensor:
    """The chain from x_T (B, C, W, H) to x_0 under `model(x, t) -> eps`:
    DDIM with eta 0, or DPM-Solver++(2M) (arXiv:2211.01095, data
    prediction; first order at the first step and at the last, whose
    sigma is 0, so that it returns the predicted x0)."""
    prev_x0, h_prev = None, None
    for i, (t, tp) in enumerate(schedule.pairs(num_steps)):
        eps = model(x, t)
        if method == "ddim":
            x = schedule.ddim(eps, t, tp, x)
            continue
        if method != "dpmpp":
            raise ValueError(method)
        x0 = schedule.x0_of(eps, t, x)
        if tp < 0:
            x = x0
            continue
        a_t, a_p = schedule.alpha_bar(t), schedule.alpha_bar(tp)
        h = schedule.half_log_snr(tp) - schedule.half_log_snr(t)
        phi = math.expm1(-h)
        ratio = math.sqrt((1.0 - a_p) / (1.0 - a_t))
        x_new = ratio * x - math.sqrt(a_p) * phi * x0
        if i > 0:
            x_new = x_new - 0.5 * math.sqrt(a_p) * phi * (
                x0 - prev_x0) * (h / h_prev)
        x, prev_x0, h_prev = x_new, x0, h
    return x
