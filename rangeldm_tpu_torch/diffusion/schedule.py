"""DDPM / DDIM / DPM-Solver++(2M) noise schedules.

The diffusers `DDPMScheduler` / `DDIMScheduler` configuration the reference
trains and samples with (ldm/train_unconditional.py:345-354,
ldm/pipelines.py:139): 1000 linear betas 1e-4..0.02, epsilon prediction,
no sample clipping, fixed-small variance, DDIM with set_alpha_to_one and
leading timestep spacing.

The sampling loop runs on the host and steps one timestep at a time, so the
step functions take Python ints (t, t_prev) with t_prev = -1 marking the
final sigma = 0 boundary. The scalar coefficients are computed in numpy
float32, the precision of the JAX package's f32 path, and applied to the
tensors as scalars. (Under bf16 the JAX package rounds the coefficients to
bf16 before combining them; here they stay f32.)

The training step draws one timestep per sample, so its functions
(`add_noise`, `get_velocity`, `snr`, `min_snr_weight`) take a (B,) tensor of
timesteps and gather the coefficients on the tensor's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    beta_schedule: str = "linear"          # 'linear' | 'scaled_linear' | 'squaredcos_cap_v2'
    prediction_type: str = "epsilon"       # 'epsilon' | 'v_prediction' | 'sample'
    clip_sample: bool = False
    set_alpha_to_one: bool = True          # DDIM final alpha_cumprod = 1
    steps_offset: int = 0
    timestep_spacing: str = "leading"      # 'leading' | 'trailing'


def make_betas(cfg: ScheduleConfig) -> np.ndarray:
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float32)
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, n,
                           dtype=np.float32) ** 2
    if cfg.beta_schedule == "squaredcos_cap_v2":
        def bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        ts = np.arange(n, dtype=np.float64)
        betas = 1.0 - bar((ts + 1) / n) / bar(ts / n)
        return np.minimum(betas, 0.999).astype(np.float32)
    raise ValueError(cfg.beta_schedule)


class Schedule:
    """Precomputed schedule (float32 numpy) and its step functions."""

    # Half-log-SNR cap standing in for lambda(t_prev < 0) = +inf at the
    # acp = 1 final boundary: exp(-(40 - lam_s)) underflows to 0 in f32 for
    # every reachable lam_s, so expm1(-h) is exactly -1 there.
    _LAMBDA_MAX = f32(40.0)
    init_noise_sigma = 1.0

    def __init__(self, cfg: ScheduleConfig = ScheduleConfig()):
        self.cfg = cfg
        self.betas = make_betas(cfg)
        self.alphas_cumprod = torch.cumprod(
            torch.from_numpy(f32(1) - self.betas), 0).numpy()
        self._tables = {}           # device -> alphas_cumprod on it

    def _acp(self, t, final: Optional[float] = None):
        """alpha_cumprod[t]; t < 0 gives the final value: for DDIM 1.0 when
        set_alpha_to_one, else alphas_cumprod[0]. DDPM passes final=1.0
        (diffusers DDPMScheduler uses `self.one` whatever the config).
        A Python int gives a numpy float32; a tensor of timesteps gives an
        f32 tensor of its shape on its device."""
        if final is None:
            final = (1.0 if self.cfg.set_alpha_to_one
                     else self.alphas_cumprod[0])
        last = self.cfg.num_train_timesteps - 1
        if isinstance(t, torch.Tensor):
            table = self._tables.get(t.device)
            if table is None:
                table = self._tables[t.device] = torch.from_numpy(
                    self.alphas_cumprod).to(t.device)
            acp = table[t.clamp(0, last).long()]
            return torch.where(t < 0, torch.full_like(acp, float(final)),
                               acp)
        if t >= 0:
            return self.alphas_cumprod[min(t, last)]
        return f32(final)

    @staticmethod
    def _bc(v: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        """(B,) coefficients broadcast over the trailing dims of ref, in
        ref's dtype."""
        return v.reshape(v.shape + (1,) * (ref.dim() - v.dim())).to(ref.dtype)

    # --- training ------------------------------------------------------
    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """The forward process: sqrt(acp_t) x0 + sqrt(1 - acp_t) noise."""
        acp = self._acp(t)
        return (self._bc(torch.sqrt(acp), x0) * x0
                + self._bc(torch.sqrt(1.0 - acp), x0) * noise)

    def get_velocity(self, x0: torch.Tensor, noise: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
        """The v-prediction target sqrt(acp_t) noise - sqrt(1 - acp_t) x0."""
        acp = self._acp(t)
        return (self._bc(torch.sqrt(acp), x0) * noise
                - self._bc(torch.sqrt(1.0 - acp), x0) * x0)

    def snr(self, t: torch.Tensor) -> torch.Tensor:
        """compute_snr (ldm/train_unconditional.py:53-75)."""
        acp = self._acp(t)
        return acp / (1.0 - acp)

    def min_snr_weight(self, t: torch.Tensor, gamma: float,
                       velocity: bool = False) -> torch.Tensor:
        """Min-SNR loss weighting (arXiv:2303.09556;
        ldm/train_unconditional.py:527-543)."""
        snr = self.snr(t)
        if velocity:
            snr = snr + 1.0
        return torch.clamp(snr, max=gamma) / snr

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """'leading': (arange(n) * (T // n)).round()[::-1] + offset, the
        diffusers default the reference samples with. 'trailing':
        round(arange(T, 0, -T/n)) - 1, which starts at t = T - 1."""
        n = num_inference_steps
        T = self.cfg.num_train_timesteps
        if self.cfg.timestep_spacing == "trailing":
            # [:n]: the float arange overshoots for some n
            ts = (np.round(np.arange(T, 0, -T / n)) - 1)[:n]
            if len(ts) != n:
                raise ValueError(f"trailing spacing gave {len(ts)} steps "
                                 f"for {n}")
            return ts.astype(np.int32)
        ratio = T // n
        ts = (np.arange(n) * ratio).round()[::-1]
        return (ts + self.cfg.steps_offset).astype(np.int32)

    def pred_x0(self, model_out: torch.Tensor, t: int,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x0, eps) predicted from the model output at timestep t."""
        a = self._acp(t)
        sa, s1a = float(np.sqrt(a)), float(np.sqrt(f32(1) - a))
        p = self.cfg.prediction_type
        if p == "epsilon":
            x0 = (x - s1a * model_out) / sa
            eps = model_out
        elif p == "v_prediction":
            x0 = sa * x - s1a * model_out
            eps = sa * model_out + s1a * x
        elif p == "sample":
            x0 = model_out
            eps = (x - sa * x0) / s1a
        else:
            raise ValueError(p)
        if self.cfg.clip_sample:
            x0 = torch.clamp(x0, -1.0, 1.0)
            eps = (x - sa * x0) / s1a
        return x0, eps

    def ddpm_step(self, model_out: torch.Tensor, t: int, t_prev: int,
                  x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """One ancestral DDPM step x_t -> x_{t_prev} (fixed-small
        variance); `noise` is standard normal of x's shape."""
        a_t = self._acp(t)
        a_prev = self._acp(t_prev, final=1.0)
        beta_prod = f32(1) - a_t
        beta_prod_prev = f32(1) - a_prev
        alpha_cur = a_t / a_prev
        beta_cur = f32(1) - alpha_cur
        x0, _ = self.pred_x0(model_out, t, x)
        coef_x0 = np.sqrt(a_prev) * beta_cur / beta_prod
        coef_xt = np.sqrt(alpha_cur) * beta_prod_prev / beta_prod
        mean = float(coef_x0) * x0 + float(coef_xt) * x
        if t <= 0:
            return mean
        var = max(beta_prod_prev / beta_prod * beta_cur, f32(1e-20))
        return mean + float(np.sqrt(var)) * noise

    def half_log_snr(self, t: int) -> np.float32:
        """lambda_t = 0.5 * log(acp / (1 - acp)) (arXiv:2211.01095 eq. 4);
        t < 0 maps to the finite _LAMBDA_MAX."""
        if t < 0:
            return self._LAMBDA_MAX
        acp = np.clip(self._acp(t), f32(1e-20), f32(1.0 - 1e-7))
        return f32(0.5) * (np.log(acp) - np.log1p(-acp))

    def dpmpp_2m_step(self, model_out: torch.Tensor, t: int, t_prev: int,
                      x: torch.Tensor, prev_x0: torch.Tensor,
                      h_prev: np.float32, use_first_order: bool):
        """One DPM-Solver++(2M) update x_t -> x_{t_prev} (arXiv:2211.01095,
        data prediction, order 2). The first step and the final sigma = 0
        step are first order; interior steps add the 0.5 * phi * D1
        correction, D1 extrapolating x0 over the previous step size.
        Returns (x_prev, x0, h)."""
        x0, _ = self.pred_x0(model_out, t, x)
        acp_t = self._acp(t)
        acp_prev = self._acp(t_prev)
        h = self.half_log_snr(t_prev) - self.half_log_snr(t)
        ratio = np.sqrt((f32(1) - acp_prev) / (f32(1) - acp_t))
        phi = np.expm1(-h)
        alpha_prev = np.sqrt(acp_prev)
        first = float(ratio) * x - float(alpha_prev * phi) * x0
        if use_first_order or t_prev < 0:
            return first, x0, h
        d1 = (x0 - prev_x0) * float(h / h_prev)
        return first - float(f32(0.5) * alpha_prev * phi) * d1, x0, h

    def ddim_step(self, model_out: torch.Tensor, t: int, t_prev: int,
                  x: torch.Tensor, eta: float = 0.0,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One DDIM step; eta = 0 is deterministic, eta > 0 needs `noise`."""
        a_t = self._acp(t)
        a_prev = self._acp(t_prev)
        x0, eps = self.pred_x0(model_out, t, x)
        if eta > 0.0:
            if noise is None:
                raise ValueError("ddim_step with eta > 0 needs noise")
            var = ((f32(1) - a_prev) / (f32(1) - a_t)
                   * (f32(1) - a_t / a_prev))
            std = f32(eta) * np.sqrt(var)
            direction = float(np.sqrt(f32(1) - a_prev - std ** 2)) * eps
        else:
            direction = float(np.sqrt(f32(1) - a_prev)) * eps
        prev = float(np.sqrt(a_prev)) * x0 + direction
        if eta > 0.0:
            prev = prev + float(std) * noise
        return prev
