"""VAE-GAN training: one generator step, then one discriminator step, per
batch (the JAX package's rangeldm_tpu/training/vae_trainer.py, after the
reference's GeneralLPIPSWithDiscriminator,
vae/sgm/modules/autoencoding/losses/__init__.py:89-378, and the engine's
two-optimizer training_step, vae/sgm/models/autoencoder.py:186-221).

Images are (B, C, W=azimuth, H=beams), channel 0 the normalized range and
channel 1 the intensity. The loss arithmetic is float32 whatever
`compute_dtype` is; bf16 autocast covers the VAE's and the
discriminator's forwards only.

The generator step's adaptive weight
‖∂nll/∂W_last‖ / (‖∂g/∂W_last‖ + 1e-4), W_last the decoder's conv_out
weight, is the reference's `torch.autograd.grad` of each loss on the
step's own graph (losses/__init__.py:200-215): the discriminator runs once
per generator step, so its running statistics move once, as in the JAX
package. The JAX package's fast path (features before conv_out, one
vjp; vae_trainer.py:236-276) computes the same numbers except in one
place: its mirrored nll leaves out the used_feature multiplicity of a
per-sample perceptual term, which this module's graph carries, as the
reference's does.

Both steps take the posterior noise as a tensor, or draw it from a
`torch.Generator`; the trainer (train_vae.py) seeds one generator per
step and stream, so a resumed run draws what an uninterrupted one draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from rangeldm_tpu_torch.models.vae import (
    AutoencoderKL, gaussian_kl, gaussian_sample,
)
from rangeldm_tpu_torch.training.ema import ema_update, warmup_decay
from rangeldm_tpu_torch.training.train_state import (
    adam_state_dict, load_adam_state,
)

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class VaeLossConfig:
    disc_start: int = 200000
    disc_weight: float = 0.5
    disc_factor: float = 1.0
    range_weight: float = 40.0
    intensity_weight: float = 10.0
    used_feature: int = 2
    kl_weight: float = 1e-6
    disc_loss: str = "hinge"            # 'hinge' | 'vanilla'
    learn_logvar: bool = False
    logvar_init: float = 0.0
    ema_decay: float = 0.9999
    # optional branches (losses/__init__.py:239-305)
    encoding: str = "linear"            # 'linear' | 'log' | 'inverse'
    use_rec_loss_true: bool = False     # L1 in decoded range
    use_rec_loss_true_power: bool = False
    rec_power: float = 2.0
    bev_rec_weight: float = 0.0         # L1 on the BEV log-density
    perceptual_weight: float = 0.0
    bev_perceptual: bool = False        # perceptual loss over BEV grids
    disc_bev: bool = False              # the discriminator sees BEV grids

    @property
    def needs_voxels(self) -> bool:
        return self.bev_rec_weight > 0 or self.bev_perceptual or self.disc_bev


def true_range_l1(x: torch.Tensor, xrec: torch.Tensor,
                  cfg: VaeLossConfig) -> torch.Tensor:
    """L1 in decoded range (losses/__init__.py:239-242): log ->
    |64^a - 64^b|, inverse -> |1/max(a, 1e-4) - 1/max(b, 1e-4)|."""
    a, b = x[:, 0], xrec[:, 0]
    if cfg.encoding == "log":
        return torch.abs(64.0 ** a - 64.0 ** b)
    if cfg.encoding == "inverse":
        return torch.abs(1.0 / torch.clamp(a, min=1e-4)
                         - 1.0 / torch.clamp(b, min=1e-4))
    raise NotImplementedError(
        "true-range loss requires log or inverse encoding "
        "(losses/__init__.py:244-245)")


def reconstruction_loss(x: torch.Tensor, xrec: torch.Tensor,
                        cfg: VaeLossConfig) -> torch.Tensor:
    """Channel-weighted L1 summed over channels, (B, W, H)
    (losses/__init__.py:239-254)."""
    if cfg.use_rec_loss_true:
        rec = true_range_l1(x, xrec, cfg)
    elif cfg.use_rec_loss_true_power:
        if cfg.encoding != "log":
            raise NotImplementedError(
                "rec_loss_true_power requires log encoding (:248-249)")
        rec = torch.abs((64.0 ** x[:, 0]) ** cfg.rec_power
                        - (64.0 ** xrec[:, 0]) ** cfg.rec_power)
    else:
        rec = cfg.range_weight * torch.abs(x[:, 0] - xrec[:, 0])
    if cfg.used_feature > 1:
        rec = rec + cfg.intensity_weight * torch.abs(x[:, 1] - xrec[:, 1])
    return rec


def bev_three_channel(vox: torch.Tensor) -> torch.Tensor:
    """(B, 2, Gy, Gx) [density, intensity] -> (density, density, intensity)
    for image perceptual nets (losses/__init__.py:270-274)."""
    return torch.cat([vox[:, :1], vox[:, :1], vox[:, 1:]], dim=1)


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real.float()))
                  + torch.mean(F.relu(1.0 + logits_fake.float())))


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.softplus(-logits_real.float()))
                  + torch.mean(F.softplus(logits_fake.float())))


def adam(params, lr: float) -> torch.optim.Adam:
    """optax.adam(lr) with its defaults: betas (0.9, 0.999), eps 1e-8
    outside the square root."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class VaeGanState:
    """The step count, the VAE, the NLL's `logvar` (a 0-dim parameter),
    the discriminator (its BatchNorm running statistics are buffers), one
    Adam for the VAE and logvar and one for the discriminator, and the EMA
    shadow of the VAE's parameters (f32, in `vae.parameters()` order) with
    its update count."""
    step: int
    vae: AutoencoderKL
    logvar: nn.Parameter
    disc: nn.Module
    gen_opt: torch.optim.Adam
    disc_opt: torch.optim.Adam
    ema: List[torch.Tensor]
    ema_updates: int = 0

    @classmethod
    def create(cls, vae: AutoencoderKL, disc: nn.Module, lr: float,
               cfg: VaeLossConfig) -> "VaeGanState":
        dev = next(vae.parameters()).device
        logvar = nn.Parameter(torch.tensor(float(cfg.logvar_init),
                                           device=dev))
        ema = [p.detach().float().clone() for p in vae.parameters()]
        return cls(0, vae, logvar, disc,
                   adam(list(vae.parameters()) + [logvar], lr),
                   adam(disc.parameters(), lr), ema)

    def gen_named(self):
        return list(self.vae.named_parameters()) + [("logvar", self.logvar)]

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The EMA shadow under the VAE's parameter names."""
        return {n: e for (n, _), e in zip(self.vae.named_parameters(),
                                          self.ema)}

    def state_dict(self) -> Dict[str, Any]:
        """One flat dict of JSON scalars and CPU tensors: 'vae/', 'disc/'
        (running statistics included), 'ema/' and the two Adams'
        'adam_gen/' and 'adam_disc/' moments by parameter name, 'logvar',
        'step', 'ema_updates' and the update counts."""
        def copy(t: torch.Tensor) -> torch.Tensor:
            return t.detach().to("cpu", copy=True)

        out: Dict[str, Any] = {f"vae/{k}": copy(v) for k, v in
                               self.vae.state_dict().items()}
        out.update({f"disc/{k}": copy(v) for k, v in
                    self.disc.state_dict().items()})
        out["logvar"] = copy(self.logvar)
        out.update({f"ema/{k}": copy(v)
                    for k, v in self.ema_state_dict().items()})
        out.update(adam_state_dict(self.gen_opt, self.gen_named(),
                                   "adam_gen"))
        out.update(adam_state_dict(self.disc_opt,
                                   self.disc.named_parameters(), "adam_disc"))
        out["step"] = int(self.step)
        out["ema_updates"] = int(self.ema_updates)
        return out

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore what `state_dict` returned, in place."""
        for prefix, module in (("vae/", self.vae), ("disc/", self.disc)):
            module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                                    if k.startswith(prefix)}, strict=True)
        with torch.no_grad():
            self.logvar.copy_(sd["logvar"])
            for (name, _), e in zip(self.vae.named_parameters(), self.ema):
                e.copy_(sd[f"ema/{name}"])
        load_adam_state(self.gen_opt, self.gen_named(), sd, "adam_gen")
        load_adam_state(self.disc_opt, list(self.disc.named_parameters()),
                        sd, "adam_disc")
        self.step = int(sd["step"])
        self.ema_updates = int(sd["ema_updates"])


def _apply(opt: torch.optim.Optimizer, params: List[torch.Tensor],
           grads) -> None:
    """One optimizer update from `grads` (None for an unused parameter:
    a zero gradient, as optax sees it), leaving no .grad behind."""
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    opt.step()
    for p in params:
        p.grad = None


def make_vae_gan_steps(cfg: VaeLossConfig,
                       voxel_fn: Optional[Callable] = None,
                       perceptual_fn: Optional[Callable] = None,
                       compute_dtype: torch.dtype = torch.float32):
    """(gen_step, disc_step), each `(state, x, noise=None, generator=None)
    -> metrics` (0-dim f32 tensors, no host synchronisation). `x` is the
    (B, C, W, H) f32 batch on the state's device; `noise` the standard
    normal posterior draw, (B, Z, W/f, H/f), else drawn from `generator`.

    voxel_fn: (B, C, W, H) images -> (B, 2, Gy, Gx) BEV grids; needed by
    the BEV branches. perceptual_fn: (x, y) -> (B,) or a broadcastable
    loss; needed when perceptual_weight > 0."""
    d_loss_fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
    if cfg.needs_voxels and voxel_fn is None:
        raise ValueError("voxel_fn required for the BEV loss branches")
    if cfg.perceptual_weight > 0 and perceptual_fn is None:
        raise ValueError("perceptual_fn required when perceptual_weight > 0")

    def autocast(x: torch.Tensor):
        if compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(x.device.type, dtype=compute_dtype)

    def disc_input(x, vox=None):
        """Range images, or with disc_bev their BEV grids as (B, 2, Gx,
        Gy) (losses/__init__.py:310-312, 361-363)."""
        if not cfg.disc_bev:
            return x
        v = vox if vox is not None else voxel_fn(x)
        return v.transpose(2, 3)

    def forward(vae, x, noise, generator):
        with autocast(x):
            moments = vae.encode_moments(x).float()
        z = gaussian_sample(moments, generator, noise)
        with autocast(x):
            xrec = vae.decode(z).float()
        return xrec, moments

    def disc_factor_at(step: int) -> float:
        return cfg.disc_factor if step >= cfg.disc_start else 0.0

    def gen_step(state: VaeGanState, x: torch.Tensor,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Metrics:
        vae, disc = state.vae.train(), state.disc.train()
        logvar = state.logvar if cfg.learn_logvar else state.logvar.detach()
        xrec, moments = forward(vae, x, noise, generator)
        b = x.shape[0]

        rec = reconstruction_loss(x, xrec, cfg)
        extra: Metrics = {}
        if cfg.encoding in ("log", "inverse") and not cfg.use_rec_loss_true:
            extra["rec_loss_true"] = true_range_l1(x, xrec, cfg).mean()
        vox_in = vox_rec = None
        if cfg.needs_voxels:
            vox_in, vox_rec = voxel_fn(x), voxel_fn(xrec)
        if cfg.perceptual_weight > 0:
            if cfg.bev_perceptual:
                p_loss = perceptual_fn(bev_three_channel(vox_in),
                                       bev_three_channel(vox_rec))
            else:
                p_loss = perceptual_fn(x, xrec)
            p_loss = p_loss.float()
            extra["p_loss"] = p_loss.mean()
            if p_loss.dim() == 1:
                # the reference adds p_loss to the elementwise (B, C, W, H)
                # map; `rec` is summed over C, so the term counts C times
                p_loss = p_loss[:, None, None] * cfg.used_feature
            rec = rec + cfg.perceptual_weight * p_loss

        # logvar once per element of the reference's (B, C, W, H) map
        nll = rec / torch.exp(logvar) + cfg.used_feature * logvar
        nll_loss = nll.sum() / b
        if cfg.bev_rec_weight > 0:
            bev = cfg.bev_rec_weight * torch.abs(vox_in[:, 0] - vox_rec[:, 0])
            nll_loss = nll_loss + bev.sum() / b
            extra["bev_rec_loss"] = bev.mean()
        kl_loss = gaussian_kl(moments).sum() / b

        with autocast(x):
            logits_fake = disc(disc_input(xrec, vox_rec))
        g_loss = -torch.mean(logits_fake.float())

        w_last = vae.decoder.conv_out.weight
        (nll_g,) = torch.autograd.grad(nll_loss, w_last, retain_graph=True)
        (g_g,) = torch.autograd.grad(g_loss, w_last, retain_graph=True)
        d_weight = torch.clamp(
            torch.linalg.vector_norm(nll_g)
            / (torch.linalg.vector_norm(g_g) + 1e-4), 0.0, 1e4).detach()
        d_weight = d_weight * cfg.disc_weight

        df = disc_factor_at(state.step)
        logvar_used = logvar.detach().clone()
        loss = nll_loss + d_weight * df * g_loss + cfg.kl_weight * kl_loss
        params = [p for _, p in state.gen_named()]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        _apply(state.gen_opt, params, grads)

        state.ema_updates += 1
        ema_update(state.ema, vae.parameters(),
                   warmup_decay(state.ema_updates, cfg.ema_decay))
        state.step += 1
        metrics = {"total_loss": loss, "nll_loss": nll_loss,
                   "rec_loss": rec.mean(), "kl_loss": kl_loss,
                   "g_loss": g_loss, "d_weight": d_weight,
                   "disc_factor": torch.tensor(df, device=x.device),
                   "logvar": logvar_used, **extra}
        return {k: v.detach() for k, v in metrics.items()}

    def disc_step(state: VaeGanState, x: torch.Tensor,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Metrics:
        vae, disc = state.vae, state.disc.train()
        with torch.no_grad():
            xrec, _ = forward(vae, x, noise, generator)
        with autocast(x):
            # real, then fake: the second pass starts from the running
            # statistics the first one left
            logits_real = disc(disc_input(x))
            logits_fake = disc(disc_input(xrec))
        # gen_step advanced the step already: both halves of a batch share
        # one global step (losses/__init__.py:316-336)
        df = disc_factor_at(state.step - 1)
        d_loss = df * d_loss_fn(logits_real, logits_fake)
        params = list(disc.parameters())
        _apply(state.disc_opt, params,
               torch.autograd.grad(d_loss, params, allow_unused=True))
        return {"disc_loss": d_loss.detach(),
                "logits_real": logits_real.detach().float().mean(),
                "logits_fake": logits_fake.detach().float().mean()}

    return gen_step, disc_step
