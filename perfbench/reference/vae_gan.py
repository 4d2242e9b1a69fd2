"""The VAE-GAN training step of the KITTI-360 first stage in plain float32
(vae/configs/kitti360.yaml; the loss GeneralLPIPSWithDiscriminator,
vae/sgm/modules/autoencoding/losses/__init__.py:89-378, its MetaKernel
PatchGAN, vae/sgm/modules/autoencoding/lpips/model/model.py:91-265, and the
two-optimizer step, vae/sgm/models/autoencoder.py:186-221), per batch:

  generator:      encode -> posterior draw -> decode -> D(xrec) -> the
                  weighted L1 NLL with logvar, the KL, the hinge generator
                  loss -> the adaptive weight at decoder.conv_out.weight ->
                  gradients -> Adam -> EMA with LitEma's warm-up;
  discriminator:  the reconstruction again, without a gradient -> D(x),
                  D(xrec) -> hinge -> gradients -> Adam.

Images are (B, C, W=azimuth, H=beams), channel 0 the normalized range and
channel 1 the intensity; weights are dicts under the published state-dict
names (`encoder.*`, `decoder.*` as in vae.py, the discriminator's
`main.{i}.mlp_coord.{0,2}`, `main.{i}.coov`, `main.{i}` for BatchNorm).
The MetaKernel's patches are 16 shifted strided slices of the padded input,
one per (beam, azimuth) tap, each weighted by the coordinate MLP of its
own relative xyz; the taps are stacked in (channel, beam, azimuth) order
for the 1x1 `coov`.

Departures from upstream, each also the port's:
* BatchNorm moves its running variance towards the batch's biased
  variance (flax's rule; torch's BatchNorm2d takes the unbiased one);
* `logvar` is fixed at its initial 0 (learn_logvar false), so it is left
  out of Adam here: a zero gradient moves nothing;
* Adam has torch's defaults, betas (0.9, 0.999), eps 1e-8 outside the
  square root, no weight decay, for both networks;
* the posterior draws are given, not drawn: the caller passes the noise
  the program's generators make;
* no perceptual term (perceptual_weight 0 in the port's mirror of the
  config; upstream's point-cloud LPIPS needs pcdet's CUDA ops).

Nothing here imports the program; TF32 must be off where this runs on the
card (`precision.strict_float32`). The step functions return tensors and
never read one on the host, so that perfbench/work_vae_gan.py runs them on
the meta device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import vae as ref_vae
from perfbench.reference.layers import Params, wrap_azimuth
from perfbench.reference.precision import Precision

# the MetaKernel's angular steps (model.py:174-180): azimuth 2 pi / 1024,
# inclination from KITTI's beam spacing; both double after a stride-2 stage
AZIMUTH_STEP = 0.00613592
INCLINATION_STEP = 0.0074594
SLOPE = 0.2
BN_EPS, BN_MOMENTUM = 1e-5, 0.1
RANGE_FILL = 100.0          # decametres, beyond any return
K = 4                       # the 4x4 patch; padding 1


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, the gradient passed straight through."""
    x = x.float()
    return x + (x.to(torch.bfloat16).float() - x).detach()


# a control: the reference with bfloat16 operands in every product, the
# precision next below TF32
BF16 = Precision("bfloat16", _bf16_round)


# -- the discriminator -----------------------------------------------------

def disc_plan(lc: dict) -> List[tuple]:
    """The MetaKernel PatchGAN's modules in order: ("mk", name, in, out,
    stride, azimuth step, inclination step, LeakyReLU after) or ("bn",
    name, channels, LeakyReLU after)."""
    if lc.get("metakernel") is not True:
        raise ValueError("the reference covers the MetaKernel discriminator "
                         "(loss.metakernel: true)")
    n_layers, ndf = int(lc.get("disc_num_layers", 3)), int(lc.get(
        "disc_ndf", 64))
    azi, inc = AZIMUTH_STEP, INCLINATION_STEP
    plan = [("mk", "main.0", int(lc.get("used_feature", 2)), ndf, 2, azi,
             inc, True)]
    azi, inc, nf, idx = 2 * azi, 2 * inc, 1, 2
    for n in range(1, n_layers):
        prev, nf = nf, min(2 ** n, 8)
        plan += [("mk", f"main.{idx}", ndf * prev, ndf * nf, 2, azi, inc,
                  False), ("bn", f"main.{idx + 1}", ndf * nf, True)]
        azi, inc, idx = 2 * azi, 2 * inc, idx + 3
    prev, nf = nf, min(2 ** n_layers, 8)
    plan += [("mk", f"main.{idx}", ndf * prev, ndf * nf, 1, azi, inc, False),
             ("bn", f"main.{idx + 1}", ndf * nf, True),
             ("mk", f"main.{idx + 3}", ndf * nf, 1, 1, azi, inc, False)]
    return plan


def disc_param_shapes(lc: dict) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}
    for entry in disc_plan(lc):
        if entry[0] == "mk":
            _, name, cin, cout = entry[:4]
            out[name + ".mlp_coord.0.weight"] = (cin, 3)
            out[name + ".mlp_coord.0.bias"] = (cin,)
            out[name + ".mlp_coord.2.weight"] = (cin, cin)
            out[name + ".mlp_coord.2.bias"] = (cin,)
            out[name + ".coov.weight"] = (cout, cin * K * K, 1, 1)
            out[name + ".coov.bias"] = (cout,)
        else:
            out[entry[1] + ".weight"] = (entry[2],)
            out[entry[1] + ".bias"] = (entry[2],)
    return out


def disc_stats(lc: dict, device) -> Dict[str, torch.Tensor]:
    """BatchNorm's running statistics at their start: mean 0, variance 1."""
    out = {}
    for entry in disc_plan(lc):
        if entry[0] == "bn":
            out[entry[1] + ".running_mean"] = torch.zeros(entry[2],
                                                          device=device)
            out[entry[1] + ".running_var"] = torch.ones(entry[2],
                                                        device=device)
    return out


def _pad(v: torch.Tensor, fill: float) -> torch.Tensor:
    """Beams (dim 3) padded by one with `fill`, azimuth (dim 2) wrapped."""
    return wrap_azimuth(F.pad(v, (1, 1), value=fill), 1, 1)


def _tap(v: torch.Tensor, kb: int, ka: int, stride: int, wo: int,
         ho: int) -> torch.Tensor:
    """The (beam kb, azimuth ka) element of every patch of padded v:
    (B, C, Wo, Ho)."""
    return v[:, :, ka:ka + stride * (wo - 1) + 1:stride,
             kb:kb + stride * (ho - 1) + 1:stride]


def _linear(pr: Precision, p: Params, name: str,
            x: torch.Tensor) -> torch.Tensor:
    return F.linear(pr.q(x), pr.q(p[name + ".weight"]), p[name + ".bias"])


def metakernel(pr: Precision, p: Params, name: str, x: torch.Tensor,
               r: torch.Tensor, stride: int, azi: float, inc: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, out, Wo, Ho), the patch centres' range (B, 1, Wo, Ho)) of
    x (B, C, W, H) and its range r (B, 1, W, H) in decametres."""
    rp, xp = _pad(r, RANGE_FILL), _pad(x, 0.0)
    wo = (xp.shape[2] - K) // stride + 1
    ho = (xp.shape[3] - K) // stride + 1
    centre = _tap(rp, K // 2, K // 2, stride, wo, ho)
    products = []
    for kb in range(K):
        for ka in range(K):
            rt = _tap(rp, kb, ka, stride, wo, ho)[:, 0]
            da, di = azi * (ka - K // 2), inc * (kb - K // 2)
            # the tap's xyz relative to the patch centre
            pe = torch.stack([
                rt * (math.cos(da) * math.cos(di)) - centre[:, 0],
                rt * (math.cos(da) * math.sin(di)),
                rt * math.sin(da)], dim=-1)
            h = F.leaky_relu(_linear(pr, p, name + ".mlp_coord.0", pe),
                             SLOPE)
            w = _linear(pr, p, name + ".mlp_coord.2", h)     # (B, Wo, Ho, C)
            products.append(_tap(xp, kb, ka, stride, wo, ho)
                            * w.permute(0, 3, 1, 2))
    stacked = torch.stack(products, dim=2).flatten(1, 2)   # c * 16 + tap
    y = F.conv2d(pr.q(stacked), pr.q(p[name + ".coov.weight"]),
                 p[name + ".coov.bias"])
    return y, centre


def batch_norm(p: Params, stats: Dict[str, torch.Tensor], name: str,
               x: torch.Tensor) -> torch.Tensor:
    """Train-mode BatchNorm on the batch's mean and biased variance; the
    running statistics move a tenth of the way towards both."""
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    with torch.no_grad():
        for key, value in (("running_mean", mean), ("running_var", var)):
            old = stats[f"{name}.{key}"]
            stats[f"{name}.{key}"] = old + BN_MOMENTUM * (value.detach()
                                                          - old)
    scale = p[name + ".weight"] * torch.rsqrt(var + BN_EPS)
    return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
            + p[name + ".bias"][None, :, None, None])


def discriminator(cfg: dict, p: Params, stats: Dict[str, torch.Tensor],
                  x: torch.Tensor, pr: Precision) -> torch.Tensor:
    """Patch logits (B, 1, Wo, Ho) of images x; moves `stats`."""
    data = cfg["data"]
    r = (x[:, :1] * float(data["std"]) + float(data["mean"])) / 10.0
    h = x
    for entry in disc_plan(cfg["loss"]):
        if entry[0] == "mk":
            _, name, _, _, stride, azi, inc, act = entry
            h, r = metakernel(pr, p, name, h, r, stride, azi, inc)
        else:
            _, name, _, act = entry
            h = batch_norm(p, stats, name, h)
        if act:
            h = F.leaky_relu(h, SLOPE)
    return h


# -- the losses and the updates --------------------------------------------

def reconstruct(cfg: dict, vae_p: Params, x: torch.Tensor,
                noise: torch.Tensor, pr: Precision):
    """(reconstruction, posterior moments) of x with the posterior draw
    `noise`."""
    vc = cfg["vae"]
    moments = ref_vae.encode_moments(vc, vae_p, x, pr)
    z = ref_vae.posterior_sample(moments, noise)
    return ref_vae.decode(vc, vae_p, z, pr), moments


def kl(moments: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0, 1)) summed over each image, (B,)."""
    mean, logvar = torch.chunk(moments, 2, dim=1)
    logvar = torch.clamp(logvar, -30.0, 20.0)
    return 0.5 * (mean * mean + torch.exp(logvar) - 1.0 - logvar).sum(
        dim=(1, 2, 3))


def nll(lc: dict, x: torch.Tensor, xrec: torch.Tensor,
        logvar: float = 0.0) -> torch.Tensor:
    """The L1 NLL summed over the batch's pixels over the batch size:
    range_weight |range - rec| + intensity_weight |intensity - rec|, over
    exp(logvar), plus logvar once per channel of each pixel."""
    rec = (float(lc["range_weight"]) * (x[:, 0] - xrec[:, 0]).abs()
           + float(lc["intensity_weight"]) * (x[:, 1] - xrec[:, 1]).abs())
    return (rec / math.exp(logvar) + x.shape[1] * logvar).sum() / x.shape[0]


def hinge(logits_real: torch.Tensor, logits_fake: torch.Tensor
          ) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean()
                  + F.relu(1.0 + logits_fake).mean())


def adam(p: Params, grads: Params, state: dict, lr: float,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One bias-corrected Adam update of `p` in place of its entries;
    `state` holds the moments and the update count."""
    state["t"] = t = state.get("t", 0) + 1
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    for n, g in grads.items():
        m = state.setdefault("m", {}).get(n, torch.zeros_like(g))
        v = state.setdefault("v", {}).get(n, torch.zeros_like(g))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        state["m"][n], state["v"][n] = m, v
        p[n] = p[n] - (lr / bc1) * m / (torch.sqrt(v) / math.sqrt(bc2) + eps)


def ema_decay(updates: int, decay: float) -> float:
    """LitEma's warm-up, min(decay, (1 + n) / (10 + n)) in float32, at the
    update count after the update."""
    n = np.float32(updates)
    return float(min(np.float32(decay), (np.float32(1) + n)
                     / (np.float32(10) + n)))


def gen_step(cfg: dict, vae_p: Params, disc_p: Params,
             stats: Dict[str, torch.Tensor], x: torch.Tensor,
             noise: torch.Tensor, disc_factor: float, pr: Precision,
             logvar: float = 0.0) -> Tuple[Dict[str, torch.Tensor], Params]:
    """The generator's losses ({total, nll, kl, g, d_weight}) and its
    gradients by VAE parameter; moves `stats` once."""
    lc = cfg["loss"]
    leaves = {n: t.detach().requires_grad_(True) for n, t in vae_p.items()}
    xrec, moments = reconstruct(cfg, leaves, x, noise, pr)
    logits_fake = discriminator(cfg, disc_p, stats, xrec, pr)
    nll_loss = nll(lc, x, xrec, logvar)
    kl_loss = kl(moments).sum() / x.shape[0]
    g_loss = -logits_fake.mean()
    w_last = leaves["decoder.conv_out.weight"]
    (nll_g,) = torch.autograd.grad(nll_loss, w_last, retain_graph=True)
    (g_g,) = torch.autograd.grad(g_loss, w_last, retain_graph=True)
    d_weight = torch.clamp(nll_g.norm() / (g_g.norm() + 1e-4), 0.0,
                           1e4).detach() * float(lc["disc_weight"])
    total = (nll_loss + d_weight * disc_factor * g_loss
             + float(lc["kl_weight"]) * kl_loss)
    names = list(leaves)
    grads = torch.autograd.grad(total, [leaves[n] for n in names])
    losses = {"total": total.detach(), "nll": nll_loss.detach(),
              "kl": kl_loss.detach(), "g": g_loss.detach(),
              "d_weight": d_weight}
    return losses, dict(zip(names, grads))


def disc_step(cfg: dict, vae_p: Params, disc_p: Params,
              stats: Dict[str, torch.Tensor], x: torch.Tensor,
              noise: torch.Tensor, disc_factor: float, pr: Precision
              ) -> Tuple[torch.Tensor, Params]:
    """The discriminator's hinge loss and its gradients by parameter, on x
    and its reconstruction made again without a gradient; moves `stats`
    twice (real, then fake)."""
    with torch.no_grad():
        xrec, _ = reconstruct(cfg, vae_p, x, noise, pr)
    leaves = {n: t.detach().requires_grad_(True) for n, t in disc_p.items()}
    logits_real = discriminator(cfg, leaves, stats, x, pr)
    logits_fake = discriminator(cfg, leaves, stats, xrec, pr)
    d_loss = disc_factor * hinge(logits_real, logits_fake)
    names = list(leaves)
    grads = torch.autograd.grad(d_loss, [leaves[n] for n in names])
    return d_loss.detach(), dict(zip(names, grads))


def train(cfg: dict, vae_w: Params, disc_w: Params,
          batches: List[torch.Tensor],
          noises: List[Tuple[torch.Tensor, torch.Tensor]], start_step: int,
          pr: Precision, fault: Optional[str] = None,
          logvar: float = 0.0) -> dict:
    """len(batches) steps from `start_step` on images (B, C, W, H), each
    with its (generator, discriminator) posterior draws. Returns each
    step's total loss, discriminator loss and d_weight (the NLL's `logvar`
    fixed at the value given), the VAE's first gradient,
    the running statistics after the first step, the gradient norms of the
    discriminator's first step past disc_start (its gradient is 0 before),
    and the VAE, discriminator, EMA and running statistics after the last
    step. The EMA's update count starts
    at 0. `fault` "disc_skipped" leaves the discriminator's parameters
    unchanged (a planted fault)."""
    if fault not in (None, "disc_skipped"):
        raise ValueError(f"no fault {fault!r}")
    lc = cfg["loss"]
    lr = float(cfg["learning_rate"])
    vae_p = {n: t.detach().clone().float() for n, t in vae_w.items()}
    disc_p = {n: t.detach().clone().float() for n, t in disc_w.items()}
    stats = disc_stats(lc, next(iter(vae_w.values())).device)
    ema = {n: t.clone() for n, t in vae_p.items()}
    gen_opt: dict = {}
    disc_opt: dict = {}
    out = {"losses": [], "disc_losses": [], "d_weights": []}
    for i, (x, (gen_noise, disc_noise)) in enumerate(zip(batches, noises)):
        step = start_step + i
        df = float(lc.get("disc_factor", 1.0)) if step >= int(
            lc["disc_start"]) else 0.0
        losses, grads = gen_step(cfg, vae_p, disc_p, stats, x, gen_noise,
                                 df, pr, logvar)
        with torch.no_grad():
            adam(vae_p, grads, gen_opt, lr)
            decay = ema_decay(i + 1, float(lc.get("ema_decay", 0.9999)))
            one_minus = float(np.float32(1) - np.float32(decay))
            for n in ema:
                ema[n] = ema[n] - one_minus * (ema[n] - vae_p[n])
        d_loss, d_grads = disc_step(cfg, vae_p, disc_p, stats, x,
                                    disc_noise, df, pr)
        if fault != "disc_skipped":
            with torch.no_grad():
                adam(disc_p, d_grads, disc_opt, lr)
        if i == 0:
            out["first_grads"] = {n: g.detach().clone()
                                  for n, g in grads.items()}
            out["first_stats"] = dict(stats)
        if "first_disc_grads" not in out and (df > 0 or i + 1 == len(
                batches)):
            out["first_disc_grads"] = {n: float(g.norm())
                                       for n, g in d_grads.items()}
        out["losses"].append(float(losses["total"]))
        out["disc_losses"].append(float(d_loss))
        out["d_weights"].append(float(losses["d_weight"]))
    out.update(vae=vae_p, disc=disc_p, ema=ema, stats=stats)
    return out
