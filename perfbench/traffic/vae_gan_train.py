"""Traffic kind `vae_gan_train`: the program's first-stage trainer
(`train_vae.VaeTrainer.fit`, one generator and one discriminator step a
batch) fed device batches, step after step. Its record is a `train`
record, so the training cells' readers of the device trace apply.

The mix's keys: `batch` (images a step), `pool` (distinct batches made
from the seed on the device and cycled), `check_steps` (the first steps,
which the reference follows), `trace_steps` (steps in the profiled
stretch).

Set-up builds `VaeTrainer` from the configuration file (its `vae`, `loss`
and `data`, the batch, the deployment's learning rate, a temporary output
directory under TMPDIR), loads the VAE's, `logvar`'s and the
discriminator's weights drawn from the seed on the device under the
published state-dict names (the EMA starts from them), sets the step to
the configuration's assumed start (`disc_start`, so the adversarial terms
are on), and runs the first `check_steps` steps through `fit` on the
pool's first batches: they are the warm-up, and the check reads their
losses, the first generator gradient (from Adam's first moment after one
update), and the parameters, EMA and BatchNorm statistics after them. The
window calls `fit` again with a batch iterator that records a CUDA event
as `fit` pulls each batch (the `train` kind's). The profiled stretch also
gives each device operation to the innermost program span that launched
it (perfbench/span_device.py): `device_ms_by_span`.

The check runs the same steps on the reference (perfbench/reference/
vae_gan.py) in float32, TF32 off, from the same weights, batches and
posterior draws (made from the program's generator seeds, (seed, step,
stream) as train_vae.step_generator makes them), and compares:
  `loss_gap`        the widest over the checked steps of the total loss's
                    |got - ref| / |ref|;
  `disc_loss_gap`   the same for the discriminator's hinge loss;
  `d_weight_gap`    the same for the adaptive weight;
  `grad_gap`        ||g - g_ref|| / ||g_ref|| of the VAE's first gradient,
                    over all its parameters;
  `change_gap`, `disc_change_gap`, `ema_gap`
                    ||d - d_ref|| / ||d_ref|| of the change over the checked
                    steps of the VAE's parameters, the discriminator's and
                    the EMA, each over the parameters whose reference
                    gradient is at least a thousandth of the median
                    parameter's (the others' gradients are rounding noise,
                    which Adam turns into full-size updates);
  `bn_mean_gap`     after the first step, the widest over the BatchNorms
                    of the running means' ||got - ref|| / ||sqrt(ref
                    variance)|| (the means sit near 0: their gap in units
                    of the spread);
  `bn_var_gap`      the same for the running variances' ||got - ref|| /
                    ||ref||.
Distances of whole vectors, rather than gaps of scalars such as a norm
or a loss, do not cancel by chance: they grow with the arithmetic's
rounding on every seed. A run compares the gaps that the cell's `limits`
name; the others are for perfbench/calibrate_vae_gan.py.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import harness, span_device, work, work_vae_gan
from perfbench import weights as seeded
from perfbench.reference import vae as ref_vae
from perfbench.reference import vae_gan as ref_gan
from perfbench.reference.precision import (
    REFERENCE, Precision, strict_float32,
)
from perfbench.traffic import train as train_kind
from perfbench.traffic.train import SMALL_GRAD, host_copy

# the configuration's keys that VaeTrainer reads as they are
TRAINER_KEYS = ("vae", "loss", "data", "checkpoint_every_steps",
                "mixed_precision", "log_every")
GEN, DISC = 0, 1            # the posterior noise streams of the two steps
# the program's step metrics the check reads, under the reference's names
# (ref_gan.train's lists)
PROGRAM_SCALARS = {"total_loss": "losses", "disc_loss": "disc_losses",
                   "d_weight": "d_weights"}


def step_generator(seed: int, step: int, stream: int,
                   device) -> torch.Generator:
    """The generator the program seeds for (seed, step, stream)."""
    key = np.random.SeedSequence([seed, step, stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(key))


def rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


class Traffic(train_kind.Traffic):
    kind = "train"

    # -- the program --------------------------------------------------
    def trainer_cfg(self) -> dict:
        cfg = self.cfg
        tcfg = {k: cfg[k] for k in TRAINER_KEYS if k in cfg}
        tcfg.update(batch_size=self.batch, output_dir=self.tmp,
                    seed=self.trainer_seed, scale_lr=False,
                    base_learning_rate=float(cfg["learning_rate"]))
        return tcfg

    def setup(self) -> None:
        from rangeldm_tpu_torch.train_vae import VaeTrainer

        cfg = self.cfg
        w_seed, data_seed, self.trainer_seed = harness.derived_seeds(
            self.seed, 0, 3)
        self.start_step = int(cfg["assumed"]["start_step"])
        self.tmp = tempfile.mkdtemp(prefix="perfbench-")
        trainer = self.trainer = VaeTrainer(self.trainer_cfg(),
                                            device=self.device)
        vae_shapes = ref_vae.param_shapes(cfg["vae"])
        disc_shapes = ref_gan.disc_param_shapes(cfg["loss"])
        gen = torch.Generator(device=self.device).manual_seed(w_seed)
        drawn = seeded.make({**vae_shapes, "logvar": (), **disc_shapes}, gen)
        st = trainer.state
        st.vae.load_state_dict({n: drawn[n] for n in vae_shapes},
                               strict=True)
        stats = ref_gan.disc_stats(cfg["loss"], self.device)
        st.disc.load_state_dict({
            **{n: drawn[n] for n in disc_shapes}, **stats,
            **{n.rsplit(".", 1)[0] + ".num_batches_tracked":
               torch.zeros((), dtype=torch.long) for n in stats}},
            strict=True)
        with torch.no_grad():
            st.logvar.copy_(drawn["logvar"])
            for e, p in zip(st.ema, st.vae.parameters()):
                e.copy_(p)
        st.step = self.start_step
        self.vae_w0 = {n: host_copy(drawn[n]) for n in vae_shapes}
        self.disc_w0 = {n: host_copy(drawn[n]) for n in disc_shapes}
        self.logvar0 = float(drawn["logvar"])
        del drawn
        h, w = cfg["image_size"]
        self.pool = torch.randn(
            (int(self.mix["pool"]), self.batch, h, w,
             cfg["vae"]["in_channels"]),
            generator=torch.Generator(device=self.device).manual_seed(
                data_seed), device=self.device)

        # the checked steps: their losses, the first generator gradient,
        # the state after the last
        self.metrics: List[Dict[str, torch.Tensor]] = []
        step_fn = trainer.train_step

        def checked(x):
            metrics = step_fn(x)
            self.metrics.append({k: metrics[k] for k in PROGRAM_SCALARS})
            if len(self.metrics) == 1:
                self.first = {"first_grads": self._first_gradient(),
                              "first_stats": self._stats()}
            if len(self.metrics) == self.check_steps:
                self.after = self._snapshot()
            return metrics

        trainer.train_step = checked
        self.fit(self.feed(steps=self.check_steps))
        trainer.train_step = step_fn
        self.sync()

    def _first_gradient(self) -> Dict[str, torch.Tensor]:
        """The VAE's gradient of the first update: Adam's first moment
        after it over 1 - beta1."""
        opt = self.trainer.state.gen_opt
        beta1 = opt.param_groups[0]["betas"][0]
        return {n: host_copy(opt.state[p]["exp_avg"]) / (1.0 - beta1)
                for n, p in self.trainer.state.vae.named_parameters()}

    def _stats(self) -> Dict[str, torch.Tensor]:
        return {n: host_copy(b)
                for n, b in self.trainer.state.disc.named_buffers()
                if n.endswith(("running_mean", "running_var"))}

    def _snapshot(self) -> dict:
        st = self.trainer.state
        vae = {n: host_copy(p) for n, p in st.vae.named_parameters()}
        return {"vae": vae,
                "disc": {n: host_copy(p)
                         for n, p in st.disc.named_parameters()},
                "ema": dict(zip(vae, (host_copy(e) for e in st.ema))),
                "stats": self._stats()}

    def profiled(self) -> dict:
        """`trace_steps` more steps under torch.profiler; the record of the
        `train` kind with `device_ms_by_span`."""
        from torch.profiler import ProfilerActivity, profile
        from perfbench import trace
        n = int(self.mix["trace_steps"])
        self.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            self.fit(self.feed(steps=n))
            self.sync()
            wall = time.perf_counter() - t0
        reduced = trace.reduce(*trace.from_profile(prof))
        return {"kind": self.kind, "units": n, "evals": n, "window_s": wall,
                "breakdown": trace.breakdown(reduced),
                "device_ms_by_span": span_device.by_span(prof), **reduced}

    def work(self) -> dict:
        counts = work_vae_gan.vae_gan_counts(self.cfg, self.batch)
        return {"flops_per_unit": counts["step"],
                "peak_flops": work.PEAK_FLOPS[
                    self.cfg["precision"]["stated"]], **counts}

    def release(self) -> None:
        self.results = {
            key: [float(m[name]) for m in self.metrics[:self.check_steps]]
            for name, key in PROGRAM_SCALARS.items()}
        self.metrics = []
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.tmp, ignore_errors=True)

    # -- the check ----------------------------------------------------
    def noises(self, batch: int) -> list:
        """The (generator, discriminator) posterior draws of the checked
        steps at `batch` rows."""
        vc, (h, w) = self.cfg["vae"], self.cfg["image_size"]
        f = 2 ** (len(vc["ch_mult"]) - 1)
        shape = (batch, vc["z_channels"], w // f, h // f)
        out = []
        for i in range(self.check_steps):
            step = self.start_step + i
            out.append(tuple(
                torch.randn(shape, device=self.device,
                            generator=step_generator(self.trainer_seed, s,
                                                     stream, self.device))
                for s, stream in ((step, GEN), (step + 1, DISC))))
        return out

    def reference(self, pr: Precision = REFERENCE,
                  fault: Optional[str] = None) -> dict:
        """The checked steps on the reference in `pr`, from the same
        weights, batches and draws; `fault` as `ref_gan.train` takes it."""
        dev = self.device
        batches = [self.pool[i].permute(0, 3, 2, 1).contiguous()
                   for i in range(self.check_steps)]
        with strict_float32():
            out = ref_gan.train(
                self.cfg, {n: t.to(dev) for n, t in self.vae_w0.items()},
                {n: t.to(dev) for n, t in self.disc_w0.items()}, batches,
                self.noises(batches[0].shape[0]), self.start_step, pr,
                fault, self.logvar0)
        for key in ("vae", "disc", "ema", "stats", "first_grads",
                    "first_stats"):
            out[key] = {n: t.cpu() for n, t in out[key].items()}
        return out

    def numbers(self, got: dict, ref: dict) -> Dict[str, float]:
        """The nine gaps of `got` (as `program_result`) to `ref`."""
        def widest(key):
            return max(rel(a, b) for a, b in zip(got[key], ref[key]))

        def moving(grads):
            norms = {n: float(g.norm()) if torch.is_tensor(g) else g
                     for n, g in grads.items()}
            median = float(np.median(list(norms.values())))
            return [n for n, g in norms.items() if g >= SMALL_GRAD * median]

        def distance(a, b, names, w0=None):
            """||a - b|| / ||b - w0|| over the named tensors."""
            num = den = 0.0
            for n in names:
                base = 0.0 if w0 is None else w0[n].double()
                num += float((a[n].double() - b[n].double()).pow(2).sum())
                den += float((b[n].double() - base).pow(2).sum())
            return (num / den) ** 0.5

        vae_moving = moving(ref["first_grads"])
        disc_moving = moving(ref["first_disc_grads"])
        return {
            "loss_gap": widest("losses"),
            "disc_loss_gap": widest("disc_losses"),
            "d_weight_gap": widest("d_weights"),
            "grad_gap": distance(got["first_grads"], ref["first_grads"],
                                 list(ref["first_grads"])),
            "change_gap": distance(got["vae"], ref["vae"], vae_moving,
                                   self.vae_w0),
            "disc_change_gap": distance(got["disc"], ref["disc"],
                                        disc_moving, self.disc_w0),
            "ema_gap": distance(got["ema"], ref["ema"], vae_moving,
                                self.vae_w0),
            **self.bn_gaps(got["first_stats"], ref["first_stats"])}

    @staticmethod
    def bn_gaps(got: dict, ref: dict) -> Dict[str, float]:
        """`bn_mean_gap`, the widest over the BatchNorms of ||mean - ref||
        / ||sqrt(ref var)|| of the running means (they sit near 0: their
        gap in units of the spread they are subtracted from), and
        `bn_var_gap`, of ||var - ref|| / ||ref|| of the running
        variances."""
        means, variances = [], []
        for name, var in ref.items():
            if not name.endswith("running_var"):
                continue
            mean = name[:-len("var")] + "mean"
            var = var.double()
            variances.append(float((got[name].double() - var).norm()
                                   / var.norm()))
            means.append(float((got[mean].double() - ref[mean].double())
                               .norm() / var.sqrt().norm()))
        return {"bn_mean_gap": max(means), "bn_var_gap": max(variances)}

    def check(self, limits: dict) -> list:
        nums = self.numbers(self.program_result(), self.reference())
        return [(k, nums[k], float(v)) for k, v in limits.items()]

    def program_result(self) -> dict:
        return {**self.results, **self.first, **self.after}
