"""Traffic kind `train`: the program's trainer (`train_ldm.LdmTrainer.fit`)
fed device batches, step after step.

The mix's keys: `batch` (images a step), `pool` (distinct batches made
from the seed on the device and cycled), `check_steps` (the first steps,
which the reference follows), `trace_steps` (steps in the profiled
stretch), `chunk` (rows the reference computes at once).

Set-up builds `LdmTrainer` from the configuration file (the reference's
`model_config` and `vae_config` inline, the shipped training keys, a
temporary output directory under TMPDIR), loads weights drawn from the
seed on the device into `trainer.unet` and `trainer.vae`, and runs the
first `check_steps` steps through `fit` on the pool's first batches: they
are the warm-up, and the check reads their losses, the first gradient
(from AdamW's first moment after one update) and the parameters and EMA
after them. The window calls `fit` once more with a batch iterator that
records a CUDA event as `fit` pulls each batch, so that each step's time
is taken on the device's stream with no added synchronisation.

The check runs the same steps on the reference in float32 and compares,
each as a relative gap:
  `loss_gap`   the widest over the checked steps of |loss - ref| / |ref|;
  `grad_gap`   the worst parameter's | ||g|| - ||g_ref|| | over the larger
               of ||g_ref|| and the median parameter's, g the clipped
               gradient of the first update;
  `change_gap` the same for the change of the parameters over the checked
               steps, and `ema_gap` for the change of the EMA; both leave
               out parameters whose reference gradient is under a
               thousandth of the median parameter's (rounding noise that
               Adam turns into full-size updates).
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import harness, work
from perfbench import weights as seeded
from perfbench.reference import train as ref_train
from perfbench.reference import unet as ref_unet
from perfbench.reference import vae as ref_vae
from perfbench.reference.precision import (
    REFERENCE, Precision, strict_float32,
)

# keys of a configuration file that describe it rather than configure the
# trainer
DESCRIPTIVE = ("name", "source", "vae_source", "about", "reduced",
               "scheduler")
SMALL_GRAD = 1e-3


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy on the host that nothing on the device shares."""
    return t.detach().to("cpu", copy=True)


def leaf_gap(got: Dict[str, float], want: Dict[str, float]) -> float:
    """The worst parameter's |got - want| over the larger of |want| and
    the median parameter's |want|."""
    scale = float(np.median([abs(v) for v in want.values()]))
    return max(abs(got[n] - w) / max(abs(w), scale, 1e-30)
               for n, w in want.items())


class Traffic:
    kind = "train"

    def __init__(self, cfg: dict, mix: dict, device: torch.device,
                 seed: int):
        self.cfg, self.mix, self.device, self.seed = cfg, mix, device, seed
        self.batch = int(mix["batch"])
        self.check_steps = int(mix["check_steps"])
        self.cursor = 0

    # -- the program --------------------------------------------------
    def setup(self) -> None:
        from rangeldm_tpu_torch.train_ldm import LdmTrainer

        cfg = self.cfg
        w_seed, data_seed, self.trainer_seed = harness.derived_seeds(
            self.seed, 0, 3)
        self.tmp = tempfile.mkdtemp(prefix="perfbench-")
        tcfg = {k: v for k, v in cfg.items() if k not in DESCRIPTIVE}
        tcfg.update(model=cfg["name"], output_dir=self.tmp,
                    seed=self.trainer_seed, train_batch_size=self.batch)
        trainer = self.trainer = LdmTrainer(tcfg, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(w_seed)
        unet_w = seeded.make(ref_unet.param_shapes(cfg["model_config"]), gen)
        trainer.unet.load_state_dict(unet_w, strict=True)
        self.unet_w0 = {n: host_copy(t) for n, t in unet_w.items()}
        self.vae_w0 = None
        if trainer.vae is not None:
            vae_w = seeded.make(ref_vae.param_shapes(cfg["vae_config"]), gen)
            trainer.vae.load_state_dict(vae_w, strict=True)
            self.vae_w0 = {n: host_copy(t) for n, t in vae_w.items()}
        del unet_w
        h, w = cfg["image_size"]
        channels = (cfg["vae_config"]["in_channels"] if self.vae_w0
                    else cfg["model_config"]["out_channels"])
        self.pool = torch.randn(
            (int(self.mix["pool"]), self.batch, h, w, channels),
            generator=torch.Generator(device=self.device).manual_seed(
                data_seed), device=self.device)

        # the checked steps: the loss of each, the first update's moments,
        # the parameters and the EMA after the last
        self.losses: List[torch.Tensor] = []
        step_fn = trainer.train_step

        def checked(state, batch, generator):
            metrics = step_fn(state, batch, generator)
            self.losses.append(metrics["loss"])
            if len(self.losses) == 1:
                self.first_moment = self._first_moment()
            if len(self.losses) == self.check_steps:
                self.after = {n: host_copy(p) for n, p in
                              trainer.unet.named_parameters()}
                self.ema_after = dict(zip(self.after, (
                    host_copy(e) for e in trainer.state.ema)))
            return metrics

        trainer.train_step = checked
        self.fit(self.feed(steps=self.check_steps))
        trainer.train_step = step_fn
        self.sync()

    def _first_moment(self) -> Dict[str, float]:
        opt = self.trainer.state.optimizer
        named = list(self.trainer.unet.named_parameters())
        # a parameter AdamW has not updated has no moment: it reads 0
        norms = torch.stack(torch._foreach_norm(
            [opt.state[p]["exp_avg"] if "exp_avg" in opt.state[p]
             else torch.zeros_like(p) for _, p in named])).cpu()
        beta1 = float(self.cfg.get("adam_beta1", 0.95))
        return {n: float(v) / (1.0 - beta1)
                for (n, _), v in zip(named, norms)}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self):
        """A timestamp of this point of the device's stream (the host's
        clock on the CPU)."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def elapsed_ms(a, b) -> float:
        if isinstance(a, float):
            return (b - a) * 1e3
        return a.elapsed_time(b)

    def feed(self, steps: int = None, seconds: float = None,
             marks: list = None):
        """Batches from the pool, cycled, until `steps` batches or
        `seconds` since the first pull; a mark as each batch is pulled and
        one as the next is asked for after the last."""
        t0 = time.perf_counter()
        n = 0
        while True:
            if marks is not None:
                marks.append(self.mark())
            if steps is not None and n >= steps:
                return
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                return
            batch = self.pool[self.cursor % len(self.pool)]
            self.cursor += 1
            n += 1
            yield {"jpg": batch}

    def fit(self, batches) -> None:
        self.trainer.fit(batches, log_every=int(self.cfg.get("log_every",
                                                             50)))

    def window(self, seconds: float) -> dict:
        self.sync()
        marks: list = []
        t0 = time.perf_counter()
        self.fit(self.feed(seconds=seconds, marks=marks))
        self.sync()
        wall = time.perf_counter() - t0
        steps = len(marks) - 1
        times = [self.elapsed_ms(a, b) for a, b in zip(marks, marks[1:])]
        return {"units": steps, "wall_s": wall, "attempted": steps,
                "failed": 0, "metrics": {
                    "train_samples_per_s": harness.rate(steps * self.batch,
                                                        wall),
                    "train_step_p95_ms": harness.percentile(times, 95)}}

    def profiled(self) -> dict:
        """`trace_steps` more steps under torch.profiler."""
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
                "breakdown": trace.breakdown(reduced), **reduced}

    def work(self) -> dict:
        cfg, b = self.cfg, self.batch
        mc = cfg["model_config"]
        flops = work.unet_train_flops(mc, b)
        if self.vae_w0 is not None:
            flops += work.vae_encode_flops(cfg["vae_config"],
                                           cfg["image_size"], b)
        return {"flops_per_unit": flops,
                "peak_flops": work.PEAK_FLOPS["bfloat16"],
                "attn_bwd_bound_s_per_unit": work.attention_bound_s(
                    mc, b, "attention_bwd")}

    def release(self) -> None:
        self.losses = [float(v) for v in self.losses[:self.check_steps]]
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.tmp, ignore_errors=True)

    # -- the check ----------------------------------------------------
    def reference(self, pr: Precision = REFERENCE) -> dict:
        """The checked steps on the reference in `pr`, from the same
        weights, batches and draws."""
        dev = self.device
        unet_w = {n: t.to(dev) for n, t in self.unet_w0.items()}
        vae_w = ({n: t.to(dev) for n, t in self.vae_w0.items()}
                 if self.vae_w0 else None)
        batches = [self.pool[i].permute(0, 3, 2, 1).contiguous()
                   for i in range(self.check_steps)]
        gen = torch.Generator(device=dev).manual_seed(self.trainer_seed)
        with strict_float32():
            out = ref_train.train(self.cfg, unet_w, vae_w, batches, gen, pr,
                                  int(self.mix["chunk"]))
        out["params"] = {n: t.cpu() for n, t in out["params"].items()}
        out["ema"] = {n: t.cpu() for n, t in out["ema"].items()}
        return out

    def numbers(self, got: dict, ref: dict) -> Dict[str, float]:
        """The four gaps of `got` (losses, first_grads, params, ema) to
        `ref`."""
        w0 = self.unet_w0
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(got["losses"], ref["losses"]))
        g_ref = ref["first_grads"]
        median = float(np.median(list(g_ref.values())))
        moving = [n for n, g in g_ref.items() if g >= SMALL_GRAD * median]

        def change(state: dict) -> Dict[str, float]:
            return {n: float((state[n].double() - w0[n].double()).norm())
                    for n in moving}

        return {
            "loss_gap": loss_gap,
            "grad_gap": leaf_gap(got["first_grads"], g_ref),
            "change_gap": leaf_gap(change(got["params"]),
                                   change(ref["params"])),
            "ema_gap": leaf_gap(change(got["ema"]), change(ref["ema"]))}

    def program_result(self) -> dict:
        return {"losses": self.losses, "first_grads": self.first_moment,
                "params": self.after, "ema": self.ema_after}

    def check(self, limits: dict) -> list:
        nums = self.numbers(self.program_result(), self.reference())
        return [(k, v, float(limits[k])) for k, v in nums.items()]
