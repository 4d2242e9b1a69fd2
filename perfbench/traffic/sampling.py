"""Traffic kind `sampling`: one caller generating scan sets through the
program's pipeline API, call after call.

The mix's keys: `batch` (scans a call), `steps` (denoising steps a call),
`method` ("ddim" or "dpmpp"), `check_calls` (calls of the window whose
scans the reference recomputes), `trace_calls` (calls in the profiled
stretch), `chunk` (rows the reference computes at once).

Set-up builds the pipeline dict that `sample_ldm.load_diffusers_pipeline`
builds, with weights drawn from the seed on the device in the served
dtype, hands it to `RangePipeline`, and warms up with one call of
min(3, steps) steps at the cell's batch. Call k of the run draws its
noise from its own seed, so every call's scans differ; each call returns
float32 scans (B, H, W, C) on the host.

The check recomputes `check_calls` calls drawn from the seed among those
the window completed: the same x_T (drawn as the program draws it from
the call's seed), the reference UNet and update in float32 over the whole
chain, and the reference decoder. It compares each scan by its relative
L2 gap to the reference's, ||scan - ref|| / ||ref||, and reports the
widest (`scan_gap`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import harness, work
from perfbench import weights as seeded
from perfbench.reference import schedule as ref_schedule
from perfbench.reference.train import pos_channel
from perfbench.reference import unet as ref_unet
from perfbench.reference import vae as ref_vae
from perfbench.reference.precision import (
    REFERENCE, Precision, strict_float32,
)


class Traffic:
    kind = "sampling"

    def __init__(self, cfg: dict, mix: dict, device: torch.device,
                 seed: int):
        self.cfg, self.mix, self.device, self.seed = cfg, mix, device, seed
        self.batch, self.steps = int(mix["batch"]), int(mix["steps"])
        self.method = mix["method"]
        self.dtype = (torch.bfloat16 if cfg.get("mixed_precision") == "bf16"
                      else torch.float32)
        self.outputs: Dict[int, np.ndarray] = {}

    # -- the program --------------------------------------------------
    def setup(self) -> None:
        from rangeldm_tpu_torch.diffusion.schedule import (
            Schedule, ScheduleConfig,
        )
        from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig
        from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
        from rangeldm_tpu_torch.pipelines.api import RangePipeline

        cfg = self.cfg
        w_seed, = harness.derived_seeds(self.seed, 0, 1)
        gen = torch.Generator(device=self.device).manual_seed(w_seed)
        mc, vc = cfg["model_config"], cfg["vae_config"]
        self.unet_w = seeded.make(ref_unet.param_shapes(mc), gen, self.dtype)
        self.vae_w = seeded.make(ref_vae.param_shapes(vc), gen, self.dtype)
        unet_cfg = dataclasses.replace(UNetConfig.from_reference(mc),
                                       circular=True)
        vae_cfg = VaeConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in vc.items()})
        with torch.device("meta"):
            unet, vae = UNet2D(unet_cfg), AutoencoderKL(vae_cfg)
        unet = unet.to_empty(device=self.device).to(self.dtype)
        vae = vae.to_empty(device=self.device).to(self.dtype)
        unet.load_state_dict(self.unet_w, strict=True)
        vae.load_state_dict(self.vae_w, strict=True)
        for m in (unet, vae):
            m.eval().requires_grad_(False)
        sched = cfg["scheduler"]
        pipe = dict(
            meta={"pos_encoding": bool(cfg.get("pos_encoding", True)),
                  "source": "diffusers", "schedule": sched},
            unet=unet, unet_cfg=unet_cfg, vae=vae, vae_cfg=vae_cfg,
            schedule=Schedule(ScheduleConfig(**sched)), device=self.device,
            dtype=self.dtype)
        self.pipe = RangePipeline(pipe)
        self.call(-1, min(3, self.steps))
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call_seed(self, k: int) -> int:
        """The seed of call k's noise (k = -1: the warm-up)."""
        return harness.derived_seeds(self.seed, 100 + k, 1)[0]

    def call(self, k: int, steps: int) -> np.ndarray:
        return self.pipe(batch_size=self.batch, num_inference_steps=steps,
                         seed=self.call_seed(k), method=self.method)

    def window(self, seconds: float) -> dict:
        """Calls back to back until `seconds` have passed; the rate counts
        the scans of the calls completed, over the time to the end of the
        last one."""
        self.sync()
        t0 = time.perf_counter()
        k, now = 0, t0
        while now - t0 < seconds:
            self.outputs[k] = self.call(k, self.steps)
            k += 1
            now = time.perf_counter()
        wall = now - t0
        return {"units": k, "wall_s": wall, "attempted": k, "failed": 0,
                "metrics": {"sampling_scans_per_s":
                            harness.rate(k * self.batch, wall)}}

    def profiled(self) -> dict:
        """`trace_calls` more calls under torch.profiler."""
        from torch.profiler import ProfilerActivity, profile
        from perfbench import trace
        n = int(self.mix["trace_calls"])
        self.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for j in range(n):
                self.call(10_000 + j, self.steps)
            self.sync()
            wall = time.perf_counter() - t0
        reduced = trace.reduce(*trace.from_profile(prof))
        return {"kind": self.kind, "units": n, "evals": n * self.steps,
                "window_s": wall, "breakdown": trace.breakdown(reduced),
                **reduced}

    def work(self) -> dict:
        mc, vc = self.cfg["model_config"], self.cfg["vae_config"]
        b = self.batch
        dtype = "bfloat16" if self.dtype == torch.bfloat16 else "float32"
        return {
            "flops_per_unit": self.steps * work.unet_flops(mc, b)
            + work.vae_decode_flops(vc, self.cfg["image_size"], b),
            "peak_flops": work.PEAK_FLOPS[dtype],
            "attn_fwd_bound_s_per_unit": self.steps * work.attention_bound_s(
                mc, b, "attention_fwd", dtype)}

    def release(self) -> None:
        self.pipe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------
    def checked_calls(self) -> List[int]:
        done = sorted(self.outputs)
        n = min(int(self.mix["check_calls"]), len(done))
        rng = np.random.default_rng(harness.derived_seeds(self.seed, 3, 1))
        return sorted(int(i) for i in rng.choice(done, n, replace=False))

    def reference(self, k: int, pr: Precision = REFERENCE) -> np.ndarray:
        """Call k's scans (B, H, W, C) from the reference in `pr`."""
        cfg, mc, vc = self.cfg, self.cfg["model_config"], \
            self.cfg["vae_config"]
        w, h = mc["sample_size"]
        gen = torch.Generator(device=self.device).manual_seed(
            self.call_seed(k))
        x_t = torch.randn((self.batch, mc["out_channels"], w, h),
                          generator=gen, dtype=self.dtype,
                          device=self.device).float()
        uw = {n: t.float() for n, t in self.unet_w.items()}
        vw = {n: t.float() for n, t in self.vae_w.items()}
        sched = ref_schedule.Schedule(cfg["scheduler"]["num_train_timesteps"])
        chunk = int(self.mix["chunk"])
        out = []
        with torch.no_grad(), strict_float32():
            for x in x_t.split(chunk):
                pos = pos_channel(x.shape[0], w, h, x.device)

                def model(x, t):
                    tt = torch.full((x.shape[0],), t, device=x.device)
                    return ref_unet.forward(mc, uw, torch.cat([x, pos], 1),
                                            tt, pr)
                z = ref_schedule.sample(sched, model, x, self.steps,
                                        self.method)
                img = ref_vae.decode(vc, vw, z / vc["scaling_factor"], pr)
                out.append(img.permute(0, 3, 2, 1).cpu().numpy())
        return np.concatenate(out)

    @staticmethod
    def scan_gap(got: np.ndarray, want: np.ndarray) -> float:
        """The widest relative L2 gap of a scan to the reference's."""
        diff = (got.astype(np.float64) - want).reshape(len(want), -1)
        ref = want.astype(np.float64).reshape(len(want), -1)
        return float(np.max(np.linalg.norm(diff, axis=1)
                            / np.linalg.norm(ref, axis=1)))

    def check(self, limits: dict) -> list:
        gap = max(self.scan_gap(self.outputs[k], self.reference(k))
                  for k in self.checked_calls())
        return [("scan_gap", gap, float(limits["scan_gap"]))]
