"""Traffic kind `train_inpaint`: the program's trainer
(`train_ldm.LdmTrainer.fit`) on an inpainting configuration, fed device
batches of scans with the published azimuth-sector mask, step after step.
Its record is a `train` record, so the training cells' readers apply.

The mix's keys are the `train` kind's (`batch`, `pool`, `check_steps`,
`trace_steps`, `chunk`). A batch holds, in the loader's (B, H, W, C)
layout (data/datasets.py `RangeImageDataset`, ldm/dataset.py:347-362):
  `jpg`              the pool's scans;
  `inpainting_mask`  +1 on the azimuth columns [0, inpainting x W), the
                     configuration's `inpainting` share (inpainting.yaml:
                     0.0625, columns 0-63 of 1024), -1 elsewhere;
  `masked_image`     -1 where masked, the scan elsewhere.

Set-up and the window are the `train` kind's. The first checked step also
gives the program's condition: the UNet's input channels past the noisy
latent (and before a position channel), read by a hook that the first
step alone runs. The profiled stretch also splits each replay of the
step's CUDA graph by the phases its capture kept (perfbench/
graph_phases.py): `device_ms_by_graph_phase`, None on a program that keeps
none.

The check runs the checked steps on perfbench/reference/inpaint.py in
float32 and reads the `train` kind's four gaps, and
  `cond_gap`   ||c - c_ref|| / ||c_ref|| of the first checked step's
               condition, the masked scan's scaled posterior draw and the
               resized mask;
a run compares those that the cell's `limits` name (the loss's is left
out: over its calibration seeds the program's largest and the float8
control's smallest lie too close to set it, PERF.md §6).
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from perfbench import graph_phases, work
from perfbench.reference import inpaint as ref_inpaint
from perfbench.reference.precision import (
    REFERENCE, Precision, strict_float32,
)
from perfbench.traffic import train as train_kind
from perfbench.traffic.train import host_copy


def inpainting_inputs(images: torch.Tensor, share: float):
    """(mask (..., H, W, 1), masked images (..., H, W, C)) of images in the
    loader's layout: the azimuth columns [0, share x W) masked."""
    w = images.shape[-2]
    keep = torch.arange(w, device=images.device) >= int(share * w)
    mask = torch.where(keep, -1.0, 1.0)[:, None].expand(
        *images.shape[:-1], 1).contiguous()
    return mask, torch.where(keep[:, None], images, -1.0)


class Traffic(train_kind.Traffic):
    kind = "train"

    def __init__(self, cfg: dict, mix: dict, device: torch.device,
                 seed: int):
        super().__init__(cfg, mix, device, seed)
        self.share = float(cfg["inpainting"])
        self.condition = self.inputs = None

    # -- the program --------------------------------------------------
    def feed(self, steps: int = None, seconds: float = None,
             marks: list = None):
        if self.inputs is None:
            # (mask, masked image) of each batch of the pool, made once
            self.inputs = inpainting_inputs(self.pool, self.share)
        mask, masked = self.inputs
        for batch in super().feed(steps, seconds, marks):
            k = (self.cursor - 1) % len(self.pool)
            yield dict(batch, masked_image=masked[k], inpainting_mask=mask[k])

    def _take_condition(self, module, args) -> None:
        if self.condition is None:
            mc = self.cfg["model_config"]
            pos = int(bool(self.cfg.get("pos_encoding", True)))
            self.condition = host_copy(
                args[0][:, mc["out_channels"]:mc["in_channels"] - pos])

    def fit(self, batches) -> None:
        if self.condition is not None:
            return super().fit(batches)
        # set-up's checked steps: the first one's condition
        hook = self.trainer.unet.register_forward_pre_hook(
            self._take_condition)
        try:
            super().fit(batches)
        finally:
            hook.remove()

    def captured_step(self):
        """The program's captured step, or None where it keeps none."""
        graphs = getattr(self.trainer.train_step, "graphs", None)
        kept = graphs.captured() if graphs is not None else []
        return kept[-1] if kept else None

    def profiled(self) -> dict:
        """`trace_steps` more steps under torch.profiler; the record of the
        `train` kind with `device_ms_by_graph_phase`."""
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
                "device_ms_by_graph_phase": graph_phases.by_phase(
                    prof, self.captured_step()), **reduced}

    def work(self) -> dict:
        out = super().work()
        out["flops_per_unit"] += work.vae_encode_flops(
            self.cfg["vae_config"], self.cfg["image_size"], self.batch)
        return out

    # -- the check ----------------------------------------------------
    def reference(self, pr: Precision = REFERENCE,
                  zero_condition: bool = False) -> dict:
        """The checked steps on the reference in `pr`, from the same
        weights, batches and draws; `zero_condition` plants that fault."""
        dev = self.device
        unet_w = {n: t.to(dev) for n, t in self.unet_w0.items()}
        vae_w = {n: t.to(dev) for n, t in self.vae_w0.items()}
        batches = []
        for k in range(self.check_steps):
            images = self.pool[k]
            mask, masked = inpainting_inputs(images, self.share)
            batches.append({name: t.permute(0, 3, 2, 1).contiguous()
                            for name, t in (("jpg", images),
                                            ("masked_image", masked),
                                            ("inpainting_mask", mask))})
        gen = torch.Generator(device=dev).manual_seed(self.trainer_seed)
        with strict_float32():
            out = ref_inpaint.train(self.cfg, unet_w, vae_w, batches, gen,
                                    pr, int(self.mix["chunk"]),
                                    zero_condition)
        out["condition"] = out.pop("conditions")[0].cpu()
        out["params"] = {n: t.cpu() for n, t in out["params"].items()}
        out["ema"] = {n: t.cpu() for n, t in out["ema"].items()}
        return out

    def numbers(self, got: dict, ref: dict) -> Dict[str, float]:
        """The `train` kind's four gaps and `cond_gap`."""
        out = super().numbers(got, ref)
        c, c_ref = got["condition"].double(), ref["condition"].double()
        # rows one side lacks count as zeros
        rows = max(len(c), len(c_ref))
        c, c_ref = (torch.cat([t, t.new_zeros((rows - len(t), *t.shape[1:]))])
                    for t in (c, c_ref))
        out["cond_gap"] = float((c - c_ref).norm() / c_ref.norm())
        return out

    def program_result(self) -> dict:
        return dict(super().program_result(), condition=self.condition)

    def check(self, limits: dict) -> list:
        """The gaps the cell's `limits` name; perfbench/
        calibrate_inpaint.py reads them all."""
        nums = self.numbers(self.program_result(), self.reference())
        return [(k, nums[k], float(v)) for k, v in limits.items()]
