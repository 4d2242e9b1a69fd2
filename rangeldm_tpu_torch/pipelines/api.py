"""User-facing pipeline API, the `from_pretrained` surface of the
reference's diffusers pipelines (ldm/pipelines.py):

    from rangeldm_tpu_torch.pipelines import RangePipeline
    pipe = RangePipeline.from_pretrained("path/to/pipeline")   # on CUDA
    images = pipe(batch_size=16, num_inference_steps=50, seed=0)
    clouds = pipe.to_point_clouds(images)

Loads released diffusers-layout directories. Unconditional sampling only;
images are returned as float32 numpy arrays (B, H, W, C).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from rangeldm_tpu_torch.geometry.inverse import to_point_cloud_masked
from rangeldm_tpu_torch.geometry.sensors import SensorSpec, get_spec
# a module reference, not names: sample_ldm imports this package in turn
from rangeldm_tpu_torch import sample_ldm


class RangePipeline:
    def __init__(self, pipe: dict, sensor: Optional[str] = None,
                 spec: Optional[SensorSpec] = None):
        self._p = pipe
        self._spec = spec          # explicit SensorSpec override
        self.sensor = sensor or (pipe.get("meta") or {}).get(
            "sensor", "kitti360")

    @classmethod
    def from_pretrained(cls, path: str, sensor: Optional[str] = None,
                        dtype: torch.dtype = torch.bfloat16,
                        use_ema: bool = True,
                        spec: Optional[SensorSpec] = None,
                        device=None) -> "RangePipeline":
        """Load a diffusers-layout pipeline directory. `device=None` is the
        CUDA device and raises without one; pass device="cpu" to run on
        the CPU. `sensor` defaults to kitti360; `spec` overrides the
        sensor lookup with an explicit SensorSpec."""
        pipe = sample_ldm.load_diffusers_pipeline(path, dtype=dtype,
                                                  device=device,
                                                  use_ema=use_ema)
        return cls(pipe, sensor=sensor, spec=spec)

    @property
    def device(self) -> torch.device:
        return self._p["device"]

    @property
    def cond_channels(self) -> int:
        cfg = self._p["unet_cfg"]
        pos = 1 if sample_ldm.pipe_pos_encoding(self._p) else 0
        return cfg.in_channels - cfg.out_channels - pos

    @property
    def sensor(self) -> str:
        return self._sensor

    @sensor.setter
    def sensor(self, value: str):
        """A new sensor invalidates a cached spec."""
        if getattr(self, "_sensor", None) not in (None, value):
            self._spec = None
        self._sensor = value

    @property
    def spec(self) -> SensorSpec:
        if self._spec is None:
            spec = sample_ldm.adapt_spec_to_model(
                get_spec(self.sensor), sample_ldm.pipe_image_size(self._p))
            self._spec = sample_ldm.apply_meta_normalization(
                spec, self._p.get("meta"))
        return self._spec

    def __call__(self, batch_size: int = 1, num_inference_steps: int = 50,
                 seed: int = 0, generator: Optional[torch.Generator] = None,
                 method: str = "ddim", final_only: bool = True):
        """Generate `batch_size` normalized range images (B, H, W, C).
        method: 'ddim' (reference), 'ddpm' or 'dpmpp' (DPM-Solver++ 2M, try
        num_inference_steps=20). final_only=False (latent pipelines) also
        returns the decoded state before every step,
        (num_steps, B, H, W, C)."""
        if self.cond_channels > 0:
            raise ValueError("conditional pipelines (upsample / inpaint) "
                             "are not supported by this package yet")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        sample = sample_ldm.build_sampler(self._p, batch_size,
                                          num_inference_steps, method,
                                          final_only=final_only)
        out = sample(generator)
        if final_only:
            return out.float().cpu().numpy()
        return tuple(u.float().cpu().numpy() for u in out)

    def to_point_clouds(self, images,
                        max_depth: float = 90.0) -> List[np.ndarray]:
        """Back-project images -> list of (N, 3 or 4) clouds with the depth
        filter of ldm/inference.py:173-177."""
        imgs = torch.as_tensor(np.asarray(images, np.float32),
                               device=self.device)
        with torch.inference_mode():
            pcs, valid = to_point_cloud_masked(imgs, self.spec,
                                               max_depth=max_depth)
        pcs, valid = pcs.cpu().numpy(), valid.cpu().numpy()
        return [pcs[i][valid[i]] for i in range(len(pcs))]

    def save_outputs(self, images, out_dir: str, start_idx: int = 0):
        """Write the {i}.bin / {i}_bev.png / {i}_range.png layout the
        evaluation CLI reads."""
        imgs = torch.as_tensor(np.asarray(images, np.float32),
                               device=self.device)
        sample_ldm.save_outputs(imgs, self.spec, out_dir, start_idx)
