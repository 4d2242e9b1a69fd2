"""User-facing pipeline API, the `from_pretrained` surface of the
reference's diffusers pipelines (ldm/pipelines.py):

    from rangeldm_tpu_torch.pipelines import RangePipeline
    pipe = RangePipeline.from_pretrained("path/to/pipeline")   # on CUDA
    images = pipe(batch_size=16, num_inference_steps=50, seed=0)
    clouds = pipe.to_point_clouds(images)

    up = RangePipeline.from_pretrained("runs/upsample/pipeline")
    dense = up.upsample(sparse_images)          # 4x beam densification
    inp = RangePipeline.from_pretrained("runs/inpainting/pipeline")
    filled = inp.inpaint(masked_images, masks)  # azimuth-sector inpainting

Loads released diffusers-layout directories. Images go in and come out as
float32 numpy arrays (B, H, W, C). `from_pretrained(..., mesh="auto")`
splits every batch over this process's cards, one replica of the models on
each, made once (the JAX package's `mesh`, pipelines/api.py:54-85).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from rangeldm_tpu_torch.geometry.inverse import to_point_cloud_masked
from rangeldm_tpu_torch.geometry.sensors import SensorSpec, get_spec
from rangeldm_tpu_torch.pipelines import pipeline
from rangeldm_tpu_torch.utils.profiling import step_annotation


class RangePipeline:
    def __init__(self, pipe: dict, sensor: Optional[str] = None,
                 spec: Optional[SensorSpec] = None,
                 mesh: Union[None, str, Sequence] = None):
        self._p = pipe
        self._spec = spec          # explicit SensorSpec override
        self.sensor = sensor or (pipe.get("meta") or {}).get(
            "sensor", "kitti360")
        if isinstance(mesh, str) and mesh != "auto":
            raise ValueError("mesh must be a tuple of devices, None, or "
                             "'auto'")
        self.mesh = mesh if mesh in (None, "auto") else tuple(mesh)

    @classmethod
    def from_pretrained(cls, path: str, sensor: Optional[str] = None,
                        dtype: torch.dtype = torch.bfloat16,
                        use_ema: bool = True,
                        spec: Optional[SensorSpec] = None,
                        device=None,
                        mesh: Union[None, str, Sequence] = None
                        ) -> "RangePipeline":
        """Load a diffusers-layout pipeline directory. `device=None` is the
        CUDA device and raises without one; pass device="cpu" to run on
        the CPU. `sensor` defaults to kitti360; `spec` overrides the
        sensor lookup with an explicit SensorSpec.

        `mesh` splits every generation call's batch over devices, one
        replica of the models on each: a tuple of devices starting at
        `device` (batches must divide over it), or "auto", this process's
        devices (`parallel.mesh.local_devices`), of which each call takes
        the largest prefix that divides its batch."""
        pipe = pipeline.load_diffusers_pipeline(path, dtype=dtype,
                                                device=device,
                                                use_ema=use_ema)
        return cls(pipe, sensor=sensor, spec=spec, mesh=mesh)

    def _mesh_for_batch(self, batch_size: int) -> Optional[tuple]:
        """The devices a call with this batch runs on: an explicit mesh as
        it is (a batch that does not divide over it raises), for "auto" the
        largest prefix of this process's devices that divides the batch;
        None for the pipeline's device alone."""
        if self.mesh != "auto":
            return self.mesh
        return pipeline.resolve_sampling_mesh("auto", batch_size, self.device)

    @property
    def device(self) -> torch.device:
        return self._p["device"]

    @property
    def unet_config(self):
        return self._p["unet_cfg"]

    @property
    def is_latent(self) -> bool:
        return self._p["vae"] is not None

    @property
    def vae_down_factor(self) -> int:
        """The image -> latent factor of the VAE (2 per down level)."""
        return self._p["vae_cfg"].down_factor if self.is_latent else 1

    @property
    def cond_channels(self) -> int:
        cfg = self._p["unet_cfg"]
        pos = 1 if pipeline.pipe_pos_encoding(self._p) else 0
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
            spec = pipeline.adapt_spec_to_model(
                get_spec(self.sensor), pipeline.pipe_image_size(self._p))
            self._spec = pipeline.apply_meta_normalization(
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
            raise ValueError(f"this pipeline is conditional "
                             f"({self.cond_channels} condition channels): "
                             f"use .upsample() / .inpaint()")
        with step_annotation("sample_call"):
            if generator is None:
                generator = torch.Generator(
                    device=self.device).manual_seed(seed)
            sample = pipeline.build_sampler(
                self._p, batch_size, num_inference_steps, method,
                final_only=final_only,
                mesh=self._mesh_for_batch(batch_size))
            out = sample(generator)
            with step_annotation("to_host"):
                if final_only:
                    return out.float().cpu().numpy()
                return tuple(u.float().cpu().numpy() for u in out)

    # -- conditional generation ----------------------------------------
    def _cond_sample(self, cond_inputs: dict, mode: str, num_steps: int,
                     seed: int, generator: Optional[torch.Generator],
                     factor: int, method: str) -> np.ndarray:
        with step_annotation("sample_call"):
            if generator is None:
                generator = torch.Generator(
                    device=self.device).manual_seed(seed)
            batch = len(next(iter(cond_inputs.values())))
            sample = pipeline.build_conditional_sampler(
                self._p, batch, mode, num_steps, factor, method=method,
                mesh=self._mesh_for_batch(batch))
            out = sample(generator, cond_inputs)
            with step_annotation("to_host"):
                return out.float().cpu().numpy()

    def upsample(self, sparse_images, num_inference_steps: int = 50,
                 seed: int = 0, generator: Optional[torch.Generator] = None,
                 factor: Optional[int] = None,
                 method: str = "ddim") -> np.ndarray:
        """Beam densification (LDMUpscalePipelineRange with the
        SparseRangeImageEncoder2 condition): sparse (B, H/f, W, C) -> dense
        (B, H, W, C). `factor` defaults to cond_channels / C and must give
        exactly the model's condition channels, factor * C
        (ldm/encoders.py:86-95)."""
        c = np.shape(sparse_images)[-1]
        if factor is None:
            factor = max(self.cond_channels // c, 1)
        if factor * c != self.cond_channels:
            want = (self.cond_channels // c if self.cond_channels % c == 0
                    else self.cond_channels / c)
            raise ValueError(
                f"upsample factor {factor} x {c} input channels != the "
                f"model's {self.cond_channels} condition channels; this "
                f"model expects factor={want} or a different input channel "
                f"count (used_feature)")
        return self._cond_sample({"down": sparse_images}, "upsample",
                                 num_inference_steps, seed, generator,
                                 factor, method)

    def inpaint(self, masked_images, masks, num_inference_steps: int = 50,
                seed: int = 0, generator: Optional[torch.Generator] = None,
                method: str = "ddim") -> np.ndarray:
        """Azimuth-sector inpainting: the masked image's latent and the
        mask resized to the latent grid condition the UNet
        (ldm/pipelines.py:406-412). masked_images (B, H, W, C), masks
        (B, H, W, 1), +1 where masked and -1 where kept."""
        return self._cond_sample(
            {"masked_image": masked_images, "inpainting_mask": masks},
            "inpainting", num_inference_steps, seed, generator,
            self.vae_down_factor, method)

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
        pipeline.save_outputs(imgs, self.spec, out_dir, start_idx)
