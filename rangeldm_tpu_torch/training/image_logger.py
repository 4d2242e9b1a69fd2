"""Image grids of range images written during training (the JAX package's
rangeldm_tpu/training/image_logger.py:16-77, after the reference's
ImageLogger, vae/main.py:309-477, and the per-epoch sample dumps of
ldm/train_unconditional.py:597-652).

The PNGs are written with the package's own greyscale writer
(`sample_ldm.write_png_gray`), so no imaging package is needed.
"""

from __future__ import annotations

import math
import os

import numpy as np

from rangeldm_tpu_torch.sample_ldm import write_png_gray


def _to_u8(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)


def save_range_image_grid(images: np.ndarray, path: str,
                          mean: float = 20.0, std: float = 40.0,
                          range_fill: float = 100.0,
                          max_images: int = 8) -> None:
    """(B, H, W, C) normalized range images -> one stacked greyscale PNG:
    the range rows (de-normalized with mean and std, over range_fill),
    then the intensity rows, clipped to [0, 1] and scaled to u8."""
    images = np.asarray(images[:max_images], np.float32)
    r = (images[..., 0] * std + mean) / range_fill
    rows = [r[i] for i in range(images.shape[0])]
    if images.shape[-1] > 1:
        rows += [images[i, ..., 1] for i in range(images.shape[0])]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png_gray(path, _to_u8(np.concatenate(rows, axis=0)))


def save_bev_png(bev_density: np.ndarray, path: str) -> None:
    """(Gy, Gx) BEV density in [0, 1] -> a greyscale PNG
    (ldm/inference.py:178-180)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png_gray(path, _to_u8(np.asarray(bev_density, np.float32)))


class ImageLogger:
    """Log image grids every `every` steps, and at the reference's
    log-scale early steps 1, 2, 4, ... up to `every`
    (vae/main.py:329-331, increase_log_steps)."""

    def __init__(self, out_dir: str, every: int = 1000,
                 increase_log_steps: bool = True, max_images: int = 8,
                 mean: float = 20.0, std: float = 40.0):
        self.out_dir = out_dir
        self.every = every
        self.max_images = max_images
        self.mean, self.std = mean, std
        self.steps = ({2 ** n for n in
                       range(int(math.log2(max(every, 1))) + 1)}
                      if increase_log_steps else set()) | {1}

    def should_log(self, step: int) -> bool:
        return step % self.every == 0 or step in self.steps

    def log(self, step: int, **named_images) -> None:
        for name, imgs in named_images.items():
            save_range_image_grid(
                np.asarray(imgs), os.path.join(
                    self.out_dir, f"{name}_step{step:08d}.png"),
                mean=self.mean, std=self.std, max_images=self.max_images)
