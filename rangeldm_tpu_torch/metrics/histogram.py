"""BEV 2D histograms of point clouds.

`point_cloud_to_histogram(160, 100, pc)` semantics
(metrics/metrics/histogram/histogram.py:4-18): 100x100 bins over
[-80, 80] m in x/y. Depth masks applied by the callers
(KITTI 3-70 m, nuScenes 2-90 m; mmd.py:39-56). The per-scan functions are
numpy on the host, as the reference's; `histogram_batch` bins a padded
batch of clouds on the device its tensors lie on.
"""

from __future__ import annotations

import numpy as np
import torch


def point_cloud_to_histogram(pc_xy: np.ndarray, field_size: float = 160.0,
                             bins: int = 100) -> np.ndarray:
    """(N, >=2) points -> (bins, bins) histogram, numpy host path."""
    half = (bins / 2) * (field_size / bins) if bins % 2 == 0 else None
    assert half is not None, "bins must be even (reference errors otherwise)"
    h, _ = np.histogramdd(pc_xy[:, :2], bins=bins,
                          range=([-half, half], [-half, half]))
    return h


def depth_mask(pc: np.ndarray, lo: float, hi: float) -> np.ndarray:
    d = np.linalg.norm(pc[:, :3], 2, axis=1)
    return (d > lo) & (d < hi)


def kitti_histogram(pc: np.ndarray) -> np.ndarray:
    """KITTI convention: mask 3-70 m (mmd.py:39-44)."""
    return point_cloud_to_histogram(pc[depth_mask(pc, 3.0, 70.0)])


def nuscenes_histogram(pc: np.ndarray) -> np.ndarray:
    """nuScenes convention: mask 2-90 m (mmd.py:46-56)."""
    return point_cloud_to_histogram(pc[depth_mask(pc, 2.0, 90.0)])


def histogram_batch(pc: torch.Tensor, mask: torch.Tensor,
                    field_size: float = 160.0,
                    bins: int = 100) -> torch.Tensor:
    """Batched histogram on the tensors' device: (B, N, >=2) points and a
    (B, N) bool mask -> (B, bins, bins) float32 counts. Matches
    np.histogramdd's edges: a value on the upper edge falls into the last
    bin, and points outside the field are dropped."""
    half = field_size / 2.0
    width = field_size / bins
    pc = pc.float()
    x, y = pc[..., 0], pc[..., 1]
    inside = mask & (x >= -half) & (x <= half) & (y >= -half) & (y <= half)
    ix = torch.clamp(torch.floor((x + half) / width).to(torch.int64), 0,
                     bins - 1)
    iy = torch.clamp(torch.floor((y + half) / width).to(torch.int64), 0,
                     bins - 1)
    b = pc.shape[0]
    offset = torch.arange(b, device=pc.device)[:, None] * (bins * bins)
    lin = torch.where(inside, ix * bins + iy + offset, offset)
    out = torch.zeros(b * bins * bins, dtype=torch.float32, device=pc.device)
    out.index_add_(0, lin.reshape(-1), inside.reshape(-1).float())
    return out.reshape(b, bins, bins)
