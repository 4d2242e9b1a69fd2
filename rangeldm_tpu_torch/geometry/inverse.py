"""Range image -> point cloud inverse projection (ldm/dataset.py:228-277).

Images are (B, H=beams, W=azimuth, C) here, the layout every public
function of the package returns, so clouds index points in (H, W) order.
"""

from __future__ import annotations

import math

import torch

from rangeldm_tpu_torch.geometry.projection import decode_range
from rangeldm_tpu_torch.geometry.sensors import SensorSpec


def to_point_cloud(images: torch.Tensor, spec: SensorSpec) -> torch.Tensor:
    """(B, H, W, C>=1) range images -> (B, H*W, 3 or 4) point clouds.

    Channel 0 is the encoded range, channel 1 (if present) the remission,
    copied through. For the table specs negative decoded ranges snap to
    the fill value (ldm/dataset.py:255)."""
    b, h, w, c = images.shape
    r = decode_range(images[..., 0], spec)                   # (B, H, W)
    if spec.row_mode != "uniform":
        r = torch.where(r < 0, torch.full_like(r, spec.range_fill), r)
    dev = images.device
    zenith = torch.as_tensor(spec.zenith, device=dev)[None, :, None]
    height = torch.as_tensor(spec.height, device=dev)[None, :, None]
    # the column table is built in f32 whatever the image dtype: bf16 would
    # quantize the column indices themselves (512..1023 to multiples of 4)
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    azi = ((w - 0.5 - cols) / w * 2.0 * math.pi - math.pi).to(
        torch.promote_types(images.dtype, torch.float32))[None, None, :]

    z = height + r * torch.sin(zenith)
    xy = r * torch.cos(zenith)
    x = xy * torch.cos(azi)
    y = xy * torch.sin(azi)
    out = [x.reshape(b, -1), y.reshape(b, -1), z.reshape(b, -1)]
    if c > 1:
        out.append(images[..., 1].reshape(b, -1))
    return torch.stack(out, dim=2)


def to_point_cloud_masked(images: torch.Tensor, spec: SensorSpec,
                          max_depth: float = 90.0):
    """Point cloud + validity mask for depth < max_depth (the export filter
    of ldm/inference.py:173-177)."""
    pc = to_point_cloud(images, spec)
    depth = torch.linalg.vector_norm(pc[..., :3], dim=-1)
    return pc, depth < max_depth
