"""BEV voxelization by trilinear splatting (ldm/dataset.py:13-132,
279-294): eight `index_add_` passes, one per cell corner."""

from __future__ import annotations

from typing import Optional

import torch

from rangeldm_tpu_torch.geometry.inverse import to_point_cloud
from rangeldm_tpu_torch.geometry.sensors import SensorSpec


def splat_points_to_volumes(points_3d: torch.Tensor,
                            points_features: torch.Tensor,
                            grid_sizes: tuple, min_weight: float = 1e-4,
                            mask: Optional[torch.Tensor] = None):
    """Trilinear-splat (B, N, 3) points in [-1, 1]^3 into a flattened
    (D, H, W) volume. Returns (features (B, F, V), densities (B, V, 1)).
    Corners outside the grid contribute nothing."""
    d, h, w = grid_sizes
    n_vox = d * h * w
    b, n, f = points_features.shape
    gs = torch.tensor([w, h, d], dtype=points_3d.dtype,
                      device=points_3d.device)
    idx_f = (points_3d + 1.0) * 0.5 * (gs - 1.0)
    base_f = torch.floor(idx_f)
    rem = idx_f - base_f
    base = base_f.to(torch.int64)

    # per-batch offsets turn the B independent scatters into one flat one
    offs = (torch.arange(b, device=points_3d.device) * n_vox)[:, None]
    densities = torch.zeros(b * n_vox, dtype=points_3d.dtype,
                            device=points_3d.device)
    features = torch.zeros(b * n_vox, f, dtype=points_3d.dtype,
                           device=points_3d.device)
    for xd in (0, 1):
        wx = (1 - xd) + (2 * xd - 1) * rem[..., 0]
        xi = base[..., 0] + xd
        for yd in (0, 1):
            wy = (1 - yd) + (2 * yd - 1) * rem[..., 1]
            yi = base[..., 1] + yd
            for zd in (0, 1):
                wz = (1 - zd) + (2 * zd - 1) * rem[..., 2]
                zi = base[..., 2] + zd
                valid = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                         & (zi >= 0) & (zi < d))
                if mask is not None:
                    valid = valid & mask
                wgt = torch.where(valid, wx * wy * wz,
                                  torch.zeros_like(wx))
                lin = torch.where(valid, (zi * h + yi) * w + xi,
                                  torch.zeros_like(xi)) + offs
                densities.index_add_(0, lin.reshape(-1), wgt.reshape(-1))
                features.index_add_(
                    0, lin.reshape(-1),
                    (wgt[..., None] * points_features).reshape(-1, f))
    densities = densities.reshape(b, n_vox)
    features = features.reshape(b, n_vox, f)
    features = features / torch.clamp(densities[..., None], min=min_weight)
    return features.transpose(1, 2), densities[..., None]


def to_voxel(images: torch.Tensor, spec: SensorSpec,
             normalize_densities: bool = True) -> torch.Tensor:
    """Range images (B, H, W, C) -> BEV grid (B, 2, Gy, Gx) with channels
    [log-density, mean intensity] for the default grid_sizes (1, Gy, Gx)."""
    b = images.shape[0]
    pc = to_point_cloud(images, spec)
    lo = torch.tensor(spec.pc_range[:3], dtype=pc.dtype, device=pc.device)
    hi = torch.tensor(spec.pc_range[3:], dtype=pc.dtype, device=pc.device)
    xyz = (pc[..., :3] - (hi + lo) / 2.0) / ((hi - lo) / 2.0)
    feats = (pc[..., 3:] if pc.shape[-1] > 3
             else torch.ones(pc.shape[:2] + (1,), dtype=pc.dtype,
                             device=pc.device))
    features, densities = splat_points_to_volumes(xyz, feats,
                                                  tuple(spec.grid_sizes))
    if normalize_densities:
        densities = torch.log(densities + 1.0)
    d, h, w = spec.grid_sizes
    return torch.cat([densities.reshape(b, d, h, w),
                      features.reshape(b, d, h, w)], dim=1)
