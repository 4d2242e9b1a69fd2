"""Range value encoding (ldm/dataset.py:173-178, 241-245).

Only the two functions the sampling path needs; projecting point clouds
into range images belongs to the data slice.
"""

from __future__ import annotations

import torch

from rangeldm_tpu_torch.geometry.sensors import SensorSpec


def encode_range(r: torch.Tensor, spec: SensorSpec) -> torch.Tensor:
    """Range value encoding (ldm/dataset.py:173-178)."""
    if spec.log:
        return torch.log2(r + 1.0) / 6.0
    if spec.inverse:
        return 1.0 / r
    return r


def decode_range(v: torch.Tensor, spec: SensorSpec) -> torch.Tensor:
    """Inverse of `encode_range` plus the normalization undo
    (ldm/dataset.py:241-245)."""
    if spec.log:
        return 2.0 ** (v * 6.0) - 1.0
    if spec.inverse:
        return 1.0 / torch.clamp(v, min=1e-4)
    return v * spec.std + spec.mean
