"""Point cloud -> range image projection and the range value encoding
(ldm/dataset.py:135-245, with the row assignments of
ldm/kitti360_range_image.py:51-61, ldm/nuscenes_range_image.py:43-45 and
ldm/kitti360_range_image_vanilla.py:24-32).

The projection is the numpy host path the data loader caches: bit-faithful
to the reference (same clamping, the in-place z shift, the far-to-near
overwrite in a stable descending-range order, the car-window mask). The
image layout is (H=beams, W=azimuth, 2), channel 0 the encoded range and
channel 1 the intensity; -1 marks empty pixels before hole filling.
`encode_range` / `decode_range` are the torch forms the sampling path uses.
"""

from __future__ import annotations

import numpy as np
import torch

from rangeldm_tpu_torch.geometry.sensors import SensorSpec


def encode_range(r: torch.Tensor, spec: SensorSpec) -> torch.Tensor:
    """Range value encoding (ldm/dataset.py:173-178)."""
    if spec.log:
        return torch.log2(r + 1.0) / 6.0
    if spec.inverse:
        return 1.0 / r
    return r


def decode_log_range(v):
    """The LiDARGen log-range decode 2^(6v) - 1 (ldm/dataset.py:241,
    metrics mae.py:60-62), for numpy arrays and tensors alike."""
    return 2.0 ** (v * 6.0) - 1.0


def decode_range(v: torch.Tensor, spec: SensorSpec) -> torch.Tensor:
    """Inverse of `encode_range` plus the normalization undo
    (ldm/dataset.py:241-245)."""
    if spec.log:
        return decode_log_range(v)
    if spec.inverse:
        return 1.0 / torch.clamp(v, min=1e-4)
    return v * spec.std + spec.mean


# ---------------------------------------------------------------------------
# numpy host path
# ---------------------------------------------------------------------------

def _encode_range_np(r: np.ndarray, spec: SensorSpec) -> np.ndarray:
    if spec.log:
        return np.log2(r + 1.0) / 6.0
    if spec.inverse:
        return 1.0 / r
    return r


def _col_inds_np(pc: np.ndarray, width: int) -> np.ndarray:
    """Azimuth -> column binning (ldm/dataset.py:162-166)."""
    azi = np.arctan2(pc[:, 1], pc[:, 0])
    col = width - 1.0 + 0.5 - (azi + np.pi) / (2.0 * np.pi) * width
    col = np.round(col).astype(np.int32)
    col[col == width] = width - 1
    col[col < 0] = 0
    return col


def _row_inds_np(pc: np.ndarray, spec: SensorSpec) -> np.ndarray:
    if spec.row_mode == "kitti":
        # argmin over per-beam |incl - atan2(h - z, ||xy||)|
        xy_norm = np.linalg.norm(pc[:, :2], ord=2, axis=1)
        incl = spec.incl[None, :]                            # (1, B)
        ang = np.arctan2(spec.height[None, :] - pc[:, 2:3], xy_norm[:, None])
        return np.argmin(np.abs(incl - ang), axis=-1).astype(np.int32)
    if spec.row_mode == "ring":
        # the row straight from the ring channel
        return (spec.n_beams - 1 - pc[:, 4]).astype(np.int32)
    if spec.row_mode == "uniform":
        # LiDARGen's uniform zenith bins
        r = np.linalg.norm(pc[:, :3], axis=1, ord=2)
        zen = np.arcsin(pc[:, 2] / np.maximum(r, 1e-12))
        fov = spec.fov_up - spec.fov_down
        row = (spec.n_beams - 1.0 + 0.5
               - (zen - spec.fov_down) / fov * spec.n_beams)
        row = np.round(row).astype(np.int32)
        row[row == spec.n_beams] = spec.n_beams - 1
        row[row < 0] = 0
        return row
    raise ValueError(f"unknown row_mode {spec.row_mode}")


def project_np(pc: np.ndarray, spec: SensorSpec) -> np.ndarray:
    """pc (N, >=4) -> range image (H, W, 2) with -1 in empty pixels
    (ldm/dataset.py:159-185): the z shift by each point's beam height is
    applied in place before the range is taken, and points are written far
    to near, so the nearest point of a pixel wins."""
    pc = np.array(pc, dtype=np.float32, copy=True)
    if spec.min_depth > 0.0:
        depth = np.linalg.norm(pc[:, :3], 2, axis=1)
        pc = pc[depth > spec.min_depth]
    row = _row_inds_np(pc, spec)
    col = _col_inds_np(pc, spec.width)

    img = np.full((spec.n_beams, spec.width, 2), -1.0, dtype=np.float32)
    pc[:, 2] -= spec.height[row]
    r = np.linalg.norm(pc[:, :3], axis=1, ord=2)
    r = np.minimum(r, spec.range_fill)

    order = np.argsort(-r, kind="stable")
    r_enc = _encode_range_np(r[order], spec)
    pc = pc[order]
    img[row[order], col[order], 0] = r_enc
    img[row[order], col[order], 1] = pc[:, 3]
    return img


def fill_noise_np(data: np.ndarray, miss: np.ndarray) -> np.ndarray:
    """Copy the next azimuth column into missing pixels
    (ldm/dataset.py:187-191). data is (H, W, C); miss is (H, W) bool."""
    shifted = np.roll(data, -1, axis=1)
    out = data.copy()
    out[miss] = shifted[miss]
    return out


def process_miss_value_np(img: np.ndarray, spec: SensorSpec):
    """Hole filling and the car-window mask (ldm/dataset.py:193-221).
    Returns (img, mask, car_window_mask); the holes left in img carry the
    encoded fill value."""
    mask = img[..., 0] > 0
    miss = img[..., 0] == -1
    img = fill_noise_np(img, miss)
    mask = fill_noise_np(mask[..., None], miss).squeeze(-1)

    still = img[..., 0] == -1
    down2 = np.roll(img[..., 0], 2, axis=0)
    up2 = np.roll(img[..., 0], -2, axis=0)
    right2 = np.roll(img[..., 0], 2, axis=1)
    left2 = np.roll(img[..., 0], -2, axis=1)
    car_window = still & ((down2 != -1) | (up2 != -1) | (right2 != -1)
                          | (left2 != -1))

    fill = np.array([float(_encode_range_np(np.float32(spec.range_fill),
                                            spec)),
                     spec.intensity_fill], dtype=np.float32)
    img[still] = fill
    return img, mask, car_window


def normalize_np(img: np.ndarray, spec: SensorSpec) -> np.ndarray:
    """(r - mean) / std on the range channel (ldm/dataset.py:223-226)."""
    img = img.copy()
    if not spec.log and not spec.inverse:
        img[..., 0] = (img[..., 0] - spec.mean) / spec.std
    return img


def range_image_np(pc: np.ndarray, spec: SensorSpec):
    """Project, fill and normalize: (img (H, W, 2) float32, mask (H, W)
    bool, car_window (H, W) bool)."""
    img = project_np(pc, spec)
    img, mask, car_window = process_miss_value_np(img, spec)
    img = normalize_np(img, spec)
    return img, mask, car_window
