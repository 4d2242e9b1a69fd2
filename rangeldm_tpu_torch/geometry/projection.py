"""Point cloud -> range image projection and the range value encoding
(ldm/dataset.py:135-245, with the row assignments of
ldm/kitti360_range_image.py:51-61, ldm/nuscenes_range_image.py:43-45 and
ldm/kitti360_range_image_vanilla.py:24-32), in two flavours:

  * the numpy host path the data loader caches (`project_np`,
    `range_image_np`): bit-faithful to the reference (same clamping, the
    in-place z shift, the far-to-near overwrite in a stable
    descending-range order, the car-window mask);
  * the tensor path (`pad_points`, `project`, `process_miss_value`,
    `normalize`, `range_image`), the JAX package's device pipeline: it runs
    on the device its inputs lie on, over fixed-size padded point buffers,
    one scan `(N, C)` or a batch `(B, N, C)`. The nearest point of a pixel
    wins by two deterministic scatter-mins: the float32 range read as int32
    bits (order-preserving for non-negative floats), then the point index
    among the range winners, so a tie on range goes to the smallest index.
    A minimum does not depend on the order of the atomics, so the result
    on a GPU is the same from call to call.

The image layout is (H=beams, W=azimuth, 2), channel 0 the encoded range
and channel 1 the intensity; -1 marks empty pixels before hole filling.
`encode_range` / `decode_range` are the torch forms the sampling path uses.
"""

from __future__ import annotations

import math

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


# ---------------------------------------------------------------------------
# tensor path (any device, fixed-size padded buffers)
# ---------------------------------------------------------------------------

_INT32_MAX = 2 ** 31 - 1


def pad_points(pc: np.ndarray, n_max: int):
    """Pad or truncate (N, C) points to (n_max, C) float32 and a validity
    mask, the fixed-size input of `project`."""
    n = min(pc.shape[0], n_max)
    out = np.zeros((n_max, pc.shape[1]), dtype=np.float32)
    out[:n] = pc[:n]
    valid = np.zeros((n_max,), dtype=bool)
    valid[:n] = True
    return out, valid


def _rows(points: torch.Tensor, spec: SensorSpec,
          heights: torch.Tensor) -> torch.Tensor:
    """Each point's beam (int64), the row assignment of `_row_inds_np`;
    the `kitti` argmin holds a (..., N, n_beams) float32 intermediate."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    h = spec.n_beams
    if spec.row_mode == "kitti":
        xy_norm = torch.sqrt(x * x + y * y)
        incl = torch.as_tensor(spec.incl, dtype=torch.float32,
                               device=points.device)
        ang = torch.atan2(heights - z[..., None], xy_norm[..., None])
        return torch.argmin(torch.abs(incl - ang), dim=-1)
    if spec.row_mode == "ring":
        if points.shape[-1] < 5:
            raise ValueError(f"ring-mode spec {spec.name!r} needs 5-column "
                             f"points (x, y, z, intensity, ring); got "
                             f"{points.shape[-1]}")
        return (h - 1 - points[..., 4]).to(torch.int64)
    if spec.row_mode == "uniform":
        r0 = torch.sqrt(x * x + y * y + z * z)
        zen = torch.asin(z / torch.clamp(r0, min=1e-12))
        fov = spec.fov_up - spec.fov_down
        rowf = h - 0.5 - (zen - spec.fov_down) / fov * h
        return torch.clamp(torch.round(rowf).to(torch.int64), 0, h - 1)
    raise ValueError(f"unknown row_mode {spec.row_mode}")


def project(points: torch.Tensor, valid: torch.Tensor,
            spec: SensorSpec) -> torch.Tensor:
    """Padded points (N, >=4) or (B, N, >=4) with their validity (N,) or
    (B, N) -> range image (H, W, 2) or (B, H, W, 2) on the points' device,
    -1 in empty pixels. A batch is one scatter over B·H·W pixels: each
    scan's pixel index is offset by b·H·W. Invalid points and points at or
    under `min_depth` never win."""
    if points.dim() not in (2, 3) or points.shape[-1] < 4:
        raise ValueError(f"points must be (N, >=4) or (B, N, >=4); got "
                         f"{tuple(points.shape)}")
    if valid.shape != points.shape[:-1]:
        raise ValueError(f"valid {tuple(valid.shape)} does not match "
                         f"points {tuple(points.shape)}")
    batched = points.dim() == 3
    if not batched:
        points, valid = points[None], valid[None]
    b, n = points.shape[:2]
    h, w = spec.n_beams, spec.width
    if b * h * w > _INT32_MAX or n >= _INT32_MAX:
        raise ValueError(f"{b} scans of {n} points over {h}x{w} pixels "
                         f"overflow the int32 keys")
    device = points.device
    points = points.float()
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    valid = valid.to(torch.bool)
    if spec.min_depth > 0.0:
        valid = valid & (torch.sqrt(x * x + y * y + z * z) > spec.min_depth)

    heights = torch.as_tensor(spec.height, dtype=torch.float32,
                              device=device)
    row = _rows(points, spec, heights)
    # a ring row above the image wraps once, as numpy's and JAX's indexing
    # does; one below it is dropped, as JAX's scatter drops it
    row = torch.where(row < 0, row + h, row)
    valid = valid & (row >= 0) & (row < h)
    row = torch.where(valid, row, 0)
    azi = torch.atan2(y, x)
    colf = w - 0.5 - (azi + math.pi) / (2.0 * math.pi) * w
    col = torch.clamp(torch.round(colf).to(torch.int64), 0, w - 1)

    # the range from the beam's origin: z shifted by the beam's height
    z_shift = z - heights[row]
    r = torch.sqrt(x * x + y * y + z_shift * z_shift)
    r = torch.clamp(r, max=spec.range_fill)

    offset = torch.arange(b, device=device)[:, None] * (h * w)
    pix = (torch.where(valid, row * w + col, 0) + offset).reshape(-1)

    # scatter-min 1: the winning range of each pixel
    rbits = torch.where(valid, r.view(torch.int32), _INT32_MAX)
    best = torch.full((b * h * w,), _INT32_MAX, dtype=torch.int32,
                      device=device)
    best.scatter_reduce_(0, pix, rbits.reshape(-1), reduce="amin")
    # scatter-min 2: the smallest point index among the range winners
    won = valid & (rbits == best[pix].view(b, n))
    idx = torch.arange(n, dtype=torch.int32, device=device)
    cand = torch.where(won, idx, _INT32_MAX)
    winner = torch.full((b * h * w,), _INT32_MAX, dtype=torch.int32,
                        device=device)
    winner.scatter_reduce_(0, pix, cand.reshape(-1), reduce="amin")

    winner = winner.view(b, h * w)
    hit = winner != _INT32_MAX
    widx = torch.where(hit, winner, 0).to(torch.int64)
    out_r = torch.where(hit, torch.gather(encode_range(r, spec), 1, widx),
                        -1.0)
    out_i = torch.where(hit, torch.gather(points[..., 3], 1, widx), -1.0)
    img = torch.stack([out_r, out_i], dim=-1).view(b, h, w, 2)
    return img if batched else img[0]


def process_miss_value(img: torch.Tensor, spec: SensorSpec):
    """Hole filling and the car-window mask of `process_miss_value_np` on
    (H, W, 2) or (B, H, W, 2) tensors: (img, mask, car_window)."""
    rch = img[..., 0]
    mask = rch > 0
    miss = rch == -1
    img = torch.where(miss[..., None], torch.roll(img, -1, dims=-2), img)
    mask = torch.where(miss, torch.roll(mask, -1, dims=-1), mask)

    rch = img[..., 0]
    still = rch == -1
    neigh = ((torch.roll(rch, 2, dims=-2) != -1)
             | (torch.roll(rch, -2, dims=-2) != -1)
             | (torch.roll(rch, 2, dims=-1) != -1)
             | (torch.roll(rch, -2, dims=-1) != -1))
    car_window = still & neigh

    fill_r = float(_encode_range_np(np.float32(spec.range_fill), spec))
    fill = torch.tensor([fill_r, spec.intensity_fill], dtype=img.dtype,
                        device=img.device)
    img = torch.where(still[..., None], fill, img)
    return img, mask, car_window


def normalize(img: torch.Tensor, spec: SensorSpec) -> torch.Tensor:
    """(r - mean) / std on the range channel of a tensor image."""
    if spec.log or spec.inverse:
        return img
    r = (img[..., :1] - spec.mean) / spec.std
    return torch.cat([r, img[..., 1:]], dim=-1)


def range_image(points: torch.Tensor, valid: torch.Tensor,
                spec: SensorSpec):
    """Project, fill and normalize on the points' device: (img, mask,
    car_window), with a leading batch dimension when `points` has one."""
    img = project(points, valid, spec)
    img, mask, car_window = process_miss_value(img, spec)
    return normalize(img, spec), mask, car_window
