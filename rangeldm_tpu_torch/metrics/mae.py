"""Densification and inpainting MAE, and segmentation IoU / accuracy
(the reference's metrics/metrics/mae.py and iou.py), in numpy.

Callers pass (N, H, W) stacks of encoded range channels, as the triplet
files of `sample_conditional` hold them, rather than the reference's
on-disk .pth dumps. The log encoding decodes as 2^(6v) - 1 (mae.py:60-62).
The baselines, bicubic and nearest beam upsampling of the 4x-subsampled
target, follow mae.py:64-78.
"""

from __future__ import annotations

import numpy as np

from rangeldm_tpu_torch.geometry.projection import decode_log_range


def _resize_beams(img: np.ndarray, factor: int, mode: str) -> np.ndarray:
    """(H, W) -> (H*factor, W) along the beam axis."""
    h, w = img.shape
    if mode == "nearest":
        return np.repeat(img, factor, axis=0)
    if mode == "cubic":
        # 1D Catmull-Rom cubic along beams (cv2.INTER_CUBIC equivalent,
        # half-pixel centers)
        out = np.empty((h * factor, w), img.dtype)
        ys = (np.arange(h * factor) + 0.5) / factor - 0.5
        y0 = np.floor(ys).astype(int)
        t = (ys - y0)[:, None]
        idx = np.clip(np.stack([y0 - 1, y0, y0 + 1, y0 + 2]), 0, h - 1)
        p0, p1, p2, p3 = (img[i] for i in idx)
        a, A = t, -0.75  # cv2 uses A=-0.75 bicubic
        w0 = ((A * (a + 1) - 5 * A) * (a + 1) + 8 * A) * (a + 1) - 4 * A
        w1 = ((A + 2) * a - (A + 3)) * a * a + 1
        w2 = ((A + 2) * (1 - a) - (A + 3)) * (1 - a) ** 2 + 1
        w3 = 1.0 - w0 - w1 - w2
        out[:] = w0 * p0 + w1 * p1 + w2 * p2 + w3 * p3
        return out
    raise ValueError(mode)


def _decode(v: np.ndarray, encoding: str, mean: float, std: float):
    if encoding == "log":
        return decode_log_range(v)
    if encoding == "linear":
        return v * std + mean
    return v


def densification_mae(results: np.ndarray, targets: np.ndarray,
                      factor: int = 4, encoding: str = "log",
                      mean: float = 20.0, std: float = 40.0) -> dict:
    """MAE of predicted vs target range (decoded meters), plus bicubic and
    nearest beam-upsampling baselines built from the subsampled target
    (mae.py:45-93). results/targets: (N, H, W) encoded range; `encoding`
    is 'log', 'linear' (with `mean` and `std`) or 'none'."""
    results = _decode(results, encoding, mean, std)
    targets = _decode(targets, encoding, mean, std)
    n, h, w = targets.shape
    err_ours = np.abs(results - targets).sum()
    err_bc = 0.0
    err_nn = 0.0
    for i in range(n):
        sub = targets[i][::factor]
        err_bc += np.abs(_resize_beams(sub, factor, "cubic") - targets[i]).sum()
        err_nn += np.abs(_resize_beams(sub, factor, "nearest") - targets[i]).sum()
    count = n * h * w
    return {"mae": err_ours / count, "mae_bicubic": err_bc / count,
            "mae_nearest": err_nn / count}


def inpainting_mae(results: np.ndarray, targets: np.ndarray,
                   masked_columns: int = 64, encoding: str = "log",
                   mean: float = 20.0, std: float = 40.0) -> float:
    """MAE over the first `masked_columns` azimuth columns
    (mae.py:95-117; note the reference normalizes by the full image area,
    which we reproduce). results/targets: (N, H, W) with W = azimuth;
    `encoding` as in densification_mae."""
    results = _decode(results, encoding, mean, std)
    targets = _decode(targets, encoding, mean, std)
    err = np.abs(results[:, :, :masked_columns] -
                 targets[:, :, :masked_columns]).sum()
    n, h, w = targets.shape
    return float(err / (n * h * w))


def segmentation_iou(pred: np.ndarray, target: np.ndarray) -> float:
    """Weighted Jaccard over flattened label maps (iou.py:8-27):
    per-class IoU averaged with class-support weights."""
    pred = pred.ravel()
    target = target.ravel()
    classes, counts = np.unique(target, return_counts=True)
    total = target.size
    score = 0.0
    for c, cnt in zip(classes, counts):
        inter = np.sum((pred == c) & (target == c))
        union = np.sum((pred == c) | (target == c))
        iou = inter / union if union else 0.0
        score += (cnt / total) * iou
    return float(score)


def segmentation_accuracy(pred: np.ndarray, target: np.ndarray) -> float:
    """Plain pixel accuracy (iou.py:29-49)."""
    return float((pred.ravel() == target.ravel()).mean())
