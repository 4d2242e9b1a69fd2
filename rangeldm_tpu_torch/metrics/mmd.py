"""MMD between histogram sets.

Matches metrics/metrics/histogram/dist_helper.py:84-103 (Gaussian kernel
sigma=0.5 on pmf-normalized histograms) and :131-172 (discrepancy means
include the diagonal). The reference thread-pools an O(N^2) Python loop;
here the full kernel matrix is three pairwise-distance products.
"""

from __future__ import annotations

import numpy as np
import torch

from rangeldm_tpu_torch.parallel.mesh import resolve_device
from rangeldm_tpu_torch.utils.precision import tf32

SIGMA = 0.5


def _mean_kernel_np(a: np.ndarray, b: np.ndarray, sigma: float) -> float:
    d2 = (np.sum(a * a, axis=1)[:, None] + np.sum(b * b, axis=1)[None, :]
          - 2.0 * (a @ b.T))
    np.maximum(d2, 0.0, out=d2)
    return float(np.mean(np.exp(-d2 / (2.0 * sigma * sigma))))


def _mean_kernel_minus_one(a: torch.Tensor, b: torch.Tensor,
                           sigma: float) -> torch.Tensor:
    """mean over all pairs of exp(-||a_i - b_j||^2 / (2 sigma^2)), minus 1.

    Histogram pmfs lie close together, so every kernel value is close to
    1; expm1 keeps each value's distance from 1 at float32's relative
    precision, and the three means then combine without the cancellation
    of O(1) terms (the ones cancel exactly: 1 + 1 - 2 = 0)."""
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
          - 2.0 * (a @ b.T))
    return torch.expm1(-torch.clamp(d2, min=0.0)
                       / (2.0 * sigma * sigma)).mean()


def _stack(hists) -> np.ndarray:
    return np.stack([np.asarray(h, np.float64) for h in hists]).reshape(
        len(hists), -1)


def _mmd_torch(a: np.ndarray, b: np.ndarray, device) -> float:
    """The float32 path: both sets normalized and reduced on `device`, with
    TF32 off for the products and the kernel means taken as their
    distance from 1."""
    x = torch.as_tensor(a.astype(np.float32), device=device)
    y = torch.as_tensor(b.astype(np.float32), device=device)
    x = x / x.sum(1, keepdim=True)
    y = y / y.sum(1, keepdim=True)
    with tf32(False):
        mmd = (_mean_kernel_minus_one(x, x, SIGMA)
               + _mean_kernel_minus_one(y, y, SIGMA)
               - 2.0 * _mean_kernel_minus_one(x, y, SIGMA))
    return float(mmd)


def compute_mmd(hists_a, hists_b, device: bool = False) -> float:
    """MMD^2 between two sets of (bins, bins) histograms
    (reference set first, per mmd.py:123).

    The default, device=False, is the host float64 path: benchmark MMD^2
    values are O(1e-4) while each mean-kernel term is O(1), so the
    k_xx + k_yy - 2 k_xy cancellation loses ~0.1-1% in float32 when the
    terms are summed as they stand; the reference accumulates in numpy
    float64. device=True runs a float32 path on the CUDA device, which
    must exist, that sums each term's distance from 1 instead
    (`_mean_kernel_minus_one`)."""
    a, b = _stack(hists_a), _stack(hists_b)
    if device:
        return _mmd_torch(a, b, resolve_device(None))
    a = a / np.sum(a, axis=1, keepdims=True)
    b = b / np.sum(b, axis=1, keepdims=True)
    return (_mean_kernel_np(a, a, SIGMA) + _mean_kernel_np(b, b, SIGMA)
            - 2.0 * _mean_kernel_np(a, b, SIGMA))
