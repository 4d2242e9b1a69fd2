"""FRD: Frechet distance over RangeNet++ decoder features.

metrics/metrics/fid/lidargen_fid.py:45-55 + fid_score.py:116-160:
each scan's (32, 64, 1024) decoder feature map is flattened (2,097,152
floats, torch CHW order), subsampled at 4096 `random.seed(0)` indices, and
the two sides' mean/covariance enter the standard Frechet distance.
"""

from __future__ import annotations

import random

import numpy as np


def frd_indices(n_dims: int = 4096, total: int = 2097152) -> np.ndarray:
    """The reference's fixed subsample (lidargen_fid.py:46-48)."""
    rng = random.Random()
    rng.seed(0)
    return np.asarray(rng.sample(range(0, total), n_dims))


def features_to_activations(features, indices: np.ndarray) -> np.ndarray:
    """(N, C, H, W) decoder features -> (N, len(indices)) activations.

    The features are in the reference's own NCHW layout, so its CHW
    flatten order (decoders/darknet.py:122-134) is a plain flatten of
    every axis after the first."""
    features = np.asarray(features)
    return features.reshape(features.shape[0], -1)[:, indices]


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """fid_score.py:116-160 (Dougal J. Sutherland's stable form)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return (float(diff.dot(diff)) + np.trace(sigma1) + np.trace(sigma2)
            - 2 * np.trace(covmean))


def frd_from_activations(act_a: np.ndarray, act_b: np.ndarray) -> float:
    """Frechet distance between two (N, D) activation matrices: the final
    step once the fixed-index subsample has been gathered (the FRD
    pipeline gathers it on the device, so full feature stacks never reach
    the host)."""
    mu_a, s_a = act_a.mean(0), np.cov(act_a, rowvar=False)
    mu_b, s_b = act_b.mean(0), np.cov(act_b, rowvar=False)
    return frechet_distance(mu_a, s_a, mu_b, s_b)


def compute_frd(features_a, features_b, n_dims: int = 4096) -> float:
    """FRD between two NCHW feature stacks (generated vs reference)."""
    total = int(np.prod(np.shape(features_a)[1:]))
    idx = frd_indices(n_dims, total)
    return frd_from_activations(features_to_activations(features_a, idx),
                                features_to_activations(features_b, idx))
