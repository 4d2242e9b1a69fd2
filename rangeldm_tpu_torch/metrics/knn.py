"""RangeNet++ KNN post-processing (postproc/KNN.py:36-141).

Cleans per-point predictions by voting among the k range-nearest neighbors
inside a search x search window of the range image around each point's
projected pixel, with an inverse-Gaussian spatial weighting and a range
cutoff that maps too-far neighbors to an invalid class excluded from the
vote.

The shipped darknet53-1024 checkpoint disables this step
(darknet53-1024/arch_cfg.yaml `post: KNN: use: False`), and the
segmentation dumps that iou.py scores are the projected pixel argmax maps
(user.py:184), so the pixel-map IoU/accuracy of `frd_pipeline` is the
reference metric. This module keeps the per-point path (user.py:146-161)
with the reference's quirks:
  * zero-padded window values are treated as valid range-0 neighbors
    (F.unfold zero padding happens *before* the `< 0 -> inf` masking);
  * the window center is overwritten with the point's own unprojected
    range;
  * the vote excludes class 0 (unlabeled) and the cutoff-invalid class,
    and returns label 1 when every neighbor is excluded.
Ties among the k smallest distances (frequent at the zero-padded border)
go to the lower window index, as `jax.lax.top_k` orders them: a stable
sort, then the first k.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    """The 2D Gaussian of postproc/KNN.py:11-33 (normalized to sum 1)."""
    coords = np.arange(size, dtype=np.float64)
    x = np.tile(coords, (size, 1))
    y = x.T
    mean = (size - 1) / 2.0
    var = float(sigma) ** 2
    k = (1.0 / (2.0 * np.pi * var)) * np.exp(
        -((x - mean) ** 2 + (y - mean) ** 2) / (2.0 * var))
    return (k / k.sum()).astype(np.float32)


@torch.no_grad()
def knn_postprocess(proj_range: torch.Tensor, unproj_range: torch.Tensor,
                    proj_argmax: torch.Tensor, px: torch.Tensor,
                    py: torch.Tensor, *, knn: int = 5, search: int = 5,
                    sigma: float = 1.0, cutoff: float = 1.0,
                    nclasses: int = 20) -> torch.Tensor:
    """(H, W) range image + argmax map, (P,) point ranges and projected
    pixel coords -> (P,) cleaned per-point labels (int32).

    Default params are the shipped darknet53-1024 arch config's
    (arch_cfg.yaml post.KNN.params: knn 5, search 5, sigma 1.0,
    cutoff 1.0). The unfold becomes a per-point window gather: identical
    values, no (S*S, H*W) materialization."""
    if search % 2 == 0:
        raise ValueError("Nearest neighbor kernel must be odd number")
    pad = (search - 1) // 2
    dev = proj_range.device
    pr = F.pad(proj_range, (pad, pad, pad, pad))       # zero pad, as unfold
    pa = F.pad(proj_argmax, (pad, pad, pad, pad))
    offs = torch.arange(search, device=dev)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")  # unfold order ky*S+kx
    rows = py.long()[:, None] + dy.reshape(-1)[None, :]  # (P, S*S) padded
    cols = px.long()[:, None] + dx.reshape(-1)[None, :]
    vals = pr[rows, cols]
    labs = pa[rows, cols].long()
    vals = torch.where(vals < 0, torch.full_like(vals, float("inf")),
                       vals)                           # KNN.py:92-95 hack
    center = (search * search - 1) // 2
    vals[:, center] = unproj_range                     # KNN.py:98-99
    d = torch.abs(vals - unproj_range[:, None])
    inv_gauss = 1.0 - torch.from_numpy(
        gaussian_kernel(search, sigma).reshape(-1)).to(dev)
    d = d * inv_gauss[None, :]
    d_sorted, idx = torch.sort(d, dim=1, stable=True)  # k smallest, ties to
    d_k, idx = d_sorted[:, :knn], idx[:, :knn]         # the lower index
    knn_lab = torch.gather(labs, 1, idx)
    if cutoff > 0:
        knn_lab = torch.where(d_k > cutoff,
                              torch.full_like(knn_lab, nclasses), knn_lab)
    votes = F.one_hot(knn_lab, nclasses + 1).sum(dim=1)
    # the vote excludes unlabeled (0) and the invalid overflow class
    # (KNN.py:137)
    return (torch.argmax(votes[:, 1:-1], dim=1) + 1).to(torch.int32)


def per_point_labels(proj_range, unproj_range, proj_argmax, px, py,
                     use_knn: bool = False, **knn_params) -> torch.Tensor:
    """The user.py:146-161 dispatch: KNN cleanup when the arch config asks
    for it, plain pixel indexing otherwise (the shipped config's path)."""
    if use_knn:
        return knn_postprocess(proj_range, unproj_range, proj_argmax,
                               px, py, **knn_params)
    return proj_argmax[py.long(), px.long()]
