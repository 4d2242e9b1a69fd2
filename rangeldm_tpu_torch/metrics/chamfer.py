"""Chamfer distance between point clouds (pytorch3d-equivalent).

Used by the VAE reconstruction eval (ldm/convert_vae.py:262-270).
pytorch3d's `chamfer_distance` returns mean_A min ||a-b||^2 +
mean_B min ||b-a||^2 (squared distances, summed over both directions).
Brute-force pairwise minima in float32, chunked over the first set so a
65k x 65k matrix never materializes.
"""

from __future__ import annotations

import torch

from rangeldm_tpu_torch.utils.precision import tf32

BIG = 1e30


def _one_sided(a: torch.Tensor, b: torch.Tensor, a_valid: torch.Tensor,
               b_valid: torch.Tensor, chunk: int) -> torch.Tensor:
    """mean over valid a of min over valid b of ||a-b||^2; NaN when either
    side has no valid point (the min over an all-masked b would be the
    1e30 sentinel and poison any average silently)."""
    b_sq = (b * b).sum(1)
    total = torch.zeros((), dtype=torch.float32, device=a.device)
    for start in range(0, a.shape[0], chunk):
        ac = a[start:start + chunk]
        d2 = (ac * ac).sum(1)[:, None] + b_sq[None, :] - 2.0 * (ac @ b.T)
        d2 = torch.where(b_valid[None, :], d2, torch.full_like(d2, BIG))
        mins = torch.clamp(d2.min(dim=1).values, min=0.0)
        total = total + torch.where(a_valid[start:start + chunk], mins,
                                    torch.zeros_like(mins)).sum()
    n_a, n_b = a_valid.sum(), b_valid.sum()
    return torch.where((n_a > 0) & (n_b > 0), total / n_a.clamp(min=1),
                       torch.full_like(total, float("nan")))


@torch.no_grad()
def chamfer_distance(a, b, a_valid=None, b_valid=None,
                     chunk: int = 4096) -> torch.Tensor:
    """Symmetric squared chamfer distance between (N, 3) and (M, 3) point
    sets (numpy or tensors) with optional (N,) / (M,) validity masks, as a
    0-dim float32 tensor on a's device (the CPU for numpy input)."""
    device = a.device if isinstance(a, torch.Tensor) else "cpu"
    a = torch.as_tensor(a, dtype=torch.float32, device=device)
    b = torch.as_tensor(b, dtype=torch.float32, device=device)
    a_valid = (torch.ones(a.shape[0], dtype=torch.bool, device=device)
               if a_valid is None else
               torch.as_tensor(a_valid, dtype=torch.bool, device=device))
    b_valid = (torch.ones(b.shape[0], dtype=torch.bool, device=device)
               if b_valid is None else
               torch.as_tensor(b_valid, dtype=torch.bool, device=device))
    with tf32(False):
        return (_one_sided(a, b, a_valid, b_valid, chunk)
                + _one_sided(b, a, b_valid, a_valid, chunk))
