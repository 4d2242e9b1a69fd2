"""JSD between aggregated histograms.

metrics/metrics/histogram/jsd.py:14-16, 92-101: sum all histograms per side,
normalize to a pmf, take the scipy `jensenshannon` *distance* (sqrt of the
divergence, natural log).
"""

from __future__ import annotations

import numpy as np


def jsd_2d(p: np.ndarray, q: np.ndarray) -> float:
    """Jensen-Shannon distance between two distributions (flattened)."""
    p = np.asarray(p, np.float64).ravel()
    q = np.asarray(q, np.float64).ravel()
    p = p / p.sum()
    q = q / q.sum()
    m = 0.5 * (p + q)

    def kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log(a[mask] / b[mask])))

    js_div = 0.5 * kl(p, m) + 0.5 * kl(q, m)
    return float(np.sqrt(max(js_div, 0.0)))


def compute_jsd(hists_a, hists_b) -> float:
    """Aggregate-then-compare JSD (jsd.py:92-101)."""
    p = np.sum(np.stack([np.asarray(h, np.float64) for h in hists_a]), axis=0)
    q = np.sum(np.stack([np.asarray(h, np.float64) for h in hists_b]), axis=0)
    return jsd_2d(p, q)
