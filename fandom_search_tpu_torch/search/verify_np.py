"""NumPy Smith-Waterman oracle; counterpart of fandom_search_tpu/search/verify_np.py."""

from __future__ import annotations

import numpy as np

from fandom_search_tpu_torch.config import SearchConfig


def sw_score_np(
    a: np.ndarray,
    b: np.ndarray,
    cfg: SearchConfig,
) -> float:
    """Smith-Waterman best local-alignment score of two token arrays."""
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return 0.0
    h = np.zeros((lb + 1,), dtype=np.float32)
    best = 0.0
    for i in range(la):
        diag_prev = 0.0  # H[i-1, j-1]
        for j in range(1, lb + 1):
            sub = cfg.sw_match if a[i] == b[j - 1] else cfg.sw_mismatch
            val = max(0.0, diag_prev + sub, h[j] + cfg.sw_gap, h[j - 1] + cfg.sw_gap)
            diag_prev = h[j]
            h[j] = val
            if val > best:
                best = val
    return float(best)


def sw_normalized_np(
    a: np.ndarray,
    b: np.ndarray,
    cfg: SearchConfig,
) -> float:
    """Score normalized so a full containment of the shorter side == 1.0."""
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return 0.0
    return sw_score_np(a, b, cfg) / (cfg.sw_match * min(la, lb))

