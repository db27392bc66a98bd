"""Host shingle windows and embedding oracle; counterpart of fandom_search_tpu/data/shingler.py:37-67."""

from __future__ import annotations

import numpy as np

from fandom_search_tpu.config import ShingleConfig
from fandom_search_tpu_torch.data.hashing import derive_sign_mults


def num_shingles(num_tokens: int, cfg: ShingleConfig) -> int:
    return max(0, num_tokens - cfg.n + 1)


def shingle_hashes(token_hashes: np.ndarray, cfg: ShingleConfig) -> np.ndarray:
    """[T] uint32 token hashes -> [T-n+1, n] uint32 shingle windows (host)."""
    t = np.asarray(token_hashes, dtype=np.uint32)
    m = num_shingles(t.shape[0], cfg)
    if m == 0:
        return np.zeros((0, cfg.n), dtype=np.uint32)
    return np.lib.stride_tricks.sliding_window_view(t, cfg.n).copy()


def embed_shingles_np(token_hashes: np.ndarray, cfg: ShingleConfig) -> np.ndarray:
    """Host-side oracle embedding: uint32[T] -> int8[T-n+1, dim].

    Entries are in [-n, n]; int8 is exact and matmul-friendly.
    """
    mults = derive_sign_mults(cfg.seed, cfg.n, cfg.dim)  # [n, dim]
    t = np.asarray(token_hashes, dtype=np.uint32)
    m = num_shingles(t.shape[0], cfg)
    if m == 0:
        return np.zeros((0, cfg.dim), dtype=np.int8)
    acc = np.zeros((m, cfg.dim), dtype=np.int16)
    for p in range(cfg.n):
        prod = t[p : p + m][:, None] * mults[p][None, :]  # wraps mod 2^32
        # top bit as sign: int32 arithmetic shift gives 0 / -1
        acc += (
            (prod.astype(np.int32) >> 31).astype(np.int16) * 2 + 1
        )
    return acc.astype(np.int8)
