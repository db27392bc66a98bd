"""32-bit word hashing (FNV-1a + fmix32); counterpart of fandom_search_tpu/data/hashing.py."""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np

_U32 = np.uint32
_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619

# Golden-ratio / PCG-ish odd constants for salt derivation.
_GAMMA_POS = np.uint32(0x9E3779B9)
_GAMMA_ROUND = np.uint32(0x7F4A7C15)


def fmix32(h):
    """Murmur3 finalizer on NumPy uint32 arrays.

    Multiplication wraps mod 2**32, which is exactly what we want;
    inputs MUST already be uint32 dtype arrays (NumPy
    uint32 *scalars* may warn on overflow — always pass arrays).
    """
    h = h ^ (h >> 16)
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


@lru_cache(maxsize=1 << 20)
def hash_word(word: str) -> int:
    """FNV-1a over UTF-8 bytes, finalized with fmix32. Returns uint32 as int."""
    h = _FNV_OFFSET
    for b in word.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFF
    return int(fmix32(np.array([h], dtype=_U32))[0])


def hash_words(words: Sequence[str]) -> np.ndarray:
    """Vectorized host hashing of a word sequence -> uint32[len(words)]."""
    return np.fromiter(
        (hash_word(w) for w in words), dtype=_U32, count=len(words)
    )


def derive_sign_mults(seed: int, n_positions: int, dim: int) -> np.ndarray:
    """Deterministic odd uint32 [n_positions, dim] multiplier table.

    mult[p, l] = fmix32(fmix32(seed + (p+1)*GAMMA_POS) ^ (l+1)*GAMMA_ROUND) | 1

    One odd constant per (shingle position, embedding lane) for the
    multiply-shift sign embedding (data/shingler.py): the sign feature
    is the top bit of ``word_hash * mult[p, l]`` (wrapping).  Word
    hashes are already fmix32-finalized, so a single multiply gives
    sign bits statistically indistinguishable from re-hashing per lane
    (measured: noise sd 0.5294 vs 0.5310, identical tails) at ~1/20th
    the VPU work — the difference between the embedding dominating the
    device profile and vanishing into it.  Computed once on host;
    passed to device as a 3KB constant.
    """
    p = (np.arange(1, n_positions + 1, dtype=np.uint64) * int(_GAMMA_POS)).astype(
        _U32
    )[:, None]
    l = (np.arange(1, dim + 1, dtype=np.uint64) * int(_GAMMA_ROUND)).astype(
        _U32
    )[None, :]
    base = fmix32((np.uint64(seed) + p.astype(np.uint64)).astype(_U32))
    return fmix32(base ^ l) | _U32(1)
