"""K1 shingle embedding; counterpart of fandom_search_tpu/ops/embed.py.

``embed_shingles`` launches ``csrc/embed.cu`` on CUDA tensors and runs
``embed_shingles_plain`` on CPU tensors.  Token hashes and multipliers
travel as int32 bit patterns of their uint32 values; the output is the
row-major int8 [M, dim] of ``data/shingler.py embed_shingles_np``.
"""

from __future__ import annotations

import torch

from fandom_search_tpu_torch.ops import _cuda


def _u32_mul_bit31(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bit 31 of (a * b mod 2^32) for int32 bit patterns, exact in int64.

    Splitting a into 16-bit halves keeps every product below 2^48, so
    nothing relies on how int32 multiplication overflows."""
    a = a.long() & 0xFFFFFFFF
    b = b.long() & 0xFFFFFFFF
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    prod = (lo + (hi << 16)) & 0xFFFFFFFF
    return prod >> 31


def embed_shingles_plain(tokens: torch.Tensor, mults: torch.Tensor) -> torch.Tensor:
    """int32 [T], int32 [n, dim] -> int8 [max(0, T-n+1), dim]."""
    n, dim = mults.shape
    m = max(0, tokens.shape[0] - n + 1)
    acc = torch.zeros((m, dim), dtype=torch.int32, device=tokens.device)
    for p in range(n):
        bit = _u32_mul_bit31(tokens[p : p + m, None], mults[p][None, :])
        acc += 1 - 2 * bit.int()
    return acc.to(torch.int8)


def embed_shingles(tokens: torch.Tensor, mults: torch.Tensor) -> torch.Tensor:
    """int32 [T] token hashes, int32 [n, dim] multipliers -> int8 [M, dim].

    M = max(0, T - n + 1).  Bit-exact with embed_shingles_np.
    """
    _cuda.require(tokens.dtype == torch.int32 and tokens.dim() == 1,
                  f"tokens must be int32 [T], got {tokens.dtype} {tuple(tokens.shape)}")
    _cuda.require(mults.dtype == torch.int32 and mults.dim() == 2,
                  f"mults must be int32 [n, dim], got {mults.dtype} {tuple(mults.shape)}")
    if _cuda.on_cpu(tokens, mults):
        return embed_shingles_plain(tokens, mults)
    n, dim = mults.shape
    _cuda.require(tokens.is_contiguous() and mults.is_contiguous(),
                  "tokens and mults must be contiguous")
    _cuda.require(n >= 1 and dim % 16 == 0 and dim > 0,
                  f"n ({n}) must be >= 1 and dim ({dim}) a multiple of 16")
    _cuda.require(mults.data_ptr() % 16 == 0, "mults must be 16-byte aligned")
    m = max(0, tokens.shape[0] - n + 1)
    out = torch.empty((m, dim), dtype=torch.int8, device=tokens.device)
    if m == 0:
        return out
    lib = _cuda.library()
    rc = lib.fs_embed(
        tokens.data_ptr(), mults.data_ptr(), out.data_ptr(), m, n, dim,
        _cuda.stream_ptr(tokens.device),
    )
    _cuda.check(rc, "fs_embed")
    embed_shingles.launches += 1
    return out


embed_shingles.launches = 0
