"""K2 and K7 fused int8 distance + top-k; counterpart of fandom_search_tpu/ops/distance_topk.py.

``topk_dot`` launches a CUDA kernel on CUDA tensors and runs
``topk_dot_plain`` on CPU tensors.  Both return, per query row, the
exact top-k of dot(q, s) / dim over script rows [0, ns_valid), ties to
the lowest column; empty slots are (NEG_INF, 0).  With a finite
``min_keep`` only scores >= min_keep enter, so a row may hold padding
where the JAX insert kernel would hold sub-threshold entries — entries
at or above the threshold are identical (the engine never reads the
others).  The JAX rows kernel keeps only entries >= min_keep too, so
there every slot is equal.

``merge`` takes the JAX op's four names.  "insert", "insertloop" and
"rebuild" (one output, three TPU merge strategies) launch K2,
``csrc/distance_topk.cu``; "rows" launches K7,
``csrc/distance_topk_rows.cu``, when ``min_keep`` is at least 1/dim,
and K2 below that, as the JAX op sends "rows" to "insertloop" there.

Both kernels score on the int8 tensor cores.  K2 sends each score that
reaches its row's gate to a per-row list and merges the list into the
row's top-k (one entry by an insert, more by a warp bitonic sort and
merge); the gate rises to the k-th score + 1 once the row is full.  K7
runs the TPU kernel's per-row kill loop over a score tile that the warp
writes only when a row's maximum beats its k-th.
``utils/topk_cases.py`` holds the edge cases of both designs.

K2 at the engine's shape (dim 128, k <= 32; ``wgmma_route``) runs on
warpgroup MMA (``fs_topk_wgmma``, counted in ``topk_dot.launches_wgmma``
too): 512 query rows a block in two consumer warpgroups, script tiles
fed by TMA from a producer warp.  Where the rows fill fewer blocks than
the card has SMs, the script's tiles are cut into column ranges
(``wgmma_splits``) and a second kernel merges each row's ranges.  K7 and
K2's other shapes score on ``mma.sync`` m16n8k32 through one producer,
``csrc/int8_tiles.cuh``: 256 query rows a block, 64 a warp with their A
fragments in registers, script tiles through a ``cp.async`` ring.  Those
take any dim that is a multiple of 128 (the producer walks 128-byte
k-chunks, A reloaded per chunk) and any k (above 32 a row's top-k lives
in its rows of the outputs and entries are inserted by the warp), through
their own template instantiations.  Scores must satisfy |dot| * 32 <
2^31 (the packed step keys), which embeddings with entries in [-n, n] do
for any dim below 2^26 / n^2.
"""

from __future__ import annotations

import numpy as np
import torch

from fandom_search_tpu_torch.ops import _cuda

NEG_INF = float(np.finfo(np.float32).min)

# min_keep floor in raw-dot units: far below any real score (|dot| <=
# n^2 * dim), the same floor the JAX kernel uses for -inf
_KEEP_FLOOR = -(1 << 30)
_KEY_EMPTY = -(1 << 62)
_KERNEL_DIM_STEP = 128
_MERGES = ("insert", "insertloop", "rebuild", "rows")
# csrc/distance_topk.cu's warpgroup-MMA K2: rows a block, script rows a
# tile, and the fewest tiles a column range of a split launch walks
WGMMA_BLOCK_ROWS = 512
WGMMA_TILE_COLS = 128
WGMMA_MIN_SPLIT_TILES = 4


def wgmma_route(dim: int, k: int) -> bool:
    """K2 runs on warpgroup MMA (``fs_topk_wgmma``) at the engine's shape,
    dim 128 and k <= 32; every other shape on the ``mma.sync`` producer
    (``fs_topk``)."""
    return dim == 128 and k <= 32


def wgmma_splits(nq: int, ns_valid: int, sms: int) -> int:
    """Column ranges of the script for one warpgroup-MMA K2 launch: 1 when
    the rows fill at least one block an SM; else as many as keep the
    blocks (row blocks x ranges) within one wave of ``sms``, each range
    at least WGMMA_MIN_SPLIT_TILES tiles."""
    row_blocks = -(-nq // WGMMA_BLOCK_ROWS)
    tiles = -(-ns_valid // WGMMA_TILE_COLS)
    if row_blocks >= sms:
        return 1
    return max(1, min(sms // row_blocks, tiles // WGMMA_MIN_SPLIT_TILES))


def min_keep_int(min_keep: float, dim: int) -> int:
    """``score >= min_keep`` as an integer test on the raw dot."""
    if not np.isfinite(min_keep):
        return _KEEP_FLOOR
    return int(min(max(int(np.ceil(min_keep * dim)), _KEEP_FLOOR), 1 << 30))


def topk_lowest_col(score: torch.Tensor, keep: torch.Tensor, k: int):
    """Per row, the top k of int64 ``score`` [R, N] among entries where
    ``keep``, ties to the lowest column: (score int64 [R, k], column
    int64 [R, k], empty bool [R, k]), best first; an empty slot holds
    no entry (fewer than k kept).

    Packs (score, column) into one unique int64 key, score * N +
    (N - 1 - col), so the top-k of the keys is the top-k of the scores
    with the lowest column first on ties — torch.topk alone does not
    break ties that way.  Needs |score| * N far below 2^62.
    """
    n = score.shape[1]
    rank = n - 1 - torch.arange(n, device=score.device, dtype=torch.int64)
    key = torch.where(keep, score * n + rank, _KEY_EMPTY)
    if k > n:
        key = torch.nn.functional.pad(key, (0, k - n), value=_KEY_EMPTY)
    top = torch.topk(key, k, dim=1).values
    empty = top == _KEY_EMPTY
    sc = torch.div(top, n, rounding_mode="floor")
    return sc, n - 1 - (top - sc * n), empty


def topk_dot_plain(q: torch.Tensor, s: torch.Tensor, ns_valid: int, k: int,
                   min_keep_i: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the K2 kernel.

    Dots run as f32 matmuls, which are exact here (int8 @ int8 on the
    CPU returns int8 and overflows); ``topk_lowest_col`` selects.  Query
    rows are chunked so no more than ~64M keys exist at once.
    """
    nq, dim = q.shape
    dev = q.device
    vals = torch.full((nq, k), NEG_INF, dtype=torch.float32, device=dev)
    idx = torch.zeros((nq, k), dtype=torch.int32, device=dev)
    ns = int(ns_valid)
    if nq == 0 or ns == 0:
        return vals, idx
    s_t = s[:ns].float().T.contiguous()                       # [dim, ns]
    inv_dim = float(np.float32(1.0 / dim))  # the kernel's f32 multiplier
    chunk = max(1, (1 << 26) // max(ns, k))
    for q0 in range(0, nq, chunk):
        q1 = min(nq, q0 + chunk)
        score = (q[q0:q1].float() @ s_t).long()               # exact ints
        sc, col, empty = topk_lowest_col(score, score >= min_keep_i, k)
        vals[q0:q1] = torch.where(empty, NEG_INF, sc.float() * inv_dim)
        idx[q0:q1] = torch.where(empty, 0, col).int()
    return vals, idx


def topk_dot(q: torch.Tensor, s: torch.Tensor, ns_valid: int, k: int, *,
             min_keep: float = -float("inf"),
             merge: str = "insert") -> tuple[torch.Tensor, torch.Tensor]:
    """int8 q [NQ, dim], int8 s [NS, dim] -> (f32 vals [NQ, k], int32 idx [NQ, k]).

    ``min_keep`` (in dot/dim units) declares that the caller discards
    scores below it; leave it at -inf for the exact full top-k.
    ``merge="rows"`` with ``min_keep >= 1/dim`` runs K7 (counted in
    ``topk_dot.launches_rows``); every other call runs K2 (counted in
    ``topk_dot.launches``, and at ``wgmma_route``'s shape also in
    ``topk_dot.launches_wgmma``).  Both compute the same function.
    """
    if merge not in _MERGES:
        raise ValueError(
            f"merge must be 'insert', 'insertloop', 'rebuild' or "
            f"'rows', got {merge!r}"
        )
    _cuda.require(q.dtype == torch.int8 and q.dim() == 2,
                  f"q must be int8 [NQ, dim], got {q.dtype} {tuple(q.shape)}")
    _cuda.require(s.dtype == torch.int8 and s.dim() == 2 and s.shape[1] == q.shape[1],
                  f"s must be int8 [NS, {q.shape[1]}], got {s.dtype} {tuple(s.shape)}")
    _cuda.require(0 <= ns_valid <= s.shape[0],
                  f"ns_valid ({ns_valid}) must lie in [0, {s.shape[0]}]")
    _cuda.require(k >= 1, f"k ({k}) must be >= 1")
    nq, dim = q.shape
    keep_i = min_keep_int(min_keep, dim)
    if _cuda.on_cpu(q, s):
        return topk_dot_plain(q, s, ns_valid, k, keep_i)
    _cuda.require(dim > 0 and dim % _KERNEL_DIM_STEP == 0,
                  f"the CUDA kernel takes dim a multiple of {_KERNEL_DIM_STEP}, got {dim}")
    _cuda.require(q.is_contiguous() and s.is_contiguous(),
                  "q and s must be contiguous")
    _cuda.require(q.data_ptr() % 16 == 0 and s.data_ptr() % 16 == 0,
                  "q and s must be 16-byte aligned")
    vals = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    if nq == 0:
        return vals, idx
    rows = merge == "rows" and keep_i >= 1
    wgmma = not rows and wgmma_route(dim, k)
    args = (q.data_ptr(), s.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            nq, int(ns_valid), dim, k, keep_i, 1.0 / dim)
    if wgmma:
        name = "fs_topk_wgmma"
        splits = wgmma_splits(nq, int(ns_valid), _cuda.sm_count(q.device))
        # freed on return: the caching allocator hands it on only to work
        # queued after this launch on the same stream
        part = (torch.empty((splits, nq, k), dtype=torch.int64, device=q.device)
                if splits > 1 else None)
        args += (0 if part is None else part.data_ptr(), splits)
    else:
        name = "fs_topk_rows" if rows else "fs_topk"
    rc = getattr(_cuda.library(), name)(*args, _cuda.stream_ptr(q.device))
    _cuda.check(rc, name)
    if rows:
        topk_dot.launches_rows += 1
    else:
        topk_dot.launches += 1
        topk_dot.launches_wgmma += wgmma
    return vals, idx


topk_dot.launches = 0        # K2
topk_dot.launches_wgmma = 0  # K2 on warpgroup MMA (dim 128, k <= 32)
topk_dot.launches_rows = 0   # K7
