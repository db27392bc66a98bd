"""Bucketed (inverted-index) prefilter; counterpart of fandom_search_tpu/ops/bucketed.py.

The sub-linear candidate stage for large script indexes.  One table per
probed position pair (i, j) of a shingle's n word hashes buckets every
script shingle by fmix32(fmix32(w_i + salt) ^ w_j); a query probes the
same P buckets, and only the script shingles found there are scored,
exactly, with the int8 dot.  Any candidate that matches a query in both
positions of a probed pair shares that bucket, so the pair set carries a
deterministic guarantee: "triangles" (groups of 3 positions, 6 probes at
n 6) finds every candidate with >= ceil(n/3) + 1 exact matches, "all"
(every pair, 15 probes) every candidate with >= 2.  A bucket holding
more than ``cap`` shingles is read only up to ``cap``; a query probing
such a bucket is "at risk", and the hybrid reroutes it through the exact
kernel (K2).

Host half: ``BucketedIndex.build`` sorts the shingle ids by bucket with
the native counting sort (``fs_bucketed_table`` in the port's
``native/fastingest.cpp``, one thread a table), or with NumPy's stable
argsort where that library is absent on the CPU; both give the same
tables.

Device half, on the engine's device inside its fused step, with no host
sync (the flat path of the JAX package's ``impl="seg"``):

  geometry — every (query, probe) bucket's start and clipped length
    (``_probe_geometry``; the hashes in int64, masked to 32 bits);
  segment stream — the clipped lengths scanned (K3) into a stream of E
    pair slots, one marker a segment scattered and scanned again (K3)
    to give each slot its (query, probe), then the script id read from
    the table (``_stream_pairs``);
  gather-dot — the exact int8 dot of every pair, in chunks
    (``_gather_dot``);
  sort — the kept pairs ranked by (query, -score, script id), one
    stable pass a key (``_rank_sort``);
  compaction — duplicates dropped, the top k of each query kept, and
    the survivors compacted (K3) into the engine's (qpos, sidx, score,
    count) contract (``_rank_compact``).

The hybrid (``bucketed_hybrid``) drops the at-risk queries from that
stream, compacts their rows (K3) into the sticky ``risk_budget`` rows,
runs K2 on those rows (``exact_on_risk_rows``; -1 rows are zeroed and
keep nothing) and merges both triple sets.  It returns the at-risk
count beside them, and the engine reruns a batch whose count exceeds the
budget, as it does for its other budgets.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from fandom_search_tpu_torch.config import BucketedConfig, ShingleConfig
from fandom_search_tpu_torch.data.hashing import fmix32
from fandom_search_tpu_torch.ops.distance_topk import topk_dot
from fandom_search_tpu_torch.ops.scan import nonzero_compact, scan1d_i32

log = logging.getLogger(__name__)

_I32_MAX = 2**31 - 1
_M32 = 0xFFFFFFFF
# rank key of a pair that is not kept: after every query row
_BIG = 1 << 30
# pairs a chunk of the gather-dot: two [chunk, dim] int32 blocks (128 MB
# each at dim 128)
_DOT_CHUNK = 1 << 18


def _derive_salts(seed: int, p: int) -> np.ndarray:
    """One uint32 salt per probe table."""
    return fmix32(
        (np.uint64(seed) + np.arange(1, p + 1, dtype=np.uint64)
         * np.uint64(0x9E3779B9)).astype(np.uint32)
    )


def _pairs_for(n: int, mode: str = "triangles") -> Tuple[Tuple[int, int], ...]:
    """Probe position pairs.  "triangles": every pair within each group
    of 3 positions (a trailing 1-position group probes (p, p));
    "all": every C(n, 2) pair."""
    if n < 2:
        return ((0, 0),)
    if mode == "all":
        return tuple((i, j) for i in range(n) for j in range(i + 1, n))
    pairs = []
    for g0 in range(0, n, 3):
        grp = list(range(g0, min(g0 + 3, n)))
        if len(grp) == 1:
            pairs.append((grp[0], grp[0]))
        else:
            pairs.extend(
                (grp[i], grp[j])
                for i in range(len(grp))
                for j in range(i + 1, len(grp))
            )
    return tuple(pairs)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 tensors of uint32 values: the two
    16-bit halves of c keep every product below 2^48."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32_t(h: torch.Tensor) -> torch.Tensor:
    """fmix32 on int64 tensors of uint32 values (shifts of non-negative
    values are logical)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _bucket_ids(w_a, w_b, salt, num_buckets: int):
    """Bucket id of an exact word-hash pair: NumPy uint32 arrays (and a
    uint32 salt) give int32 ids; torch int64 tensors of uint32 values (a
    salt int or tensor) give int64 ids."""
    if isinstance(w_a, torch.Tensor):
        k = _fmix32_t(_fmix32_t((w_a + salt) & _M32) ^ w_b)
        return k & (num_buckets - 1)
    k = fmix32(fmix32(w_a + np.uint32(salt)) ^ w_b)
    return (k & np.uint32(num_buckets - 1)).astype(np.int32)


def _build_tables_native(w, pairs, salts, num_buckets, cap, entries, offsets):
    """Counting-sort table build in C++ (``fs_bucketed_table``), one
    GIL-free thread per probe table.  Returns the overflow entry count,
    or None when the native library is unavailable."""
    from fandom_search_tpu_torch.data.fast_tokenizer import get_lib

    lib = get_lib()
    if lib is None:
        return None
    ns = w.shape[0]
    cols = {}
    for (a, bb) in pairs:
        for c in (a, bb):
            if c not in cols:
                cols[c] = np.ascontiguousarray(w[:, c])
    keys_scratch = np.empty((len(pairs), ns), dtype=np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)

    def one(i):
        a, bb = pairs[i]
        return lib.fs_bucketed_table(
            cols[a].ctypes.data_as(u32p),
            cols[bb].ctypes.data_as(u32p),
            ctypes.c_int64(ns),
            ctypes.c_uint32(int(salts[i])),
            ctypes.c_uint32(num_buckets - 1),
            ctypes.c_int32(cap),
            keys_scratch[i].ctypes.data_as(u32p),
            entries[i].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets[i].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )

    with ThreadPoolExecutor(max_workers=min(8, len(pairs))) as ex:
        return sum(ex.map(one, range(len(pairs))))


def _build_tables_numpy(w, pairs, salts, num_buckets, cap, entries, offsets):
    """The native build's twin: a stable argsort per table (ties in
    ascending shingle id).  Returns the overflow entry count."""
    ns = w.shape[0]
    over = 0
    for i, (a, bb) in enumerate(pairs):
        keys = _bucket_ids(w[:, a], w[:, bb], salts[i], num_buckets)
        entries[i, :ns] = np.argsort(keys, kind="stable")
        counts = np.bincount(keys, minlength=num_buckets)
        offsets[i, 1:] = np.cumsum(counts)
        over += int(counts[counts > cap].sum())
    return over


@dataclass
class BucketedIndex:
    """The inverted tables over the script's shingles, on a device."""

    entries: torch.Tensor     # int32 [P, max(1, NS)] shingle ids sorted by bucket
    offsets: torch.Tensor     # int32 [P, B + 1] CSR bucket offsets
    num_buckets: int
    salts: Tuple[int, ...]    # one per probe table
    ns_valid: int
    overflow_frac: float      # share of entries in buckets larger than cap
    builder: str = "loaded"   # "native", "numpy", "empty" or "loaded"
    build_seconds: float = 0.0

    @classmethod
    def build(cls, shingle_windows: np.ndarray, cfg: BucketedConfig,
              shingle_cfg: ShingleConfig, device="cuda") -> "BucketedIndex":
        """Tables of uint32 windows [NS, n] (``ScriptIndex.shingle_windows``),
        built on the host by the C++ builder and put on ``device``.  Where
        its library is absent NumPy's twin builds them for the CPU; for a
        CUDA device that raises."""
        dev = torch.device(device)
        t0 = time.perf_counter()
        w = np.asarray(shingle_windows, dtype=np.uint32)
        ns = w.shape[0] if w.ndim == 2 else 0
        pairs = _pairs_for(shingle_cfg.n, cfg.pairs)
        p = len(pairs)
        b = 1024
        while b < cfg.load_factor * max(ns, 1):
            b *= 2
        salts = _derive_salts(cfg.seed, p)
        entries = np.zeros((p, max(ns, 1)), dtype=np.int32)
        offsets = np.zeros((p, b + 1), dtype=np.int32)  # counts < 2^31
        over, builder = 0, "empty"
        if ns:
            over = _build_tables_native(w, pairs, salts, b, cfg.cap, entries, offsets)
            builder = "native"
            if over is None:
                if dev.type != "cpu":
                    raise RuntimeError(
                        "the native bucketed table builder (fs_bucketed_table) did "
                        "not load; it is required here")
                over = _build_tables_numpy(w, pairs, salts, b, cfg.cap, entries, offsets)
                builder = "numpy"
        return cls(
            entries=torch.from_numpy(entries).to(dev),
            offsets=torch.from_numpy(offsets).to(dev),
            num_buckets=b,
            salts=tuple(int(s) for s in salts),
            ns_valid=ns,
            overflow_frac=over / max(1, ns * p),
            builder=builder,
            build_seconds=time.perf_counter() - t0,
        )

    @classmethod
    def from_arrays(cls, entries: np.ndarray, offsets: np.ndarray, num_buckets: int,
                    salts, ns_valid: int, overflow_frac: float) -> "BucketedIndex":
        """An index on the CPU from saved arrays; ``to`` moves it."""
        return cls(
            entries=torch.from_numpy(np.ascontiguousarray(entries, dtype=np.int32)),
            offsets=torch.from_numpy(np.ascontiguousarray(offsets, dtype=np.int32)),
            num_buckets=int(num_buckets),
            salts=tuple(int(s) for s in salts),
            ns_valid=int(ns_valid),
            overflow_frac=float(overflow_frac),
        )

    def to(self, device) -> "BucketedIndex":
        return dataclasses.replace(self, entries=self.entries.to(device),
                                   offsets=self.offsets.to(device))


@functools.lru_cache(maxsize=64)
def _probe_consts(device: torch.device, n: int, pairs_mode: str,
                  salts: Tuple[int, ...], num_buckets: int):
    """(column a [P], column b [P], salt [P], table base [P]) on
    ``device``, int64.  Cached: a tensor copied from host memory waits
    for the stream, so the engine's fused step must not make them."""
    pairs = _pairs_for(n, pairs_mode)
    p = len(pairs)
    if len(salts) != p:
        raise ValueError(f"{len(salts)} salts for {p} probe pairs")
    host = torch.tensor([[a for a, _ in pairs], [b for _, b in pairs], list(salts),
                         [i * (num_buckets + 1) for i in range(p)]], dtype=torch.int64)
    return tuple(host.to(device))


def _windows(stream: torch.Tensor, n: int) -> torch.Tensor:
    """int32 token stream [T] (uint32 bit patterns) -> int64 [M, n] of
    uint32 values, M = max(0, T - n + 1)."""
    s64 = stream.long() & _M32
    if stream.shape[0] < n:
        return s64.new_zeros((0, n))
    return s64.unfold(0, n, 1)


def _probe_geometry(stream, offsets, *, n, cap, num_buckets, salts, pairs_mode):
    """Bucket (start, clipped length) of every (query, probe), without
    the entry gather: (start int32 [M, P], ln int32 [M, P], at_risk bool
    [M]); at_risk marks a query probing any bucket over ``cap``."""
    col_a, col_b, salt, base = _probe_consts(
        stream.device, n, pairs_mode, tuple(salts), num_buckets)
    win = _windows(stream, n)
    bk = _bucket_ids(win[:, col_a], win[:, col_b], salt, num_buckets)   # [M, P]
    flat = offsets.reshape(-1)
    fi = bk + base
    start = flat[fi]
    full = flat[fi + 1] - start
    return start, full.clamp(max=cap), (full > cap).any(dim=1)


def probe_candidates(stream, entries, offsets, *, n, cap, num_buckets, salts,
                     pairs_mode="triangles"):
    """Bucket-probe every query shingle: (cand int32 [M, P*cap], ok bool
    [M, P*cap], at_risk bool [M]), candidates sorted ascending per row
    with invalid slots 0 and duplicates masked out of ``ok``."""
    start, ln, at_risk = _probe_geometry(
        stream, offsets, n=n, cap=cap, num_buckets=num_buckets, salts=salts,
        pairs_mode=pairs_mode)
    m, p = start.shape
    dev = stream.device
    iota = torch.arange(cap, dtype=torch.int32, device=dev)
    ecols = entries.shape[1]
    probe = torch.arange(p, dtype=torch.int64, device=dev)[None, :, None] * ecols
    pos = (start[:, :, None] + iota).clamp(0, ecols - 1)
    cand = entries.reshape(-1)[probe + pos].reshape(m, p * cap)
    ok = (iota < ln[:, :, None]).reshape(m, p * cap)
    s = torch.sort(torch.where(ok, cand, _I32_MAX), dim=1).values
    ok = s < _I32_MAX
    dup = torch.cat([torch.zeros((m, 1), dtype=torch.bool, device=dev),
                     s[:, 1:] == s[:, :-1]], dim=1)
    return torch.where(ok, s, 0), ok & ~dup, at_risk


def bucketed_topk(q_emb, stream, bidx: BucketedIndex, s_emb, k: int, dim: int,
                  cfg: BucketedConfig, shingle_cfg: ShingleConfig):
    """Sub-linear top-k: bucket probe -> exact int8 rerank (``rerank_exact``);
    scores are dot / dim, as K2's."""
    from fandom_search_tpu_torch.ops.lsh import rerank_exact

    cand, ok, _ = probe_candidates(
        stream, bidx.entries, bidx.offsets, n=shingle_cfg.n, cap=cfg.cap,
        num_buckets=bidx.num_buckets, salts=bidx.salts, pairs_mode=cfg.pairs)
    return rerank_exact(q_emb, s_emb, cand, ok, k, dim)


def _seg_stream(ln_flat, start_flat, pair_budget: int):
    """Each slot of the [pair_budget] pair stream's segment and entry
    column, from the clipped per-(query, probe) lengths: (seg int32 [E],
    epos int32 [E], valid bool [E], pair_count int32 scalar).

    One marker per segment start goes into E + 1 slots and a scan
    recovers the segment of every slot (empty segments pile onto the
    next start).  The spare slot takes the markers of segments that
    start at or past the budget: with pair mass exactly E and trailing
    empty segments, clipping them onto slot E - 1 would give that valid
    slot the wrong segment."""
    csum = scan1d_i32(ln_flat)
    pair_count = csum[-1]                          # pre-dedup mass
    out_start = csum - ln_flat                     # exclusive scan
    adds = torch.zeros((pair_budget + 1,), dtype=torch.int32, device=ln_flat.device)
    adds.index_add_(0, out_start.clamp(max=pair_budget).long(),
                    torch.ones_like(out_start))
    e_iota = torch.arange(pair_budget, dtype=torch.int32, device=ln_flat.device)
    seg = (scan1d_i32(adds[:pair_budget]) - 1).clamp(0, ln_flat.shape[0] - 1)
    valid = e_iota < pair_count
    # epos = start[seg] + (e - out_start[seg]): one gather of the delta
    delta = start_flat - out_start
    epos = e_iota + delta[seg.long()]
    return seg, epos, valid, pair_count


def _pair_budget(m_queries: int, p: int, max_out: int) -> int:
    """The flat stream's slots: about twice the expected noise pairs
    (P / load factor a query) plus 8 a candidate of the engine's budget,
    on the quarter-pow2 ladder."""
    slack = max(2, -(-p // 3))
    return _next_qpow2(slack * m_queries + 8 * max_out, 1024)


def _stream_pairs(start, ln, at_risk, entries, *, pair_budget: int, drop_risk: bool):
    """The segment stream of the probe geometry: (row int32 [E], sid int32
    [E], valid bool [E], pair_count).  ``drop_risk`` leaves the pairs of
    at-risk queries out of the stream."""
    p = start.shape[1]
    if drop_risk:
        ln = torch.where(at_risk[:, None], 0, ln)
    seg, epos, valid, pair_count = _seg_stream(
        ln.reshape(-1).contiguous(), start.reshape(-1), pair_budget)
    ecols = entries.shape[1]
    sid = entries.reshape(-1)[
        (seg % p).long() * ecols + epos.clamp(0, ecols - 1).long()]
    return seg // p, torch.where(valid, sid, 0), valid, pair_count


def _gather_dot(q_emb, s_emb, row, sid) -> torch.Tensor:
    """Exact int32 dots of q_emb[row] and s_emb[sid] (int8 rows), in
    chunks of ``_DOT_CHUNK`` pairs; rows past q_emb read its last row."""
    e = row.shape[0]
    out = torch.empty((e,), dtype=torch.int32, device=row.device)
    rq = row.clamp(max=q_emb.shape[0] - 1).long()
    rs = sid.long()
    for c0 in range(0, e, _DOT_CHUNK):
        c1 = min(e, c0 + _DOT_CHUNK)
        qe = q_emb[rq[c0:c1]].int()
        se = s_emb[rs[c0:c1]].int()
        out[c0:c1] = (qe * se).sum(dim=1, dtype=torch.int32)
    return out


def _rank_sort(row, sid, dot, valid, *, dim: int, threshold: float):
    """The pairs at or above ``threshold`` (dot / dim, in f32) sorted by
    (row, -dot, sid); the others after them: (row_s, neg_s, sid_s)."""
    from fandom_search_tpu_torch.search.engine import _f32, _stable_sort_perm

    keep = valid & (dot.float() / dim >= _f32(threshold))
    key_row = torch.where(keep, row, _BIG)
    key_neg = torch.where(keep, -dot, 0)
    perm = _stable_sort_perm([key_row, key_neg, sid])
    return key_row[perm], key_neg[perm], sid[perm]


def _rank_compact(row_s, neg_s, sid_s, pair_count, *, k: int, dim: int, max_out: int,
                  pair_budget: int):
    """Drop (row, sid) duplicates, keep the top k of each row and compact:
    (qpos int32 [max_out] -1 padded, sidx int32, score f32, count int32).
    The count exceeds ``max_out`` when either the triples or the pair
    stream overflowed, so the engine's retry grows both budgets."""
    dev = row_s.device
    e = row_s.shape[0]
    iota = torch.arange(e, dtype=torch.int32, device=dev)
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       row_s[1:] != row_s[:-1]])
    # (row, sid) duplicates sort adjacent: equal row and sid give equal dots
    dup = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev),
                     (row_s[1:] == row_s[:-1]) & (sid_s[1:] == sid_s[:-1])])
    keep2 = ((row_s < _BIG) & ~dup).int()
    c_exc = scan1d_i32(keep2) - keep2
    seg_start = scan1d_i32(torch.where(first, iota, 0), "max")
    rank = c_exc - c_exc[seg_start.long()]
    topk_keep = (keep2 > 0) & (rank < k)
    final_count = topk_keep.sum(dtype=torch.int32)
    out_pos = nonzero_compact(topk_keep, max_out)
    out_safe = out_pos.clamp(min=0).long()
    out_valid = out_pos >= 0
    qpos = torch.where(out_valid, row_s[out_safe], -1)
    sidx = torch.where(out_valid, sid_s[out_safe], 0)
    sc = (-neg_s[out_safe]).float() / dim
    over = torch.where(pair_count > pair_budget, max_out + pair_count - pair_budget, 0)
    return qpos, sidx, sc, torch.maximum(final_count, over.int())


def _stage_parts(stream, q_emb, entries, offsets, s_emb, *, n, cap, num_buckets, salts,
                 k, dim, threshold, max_out, pairs_mode, risk_budget=None, ns_valid=None,
                 drop_risk=None, stage=contextlib.nullcontext):
    """The candidate stage run part by part: {name: (part, result)} in
    order, where ``part()`` reruns that part alone on what the parts
    before it made, so that each can be timed alone.  The flat path ends
    at "compaction", whose result is (qpos, sidx, score, count);
    "geometry"'s third result is the at-risk mask.  With a
    ``risk_budget`` it drops the at-risk queries and "risk_rows" adds
    their rows ((rows, count)); with ``ns_valid`` as well, "stage2" runs
    K2 on them and "merge" joins the two triple sets.  ``drop_risk``
    drops the at-risk queries without a ``risk_budget`` (the sharded
    hybrid compacts their rows across shards).  Every part but "stage2"
    runs inside a ``stage()`` context (the engine's timer of stage 1)."""
    if stream.shape[0] < n:
        raise ValueError(
            f"query stream of {stream.shape[0]} tokens is shorter than "
            f"the shingle width n={n}; no query shingles exist"
        )
    parts = {}

    def run(name, part):
        with contextlib.nullcontext() if name == "stage2" else stage():
            parts[name] = (part, part())
        return parts[name][1]

    hybrid = risk_budget is not None
    drop = hybrid if drop_risk is None else drop_risk
    p = len(_pairs_for(n, pairs_mode))
    pair_budget = _pair_budget(stream.shape[0] - n + 1, p, max_out)
    start, ln, at_risk = run("geometry", lambda: _probe_geometry(
        stream, offsets, n=n, cap=cap, num_buckets=num_buckets, salts=salts,
        pairs_mode=pairs_mode))
    row, sid, valid, pair_count = run("segment_stream", lambda: _stream_pairs(
        start, ln, at_risk, entries, pair_budget=pair_budget, drop_risk=drop))
    dot = run("gather_dot", lambda: _gather_dot(q_emb, s_emb, row, sid))
    row_s, neg_s, sid_s = run("sort", lambda: _rank_sort(
        row, sid, dot, valid, dim=dim, threshold=threshold))
    flat = run("compaction", lambda: _rank_compact(
        row_s, neg_s, sid_s, pair_count, k=k, dim=dim, max_out=max_out,
        pair_budget=pair_budget))
    if hybrid:
        risk_rows, _ = run("risk_rows", lambda: (nonzero_compact(at_risk, risk_budget),
                                                 at_risk.sum(dtype=torch.int32)))
        if ns_valid is not None:
            exact = run("stage2", lambda: exact_on_risk_rows(
                q_emb, risk_rows, s_emb, ns_valid, k=k, dim=dim, threshold=threshold,
                max_out=max_out))
            run("merge", lambda: merge_triples(*flat, *exact, max_out=max_out))
    return parts


def bucketed_candidates_flat(stream, q_emb, entries, offsets, s_emb, *, n, cap,
                             num_buckets, salts, k, dim, threshold, max_out,
                             pairs_mode="triangles"):
    """Sub-linear candidate generation in the engine's contract
    (``compact_candidates``'s): the top k of each query among the pairs
    its probed buckets hold, at or above ``threshold``, ties to the
    lowest script id.  ``stream`` is the int32 token stream [T] (uint32
    bit patterns), ``q_emb`` its int8 embeddings [>= T - n + 1, dim]."""
    parts = _stage_parts(
        stream, q_emb, entries, offsets, s_emb, n=n, cap=cap, num_buckets=num_buckets,
        salts=salts, k=k, dim=dim, threshold=threshold, max_out=max_out,
        pairs_mode=pairs_mode)
    return parts["compaction"][1]


def bucketed_hybrid_parts(stream, q_emb, entries, offsets, s_emb, *, n, cap,
                          num_buckets, salts, k, dim, threshold, max_out, risk_budget,
                          pairs_mode="triangles"):
    """Hybrid stage 1: the flat path with at-risk queries dropped, and
    their rows compacted for stage 2: (qpos, sidx, sc, count, risk_rows
    int32 [risk_budget] -1 padded, risk_count), where risk_count may
    exceed risk_budget."""
    parts = _stage_parts(
        stream, q_emb, entries, offsets, s_emb, n=n, cap=cap, num_buckets=num_buckets,
        salts=salts, k=k, dim=dim, threshold=threshold, max_out=max_out,
        pairs_mode=pairs_mode, risk_budget=risk_budget)
    return (*parts["compaction"][1], *parts["risk_rows"][1])


def exact_on_risk_rows(q_emb, risk_rows, s_emb, ns_valid: int, *, k: int, dim: int,
                       threshold: float, max_out: int):
    """Hybrid stage 2: K2 with ``min_keep`` at the threshold on the
    at-risk rows only (-1 rows zeroed, keeping nothing), as triples
    mapped back to query positions and compacted to ``max_out`` with an
    exact count."""
    from fandom_search_tpu_torch.search.engine import _f32

    valid_row = risk_rows >= 0
    safe = risk_rows.clamp(0, q_emb.shape[0] - 1).long()
    qr = torch.where(valid_row[:, None], q_emb[safe], 0)
    vals, idx = topk_dot(qr, s_emb, ns_valid, k, min_keep=threshold)
    keep = (vals >= _f32(threshold)) & valid_row[:, None]
    pos = nonzero_compact(keep.reshape(-1), max_out)
    psafe = pos.clamp(min=0).long()
    pvalid = pos >= 0
    qpos = torch.where(pvalid, risk_rows[psafe // k], -1)
    sidx = torch.where(pvalid, idx.reshape(-1)[psafe], 0)
    return qpos, sidx, vals.reshape(-1)[psafe], keep.sum(dtype=torch.int32)


def merge_triples(qb, sb, scb, cb, qe, se, sce, ce, *, max_out: int):
    """Concatenate two compacted triple sets into one [max_out] set: the
    first at [0, cb), the second at [cb, cb + ce); the count may exceed
    max_out."""
    iota = torch.arange(max_out, dtype=torch.int32, device=qb.device)
    j = (iota - cb).clamp(0, qe.shape[0] - 1).long()
    from_e = iota >= cb
    return (torch.where(from_e, qe[j], qb), torch.where(from_e, se[j], sb),
            torch.where(from_e, sce[j], scb), cb + ce)


def bucketed_hybrid(stream, q_emb, entries, offsets, s_emb, ns_valid: int, *, n, cap,
                    num_buckets, salts, k, dim, threshold, max_out, risk_budget,
                    pairs_mode="triangles"):
    """The hybrid on the device, without a host sync: stage 1, K2 on the
    ``risk_budget`` at-risk rows, merged; (qpos, sidx, sc, count,
    risk_count).  The triples are right only when risk_count <=
    risk_budget: the caller reruns with a larger budget otherwise."""
    parts = _stage_parts(
        stream, q_emb, entries, offsets, s_emb, n=n, cap=cap, num_buckets=num_buckets,
        salts=salts, k=k, dim=dim, threshold=threshold, max_out=max_out,
        pairs_mode=pairs_mode, risk_budget=risk_budget, ns_valid=ns_valid)
    return (*parts["merge"][1], parts["risk_rows"][1][1])


def thresholded_recall_vs_exact(exact_vals, qpos, scores, count, *, dim, threshold,
                                stride=1):
    """Share of the exact top-k's entries at or above ``threshold`` that
    the candidate triples reproduce with an equal score (a multiset per
    query: ties matched one for one), with the number of such entries;
    ``stride`` subsamples queries."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    evn = host(exact_vals)
    n = int(host(count))
    got = {}
    for q, v in zip(host(qpos)[:n], np.round(host(scores)[:n] * dim)):
        got.setdefault(int(q), []).append(float(v))
    tot = hit = 0
    for i in range(0, evn.shape[0], stride):
        keep = evn[i] >= threshold
        if not keep.any():
            continue
        have = got.get(i, [])
        for v in np.round(evn[i][keep] * dim):
            tot += 1
            if v in have:
                have.remove(v)
                hit += 1
    return hit / max(1, tot), tot


def validate_and_place_bucketed(engine, cfg: BucketedConfig,
                                bidx: BucketedIndex | None) -> BucketedIndex:
    """Attach-time checks and placement: k against the probe width, the
    tables against the index's rows, the pure mode's refusal and the
    hybrid's warning on a skewed index.  Returns the index on the
    engine's device (built there when ``bidx`` is None)."""
    p_width = len(_pairs_for(engine.cfg.shingle.n, cfg.pairs)) * cfg.cap
    if engine.cfg.search.k > p_width:
        raise ValueError(
            f"k ({engine.cfg.search.k}) cannot exceed the bucketed probe "
            f"width (P*cap = {p_width})"
        )
    if bidx is None:
        bidx = BucketedIndex.build(engine.index.shingle_windows, cfg, engine.cfg.shingle,
                                   device=engine.device)
    elif bidx.ns_valid != engine.index.num_shingles:
        raise ValueError(
            f"bucketed index covers {bidx.ns_valid} shingles; engine "
            f"index has {engine.index.num_shingles} — rebuild it"
        )
    else:
        bidx = bidx.to(engine.device)
    if not cfg.hybrid and bidx.overflow_frac > 0.05:
        raise ValueError(
            f"bucketed index has {bidx.overflow_frac:.0%} of entries in "
            f"over-cap buckets (cap={cfg.cap}); this corpus's word-pair "
            f"distribution is too skewed for the pure bucketed "
            f"prefilter — enable the hybrid (BucketedConfig.hybrid), "
            f"use the exact kernel (drop --bucketed), or raise cap/"
            f"load_factor"
        )
    if bidx.overflow_frac > 0.05:
        log.warning(
            "bucketed index has %.0f%% of entries in over-cap buckets "
            "(cap=%d): the word-pair distribution is skewed, so a large "
            "query fraction will reroute through the exact kernel "
            "(hybrid fallback) — expect near-exact-kernel wall-clock",
            100 * bidx.overflow_frac, cfg.cap,
        )
    return bidx


def attach_bucketed_prefilter(engine, cfg: BucketedConfig,
                              bidx: BucketedIndex | None = None) -> None:
    """Swap a SearchEngine's candidate stage for the bucketed one: K1
    embed -> the flat path, or the hybrid where the index has over-cap
    buckets and ``cfg.hybrid`` is on.  The rest of the fused step stays.
    ``bidx`` may be a prebuilt index (``search/persist.py``'s
    ``load_bucketed``); it must cover the engine's index."""
    from fandom_search_tpu_torch.ops.embed import embed_shingles

    bidx = validate_and_place_bucketed(engine, cfg, bidx)
    engine.bucketed = bidx
    scfg, xcfg = engine.cfg.shingle, engine.cfg.search
    dix = engine._dix
    hybrid = cfg.hybrid and bidx.overflow_frac > 0.0
    kw = dict(entries=bidx.entries, offsets=bidx.offsets, s_emb=dix.s_emb, n=scfg.n,
              cap=cfg.cap, num_buckets=bidx.num_buckets, salts=bidx.salts, k=xcfg.k,
              dim=scfg.dim, threshold=xcfg.candidate_threshold, pairs_mode=cfg.pairs)
    if hybrid:
        kw["ns_valid"] = dix.s_emb.shape[0]

    def stage_parts(stream, *, max_out, risk_budget=None):
        """The candidate stage's parts on ``stream`` as this engine runs
        them (``_stage_parts``), for timing each alone."""
        q_emb = embed_shingles(stream, dix.mults)
        return _stage_parts(stream, q_emb, max_out=max_out, risk_budget=risk_budget, **kw)

    engine.bucketed_stage_parts = stage_parts
    if not hybrid:
        # no bucket overflows cap (or the hybrid is off): no query is
        # ever rerouted, and the flat path alone gives the same triples
        engine._bucketed_risk_budget = None

        def candidates(stream, *, max_out):
            q_emb = embed_shingles(stream, dix.mults)
            return bucketed_candidates_flat(stream, q_emb, max_out=max_out, **kw)
    else:
        # sticky, pow2-grown by the engine's retry like its other budgets
        engine._bucketed_risk_budget = max(1024, engine._bucketed_risk_budget or 0)

        def candidates(stream, *, max_out, risk_budget):
            # bucketed_hybrid's parts, stage 1 timed; while tracing, the
            # at-risk rows go to the fused step for the k2_rows_needed count
            trace = engine._trace
            q_emb = embed_shingles(stream, dix.mults)
            parts = _stage_parts(stream, q_emb, max_out=max_out, risk_budget=risk_budget,
                                 stage=lambda: trace.device("stage.bucket", "d_bucket_stage"),
                                 **kw)
            rows, count = parts["risk_rows"][1]
            return (*parts["merge"][1], count) + ((rows,) if trace.on else ())

    engine._candidates_fn = candidates
    engine._k2_on_stream = False
    # uploads go raw, as on the JAX engine's two-stage prefilter flow
    engine._venc = None


def _next_qpow2(n: int, floor: int) -> int:
    """Smallest quarter-pow2 (2^k * {1, 1.25, 1.5, 1.75}) >= max(n,
    floor): overshoot <= 25% at <= 4 sizes an octave."""
    n = max(int(n), int(floor), 1)
    p = 1
    while p < n:
        p *= 2
    if p == n or p < 8:
        return p
    base = p // 2
    for num in (5, 6, 7):
        q = base * num // 4
        if q >= n:
            return q
    return p
