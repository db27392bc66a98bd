"""The search engine's fused batch path; counterpart of fandom_search_tpu/search/engine.py.

``SearchEngine.search_works`` tokenizes and packs works on the host
exactly as the JAX engine does, then runs ONE ``fused_step`` per batch
on ``device``: K1 embed -> K2 distance top-k -> threshold compaction
(K3 scan) -> dedup sort -> verify windows -> length sort -> K4
Smith-Waterman -> compaction of the verified hits.  The host pulls one
f32 [5, verify_budget] array per batch, retries a batch whose fixed
budgets overflowed, and chains the hits into MatchRows.  Inside a batch
nothing syncs with the host: no nonzero, no boolean-mask indexing, no
.item().
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from fandom_search_tpu.config import PipelineConfig, SearchConfig, ShingleConfig
from fandom_search_tpu_torch.data.fast_tokenizer import tokenize_many
from fandom_search_tpu_torch.data.hashing import derive_sign_mults
from fandom_search_tpu_torch.data.tokenizer import Tokenized
from fandom_search_tpu_torch.ops.distance_topk import topk_dot
from fandom_search_tpu_torch.ops.embed import embed_shingles
from fandom_search_tpu_torch.ops.scan import scan1d_i32
from fandom_search_tpu_torch.ops.smith_waterman import sw_normalized
from fandom_search_tpu_torch.search.chain import chain_hits_arrays
from fandom_search_tpu_torch.search.index import ScriptIndex, index_from_numpy
from fandom_search_tpu_torch.search.types import MatchRow

log = logging.getLogger(__name__)


@dataclass
class EngineStats:
    num_works: int = 0
    num_query_shingles: int = 0
    num_candidates: int = 0
    num_verified: int = 0
    num_batches: int = 0
    seconds_device_topk: float = 0.0
    seconds_host: float = 0.0
    extra: Dict[str, float] = field(default_factory=dict)

    @property
    def shingle_pairs(self) -> int:
        """Query-shingle x script-shingle pairs scored."""
        return self.num_query_shingles * int(self.extra.get("ns", 0))


def _next_pow2(n: int, floor: int) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; a CUDA device must exist — there is
    no silent CPU fallback (``cpu`` is the explicit way to run the
    plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class _HitAccumulator:
    """Verified hits as struct-of-arrays, accumulated across batches."""

    def __init__(self, tokenized: Dict[str, Tokenized] | None = None):
        self.work_ids: List[str] = []
        self._map: Dict[str, int] = {}
        self._parts: List[Tuple[np.ndarray, ...]] = []
        # full-work token counts for the split-chunk window filter; the
        # engine MUTATES this dict as tokenization streams in, so an
        # initially-empty dict must not be replaced
        self._tokenized = tokenized if tokenized is not None else {}

    def span_tables(self, spans):
        """(work_idx, fold_offset, is_split, work_len) per span.

        Split-chunk span ids ("wid\\x00offset") fold back to the work
        here; work_len is the FULL work's token count for split spans.
        """
        m = len(spans)
        widx = np.empty(m, np.int64)
        fold = np.zeros(m, np.int64)
        split = np.zeros(m, bool)
        wlen = np.zeros(m, np.int64)
        for j, (wid, _, _) in enumerate(spans):
            if "\x00" in wid:
                wid, off = wid.split("\x00")
                fold[j] = int(off)
                split[j] = True
                wlen[j] = len(self._tokenized[wid])
            ix = self._map.get(wid)
            if ix is None:
                ix = len(self.work_ids)
                self._map[wid] = ix
                self.work_ids.append(wid)
            widx[j] = ix
        return widx, fold, split, wlen

    @staticmethod
    def split_window_ok(local, span_of, fold, split, wlen, span_len,
                        window: int, lead: int):
        """Keep-mask for split-chunk hits: the chunk must fully contain
        the oracle's verification window for the shingle (centered in
        the FULL work), so exactly one chunk verifies each shingle and
        its score is bit-identical to the oracle's."""
        o = fold[span_of]
        L = span_len[span_of]
        W = wlen[span_of]
        g = local + o
        a0w = np.clip(g - lead, 0, np.maximum(0, W - window))
        ok = (a0w >= o) & (a0w + window <= o + L)
        return np.where(split[span_of], ok, True)

    def add(self, widx, fpos, line, score, vscore, split):
        self._parts.append((widx, fpos, line, score, vscore, split))

    def finalize(self):
        """Concatenate, dedup split-chunk duplicates (max verify score,
        first arrival on ties), return arrays."""
        if not self._parts:
            z = np.zeros(0, np.int64)
            return z, z, z, z.astype(np.float32), z.astype(np.float32)
        widx, fpos, line, sc, vs, split = (
            np.concatenate([p[i] for p in self._parts])
            for i in range(6)
        )
        if split.any():
            keep_plain = np.logical_not(split)
            sw, sf, sl = widx[split], fpos[split], line[split]
            ss, sv = sc[split], vs[split]
            arrival = np.arange(len(sw))
            order = np.lexsort((arrival, -sv, sl, sf, sw))
            sw, sf, sl, ss, sv = (
                sw[order], sf[order], sl[order], ss[order], sv[order]
            )
            first = np.ones(len(sw), bool)
            first[1:] = (
                (sw[1:] != sw[:-1]) | (sf[1:] != sf[:-1])
                | (sl[1:] != sl[:-1])
            )
            widx = np.concatenate([widx[keep_plain], sw[first]])
            fpos = np.concatenate([fpos[keep_plain], sf[first]])
            line = np.concatenate([line[keep_plain], sl[first]])
            sc = np.concatenate([sc[keep_plain], ss[first]])
            vs = np.concatenate([vs[keep_plain], sv[first]])
        return widx, fpos, line, sc, vs


@dataclass(frozen=True)
class DeviceIndex:
    """The script index's arrays on the device, as ``fused_step`` reads them."""

    s_emb: torch.Tensor           # int8 [NS, dim]
    mults: torch.Tensor           # int32 [n, dim] (uint32 bit patterns)
    script_stream: torch.Tensor   # int32 [max(1, T_script)]
    shingle_line: torch.Tensor    # int32 [max(1, NS)]
    shingle_anchor: torch.Tensor  # int32 [max(1, NS)]
    line_start: torch.Tensor      # int32 [max(1, L)]
    line_len: torch.Tensor        # int32 [max(1, L)]

    @classmethod
    def build(cls, index: ScriptIndex, scfg: ShingleConfig,
              device: torch.device) -> "DeviceIndex":
        def i32(x):
            a = np.asarray(x)
            a = a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)
            if a.shape[0] == 0:
                # the clip-gathers need one valid element
                a = np.zeros((1,), dtype=np.int32)
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        mults = derive_sign_mults(scfg.seed, scfg.n, scfg.dim).view(np.int32)
        return cls(
            s_emb=torch.from_numpy(
                np.ascontiguousarray(index.embeddings, dtype=np.int8)
            ).to(device),
            mults=torch.from_numpy(np.ascontiguousarray(mults)).to(device),
            script_stream=i32(index.stream_hashes),
            shingle_line=i32(index.shingle_line),
            shingle_anchor=i32(index.shingle_anchor),
            line_start=i32(index.line_start),
            line_len=i32(index.line_lengths),
        )


def _f32(x: float) -> float:
    """``x`` rounded to float32, so comparing an f32 tensor with it
    matches the JAX package's f32 comparison whatever precision torch
    computes it in.  (A scalar, not a device tensor: creating one would
    cost a host-to-device copy that waits for the stream.)"""
    return float(np.float32(x))


def nonzero_compact(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Ascending indices of True entries, -1 padded to ``size`` (entries
    past ``size`` drop; callers detect overflow from a separate count).
    K3's inclusive scan gives each selected entry its slot; a scatter
    into [size + N] sends every other entry to a distinct slot past
    ``size``, so destinations are unique and no sync is needed."""
    m = mask.reshape(-1)
    n = m.shape[0]
    csum = scan1d_i32(m.to(torch.int32))
    src = torch.arange(n, dtype=torch.int32, device=m.device)
    sel = m & (csum <= size)
    dest = torch.where(sel, csum - 1, size + src)
    out = torch.full((size + n,), -1, dtype=torch.int32, device=m.device)
    out.scatter_(0, dest.long(), src)
    return out[:size]


def compact_candidates(vals, idx, threshold: float, ns: int, k: int,
                       max_out: int):
    """Threshold-compact the [NQ, k] top-k on the device.

    Returns (qpos int32 [max_out] with -1 padding, script_idx int32,
    score f32, true_count int32 scalar tensor).  true_count can exceed
    max_out: the engine then reruns the batch with a larger budget.
    Rows are compacted first (rows with any hit <= true count), then the
    [row_budget, k] slots, which keeps the flat row-major order.
    """
    ok = (vals >= _f32(threshold)) & (idx < ns)             # [NQ, k]
    count = ok.sum(dtype=torch.int32)
    row_any = ok.any(dim=1)                                 # [NQ]
    row_budget = min(max_out, ok.shape[0])
    rows = nonzero_compact(row_any, row_budget)
    rsafe = rows.clamp(min=0).long()
    ok_r = ok[rsafe] & (rows >= 0)[:, None]                 # [RB, k]
    pos = nonzero_compact(ok_r, max_out)
    safe = pos.clamp(min=0).long()
    qpos = rsafe[safe // k].int()
    score = vals[rsafe].reshape(-1)[safe]
    sidx = idx[rsafe].reshape(-1)[safe]
    valid = pos >= 0
    return (
        torch.where(valid, qpos, -1),
        torch.where(valid, sidx, 0),
        score,
        count,
    )


def fused_step(stream_ext: torch.Tensor, dix: DeviceIndex, *,
               shingle_cfg: ShingleConfig, search_cfg: SearchConfig,
               cand_budget: int, verify_budget: int,
               nspans: int) -> torch.Tensor:
    """One batch on the device: candidates -> dedup -> windows -> SW.

    ``stream_ext`` is int32 [T_pad + 2*nspans]: the token stream, then
    the span starts, then the span lengths (uint32 bit patterns).
    Returns f32 [5, verify_budget], the layout of the JAX engine's
    ``_fused_impl``: rows 0-3 are (qpos, line, score, verify_score) of
    the verified hits; row 4 holds (candidates, deduped, verified) in
    its first three slots.
    """
    n, dim = shingle_cfg.n, shingle_cfg.dim
    k = search_cfg.k
    t_pad = stream_ext.shape[0] - 2 * nspans
    stream = stream_ext[:t_pad]
    sp_start = stream_ext[t_pad : t_pad + nspans]
    sp_len = stream_ext[t_pad + nspans :]
    ns = dix.s_emb.shape[0]

    # ---- candidates: K1 embed -> K2 top-k -> threshold compaction -----
    threshold = search_cfg.candidate_threshold
    q_emb = embed_shingles(stream, dix.mults)
    vals, idx = topk_dot(q_emb, dix.s_emb, ns, k, min_keep=threshold)
    qpos, sidx, score, cand_count = compact_candidates(
        vals, idx, threshold, ns, k, cand_budget
    )
    return fused_tail(
        stream, sp_start, sp_len, qpos, sidx, score, cand_count, dix,
        n=n, dim=dim, search_cfg=search_cfg, verify_budget=verify_budget,
        nspans=nspans,
    )


def _stable_sort_perm(keys) -> torch.Tensor:
    """Permutation sorting by ``keys`` (most significant first), stable:
    one stable sort per key, least significant first."""
    perm = None
    for key in reversed(keys):
        kk = key if perm is None else key[perm]
        order = torch.sort(kk, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def _packable(t_pad: int, n_lines: int, width: int) -> bool:
    """Whether the dedup keys fit one int64 (always, at default configs)."""
    return t_pad < (1 << 21) and n_lines * width < (1 << 30)


def fused_tail(stream, sp_start, sp_len, qpos, sidx, score, cand_count,
               dix: DeviceIndex, *, n: int, dim: int,
               search_cfg: SearchConfig, verify_budget: int,
               nspans: int) -> torch.Tensor:
    """Dedup -> windows -> verification -> verified-hit compaction."""
    dev = stream.device
    t_pad = stream.shape[0]
    n_lines = dix.line_start.shape[0]

    # ---- dedup per (qpos, line), max score, stable ties ---------------
    ok = qpos >= 0
    span_of = (
        torch.searchsorted(sp_start, qpos, right=True) - 1
    ).clamp(0, nspans - 1)
    st = sp_start[span_of]
    ln = sp_len[span_of]
    ok = ok & (qpos >= st) & (qpos <= st + ln - n)
    line = dix.shingle_line[sidx.clamp(0, dix.shingle_line.shape[0] - 1).long()]
    bad = (~ok).to(torch.int64)
    # |score * dim| <= n^2 * dim (embedding entries lie in [-n, n])
    smax = n * n * dim
    width = 1
    while width < 2 * smax + 2:
        width *= 2
    if _packable(t_pad, n_lines, width):
        # one stable sort on k1 * 2^30 + k2, where k1 = bad<<30 | qpos and
        # k2 = line * width + (smax - score*dim) < 2^30
        score_i = torch.where(ok, torch.round(score * dim).long(), 0)
        k1 = (bad << 30) | qpos.clamp(min=0).long()
        k2 = torch.where(ok, line.long(), 0) * width + (smax - score_i)
        key_s, perm = torch.sort((k1 << 30) + k2, stable=True)
        k1_s = key_s >> 30
        k2_s = key_s & ((1 << 30) - 1)
        bad_s = k1_s >> 30
        qpos_s = k1_s & ((1 << 30) - 1)
        line_s = k2_s // width
        score_s = (smax - k2_s % width).float() / dim
    else:
        perm = _stable_sort_perm([bad, qpos, line, -score])
        bad_s, qpos_s, line_s = bad[perm], qpos[perm].long(), line[perm].long()
        score_s = score[perm]
    sidx_s = sidx[perm]
    spanof_s = span_of[perm]
    first = (bad_s == 0) & torch.cat([
        torch.ones((1,), dtype=torch.bool, device=dev),
        (qpos_s[1:] != qpos_s[:-1]) | (line_s[1:] != line_s[:-1]),
    ])
    uniq_count = first.sum(dtype=torch.int32)
    upos = nonzero_compact(first, verify_budget)
    safe = upos.clamp(min=0).long()
    uvalid = upos >= 0
    q_u = qpos_s[safe]
    line_u = line_s[safe].clamp(0, n_lines - 1)
    sidx_u = sidx_s[safe].clamp(0, dix.shingle_anchor.shape[0] - 1).long()
    sc_u = score_s[safe]
    sp_u = spanof_s[safe]

    # ---- verification windows (fan side + line-side segment) ----------
    w = search_cfg.window_tokens
    lead = (w - n) // 2
    st_u = sp_start[sp_u].long()
    ln_u = sp_len[sp_u].long()
    local = q_u - st_u
    a0 = torch.minimum((local - lead).clamp(min=0), (ln_u - w).clamp(min=0))
    starts_a = st_u + a0
    len_a = torch.where(uvalid, (ln_u - a0).clamp(max=w), 0)
    mlt = search_cfg.max_line_tokens
    lead_b = (mlt - n) // 2
    anchor = dix.shingle_anchor[sidx_u].long()
    llen = dix.line_len[line_u].long()
    b0 = torch.minimum((anchor - lead_b).clamp(min=0), (llen - mlt).clamp(min=0))
    starts_b = dix.line_start[line_u].long() + b0
    len_b = (llen - b0).clamp(max=mlt)

    # ---- length-sort the verify batch ---------------------------------
    # pairs of similar length sit side by side, so the threads of a warp
    # in K4 stop at similar bounds; the scatter restores the order
    vb = starts_a.shape[0]
    perm_v = torch.sort(-(len_a + len_b), stable=True).indices
    offs = torch.arange(w, device=dev)[None, :]
    a = stream[(starts_a[perm_v][:, None] + offs).clamp(0, t_pad - 1)]
    offs_b = torch.arange(mlt, device=dev)[None, :]
    b = dix.script_stream[
        (starts_b[perm_v][:, None] + offs_b).clamp(
            0, dix.script_stream.shape[0] - 1
        )
    ]
    vscore_p = sw_normalized(
        a, b, len_a[perm_v].int(), len_b[perm_v].int(), search_cfg
    )
    vscore = torch.zeros((vb,), dtype=torch.float32, device=dev)
    vscore.scatter_(0, perm_v, vscore_p)

    # ---- final compact: only verified hits leave the device -----------
    keep = uvalid & (vscore >= _f32(search_cfg.verify_threshold))
    ver_count = keep.sum(dtype=torch.int32)
    vpos = nonzero_compact(keep, verify_budget)
    vsafe = vpos.clamp(min=0).long()
    counts = torch.zeros((verify_budget,), dtype=torch.float32, device=dev)
    counts[:3] = torch.stack([cand_count, uniq_count, ver_count]).float()
    return torch.stack([
        q_u[vsafe].float(),
        line_u[vsafe].float(),
        sc_u[vsafe],
        vscore[vsafe],
        counts,
    ])


class SearchEngine:
    """Index once, search many fanwork batches, on ``device``.

    ``device`` is "cuda" (or "cuda:N"), where every stage runs through
    the CUDA kernels, or "cpu", which runs their plain PyTorch versions.
    """

    def __init__(self, index: ScriptIndex, cfg: PipelineConfig, *,
                 device="cuda"):
        if cfg.search.stream_compress:
            raise NotImplementedError(
                "stream_compress (the u16 upload) is not ported yet"
            )
        self.index = index
        self.cfg = cfg
        self.device = resolve_device(device)
        xcfg = cfg.search
        self._dix = DeviceIndex.build(index, cfg.shingle, self.device)
        # Minimum stream-bucket size (see _batches).
        self._batch_granule = 1 << 14
        # Fixed-size budgets that grow (pow2, sticky) when a batch
        # overflows them; the batch is rerun, so nothing is dropped.
        self._cand_budget = xcfg.max_candidates_per_batch
        self._verify_budget = max(2048, xcfg.batch_queries // 64)

    @classmethod
    def from_index(cls, index, cfg: PipelineConfig, *, device="cuda"):
        """Engine over an index built elsewhere (e.g. by the JAX package):
        its NumPy arrays are carried across and put on ``device``."""
        return cls(index_from_numpy(index), cfg, device=device)

    # -- batching ----------------------------------------------------------

    def _batches(
        self, items: Iterable[Tuple[str, Tokenized]]
    ) -> Iterable[Tuple[np.ndarray, int, List[Tuple[str, int, int]], int]]:
        """Pack works into bucketed token streams.

        ``items`` yields (work_id, Tokenized) in sorted order.  Yields
        (ext uint32 [T_bucket + 2*nspans], nspans, spans, fresh) where
        spans is [(work_id, stream_offset, num_tokens)] and fresh is the
        number of not-previously-counted query shingles.
        """
        cap = self.cfg.search.batch_queries
        n = self.cfg.shingle.n
        # stream length is bucketed (granule * pow2, clamped to cap)
        g = min(self._batch_granule, cap)

        def t_pad_for(tokens: int) -> int:
            b = g
            while b < min(tokens, cap):
                b *= 2
            return min(b, cap) + n - 1

        cur: List[Tuple[str, Tokenized, int]] = []
        cur_len = 0
        for wid, tk in items:
            need = len(tk)
            if need == 0:
                continue
            if need > cap:
                # A work longer than a batch: overlapping chunks.  The
                # overlap of window_tokens-1 lets every shingle see its
                # full verification window inside at least one chunk.
                ov = min(
                    max(n - 1, self.cfg.search.window_tokens - 1), cap - 1
                )
                pos = 0
                while pos < need:
                    end = min(need, pos + cap)
                    piece = Tokenized(
                        text=tk.text,
                        offsets=tk.offsets[pos:end],
                        hashes=tk.hashes[pos:end],
                    )
                    fresh = (
                        end - pos - n + 1 if pos == 0
                        else end - pos - ov
                    )
                    yield self._flush(
                        [(f"{wid}\x00{pos}", piece, max(0, fresh))], t_pad_for
                    )
                    if end == need:
                        break
                    pos = end - ov
                continue
            if cur_len + need > cap and cur:
                yield self._flush(cur, t_pad_for)
                cur, cur_len = [], 0
            cur.append((wid, tk, need - n + 1))
            cur_len += need
        if cur:
            yield self._flush(cur, t_pad_for)

    def _flush(self, items, t_pad_for):
        """One batch's upload buffer, built once: uint32 [stream tokens
        (t_pad) | span starts (nspans) | span lens (nspans)].  Unused span
        slots hold a large sentinel start (keeps the searchsorted
        monotone) and zero length."""
        tokens = sum(len(tk) for _, tk, _ in items)
        t_pad = t_pad_for(tokens)
        nspans = _next_pow2(len(items), 512)
        ext = np.zeros((t_pad + 2 * nspans,), dtype=np.uint32)
        stream = ext[:t_pad]
        sp = ext[t_pad:]
        sp[:nspans] = 1 << 30
        spans = []
        off = 0
        fresh_total = 0
        for j, (wid, tk, fresh) in enumerate(items):
            m = len(tk)
            stream[off : off + m] = tk.hashes
            sp[j] = off
            sp[nspans + j] = m
            spans.append((wid, off, m))
            off += m
            fresh_total += max(0, fresh)
        return ext, nspans, spans, fresh_total

    # -- search ------------------------------------------------------------

    def search_works(
        self,
        works: Dict[str, str] | Dict[str, Tokenized],
    ) -> Tuple[List[MatchRow], EngineStats]:
        stats = EngineStats()
        scfg, xcfg = self.cfg.shingle, self.cfg.search
        raw = {w: t for w, t in works.items() if not isinstance(t, Tokenized)}
        tokenized: Dict[str, Tokenized] = {
            wid: t for wid, t in works.items() if isinstance(t, Tokenized)
        }
        stats.num_works = len(works)
        stats.extra["ns"] = float(self.index.num_shingles)
        if self.index.num_shingles == 0:
            return [], stats

        items = self._work_stream(raw, tokenized)
        acc = _HitAccumulator(tokenized)
        pending: List[Tuple] = []
        # Batch N+1 is submitted before batch N is pulled: kernel
        # launches are asynchronous, so the device runs ahead while the
        # host packs and post-processes.
        lookahead = max(1, xcfg.lookahead_batches)
        # stage timers: s_batchgen = tokenize + pack wait, s_pull = the
        # wait for a batch's result, s_host = host post-processing and
        # chaining
        for key in ("s_batchgen", "s_pull", "s_host"):
            stats.extra[key] = 0.0
        gen = self._batches(items)
        while True:
            t_g = time.perf_counter()
            nxt = next(gen, None)
            stats.extra["s_batchgen"] += time.perf_counter() - t_g
            if nxt is None:
                break
            ext, nspans, spans, fresh = nxt
            stats.num_batches += 1
            stats.num_query_shingles += fresh
            pending.append(self._submit_fused(ext, nspans, spans, stats))
            if len(pending) > lookahead:
                self._process_fused(*pending.pop(0), stats, acc)
        while pending:
            self._process_fused(*pending.pop(0), stats, acc)

        t0 = time.perf_counter()
        widx, fpos, line, sc, vs = acc.finalize()
        rows = chain_hits_arrays(
            widx, fpos, line, sc, vs, acc.work_ids, tokenized,
            self.index, scfg, xcfg,
        )
        stats.seconds_host += time.perf_counter() - t0
        stats.extra["s_host"] += time.perf_counter() - t0
        return rows, stats

    @staticmethod
    def _work_stream(
        raw: Dict[str, str], tokenized: Dict[str, Tokenized],
        chunk: int = 1024,
    ) -> Iterable[Tuple[str, Tokenized]]:
        """All works in sorted id order; raw text tokenizes on worker
        threads a few chunks ahead and lands in ``tokenized``."""
        import heapq

        pre = iter(sorted(tokenized.items()))
        if not raw:
            yield from pre
            return

        def tokenized_chunks():
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            ids = sorted(raw)
            spans = [ids[i : i + chunk] for i in range(0, len(ids), chunk)]
            # 3 chunks in flight on 2 workers; tokenize_many fans each
            # chunk over its own GIL-free thread pool
            with ThreadPoolExecutor(max_workers=2) as ex:
                pending = deque(
                    ex.submit(tokenize_many, {w: raw[w] for w in sp})
                    for sp in spans[:3]
                )
                nxt = 3
                while pending:
                    done = pending.popleft().result()
                    if nxt < len(spans):
                        pending.append(ex.submit(
                            tokenize_many,
                            {w: raw[w] for w in spans[nxt]},
                        ))
                        nxt += 1
                    tokenized.update(done)
                    yield from sorted(done.items())

        yield from heapq.merge(pre, tokenized_chunks())

    # -- fused batch path ----------------------------------------------------

    def _fused_call(self, ext_dev, nspans, cand_budget, verify_budget):
        return fused_step(
            ext_dev, self._dix,
            shingle_cfg=self.cfg.shingle, search_cfg=self.cfg.search,
            cand_budget=cand_budget, verify_budget=verify_budget,
            nspans=nspans,
        )

    def _submit_fused(self, ext, nspans, spans, stats: EngineStats):
        t0 = time.perf_counter()
        ext_t = torch.from_numpy(ext.view(np.int32))
        if self.device.type == "cuda":
            # from pinned memory the upload is asynchronous; from
            # pageable memory it would wait for the previous batch
            ext_dev = ext_t.pin_memory().to(self.device, non_blocking=True)
        else:
            ext_dev = ext_t
        out = self._fused_call(
            ext_dev, nspans, self._cand_budget, self._verify_budget
        )
        stats.seconds_device_topk += time.perf_counter() - t0
        return (ext_dev, spans, nspans, self._cand_budget,
                self._verify_budget, out)

    def _process_fused(
        self, ext_dev, spans, nspans, cand_budget, verify_budget, out,
        stats: EngineStats, acc: _HitAccumulator,
    ) -> None:
        scfg, xcfg = self.cfg.shingle, self.cfg.search
        t0 = time.perf_counter()
        while True:
            t_p = time.perf_counter()
            host = out.cpu().numpy()  # ONE pull per batch
            stats.extra["s_pull"] += time.perf_counter() - t_p
            cand_count = int(host[4, 0])
            uniq_count = int(host[4, 1])
            retry = False
            if cand_count > cand_budget:
                cand_budget = _next_pow2(cand_count, cand_budget * 2)
                self._cand_budget = max(self._cand_budget, cand_budget)
                retry = True
            if uniq_count > verify_budget:
                verify_budget = _next_pow2(uniq_count, verify_budget * 2)
                self._verify_budget = max(self._verify_budget, verify_budget)
                retry = True
            if not retry:
                break
            log.info(
                "budget exceeded (cand=%d uniq=%d); retrying batch with "
                "budgets %d/%d", cand_count, uniq_count,
                cand_budget, verify_budget,
            )
            out = self._fused_call(ext_dev, nspans, cand_budget, verify_budget)
        t_h = time.perf_counter()
        ver_count = int(host[4, 2])
        stats.num_candidates += uniq_count

        starts = np.array([off for _, off, _ in spans], dtype=np.int64)
        qpos = host[0, :ver_count].astype(np.int64)
        line = host[1, :ver_count].astype(np.int64)
        score = host[2, :ver_count]
        vscore = host[3, :ver_count]
        span_of = np.searchsorted(starts, qpos, side="right") - 1
        local = qpos - starts[span_of]
        span_widx, span_fold, span_split, span_wlen = acc.span_tables(spans)
        span_len = np.array([m for _, _, m in spans], dtype=np.int64)
        keep = acc.split_window_ok(
            local, span_of, span_fold, span_split, span_wlen, span_len,
            xcfg.window_tokens, (xcfg.window_tokens - scfg.n) // 2,
        )
        sp_k = span_of[keep]
        stats.num_verified += int(keep.sum())
        acc.add(
            span_widx[sp_k], local[keep] + span_fold[sp_k], line[keep],
            score[keep], vscore[keep], span_split[sp_k],
        )
        stats.extra["s_host"] += time.perf_counter() - t_h
        stats.seconds_host += time.perf_counter() - t0
