"""The search engine; counterpart of fandom_search_tpu/search/engine.py.

``SearchEngine.search_works`` tokenizes and packs works on the host
exactly as the JAX engine does, then runs ONE ``fused_step`` per batch
on ``device``: the candidate stage -> dedup sort -> verify windows ->
length sort -> Smith-Waterman (K4 or K5) -> compaction of the verified
hits.  The candidate stage is ``exact_candidates`` (K1 embed -> K2
distance top-k -> threshold compaction; every compaction is one K3
launch) unless a prefilter swaps in its own: ``ops.lsh.attach_lsh_prefilter``
(K1 -> K6 -> rerank -> the same compaction) or
``ops.bucketed.attach_bucketed_prefilter`` (K1 -> bucket probe -> exact
dots of the pairs found -> K3 compactions; its hybrid adds K2 on the
queries that probe an over-cap bucket).  The host pulls one f32
[5, verify_budget] array per batch, retries a batch whose fixed budgets
overflowed, and chains the hits into MatchRows.  Inside the device step
nothing syncs with the host: no nonzero, no boolean-mask indexing, no
.item().

With ``stream_compress`` the exact path uploads a batch as u16 vocab
ids plus a patch list (``search/vocab_stream.py``), and
``_decode_stream`` rebuilds the u32 stream on the device before the
step, bit for bit.  ``parallel/sharded.py`` runs the same step over a
works x script grid of devices.
"""

from __future__ import annotations

import functools
import logging
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, NamedTuple, Tuple

import numpy as np
import torch

from fandom_search_tpu_torch.config import PipelineConfig, SearchConfig, ShingleConfig
from fandom_search_tpu_torch.data.fast_tokenizer import fast_tokenize, get_lib
from fandom_search_tpu_torch.data.hashing import derive_sign_mults
from fandom_search_tpu_torch.data.tokenizer import Tokenized
from fandom_search_tpu_torch.ops.distance_topk import topk_dot
from fandom_search_tpu_torch.ops.embed import embed_shingles
from fandom_search_tpu_torch.ops.scan import nonzero_compact
from fandom_search_tpu_torch.ops.smith_waterman import sw_normalized
from fandom_search_tpu_torch.search.chain import chain_hits_arrays
from fandom_search_tpu_torch.search.index import ScriptIndex, index_from_numpy
from fandom_search_tpu_torch.search.types import MatchRow
from fandom_search_tpu_torch.search.vocab_stream import StreamVocab
from fandom_search_tpu_torch.utils.profiling import Tracer, tracing

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


# Threads that tokenize a search's works ahead of the caller, which
# tokenizes too.  More add no speed on an 8-core H100 host: the wrapper
# around the GIL-free native scan holds the interpreter lock, so wider
# pools only slowed the caller's packing and submits (PERF.md section 6).
TOKENIZE_HELPERS = 2


def tokenize_tasks(raw: Dict[str, str], batch_queries: int, threads: int) -> List[List[str]]:
    """The raw works' ids in sorted order, cut into runs of consecutive
    works: a run closes at the work that brings its text to
    ``batch_queries // threads`` characters.  A token takes at least one
    character, so a batch of ``batch_queries`` tokens spans ``threads``
    runs or more, one for each thread that tokenizes."""
    budget = max(1, batch_queries // threads)
    tasks: List[List[str]] = []
    run: List[str] = []
    size = 0
    for w in sorted(raw):
        run.append(w)
        size += len(raw[w])
        if size >= budget:
            tasks.append(run)
            run, size = [], 0
    if run:
        tasks.append(run)
    return tasks


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


class EncodedBatch(NamedTuple):
    """A batch's compressed upload (``SearchEngine._encode_payload``).

    ``c_ext`` is uint32 [ceil(t_pad / 2) | p_pad | p_pad | 2 * nspans]:
    the u16 vocab ids packed little-endian two a word, the patch
    positions (pad slots hold t_pad), the patch hashes, the span table.
    ``misses`` is the batch's count of out-of-table tokens."""

    c_ext: np.ndarray
    t_pad: int
    p_pad: int
    misses: int


def _decode_stream(c_ext: torch.Tensor, table: torch.Tensor, *, t_pad: int,
                   p_pad: int, nspans: int) -> torch.Tensor:
    """The int32 [t_pad + 2 * nspans] stream_ext of a compressed upload
    (``EncodedBatch.c_ext`` as int32), with ``table`` the int32 [65536]
    vocab table: unpack the u16 ids, gather the table, scatter the
    patches and re-append the span table.  Bit-exact: every id either
    hits the entry holding its hash or is overwritten by its patch.

    The high id is masked after the shift, which is arithmetic on int32.
    Pad patches target slot t_pad of a t_pad + 1 buffer, which is cut
    (the JAX scatter drops them; here an index past the end would be a
    device-side assert).  An odd t_pad packs a zero id into the last
    half-word, which the cut to t_pad drops."""
    h = (t_pad + 1) // 2
    v = c_ext[:h]
    ids = torch.stack([v & 0xFFFF, (v >> 16) & 0xFFFF], dim=1).reshape(-1)[:t_pad]
    toks = torch.empty((t_pad + 1,), dtype=torch.int32, device=c_ext.device)
    toks[:t_pad] = table[ids.long()]
    toks.scatter_(0, c_ext[h : h + p_pad].long(), c_ext[h + p_pad : h + 2 * p_pad])
    return torch.cat([toks[:t_pad], c_ext[h + 2 * p_pad : h + 2 * p_pad + 2 * nspans]])


def _f32(x: float) -> float:
    """``x`` rounded to float32, so comparing an f32 tensor with it
    matches the JAX package's f32 comparison whatever precision torch
    computes it in.  (A scalar, not a device tensor: creating one would
    cost a host-to-device copy that waits for the stream.)"""
    return float(np.float32(x))


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


def exact_candidates(stream: torch.Tensor, dix: DeviceIndex, *,
                     search_cfg: SearchConfig, max_out: int):
    """K1 embed -> K2 top-k -> threshold compaction: the exact candidate
    stage, as ``compact_candidates`` returns it."""
    threshold = search_cfg.candidate_threshold
    ns = dix.s_emb.shape[0]
    q_emb = embed_shingles(stream, dix.mults)
    vals, idx = topk_dot(q_emb, dix.s_emb, ns, search_cfg.k, min_keep=threshold)
    return compact_candidates(vals, idx, threshold, ns, search_cfg.k, max_out)


def fused_step(stream_ext: torch.Tensor, dix: DeviceIndex, *,
               shingle_cfg: ShingleConfig, search_cfg: SearchConfig,
               cand_budget: int, verify_budget: int,
               nspans: int, candidates_fn=None, sw_fn=sw_normalized) -> torch.Tensor:
    """One batch on the device: candidates -> dedup -> windows -> SW.

    ``stream_ext`` is int32 [T_pad + 2*nspans]: the token stream, then
    the span starts, then the span lengths (uint32 bit patterns).
    ``candidates_fn(stream, max_out=...)`` returns what
    ``compact_candidates`` returns, and may add a fifth element, the
    bucketed hybrid's at-risk query count, and a sixth, its at-risk rows
    (given while tracing, for the ``k2_rows_needed`` count); it defaults
    to ``exact_candidates``.  ``sw_fn`` scores the verify batch
    (``sw_normalized``'s signature; the sharded engine splits it over
    its works devices).  Returns f32 [5, verify_budget], the layout of
    the JAX engine's ``_fused_impl``: rows 0-3 are (qpos, line, score,
    verify_score) of the verified hits; row 4 holds (candidates,
    deduped, verified) in its first three slots, the at-risk count,
    where there is one, in the fourth, and where the at-risk rows are
    given, in the fifth, how many of them start a shingle inside one work.
    """
    n, dim = shingle_cfg.n, shingle_cfg.dim
    t_pad = stream_ext.shape[0] - 2 * nspans
    stream = stream_ext[:t_pad]
    sp_start = stream_ext[t_pad : t_pad + nspans]
    sp_len = stream_ext[t_pad + nspans :]
    if candidates_fn is None:
        candidates_fn = functools.partial(
            exact_candidates, dix=dix, search_cfg=search_cfg
        )
    qpos, sidx, score, cand_count, *risk = candidates_fn(stream, max_out=cand_budget)
    return fused_tail(
        stream, sp_start, sp_len, qpos, sidx, score, cand_count, dix,
        n=n, dim=dim, search_cfg=search_cfg, verify_budget=verify_budget,
        nspans=nspans, risk_count=risk[0] if risk else None,
        risk_rows=risk[1] if len(risk) > 1 else None, sw_fn=sw_fn,
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


def verify_pairs(stream, script_stream, starts_a, len_a, starts_b, len_b,
                 search_cfg: SearchConfig, sw_fn=sw_normalized) -> torch.Tensor:
    """Smith-Waterman scores of the windows stream[starts_a : +len_a]
    against script_stream[starts_b : +len_b], in input order.

    The pairs are length-sorted first, so pairs of similar length sit
    side by side (K4's threads of a warp stop at similar bounds); the
    scatter restores the order.  Pairs score independently, so the sort
    changes no score."""
    w, mlt = search_cfg.window_tokens, search_cfg.max_line_tokens
    dev = stream.device
    perm = torch.sort(-(len_a + len_b), stable=True).indices
    offs = torch.arange(w, device=dev)[None, :]
    a = stream[(starts_a[perm].long()[:, None] + offs).clamp(0, stream.shape[0] - 1)]
    offs_b = torch.arange(mlt, device=dev)[None, :]
    b = script_stream[
        (starts_b[perm].long()[:, None] + offs_b).clamp(0, script_stream.shape[0] - 1)
    ]
    vscore_p = sw_fn(a, b, len_a[perm].int(), len_b[perm].int(), search_cfg)
    vscore = torch.zeros((perm.shape[0],), dtype=torch.float32, device=dev)
    vscore.scatter_(0, perm, vscore_p)
    return vscore


def _packable(t_pad: int, n_lines: int, width: int) -> bool:
    """Whether the dedup keys fit one int64 (always, at default configs)."""
    return t_pad < (1 << 21) and n_lines * width < (1 << 30)


def fused_tail(stream, sp_start, sp_len, qpos, sidx, score, cand_count,
               dix: DeviceIndex, *, n: int, dim: int,
               search_cfg: SearchConfig, verify_budget: int,
               nspans: int, risk_count=None, risk_rows=None,
               sw_fn=sw_normalized) -> torch.Tensor:
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

    vscore = verify_pairs(stream, dix.script_stream, starts_a, len_a,
                          starts_b, len_b, search_cfg, sw_fn)

    # ---- final compact: only verified hits leave the device -----------
    keep = uvalid & (vscore >= _f32(search_cfg.verify_threshold))
    ver_count = keep.sum(dtype=torch.int32)
    vpos = nonzero_compact(keep, verify_budget)
    vsafe = vpos.clamp(min=0).long()
    counts = torch.zeros((verify_budget,), dtype=torch.float32, device=dev)
    counts[:3] = torch.stack([cand_count, uniq_count, ver_count]).float()
    if risk_count is not None:
        counts[3] = risk_count.float()
    if risk_rows is not None:
        # the at-risk rows (-1: none) that start a shingle inside one work
        i = (torch.searchsorted(sp_start, risk_rows, right=True) - 1).clamp(0, nspans - 1)
        st = sp_start[i]
        counts[4] = ((risk_rows >= st) & (risk_rows <= st + sp_len[i] - n)).sum().float()
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
        # The candidate stage of fused_step; a prefilter swaps it
        # (ops/lsh.py attach_lsh_prefilter, ops/bucketed.py
        # attach_bucketed_prefilter).
        self._candidates_fn = functools.partial(
            exact_candidates, dix=self._dix, search_cfg=xcfg
        )
        # the verify batch's scorer (the sharded engine splits it)
        self._sw_fn = sw_normalized
        # u16 stream compression (search/vocab_stream.py): batch 1 goes
        # raw and frequency-seeds the table.  Only the exact candidate
        # stage takes encoded uploads, as in the JAX engine, whose
        # prefilters drop to its raw two-stage flow: attaching one sets
        # _venc to None.
        self._venc = StreamVocab() if xcfg.stream_compress else None
        self._vtab_dev = None
        self._vtab_ver = -1
        self.table_uploads = 0
        # The bucketed hybrid's sticky at-risk row budget (None: no
        # hybrid attached; its candidate stage then takes no
        # risk_budget) and its per-search counts of at-risk and all
        # query positions, counted per device step as the JAX engine
        # counts them.
        self._bucketed_risk_budget = None
        self._bucketed_risk_queries = 0
        self._bucketed_total_queries = 0
        # Whether the candidate stage runs K2 on every stream row (the
        # exact stage; a prefilter clears it), for the K2 row counters.
        self._k2_on_stream = True
        # The timers and counters of the search in progress; outside a
        # search they go to a throwaway EngineStats.
        self._trace = Tracer(EngineStats(), self.device)

    @classmethod
    def from_index(cls, index, cfg: PipelineConfig, *, device="cuda"):
        """Engine over an index built elsewhere (e.g. by the JAX package):
        its NumPy arrays are carried across and put on ``device``."""
        return cls(index_from_numpy(index), cfg, device=device)

    # -- batching ----------------------------------------------------------

    def _batches(
        self, items: Iterable[Tuple[str, Tokenized]]
    ) -> Iterable[Tuple[np.ndarray | EncodedBatch, int, List[Tuple[str, int, int]], int]]:
        """Pack works into bucketed token streams.

        ``items`` yields (work_id, Tokenized) in sorted order.  Yields
        (payload, nspans, spans, fresh) where payload is ext uint32
        [T_bucket + 2*nspans] or, with stream compression, its
        ``EncodedBatch``; spans is [(work_id, stream_offset, num_tokens)]
        and fresh is the number of not-previously-counted query shingles.
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
        """One batch's upload, built once: the raw buffer uint32 [stream
        tokens (t_pad) | span starts (nspans) | span lens (nspans)], or
        its ``EncodedBatch`` (``_encode_payload``).  Unused span slots
        hold a large sentinel start (keeps the searchsorted monotone)
        and zero length."""
        with self._trace.host("host.pack", "s_pack"):
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
            return self._encode_payload(ext, off, t_pad, nspans), nspans, spans, fresh_total

    def _encode_payload(self, ext, valid: int, t_pad: int, nspans: int):
        """``ext`` itself, or its ``EncodedBatch`` when the vocab encoder
        is warm and the batch's out-of-table tokens fit the patch budget
        p_pad = max(4096, t_pad >> stream_patch_shift).  The first batch
        bootstraps the table and goes raw; a batch over the budget goes
        raw and its frequencies are admitted; an encoded batch's misses
        are admitted for later batches (it carries its own patches)."""
        venc = self._venc
        if venc is None:
            return ext
        stream = ext[:t_pad]
        if not venc.ready:
            venc.bootstrap(stream[:valid])
            return ext
        p_pad = max(4096, t_pad >> self.cfg.search.stream_patch_shift)
        ids, mpos, mhash, total = venc.encode(stream, miss_cap=p_pad)
        if total > p_pad:
            venc.admit_counted(stream[:valid])
            return ext
        venc.admit(mhash)
        h = (t_pad + 1) // 2
        if t_pad % 2:
            ids = np.concatenate([ids, np.zeros(1, np.uint16)])
        c_ext = np.empty((h + 2 * p_pad + 2 * nspans,), np.uint32)
        c_ext[:h] = ids.view(np.uint32)
        c_ext[h : h + p_pad] = t_pad
        c_ext[h : h + mpos.size] = mpos
        c_ext[h + p_pad : h + 2 * p_pad] = 0
        c_ext[h + p_pad : h + p_pad + mhash.size] = mhash
        c_ext[h + 2 * p_pad :] = ext[t_pad:]
        return EncodedBatch(c_ext, t_pad, p_pad, int(total))

    def _vocab_table_dev(self) -> torch.Tensor:
        """The vocab table on the device (int32 [65536], 256 KB), uploaded
        again only when the table grew since the last upload."""
        if self._vtab_dev is None or self._vtab_ver != self._venc.version:
            self._vtab_dev = self._upload(self._venc.table())
            self._vtab_ver = self._venc.version
            self.table_uploads += 1
        return self._vtab_dev

    def _device_ext(self, payload, nspans: int) -> torch.Tensor:
        """A batch's int32 stream_ext on the device: the raw buffer
        uploaded, or an encoded one uploaded and decoded there."""
        if isinstance(payload, EncodedBatch):
            return _decode_stream(
                self._upload(payload.c_ext), self._vocab_table_dev(),
                t_pad=payload.t_pad, p_pad=payload.p_pad, nspans=nspans,
            )
        return self._upload(payload)

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
        self._bucketed_risk_queries = self._bucketed_total_queries = 0
        if self.index.num_shingles == 0:
            return [], stats

        # stage timers (the host span of each in brackets): s_batchgen =
        # batch generation [host.batchgen], in it s_tokenize_wait = the
        # wait on the tokenizer threads [host.tokenize_wait] and s_pack =
        # packing [host.pack]; s_pull = the wait for a batch's result
        # [host.pull]; s_host = host post-processing [host.post] and
        # chaining [host.chain]
        for key in ("s_batchgen", "s_tokenize_wait", "s_pack", "s_pull", "s_host"):
            stats.extra[key] = 0.0
        self._trace = Tracer(stats, self.device, on=tracing())
        try:
            rows = self._search(raw, tokenized, stats)
        finally:
            self._trace = Tracer(EngineStats(), self.device)
        if self._bucketed_total_queries:
            stats.extra["bucketed_risk_frac"] = (
                self._bucketed_risk_queries / self._bucketed_total_queries
            )
        return rows, stats

    def _search(self, raw, tokenized, stats: EngineStats) -> List[MatchRow]:
        scfg, xcfg = self.cfg.shingle, self.cfg.search
        trace = self._trace
        items = self._work_stream(raw, tokenized)
        acc = _HitAccumulator(tokenized)
        pending: List[Tuple] = []
        # Batch N+1 is submitted before batch N is pulled: kernel
        # launches are asynchronous, so the device runs ahead while the
        # host packs and post-processes.
        lookahead = max(1, xcfg.lookahead_batches)
        gen = self._batches(items)
        while True:
            with trace.host("host.batchgen", "s_batchgen"):
                nxt = next(gen, None)
            if nxt is None:
                break
            payload, nspans, spans, fresh = nxt
            stats.num_batches += 1
            stats.num_query_shingles += fresh
            pending.append(self._submit_fused(payload, nspans, spans, stats))
            if len(pending) > lookahead:
                self._process_fused(*pending.pop(0), stats, acc)
        while pending:
            self._process_fused(*pending.pop(0), stats, acc)
        trace.resolve(wait=True)

        with trace.host("host.chain", ("s_host", "seconds_host")):
            widx, fpos, line, sc, vs = acc.finalize()
            return chain_hits_arrays(
                widx, fpos, line, sc, vs, acc.work_ids, tokenized,
                self.index, scfg, xcfg,
            )

    def _work_stream(
        self, raw: Dict[str, str], tokenized: Dict[str, Tokenized],
    ) -> Iterable[Tuple[str, Tokenized]]:
        """All works in sorted id order; raw text tokenizes in that order
        and lands in ``tokenized``, each work yielded as soon as it and
        every raw work before it are done, so the first batch waits only
        for its own works."""
        import heapq

        pre = iter(sorted(tokenized.items()))
        if not raw:
            yield from pre
            return
        yield from heapq.merge(pre, self._tokenized_in_order(raw, tokenized))

    def _tokenized_in_order(
        self, raw: Dict[str, str], tokenized: Dict[str, Tokenized],
    ) -> Iterable[Tuple[str, Tokenized]]:
        """The raw works tokenized, in sorted id order, in runs of
        ``tokenize_tasks``.

        Every run but the first goes at once, in order, to a pool of
        ``TOKENIZE_HELPERS`` threads, whose FIFO queue keeps them on the
        earliest runs not yet started.  The caller tokenizes the first
        run, and each later run no helper has started (it cancels the
        run's future), rather than wait for it.  A run the caller
        tokenizes or waits for counts in ``tokenize_waits`` and is
        spanned by ``host.tokenize_wait``."""
        from concurrent.futures import ThreadPoolExecutor

        tasks = tokenize_tasks(raw, self.cfg.search.batch_queries, TOKENIZE_HELPERS + 1)
        trace = self._trace

        def run(ids):
            return [fast_tokenize(raw[w]) for w in ids]

        def landed(ids, fut):
            # the run tokenized here (fut None) or by its helper
            if fut is not None and fut.done():
                toks = fut.result()
            else:
                trace.add("tokenize_waits", 1)
                with trace.host("host.tokenize_wait", "s_tokenize_wait"):
                    toks = run(ids) if fut is None else fut.result()
            for w, tk in zip(ids, toks):
                tokenized[w] = tk
                yield w, tk

        # the Python tokenizer holds the interpreter lock throughout, and
        # a single run (a served request's work) needs no helper
        helpers = min(TOKENIZE_HELPERS, len(tasks) - 1) if get_lib() is not None else 0
        if not helpers:
            for ids in tasks:
                yield from landed(ids, None)
            return
        ex = ThreadPoolExecutor(max_workers=helpers)
        try:
            futures = [None] + [ex.submit(run, ids) for ids in tasks[1:]]
            for ids, fut in zip(tasks, futures):
                yield from landed(ids, None if fut is None or fut.cancel() else fut)
        finally:
            ex.shutdown(cancel_futures=True)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A uint32 or int32 host array on the device as int32.  From
        pinned memory the copy is asynchronous; from pageable memory it
        would wait for the previous batch."""
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- fused batch path ----------------------------------------------------

    def _fused_call(self, ext_dev, nspans, cand_budget, verify_budget,
                    risk_budget=None):
        """One fused step; ``risk_budget`` (default: the sticky one) goes
        to a bucketed hybrid's candidate stage."""
        fn = self._candidates_fn
        if self._bucketed_risk_budget is not None:
            risk_budget = risk_budget or self._bucketed_risk_budget
            fn = functools.partial(fn, risk_budget=risk_budget)
            self._trace.add("k2_rows_launched", risk_budget)
        elif self._k2_on_stream:
            self._trace.add("k2_rows_launched", max(
                0, ext_dev.shape[0] - 2 * nspans - self.cfg.shingle.n + 1))
        return fused_step(
            ext_dev, self._dix,
            shingle_cfg=self.cfg.shingle, search_cfg=self.cfg.search,
            cand_budget=cand_budget, verify_budget=verify_budget,
            nspans=nspans, candidates_fn=fn, sw_fn=self._sw_fn,
        )

    def _submit_fused(self, payload, nspans, spans, stats: EngineStats):
        with self._trace.host("host.submit", "seconds_device_topk"):
            ext_dev = self._device_ext(payload, nspans)
            budgets = (self._cand_budget, self._verify_budget,
                       self._bucketed_risk_budget)
            out = self._fused_call(ext_dev, nspans, *budgets)
        return (ext_dev, spans, nspans, *budgets, out)

    def _process_fused(
        self, ext_dev, spans, nspans, cand_budget, verify_budget,
        risk_budget, out, stats: EngineStats, acc: _HitAccumulator,
    ) -> None:
        scfg, xcfg = self.cfg.shingle, self.cfg.search
        trace = self._trace
        with trace.host("host.pull_post", "seconds_host"):
            first = True
            while True:
                with trace.host("host.pull", "s_pull"):
                    host = out.cpu().numpy()  # ONE pull per batch
                trace.resolve()
                if first:
                    first = False
                    self._count_k2_needed(spans, risk_budget, host)
                cand_count = int(host[4, 0])
                uniq_count = int(host[4, 1])
                if risk_budget is not None:
                    # the hybrid's triples hold every at-risk query only when
                    # they fit its risk budget; the other counts wait for that
                    risk_count = int(host[4, 3])
                    if risk_count > risk_budget:
                        risk_budget = _next_pow2(risk_count, risk_budget * 2)
                        self._bucketed_risk_budget = max(
                            self._bucketed_risk_budget, risk_budget
                        )
                        log.info(
                            "at-risk rows exceeded (%d); retrying batch with "
                            "risk budget %d", risk_count, risk_budget,
                        )
                        out = self._fused_call(
                            ext_dev, nspans, cand_budget, verify_budget, risk_budget
                        )
                        continue
                    self._bucketed_risk_queries += risk_count
                    self._bucketed_total_queries += max(
                        0, ext_dev.shape[0] - 2 * nspans - scfg.n + 1
                    )
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
                out = self._fused_call(
                    ext_dev, nspans, cand_budget, verify_budget, risk_budget
                )
            with trace.host("host.post", "s_host"):
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

    def _count_k2_needed(self, spans, risk_budget, host) -> None:
        """Add a batch's ``k2_rows_needed`` once, at its first pull: on the
        exact stage its work shingles, on the hybrid (while tracing) the
        at-risk rows of its first launch that start a shingle inside one
        work, counted on the device.  A rerun needs no more rows."""
        if risk_budget is None and self._k2_on_stream:
            n = self.cfg.shingle.n
            self._trace.add("k2_rows_needed", sum(max(0, m - n + 1) for _, _, m in spans))
        elif risk_budget is not None and self._trace.on:
            self._trace.add("k2_rows_needed", int(host[4, 4]))
