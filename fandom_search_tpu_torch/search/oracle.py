"""NumPy golden search pipeline; counterpart of fandom_search_tpu/search/oracle.py."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from fandom_search_tpu.config import PipelineConfig
from fandom_search_tpu_torch.data.tokenizer import Tokenized, tokenize
from fandom_search_tpu_torch.data.shingler import embed_shingles_np
from fandom_search_tpu_torch.search.chain import chain_hits
from fandom_search_tpu_torch.search.common import line_segment, verify_window
from fandom_search_tpu_torch.search.index import ScriptIndex
from fandom_search_tpu_torch.search.types import CandidateHit, MatchRow
from fandom_search_tpu_torch.search.verify_np import sw_normalized_np


@dataclass
class OracleStats:
    num_query_shingles: int = 0
    num_candidates: int = 0
    num_verified: int = 0
    seconds_topk: float = 0.0
    seconds_verify: float = 0.0
    per_stage: Dict[str, float] = field(default_factory=dict)


def topk_scores_np(
    query_emb: np.ndarray,   # int8 [NQ, dim]
    index_emb: np.ndarray,   # int8 [NS, dim]
    k: int,
    dim: int,
    block: int = 4096,
    index_t: np.ndarray | None = None,  # f32 [dim, NS] — precomputed .T
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact per-query top-k of dot/dim scores. Returns (vals, idx).

    Blocked over queries so the full [NQ, NS] matrix never materializes
    (mirrors the device kernel's tiling).  Ties broken by lower index,
    matching the device kernel's merge rule.
    """
    nq, ns = query_emb.shape[0], index_emb.shape[0]
    k_eff = min(k, ns)
    vals = np.full((nq, k), -np.inf, dtype=np.float32)
    idxs = np.zeros((nq, k), dtype=np.int32)
    if ns == 0 or nq == 0:
        return vals, idxs
    # f32 matmul runs on BLAS and is exact here: |dot| <= n^2 * dim
    # (4608 at defaults) is far below f32's 2^24 integer range.
    # Callers looping over many query batches pass index_t once
    # (the conversion is ~50MB of work per call on a large index).
    st = (
        index_t if index_t is not None
        else index_emb.astype(np.float32).T
    )
    for q0 in range(0, nq, block):
        q1 = min(nq, q0 + block)
        b = q1 - q0
        scores_f = (query_emb[q0:q1].astype(np.float32) @ st) / dim  # [b, NS]
        # argpartition alone picks an ARBITRARY subset among values tied
        # at the k-th boundary; the device kernel (K2) resolves such
        # ties to the lowest index.  Use the
        # partition only to find the k-th value, then select exactly:
        # every index strictly above it, plus the lowest-index ties
        # (rank computed sparsely — boundary ties are few per row).
        part = np.argpartition(-scores_f, k_eff - 1, axis=1)[:, :k_eff]
        vk = np.take_along_axis(scores_f, part, axis=1).min(axis=1)  # [b]
        gt = scores_f > vk[:, None]
        need = k_eff - gt.sum(axis=1)                                # [b]
        rows_eq, cols_eq = np.nonzero(scores_f == vk[:, None])
        first_of_row = np.searchsorted(rows_eq, np.arange(b))
        rank = np.arange(len(rows_eq)) - first_of_row[rows_eq]
        keep = rank < need[rows_eq]
        gt[rows_eq[keep], cols_eq[keep]] = True
        rows_sel, cols_sel = np.nonzero(gt)  # k_eff per row, idx-asc
        part = cols_sel.reshape(b, k_eff)
        pv = np.take_along_axis(scores_f, part, axis=1)
        order = np.lexsort((part, -pv), axis=1)
        vals[q0:q1, :k_eff] = np.take_along_axis(pv, order, axis=1)
        idxs[q0:q1, :k_eff] = np.take_along_axis(part, order, axis=1).astype(
            np.int32
        )
    return vals, idxs


def search_works_oracle(
    works: Dict[str, str] | Dict[str, Tokenized],
    index: ScriptIndex,
    cfg: PipelineConfig,
) -> Tuple[List[MatchRow], OracleStats]:
    """Full oracle search of {work_id: text-or-Tokenized} against a script."""
    stats = OracleStats()
    scfg, xcfg = cfg.shingle, cfg.search
    tokenized: Dict[str, Tokenized] = {
        wid: (t if isinstance(t, Tokenized) else tokenize(t))
        for wid, t in works.items()
    }

    hits: List[CandidateHit] = []
    index_t = index.embeddings.astype(np.float32).T  # once, not per work
    for wid, tk in sorted(tokenized.items()):
        nq = max(0, len(tk) - scfg.n + 1)
        if nq == 0 or index.num_shingles == 0:
            continue
        stats.num_query_shingles += nq
        emb = embed_shingles_np(tk.hashes, scfg)

        t0 = time.perf_counter()
        vals, idxs = topk_scores_np(
            emb, index.embeddings, xcfg.k, scfg.dim, index_t=index_t
        )
        stats.seconds_topk += time.perf_counter() - t0

        t0 = time.perf_counter()
        cand = np.nonzero(vals >= xcfg.candidate_threshold)
        # Dedup (fan_pos, line) pairs: several top-k script shingles can
        # attribute to the same line.  Keep the max-score candidate's
        # script-shingle index (first strictly-greater wins, matching
        # the engine's stable-lexsort dedup) — it anchors the line-side
        # verify segment for long lines.
        seen: Dict[Tuple[int, int], Tuple[float, int]] = {}
        for qi, kj in zip(*cand):
            sidx = int(idxs[qi, kj])
            line = int(index.shingle_line[sidx])
            key = (int(qi), line)
            s = float(vals[qi, kj])
            if key not in seen or s > seen[key][0]:
                seen[key] = (s, sidx)
        stats.num_candidates += len(seen)

        for (fan_pos, line), (score, sidx) in seen.items():
            a0, a1 = verify_window(fan_pos, len(tk), scfg, xcfg)
            a = tk.hashes[a0:a1]
            anchor = int(index.shingle_anchor[sidx])
            llen = int(index.line_lengths[line])
            b0, blen = line_segment(anchor, llen, scfg, xcfg)
            gstart = int(index.line_start[line]) + int(b0)
            b = index.stream_hashes[gstart : gstart + int(blen)]
            v = sw_normalized_np(a, b, xcfg)
            if v >= xcfg.verify_threshold:
                stats.num_verified += 1
                hits.append(CandidateHit(wid, int(fan_pos), line, score, v))
        stats.seconds_verify += time.perf_counter() - t0

    rows = chain_hits(hits, tokenized, index, scfg, xcfg)
    return rows, stats
