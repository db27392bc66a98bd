"""The bucketed prefilter sharded over the works axis; counterpart of fandom_search_tpu/parallel/sharded_bucketed.py.

The bucketed stage's natural parallel axis is the queries: a query's
work is O(P * cap) whatever the index size, and the bucket tables are
small next to the embeddings.  So, as in the JAX package:

  * the query token stream -> split over the ``works`` axis, each slice
    with its (n - 1)-token halo (``ShardedSearchEngine.works_slices``);
  * bucket tables and script embeddings -> one copy on each works row's
    device;
  * each slice's flat candidate triples -> moved to the stream's device
    in works order and compacted into one triple set;
  * the hybrid's at-risk masks -> gathered the same way, their rows
    compacted into the engine's sticky risk budget and rescued by K2 on
    the stream's device against the whole script, then merged.

The hybrid takes the single-device port's form (``ops/bucketed.py``
``bucketed_hybrid``), not the JAX package's deferred host resolve: K2
runs on all ``risk_budget`` rows inside the fused step, the at-risk
count rides the step's output, and the engine reruns a batch whose count
is over the budget.  On a works x script mesh the script-axis devices
of a row take no part: the tables are index-side and already
sub-linear.
"""

from __future__ import annotations

import torch

from fandom_search_tpu_torch.config import BucketedConfig
from fandom_search_tpu_torch.ops.bucketed import (
    BucketedIndex,
    _stage_parts,
    exact_on_risk_rows,
    merge_triples,
    validate_and_place_bucketed,
)
from fandom_search_tpu_torch.ops.embed import embed_shingles
from fandom_search_tpu_torch.ops.scan import nonzero_compact
from fandom_search_tpu_torch.parallel.sharded import _cat, _on, _to


def attach_bucketed_prefilter_sharded(engine, cfg: BucketedConfig,
                                      bidx: BucketedIndex | None = None) -> None:
    """Swap a ShardedSearchEngine's candidate stage for the query-sharded
    bucketed one: the same checks, contract and budgets as
    ``ops.bucketed.attach_bucketed_prefilter``."""
    bidx = validate_and_place_bucketed(engine, cfg, bidx)
    engine.bucketed = bidx
    scfg, xcfg = engine.cfg.shingle, engine.cfg.search
    dix = engine._dix
    hybrid = cfg.hybrid and bidx.overflow_frac > 0.0
    kw = dict(n=scfg.n, cap=cfg.cap, num_buckets=bidx.num_buckets, salts=bidx.salts,
              k=xcfg.k, dim=scfg.dim, threshold=xcfg.candidate_threshold,
              pairs_mode=cfg.pairs)
    # each works row's copy of the tables, the script and the multipliers
    rows = []
    for row in engine.mesh.devices:
        dev = row[0]
        rows.append((dev, bidx.to(dev), _to(dix.s_emb, dev), _to(dix.mults, dev)))

    def candidates(stream, *, max_out, risk_budget=None):
        main = stream.device
        qp, si, sc, ct, risk, q_parts = [], [], [], [], [], []
        for i, (stream_l, (dev, b, s_emb, mults)) in enumerate(
                zip(engine.works_slices(stream), rows)):
            with _on(dev):
                q_l = embed_shingles(stream_l, mults)
                parts = _stage_parts(stream_l, q_l, b.entries, b.offsets, s_emb,
                                     max_out=max_out, drop_risk=hybrid, **kw)
                q, s_, c, cnt = parts["compaction"][1]
                qp.append(_to(torch.where(q >= 0, q + i * q_l.shape[0], -1), main))
                si.append(_to(s_, main))
                sc.append(_to(c, main))
                ct.append(_to(cnt.reshape(1), main))
                if hybrid:
                    risk.append(_to(parts["geometry"][1][2], main))
                    q_parts.append(_to(q_l, main))
        # the shards' triples in works order, compacted into one set
        all_ct = _cat(ct)
        iota = torch.arange(max_out, dtype=torch.int32, device=main)
        pos = nonzero_compact((iota[None, :] < all_ct[:, None]).reshape(-1), max_out)
        safe = pos.clamp(min=0).long()
        valid = pos >= 0
        flat = (torch.where(valid, _cat(qp)[safe], -1), torch.where(valid, _cat(si)[safe], 0),
                _cat(sc)[safe], all_ct.sum(dtype=torch.int32))
        if not hybrid:
            return flat
        at_risk = _cat(risk)
        risk_rows = nonzero_compact(at_risk, risk_budget)
        exact = exact_on_risk_rows(
            _cat(q_parts), risk_rows, dix.s_emb, dix.s_emb.shape[0], k=xcfg.k,
            dim=scfg.dim, threshold=xcfg.candidate_threshold, max_out=max_out)
        return (*merge_triples(*flat, *exact, max_out=max_out),
                at_risk.sum(dtype=torch.int32))

    # sticky, pow2-grown by the engine's retry like its other budgets
    engine._bucketed_risk_budget = (
        max(1024, engine._bucketed_risk_budget or 0) if hybrid else None)
    engine._candidates_fn = candidates
    # uploads go raw, as on the JAX engine's two-stage prefilter flow
    engine._venc = None
