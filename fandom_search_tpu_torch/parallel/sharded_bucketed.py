"""The bucketed prefilter sharded over the works axis; counterpart of fandom_search_tpu/parallel/sharded_bucketed.py.

The bucketed stage's natural parallel axis is the queries: a query's
work is O(P * cap) whatever the index size, and the bucket tables are
small next to the embeddings.  So, as in the JAX package:

  * the query token stream -> split over the ``works`` axis, each slice
    with its (n - 1)-token halo (``ShardedSearchEngine.works_slices``);
  * bucket tables and script embeddings -> one copy on each works row's
    device;
  * each slice's flat candidate triples -> gathered on the stream's
    device in works order (``comm.gather``: copies in one process, an
    all_gather across ranks) and compacted into one triple set;
  * the hybrid's at-risk masks -> gathered the same way, their rows
    compacted into the engine's sticky risk budget and rescued by K2 on
    the stream's device against the whole script (the queries embedded
    there by K1, which every rank can do: it holds the whole stream),
    then merged.

The hybrid takes the single-device port's form (``ops/bucketed.py``
``bucketed_hybrid``), not the JAX package's deferred host resolve: K2
runs on all ``risk_budget`` rows inside the fused step, the at-risk
count rides the step's output, and the engine reruns a batch whose count
is over the budget.  On a works x script mesh the script-axis devices
of a row take no part: the tables are index-side and already
sub-linear.  Each works row's stage runs where its cell (i, 0) is
owned.
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
from fandom_search_tpu_torch.parallel.comm import _cat, _on, _to, gather


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
    mesh = engine.mesh
    works = mesh.shape["works"]
    # each owned works row's copy of the tables, the script and the multipliers
    rows = []
    for i, row in enumerate(mesh.devices):
        dev = row[0]
        rows.append((dev, bidx.to(dev), _to(dix.s_emb, dev), _to(dix.mults, dev))
                    if mesh.local(i, 0) else None)

    def candidates(stream, *, max_out, risk_budget=None):
        main = stream.device
        rows_l = (stream.shape[0] - scfg.n + 1) // works
        parts = {}
        for i, (stream_l, placed) in enumerate(zip(engine.works_slices(stream), rows)):
            if placed is None:
                continue
            dev, b, s_emb, mults = placed
            with _on(dev):
                q_l = embed_shingles(stream_l, mults)
                stage = _stage_parts(stream_l, q_l, b.entries, b.offsets, s_emb,
                                     max_out=max_out, drop_risk=hybrid, **kw)
                q, s_, c, cnt = stage["compaction"][1]
                parts[(i, 0)] = (torch.where(q >= 0, q + i * rows_l, -1), s_, c,
                                 cnt.reshape(1)) + (
                    (stage["geometry"][1][2],) if hybrid else ())
        spec = (((max_out,), torch.int32), ((max_out,), torch.int32),
                ((max_out,), torch.float32), ((1,), torch.int32)) + (
            (((rows_l,), torch.bool),) if hybrid else ())
        got = gather(mesh, [(i, 0) for i in range(works)], parts, spec, main)
        # the shards' triples in works order, compacted into one set
        all_ct = _cat([g[3] for g in got])
        iota = torch.arange(max_out, dtype=torch.int32, device=main)
        pos = nonzero_compact((iota[None, :] < all_ct[:, None]).reshape(-1), max_out)
        safe = pos.clamp(min=0).long()
        valid = pos >= 0
        flat = (torch.where(valid, _cat([g[0] for g in got])[safe], -1),
                torch.where(valid, _cat([g[1] for g in got])[safe], 0),
                _cat([g[2] for g in got])[safe], all_ct.sum(dtype=torch.int32))
        if not hybrid:
            return flat
        at_risk = _cat([g[4] for g in got])
        risk_rows = nonzero_compact(at_risk, risk_budget)
        exact = exact_on_risk_rows(
            embed_shingles(stream, dix.mults), risk_rows, dix.s_emb, dix.s_emb.shape[0],
            k=xcfg.k, dim=scfg.dim, threshold=xcfg.candidate_threshold, max_out=max_out)
        # while tracing, the at-risk rows go to the fused step for the
        # k2_rows_needed count
        return (*merge_triples(*flat, *exact, max_out=max_out),
                at_risk.sum(dtype=torch.int32)) + ((risk_rows,) if engine._trace.on else ())

    # sticky, pow2-grown by the engine's retry like its other budgets
    engine._bucketed_risk_budget = (
        max(1024, engine._bucketed_risk_budget or 0) if hybrid else None)
    engine._candidates_fn = candidates
    engine._k2_on_stream = False
    # uploads go raw, as on the JAX engine's two-stage prefilter flow
    engine._venc = None
