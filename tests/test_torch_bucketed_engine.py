"""The port's engine with the bucketed prefilter against the JAX package.

Tolerance: 0.  MatchRows compare field by field (rounded scores
included) between the port's engine and the JAX engine with
``attach_bucketed_prefilter``, and with the exact path; candidate
triples compare element by element up to their count.  The JAX side
runs with ``use_pallas=False`` (its jnp twins of the kernels), as its
CLI's ``--no-pallas``: the rows do not depend on it, and the Pallas
interpreter would take minutes here.  The worlds are those of
tests/test_bucketed.py.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fandom_search_tpu.config import BucketedConfig, PipelineConfig
from fandom_search_tpu.data.script_parser import parse_script
from fandom_search_tpu.ops.bucketed import attach_bucketed_prefilter as jax_attach
from fandom_search_tpu.search import persist as jpersist
from fandom_search_tpu.search.engine import SearchEngine as JaxEngine
from fandom_search_tpu.search.index import build_script_index
from fandom_search_tpu.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)
from fandom_search_tpu_torch.config import BucketedConfig as PortBucketedConfig
from fandom_search_tpu_torch.config import PipelineConfig as PortConfig
from fandom_search_tpu_torch.data.fast_tokenizer import tokenize_many
from fandom_search_tpu_torch.ops.bucketed import (
    BucketedIndex,
    attach_bucketed_prefilter,
)
from fandom_search_tpu_torch.search import persist
from fandom_search_tpu_torch.search.engine import SearchEngine

BATCH = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(rows):
    return [r.to_csv_row() for r in rows]


def _both(batch=BATCH):
    """(JAX config, port config) at ``batch`` query shingles a batch."""
    j, p = PipelineConfig(), PortConfig()
    return (dataclasses.replace(j, search=dataclasses.replace(j.search, batch_queries=batch)),
            dataclasses.replace(p, search=dataclasses.replace(p.search, batch_queries=batch)))


def _uniform_world():
    """tests/test_bucketed.py:146's world: no bucket overflows cap."""
    rng = np.random.default_rng(42)
    vocab = make_vocab(rng, 800)
    lines = parse_script(make_script(rng, vocab, num_lines=20))
    index = build_script_index(lines, PipelineConfig().shingle, PipelineConfig().search)
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=12, words_per_work=200,
        quotes_per_work=2, vocab=vocab,
    )
    return index, works


def _skewed_world(seed, num_lines=30, num_works=8, words_per_work=220):
    """tests/test_bucketed.py:297's world: every line leads with the same
    stopword run (hot pair-buckets overflow cap), then unique words."""
    rng = np.random.default_rng(seed)
    vocab = make_vocab(rng, 600)
    lines = parse_script("\n".join(
        "ALICE: of the of the " + " ".join(rng.choice(vocab, size=6).tolist())
        for _ in range(num_lines)
    ))
    index = build_script_index(lines, PipelineConfig().shingle, PipelineConfig().search)
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=num_works,
        words_per_work=words_per_work, quotes_per_work=2, vocab=vocab,
    )
    return index, works


@pytest.fixture(scope="module")
def worlds():
    return {"uniform": _uniform_world(), "skewed42": _skewed_world(42),
            "skewed7": _skewed_world(7)}


def _engines(index, bcfg=None, batch=BATCH):
    """(JAX engine, port engine on the CPU), both with the prefilter."""
    jcfg, pcfg = _both(batch)
    bcfg = bcfg or BucketedConfig()
    jeng = JaxEngine(index, jcfg, use_pallas=False)
    jax_attach(jeng, bcfg)
    eng = SearchEngine.from_index(index, pcfg, device="cpu")
    attach_bucketed_prefilter(eng, PortBucketedConfig(**dataclasses.asdict(bcfg)))
    return jeng, eng


@pytest.mark.parametrize("name,pairs", [
    ("uniform", "triangles"),    # the pure flat route: no bucket overflows
    ("skewed42", "triangles"),   # the hybrid: at-risk queries reroute to K2
    ("skewed7", "all"),
])
def test_bucketed_engine_rows_match_jax_and_exact(worlds, name, pairs):
    index, works = worlds[name]
    jeng, eng = _engines(index, BucketedConfig(pairs=pairs))
    assert eng.bucketed.ns_valid == index.num_shingles
    assert eng.bucketed.overflow_frac == jeng.bucketed.overflow_frac
    assert (eng._bucketed_risk_budget is None) == (name == "uniform")
    jrows, jstats = jeng.search_works(works)
    rows, stats = eng.search_works(works)
    assert rows and _rows(rows) == _rows(jrows)
    for f in ("num_works", "num_query_shingles", "num_candidates", "num_verified",
              "num_batches"):
        assert getattr(stats, f) == getattr(jstats, f), f
    assert stats.extra.get("bucketed_risk_frac") == jstats.extra.get("bucketed_risk_frac")
    if name != "uniform":
        assert eng.bucketed.overflow_frac > 0.05
        assert 0 < eng._bucketed_risk_queries <= eng._bucketed_total_queries
    # the official gate: the exact path's rows
    _, pcfg = _both()
    exact, _ = SearchEngine.from_index(index, pcfg, device="cpu").search_works(works)
    assert _rows(rows) == _rows(exact)
    if name == "skewed42":
        # a second search counts its own queries only
        again, stats2 = eng.search_works(works)
        assert _rows(again) == _rows(rows)
        assert stats2.extra["bucketed_risk_frac"] == stats.extra["bucketed_risk_frac"]


@pytest.mark.parametrize("name,max_out", [("uniform", 1 << 14), ("uniform", 8),
                                          ("skewed42", 1 << 14), ("skewed42", 8)])
def test_bucketed_candidate_stage_matches_jax(worlds, name, max_out):
    """The swapped-in candidate stage on one batch: (qpos, script row,
    score) up to the count, and the count, also when it overflows
    ``max_out`` and the engine must rerun the batch; the hybrid's fifth
    output is the at-risk count."""
    index, works = worlds[name]
    jeng, eng = _engines(index)
    (_, payload, _, _), *_ = list(jeng._batches(sorted(jeng._work_stream(dict(works), {}))))
    _, ext, t_pad, _ = payload
    out = jeng._candidates_fn(jnp.asarray(ext[:t_pad]), jeng._s_emb_padded,
                              jeng._ns_valid, jeng._mults, max_out=max_out)
    if hasattr(out, "resolve"):
        out = out.resolve()
    want = [np.asarray(x) for x in out]
    kw = {} if eng._bucketed_risk_budget is None else {
        "risk_budget": eng._bucketed_risk_budget}
    got = [x.numpy() for x in eng._candidates_fn(
        torch.from_numpy(ext[:t_pad].view(np.int32)), max_out=max_out, **kw)]
    c = int(want[3])
    assert int(got[3]) == c > 0 and (c > max_out) == (max_out == 8)
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == w.shape and np.array_equal(g[:c], w[:c])
    assert len(got) == (4 if name == "uniform" else 5)
    if name != "uniform":
        assert 0 < int(got[4]) <= eng._bucketed_risk_budget


@pytest.mark.parametrize("name", ["uniform", "skewed42"])
def test_stage_parts_are_the_candidate_stage(worlds, name):
    """``bucketed_stage_parts``, which the card script times part by
    part, runs the engine's own candidate stage: its last results are
    the stage's outputs, and each part rerun alone gives its result."""
    index, works = worlds[name]
    _, eng = _engines(index)
    items = sorted(tokenize_many(dict(sorted(works.items()))).items())
    ext, nspans, _, _ = next(iter(eng._batches(items)))
    tok = torch.from_numpy(ext[:ext.shape[0] - 2 * nspans].view(np.int32).copy())
    rb = eng._bucketed_risk_budget
    kw = {} if rb is None else {"risk_budget": rb}
    want = eng._candidates_fn(tok, max_out=1 << 14, **kw)
    parts = eng.bucketed_stage_parts(tok, max_out=1 << 14, **kw)
    names = ["geometry", "segment_stream", "gather_dot", "sort", "compaction"]
    if rb is None:
        got = parts["compaction"][1]
    else:
        names += ["risk_rows", "stage2", "merge"]
        got = (*parts["merge"][1], parts["risk_rows"][1][1])
    assert list(parts) == names
    assert len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))
    for part, result in parts.values():
        again = part()
        again = again if isinstance(again, tuple) else (again,)
        result = result if isinstance(result, tuple) else (result,)
        assert all(torch.equal(x, y) for x, y in zip(again, result))


def test_hybrid_risk_budget_retry_matches_jax():
    """Long stopword-only works: nearly every query shingle is at risk,
    far past the 1,024-row floor; the engine grows the sticky risk budget
    (pow2), reruns the batch, and its rows and risk fraction stay the JAX
    engine's (whose rows its own test holds to the exact path's)."""
    index, works = _skewed_world(42, num_lines=20, num_works=2, words_per_work=1200)
    works = {w: "of the " * 600 + t for w, t in works.items()}
    jeng, eng = _engines(index, batch=8192)
    assert eng._bucketed_risk_budget == 1024
    rows, stats = eng.search_works(works)
    assert eng._bucketed_risk_budget > 1024
    jrows, jstats = jeng.search_works(works)
    assert rows and _rows(rows) == _rows(jrows)
    assert stats.extra["bucketed_risk_frac"] == jstats.extra["bucketed_risk_frac"] > 0.25


def test_attach_refusals(worlds):
    """The pure mode refuses a skewed index, a prebuilt index must cover
    the engine's rows, and k may not exceed the probe width."""
    index, _ = worlds["skewed42"]
    _, pcfg = _both()
    eng = SearchEngine.from_index(index, pcfg, device="cpu")
    with pytest.raises(ValueError, match="too skewed"):
        attach_bucketed_prefilter(eng, PortBucketedConfig(hybrid=False))
    good = BucketedIndex.build(index.shingle_windows, PortBucketedConfig(),
                               pcfg.shingle, device="cpu")
    with pytest.raises(ValueError, match="rebuild"):
        attach_bucketed_prefilter(eng, PortBucketedConfig(),
                                  bidx=dataclasses.replace(good, ns_valid=3))
    wide = dataclasses.replace(pcfg, search=dataclasses.replace(pcfg.search, k=49))
    with pytest.raises(ValueError, match="probe width"):
        attach_bucketed_prefilter(SearchEngine.from_index(index, wide, device="cpu"),
                                  PortBucketedConfig())
    attach_bucketed_prefilter(eng, PortBucketedConfig(), bidx=good)  # hybrid: no refusal
    assert eng.bucketed.builder == "native" and eng._bucketed_risk_budget == 1024


def test_save_load_bucketed(tmp_path, worlds):
    """The tables round-trip through ``bucketed_arrays.npz``; a config
    with other tables (pairs) warns and loads nothing; ``hybrid`` is not
    part of the identity."""
    index, _ = worlds["skewed7"]
    bcfg = PortBucketedConfig(pairs="all")
    bidx = BucketedIndex.build(index.shingle_windows, bcfg, PortConfig().shingle,
                               device="cpu")
    assert persist.load_bucketed(tmp_path, bcfg) is None
    persist.save_bucketed(tmp_path, bidx, bcfg)
    for cfg in (bcfg, dataclasses.replace(bcfg, hybrid=False)):
        got = persist.load_bucketed(tmp_path, cfg)
        assert torch.equal(got.entries, bidx.entries) and torch.equal(got.offsets, bidx.offsets)
        assert (got.num_buckets, got.salts, got.ns_valid, got.overflow_frac) == (
            bidx.num_buckets, bidx.salts, bidx.ns_valid, bidx.overflow_frac)
    assert persist.load_bucketed(tmp_path, PortBucketedConfig()) is None
    want = jpersist._bucketed_identity(BucketedConfig(pairs="all"))
    meta = json.loads((tmp_path / "bucketed_meta.json").read_text())
    assert meta["bucketed"] == want
