"""The port's works-sharded bucketed prefilter against the JAX package.

Tolerance: 0.  MatchRows compare field by field (rounded scores
included) with JAX's ``attach_bucketed_prefilter_sharded`` on its 8
virtual CPU devices (``use_pallas=False``), with the single-device exact
engines of both packages, and, on the dry-run world of
``__graft_entry__.py``'s ``dryrun_multichip``, with the JAX oracle.
The worlds are those of tests/test_sharded_bucketed.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fandom_search_tpu.config import BucketedConfig as JBucketedConfig
from fandom_search_tpu.config import MeshConfig as JMeshConfig
from fandom_search_tpu.config import PipelineConfig
from fandom_search_tpu.data.script_parser import parse_script
from fandom_search_tpu.parallel.sharded import ShardedSearchEngine as JShardedEngine
from fandom_search_tpu.parallel.sharded_bucketed import (
    attach_bucketed_prefilter_sharded as jattach,
)
from fandom_search_tpu.search.engine import SearchEngine as JaxEngine
from fandom_search_tpu.search.index import build_script_index
from fandom_search_tpu.search.oracle import search_works_oracle as joracle
from fandom_search_tpu.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)
from fandom_search_tpu_torch.config import BucketedConfig, MeshConfig
from fandom_search_tpu_torch.config import PipelineConfig as PortConfig
from fandom_search_tpu_torch.parallel.sharded import ShardedSearchEngine
from fandom_search_tpu_torch.parallel.sharded_bucketed import (
    attach_bucketed_prefilter_sharded,
)
from fandom_search_tpu_torch.search.engine import SearchEngine
from tests.test_bucketed import _skewed_world


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(works_ax, script_ax):
    """(JAX config, port config): the mesh, works_ax * 512 queries a batch."""
    j = PipelineConfig(mesh=JMeshConfig(works=works_ax, script=script_ax))
    p = PortConfig(mesh=MeshConfig(works=works_ax, script=script_ax))
    return (dataclasses.replace(j, search=dataclasses.replace(j.search,
                                                              batch_queries=works_ax * 512)),
            dataclasses.replace(p, search=dataclasses.replace(p.search,
                                                              batch_queries=works_ax * 512)))


def _rows(rows):
    return [r.to_csv_row() for r in rows]


def _both(index, works, works_ax, script_ax):
    """Rows and engines of the port's and JAX's sharded bucketed attach."""
    jcfg, pcfg = _cfgs(works_ax, script_ax)
    eng = ShardedSearchEngine.from_index(index, pcfg, device="cpu")
    attach_bucketed_prefilter_sharded(eng, BucketedConfig())
    jeng = JShardedEngine(index, jcfg, use_pallas=False)
    jattach(jeng, JBucketedConfig())
    rows, stats = eng.search_works(works)
    jrows, jstats = jeng.search_works(works)
    return (rows, stats, eng), (jrows, jstats, jeng)


@pytest.fixture(scope="module")
def uniform_world():
    rng = np.random.default_rng(91)
    vocab = make_vocab(rng, 1000)
    lines = parse_script(make_script(rng, vocab, num_lines=18, words_per_line=(7, 12)))
    works, planted = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=10, words_per_work=220,
        quotes_per_work=2, vocab=vocab,
    )
    index = build_script_index(lines, PipelineConfig().shingle, PipelineConfig().search)
    _, pcfg = _cfgs(1, 1)
    exact, _ = SearchEngine.from_index(index, pcfg, device="cpu").search_works(works)
    return index, works, planted, _rows(exact)


@pytest.mark.parametrize("works_ax,script_ax", [(4, 2), (8, 1), (2, 4)])
def test_sharded_bucketed_pure_matches_jax_and_exact(uniform_world, works_ax, script_ax):
    """No bucket overflows cap: the pure query-sharded flat path."""
    index, works, planted, exact = uniform_world
    (rows, _, eng), (jrows, _, jeng) = _both(index, works, works_ax, script_ax)
    assert eng.bucketed.overflow_frac == jeng.bucketed.overflow_frac == 0.0
    assert eng._bucketed_risk_budget is None
    assert rows and _rows(rows) == _rows(jrows) == exact
    found = {(r.work_id, r.line_no) for r in rows}
    assert all((p.work_id, p.line_no) in found for p in planted)


@pytest.fixture(scope="module")
def skewed_world():
    """tests/test_bucketed.py's skewed world (seed 42) and the rows of
    both packages' single-device exact engines, which are equal."""
    _, index, works = _skewed_world(np.random.default_rng(42))
    jcfg, pcfg = _cfgs(1, 1)
    want, _ = JaxEngine(index, jcfg, use_pallas=False).search_works(works)
    exact, _ = SearchEngine.from_index(index, pcfg, device="cpu").search_works(works)
    assert exact and _rows(exact) == _rows(want)
    return index, works, _rows(exact)


def test_sharded_bucketed_hybrid_rescues_skew(skewed_world):
    """A stopword-led script: hot buckets overflow, at-risk queries go to
    K2 on the stream's device, and the rows equal the single-device exact
    engine's and JAX's sharded hybrid's, at-risk counts included."""
    index, works, exact = skewed_world
    (rows, stats, eng), (jrows, jstats, jeng) = _both(index, works, 4, 2)
    assert eng.bucketed.overflow_frac == jeng.bucketed.overflow_frac > 0.05
    assert _rows(rows) == _rows(jrows) == exact
    assert 0 < eng._bucketed_risk_queries == jeng._bucketed_risk_queries
    assert eng._bucketed_total_queries == jeng._bucketed_total_queries
    assert stats.extra["bucketed_risk_frac"] == jstats.extra["bucketed_risk_frac"]


def test_sharded_bucketed_hybrid_reruns_over_budget(skewed_world):
    """A risk budget below the batch's at-risk count: the engine reruns
    the batch with a grown, sticky budget and the rows stay equal."""
    index, works, exact = skewed_world
    _, pcfg = _cfgs(2, 4)
    eng = ShardedSearchEngine.from_index(index, pcfg, device="cpu")
    attach_bucketed_prefilter_sharded(eng, BucketedConfig())
    eng._bucketed_risk_budget = 8
    rows, _ = eng.search_works(works)
    assert eng._bucketed_risk_budget > 8 and _rows(rows) == exact


def dryrun_world():
    """``dryrun_multichip``'s world at 8 devices (mesh 2 x 4): seed 7, 15
    uniform and 15 stopword-led lines, 40 works and one work longer than
    the batch cap (the split-chunk path)."""
    works_ax = 2
    rng = np.random.default_rng(7)
    vocab = make_vocab(rng, 500)
    uniform_txt = make_script(rng, vocab, num_lines=15)
    skew_txt = "\n".join(
        "ALICE: of the of the " + " ".join(rng.choice(vocab, size=6).tolist())
        for _ in range(15)
    )
    lines = parse_script(uniform_txt + "\n" + skew_txt)
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=40, words_per_work=150,
        quotes_per_work=3, vocab=vocab,
    )
    long_w, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=1,
        words_per_work=works_ax * 512 + 700, quotes_per_work=6, vocab=vocab,
    )
    works["workzlong"] = long_w["work00000"]
    return lines, works


def test_dryrun_world_mesh_2x4_matches_oracles():
    """Both mesh paths of the dry run, the fused sharded engine and the
    sharded bucketed hybrid, give the JAX oracle's rows, and the hybrid
    reroutes at-risk queries."""
    lines, works = dryrun_world()
    jcfg, pcfg = _cfgs(2, 4)
    index = build_script_index(lines, jcfg.shingle, jcfg.search)
    orows, _ = joracle(works, index, jcfg)
    assert len(orows) >= 100
    fused = ShardedSearchEngine.from_index(index, pcfg, device="cpu")
    rows, stats = fused.search_works(works)
    assert _rows(rows) == _rows(orows) and stats.num_verified > 0
    assert any("\x00" in wid for wid, _, _ in _spans(fused, works))
    hyb = ShardedSearchEngine.from_index(index, pcfg, device="cpu")
    attach_bucketed_prefilter_sharded(hyb, BucketedConfig())
    rows2, _ = hyb.search_works(works)
    assert hyb.bucketed.overflow_frac > 0.0 and hyb._bucketed_risk_queries > 0
    assert _rows(rows2) == _rows(orows)


def _spans(engine, works):
    from fandom_search_tpu_torch.data.fast_tokenizer import tokenize_many

    items = sorted(tokenize_many(works).items())
    return [s for _, _, spans, _ in engine._batches(items) for s in spans]
