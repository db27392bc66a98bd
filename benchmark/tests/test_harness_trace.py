"""The traced run's counts: the K2 and K6 rows each call needs, and a
listed metric that reads nothing."""

import json

import pytest

from benchmark.harness import cells, runner, system, world
from benchmark.harness import trace as tr
from conftest import TINY_CELL, add_tiny_cell


@pytest.mark.parametrize("prefilter", [None, "bucketed"])
def test_k2_rows_are_the_rows_the_algorithm_needs(tmp_path, prefilter):
    """Exact path: each batch's work shingles, not its padded stream.
    Hybrid: the valid at-risk rows, not the sticky budget's -1 rows."""
    bench_json = add_tiny_cell(tmp_path, prefilter=prefilter)
    if prefilter:
        # buckets of 2 overflow on the tiny script, so the hybrid reruns K2
        cfg_path = tmp_path / "benchmark" / "configs" / "tiny.json"
        cfg = json.loads(cfg_path.read_text())
        cfg["pipeline"]["bucketed"]["cap"] = 2
        cfg_path.write_text(json.dumps(cfg))
    cell = cells.load_cell(TINY_CELL, bench_json)
    vocab, script, ranks = world.make_script_world(23, cell.config["script"])
    pool = world.make_pool(23, vocab, script, ranks, cell.traffic)
    with tr.Spans() as spans:
        engine = system.build_engine(script.text, cell.config, "cpu", {})
        engine.search_works(world.call_works(pool, 0))          # grows the budgets
        spans.k2_rows.clear()
        _, st = engine.search_works(world.call_works(pool, 1))
        rows, _ = spans.counts()
    assert rows and all(r >= 0 for r in rows)
    if prefilter is None:
        assert sum(rows) == st.num_query_shingles
    else:
        # the engine's at-risk count takes in the padding past the works
        at_risk = engine._bucketed_risk_queries
        assert 0 < sum(rows) <= at_risk and sum(rows) < st.num_query_shingles


def test_k6_rows_are_the_rows_the_algorithm_needs(tmp_path):
    """LSH: each batch's work shingles on its first K6 call, not its
    padded stream; a rerun after a budget overflow needs no more rows."""
    bench_json = add_tiny_cell(tmp_path, prefilter="lsh")
    cell = cells.load_cell(TINY_CELL, bench_json)
    vocab, script, ranks = world.make_script_world(29, cell.config["script"])
    pool = world.make_pool(29, vocab, script, ranks, cell.traffic)
    with tr.Spans() as spans:
        engine = system.build_engine(script.text, cell.config, "cpu", {})
        engine._cand_budget = 1                 # the first batch overflows it and reruns
        _, st = engine.search_works(world.call_works(pool, 1))
        rows, (k2_rows, _) = spans.k6_rows, spans.counts()
    reruns = len(rows) - st.num_batches
    assert reruns >= 1 and rows.count(0) == reruns and not k2_rows
    assert sum(rows) == st.num_query_shingles > 0


def test_k6_span_keeps_the_launch_counter(monkeypatch):
    """The CUDA route of ``hamming_topk`` counts its launches on its
    module name, which is the span's wrapper while ``Spans`` is in."""
    from fandom_search_tpu_torch.ops import lsh

    def cuda_route(*a, **kw):
        lsh.hamming_topk.launches += 1
        return "out"

    cuda_route.launches = 5
    monkeypatch.setattr(lsh, "hamming_topk", cuda_route)
    with tr.Spans() as spans:
        assert lsh.hamming_topk(None, None, 0, 1, 32) == "out"
        assert lsh.hamming_topk is not cuda_route and spans.k6_rows == [0]
    assert lsh.hamming_topk is cuda_route and cuda_route.launches == 6


def test_listed_metric_that_reads_nothing_fails(tiny_bench):
    (tiny_bench.parent / "benchmark" / "metrics" / "nothing.sweep.py").write_text(
        '"""nothing.sweep: finds nothing.\n\nlayer: test\n"""\n\n\n'
        "def read(ctx):\n    return None\n")
    spec = json.loads(tiny_bench.read_text())
    spec["per_layer"].append({"name": "nothing.sweep", "unit": "%", "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "search_words_per_s", "workloads": [TINY_CELL]})
    tiny_bench.write_text(json.dumps(spec))
    with pytest.raises(RuntimeError, match="nothing.sweep"):
        runner.run(TINY_CELL, 31, 0.1, True, device="cpu", bench_json=tiny_bench)
