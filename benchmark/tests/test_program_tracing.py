"""The program's own spans and counters, as the per-layer metrics read
them: the engine's ``k2_rows_needed`` against the harness's count of the
same rows, and the readers of ``tokenize_idle_share``,
``pack_idle_share``, ``k2_pad_share`` and ``bucket_stage_device_share``."""

import json

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import cells, runner, system, world
from benchmark.harness import trace as tr
from conftest import ROOT, TINY_CELL, add_tiny_cell

NEW = ("tokenize_idle_share.sweep", "pack_idle_share.sweep", "k2_pad_share.sweep",
       "bucket_stage_device_share.sweep")


def _readers():
    return cells.metric_readers(list(NEW), ROOT / "benchmark")


def _hybrid_cell(tmp_path, cap=None):
    bench_json = add_tiny_cell(tmp_path, prefilter="bucketed")
    if cap:
        cfg_path = tmp_path / "benchmark" / "configs" / "tiny.json"
        cfg = json.loads(cfg_path.read_text())
        cfg["pipeline"]["bucketed"]["cap"] = cap
        cfg_path.write_text(json.dumps(cfg))
    return bench_json


@pytest.mark.parametrize("prefilter", [None, "bucketed"])
def test_program_counts_the_rows_the_harness_counts(tmp_path, prefilter):
    """A call's k2_rows_needed (on the hybrid counted on the device while
    the profiler records) equals the harness's ``Spans.k2_rows``.  The
    hybrid starts from a risk budget of 256, so its first launch
    overflows and K2 reruns."""
    bench_json = _hybrid_cell(tmp_path, cap=2) if prefilter else add_tiny_cell(tmp_path)
    cell = cells.load_cell(TINY_CELL, bench_json)
    vocab, script, ranks = world.make_script_world(23, cell.config["script"])
    pool = world.make_pool(23, vocab, script, ranks, cell.traffic)
    with tr.Spans() as spans:
        engine = system.build_engine(script.text, cell.config, "cpu", {})
        if prefilter:
            engine._bucketed_risk_budget = 256
        with profile(activities=[ProfilerActivity.CPU]):
            _, st = engine.search_works(world.call_works(pool, 1))
        rows, _ = spans.counts()
    x = st.extra
    assert rows and x["k2_rows_needed"] == sum(rows) > 0
    if prefilter:
        assert engine._bucketed_risk_budget > 256
        assert x["k2_rows_launched"] > 256 * st.num_batches
    else:
        assert x["k2_rows_needed"] == st.num_query_shingles
        assert x["k2_rows_launched"] >= x["k2_rows_needed"]


def _ctx(calls, gaps=None, devices=1, window_s=10.0):
    summary = tr.TraceSummary(window_s, {i: 5.0 for i in range(devices)}, {}, gaps or {})
    return runner.Context(cell=None, window_s=window_s, calls=calls, trace=summary)


def _call(**extra):
    return {"extra": dict({"s_pack": 0.1, "s_tokenize_wait": 0.5}, **extra)}


def test_readers_on_a_hand_built_context():
    r = _readers()
    ctx = _ctx([_call(k2_rows_launched=1000.0, k2_rows_needed=700.0, d_bucket_stage=0.2),
                _call(k2_rows_launched=1000.0, k2_rows_needed=900.0, d_bucket_stage=0.3)],
               gaps={"host.tokenize_wait": 2.5, "host.pack": 0.1, "host.batchgen": 0.2})
    assert r["tokenize_idle_share.sweep"].read(ctx) == pytest.approx(25.0)
    assert r["pack_idle_share.sweep"].read(ctx) == pytest.approx(1.0)
    assert r["k2_pad_share.sweep"].read(ctx) == pytest.approx(20.0)
    assert r["bucket_stage_device_share.sweep"].read(ctx) == pytest.approx(5.0)


def test_idle_readers_read_zero_without_such_gaps_and_nothing_without_cards():
    r = _readers()
    for name in NEW[:2]:
        assert r[name].read(_ctx([_call()], gaps={"host.batchgen": 1.0})) == 0.0
        assert r[name].read(_ctx([_call()], gaps={"host.other": 1.0}, devices=0)) is None
        assert r[name].read(runner.Context(cell=None, window_s=1.0, calls=[_call()])) is None


def test_counter_readers_on_a_program_without_the_counters():
    """A program that predates them reads 0 (its traced run ends); one
    that has them and lost them reads nothing."""
    r = _readers()
    parent = [{"extra": {"s_batchgen": 1.0, "bucketed_risk_frac": 0.2}}]
    lost = [_call(k2_rows_launched=1000.0)]
    for name in NEW[2:]:
        assert r[name].read(_ctx(parent)) == 0.0
        assert r[name].read(_ctx(lost)) is None


def test_traced_hybrid_run_reports_the_counter_metrics(tmp_path):
    """A traced CPU run of the tiny hybrid reports the program's own
    counters; the device-trace metrics read nothing on the CPU."""
    bench_json = _hybrid_cell(tmp_path, cap=2)
    r = runner.run(TINY_CELL, 2**31 + 5, 0.1, True, device="cpu", bench_json=bench_json)
    assert r["correct"]
    m = r["metrics"]
    assert 0.0 < m["k2_pad_share.sweep"]["value"] < 100.0
    assert 0.0 < m["bucket_stage_device_share.sweep"]["value"] < 100.0
    assert "tokenize_idle_share.sweep" not in m and "pack_idle_share.sweep" not in m
