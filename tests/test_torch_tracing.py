"""The engine's own tracing (``utils/profiling.py`` ``Tracer``) on the CPU.

While the torch profiler records, ``search_works`` opens a host span on
the caller's thread for each of its timers (``host.batchgen`` and in it
``host.tokenize_wait`` and ``host.pack``, ``host.submit``,
``host.pull_post`` and in it ``host.pull`` and ``host.post``,
``host.chain``), and the bucketed hybrid a ``stage.bucket`` span for each
part of its stage 1.  Off, it makes no ``record_function`` at all.  The
K2 row counters: on the exact path each batch's work shingles, on the
hybrid (counted on the device while tracing) the at-risk rows of each
batch's first launch that lie inside one work; ``tokenize_waits``, the
tokenizer tasks the caller waited for.  The worlds are small:
an exact search in three batches, and a hybrid with buckets of cap 2
whose at-risk rows overflow the first risk budget, so K2 reruns.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from fandom_search_tpu_torch.config import BucketedConfig, PipelineConfig
from fandom_search_tpu_torch.data.script_parser import parse_script
from fandom_search_tpu_torch.ops.bucketed import attach_bucketed_prefilter
from fandom_search_tpu_torch.search.engine import (
    TOKENIZE_HELPERS,
    EngineStats,
    SearchEngine,
    tokenize_tasks,
)
from fandom_search_tpu_torch.search.index import build_script_index
from fandom_search_tpu_torch.utils import profiling
from fandom_search_tpu_torch.utils.profiling import Tracer
from fandom_search_tpu_torch.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)

HOST_SPANS = {"host.batchgen", "host.tokenize_wait", "host.pack", "host.submit",
              "host.pull_post", "host.pull", "host.post", "host.chain"}
CALLER = "test.caller"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = PipelineConfig()
    return dataclasses.replace(cfg, search=dataclasses.replace(cfg.search, batch_queries=4096))


def _exact_world():
    rng = np.random.default_rng(7)
    vocab = make_vocab(rng, 400)
    lines = parse_script(make_script(rng, vocab, num_lines=40))
    index = build_script_index(lines, _cfg().shingle, _cfg().search)
    works, _ = make_corpus_with_quotes(rng, [ln.text for ln in lines], num_works=24,
                                       words_per_work=400, quotes_per_work=2, vocab=vocab)
    return index, works


def _hybrid_world():
    """Every line leads with the same stopword run, so its pair buckets
    overflow cap 2, and the works are made of script lines: most of a
    batch's rows are at risk, more than the first risk budget holds."""
    rng = np.random.default_rng(42)
    vocab = make_vocab(rng, 600)
    lines = parse_script("\n".join(
        "ALICE: of the of the " + " ".join(rng.choice(vocab, size=6).tolist())
        for _ in range(30)))
    index = build_script_index(lines, _cfg().shingle, _cfg().search)
    texts = [ln.text for ln in lines]
    works = {f"w{i:02d}": " ".join(texts[j] for j in rng.integers(0, len(texts), 30))
             for i in range(10)}
    return index, works


def _engine(path, index):
    eng = SearchEngine(index, _cfg(), device="cpu")
    if path == "hybrid":
        attach_bucketed_prefilter(eng, BucketedConfig(cap=2, pairs="all"))
        assert eng._bucketed_risk_budget == 1024
    return eng


def _traced(eng, works, tmp: Path):
    """search_works under the profiler, inside a span of the caller's;
    (rows, stats, the trace's annotation events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            rows, stats = eng.search_works(dict(works))
    prof.export_chrome_trace(str(tmp / "trace.json"))
    events = json.loads((tmp / "trace.json").read_text())["traceEvents"]
    return rows, stats, [e for e in events if e.get("cat") == "user_annotation"]


@pytest.fixture(scope="module", params=["exact", "hybrid"])
def searched(request, tmp_path_factory):
    """Each path's world searched untraced and traced, each on an engine
    of its own: {rows, stats, engine, ...} for both."""
    index, works = _exact_world() if request.param == "exact" else _hybrid_world()
    plain = _engine(request.param, index)
    rows, stats = plain.search_works(dict(works))
    traced = _engine(request.param, index)
    t_rows, t_stats, ann = _traced(traced, works, tmp_path_factory.mktemp(request.param))
    return dict(path=request.param, index=index, works=works, rows=rows, stats=stats,
                engine=plain, t_rows=t_rows, t_stats=t_stats, t_engine=traced, ann=ann)


def _csv(rows):
    return [r.to_csv_row() for r in rows]


def test_traced_search_holds_every_span(searched):
    names = {e["name"] for e in searched["ann"]}
    assert HOST_SPANS <= names
    assert ("stage.bucket" in names) == (searched["path"] == "hybrid")


def test_host_spans_are_on_the_callers_thread(searched):
    caller = {e["tid"] for e in searched["ann"] if e["name"] == CALLER}
    assert len(caller) == 1
    spans = [e for e in searched["ann"] if e["name"].startswith(("host.", "stage."))]
    assert spans and {e["tid"] for e in spans} == caller


def test_rows_are_the_same_traced_and_untraced(searched):
    assert searched["rows"] and _csv(searched["rows"]) == _csv(searched["t_rows"])
    for f in ("num_query_shingles", "num_candidates", "num_verified", "num_batches"):
        assert getattr(searched["stats"], f) == getattr(searched["t_stats"], f), f


def test_batchgen_holds_tokenize_wait_and_pack(searched):
    for st in (searched["stats"], searched["t_stats"]):
        x = st.extra
        assert {"s_batchgen", "s_pull", "s_host", "s_tokenize_wait", "s_pack"} <= set(x)
        assert 0 < x["s_tokenize_wait"] + x["s_pack"] <= x["s_batchgen"]
        assert st.seconds_device_topk > 0 and st.seconds_host >= x["s_host"] > 0


def test_tokenize_waits_counts_the_tasks_waited_for(searched):
    """The in-order tokenizer results the caller had to wait for: the
    first task at least (the caller tokenizes it), every task at most."""
    tasks = tokenize_tasks(searched["works"], _cfg().search.batch_queries, TOKENIZE_HELPERS + 1)
    for st in (searched["stats"], searched["t_stats"]):
        assert 1 <= st.extra["tokenize_waits"] <= len(tasks)


def test_k2_rows(searched):
    """Exact: each batch's in-work shingles, however the search is run.
    Hybrid: the at-risk rows of each first launch that lie in a work,
    counted only while tracing; no more than the engine's at-risk count,
    and that no more than the rows K2 ran, reruns included."""
    x, tx = searched["stats"].extra, searched["t_stats"].extra
    n = _cfg().shingle.n
    if searched["path"] == "exact":
        eng = searched["engine"]
        spans = [s for _, _, sp, _ in eng._batches(eng._work_stream(dict(searched["works"]), {}))
                 for s in sp]
        want = sum(max(0, m - n + 1) for _, _, m in spans)
        assert x["k2_rows_needed"] == tx["k2_rows_needed"] == want
        assert x["k2_rows_launched"] == tx["k2_rows_launched"] >= want
        assert searched["stats"].num_batches == 3
    else:
        eng = searched["t_engine"]
        assert "k2_rows_needed" not in x and x["k2_rows_launched"] == tx["k2_rows_launched"]
        assert 0 < tx["k2_rows_needed"] <= eng._bucketed_risk_queries <= tx["k2_rows_launched"]
        # the first budget overflowed, so K2 ran again at a larger one
        assert eng._bucketed_risk_budget > 1024
        assert tx["k2_rows_launched"] > 1024 * searched["t_stats"].num_batches


def test_bucket_stage_is_timed_on_the_cpu(searched):
    """On the CPU the stage's parts run as called: their host seconds,
    traced or not."""
    for st in (searched["stats"], searched["t_stats"]):
        if searched["path"] == "hybrid":
            assert 0 < st.extra["d_bucket_stage"] < st.seconds_device_topk + st.seconds_host
        else:
            assert "d_bucket_stage" not in st.extra


def test_no_record_function_with_the_profiler_off(searched, monkeypatch):
    made = []

    def counting(name):
        made.append(name)
        return record_function(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    eng = _engine(searched["path"], searched["index"])
    eng.search_works(dict(searched["works"]))
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        eng.search_works(dict(searched["works"]))
    assert HOST_SPANS <= set(made)


def test_tracer_sums_into_fields_and_extra():
    st = EngineStats()
    tr = Tracer(st, "cpu")
    with tr.host("a", ("seconds_host", "s_x")):
        pass
    tr.add("k", 3)
    tr.add("k", 4)
    with tr.device("d", "d_x"):
        torch.ones(4).sum()
    tr.resolve(wait=True)
    assert st.seconds_host == st.extra["s_x"] > 0
    assert st.extra["k"] == 7 and st.extra["d_x"] > 0
    assert not tr.on and not profiling.tracing()


def test_tracer_spans_only_while_tracing():
    st = EngineStats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = Tracer(st, "cpu", on=profiling.tracing())
        with on.host("test.on", "s_on"):
            with on.device("test.dev", "d_on"):
                pass
        off = Tracer(st, "cpu", on=False)
        with off.host("test.off", "s_off"):
            pass
    names = {e.name for e in prof.events()}
    assert on.on and {"test.on", "test.dev"} <= names and "test.off" not in names
    assert {"s_on", "d_on", "s_off"} <= set(st.extra)
