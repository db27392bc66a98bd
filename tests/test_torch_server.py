"""The port's serve mode against the JAX package's (search/server.py).

Tolerance: 0.  Match rows compare field by field (their CSV form,
rounded scores included) with the port's engine called directly and
with the JAX SearchService over the JAX engine on the same request.
The server runs on the CPU device in a thread, on an ephemeral
localhost port.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fandom_search_tpu.config import PipelineConfig, SearchConfig
from fandom_search_tpu.data.script_parser import parse_script
from fandom_search_tpu.search.engine import SearchEngine as JaxEngine
from fandom_search_tpu.search.index import build_script_index
from fandom_search_tpu.search.server import SearchService as JService
from fandom_search_tpu.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)
from fandom_search_tpu_torch.config import PipelineConfig as PortConfig
from fandom_search_tpu_torch.config import SearchConfig as PortSearchConfig
from fandom_search_tpu_torch.search.engine import SearchEngine
from fandom_search_tpu_torch.search.index import index_from_numpy
from fandom_search_tpu_torch.search.server import SearchService, make_server


# small device batches: the rows do not depend on the batch size, and the
# plain versions then stay cheap on a CPU shared with the suite's workers
BATCH = 4096


@pytest.fixture(scope="module")
def served():
    """The tests/test_server.py world, served by the port on the CPU with
    one torch thread (the tensors are small; the suite's workers share
    the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = PipelineConfig(search=SearchConfig(batch_queries=BATCH))
    pcfg = PortConfig(search=PortSearchConfig(batch_queries=BATCH))
    rng = np.random.default_rng(31)
    vocab = make_vocab(rng, 1200)
    script_text = make_script(rng, vocab, num_lines=20, words_per_line=(7, 12))
    jidx = build_script_index(parse_script(script_text), cfg.shingle, cfg.search)
    works, planted = make_corpus_with_quotes(
        rng, [ln.text for ln in jidx.lines], num_works=6, words_per_work=300,
        quotes_per_work=2, num_edits=0, vocab=vocab,
    )
    index = index_from_numpy(jidx)
    engine = SearchEngine(index, pcfg, device="cpu")
    service = SearchService(engine, index, pcfg)
    service.warm()
    srv = make_server(service, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    jservice = JService(JaxEngine(jidx, cfg, use_pallas=False), jidx, cfg)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield base, service, engine, jservice, works, planted
    srv.shutdown()
    srv.server_close()
    t.join(timeout=5)
    torch.set_num_threads(threads)
    assert not t.is_alive()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _json_rows(rows):
    from fandom_search_tpu_torch.search.types import MatchRow

    return [dict(zip(MatchRow.CSV_FIELDS, r.to_csv_row())) for r in rows]


def test_health_names_the_torch_device(served):
    base, service, _, jservice, _, _ = served
    code, h = _get(base + "/health")
    assert code == 200 and h["status"] == "ok" and h["device"] == "cpu"
    assert h["script_shingles"] == service.index.num_shingles
    assert h["script_lines"] == len(service.index.lines)
    assert set(h) == {"status", "script_lines", "script_shingles", "device",
                      "uptime_seconds"}


def test_search_rows_equal_direct_engine_and_jax_service(served):
    base, _, engine, jservice, works, planted = served
    code, out = _post(base + "/search", {"works": works})
    assert code == 200 and out["works"] == len(works)
    direct, _ = engine.search_works(works)
    jrows, jmeta = jservice.search(works)
    assert out["matches"] == _json_rows(direct) == _json_rows(jrows)
    assert out["matches"]
    assert out["num_matches"] == jmeta["num_matches"]
    assert out["query_shingles"] == jmeta["query_shingles"]
    assert {"works", "num_matches", "query_shingles", "seconds",
            "queue_seconds", "engine_extra"} <= set(out)
    found = {(m["work_id"], m["line_no"]) for m in out["matches"]}
    assert all((p.work_id, p.line_no) in found for p in planted)


def test_single_text_and_stats(served):
    base, _, _, jservice, works, _ = served
    some_text = next(iter(works.values()))
    code, out = _post(base + "/search", {"text": some_text, "include_stats": True})
    assert code == 200
    assert out["matches"] and all(m["work_id"] == "query" for m in out["matches"])
    assert out["matches"] == _json_rows(jservice.search({"query": some_text})[0])
    assert out["server_stats"]["requests"] >= 1
    code, st = _get(base + "/stats")
    assert code == 200 and st["matches"] > 0 and st["errors"] == 0
    assert set(st) == set(jservice.stats())


@pytest.mark.parametrize("body", [{}, {"works": {}}, {"works": {"a": 3}}, {"works": "x"}, [1]])
def test_bad_requests(served, body):
    code, out = _post(served[0] + "/search", body)
    assert code == 400 and "error" in out


def test_unknown_paths_and_raw_garbage(served):
    base = served[0]
    assert _get(base + "/nope")[0] == 404
    assert _post(base + "/elsewhere", {"works": {"a": "b"}})[0] == 404
    req = urllib.request.Request(base + "/search", data=b"not json", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code = r.status
    except urllib.error.HTTPError as e:
        code = e.code
    assert code == 400


def test_engine_failure_answers_500_and_counts(served, monkeypatch):
    base, service, engine, _, works, _ = served

    def boom(works):
        raise RuntimeError("device lost")

    before = service.stats()["errors"]
    monkeypatch.setattr(engine, "search_works", boom)
    code, out = _post(base + "/search", {"text": "a b c d e f g"})
    assert code == 500 and "device lost" in out["error"]
    assert service.stats()["errors"] == before + 1


def test_concurrent_requests_consistent_counters(served):
    """Parallel clients: every request answers and the counters (read-
    modify-written outside the engine lock) lose no update."""
    base, service, _, _, works, _ = served
    with service._stats_lock:
        before = dict(service.counters)
    wid = sorted(works)[0]
    n_threads, per_thread = 6, 3
    errors = []

    def client():
        for _ in range(per_thread):
            code, body = _post(base + "/search", {"works": {wid: works[wid]}})
            if code != 200:
                errors.append((code, body))

    threads = [threading.Thread(target=client) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    stats = _get(base + "/stats")[1]
    n = n_threads * per_thread
    assert stats["requests"] == before["requests"] + n
    assert stats["works"] == before["works"] + n
    assert stats["errors"] == before["errors"]


def test_queue_seconds_grow_under_contention(served):
    """Requests serialize behind the engine lock, and the meta shows the
    wait: the deepest-queued request waited about one search or more."""
    base, _, _, _, works, _ = served
    wid = sorted(works)[0]
    code, solo = _post(base + "/search", {"works": {wid: works[wid]}})
    assert code == 200 and solo["queue_seconds"] >= 0.0
    metas, lock = [], threading.Lock()

    def client():
        code, body = _post(base + "/search", {"works": {wid: works[wid]}})
        if code == 200:
            with lock:
                metas.append(body)

    threads = [threading.Thread(target=client) for _ in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert len(metas) == 5
    queues = sorted(m["queue_seconds"] for m in metas)
    assert queues[-1] > max(min(m["seconds"] for m in metas) * 0.5, solo["queue_seconds"])
    assert _get(base + "/stats")[1]["queue_seconds"] >= queues[-1] * 0.9
