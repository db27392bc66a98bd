"""The engine's work stream (``SearchEngine._work_stream``) on the CPU.

Raw works tokenize in sorted id order, in runs of consecutive works
(``tokenize_tasks``), on the caller's thread and a few helper threads,
and each is yielded as soon as it and every work before it are done.
The stream is held to the tokenizer's own output, work for work, and a
stream whose later works are held back still yields its first ones.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest

from fandom_search_tpu_torch.config import PipelineConfig
from fandom_search_tpu_torch.data.fast_tokenizer import fast_tokenize, tokenize_many
from fandom_search_tpu_torch.data.script_parser import parse_script
from fandom_search_tpu_torch.search import engine as engine_mod
from fandom_search_tpu_torch.search.engine import EngineStats, SearchEngine, tokenize_tasks
from fandom_search_tpu_torch.search.index import build_script_index
from fandom_search_tpu_torch.utils.profiling import Tracer
from fandom_search_tpu_torch.utils.synthetic import make_script, make_vocab

BATCH = 4096


@pytest.fixture(scope="module")
def vocab():
    return make_vocab(np.random.default_rng(3), 300)


@pytest.fixture(scope="module")
def engine(vocab):
    cfg = PipelineConfig()
    cfg = dataclasses.replace(cfg, search=dataclasses.replace(cfg.search, batch_queries=BATCH))
    lines = parse_script(make_script(np.random.default_rng(4), vocab, num_lines=20))
    return SearchEngine(build_script_index(lines, cfg.shingle, cfg.search), cfg, device="cpu")


def _texts(vocab, rng, count, words):
    return [" ".join(rng.choice(vocab, size=int(rng.integers(*words))).tolist())
            for _ in range(count)]


def _case(name, vocab):
    """(raw works, pre-tokenized works) of one case."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "no_raw":
        return {}, {f"p{i}": fast_tokenize(t) for i, t in enumerate(_texts(vocab, rng, 5, (20, 60)))}
    if name.startswith("inline_"):
        # a served request's few works: short enough for one run
        n = int(name[-1])
        return {f"w{i}": t for i, t in enumerate(_texts(vocab, rng, n, (20, 60)))}, {}
    if name == "many_short":
        return {f"w{i:04d}": t for i, t in enumerate(_texts(vocab, rng, 2048, (1, 12)))}, {}
    if name == "interleaved":
        texts = _texts(vocab, rng, 60, (30, 300))
        raw = {f"w{i:02d}": t for i, t in enumerate(texts) if i % 3}
        pre = {f"w{i:02d}": fast_tokenize(t) for i, t in enumerate(texts) if not i % 3}
        return raw, pre
    if name == "empty_texts":
        texts = _texts(vocab, rng, 30, (5, 80))
        return {f"w{i:02d}": ("" if i % 4 == 0 else "  \n" if i % 7 == 0 else t)
                for i, t in enumerate(texts)}, {}
    if name == "longer_than_batch":
        texts = _texts(vocab, rng, 12, (50, 200))
        texts[5] = " ".join(rng.choice(vocab, size=3 * BATCH).tolist())
        return {f"w{i:02d}": t for i, t in enumerate(texts)}, {}
    raise KeyError(name)


CASES = ["no_raw", "inline_1", "inline_3", "many_short", "interleaved", "empty_texts",
         "longer_than_batch"]


@pytest.mark.parametrize("name", CASES)
def test_stream_is_the_tokenizers_output_in_order(engine, vocab, name):
    raw, pre = _case(name, vocab)
    want = sorted({**pre, **tokenize_many(dict(raw))}.items())
    tokenized = dict(pre)
    stats = EngineStats()
    engine._trace = Tracer(stats, "cpu")
    # switch threads often, so the caller's cancel of a run races the
    # helpers' start of it
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = list(engine._work_stream(dict(raw), tokenized))
    finally:
        sys.setswitchinterval(interval)
        engine._trace = Tracer(EngineStats(), "cpu")
    assert [w for w, _ in got] == [w for w, _ in want]
    for (w, g), (_, e) in zip(got, want):
        assert g.text == e.text, w
        assert g.hashes.dtype == e.hashes.dtype and np.array_equal(g.hashes, e.hashes), w
        assert g.offsets.dtype == e.offsets.dtype and np.array_equal(g.offsets, e.offsets), w
    assert set(tokenized) == set(raw) | set(pre)
    assert all(tokenized[w] is g for w, g in got)
    tasks = tokenize_tasks(raw, BATCH, engine_mod.TOKENIZE_HELPERS + 1)
    waits = stats.extra.get("tokenize_waits", 0)
    assert 0 < waits <= len(tasks) if raw else waits == 0
    if name.startswith("inline_"):
        # one run, tokenized on the caller's thread: a wait
        assert waits == len(tasks) == 1


def test_tokenize_tasks_cover_the_sorted_works_in_runs():
    raw = {f"w{i:03d}": "x" * (i % 7) * 40 for i in range(200)}
    tasks = tokenize_tasks(raw, 1024, 4)
    assert [w for t in tasks for w in t] == sorted(raw)
    # every run but the last reaches the budget, and only at its last work
    for t in tasks[:-1]:
        size = [len(raw[w]) for w in t]
        assert sum(size) >= 256 > sum(size[:-1])


def test_first_works_are_yielded_while_later_ones_tokenize(engine, vocab, monkeypatch):
    """Every work after the first three blocks until released: the stream
    yields those three first, so the first batch does not wait for the
    rest of the call."""
    rng = np.random.default_rng(11)
    # each work alone reaches a run's budget, so each is a task of its own
    texts = [f"{i} " + t for i, t in enumerate(_texts(vocab, rng, 40, (300, 400)))]
    raw = {f"w{i:02d}": t for i, t in enumerate(texts)}
    assert min(len(t) for t in texts) >= BATCH // (engine_mod.TOKENIZE_HELPERS + 1)
    early = set(texts[:3])
    release = threading.Event()
    blocked = []

    def held_back(text):
        if text not in early:
            blocked.append(text)
            if not release.wait(timeout=10):
                release.set()  # the stream waited for this work: fail, not hang
        return fast_tokenize(text)

    monkeypatch.setattr(engine_mod, "fast_tokenize", held_back)
    monkeypatch.setattr(engine_mod, "get_lib", lambda: object())
    tokenized = {}
    stream = engine._work_stream(dict(raw), tokenized)
    try:
        first = [next(stream) for _ in range(3)]
        assert not release.is_set()
        assert [w for w, _ in first] == sorted(raw)[:3]
    finally:
        release.set()
    got = first + list(stream)
    assert len(blocked) == len(texts) - 3
    want = sorted(tokenize_many(dict(raw)).items())
    assert [w for w, _ in got] == [w for w, _ in want]
    assert all(np.array_equal(g.hashes, e.hashes) for (_, g), (_, e) in zip(got, want))
    assert set(tokenized) == set(raw)
