"""The port's fused step, engine and CLI against the JAX package.

Tolerance: 0.  Every quantity is an integer or one f32 division of two
integers, so the [5, verify_budget] step outputs compare element by
element (np.array_equal) and MatchRows compare field by field,
rounded scores included.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fandom_search_tpu.config import PipelineConfig
from fandom_search_tpu.data.script_parser import parse_script
from fandom_search_tpu.scrape.clean import load_works_dir
from fandom_search_tpu.search.engine import SearchEngine as JaxEngine
from fandom_search_tpu.search.index import build_script_index
from fandom_search_tpu.search.oracle import search_works_oracle
from fandom_search_tpu.search.report import write_matches_csv
from fandom_search_tpu.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)
from fandom_search_tpu_torch import cli
from fandom_search_tpu_torch.search import engine as port_engine
from fandom_search_tpu_torch.search.engine import SearchEngine, fused_step

CFG = PipelineConfig()
EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(scope="module")
def world():
    """The tests/test_engine.py world: clean and mutated planted quotes."""
    rng = np.random.default_rng(11)
    vocab = make_vocab(rng, 1500)
    script_text = make_script(rng, vocab, num_lines=25, words_per_line=(7, 13))
    lines = parse_script(script_text)
    index = build_script_index(lines, CFG.shingle, CFG.search)
    dialogue = [ln.text for ln in lines]
    works, planted = make_corpus_with_quotes(
        rng, dialogue, num_works=8, words_per_work=300,
        quotes_per_work=2, num_edits=0, vocab=vocab,
    )
    works2, _ = make_corpus_with_quotes(
        rng, dialogue, num_works=4, words_per_work=250,
        quotes_per_work=1, num_edits=1, vocab=vocab,
    )
    for wid, text in works2.items():
        works["mut_" + wid] = text
    return works, planted, index


def _rows(rows):
    return [r.to_csv_row() for r in rows]


def _with_search(cfg, **kw):
    return dataclasses.replace(cfg, search=dataclasses.replace(cfg.search, **kw))


@pytest.mark.parametrize(
    "cand_budget,verify_budget,packed",
    [(1 << 14, 2048, True), (8, 2048, True), (1 << 14, 16, True),
     (1 << 14, 2048, False)],
)
def test_fused_step_matches_jax_fused_jit(world, monkeypatch, cand_budget,
                                          verify_budget, packed):
    """(a) The [5, VB] output of one batch equals _fused_jit's
    (use_pallas=False) element by element — including batches whose
    candidate or verify budget overflows, and the multi-key dedup sort
    the port takes when the packed key would not fit."""
    if not packed:
        monkeypatch.setattr(port_engine, "_packable", lambda *a: False)
    works, _, index = world
    jeng = JaxEngine(index, CFG, use_pallas=False)
    items = sorted(
        (w, t) for w, t in jeng._work_stream(dict(works), {})
    )
    (_, payload, _, _), = list(jeng._batches(items))
    kind, ext, _, nspans = payload
    assert kind == "raw"
    want = np.asarray(
        jeng._fused_call(jnp.asarray(ext), nspans, cand_budget, verify_budget)
    )
    peng = SearchEngine.from_index(index, CFG, device="cpu")
    got = fused_step(
        torch.from_numpy(ext.view(np.int32)), peng._dix,
        shingle_cfg=CFG.shingle, search_cfg=CFG.search,
        cand_budget=cand_budget, verify_budget=verify_budget, nspans=nspans,
    ).numpy()
    assert got.shape == want.shape == (5, verify_budget)
    assert np.array_equal(got, want)
    assert want[4, 2] > 0


def test_engine_rows_match_oracle_and_jax_pallas(world):
    """(b) Rows and scores equal the NumPy oracle's and the JAX engine's
    (Pallas kernels in interpret mode)."""
    works, planted, index = world
    rows, stats = SearchEngine.from_index(index, CFG, device="cpu").search_works(works)
    oracle_rows, _ = search_works_oracle(works, index, CFG)
    jax_rows, jstats = JaxEngine(
        index, CFG, use_pallas=True, interpret=True
    ).search_works(works)
    assert rows and _rows(rows) == _rows(oracle_rows) == _rows(jax_rows)
    found = {(r.work_id, r.line_no) for r in rows}
    assert all((p.work_id, p.line_no) in found for p in planted)
    for f in ("num_works", "num_query_shingles", "num_candidates",
              "num_verified", "num_batches"):
        assert getattr(stats, f) == getattr(jstats, f), f
    assert {"s_batchgen", "s_pull", "s_host"} <= set(stats.extra)


def test_engine_multi_batch_and_budget_overflow(world):
    """(c) batch_queries=512 packs many batches; a candidate budget of 8
    forces the overflow retry; rows stay equal to oracle and JAX."""
    works, _, index = world
    for cfg, grow in ((_with_search(CFG, batch_queries=512), False),
                      (_with_search(CFG, max_candidates_per_batch=8), True)):
        eng = SearchEngine.from_index(index, cfg, device="cpu")
        rows, stats = eng.search_works(works)
        jrows, _ = JaxEngine(index, cfg, use_pallas=False).search_works(works)
        oracle_rows, _ = search_works_oracle(works, index, cfg)
        assert _rows(rows) == _rows(oracle_rows) == _rows(jrows)
        if grow:
            assert eng._cand_budget > 8
        else:
            assert stats.num_batches > 1


def test_engine_giant_work_split_parity(world):
    """(c) A work past the batch cap splits into overlapping chunks: a
    line quoted inside one (tests/test_engine.py:195), and quotes that
    straddle every chunk boundary (:211)."""
    _, _, index = world
    cap = 1024
    small = _with_search(CFG, batch_queries=cap)
    # a script line quoted in the middle of a giant work (:195)
    rng = np.random.default_rng(3)
    vocab = make_vocab(rng, 500)
    body = " ".join(vocab[i] for i in rng.integers(0, len(vocab), 2000))
    works = {"giant": body + " " + index.lines[5].text + " " + body}
    rows, _ = SearchEngine.from_index(index, small, device="cpu").search_works(works)
    oracle_rows, _ = search_works_oracle(works, index, small)
    assert any(r.line_no == 5 for r in rows)
    assert _rows(rows) == _rows(oracle_rows)
    # quotes at every chunk-boundary-relative offset (:211)
    rng = np.random.default_rng(17)
    vocab = make_vocab(rng, 500)
    w = CFG.search.window_tokens
    words = [vocab[i] for i in rng.integers(0, len(vocab), 4 * cap)]
    for c in (1, 2, 3):
        base = c * (cap - (w - 1))
        for off in (-40, -3, 0, 7, w // 2):
            pos = base + off
            q = index.lines[(c + off) % len(index.lines)].text.split()
            words[pos : pos + len(q)] = q
    works = {"giant": " ".join(words)}
    rows, stats = SearchEngine.from_index(index, small, device="cpu").search_works(works)
    oracle_rows, _ = search_works_oracle(works, index, small)
    jrows, _ = JaxEngine(index, small, use_pallas=False).search_works(works)
    assert stats.num_batches > 1
    assert rows and _rows(rows) == _rows(oracle_rows) == _rows(jrows)


def test_engine_repeated_words_and_long_line_tail():
    """(c) Repeated-word lines push scores to n^2 (tests/test_engine.py
    :278); a quote of a 200-token line's tail verifies (:305)."""
    rng = np.random.default_rng(55)
    vocab = make_vocab(rng, 200)
    long_words = [vocab[i] for i in rng.integers(0, len(vocab), 200)]
    script_text = (
        f"ECHO: {' '.join(['drum'] * 12)}\n"
        f"ALICE: {' '.join(vocab[:9])}\n"
        f"ECHO: {' '.join(['drum'] * 8)} {' '.join(vocab[10:14])}\n"
        f"BOB: {' '.join(long_words)}\n"
    )
    lines = parse_script(script_text)
    index = build_script_index(lines, CFG.shingle, CFG.search)
    filler = " ".join(vocab[i] for i in rng.integers(0, len(vocab), 120))
    works = {
        "w0": filler + " " + " ".join(["drum"] * 12) + " " + filler,
        "w1": " ".join(["drum"] * 30),
        "w_tail": f"{filler} {' '.join(long_words[-30:])} {filler}",
    }
    rows, _ = SearchEngine.from_index(index, CFG, device="cpu").search_works(works)
    oracle_rows, _ = search_works_oracle(works, index, CFG)
    jrows, _ = JaxEngine(index, CFG, use_pallas=True, interpret=True).search_works(works)
    assert _rows(rows) == _rows(oracle_rows) == _rows(jrows)
    assert any(r.work_id == "w0" for r in rows)
    assert any(r.work_id == "w_tail" and r.line_no == 3
               and r.verify_score >= CFG.search.verify_threshold for r in rows)


def test_engine_empty_short_and_unsupported(world):
    _, _, index = world
    eng = SearchEngine.from_index(index, CFG, device="cpu")
    rows, stats = eng.search_works({"empty": "", "short": "two words"})
    assert rows == [] and stats.num_works == 2
    with pytest.raises(NotImplementedError):
        SearchEngine.from_index(
            index, _with_search(CFG, stream_compress=True), device="cpu"
        )


def test_engine_refuses_missing_cuda(world, monkeypatch):
    """No silent CPU fallback: asking for CUDA without it raises."""
    _, _, index = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SearchEngine.from_index(index, CFG, device="cuda")


def test_cli_search_cpu_writes_oracle_csv_bytes(tmp_path):
    """(d) `search --device cpu` on examples/ writes the bytes that the
    JAX package's write_matches_csv writes for the oracle's rows."""
    out = tmp_path / "port.csv"
    rc = cli.main([
        "search", str(EXAMPLES / "fanworks"), str(EXAMPLES / "script.txt"),
        "-o", str(out), "--device", "cpu",
    ])
    assert rc == 0
    lines = parse_script((EXAMPLES / "script.txt").read_text(encoding="utf-8"))
    index = build_script_index(lines, CFG.shingle, CFG.search)
    works = load_works_dir(EXAMPLES / "fanworks")
    oracle_rows, _ = search_works_oracle(works, index, CFG)
    want = tmp_path / "oracle.csv"
    write_matches_csv(oracle_rows, want)
    assert oracle_rows
    assert out.read_bytes() == want.read_bytes()


def test_cli_flags_and_missing_cuda(tmp_path, monkeypatch, capsys):
    out = tmp_path / "m.csv"
    rc = cli.main([
        "search", str(EXAMPLES / "fanworks"), str(EXAMPLES / "script.txt"),
        "-o", str(out), "--device", "cpu", "--k", "3",
        "--candidate-threshold", "4.0", "--verify-threshold", "0.5",
    ])
    assert rc == 0
    cfg = _with_search(CFG, k=3, candidate_threshold=4.0, verify_threshold=0.5)
    lines = parse_script((EXAMPLES / "script.txt").read_text(encoding="utf-8"))
    index = build_script_index(lines, cfg.shingle, cfg.search)
    oracle_rows, _ = search_works_oracle(
        load_works_dir(EXAMPLES / "fanworks"), index, cfg
    )
    want = tmp_path / "oracle.csv"
    write_matches_csv(oracle_rows, want)
    assert out.read_bytes() == want.read_bytes()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        cli.main([
            "search", str(EXAMPLES / "fanworks"), str(EXAMPLES / "script.txt"),
            "-o", str(tmp_path / "x.csv"),
        ])
    assert "CUDA is not available" in capsys.readouterr().err
