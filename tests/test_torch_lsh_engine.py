"""The port's engine with the LSH prefilter and `search --lsh` against the JAX package.

Tolerance: 0.  MatchRows compare field by field (rounded scores
included) between the port's engine and the JAX engine with the same
prefilter attached; the JAX side runs its Pallas kernels in interpret
mode, at 256 bits and rerank 128 as tests/test_lsh.py does.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fandom_search_tpu.config import PipelineConfig
from fandom_search_tpu.data.script_parser import parse_script
from fandom_search_tpu.ops.lsh import attach_lsh_prefilter as jax_attach
from fandom_search_tpu.search.engine import SearchEngine as JaxEngine
from fandom_search_tpu.search.index import build_script_index
from fandom_search_tpu.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)
from fandom_search_tpu_torch import cli
from fandom_search_tpu_torch.config import LSHConfig as PortLSHConfig
from fandom_search_tpu_torch.config import PipelineConfig as PortConfig
from fandom_search_tpu_torch.data.script_parser import parse_script as port_parse
from fandom_search_tpu_torch.ops.lsh import attach_lsh_prefilter
from fandom_search_tpu_torch.scrape.clean import load_works_dir
from fandom_search_tpu_torch.search.engine import SearchEngine
from fandom_search_tpu_torch.search.index import build_script_index as port_build
from fandom_search_tpu_torch.search.report import write_matches_csv

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
LSH_SMALL = dict(bits=256, rerank=128)


@pytest.fixture(scope="module")
def world():
    """The tests/test_lsh.py:90-116 world."""
    rng = np.random.default_rng(42)
    vocab = make_vocab(rng, 1000)
    script_text = make_script(rng, vocab, num_lines=18, words_per_line=(7, 12))
    lines = parse_script(script_text)
    index = build_script_index(lines, PipelineConfig().shingle, PipelineConfig().search)
    works, planted = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=6, words_per_work=200,
        quotes_per_work=2, num_edits=0, vocab=vocab,
    )
    return works, planted, index


def _rows(rows):
    return [r.to_csv_row() for r in rows]


def _both(**search):
    """(JAX config, port config) with the same search overrides."""
    j, p = PipelineConfig(), PortConfig()
    return (dataclasses.replace(j, search=dataclasses.replace(j.search, **search)),
            dataclasses.replace(p, search=dataclasses.replace(p.search, **search)))


@pytest.mark.parametrize("search", [
    {},
    # a candidate budget of 8 forces the batch retry; "fast" routes
    # verification to K5
    dict(max_candidates_per_batch=8, sw_variant="fast"),
    # many batches, with the next one submitted before the last is pulled
    dict(batch_queries=512, sw_variant="r2"),
])
def test_lsh_engine_rows_match_jax(world, search):
    works, planted, index = world
    jcfg, pcfg = _both(**search)
    jeng = JaxEngine(index, jcfg, use_pallas=True, interpret=True)
    jax_attach(jeng, dataclasses.replace(jcfg.lsh, **LSH_SMALL))
    jrows, jstats = jeng.search_works(works)
    eng = SearchEngine.from_index(index, pcfg, device="cpu")
    attach_lsh_prefilter(eng, PortLSHConfig(**LSH_SMALL))
    assert eng.lsh.ns_valid == index.num_shingles
    rows, stats = eng.search_works(works)
    assert rows and _rows(rows) == _rows(jrows)
    for f in ("num_works", "num_query_shingles", "num_candidates",
              "num_verified", "num_batches"):
        assert getattr(stats, f) == getattr(jstats, f), f
    found = {(r.work_id, r.line_no) for r in rows}
    assert all((p.work_id, p.line_no) in found for p in planted)
    if "max_candidates_per_batch" in search:
        assert eng._cand_budget > 8
    if "batch_queries" in search:
        assert stats.num_batches > 1
    # and, as tests/test_lsh.py asks, >= 95% agreement with the exact path
    exact, _ = SearchEngine.from_index(index, pcfg, device="cpu").search_works(works)
    key = lambda r: (r.work_id, r.fan_token_start, r.fan_token_end, r.line_no)  # noqa: E731
    a, b = {key(r) for r in exact}, {key(r) for r in rows}
    assert len(a & b) >= 0.95 * len(a)


@pytest.mark.parametrize("max_out", [1 << 14, 8])
def test_lsh_candidate_stage_matches_jax(world, max_out):
    """The swapped-in candidate stage (K1 -> encode -> K6 -> rerank ->
    compaction) returns the JAX stage's (qpos, script row, score, count)
    on one batch, element by element — also when the count overflows
    ``max_out`` and the engine must rerun the batch."""
    works, _, index = world
    jcfg, pcfg = _both()
    jeng = JaxEngine(index, jcfg, use_pallas=True, interpret=True)
    jax_attach(jeng, dataclasses.replace(jcfg.lsh, **LSH_SMALL))
    (_, payload, _, _), = list(jeng._batches(sorted(jeng._work_stream(dict(works), {}))))
    kind, ext, t_pad, _ = payload
    assert kind == "raw"
    want = [np.asarray(x) for x in jeng._candidates_fn(
        jnp.asarray(ext[:t_pad]), jeng._s_emb_padded, jeng._ns_valid, jeng._mults,
        max_out=max_out)]
    eng = SearchEngine.from_index(index, pcfg, device="cpu")
    attach_lsh_prefilter(eng, PortLSHConfig(**LSH_SMALL))
    got = [x.numpy() for x in eng._candidates_fn(
        torch.from_numpy(ext[:t_pad].view(np.int32)), max_out=max_out)]
    assert int(want[3]) > 0 and (int(want[3]) > max_out) == (max_out == 8)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("flags,lsh,variant", [
    (["--lsh"], True, "wide"),
    (["--sw-variant", "fast"], False, "fast"),
    (["--lsh", "--sw-variant", "dyn"], True, "dyn"),
])
def test_cli_search_lsh_and_sw_variant(tmp_path, flags, lsh, variant):
    """`search --lsh` / `--sw-variant` with --device cpu write the rows
    the in-process engine gives with the same settings."""
    out = tmp_path / "cli.csv"
    rc = cli.main(["search", str(EXAMPLES / "fanworks"), str(EXAMPLES / "script.txt"),
                   "-o", str(out), "--device", "cpu", *flags])
    assert rc == 0
    cfg = PortConfig()
    cfg = dataclasses.replace(cfg, search=dataclasses.replace(cfg.search, sw_variant=variant))
    lines = port_parse((EXAMPLES / "script.txt").read_text(encoding="utf-8"))
    eng = SearchEngine(port_build(lines, cfg.shingle, cfg.search), cfg, device="cpu")
    if lsh:
        attach_lsh_prefilter(eng, cfg.lsh)
    rows, _ = eng.search_works(load_works_dir(EXAMPLES / "fanworks"))
    want = tmp_path / "engine.csv"
    write_matches_csv(rows, want)
    assert rows and out.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("flags", [["--lsh"], ["--sw-variant", "fast"]])
def test_cli_new_flags_still_need_cuda(tmp_path, monkeypatch, capsys, flags):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        cli.main(["search", str(EXAMPLES / "fanworks"), str(EXAMPLES / "script.txt"),
                  "-o", str(tmp_path / "x.csv"), *flags])
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "x.csv").exists()
