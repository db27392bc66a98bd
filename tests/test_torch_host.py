"""The port's host modules against the JAX package's originals.

Tolerance: 0.  Hashes, tokens, offsets, index arrays and match rows are
integers, strings or rounded floats computed by the same code, so every
comparison is exact (np.array_equal / ==).
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fandom_search_tpu.config import PipelineConfig
from fandom_search_tpu.data import hashing as jhash
from fandom_search_tpu.data import shingler as jshingler
from fandom_search_tpu.data.fast_tokenizer import tokenize_many as jtokenize_many
from fandom_search_tpu.data.script_parser import parse_script as jparse
from fandom_search_tpu.data.tokenizer import tokenize as jtokenize
from fandom_search_tpu.search.chain import chain_hits_arrays as jchain
from fandom_search_tpu.search.index import build_script_index as jbuild
from fandom_search_tpu.search.index import concat_indexes as jconcat
from fandom_search_tpu.search.oracle import search_works_oracle as joracle
from fandom_search_tpu.utils import synthetic as jsynthetic
from fandom_search_tpu.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)
from fandom_search_tpu_torch.data import hashing, shingler
from fandom_search_tpu_torch.data.fast_tokenizer import tokenize_many
from fandom_search_tpu_torch.data.script_parser import parse_script
from fandom_search_tpu_torch.data.tokenizer import tokenize
from fandom_search_tpu_torch.search.chain import chain_hits_arrays
from fandom_search_tpu_torch.search.index import (
    build_script_index,
    concat_indexes,
    index_from_numpy,
)
from fandom_search_tpu_torch.search.oracle import search_works_oracle
from fandom_search_tpu_torch.utils import synthetic

CFG = PipelineConfig()
ROOT = Path(__file__).resolve().parent.parent
INDEX_ARRAYS = (
    "stream_hashes", "token_line", "shingle_line", "shingle_anchor",
    "shingle_windows", "embeddings", "line_start", "line_lengths",
)
TEXTS = [
    "", "Hello, world! Don't stop.", "o'clock  ROCK'n'roll 42x",
    "İstanbul straße ÉCOLE naïve", "a\tb\nc--d'e'", "x" * 50,
]


@pytest.fixture(scope="module")
def world():
    """The tests/test_engine.py world (the JAX package's index and works)."""
    rng = np.random.default_rng(11)
    vocab = make_vocab(rng, 1500)
    script_text = make_script(rng, vocab, num_lines=25, words_per_line=(7, 13))
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in jparse(script_text)], num_works=8,
        words_per_work=300, quotes_per_work=2, num_edits=1, vocab=vocab,
    )
    return script_text, works


def _same_index(a, b):
    for f in INDEX_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert [(ln.line_no, ln.speaker, ln.text, ln.script) for ln in a.lines] == [
        (ln.line_no, ln.speaker, ln.text, ln.script) for ln in b.lines
    ]


def test_hashing_matches(rng):
    words = ["", "a", "don't", "naïve", "ÉCOLE", "x" * 300]
    assert [hashing.hash_word(w) for w in words] == [jhash.hash_word(w) for w in words]
    assert np.array_equal(hashing.hash_words(words), jhash.hash_words(words))
    h = rng.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(hashing.fmix32(h), jhash.fmix32(h))
    for seed, n, dim in ((0x5EED, 6, 128), (7, 3, 256)):
        assert np.array_equal(
            hashing.derive_sign_mults(seed, n, dim),
            jhash.derive_sign_mults(seed, n, dim),
        )


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_matches(text):
    a, b = tokenize(text), jtokenize(text)
    assert a.tokens == b.tokens
    assert np.array_equal(a.offsets, b.offsets) and np.array_equal(a.hashes, b.hashes)


def test_tokenize_many_matches(world):
    _, works = world
    texts = dict(works, **{f"t{i}": t for i, t in enumerate(TEXTS)})
    got, want = tokenize_many(texts), jtokenize_many(texts)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].offsets, want[k].offsets), k
        assert np.array_equal(got[k].hashes, want[k].hashes), k


@pytest.mark.parametrize("which", ["tagged", "screenplay"])
def test_script_parser_matches(world, which):
    text = world[0] if which == "tagged" else (
        ROOT / "examples" / "script.txt").read_text(encoding="utf-8")
    got = [(ln.line_no, ln.speaker, ln.text, ln.script) for ln in parse_script(text)]
    want = [(ln.line_no, ln.speaker, ln.text, ln.script) for ln in jparse(text)]
    assert got and got == want


def test_shingler_matches(rng):
    cfg = CFG.shingle
    for t in (0, 5, 6, 400):
        toks = rng.integers(0, 2**32, size=t, dtype=np.uint64).astype(np.uint32)
        assert shingler.num_shingles(t, cfg) == jshingler.num_shingles(t, cfg)
        assert np.array_equal(shingler.shingle_hashes(toks, cfg),
                              jshingler.shingle_hashes(toks, cfg))
        assert np.array_equal(shingler.embed_shingles_np(toks, cfg),
                              jshingler.embed_shingles_np(toks, cfg))


def test_build_script_index_and_carry_across(world):
    """The port builds identical arrays, and index_from_numpy carries a
    JAX-built index across unchanged (tokens re-derived identically)."""
    text, _ = world
    jidx = jbuild(jparse(text), CFG.shingle, CFG.search)
    pidx = build_script_index(parse_script(text), CFG.shingle, CFG.search)
    _same_index(pidx, jidx)
    carried = index_from_numpy(jidx)
    _same_index(carried, jidx)
    assert [t.tokens for t in carried.tokenized] == [t.tokens for t in jidx.tokenized]
    assert carried.num_shingles == jidx.num_shingles
    # round trip: port -> port
    _same_index(index_from_numpy(carried), pidx)


def test_concat_indexes_matches(world):
    text, _ = world
    ex = (ROOT / "examples" / "script.txt").read_text(encoding="utf-8")
    jparts = [(n, jbuild(jparse(t), CFG.shingle, CFG.search))
              for n, t in (("a", text), ("b", ex))]
    pparts = [(n, build_script_index(parse_script(t), CFG.shingle, CFG.search))
              for n, t in (("a", text), ("b", ex))]
    _same_index(concat_indexes(pparts), jconcat(jparts))


def test_chain_hits_arrays_matches(world):
    text, works = world
    jidx = jbuild(jparse(text), CFG.shingle, CFG.search)
    pidx = index_from_numpy(jidx)
    jtok, ptok = jtokenize_many(works), tokenize_many(works)
    wids = sorted(jtok)
    rng = np.random.default_rng(99)
    seen, hits = set(), []
    for _ in range(400):
        wi = int(rng.integers(len(wids)))
        pos = int(rng.integers(len(jtok[wids[wi]]) - 6))
        line = int(rng.integers(len(jidx.lines)))
        if (wi, pos, line) not in seen:
            seen.add((wi, pos, line))
            hits.append((wi, pos, line, rng.random() * 6, rng.random()))
    arr = np.array(hits)
    cols = (arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64),
            arr[:, 2].astype(np.int64), arr[:, 3].astype(np.float32),
            arr[:, 4].astype(np.float32))
    got = chain_hits_arrays(*cols, wids, ptok, pidx, CFG.shingle, CFG.search)
    want = jchain(*cols, wids, jtok, jidx, CFG.shingle, CFG.search)
    assert got and [r.to_csv_row() for r in got] == [r.to_csv_row() for r in want]


def test_oracle_rows_match(world):
    text, works = world
    jidx = jbuild(jparse(text), CFG.shingle, CFG.search)
    got, gstats = search_works_oracle(works, index_from_numpy(jidx), CFG)
    want, wstats = joracle(works, jidx, CFG)
    assert got and [r.to_csv_row() for r in got] == [r.to_csv_row() for r in want]
    assert (gstats.num_candidates, gstats.num_verified) == (
        wstats.num_candidates, wstats.num_verified)


@pytest.mark.parametrize("seed,num_edits", [(0, 0), (11, 1), (5, 2)])
def test_synthetic_matches(seed, num_edits):
    """The port's corpus generator draws the same vocab, script, works
    and planted quotes as the original from the same seed."""
    out = []
    for mod in (synthetic, jsynthetic):
        rng = np.random.default_rng(seed)
        vocab = mod.make_vocab(rng, 800)
        text = mod.make_script(rng, vocab, num_lines=30, words_per_line=(6, 14))
        works, planted = mod.make_corpus_with_quotes(
            rng, [ln.text for ln in parse_script(text)], num_works=6,
            words_per_work=200, quotes_per_work=3, num_edits=num_edits,
            vocab=vocab,
        )
        out.append((vocab, text, works, [dataclasses.astuple(p) for p in planted],
                    rng.integers(1 << 30)))
    assert out[0] == out[1]


def _imported_modules(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py names no module of JAX or of fandom_search_tpu."""
    names = _imported_modules(ROOT / "chip_smoke.py")
    assert "fandom_search_tpu_torch.utils.synthetic" in names
    bad = {m for m in names
           if m.split(".")[0] in ("jax", "jaxlib", "fandom_search_tpu")}
    assert not bad, bad


def test_package_imports_without_jax():
    """With jax unimportable, the port and its engine, ops, CLI and corpus
    generator load, and of the JAX package only its jax-free config and
    scrape.clean are touched."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import fandom_search_tpu_torch\n"
        "import fandom_search_tpu_torch.search.engine\n"
        "import fandom_search_tpu_torch.search.oracle\n"
        "import fandom_search_tpu_torch.search.report\n"
        "import fandom_search_tpu_torch.ops.embed\n"
        "import fandom_search_tpu_torch.ops.distance_topk\n"
        "import fandom_search_tpu_torch.ops.scan\n"
        "import fandom_search_tpu_torch.ops.smith_waterman\n"
        "import fandom_search_tpu_torch.utils.synthetic\n"
        "import fandom_search_tpu_torch.cli\n"
        "from fandom_search_tpu_torch.cli import build_parser\n"
        "build_parser()\n"
        "import fandom_search_tpu.scrape.clean\n"
        "print(sorted(m for m in sys.modules if m.startswith('fandom_search_tpu.')))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    loaded = set(eval(res.stdout.strip().splitlines()[-1]))
    assert loaded <= {
        "fandom_search_tpu.config", "fandom_search_tpu.scrape",
        "fandom_search_tpu.scrape.clean",
    }, loaded
