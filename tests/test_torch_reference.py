"""The port's reference-style pipeline (``search --reference``) and ``format`` against the JAX package.

Tolerance: 0, seconds excepted.  ``ReferenceSearch``'s MatchRows compare
field by field (rounded scores included) and its stats field by field
but for ``seconds_query`` and ``seconds_verify``, which time the host;
the CLI's CSVs compare byte for byte with the JAX CLI's.  The cases are
tests/test_reference_pipeline.py's worlds.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from fandom_search_tpu import cli as jcli
from fandom_search_tpu.config import PipelineConfig
from fandom_search_tpu.data.fast_tokenizer import tokenize_many as jtokenize_many
from fandom_search_tpu.data.script_parser import parse_script as jparse
from fandom_search_tpu.search import reference_pipeline as jref
from fandom_search_tpu.utils import jit_cache
from fandom_search_tpu.utils.synthetic import make_corpus_with_quotes, make_script, make_vocab
from fandom_search_tpu_torch import cli
from fandom_search_tpu_torch.config import PipelineConfig as PortConfig
from fandom_search_tpu_torch.data.fast_tokenizer import tokenize_many
from fandom_search_tpu_torch.data.script_parser import parse_script
from fandom_search_tpu_torch.search import reference_pipeline as ref

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
CFG, PCFG = PipelineConfig(), PortConfig()
TIMES = ("seconds_query", "seconds_verify")


def _planted(seed):
    """tests/test_reference_pipeline.py's planted-quote world."""
    rng = np.random.default_rng(seed)
    vocab = make_vocab(rng, 1200)
    text = make_script(rng, vocab, num_lines=20, words_per_line=(7, 12))
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in jparse(text)], num_works=8, words_per_work=250,
        quotes_per_work=1, vocab=vocab)
    return text, works


def _noise():
    """tests/test_reference_pipeline.py's noise world: words over an
    alphabet the script's vocabulary never uses."""
    rng = np.random.default_rng(42)
    vocab = make_vocab(rng, 1200)
    text = make_script(rng, vocab, num_lines=15)
    noise_rng = np.random.default_rng(999)
    noise_vocab = ["".join("xy"[b] for b in noise_rng.integers(0, 2, int(n)))
                   for n in noise_rng.integers(4, 12, 800)]
    noise = " ".join(noise_vocab[i] for i in rng.integers(0, len(noise_vocab), 400))
    return text, {"noise": noise}


WORLDS = {
    "planted42": lambda: _planted(42),
    "planted7": lambda: _planted(7),
    "noise": _noise,
    "examples": lambda: ((EXAMPLES / "script.txt").read_text(encoding="utf-8"),
                         {p.stem: p.read_text(encoding="utf-8")
                          for p in sorted((EXAMPLES / "fanworks").glob("*.txt"))}),
    # no shingle in the script: no tree, no rows
    "tiny_script": lambda: ("ALICE: hi there", {"w": "hi there you"}),
}


def _stats(stats):
    return {k: v for k, v in dataclasses.asdict(stats).items() if k not in TIMES}


@pytest.mark.parametrize("name", sorted(WORLDS))
@pytest.mark.parametrize("tokenized", [False, True])
def test_reference_search_matches_jax(name, tokenized):
    text, works = WORLDS[name]()
    jworks = works
    if tokenized:
        works, jworks = tokenize_many(works), jtokenize_many(works)
    rows, stats = ref.ReferenceSearch(parse_script(text), PCFG).search_works(works)
    jrows, jstats = jref.ReferenceSearch(jparse(text), CFG).search_works(jworks)
    assert [r.to_csv_row() for r in rows] == [r.to_csv_row() for r in jrows]
    assert _stats(stats) == _stats(jstats)
    if name.startswith("planted"):
        assert rows and stats.num_verified > 0
    if name in ("noise", "tiny_script"):
        assert rows == []


def test_points_match(rng):
    h = rng.integers(0, 2**32, size=300, dtype=np.uint64).astype(np.uint32)
    for n in (1, 6, 300, 301):
        a, b = ref._points(h, n), jref._points(h, n)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ref._COORD_MOD == jref._COORD_MOD


def _synthetic_dir(root: Path):
    """The planted world of seed 42 as a works dir and a script file."""
    text, works = _planted(42)
    (root / "works").mkdir(parents=True)
    for w, t in works.items():
        (root / "works" / f"{w}.txt").write_text(t, encoding="utf-8")
    (root / "script.txt").write_text(text, encoding="utf-8")
    return root / "works", root / "script.txt"


@pytest.fixture
def no_jax_cache(monkeypatch):
    monkeypatch.setattr(jit_cache, "enable_persistent_cache", lambda *a, **k: None)


@pytest.mark.parametrize("inputs", ["examples", "synthetic", "index"])
def test_cli_search_reference_matches_jax(tmp_path, capsys, no_jax_cache, inputs):
    """`search --reference` (host only: no --device needed) writes the JAX
    CLI's CSV, from script files or from a persisted index."""
    if inputs == "examples":
        works, script = EXAMPLES / "fanworks", EXAMPLES / "script.txt"
    else:
        works, script = _synthetic_dir(tmp_path / "w")
    src = [str(script)]
    if inputs == "index":
        assert cli.main(["index", str(script), "-o", str(tmp_path / "idx"),
                         "--device", "cpu"]) == 0
        src = ["--index", str(tmp_path / "idx")]
    assert cli.main(["search", str(works), *src, "-o", str(tmp_path / "p.csv"),
                     "--reference"]) == 0
    assert jcli.main(["search", str(works), str(script), "-o", str(tmp_path / "j.csv"),
                      "--reference", "--cpu"]) == 0
    got = (tmp_path / "p.csv").read_bytes()
    assert got == (tmp_path / "j.csv").read_bytes() and got.count(b"\n") > 1
    capsys.readouterr()


@pytest.mark.parametrize("script", ["examples", "tagged"])
def test_cli_format_matches_jax(tmp_path, capsys, script):
    if script == "examples":
        path = EXAMPLES / "script.txt"
    else:
        rng = np.random.default_rng(5)
        path = tmp_path / "s.txt"
        path.write_text(make_script(rng, make_vocab(rng, 300), num_lines=30), encoding="utf-8")
    assert cli.main(["format", str(path), "-o", str(tmp_path / "p.csv")]) == 0
    perr = capsys.readouterr().err
    assert jcli.main(["format", str(path), "-o", str(tmp_path / "j.csv")]) == 0
    assert perr == capsys.readouterr().err and "parsed" in perr
    got = (tmp_path / "p.csv").read_bytes()
    assert got == (tmp_path / "j.csv").read_bytes() and got.count(b"\n") > 10


def test_serve_refuses_reference(capsys):
    assert cli.main(["serve", str(EXAMPLES / "script.txt"), "--reference"]) == 2
    assert "no --oracle/--reference" in capsys.readouterr().err
