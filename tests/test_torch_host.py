"""The port's host modules against the JAX package's originals.

Tolerance: 0.  Hashes, tokens, offsets, index arrays and match rows are
integers, strings or rounded floats computed by the same code, so every
comparison is exact (np.array_equal / ==).
"""

import ast
import dataclasses
import os
import re
import shutil
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
from fandom_search_tpu_torch.config import PipelineConfig as PortConfig
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
PCFG = PortConfig()
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
    cfg, pcfg = CFG.shingle, PCFG.shingle
    for t in (0, 5, 6, 400):
        toks = rng.integers(0, 2**32, size=t, dtype=np.uint64).astype(np.uint32)
        assert shingler.num_shingles(t, pcfg) == jshingler.num_shingles(t, cfg)
        assert np.array_equal(shingler.shingle_hashes(toks, pcfg),
                              jshingler.shingle_hashes(toks, cfg))
        assert np.array_equal(shingler.embed_shingles_np(toks, pcfg),
                              jshingler.embed_shingles_np(toks, cfg))


def test_build_script_index_and_carry_across(world):
    """The port builds identical arrays, and index_from_numpy carries a
    JAX-built index across unchanged (tokens re-derived identically)."""
    text, _ = world
    jidx = jbuild(jparse(text), CFG.shingle, CFG.search)
    pidx = build_script_index(parse_script(text), PCFG.shingle, PCFG.search)
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
    pparts = [(n, build_script_index(parse_script(t), PCFG.shingle, PCFG.search))
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
    got = chain_hits_arrays(*cols, wids, ptok, pidx, PCFG.shingle, PCFG.search)
    want = jchain(*cols, wids, jtok, jidx, CFG.shingle, CFG.search)
    assert got and [r.to_csv_row() for r in got] == [r.to_csv_row() for r in want]


def test_oracle_rows_match(world):
    text, works = world
    jidx = jbuild(jparse(text), CFG.shingle, CFG.search)
    got, gstats = search_works_oracle(works, index_from_numpy(jidx), PCFG)
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


@pytest.mark.parametrize("seed,zipf_a,num_edits", [(23, 1.01, 1), (3, 1.3, 0), (8, None, 2)])
def test_synthetic_zipf_matches(seed, zipf_a, num_edits):
    """With ``zipf_a`` (the skewed worlds of the bucketed prefilter), the
    port's generator draws the original's script, works, planted quotes
    and random text from the same seed."""
    out = []
    for mod in (synthetic, jsynthetic):
        rng = np.random.default_rng(seed)
        vocab = mod.make_vocab(rng, 3000)
        text = mod.make_script(rng, vocab, num_lines=40, words_per_line=(8, 17),
                               zipf_a=zipf_a)
        works, planted = mod.make_corpus_with_quotes(
            rng, [ln.text for ln in parse_script(text)], num_works=5,
            words_per_work=300, quotes_per_work=3, num_edits=num_edits,
            vocab=vocab, zipf_a=zipf_a,
        )
        out.append((text, works, [dataclasses.astuple(p) for p in planted],
                    mod.random_text(rng, vocab, 50, zipf_a=zipf_a),
                    mod.random_text(rng, vocab, 20), rng.integers(1 << 30)))
    assert out[0] == out[1]


PORT_FILES = sorted(
    str(f.relative_to(ROOT))
    for f in (ROOT / "fandom_search_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]


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


CARD_SCRIPTS = sorted(str(f.relative_to(ROOT)) for f in (ROOT / "scripts").glob("torch_*.py"))


@pytest.mark.parametrize("rel", CARD_SCRIPTS)
def test_card_script_imports_nothing_of_jax(rel):
    """The scripts that measure the port on the card (no JAX there) import
    neither JAX nor any module of the JAX package."""
    bad = {m for m in _imported_modules(ROOT / rel)
           if m.split(".")[0] in ("jax", "jaxlib", "fandom_search_tpu")}
    assert not bad, bad


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_nothing_of_jax(rel):
    """No file of the port, and not chip_smoke.py, imports JAX or any
    module of the JAX package."""
    bad = {m for m in _imported_modules(ROOT / rel)
           if m.split(".")[0] in ("jax", "jaxlib", "fandom_search_tpu")}
    assert not bad, bad


def test_package_imports_without_jax():
    """With jax and the JAX package unimportable, the port and its
    engine, ops (LSH and bucketed included), the stream encoder, the
    mesh and its exchange layer, the sharded engine and its bucketed
    prefilter, persistence, server, runner, report, heatmap, profiler,
    scraper and cleaner, reference pipeline, bench, CLI and corpus
    generator load, and no module of fandom_search_tpu is loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fandom_search_tpu'] = None\n"
        "import fandom_search_tpu_torch\n"
        "import fandom_search_tpu_torch.search.engine\n"
        "import fandom_search_tpu_torch.search.oracle\n"
        "import fandom_search_tpu_torch.search.report\n"
        "import fandom_search_tpu_torch.search.heatmap\n"
        "import fandom_search_tpu_torch.search.persist\n"
        "import fandom_search_tpu_torch.search.runner\n"
        "import fandom_search_tpu_torch.search.server\n"
        "import fandom_search_tpu_torch.utils.profiling\n"
        "import fandom_search_tpu_torch.ops.embed\n"
        "import fandom_search_tpu_torch.ops.distance_topk\n"
        "import fandom_search_tpu_torch.ops.scan\n"
        "import fandom_search_tpu_torch.ops.smith_waterman\n"
        "import fandom_search_tpu_torch.ops.lsh\n"
        "import fandom_search_tpu_torch.ops.bucketed\n"
        "import fandom_search_tpu_torch.search.vocab_stream\n"
        "import fandom_search_tpu_torch.parallel.mesh\n"
        "import fandom_search_tpu_torch.parallel.comm\n"
        "import fandom_search_tpu_torch.parallel.sharded\n"
        "import fandom_search_tpu_torch.parallel.sharded_bucketed\n"
        "import fandom_search_tpu_torch.scrape.clean\n"
        "import fandom_search_tpu_torch.scrape.ao3\n"
        "import fandom_search_tpu_torch.search.reference_pipeline\n"
        "import fandom_search_tpu_torch.utils.synthetic\n"
        "import fandom_search_tpu_torch.bench\n"
        "import fandom_search_tpu_torch.cli\n"
        "from fandom_search_tpu_torch.cli import build_parser\n"
        "build_parser()\n"
        "print(sorted(m for m in sys.modules if m.startswith('fandom_search_tpu.')))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert eval(res.stdout.strip().splitlines()[-1]) == []


def test_fastingest_copy_matches():
    """The port's native tokenizer source is the JAX package's, byte for
    byte."""
    port = ROOT / "fandom_search_tpu_torch" / "native" / "fastingest.cpp"
    assert port.read_bytes() == (ROOT / "fandom_search_tpu" / "native"
                                 / "fastingest.cpp").read_bytes()


# a path into the JAX package's tree: its name as a whole path component
_JAX_TREE = re.compile(r"(^|[/\\])fandom_search_tpu($|[/\\])")


def _code_strings(path):
    """String constants of a module outside its docstrings."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("rel", [p for p in PORT_FILES if p != "chip_smoke.py"])
def test_port_file_names_no_path_into_the_jax_package(rel):
    """No module of the port builds a path into fandom_search_tpu/ (the
    AST import guard cannot see a file read by path)."""
    bad = [v for v in _code_strings(ROOT / rel) if _JAX_TREE.search(v)]
    assert not bad, bad


def test_port_native_sources_include_nothing_of_the_jax_package():
    srcs = [f for ext in ("*.cu", "*.cuh", "*.cpp", "*.h")
            for f in (ROOT / "fandom_search_tpu_torch").rglob(ext)]
    assert any(f.name == "fastingest.cpp" for f in srcs)
    for f in srcs:
        for line in f.read_text(encoding="utf-8").splitlines():
            if line.lstrip().startswith("#include"):
                assert "fandom_search_tpu" not in line, (f, line)


def test_native_tokenizer_builds_from_the_port_alone(tmp_path):
    """A copy of the port with no JAX package beside it builds and loads
    its native tokenizer from its own source."""
    shutil.copytree(ROOT / "fandom_search_tpu_torch", tmp_path / "fandom_search_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fandom_search_tpu'] = None\n"
        "from fandom_search_tpu_torch.data import fast_tokenizer as f\n"
        "assert f.get_lib() is not None\n"
        "print(f._SRC)\n"
        "print(f.fast_tokenize('Hello, world').hashes.tolist())\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert res.returncode == 0, res.stderr
    src, hashes = res.stdout.strip().splitlines()[-2:]
    assert Path(src).resolve().is_relative_to(tmp_path.resolve())
    assert eval(hashes) == jtokenize("Hello, world").hashes.tolist()


CONFIG_CLASSES = ("ShingleConfig", "SearchConfig", "LSHConfig",
                  "BucketedConfig", "MeshConfig", "PipelineConfig")
# field values each class's __post_init__ refuses
BAD_CONFIGS = {
    "ShingleConfig": [dict(dim=64), dict(dim=0), dict(n=0)],
    "SearchConfig": [dict(sw_variant="slow"), dict(batch_queries=1 << 21),
                     dict(batch_queries=32)],
    "LSHConfig": [dict(bits=100)],
    "BucketedConfig": [dict(cap=0), dict(load_factor=0), dict(pairs="some")],
    "MeshConfig": [],
    "PipelineConfig": [],
}


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_copy_matches(name):
    """The port's config copy: same fields, defaults and validation
    errors as fandom_search_tpu.config, field by field."""
    from fandom_search_tpu import config as jconfig
    from fandom_search_tpu_torch import config as pconfig

    jcls, pcls = getattr(jconfig, name), getattr(pconfig, name)
    jf, pf = dataclasses.fields(jcls), dataclasses.fields(pcls)
    assert [(f.name, f.type) for f in pf] == [(f.name, f.type) for f in jf]
    assert pcls.__dataclass_params__.frozen and jcls.__dataclass_params__.frozen
    assert dataclasses.astuple(pcls()) == dataclasses.astuple(jcls())
    for bad in BAD_CONFIGS[name]:
        with pytest.raises(ValueError) as je:
            jcls(**bad)
        with pytest.raises(ValueError) as pe:
            pcls(**bad)
        assert str(pe.value) == str(je.value)
    if name == "MeshConfig":
        assert pcls(works=2, script=3).num_devices == 6


def test_load_works_dir_matches(tmp_path):
    """The port's load_works_dir copy reads .txt and .html works exactly
    as the original does (a .txt wins over an .html of the same id; a
    page without #workskin is dropped)."""
    from fandom_search_tpu.scrape.clean import load_works_dir as jload
    from fandom_search_tpu_torch.scrape.clean import load_works_dir

    page = (
        '<html><body><div id="workskin"><div class="preface">Title</div>'
        '<div class="userstuff"><p>First  line. </p><p></p>'
        '<p>Second line\u2014with a dash.</p></div>'
        '<div class="notes">a note</div></div></body></html>'
    )
    (tmp_path / "a.txt").write_text("Plain text work.\nTwo lines.", encoding="utf-8")
    (tmp_path / "b.html").write_text(page, encoding="utf-8")
    (tmp_path / "a.html").write_text(page, encoding="utf-8")
    (tmp_path / "broken.html").write_text("<html>error</html>", encoding="utf-8")
    (tmp_path / "c.txt").write_bytes(b"bad byte \xff here")
    got, want = load_works_dir(tmp_path), jload(tmp_path)
    assert got == want and set(got) == {"a", "b", "c"}
    assert "Second line" in got["b"] and "a note" not in got["b"]


def test_package_data_holds_every_source():
    """pyproject.toml's package data for the port lists every file the
    kernel build hashes and compiles (csrc/*.cu and the headers they
    include) and the tokenizer's source, so an installed wheel can build
    them."""
    import fnmatch
    import tomllib

    from fandom_search_tpu_torch.ops import _cuda

    with open(ROOT / "pyproject.toml", "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "fandom_search_tpu_torch"]
    pkg = ROOT / "fandom_search_tpu_torch"
    files = [f.relative_to(pkg).as_posix() for f in _cuda._sources()]
    files += [f.relative_to(pkg).as_posix() for f in (pkg / "native").glob("*.cpp")]
    assert any(f.endswith(".cuh") for f in files)
    missing = [f for f in files if not any(fnmatch.fnmatch(f, p) for p in patterns)]
    assert not missing, f"not in package data: {missing}"
