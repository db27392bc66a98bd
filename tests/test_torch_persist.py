"""The port's persistence, resumable runner and CLI verbs against the JAX package.

Tolerance: 0.  Index arrays, codes and configs compare exactly
(np.array_equal, dtypes included); the CLI outputs (matches CSV, matrix
CSV, heatmap HTML, Parquet) compare byte for byte with what the JAX
CLI writes with ``--cpu --no-pallas`` on the same inputs.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from fandom_search_tpu import cli as jcli
from fandom_search_tpu.config import PipelineConfig, SearchConfig
from fandom_search_tpu.data.script_parser import parse_script as jparse
from fandom_search_tpu.ops.lsh import LSHIndex as JLSHIndex
from fandom_search_tpu.search import persist as jpersist
from fandom_search_tpu.search.engine import SearchEngine as JaxEngine
from fandom_search_tpu.search.index import build_script_index as jbuild
from fandom_search_tpu.search.runner import ResumableRunner as JRunner
from fandom_search_tpu.utils import jit_cache
from fandom_search_tpu.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)
from fandom_search_tpu_torch import cli
from fandom_search_tpu_torch.config import PipelineConfig as PortConfig
from fandom_search_tpu_torch.config import SearchConfig as PortSearchConfig
from fandom_search_tpu_torch.ops.lsh import LSHIndex, attach_lsh_prefilter
from fandom_search_tpu_torch.search import persist
from fandom_search_tpu_torch.search.engine import SearchEngine
from fandom_search_tpu_torch.search.index import index_from_numpy
from fandom_search_tpu_torch.search.runner import ResumableRunner
from fandom_search_tpu_torch.utils.profiling import busy_share

# small device batches: the rows do not depend on the batch size, and the
# plain versions then stay cheap on a CPU shared with the suite's workers
BATCH = 4096
CFG = PipelineConfig(search=SearchConfig(batch_queries=BATCH))
PCFG = PortConfig(search=PortSearchConfig(batch_queries=BATCH))
FIELDS = ("stream_hashes", "token_line", "shingle_line", "shingle_anchor",
          "shingle_windows", "embeddings", "line_start", "line_lengths")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: these tests' tensors are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """The tests/test_persist_runner.py world: 15 lines, 9 works of 150
    words with one planted quote each."""
    rng = np.random.default_rng(31)
    vocab = make_vocab(rng, 900)
    lines = jparse(make_script(rng, vocab, num_lines=15))
    jidx = jbuild(lines, CFG.shingle, CFG.search)
    works, planted = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=9, words_per_work=150,
        quotes_per_work=1, vocab=vocab,
    )
    return jidx, index_from_numpy(jidx), works, planted


def _rows(rows):
    return [r.to_csv_row() for r in rows]


def _same_arrays(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_save_load_roundtrip_matches_jax(tmp_path, world):
    """Every array, dtype, line and config field of a port round trip
    equals a JAX save_index/load_index round trip; meta.json is the same
    bytes; the loaded index searches identically."""
    jidx, pidx, works, _ = world
    jpersist.save_index(jidx, CFG, tmp_path / "jax")
    persist.save_index(pidx, PCFG, tmp_path / "port")
    jback, jcfg = jpersist.load_index(tmp_path / "jax")
    pback, pcfg = persist.load_index(tmp_path / "port")
    _same_arrays(pback, jback)
    _same_arrays(pback, pidx)
    assert [(ln.line_no, ln.speaker, ln.text, ln.script) for ln in pback.lines] == [
        (ln.line_no, ln.speaker, ln.text, ln.script) for ln in jback.lines]
    assert [t.tokens for t in pback.tokenized] == [t.tokens for t in jback.tokenized]
    for name in ("shingle", "search", "lsh", "bucketed", "mesh"):
        assert dataclasses.astuple(getattr(pcfg, name)) == dataclasses.astuple(
            getattr(jcfg, name)), name
    assert ((tmp_path / "port" / "meta.json").read_bytes()
            == (tmp_path / "jax" / "meta.json").read_bytes())
    r1, _ = SearchEngine(pidx, PCFG, device="cpu").search_works(works)
    r2, _ = SearchEngine(pback, pcfg, device="cpu").search_works(works)
    assert r1 and _rows(r1) == _rows(r2)


def test_save_load_lsh_roundtrip_matches_jax(tmp_path, world):
    """Persisted codes equal the JAX package's (built and round-tripped),
    a config mismatch loads None, and a loaded index attaches to a loaded
    engine with the rows of an in-process build."""
    jidx, pidx, works, _ = world
    lcfg_j = dataclasses.replace(CFG.lsh, bits=256, rerank=128)
    lcfg = dataclasses.replace(PCFG.lsh, bits=256, rerank=128)
    pad = CFG.search.script_pad_multiple
    jl = JLSHIndex.build(jidx.embeddings, lcfg_j, CFG.shingle, pad_multiple=pad)
    jpersist.save_index(jidx, CFG, tmp_path / "jax")
    jpersist.save_lsh(tmp_path / "jax", jl, lcfg_j)
    jback = jpersist.load_lsh(tmp_path / "jax", lcfg_j)
    pl = LSHIndex.build(pidx.embeddings, lcfg, PCFG.shingle, pad_multiple=pad, device="cpu")
    persist.save_index(pidx, PCFG, tmp_path / "port")
    persist.save_lsh(tmp_path / "port", pl, lcfg)
    back = persist.load_lsh(tmp_path / "port", lcfg)
    codes = back.codes_t.numpy().view(np.uint32)
    assert codes.dtype == np.asarray(jback.codes_t).dtype == np.uint32
    assert np.array_equal(codes, np.asarray(jback.codes_t))
    assert np.array_equal(codes, np.asarray(jl.codes_t))
    assert np.array_equal(back.projection.numpy(), np.asarray(jback.projection))
    assert back.projection.dtype == torch.int8 and back.ns_valid == jback.ns_valid
    assert ((tmp_path / "port" / "lsh_meta.json").read_bytes()
            == (tmp_path / "jax" / "lsh_meta.json").read_bytes())
    assert persist.load_lsh(tmp_path / "port", dataclasses.replace(lcfg, bits=512)) is None
    assert persist.load_lsh(tmp_path / "nowhere", lcfg) is None

    index2, cfg2 = persist.load_index(tmp_path / "port")
    e_fresh = SearchEngine(pidx, PCFG, device="cpu")
    attach_lsh_prefilter(e_fresh, lcfg)
    e_loaded = SearchEngine(index2, cfg2, device="cpu")
    attach_lsh_prefilter(e_loaded, lcfg, lsh=back)
    r1, _ = e_fresh.search_works(works)
    r2, _ = e_loaded.search_works(works)
    assert r1 and _rows(r1) == _rows(r2)
    bad = LSHIndex(projection=back.projection, codes_t=back.codes_t[:, :-512],
                   ns_valid=back.ns_valid)
    with pytest.raises(ValueError, match="does not match"):
        attach_lsh_prefilter(SearchEngine(pidx, PCFG, device="cpu"), lcfg, lsh=bad)


def test_jax_written_and_stale_dirs_refused(tmp_path, world):
    """A directory the JAX package wrote (orbax arrays/, no arrays.npz)
    is refused with the message to re-run the port's index; so is its
    LSH checkpoint, and an index of another format version."""
    jidx, pidx, _, _ = world
    jpersist.save_index(jidx, CFG, tmp_path / "jax")
    jl = JLSHIndex.build(jidx.embeddings, CFG.lsh, CFG.shingle,
                         pad_multiple=CFG.search.script_pad_multiple)
    jpersist.save_lsh(tmp_path / "jax", jl, CFG.lsh)
    with pytest.raises(ValueError, match=r"orbax checkpoint \(arrays/\).*re-run "
                                         r"`python -m fandom_search_tpu_torch index`"):
        persist.load_index(tmp_path / "jax")
    with pytest.raises(ValueError, match="lsh_arrays/"):
        persist.load_lsh(tmp_path / "jax", PCFG.lsh)
    persist.save_index(pidx, PCFG, tmp_path / "old")
    meta = json.loads((tmp_path / "old" / "meta.json").read_text())
    meta["version"] = 2
    (tmp_path / "old" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="format v2"):
        persist.load_index(tmp_path / "old")


def test_resumable_runner_matches_jax(tmp_path, world):
    """Unit CSVs equal the JAX runner's byte for byte; complete units
    resume without an engine call; a deleted unit alone reruns."""
    jidx, pidx, works, _ = world
    JRunner(JaxEngine(jidx, CFG, use_pallas=False), tmp_path / "jax", unit_size=3).run(works)
    eng = SearchEngine(pidx, PCFG, device="cpu")
    direct, _ = eng.search_works(works)
    out = tmp_path / "port"
    rows = ResumableRunner(eng, out, unit_size=3).run(works)
    assert _rows(rows) == _rows(direct)
    manifest = json.loads((out / "manifest.json").read_text())
    assert sorted(manifest["units"]) == ["00000", "00001", "00002"]
    for u in manifest["units"]:
        assert ((out / f"unit_{u}.csv").read_bytes()
                == (tmp_path / "jax" / f"unit_{u}.csv").read_bytes())

    calls = []
    orig = eng.search_works
    eng.search_works = lambda w: calls.append(len(w)) or orig(w)
    assert _rows(ResumableRunner(eng, out, unit_size=3).run(works)) == _rows(direct)
    assert calls == []
    (out / "unit_00001.csv").unlink()
    runner = ResumableRunner(eng, out, unit_size=3)
    runner.manifest["units"]["00001"]["done"] = False
    assert _rows(runner.run(works)) == _rows(direct)
    assert calls == [3]
    summary = runner.stats_summary()
    assert summary["units"] == 3 and summary["works"] == len(works)
    assert summary["rows"] == len(direct) and summary["verified"] > 0


def test_resumable_runner_detects_corpus_change(tmp_path, world):
    """A work id that sorts into a finished unit shifts membership: the
    stale units recompute and no new work is missed."""
    _, pidx, works, _ = world
    eng = SearchEngine(pidx, PCFG, device="cpu")
    out = tmp_path / "run_grow"
    some = dict(list(sorted(works.items()))[:6])
    ResumableRunner(eng, out, unit_size=3).run(some)
    grown = dict(some)
    first_id = sorted(some)[0]
    grown["a_" + first_id] = some[first_id]
    rows = ResumableRunner(eng, out, unit_size=3).run(grown)
    direct, _ = eng.search_works(grown)
    assert sorted(_rows(rows)) == sorted(_rows(direct))
    assert any(r.work_id == "a_" + first_id for r in rows)


# ---- the CLI verbs, port against the JAX CLI ------------------------------


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """Two script files and a works dir with quotes of both (the shapes
    of tests/test_persist_runner.py's CLI tests, with more works)."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(6)
    vocab = make_vocab(rng, 700)
    scripts, dialogue = [], []
    for name in ("ep1", "ep2"):
        text = make_script(rng, vocab, num_lines=10, words_per_line=(7, 12))
        (root / f"{name}.txt").write_text(text, encoding="utf-8")
        scripts.append(str(root / f"{name}.txt"))
        dialogue += [ln.text for ln in jparse(text)]
    works, _ = make_corpus_with_quotes(
        rng, dialogue, num_works=10, words_per_work=200, quotes_per_work=2,
        num_edits=1, vocab=vocab,
    )
    wdir = root / "works"
    wdir.mkdir()
    for wid, text in works.items():
        (wdir / f"{wid}.txt").write_text(text, encoding="utf-8")
    return root, scripts, wdir


@pytest.fixture
def no_jax_cache(monkeypatch):
    """The JAX CLI turns on jax's persistent compilation cache; keep this
    test process's jax config as it was."""
    monkeypatch.setattr(jit_cache, "enable_persistent_cache", lambda *a, **k: None)


def _run(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1]) if out else None


def _flows(tmp_path, scripts, wdir, capsys, search_extra=(), out_name="m.csv"):
    """index -> search --index -> matrix --html through both CLIs; returns
    {"jax": (dir, manifest), "port": (dir, manifest)}."""
    res = {}
    for who, main, dev in (("jax", jcli.main, ["--cpu"]),
                           ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / who
        _run(main, ["index", *scripts, "-o", str(d / "idx"), *dev], capsys)
        search_dev = dev + ["--batch-queries", str(BATCH)] + (
            ["--no-pallas"] if who == "jax" else [])
        man = _run(main, ["search", str(wdir), "--index", str(d / "idx"),
                          "-o", str(d / out_name), *search_dev, *search_extra], capsys)
        res[who] = (d, man)
    return res


@pytest.mark.parametrize("multi", [False, True])
def test_cli_index_search_matrix_bytes_match_jax(tmp_path, cli_inputs, capsys,
                                                 no_jax_cache, multi):
    """Single- and multi-script: matches CSV, matrix CSV and heatmap HTML
    are the JAX CLI's bytes; the multi-script rows carry both scripts."""
    _, scripts, wdir = cli_inputs
    scripts = scripts if multi else scripts[:1]
    res = _flows(tmp_path, scripts, wdir, capsys)
    for who, main in (("jax", jcli.main), ("port", cli.main)):
        d = res[who][0]
        assert main(["matrix", str(d / "m.csv"), "-o", str(d / "x.csv"),
                     "--script", *scripts, "--html", str(d / "h.html"),
                     "--title", "Ep & co"]) == 0
    (jd, jman), (pd_, pman) = res["jax"], res["port"]
    for name in ("m.csv", "x.csv", "h.html"):
        assert (pd_ / name).read_bytes() == (jd / name).read_bytes(), name
    assert pman["matches"] == jman["matches"] > 0
    assert pman["script_shingles"] == jman["script_shingles"]
    text = (pd_ / "m.csv").read_text(encoding="utf-8")
    if multi:
        assert ",ep1\n" in text and ",ep2\n" in text
    # the rows equal a search straight from the script files
    _run(cli.main, ["search", str(wdir), *scripts, "-o", str(tmp_path / "direct.csv"),
                    "--device", "cpu", "--batch-queries", str(BATCH)], capsys)
    assert (tmp_path / "direct.csv").read_bytes() == (pd_ / "m.csv").read_bytes()


def test_cli_resume_dir_matches_jax(tmp_path, cli_inputs, capsys, no_jax_cache,
                                    monkeypatch):
    """--resume-dir: the same CSV bytes as the JAX CLI on a first run, a
    resumed run that searches nothing, and a grown corpus."""
    _, scripts, wdir = cli_inputs
    for main, who in ((jcli.main, "jax"), (cli.main, "port")):
        assert main(["index", scripts[0], "-o", str(tmp_path / who / "idx")]) == 0
    calls = []
    orig = SearchEngine.search_works
    monkeypatch.setattr(SearchEngine, "search_works",
                        lambda self, w: calls.append(len(w)) or orig(self, w))
    grown = tmp_path / "grown"
    grown.mkdir()
    for f in wdir.iterdir():
        (grown / f.name).write_bytes(f.read_bytes())
    first = sorted(wdir.iterdir())[0]
    (grown / f"a_{first.name}").write_bytes(first.read_bytes())
    for step, works_dir in (("first", wdir), ("resumed", wdir), ("grown", grown)):
        for who, main, dev in (("jax", jcli.main, ["--cpu", "--no-pallas"]),
                               ("port", cli.main, ["--device", "cpu"])):
            d = tmp_path / who
            man = _run(main, ["search", str(works_dir), "--index", str(d / "idx"),
                              "-o", str(d / f"{step}.csv"), *dev,
                              "--batch-queries", str(BATCH),
                              "--resume-dir", str(d / "units")], capsys)
            assert man["stats"]["resumable"] and man["stats"]["units"] == 1
        for name in (f"{step}.csv", "units/unit_00000.csv"):
            assert ((tmp_path / "port" / name).read_bytes()
                    == (tmp_path / "jax" / name).read_bytes()), (step, name)
        n = len(list(works_dir.iterdir()))
        assert calls == {"first": [n], "resumed": [], "grown": [n]}[step], step
        calls.clear()
    assert ((tmp_path / "port" / "first.csv").read_bytes()
            == (tmp_path / "port" / "resumed.csv").read_bytes())


def test_cli_parquet_and_selfcheck_match_jax(tmp_path, cli_inputs, capsys, no_jax_cache):
    """--parquet writes the JAX CLI's file, and --selfcheck reports the
    same agreement block (1.0: the engine equals the oracle)."""
    pd = pytest.importorskip("pandas")
    _, scripts, wdir = cli_inputs
    res = _flows(tmp_path, scripts, wdir, capsys, out_name="m.parquet",
                 search_extra=("--parquet", "--selfcheck", "4"))
    (jd, jman), (pd_, pman) = res["jax"], res["port"]
    pd.testing.assert_frame_equal(pd.read_parquet(pd_ / "m.parquet"),
                                  pd.read_parquet(jd / "m.parquet"))
    assert (pd_ / "m.parquet").read_bytes() == (jd / "m.parquet").read_bytes()
    assert pman["selfcheck"] == jman["selfcheck"]
    assert pman["selfcheck"]["agreement"] == 1.0 and pman["selfcheck"]["works"] == 4


def test_cli_index_lsh_and_search_index_lsh(tmp_path, cli_inputs, capsys, no_jax_cache):
    """index --lsh writes the JAX package's codes; search --index --lsh
    loads them and writes the JAX CLI's CSV; --oracle and --profile run."""
    _, scripts, wdir = cli_inputs
    jcli.main(["index", scripts[0], "-o", str(tmp_path / "jlsh"), "--cpu", "--lsh"])
    cli.main(["index", scripts[0], "-o", str(tmp_path / "plsh"), "--device", "cpu", "--lsh"])
    capsys.readouterr()
    jl = jpersist.load_lsh(tmp_path / "jlsh", CFG.lsh)
    pl = persist.load_lsh(tmp_path / "plsh", PCFG.lsh)
    assert np.array_equal(pl.codes_t.numpy().view(np.uint32), np.asarray(jl.codes_t))
    for who, main, dev in (("jax", jcli.main, ["--cpu", "--no-pallas"]),
                           ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / ("jlsh" if who == "jax" else "plsh")
        man = _run(main, ["search", str(wdir), "--index", str(d), "-o", str(d / "m.csv"),
                          "--lsh", "--batch-queries", str(BATCH), *dev], capsys)
        assert man["matches"] > 0
    assert ((tmp_path / "plsh" / "m.csv").read_bytes()
            == (tmp_path / "jlsh" / "m.csv").read_bytes())
    man = _run(cli.main, ["search", str(wdir), "--index", str(tmp_path / "plsh"),
                          "-o", str(tmp_path / "o.csv"), "--oracle"], capsys)
    assert man["device"] == "cpu" and man["matches"] > 0
    man = _run(cli.main, ["search", str(wdir), scripts[0], "-o", str(tmp_path / "p.csv"),
                          "--device", "cpu", "--batch-queries", str(BATCH),
                          "--profile", str(tmp_path / "prof")], capsys)
    share = busy_share(tmp_path / "prof" / "trace.json")
    assert man["matches"] > 0 and share["wall_ms"] > 0
    assert share["kernels"] == 0 and share["busy_share"] == 0.0  # no device on the CPU
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "o.csv").read_bytes()


def test_cli_shingle_dim_matches_jax(tmp_path, cli_inputs, capsys, no_jax_cache):
    """--shingle-dim 256 behaves as the JAX CLI's: the index stores dim
    256 (meta.json bytes equal), search --index writes the JAX CLI's CSV
    bytes, a --shingle-dim laid over a loaded index is ignored with the
    same warning, and a search from the script files at dim 256 finds
    the same rows."""
    _, scripts, wdir = cli_inputs
    out = {}
    for who, main, dev in (("jax", jcli.main, ["--cpu"]),
                           ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / who
        assert main(["index", scripts[0], "-o", str(d / "idx"), "--shingle-dim", "256",
                     *dev]) == 0
        capsys.readouterr()
        search_dev = dev + ["--batch-queries", str(BATCH)] + (
            ["--no-pallas"] if who == "jax" else [])
        assert main(["search", str(wdir), "--index", str(d / "idx"), "-o", str(d / "m.csv"),
                     "--shingle-dim", "128", *search_dev]) == 0
        cap = capsys.readouterr()
        out[who] = (json.loads(cap.out.strip().splitlines()[-1]),
                    [ln for ln in cap.err.splitlines() if "--shingle-dim" in ln])
    jd, pd_ = tmp_path / "jax", tmp_path / "port"
    assert (pd_ / "idx" / "meta.json").read_bytes() == (jd / "idx" / "meta.json").read_bytes()
    assert json.loads((pd_ / "idx" / "meta.json").read_text())["shingle"]["dim"] == 256
    assert (pd_ / "m.csv").read_bytes() == (jd / "m.csv").read_bytes()
    assert out["port"][0]["matches"] == out["jax"][0]["matches"] > 0
    assert out["port"][1] == out["jax"][1] == [
        "warning: --shingle-dim 128 ignored; the loaded index was built with dim=256"]
    _run(cli.main, ["search", str(wdir), scripts[0], "-o", str(tmp_path / "direct.csv"),
                    "--device", "cpu", "--batch-queries", str(BATCH), "--shingle-dim", "256"],
         capsys)
    assert (tmp_path / "direct.csv").read_bytes() == (pd_ / "m.csv").read_bytes()


def test_cli_overlay_and_errors(tmp_path, cli_inputs, capsys, monkeypatch):
    """Flags laid over a loaded index behave as the JAX CLI's; a missing
    script and a missing card are refused."""
    from types import SimpleNamespace

    _, scripts, wdir = cli_inputs
    cli.main(["index", scripts[0], "-o", str(tmp_path / "idx"), "--k", "4"])
    _, cfg = persist.load_index(tmp_path / "idx")
    assert cfg.search.k == 4
    flags = dict(shingle_n=5, k=7, candidate_threshold=4.0, verify_threshold=None,
                 chain_gap=3, batch_queries=None, lookahead_batches=2,
                 sw_variant="fast")
    jflags = dict(flags, stream_compress=None, shingle_dim=None, mesh=None,
                  shards=None, bucketed_pairs=None)
    _, jcfg = jpersist.load_index(_jax_index(tmp_path, scripts[0]))
    got = cli._overlay_runtime(cfg, SimpleNamespace(**flags))
    want = jcli._overlay_runtime(jcfg, SimpleNamespace(**jflags))
    assert dataclasses.astuple(got.search) == dataclasses.astuple(want.search)
    assert got.shingle.n == 6 and "--shingle-n 5 ignored" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        cli.main(["search", str(wdir), "-o", str(tmp_path / "x.csv"), "--device", "cpu"])
    assert e.value.code == 2 and "provide script file(s) or --index" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["search", str(wdir), "--index", str(tmp_path / "idx"), "-o",
                  str(tmp_path / "y.csv")],
                 ["serve", "--index", str(tmp_path / "idx")],
                 ["index", scripts[0], "-o", str(tmp_path / "i2"), "--lsh"]):
        with pytest.raises(SystemExit):
            cli.main(argv)
        assert "CUDA is not available" in capsys.readouterr().err


def _jax_index(tmp_path, script):
    d = tmp_path / "jidx"
    lines = jparse(open(script, encoding="utf-8").read())
    jpersist.save_index(jbuild(lines, CFG.shingle, CFG.search),
                        PipelineConfig(search=SearchConfig(k=4)), d)
    return d
