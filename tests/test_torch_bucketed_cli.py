"""The port's `index --bucketed` and `search --bucketed` against the JAX CLI.

Tolerance: 0.  The CLIs' CSV and JSON files and the saved tables compare
byte for byte and element by element; the JAX side searches with
``--no-pallas`` (its jnp twins of the kernels), on which the rows do not
depend.  The world is a script with a stopword-led half, so the hybrid
runs.
"""

import json

import numpy as np
import pytest
import torch

from fandom_search_tpu import cli as jcli
from fandom_search_tpu.config import BucketedConfig
from fandom_search_tpu.data.script_parser import parse_script
from fandom_search_tpu.search import persist as jpersist
from fandom_search_tpu.utils import jit_cache
from fandom_search_tpu.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)
from fandom_search_tpu_torch import cli
from fandom_search_tpu_torch.config import BucketedConfig as PortBucketedConfig
from fandom_search_tpu_torch.search import persist

BATCH = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_jax_cache(monkeypatch):
    """The JAX CLI turns on jax's persistent compilation cache; keep this
    test process's jax config as it was."""
    monkeypatch.setattr(jit_cache, "enable_persistent_cache", lambda *a, **k: None)


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """A script with a stopword-led half (hot pair-buckets: the hybrid
    runs) and a works dir quoting it."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(8)
    vocab = make_vocab(rng, 700)
    text = make_script(rng, vocab, num_lines=12, words_per_line=(7, 12))
    text += "\n" + "\n".join(
        "BOB: of the of the " + " ".join(rng.choice(vocab, size=6).tolist())
        for _ in range(12))
    (root / "script.txt").write_text(text, encoding="utf-8")
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in parse_script(text)], num_works=10,
        words_per_work=200, quotes_per_work=2, num_edits=1, vocab=vocab,
    )
    wdir = root / "works"
    wdir.mkdir()
    for wid, t in works.items():
        (wdir / f"{wid}.txt").write_text(t, encoding="utf-8")
    return root / "script.txt", wdir


def _run(main, argv, capsys):
    assert main(argv) == 0
    cap = capsys.readouterr()
    out = cap.out.strip().splitlines()
    return (json.loads(out[-1]) if out else None), cap.err


def test_cli_index_and_search_bucketed_bytes_match_jax(tmp_path, cli_inputs, capsys,
                                                       no_jax_cache):
    """`index --bucketed --bucketed-pairs all` writes the JAX CLI's
    meta.json and bucketed_meta.json and the same tables;
    `search --index --bucketed` writes its CSV; a search from the script
    file with --bucketed writes the same; tables asked for with other
    pairs are refused with the JAX package's warning."""
    script, wdir = cli_inputs
    runs = {}
    for who, main, dev in (("jax", jcli.main, ["--cpu"]),
                           ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / who
        _, err = _run(main, ["index", str(script), "-o", str(d / "idx"), "--bucketed",
                             "--bucketed-pairs", "all", *dev], capsys)
        assert "saved bucketed tables" in err
        sdev = dev + ["--batch-queries", str(BATCH)] + (
            ["--no-pallas"] if who == "jax" else [])
        man, _ = _run(main, ["search", str(wdir), "--index", str(d / "idx"),
                             "-o", str(d / "m.csv"), "--bucketed", *sdev], capsys)
        load = jpersist.load_bucketed if who == "jax" else persist.load_bucketed
        cfg = BucketedConfig() if who == "jax" else PortBucketedConfig()
        assert load(d / "idx", cfg) is None
        runs[who] = (d, man, capsys.readouterr().err.replace(str(d), "DIR"))
    (jd, jman, jwarn), (pd_, pman, pwarn) = runs["jax"], runs["port"]
    for name in ("idx/meta.json", "idx/bucketed_meta.json", "m.csv"):
        assert (pd_ / name).read_bytes() == (jd / name).read_bytes(), name
    assert pman["matches"] == jman["matches"] > 0
    assert pwarn == jwarn and pwarn.startswith("warning: persisted bucketed tables at DIR")
    jt = jpersist.load_bucketed(jd / "idx", BucketedConfig(pairs="all"))
    pt = persist.load_bucketed(pd_ / "idx", PortBucketedConfig(pairs="all"))
    assert np.array_equal(pt.entries.numpy(), np.asarray(jt.entries))
    assert np.array_equal(pt.offsets.numpy(), np.asarray(jt.offsets))
    assert pt.overflow_frac == jt.overflow_frac > 0
    man, _ = _run(cli.main, ["search", str(wdir), str(script), "-o", str(tmp_path / "d.csv"),
                             "--bucketed", "--bucketed-pairs", "all", "--device", "cpu",
                             "--batch-queries", str(BATCH)], capsys)
    assert (tmp_path / "d.csv").read_bytes() == (pd_ / "m.csv").read_bytes()
    assert man["stats"]["extra"]["bucketed_risk_frac"] > 0


def test_cli_lsh_and_bucketed_exclusive(tmp_path, cli_inputs, capsys, no_jax_cache):
    script, wdir = cli_inputs
    msgs = []
    for main, dev in ((jcli.main, ["--cpu", "--no-pallas"]), (cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(["search", str(wdir), str(script), "-o", str(tmp_path / "x.csv"),
                  "--lsh", "--bucketed", *dev])
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] == "error: --lsh and --bucketed are exclusive"
    assert not (tmp_path / "x.csv").exists()


def test_cli_bucketed_still_needs_cuda(tmp_path, cli_inputs, monkeypatch, capsys):
    script, wdir = cli_inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["search", str(wdir), str(script), "-o", str(tmp_path / "x.csv"),
                  "--bucketed"],
                 ["index", str(script), "-o", str(tmp_path / "i"), "--bucketed"]):
        with pytest.raises(SystemExit):
            cli.main(argv)
        assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "x.csv").exists()
    assert not (tmp_path / "i" / "bucketed_meta.json").exists()
