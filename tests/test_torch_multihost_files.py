"""Files that every rank of a ``--multihost`` run writes: ``index -o`` and ``--resume-dir``.

Two gloo ranks (subprocesses on the loopback address) run the port's
CLI on one shared directory.  ``index --multihost``: both ranks write
the same index, which then loads and searches to the JAX CLI's CSV.
``search --multihost --resume-dir``: both ranks write the same units
and manifest; each rank's CSV equals the JAX CLI's.  The rename race
behind the second is also staged in one process: the JAX runner's
shared temporary name loses it (a fault of the reference, left as it
is); the port's per-rank names do not.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from fandom_search_tpu import cli as jcli
from fandom_search_tpu.search import runner as jrunner
from fandom_search_tpu.utils import jit_cache
from fandom_search_tpu_torch.data.script_parser import parse_script
from fandom_search_tpu_torch.search import runner
from fandom_search_tpu_torch.search.persist import load_index
from fandom_search_tpu_torch.utils.synthetic import (
    make_corpus_with_quotes, make_script, make_vocab,
)

ROOT = Path(__file__).resolve().parent.parent
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
TIMEOUT_S = 240
# works: three resume units of 256 (the CLI's unit size), the last partial
NUM_WORKS = 520


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(root: Path, argv, ranks: int = 2):
    """``argv`` + the multihost flags on every rank, run to the end."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fandom_search_tpu_torch", *[a.format(r=r) for a in argv],
         "--device", "cpu", "--multihost", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(ranks), "--process-id", str(r)],
        env=ENV, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(ranks)]
    try:
        res = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, res):
        assert p.returncode == 0, err[-3000:]
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A script and NUM_WORKS short works on disk, and the JAX CLI's CSV
    of their search (one process, a 2 x 1 mesh of virtual CPU devices)."""
    root = tmp_path_factory.mktemp("multihost_files")
    rng = np.random.default_rng(31)
    vocab = make_vocab(rng, 1200)
    text = make_script(rng, vocab, num_lines=20, words_per_line=(7, 12))
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in parse_script(text)], num_works=NUM_WORKS,
        words_per_work=60, quotes_per_work=1, num_edits=0, vocab=vocab)
    (root / "works").mkdir()
    for w, t in works.items():
        (root / "works" / f"{w}.txt").write_text(t, encoding="utf-8")
    (root / "script.txt").write_text(text, encoding="utf-8")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jit_cache, "enable_persistent_cache", lambda *a, **k: None)
        assert jcli.main(["search", str(root / "works"), str(root / "script.txt"),
                          "-o", str(root / "jax.csv"), "--cpu", "--no-pallas",
                          "--mesh", "2x1", "--batch-queries", "4096"]) == 0
    return root, (root / "jax.csv").read_bytes()


def test_index_multihost_then_search_index(world):
    """Both ranks write the one index directory; it holds what one
    process writes, and `search --index` on it gives the JAX CLI's CSV."""
    root, jax_csv = world
    _ranks(root, ["index", "script.txt", "-o", "idx"])
    subprocess.run([sys.executable, "-m", "fandom_search_tpu_torch", "index",
                    "script.txt", "-o", "one", "--device", "cpu"],
                   env=ENV, cwd=root, check=True, capture_output=True, timeout=TIMEOUT_S)
    assert sorted(os.listdir(root / "idx")) == ["arrays.npz", "meta.json"]
    assert (root / "idx" / "meta.json").read_bytes() == (root / "one" / "meta.json").read_bytes()
    got, want = load_index(root / "idx")[0], load_index(root / "one")[0]
    for name in ("stream_hashes", "shingle_windows", "embeddings", "line_start"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    r = subprocess.run([sys.executable, "-m", "fandom_search_tpu_torch", "search", "works",
                        "--index", "idx", "-o", "from_index.csv", "--device", "cpu",
                        "--batch-queries", "4096"],
                       env=ENV, cwd=root, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    assert (root / "from_index.csv").read_bytes() == jax_csv


def test_resume_dir_multihost(world):
    """Both ranks run every unit into one --resume-dir and finish: each
    rank's CSV equals the JAX CLI's, every unit is recorded done and no
    temporary file is left."""
    root, jax_csv = world
    _ranks(root, ["search", "works", "script.txt", "-o", "r{r}.csv", "--mesh", "2x1",
                  "--batch-queries", "4096", "--resume-dir", "resume"])
    for r in range(2):
        assert (root / f"r{r}.csv").read_bytes() == jax_csv, f"rank {r}"
    units = -(-NUM_WORKS // 256)
    assert sorted(os.listdir(root / "resume")) == ["manifest.json"] + [
        f"unit_{i:05d}.csv" for i in range(units)]
    manifest = json.loads((root / "resume" / "manifest.json").read_text())
    assert sorted(manifest["units"]) == [f"{i:05d}" for i in range(units)]
    assert all(u["done"] for u in manifest["units"].values())


class _Engine:
    """A search that finds nothing, with the stats both runners record."""

    def search_works(self, works):
        return [], SimpleNamespace(num_query_shingles=0, num_candidates=0, num_verified=0,
                                   seconds_device_topk=0.0, seconds_device_verify=0.0,
                                   seconds_host=0.0)


def _interleaved(mod, first, second, monkeypatch):
    """``first`` runs a unit; between writing its CSV and renaming it,
    ``second`` runs the same unit into the same directory to the end."""
    real = mod.write_matches_csv
    calls = []

    def write(rows, path):
        real(rows, path)
        calls.append(path.name)
        if len(calls) == 1:
            second.run({"w0": "", "w1": ""})

    monkeypatch.setattr(mod, "write_matches_csv", write)
    first.run({"w0": "", "w1": ""})
    return calls


@pytest.mark.parametrize("package", ["port", "jax"])
def test_interleaved_units_one_directory(tmp_path, monkeypatch, package):
    """The port's ranks write through temporary names of their own, so a
    rank that completes the unit meanwhile leaves the other's rename
    standing; the JAX runner's one shared temporary name makes the first
    rank's rename fail (FileNotFoundError), as `search --multihost
    --resume-dir` of two JAX processes did."""
    from fandom_search_tpu_torch.parallel import mesh as M

    out = tmp_path / "resume"
    if package == "port":
        def at_rank(r):
            monkeypatch.setattr(M, "_WORLD", SimpleNamespace(rank=r))
            return runner.ResumableRunner(_Engine(), out)

        a, b = at_rank(0), at_rank(1)
        monkeypatch.setattr(M, "_WORLD", None)
        calls = _interleaved(runner, a, b, monkeypatch)
        assert calls == ["unit_00000.csv.r0.tmp", "unit_00000.csv.r1.tmp"]
        assert sorted(os.listdir(out)) == ["manifest.json", "unit_00000.csv"]
        assert json.loads((out / "manifest.json").read_text())["units"]["00000"]["done"]
    else:
        a, b = (jrunner.ResumableRunner(_Engine(), out) for _ in range(2))
        with pytest.raises(FileNotFoundError):
            _interleaved(jrunner, a, b, monkeypatch)


def test_runner_rank_defaults_to_the_world(tmp_path, monkeypatch):
    """The runner takes its rank in the joined world (0 outside one) for
    its temporary names."""
    from fandom_search_tpu_torch.parallel import mesh as M

    assert runner.ResumableRunner(_Engine(), tmp_path / "a")._tmp_suffix == ".r0.tmp"
    monkeypatch.setattr(M, "_WORLD", SimpleNamespace(rank=3))
    assert runner.ResumableRunner(_Engine(), tmp_path / "b")._tmp_suffix == ".r3.tmp"
