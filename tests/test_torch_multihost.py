"""The port's multi-process grid (``--multihost``) against one process and the JAX package.

Tolerance: 0.  Each world is a group of subprocesses
(``tests/torch_multihost_rank.py``, gloo over ``env://`` on the loopback
address, each rank naming the CPU once or twice), every one with a
timeout.  Every rank's MatchRows compare field by field (rounded scores
included) with the port's one-process rows on the same mesh (the CPU
named once per cell) and with JAX's ``ShardedSearchEngine`` on the same
mesh shape over tests/conftest.py's virtual CPU devices
(``use_pallas=False``); the CLI's CSVs compare byte for byte with the
JAX CLI's ``--cpu`` CSV.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fandom_search_tpu import cli as jcli
from fandom_search_tpu.config import BucketedConfig as JBucketedConfig
from fandom_search_tpu.config import LSHConfig as JLSHConfig
from fandom_search_tpu.config import MeshConfig as JMeshConfig
from fandom_search_tpu.config import PipelineConfig as JConfig
from fandom_search_tpu.data.script_parser import parse_script
from fandom_search_tpu.ops.lsh import attach_lsh_prefilter as jattach_lsh
from fandom_search_tpu.parallel.sharded import ShardedSearchEngine as JShardedEngine
from fandom_search_tpu.parallel.sharded_bucketed import (
    attach_bucketed_prefilter_sharded as jattach_bucketed,
)
from fandom_search_tpu.search.index import build_script_index as jbuild
from fandom_search_tpu.utils import jit_cache
from fandom_search_tpu.utils.synthetic import make_corpus_with_quotes, make_script, make_vocab
from fandom_search_tpu_torch import cli
from fandom_search_tpu_torch.config import MeshConfig
from fandom_search_tpu_torch.parallel import mesh as M
from fandom_search_tpu_torch.parallel.sharded import ShardedSearchEngine
from fandom_search_tpu_torch.search.index import build_script_index
from tests import torch_multihost_rank as R

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
RANK = Path(R.__file__)
# seconds a rank may take, and a collective inside it
TIMEOUT_S = 240
COLLECTIVE_S = 60
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def _job(name, world, mesh, path="exact", **search):
    return dict(name=name, world=world, mesh=list(mesh), path=path, search=search)


FAST = dict(sw_variant="fast")
# 4 ranks x 1 CPU device: the script axis crosses processes at 1x4
JOBS_4x1 = [
    _job("exact_4x1", "sharded", (4, 1)),
    _job("exact_2x2", "sharded", (2, 2)),
    _job("exact_1x4", "sharded", (1, 4)),
    _job("lsh_fast_2x2", "sharded", (2, 2), "lsh", **FAST),
    _job("lsh_fast_1x4", "sharded", (1, 4), "lsh", **FAST),
    _job("compress_4x1", "sharded", (4, 1), stream_compress=True),
    _job("hybrid_2x2", "dryrun", (2, 2), "hybrid"),
]
# 2 ranks x 2 logical CPU devices: each rank owns a works row
JOBS_2x2 = [
    _job("exact_2x2", "sharded", (2, 2)),
    _job("lsh_fast_2x2", "sharded", (2, 2), "lsh", **FAST),
    _job("compress_2x2", "sharded", (2, 2), stream_compress=True),
    _job("hybrid_2x2", "dryrun", (2, 2), "hybrid"),
    # a risk budget below a batch's at-risk count: every rank must rerun
    # the same batches with the same grown budget (a rank that skipped
    # the rerun's collectives would hang the others)
    dict(_job("hybrid_rerun_2x2", "dryrun", (2, 2), "hybrid"), risk_budget=8),
]
WORLDS = {"4x1": (4, 1, JOBS_4x1), "2x2": (2, 2, JOBS_2x2)}
CASES = [(w, j["name"]) for w, (_, _, jobs) in WORLDS.items() for j in jobs]
CLI_CASES = ["examples", "synthetic"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(out: Path, world: int, local: int, jobs, **extra):
    out.mkdir(parents=True, exist_ok=True)
    spec = dict(port=_free_port(), world=world, local_devices=local, jobs=jobs,
                out=str(out), timeout_s=COLLECTIVE_S, **extra)
    (out / "spec.json").write_text(json.dumps(spec))
    return [subprocess.Popen([sys.executable, str(RANK), str(out / "spec.json"), str(r)],
                             env=ENV, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def _launch_cli(out: Path, works: Path, script: Path, ranks: int = 2):
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "fandom_search_tpu_torch", "search", str(works), str(script),
         "-o", str(out / f"r{r}.csv"), "--device", "cpu", "--multihost",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(ranks),
         "--process-id", str(r), "--mesh", f"{ranks}x1", "--batch-queries", "4096"],
        env=ENV, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(ranks)]


def _wait(procs):
    """Each process's (stdout, stderr); all must exit 0 in time."""
    res = []
    try:
        for p in procs:
            res.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, res):
        assert p.returncode == 0, err[-3000:]
    return res


def _synthetic_dir(root: Path):
    """tests/test_sharded.py's world (seed 23) as a works dir and a script."""
    rng = np.random.default_rng(23)
    vocab = make_vocab(rng, 1200)
    text = make_script(rng, vocab, num_lines=20, words_per_line=(7, 12))
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in parse_script(text)], num_works=10, words_per_work=250,
        quotes_per_work=2, num_edits=0, vocab=vocab)
    (root / "works").mkdir(parents=True)
    for w, t in works.items():
        (root / "works" / f"{w}.txt").write_text(t, encoding="utf-8")
    (root / "script.txt").write_text(text, encoding="utf-8")
    return root / "works", root / "script.txt"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world, launched at once: the two search worlds, a world whose
    ranks all claim one card, and two 2-rank CLI searches; the JAX CLI's
    CSVs are made while they run."""
    root = tmp_path_factory.mktemp("multihost")
    procs = {w: _launch(root / w, n, local, jobs) for w, (n, local, jobs) in WORLDS.items()}
    procs["card"] = _launch(root / "card", 2, 1, [], fake_card=True)
    inputs = {"examples": (EXAMPLES / "fanworks", EXAMPLES / "script.txt"),
              "synthetic": _synthetic_dir(root / "synthetic")}
    for case, (works, script) in inputs.items():
        (root / f"cli_{case}").mkdir()
        procs[f"cli_{case}"] = _launch_cli(root / f"cli_{case}", works, script)
    jax_csv = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jit_cache, "enable_persistent_cache", lambda *a, **k: None)
        for case, (works, script) in inputs.items():
            out = root / f"jax_{case}.csv"
            assert jcli.main(["search", str(works), str(script), "-o", str(out), "--cpu",
                              "--no-pallas", "--mesh", "2x1", "--batch-queries", "4096"]) == 0
            jax_csv[case] = out.read_bytes()
    logs = {k: _wait(p) for k, p in procs.items()}
    return root, jax_csv, logs


def _load(root: Path, world: str, name: str, ranks: int):
    return [json.loads((root / world / f"{name}.r{r}.json").read_text()) for r in range(ranks)]


def _rows(rows):
    """MatchRows as the JSON the ranks wrote them in."""
    return json.loads(json.dumps([r.to_csv_row() for r in rows]))


def _rows_json(res):
    return json.loads(json.dumps(res["rows"]))


def _jax_rows(job, world):
    """JAX's ShardedSearchEngine on the job's mesh shape and path."""
    lines, works = world
    w, s = job["mesh"]
    cfg = JConfig(mesh=JMeshConfig(works=w, script=s))
    cfg = dataclasses.replace(cfg, search=dataclasses.replace(
        cfg.search, batch_queries=w * 512, **job["search"]))
    index = jbuild(lines, cfg.shingle, cfg.search)
    eng = JShardedEngine(index, cfg, use_pallas=False)
    if job["path"] == "lsh":
        jattach_lsh(eng, JLSHConfig())
    elif job["path"] == "hybrid":
        jattach_bucketed(eng, JBucketedConfig())
    rows, _ = eng.search_works(works)
    return _rows(rows), eng


@pytest.fixture(scope="module")
def worlds():
    return {name: fn() for name, fn in R.WORLDS.items()}


@pytest.fixture(scope="module")
def refs(worlds):
    """(one-process result, JAX rows, JAX engine) of a job, each made once
    for the jobs that share it (JAX has no risk budget to set)."""
    ones, jaxes = {}, {}

    def key(job, *drop):
        return json.dumps({k: v for k, v in job.items() if k not in ("name", *drop)},
                          sort_keys=True)

    def ref(job):
        world = worlds[job["world"]]
        if key(job) not in ones:
            ones[key(job)] = json.loads(json.dumps(R.run_job(job, world)))
        if key(job, "risk_budget") not in jaxes:
            jaxes[key(job, "risk_budget")] = _jax_rows(job, world)
        return (ones[key(job)], *jaxes[key(job, "risk_budget")])

    return ref


@pytest.mark.parametrize("world,name", CASES)
def test_every_rank_matches_one_process_and_jax(runs, refs, world, name):
    """Every rank's rows equal the one-process grid's and JAX's sharded
    engine's on the same mesh; the at-risk counts, risk budgets, batches
    and table uploads equal one process's; each rank owned only its own
    cells."""
    root, _, _ = runs
    ranks, local, jobs = WORLDS[world]
    job = next(j for j in jobs if j["name"] == name)
    got = _load(root, world, name, ranks)
    one, want, jeng = refs(job)
    assert one["rows"] and one["rows"] == want
    for r, res in enumerate(got):
        assert res["rows"] == one["rows"], f"rank {r}"
        for key in ("batches", "risk_queries", "risk_budget", "table_uploads"):
            assert res[key] == one[key], (r, key)
        owned = [c for row in res["owned"] for c in row]
        assert owned == [k // local == r for k in range(len(owned))]
    if job["path"] == "hybrid":
        assert 0 < got[0]["risk_queries"] == jeng._bucketed_risk_queries
    if "risk_budget" in job:
        assert got[0]["risk_budget"] > job["risk_budget"]
    if job["search"].get("stream_compress"):
        assert got[0]["table_uploads"] >= 1


def test_world_init_idle_ranks_and_duplicate_cards(runs):
    """initialize_multihost is idempotent and counts the global devices
    (4 x 1 and 2 x 2); a mesh that leaves a rank without a cell is
    refused; ranks that name one card are refused before any collective,
    and leave no process group behind."""
    root, _, _ = runs
    for world, (ranks, local, _) in WORLDS.items():
        for r, info in enumerate(_load(root, world, "world", ranks)):
            assert info["global_devices"] == info["again"] == ranks * local
            assert info["rank"] == r
            idle = list(range(1, ranks)) if local == 1 else [1]
            assert info["idle_refusal"] == (
                f"mesh {local}x1 leaves rank(s) {idle} without a cell; every rank must own one")
    for r in range(2):
        res = json.loads((root / "card" / f"refused.r{r}.json").read_text())
        assert res["error"].startswith("ranks 0 and 1 both name card host/GPU-fake")
        assert res["initialized"] is False


@pytest.mark.parametrize("case", CLI_CASES)
def test_cli_multihost_csv_matches_jax(runs, case):
    """Two ranks of `search --device cpu --multihost --mesh 2x1`: each
    joins the cluster, and each rank's CSV is byte-equal to the JAX
    CLI's `--cpu` CSV on the same mesh."""
    root, jax_csv, logs = runs
    assert jax_csv[case].count(b"\n") > 1
    for r, (out, err) in enumerate(logs[f"cli_{case}"]):
        assert "multihost: joined cluster, 2 global devices" in err
        assert json.loads(out.strip().splitlines()[-1])["matches"] > 0
        assert (root / f"cli_{case}" / f"r{r}.csv").read_bytes() == jax_csv[case], f"rank {r}"


def test_one_rank_world_in_process(monkeypatch, refs, worlds):
    """A one-rank world over env:// (the card's one-rank NCCL world, here
    on gloo): initialize_multihost is idempotent, the default grid is the
    world's (every cell this rank's), the exchange runs its all_gathers
    over the world and the rows equal the one-process grid's; leaving the
    world twice is harmless."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    job = _job("exact_2x2", "sharded", (2, 2))
    one, _, _ = refs(job)
    try:
        assert M.initialize_multihost(device="cpu", local_devices=4,
                                      timeout_s=COLLECTIVE_S) == 4
        assert M.initialize_multihost(device="cpu") == 4 and dist.is_initialized()
        mesh = M.make_mesh(MeshConfig(works=2, script=2))
        assert mesh.distributed and mesh.ranks == [[0, 0], [0, 0]] and mesh.world == 1
        calls = []
        orig = dist.all_gather
        monkeypatch.setattr(dist, "all_gather", lambda *a, **k: calls.append(1) or orig(*a, **k))
        assert _rows_json(R.run_job(job, worlds["sharded"])) == one["rows"]
        assert calls   # the exchange went through the collective
    finally:
        M.shutdown_multihost()
    assert not dist.is_initialized() and M.multihost_world() is None
    M.shutdown_multihost()


def test_cuda_world_without_cuda_fails_without_fallback(tmp_path, monkeypatch, capsys):
    """--multihost on cuda (the default device) without CUDA fails: no
    gloo world is joined in its place, and the CLI exits 2 with the
    reason and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA and NCCL"):
        M.initialize_multihost("127.0.0.1:1", 1, 0, device="cuda")
    assert not dist.is_initialized() and M.multihost_world() is None
    out = tmp_path / "x.csv"
    with pytest.raises(SystemExit) as e:
        cli.main(["search", str(EXAMPLES / "fanworks"), str(EXAMPLES / "script.txt"),
                  "-o", str(out), "--multihost", "--coordinator", "127.0.0.1:1",
                  "--num-processes", "1", "--process-id", "0"])
    assert e.value.code == 2 and not out.exists() and not dist.is_initialized()
    assert "error: --multihost on cuda needs CUDA and NCCL" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="needs initialize_multihost"):
        M.make_mesh(MeshConfig(works=2), ["cpu", "cpu"], ranks=[0, 0])


def test_serve_refuses_multihost(capsys):
    """serve --multihost refuses before joining anything: the JAX
    package's serve --multihost binds one port on every rank (the second
    rank fails) and a request to the first waits in a collective that no
    other rank enters."""
    assert cli.main(["serve", str(EXAMPLES / "script.txt"), "--device", "cpu",
                     "--multihost"]) == 2
    assert "serve does not run --multihost" in capsys.readouterr().err
    assert not dist.is_initialized()


def test_sharded_engine_refuses_a_world_of_another_device(monkeypatch, worlds):
    """A ShardedSearchEngine asked for cuda in a gloo (CPU) world is
    refused, not run on the CPU."""
    monkeypatch.setattr(M, "_WORLD", M._World(0, 1, [torch.device("cpu")], [0]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    lines, _ = worlds["sharded"]
    cfg = R.job_config(_job("x", "sharded", (1, 1)))
    with pytest.raises(ValueError, match="the multihost world runs on cpu, not on cuda"):
        ShardedSearchEngine(build_script_index(lines, cfg.shingle, cfg.search), cfg)
