"""The port's bench (fandom_search_tpu_torch/bench.py) against the JAX package's.

Tolerance 0: on one tiny environment (``TINY``) both benches run on the
CPU, each in a subprocess (the JAX bench with ``BENCH_CPU=1``, the port's
with ``--device cpu``), and every key of the details that is no time or
rate must be equal: recalls, overflow and risk fractions, row counts,
parities, missing and extra rows, query shingles.  ``BENCH_ZIPF_NS``
makes the zipf-1.3 stage overflow 43.5% of its table and reroute 935 of
1,024 queries through the hybrid.  The copied helpers are held equal to
the originals on the same inputs.
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fandom_search_tpu import bench as jbench
from fandom_search_tpu import cli as jcli
from fandom_search_tpu_torch import bench, cli
from fandom_search_tpu_torch.config import PipelineConfig

ROOT = Path(__file__).resolve().parent.parent
TINY = {
    "BENCH_NQ": "1024", "BENCH_NS": "256", "BENCH_CPU_NQ": "128", "BENCH_SW_B": "32",
    "BENCH_BIG_NS": "4096", "BENCH_ENGLISH_NS": "8192", "BENCH_ZIPF_NS": "16384",
    "BENCH_HUGE_NS": "0", "BENCH_ENGLISH_HUGE_NS": "0", "BENCH_E2E_WORKS": "8",
    "BENCH_CPU_E2E_WORKS": "4", "BENCH_E2E_REPS": "1", "BENCH_E2E_BIG_SHINGLES": "4096",
    "BENCH_E2E_BIG_WORKS": "6", "BENCH_SCALE_WORKS": "0",
}
STAGES = ["kernel_engine", "kernel_exact", "cpu_oracle", "sw", "sharded", "lsh",
          "bucketed_small", "e2e", "bucketed_e2e_parity", "bucketed_big",
          "bucketed_english", "bucketed_zipf", "bucketed_e2e_big"]
# a key holding a time or a rate: present on both sides, values free
TIMED = re.compile(r"seconds|per_sec|speedup|hybrid_vs_exact|utilization|peak_share")
# labels naming the backend's device, or the package's own tests
LABELS = {"device", "sharded_note"}
RENAMED = {"kernel_engine_mxu_utilization": "kernel_engine_int8_peak_share"}
ADDED = {"build_seconds", "card", "torch", "cuda", "stage_launches", "e2e_stage_seconds"}
# the key groups the parity test compares, one case each
GROUPS = ["run", "kernel", "cpu_oracle", "sw", "sharded", "lsh", "bucketed_small",
          "e2e", "bucketed_e2e", "bucketed_big", "bucketed_english", "bucketed_zipf",
          "bucketed_e2e_big"]


def _group(key: str) -> str:
    """The stage group a details key belongs to."""
    for g in sorted(GROUPS, key=len, reverse=True):
        if g != "run" and key.startswith(g):
            return g
    if key.startswith(("speedup_kernel", "cpu_pairs")):
        return "cpu_oracle"
    if key.startswith(("cpu_e2e", "cpu_reference")):
        return "e2e"
    if key == "recall_gate_ok":
        return "bucketed_e2e"
    return "run"


def _last_json(stdout: str):
    lines = stdout.strip().splitlines()
    return json.loads(lines[-1]) if lines else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both benches at TINY, started together: (JAX details, port process,
    port result line, port details, port run dir)."""
    jdir, pdir = tmp_path_factory.mktemp("jax_bench"), tmp_path_factory.mktemp("port_bench")
    jenv = {**os.environ, **TINY, "BENCH_CPU": "1", "PYTHONPATH": str(ROOT)}
    jenv.pop("JAX_PLATFORMS", None)
    code = "import sys\nfrom fandom_search_tpu import bench\nsys.exit(bench.main([]))\n"
    jp = subprocess.Popen([sys.executable, "-c", code], cwd=jdir, env=jenv,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    penv = {**os.environ, **TINY, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    pp = subprocess.Popen([sys.executable, "-m", "fandom_search_tpu_torch", "bench",
                           "--device", "cpu"], cwd=pdir, env=penv,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        jout, jerr = jp.communicate(timeout=600)
        pout, perr = pp.communicate(timeout=600)
    finally:
        jp.kill()
        pp.kill()
    assert jp.returncode == 0, jerr[-3000:]
    assert pp.returncode == 0, perr[-3000:]
    jd = json.loads((jdir / jbench.FINAL_NAME).read_text())
    pd = json.loads((pdir / bench.FINAL_NAME).read_text())
    return jd, (pout, perr), _last_json(pout), pd, pdir


def test_result_line_and_details(runs):
    """The last stdout line is the result line with its six keys
    (backend "cpu", never degraded); the details file holds every stage,
    its seconds, its backend and its launches (none on the CPU), and the
    partial file is gone."""
    _, (pout, _), line, pd, pdir = runs
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "backend", "degraded"}
    assert line["metric"] == "shingle_pairs_per_sec" and line["unit"] == "pairs/s"
    assert line["backend"] == "cpu" and line["degraded"] is False
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert len(pout.strip().splitlines()) == 1     # everything else on stderr
    assert pd["capture_complete"] is True and pd["stages_done"] == STAGES
    assert set(pd["stage_seconds"]) == set(STAGES)
    assert pd["stage_backends"] == {s: "cpu" for s in STAGES}
    assert set(pd["stage_launches"]) == {"setup", *STAGES}
    assert all(n == 0 for per in pd["stage_launches"].values() for n in per.values())
    assert set(pd["stage_launches"]["e2e"]) == set(bench.COUNTERS)
    assert pd["build_seconds"] is None and pd["card"] is None
    assert "stages_skipped_for_time" not in pd
    assert set(pd["e2e_stage_seconds"]) == {"s_batchgen", "s_pull", "s_host"}
    assert all(len(v) == int(TINY["BENCH_E2E_REPS"]) for v in pd["e2e_stage_seconds"].values())
    assert not (pdir / bench.PARTIAL_NAME).exists()


def test_key_sets_match(runs):
    """The port's keys are the JAX bench's, less the renamed key and plus
    the added ones; every key falls in a compared group."""
    jd, _, _, pd, _ = runs
    want = {RENAMED.get(k, k) for k in jd} | ADDED
    assert set(pd) == want
    assert {_group(k) for k in pd} == set(GROUPS)


@pytest.mark.parametrize("group", GROUPS)
def test_values_match_jax(runs, group):
    """Every key of the group that is no time or rate equals the JAX
    bench's with tolerance 0; times and rates are finite and positive."""
    jd, _, _, pd, _ = runs
    keys = sorted(k for k in jd if _group(RENAMED.get(k, k)) == group)
    assert keys
    for key in keys:
        got = pd[RENAMED.get(key, key)]
        if key in LABELS:
            assert isinstance(got, str) and got
        elif key == "lsh_gated_thresholded_recall" and got != jd[key]:
            # K6's gate keeps exactly the entries at or above it; the JAX
            # kernel gates per block and may keep more (ROADMAP §3)
            assert got <= jd[key]
        elif TIMED.search(key):
            vals = got.values() if isinstance(got, dict) else (
                got if isinstance(got, list) else [got])
            if key != "kernel_engine_mxu_utilization":
                assert all(np.isfinite(v) and v > 0 for v in vals), key
        else:
            assert got == jd[key], key


def test_hybrid_reroute_reached(runs):
    """The zipf stage overflows its table and reroutes most queries
    through the hybrid's K2, with the JAX bench's recall."""
    jd, _, _, pd, _ = runs
    assert pd["bucketed_zipf_overflow_frac"] > 0.4
    assert pd["bucketed_zipf_risk_frac"] == jd["bucketed_zipf_risk_frac"] == 935 / 1024
    assert pd["bucketed_zipf_thresholded_recall"] == jd["bucketed_zipf_thresholded_recall"]
    assert pd["kernel_recall_at_10_vs_oracle"] == 1.0
    assert pd["e2e_sample_match_parity"] == 1.0 and pd["recall_gate_ok"] is True


@pytest.mark.parametrize("seed,n_works", [(42, 3), (7, 11)])
def test_make_e2e_world_matches_jax(seed, n_works):
    """The copied e2e world: the same lines, works and index arrays."""
    lines, index, works, cfg = bench.make_e2e_world(np.random.default_rng(seed), n_works)
    jlines, jindex, jworks, jcfg = jbench.make_e2e_world(np.random.default_rng(seed), n_works)
    assert [(ln.line_no, ln.speaker, ln.text) for ln in lines] == [
        (ln.line_no, ln.speaker, ln.text) for ln in jlines]
    assert works == jworks
    for name in ("stream_hashes", "shingle_windows", "embeddings", "shingle_line",
                 "line_start", "line_lengths"):
        np.testing.assert_array_equal(getattr(index, name), getattr(jindex, name))
    assert (cfg.shingle.n, cfg.shingle.dim, cfg.search.k) == (
        jcfg.shingle.n, jcfg.shingle.dim, jcfg.search.k)


@pytest.mark.parametrize("shingles,n_works", [(4096, 6), (12000, 3)])
def test_flagship_world_matches_jax(shingles, n_works):
    """The bucketed_e2e_big world (flagship_world) is the one the JAX
    bench's stage builds from default_rng(23) with its own generators."""
    from fandom_search_tpu.config import PipelineConfig as JConfig
    from fandom_search_tpu.data.script_parser import parse_script
    from fandom_search_tpu.search.index import build_script_index
    from fandom_search_tpu.utils.synthetic import (
        make_corpus_with_quotes, make_script, make_vocab,
    )

    jcfg = JConfig()
    rng = np.random.default_rng(23)
    vocab = make_vocab(rng, 30000)
    jlines = parse_script(make_script(rng, vocab, num_lines=max(1, -(-shingles // 12)),
                                      words_per_line=(8, 17), zipf_a=1.01))
    jindex = build_script_index(jlines, jcfg.shingle, jcfg.search)
    jworks, jplanted = make_corpus_with_quotes(
        rng, [ln.text for ln in jlines], num_works=n_works, words_per_work=2000,
        quotes_per_work=3, num_edits=1, vocab=vocab, zipf_a=1.01)
    lines, index, works, planted = bench.flagship_world(
        PipelineConfig(), shingles, n_works)
    assert [ln.text for ln in lines] == [ln.text for ln in jlines]
    assert works == jworks
    assert [vars(p) for p in planted] == [vars(p) for p in jplanted]
    np.testing.assert_array_equal(index.embeddings, jindex.embeddings)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recall_helpers_match_jax(seed):
    """driver_line, _recall_by_score and skew_recall_accounting give the
    JAX bench's results on the same inputs (ties, misses and duplicate
    scores included)."""
    rng = np.random.default_rng(seed)
    dim, k = 128, 10
    want = rng.integers(400, 520, size=(40, k)) / dim
    got = np.where(rng.random((40, k)) < 0.2, rng.integers(400, 520, size=(40, k)) / dim, want)
    assert bench._recall_by_score(want, got, dim, k) == jbench._recall_by_score(want, got, dim, k)
    evn = rng.integers(380, 520, size=(60, k)).astype(np.float32) / dim
    ein = rng.integers(0, 50, size=(60, k))
    q_wh = rng.integers(0, 4, size=(60, 6)).astype(np.uint32)
    sw_h = rng.integers(0, 4, size=(50, 6)).astype(np.uint32)
    have = {i: {(int(s), int(round(v * dim))) for s, v in zip(ein[i], evn[i])
                if rng.random() < 0.7} for i in range(60)}
    for gmin in (None, 2, 3):
        kw = dict(stride=3, thr=3.5, dim=dim, guarantee_min=gmin)
        assert bench.skew_recall_accounting(evn, ein, have, q_wh, sw_h, **kw) == \
            jbench.skew_recall_accounting(evn, ein, have, q_wh, sw_h, **kw)
    args = ("shingle_pairs_per_sec", 123, "pairs/s", 4.5, "gpu", False)
    assert bench.driver_line(*args) == jbench.driver_line(*args)
    assert bench.driver_line(*args, fault=[{"x": 1}]) == jbench.driver_line(
        *args, fault=[{"x": 1}])


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    for key, val in TINY.items():
        monkeypatch.setenv(key, val)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_quick_compares_with_expected(tiny, monkeypatch, capsys):
    """--quick runs kernel_engine alone: with no expected file it skips the
    compare and exits 0; with a recorded rate far above this run's it
    exits 1, as it does on a burst basis other than this run's; the
    result line goes out each time and no details file is left."""
    assert not bench.EXPECTED_PATH.exists()   # no guard level is recorded yet
    monkeypatch.setattr(bench, "EXPECTED_PATH", tiny / "none.json")
    assert cli.main(["bench", "--quick", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert "no none.json; skipping regression compare" in err
    line = _last_json(out)
    assert line["backend"] == "cpu" and line["value"] > 0 and line["vs_baseline"] == 0
    exp = tiny / "expected.json"
    monkeypatch.setattr(bench, "EXPECTED_PATH", exp)
    exp.write_text(json.dumps({"kernel_engine_pairs_per_sec": 1e30}))
    assert bench.main(["--quick", "--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    assert "-> FAIL" in err and _last_json(out)["metric"] == "shingle_pairs_per_sec"
    exp.write_text(json.dumps({"kernel_engine_pairs_per_sec": 1.0, "basis_iters": 7}))
    assert bench.main(["--quick", "--device", "cpu"]) == 1
    assert "7-call burst basis" in capsys.readouterr().err
    exp.write_text(json.dumps({"kernel_engine_pairs_per_sec": 1.0, "basis_iters": 40}))
    assert bench.main(["--quick", "--device", "cpu"]) == 0
    assert "-> PASS" in capsys.readouterr().err
    assert not list(tiny.glob("torch_bench_details*"))


def test_time_budget_skips_optional_stages(tiny, monkeypatch, capsys):
    """A 1 s budget runs the required stages and skips every optional
    one, listing each in stages_skipped_for_time."""
    monkeypatch.setenv("BENCH_TIME_BUDGET_S", "1")
    assert bench.main(["--device", "cpu"]) == 0
    d = json.loads((tiny / bench.FINAL_NAME).read_text())
    required = STAGES[:7]
    assert d["stages_done"] == required
    assert d["stages_skipped_for_time"] == [s for s in STAGES if s not in required]
    assert "[budget] skipping optional stage e2e" in capsys.readouterr().err


def test_no_cuda_fails_without_result_line(tmp_path):
    """bench on the default device without CUDA (this machine) exits 2
    with the reason and prints nothing on stdout."""
    env = {**os.environ, **TINY, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""}
    for argv in (["-m", "fandom_search_tpu_torch", "bench"],
                 ["-m", "fandom_search_tpu_torch.bench", "--quick"]):
        r = subprocess.run([sys.executable, *argv], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 2, r.stderr[-2000:]
        assert r.stdout == "" and "CUDA is not available" in r.stderr
    assert not list(tmp_path.iterdir())


def test_bench_names_no_plain_version():
    """bench.py reaches every kernel through its wrapper: it names no
    *_plain function."""
    tree = ast.parse(Path(bench.__file__).read_text())
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    names |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
              for a in n.names}
    assert not [x for x in names if x.endswith("_plain")]


def _subcommands(parser):
    (sub,) = [a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction"]
    return sub.choices


def test_version_and_verbs_match_jax_cli(capsys):
    """--version prints what the JAX CLI prints; the port has every verb
    and top-level flag of the JAX CLI, and bench every flag of its bench."""
    outs = []
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit) as e:
            main(["--version"])
        assert e.value.code == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].strip()
    port, ref = cli.build_parser(), jcli.build_parser()
    assert set(_subcommands(port)) == set(_subcommands(ref))
    assert set(port._option_string_actions) == set(ref._option_string_actions)
    assert set(_subcommands(ref)["bench"]._option_string_actions) <= set(
        _subcommands(port)["bench"]._option_string_actions)
