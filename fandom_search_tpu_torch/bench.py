"""The port's benchmark; counterpart of fandom_search_tpu/bench.py.

    python -m fandom_search_tpu_torch bench [--quick] [--device cuda|cpu]
    python -m fandom_search_tpu_torch.bench [--quick] [--device cuda|cpu]

Runs the JAX bench's stages in its order, under its keys, with its
``BENCH_*`` size knobs and defaults, its seeds and its draw order, so
that on the same sizes the same data goes in:

  kernel_engine, kernel_exact  K2 on 2^17 query x 8,192 script shingles
      (K1 embeds the query stream on the device, ~1% plants set after
      it), gated at the candidate threshold and exact, timed in bursts
      of BENCH_KERNEL_ITERS calls;
  cpu_oracle    the NumPy oracle on 2,048 rows, and K2's recall@10
      against it;
  sw            8,192 pairs of 64 x 64 tokens at the default sw_variant
      ("wide": K4);
  sharded       ``sharded_topk`` on a 1 x 1 mesh of the device;
  lsh           ``LSHIndex.build`` and ``lsh_topk`` (K6, then the exact
      rerank), ungated and gated, with both recalls;
  bucketed_small / _big / _huge   the flat bucketed stage against K2;
  e2e           ``SearchEngine.search_works`` over the 10k-work world
      (``make_e2e_world``), warm, then BENCH_E2E_REPS timed passes, the
      NumPy oracle on a 50-work sample (row parity) and, where sklearn
      and Levenshtein are installed, the reference pipeline;
  bucketed_e2e_parity   the same world through the bucketed prefilter,
      rows against the exact path's;
  bucketed_english / _english_huge / _zipf   the hybrid on skewed
      vocabularies against K2, driven with the engine's rerun rule;
  bucketed_e2e_big   the flagship world (2^20 script shingles at zipf
      1.01, 480 works, pairs "all"), hybrid rows against exact rows;
  scale         100k works through the e2e engine.

Every stage runs the kernels through their wrappers: on CUDA tensors
each wrapper launches its kernel, so the bench's path launches K1, K2,
K3, K4 and K6 (``stage_launches`` counts them a stage).  ``--device
cpu`` runs the same code on CPU tensors, where the wrappers take their
plain versions (a test setting, not a fallback).  Without CUDA and
without ``--device cpu`` the bench exits 2 with the reason and prints
no result line; a stage that raises fails the run.

The last stdout line is the result line (``driver_line``): the engine-
mode K2 rate as ``shingle_pairs_per_sec``, with ``backend`` "gpu" or
"cpu" and ``degraded`` always false (the port never falls back).
Everything else goes to stderr and to ``torch_bench_details.json``;
``torch_bench_details.partial.json`` is rewritten after every stage, so
a killed run leaves what it measured.  ``--quick`` (or BENCH_QUICK=1)
runs ``kernel_engine`` only and compares its rate with
``bench_expected.json`` beside this module at 80%, on the same burst
basis (``basis_iters``); without that file it skips the compare.

Keys beyond the JAX bench's: ``kernel_engine_int8_peak_share`` (the
rate x 2 x dim over the card's dense int8 tensor-core peak; null for a
card this module does not know) in place of
``kernel_engine_mxu_utilization``; ``build_seconds`` (nvcc, before the
first stage), ``card``, ``torch``, ``cuda``, ``stage_launches``
({stage: {kernel: launches}}, "setup" included), ``e2e_stage_seconds``
(the engine's s_batchgen, s_pull and s_host, one entry a timed pass)
and ``cpu_reference_skipped`` (why the reference pipeline did not run).

Knobs: BENCH_NQ, BENCH_NS, BENCH_CPU_NQ, BENCH_KERNEL_ITERS (40),
BENCH_SW_B, BENCH_SW_ITERS (20), BENCH_BIG_NS, BENCH_HUGE_NS,
BENCH_ENGLISH_NS, BENCH_ENGLISH_HUGE_NS, BENCH_ZIPF_NS (0 unless
BENCH_FULL=1), BENCH_E2E_WORKS, BENCH_CPU_E2E_WORKS, BENCH_E2E_REPS,
BENCH_SKIP_E2E=1, BENCH_E2E_BIG_SHINGLES, BENCH_E2E_BIG_WORKS,
BENCH_E2E_BIG_REPS, BENCH_SCALE_WORKS, BENCH_SCALE_REPS,
BENCH_TIME_BUDGET_S (900; optional stages that would run past it are
skipped and listed in ``stages_skipped_for_time``; 0 disables).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PARTIAL_NAME = "torch_bench_details.partial.json"
FINAL_NAME = "torch_bench_details.json"
EXPECTED_PATH = Path(__file__).with_name("bench_expected.json")
# dense int8 tensor-core operations/s by card (NVIDIA data sheet, SXM)
INT8_PEAK_OPS_S = {"H100": 1.979e15}
# the kernels' launch counters, by kernel key: (ops module, wrapper,
# counter); K1 embed, K2 / K7 distance top-k, K3 scan, K4 / K5
# Smith-Waterman, K6 Hamming top-R
COUNTERS = {
    "embed_shingles": ("embed", "embed_shingles", "launches"),
    "topk_dot": ("distance_topk", "topk_dot", "launches"),
    "scan1d_i32": ("scan", "scan1d_i32", "launches"),
    "sw_wide": ("smith_waterman", "sw_wide", "launches"),
    "sw_lane_i16": ("smith_waterman", "sw_lane", "launches_i16"),
    "sw_lane_f32": ("smith_waterman", "sw_lane", "launches_f32"),
    "hamming_topk": ("lsh", "hamming_topk", "launches"),
    "topk_dot_rows": ("distance_topk", "topk_dot", "launches_rows"),
}
_REF_PACKAGES = ("sklearn", "Levenshtein")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def driver_line(metric, value, unit, vs_baseline, platform, degraded,
                fault=None):
    """The ONE stdout JSON line a benchmark harness parses (the JAX
    bench's keys)."""
    out = {
        "metric": metric, "value": value, "unit": unit,
        "vs_baseline": vs_baseline,
        "backend": platform, "degraded": bool(degraded),
    }
    if fault:
        out["fault"] = fault
    return out


def _recall_by_score(want_vals, got_vals, dim, k):
    """recall@k counted by score MULTISET: each tied oracle entry must be
    matched by its own kernel entry."""
    w = np.round(np.asarray(want_vals) * dim)
    g = np.round(np.asarray(got_vals) * dim)
    rec = 0.0
    for i in range(w.shape[0]):
        wv, wc = np.unique(w[i], return_counts=True)
        gv, gc = np.unique(g[i], return_counts=True)
        got_counts = dict(zip(gv.tolist(), gc.tolist()))
        hit = sum(
            min(int(c), got_counts.get(v, 0))
            for v, c in zip(wv.tolist(), wc.tolist())
        )
        rec += hit / k
    return rec / max(1, w.shape[0])


def skew_recall_accounting(
    evn, ein, got, q_wh, sw_h, *, stride, thr, dim, guarantee_min,
):
    """Thresholded + guaranteed-set recall of hybrid triples vs the exact
    kernel's above-threshold top-k entries, strided sample.

    ``got`` maps query index -> set of (script_idx, rounded score)
    identity pairs: matching on identity, not on a score multiset, keeps
    an embedding-noise entry that ties a guaranteed entry's score from
    taking its hit."""
    tot = hit = g_tot = g_hit = 0
    for i in range(0, evn.shape[0], stride):
        keepm = evn[i] >= thr
        if not keepm.any():
            continue
        have = got.get(i, set())
        for v, si in zip(
            np.round(evn[i][keepm] * dim), ein[i][keepm]
        ):
            guaranteed = (
                guarantee_min is not None
                and int((q_wh[i] == sw_h[si]).sum()) >= guarantee_min
            )
            tot += 1
            g_tot += guaranteed
            if (int(si), int(v)) in have:
                hit += 1
                g_hit += guaranteed
    return tot, hit, g_tot, g_hit


def make_e2e_world(rng, n_works: int):
    """The e2e workload: 200-line script (6-14 words/line), vocab 5000,
    2000-word works with 3 planted quotes each.

    Returns (lines, index, works, cfg)."""
    from fandom_search_tpu_torch.config import PipelineConfig
    from fandom_search_tpu_torch.data.script_parser import parse_script
    from fandom_search_tpu_torch.search.index import build_script_index
    from fandom_search_tpu_torch.utils.synthetic import (
        make_corpus_with_quotes, make_script, make_vocab,
    )

    cfg = PipelineConfig()
    vocab = make_vocab(rng, 5000)
    script_text = make_script(rng, vocab, num_lines=200,
                              words_per_line=(6, 14))
    lines = parse_script(script_text)
    index = build_script_index(lines, cfg.shingle, cfg.search)
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=n_works,
        words_per_work=2000, quotes_per_work=3, vocab=vocab,
    )
    return lines, index, works, cfg


def sizes() -> dict:
    """The stages' sizes from the BENCH_* knobs, at the JAX bench's
    defaults (``bucketed_zipf`` only under BENCH_FULL=1 or its knob)."""
    return dict(
        nq=_env_int("BENCH_NQ", 1 << 17),
        ns=_env_int("BENCH_NS", 8192),
        cpu_nq=_env_int("BENCH_CPU_NQ", 2048),
        sw_b=_env_int("BENCH_SW_B", 8192),
        bucketed_big=_env_int("BENCH_BIG_NS", 1 << 20),
        bucketed_huge=_env_int("BENCH_HUGE_NS", 1 << 22),
        bucketed_english=_env_int("BENCH_ENGLISH_NS", 1 << 20),
        bucketed_english_huge=_env_int("BENCH_ENGLISH_HUGE_NS", 1 << 22),
        bucketed_zipf=_env_int(
            "BENCH_ZIPF_NS", 1 << 20 if os.environ.get("BENCH_FULL") else 0),
        e2e_works=_env_int("BENCH_E2E_WORKS", 10000),
        e2e_big_shingles=_env_int("BENCH_E2E_BIG_SHINGLES", 1 << 20),
        e2e_big_works=_env_int("BENCH_E2E_BIG_WORKS", 480),
        scale_works=_env_int("BENCH_SCALE_WORKS", 100000),
    )


# the hybrid's skewed-vocabulary stages (measure_skew): zipf-1.01 over a
# 2^19 vocabulary (English-like; pairs "all" makes the guarantee
# deterministic down to 2 matching positions) and zipf-1.3 % 50k (the
# stress case: the top word 29% of tokens); query rows are min(nq, nq_max)
SKEW = {
    "bucketed_english": dict(
        nq_max=1 << 16, zipf_a=1.01, vocab=1 << 19, pairs_mode="all",
        plant_stride=20, guarantee_min=2, seed=13),
    "bucketed_english_huge": dict(
        nq_max=1 << 17, zipf_a=1.01, vocab=1 << 19, pairs_mode="all",
        plant_stride=20, guarantee_min=2, seed=13),
    "bucketed_zipf": dict(
        nq_max=1 << 16, zipf_a=1.3, vocab=50000, pairs_mode=None,
        plant_stride=100, guarantee_min=None, seed=11),
}


def kernel_data(cfg, nq: int, ns: int):
    """The kernel stages' host data from default_rng(0): the query and
    script uint32 streams, the script's int8 embeddings and the script
    rows planted at every 100th query row.  Returns (q_stream, s_stream,
    s_emb, plant_idx)."""
    from fandom_search_tpu_torch.data.shingler import embed_shingles_np

    n = cfg.shingle.n
    rng = np.random.default_rng(0)
    q_stream = rng.integers(0, 2**32, size=nq + n - 1, dtype=np.uint32)
    s_stream = rng.integers(0, 2**32, size=ns + n - 1, dtype=np.uint32)
    s_emb = embed_shingles_np(s_stream, cfg.shingle)
    # ~1% planted near-duplicates, so the merge gate sees both regimes
    plant_idx = rng.integers(0, ns, size=len(range(0, nq, 100)))
    return q_stream, s_stream, s_emb, plant_idx


def kernel_operands(dev, cfg, q_stream, s_emb, plant_idx) -> dict:
    """The kernel stages' device operands: the query tokens (``tok``), the
    sign multipliers, the padded script rows (``s_pad``, ``ns_valid``),
    and the query rows (``q_dev``) that K1 embeds from the tokens, with
    the plants set after it."""
    import torch

    from fandom_search_tpu_torch.data.hashing import derive_sign_mults
    from fandom_search_tpu_torch.ops.embed import embed_shingles

    mults = torch.from_numpy(derive_sign_mults(
        cfg.shingle.seed, cfg.shingle.n, cfg.shingle.dim).view(np.int32)).to(dev)
    s_dev = torch.from_numpy(s_emb).to(dev)
    s_pad, ns_valid = _pad_rows(s_dev, cfg.search.script_pad_multiple)
    tok = _tokens(q_stream, dev)
    q_dev = embed_shingles(tok, mults)
    q_dev[::100] = s_dev[torch.from_numpy(plant_idx).to(dev)]
    return dict(tok=tok, mults=mults, s_pad=s_pad, ns_valid=ns_valid,
                q_dev=q_dev)


def sw_data(cfg, pairs: int):
    """The ``sw`` stage's token pairs from default_rng(5): (a [pairs,
    window_tokens], b [pairs, max_line_tokens]), uint32."""
    r_sw = np.random.default_rng(5)
    a = r_sw.integers(1, 1000, size=(pairs, cfg.search.window_tokens))
    b = r_sw.integers(1, 1000, size=(pairs, cfg.search.max_line_tokens))
    return a.astype(np.uint32), b.astype(np.uint32)


def bucketed_streams(cfg, ns_b: int, nq_b: int):
    """A flat bucketed stage's uint32 streams from default_rng(7): the
    script's, and the queries' with ~1% plants of 0-2 mutations.
    Returns (s_stream, q_stream)."""
    n = cfg.shingle.n
    r2 = np.random.default_rng(7)
    s_stream = r2.integers(0, 2**32, size=ns_b + n - 1, dtype=np.uint32)
    q_stream = r2.integers(0, 2**32, size=nq_b + n - 1, dtype=np.uint32)
    for qi in range(0, nq_b, 100):
        si = int(r2.integers(0, ns_b))
        q_stream[qi : qi + n] = s_stream[si : si + n]
        for p in r2.choice(n, size=int(r2.integers(0, 3)), replace=False):
            q_stream[qi + p] = r2.integers(0, 2**32, dtype=np.uint32)
    return s_stream, q_stream


def skew_streams(cfg, ns_c: int, nq_c: int, *, zipf_a, vocab, plant_stride,
                 seed, **_):
    """A skewed-vocabulary stage's uint32 streams (``SKEW``): zipf ranks
    folded into ``vocab`` words, a script window planted at every
    ``plant_stride``-th query.  Returns (s_stream, q_stream)."""
    n = cfg.shingle.n
    r = np.random.default_rng(seed)

    def words(count):
        # ranks -> word hashes with a stopword-like head; the +1 keeps
        # every hash nonzero (hash 0 embeds to a constant vector)
        return (
            (((r.zipf(zipf_a, size=count) - 1) % vocab) + 1)
            .astype(np.uint32) * np.uint32(0x9E3779B9)
        )

    s_stream = words(ns_c + n - 1)
    q_stream = words(nq_c + n - 1)
    for qi in range(0, nq_c, plant_stride):
        si = int(r.integers(0, ns_c))
        q_stream[qi : qi + n] = s_stream[si : si + n]
    return s_stream, q_stream


def flagship_world(cfg, shingles: int, num_works: int, seed: int = 23):
    """The ``bucketed_e2e_big`` world: a whole-franchise script of about
    ``shingles`` shingles with English-like skew (zipf 1.01 over 30,000
    words) and ``num_works`` 2,000-word works with 3 plants each, one
    word of each mutated.  Returns (lines, index, works, planted)."""
    from fandom_search_tpu_torch.data.script_parser import parse_script
    from fandom_search_tpu_torch.search.index import build_script_index
    from fandom_search_tpu_torch.utils.synthetic import (
        make_corpus_with_quotes, make_script, make_vocab,
    )

    rng = np.random.default_rng(seed)
    vocab = make_vocab(rng, 30000)
    script_text = make_script(
        rng, vocab, num_lines=max(1, -(-shingles // 12)),
        words_per_line=(8, 17), zipf_a=1.01,
    )
    lines = parse_script(script_text)
    index = build_script_index(lines, cfg.shingle, cfg.search)
    # num_edits=1: mutated plants give 5-of-6-match shingles too, so the
    # parity set reaches the guarantee's boundary
    works, planted = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=num_works,
        words_per_work=2000, quotes_per_work=3, num_edits=1, vocab=vocab,
        zipf_a=1.01,
    )
    return lines, index, works, planted


def counters() -> dict:
    """{kernel key: (wrapper, name of its launch counter)}."""
    return {
        key: (getattr(importlib.import_module(
            f"fandom_search_tpu_torch.ops.{mod}"), fn), attr)
        for key, (mod, fn, attr) in COUNTERS.items()
    }


def hybrid_rerun(call, budgets: dict):
    """Drive ``call(max_out, risk_budget)``, a ``bucketed_hybrid`` call,
    with the engine's rerun rule (search/engine.py ``_process_fused``):
    over the risk budget, rerun at the next power of two; and grow
    ``max_out`` so no triple is cut.  ``budgets`` ({"max_out",
    "risk_budget"}) keeps what the reruns settled.  Returns ((qpos,
    script_idx, score, count), risk count)."""
    from fandom_search_tpu_torch.search.engine import _next_pow2

    while True:
        qp, si, sc, cnt, rc = call(budgets["max_out"], budgets["risk_budget"])
        rc_n = int(rc)
        if rc_n > budgets["risk_budget"]:
            budgets["risk_budget"] = _next_pow2(rc_n, budgets["risk_budget"] * 2)
            continue
        c = int(cnt)
        if c > budgets["max_out"]:
            budgets["max_out"] = _next_pow2(c, budgets["max_out"] * 2)
            continue
        return (qp, si, sc, c), rc_n


def read_counters() -> dict:
    """{kernel key: launches so far} from the wrappers' counters."""
    return {key: getattr(w, attr) for key, (w, attr) in counters().items()}


def _launches_since(before: dict) -> dict:
    now = read_counters()
    return {k: now[k] - before[k] for k in now}


class StageRunner:
    """Runs the stages: details flushed to the partial file after each;
    per stage its wall seconds, backend and kernel launches; optional
    stages skipped when the elapsed time plus their estimate would pass
    ``budget_s`` (0: no budget)."""

    def __init__(self, path: Path, backend: str, *, t0: float,
                 budget_s: float):
        self.path = path
        self.backend = backend
        self.t0 = t0
        self.budget_s = budget_s
        self.done: list[str] = []
        self.details = {"stages_done": self.done}

    def flush(self):
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.details, indent=2))
        tmp.replace(self.path)

    def run(self, name: str, fn, *, optional: bool = False,
            est_s: float = 0.0) -> bool:
        if optional and self.budget_s:
            elapsed = time.time() - self.t0
            if elapsed + est_s > self.budget_s:
                skipped = self.details.setdefault("stages_skipped_for_time", [])
                skipped.append(name)
                self.flush()
                log(f"[budget] skipping optional stage {name}: "
                    f"{elapsed:.0f}s elapsed + ~{est_s:.0f}s estimated "
                    f"> {self.budget_s:.0f}s budget "
                    "(BENCH_TIME_BUDGET_S; 0 disables)")
                return False
        self.details["stage_started"] = name
        self.flush()
        before = read_counters()
        t_stage = time.perf_counter()
        fn()
        self.details.setdefault("stage_seconds", {})[name] = round(
            time.perf_counter() - t_stage, 3)
        self.details.setdefault("stage_launches", {})[name] = (
            _launches_since(before))
        self.details.pop("stage_started", None)
        self.done.append(name)
        self.details.setdefault("stage_backends", {})[name] = self.backend
        self.flush()
        return True


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time(dev, fn, iters=10, rounds=3):
    """Best-of-``rounds`` seconds a call over bursts of ``iters`` calls,
    after one warm call."""
    fn()
    _sync(dev)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def _timed(dev, fn):
    """(seconds, result) of one call, synced."""
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return time.perf_counter() - t0, out


def _tokens(stream: np.ndarray, dev):
    """uint32 token hashes -> int32 bit patterns on ``dev``."""
    import torch

    return torch.from_numpy(
        np.ascontiguousarray(stream, dtype=np.uint32).view(np.int32)).to(dev)


def _pad_rows(x, multiple: int):
    """Zero-pad rows to a multiple (at least one): (padded, original rows)."""
    import torch

    from fandom_search_tpu_torch.ops.lsh import round_up_pad

    n = x.shape[0]
    target = round_up_pad(n, multiple)
    if target == n:
        return x, n
    return torch.cat([x, x.new_zeros((target - n, *x.shape[1:]))]), n


def _host(x):
    return x.cpu().numpy()


def _card(dev) -> str | None:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def _int8_peak(name: str) -> float | None:
    return next((v for k, v in INT8_PEAK_OPS_S.items() if k in name), None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fandom_search_tpu_torch bench",
        description="the port's standard benchmark (one JSON line on stdout)")
    ap.add_argument("--quick", action="store_true",
                    help="kernel_engine only, compared with bench_expected.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; fails without CUDA) or cpu, which "
                         "runs the kernels' plain versions")
    args = ap.parse_args(argv)
    quick = args.quick or bool(os.environ.get("BENCH_QUICK"))
    from fandom_search_tpu_torch.search.engine import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        log(f"bench: {e}")
        return 2
    return run(dev, quick)


def run(dev, quick: bool = False) -> int:
    t_start = time.time()
    import torch

    from fandom_search_tpu_torch.config import PipelineConfig
    from fandom_search_tpu_torch.data.shingler import (
        embed_shingles_np, shingle_hashes,
    )
    from fandom_search_tpu_torch.ops import _cuda
    from fandom_search_tpu_torch.ops.distance_topk import topk_dot
    from fandom_search_tpu_torch.ops.embed import embed_shingles
    from fandom_search_tpu_torch.search.engine import SearchEngine
    from fandom_search_tpu_torch.search.oracle import topk_scores_np

    backend = "gpu" if dev.type == "cuda" else "cpu"
    build_s = None
    if dev.type == "cuda":
        # every kernel builds before the first stage, timed apart
        build_s = _cuda.build()
        _cuda.library()
    cfg = PipelineConfig()
    k, dim, n = cfg.search.k, cfg.shingle.dim, cfg.shingle.n
    thr = cfg.search.candidate_threshold
    dev_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"benchmark on {dev_name} (backend={backend})")

    size = sizes()
    nq, ns, cpu_nq = size["nq"], size["ns"], size["cpu_nq"]

    cap = StageRunner(
        Path.cwd() / PARTIAL_NAME, backend, t0=t_start,
        budget_s=float(os.environ.get("BENCH_TIME_BUDGET_S", 900)),
    )
    d = cap.details
    d.update(backend=backend, degraded=False, device=dev_name, nq=nq, ns=ns,
             card=_card(dev), torch=torch.__version__, cuda=torch.version.cuda,
             build_seconds=build_s)
    before_setup = read_counters()

    log(f"building embeddings: {nq} query + {ns} script shingles")
    q_stream, _s_stream, s_emb, plant_idx = kernel_data(cfg, nq, ns)
    # the query side embedded on the device by K1 from the uint32 stream
    ops = kernel_operands(dev, cfg, q_stream, s_emb, plant_idx)
    mults, s_pad, ns_valid, q_dev = (
        ops["mults"], ops["s_pad"], ops["ns_valid"], ops["q_dev"])
    log(f"script side on device ({float(s_pad.float().sum()):.0f} checksum)")
    log(f"query embeds on device ({float(q_dev.float().sum()):.0f} checksum)")
    # host embeds for the oracle sample only (cpu_nq rows)
    q_emb = embed_shingles_np(q_stream[: cpu_nq + n - 1], cfg.shingle)
    q_emb[::100] = s_emb[plant_idx[: len(q_emb[::100])]]
    d["stage_launches"] = {"setup": _launches_since(before_setup)}
    cap.flush()

    def run_kernel(min_keep):
        return topk_dot(q_dev, s_pad, ns_valid, k, min_keep=min_keep)

    # a burst amortizes the host's sync over `iters` launches, as the
    # engine launches its batches without a sync between them
    kernel_iters = _env_int("BENCH_KERNEL_ITERS", 40)
    _memo: dict = {}

    def get_ovals():
        """Oracle top-k on the noise corpus (also read by the LSH stage)."""
        if "ovals" not in _memo:
            _memo["ovals"] = topk_scores_np(q_emb[:cpu_nq], s_emb, k, dim)
        return _memo["ovals"]

    # ---- fused distance + top-k kernel (K2) -----------------------------
    def stage_kernel_engine():
        dt = _time(dev, lambda: run_kernel(thr), iters=kernel_iters)
        rate = nq * ns / dt
        peak = _int8_peak(dev_name) if dev.type == "cuda" else None
        share = rate * 2 * dim / peak if peak else None
        log(f"kernel (engine mode, min_keep={thr}): {dt*1e3:.3f} ms -> "
            f"{rate/1e9:.2f} G pairs/s"
            + (f" ({share:.1%} of the int8 tensor-core peak)" if share else ""))
        d["kernel_engine_pairs_per_sec"] = rate
        d["kernel_engine_int8_peak_share"] = share

    cap.run("kernel_engine", stage_kernel_engine)
    rate_engine = d["kernel_engine_pairs_per_sec"]

    if quick:
        ok = True
        if EXPECTED_PATH.exists():
            exp = json.loads(EXPECTED_PATH.read_text())
            basis_iters = exp.get("basis_iters")
            if basis_iters and basis_iters != kernel_iters:
                # a recorded floor holds only on the burst basis it was
                # measured on; a mismatch is a config error, not a pass
                log(f"quick regression check: recorded floor is on a "
                    f"{basis_iters}-call burst basis but this run used "
                    f"{kernel_iters}; set BENCH_KERNEL_ITERS={basis_iters} "
                    "for a valid compare -> FAIL")
                ok = False
            else:
                floor = exp["kernel_engine_pairs_per_sec"] * 0.80
                ok = rate_engine >= floor
                log(f"quick regression check: {rate_engine/1e9:.1f} G vs "
                    f"recorded {exp['kernel_engine_pairs_per_sec']/1e9:.1f} G "
                    f"(floor 80%) -> {'PASS' if ok else 'FAIL'}")
        else:
            log(f"no {EXPECTED_PATH.name}; skipping regression compare")
        d["quick_regression_ok"] = bool(ok)
        d["capture_complete"] = True
        cap.path.unlink(missing_ok=True)
        print(json.dumps(driver_line(
            "shingle_pairs_per_sec", round(rate_engine), "pairs/s", 0,
            backend, False,
        )), flush=True)
        return 0 if ok else 1

    def stage_kernel_exact():
        dt = _time(dev, lambda: run_kernel(-float("inf")), iters=kernel_iters)
        rate = nq * ns / dt
        log(f"kernel (exact top-k): {dt*1e3:.3f} ms -> {rate/1e9:.2f} G pairs/s")
        d["kernel_exact_pairs_per_sec"] = rate

    cap.run("kernel_exact", stage_kernel_exact)

    # ---- the CPU oracle (the reference algorithm, NumPy) ----------------
    def stage_cpu_oracle():
        t0 = time.perf_counter()
        ovals, _ = get_ovals()
        cpu_dt = time.perf_counter() - t0
        cpu_rate = cpu_nq * ns / cpu_dt
        log(f"CPU oracle: {cpu_nq}x{ns} in {cpu_dt:.3f}s -> "
            f"{cpu_rate/1e6:.1f} M pairs/s")
        d["cpu_pairs_per_sec"] = cpu_rate
        d["speedup_kernel_vs_cpu"] = rate_engine / cpu_rate
        # recall@10 of the exact kernel vs the oracle (must be 1.0)
        kvals, _ = topk_dot(q_dev[:cpu_nq], s_pad, ns_valid, k)
        d["kernel_recall_at_10_vs_oracle"] = _recall_by_score(
            ovals, _host(kvals), dim, k)
        log(f"exact-kernel recall@10 vs oracle: "
            f"{d['kernel_recall_at_10_vs_oracle']:.4f}")

    cap.run("cpu_oracle", stage_cpu_oracle)

    # ---- Smith-Waterman verification rate (K4 at "wide") ---------------
    def stage_sw():
        from fandom_search_tpu_torch.ops.smith_waterman import sw_normalized

        B = size["sw_b"]
        a, b = sw_data(cfg, B)
        w, mlt = a.shape[1], b.shape[1]
        ad = torch.from_numpy(a.view(np.int32)).to(dev)
        bd = torch.from_numpy(b.view(np.int32)).to(dev)
        la = torch.full((B,), w, dtype=torch.int32, device=dev)
        lb = torch.full((B,), mlt, dtype=torch.int32, device=dev)
        dt_sw = _time(
            dev, lambda: sw_normalized(ad, bd, la, lb, cfg.search),
            iters=_env_int("BENCH_SW_ITERS", 20),
        )
        d["sw_pairs_per_sec"] = B / dt_sw
        d["sw_cells_per_sec"] = B * w * mlt / dt_sw
        log(f"SW verify: {dt_sw*1e3:.3f} ms for {B} pairs -> "
            f"{B/dt_sw:,.0f} pairs/s ({B*w*mlt/dt_sw/1e9:.2f} G cells/s)")

    cap.run("sw", stage_sw)

    # ---- sharded path (a 1 x 1 mesh of this device) ---------------------
    def stage_sharded():
        from fandom_search_tpu_torch.config import MeshConfig
        from fandom_search_tpu_torch.parallel.mesh import make_mesh
        from fandom_search_tpu_torch.parallel.sharded import (
            place_script_shards, sharded_topk,
        )

        mesh = make_mesh(MeshConfig(works=1, script=1), [dev])
        shards = place_script_shards(mesh, s_pad)
        dt_sh = _time(dev, lambda: sharded_topk(
            mesh, [q_dev], shards, [ns_valid], k, min_keep=thr))
        d["sharded_pairs_per_sec"] = nq * ns / dt_sh
        d["sharded_note"] = (
            "1x1 mesh of one device; works x script meshes are held to the "
            "JAX package's by tests/test_torch_sharded.py and "
            "tests/test_torch_multihost.py, and run on the card by "
            "chip_smoke.py's sharded and multihost phases"
        )
        log(f"sharded (1x1 mesh): {dt_sh*1e3:.3f} ms -> "
            f"{nq*ns/dt_sh/1e9:.2f} G pairs/s")

    cap.run("sharded", stage_sharded)

    # ---- LSH prefilter build + query + recall@10 (K6) -------------------
    def stage_lsh():
        from fandom_search_tpu_torch.ops.lsh import (
            LSHIndex, coarse_sim_threshold, lsh_topk,
        )

        ovals, _ = get_ovals()
        t0 = time.perf_counter()
        lsh = LSHIndex.build(s_emb, cfg.lsh, cfg.shingle,
                             pad_multiple=cfg.search.script_pad_multiple,
                             device=dev)
        _sync(dev)
        d["lsh_build_seconds"] = time.perf_counter() - t0
        dt_lsh = _time(
            dev, lambda: lsh_topk(q_dev, lsh, s_pad, k, dim, cfg.lsh), iters=3)
        d["lsh_pairs_per_sec_equiv"] = nq * ns / dt_lsh
        lvals, _ = lsh_topk(q_dev[:cpu_nq], lsh, s_pad, k, dim, cfg.lsh)
        d["lsh_recall_at_10_vs_exact"] = _recall_by_score(
            ovals, _host(lvals), dim, k)
        log(f"LSH: build {d['lsh_build_seconds']:.2f}s, query "
            f"{dt_lsh*1e3:.3f} ms ({nq*ns/dt_lsh/1e9:.2f} G pairs/s-equiv), "
            f"recall@10 vs exact = {d['lsh_recall_at_10_vs_exact']:.4f}")

        # the engine's prefilter config: selection gated at the Hamming
        # floor of the candidate threshold; recall measured on the
        # candidates the engine consumes (score >= threshold)
        keep_sim = coarse_sim_threshold(thr, n, cfg.lsh.bits)
        dt_g = _time(dev, lambda: lsh_topk(
            q_dev, lsh, s_pad, k, dim, cfg.lsh, min_keep_sim=keep_sim), iters=3)
        gvals, _ = lsh_topk(q_dev[:cpu_nq], lsh, s_pad, k, dim, cfg.lsh,
                            min_keep_sim=keep_sim)
        ow = np.asarray(ovals).copy()
        with np.errstate(over="ignore"):   # empty slots: NEG_INF * dim
            gw = np.round(_host(gvals) * dim)
        recs = []
        for i in range(ow.shape[0]):
            keepm = ow[i] >= thr
            if keepm.sum():
                recs.append(
                    np.sum(np.isin(np.round(ow[i][keepm] * dim), gw[i]))
                    / keepm.sum()
                )
        d["lsh_gated_pairs_per_sec_equiv"] = nq * ns / dt_g
        d["lsh_gated_thresholded_recall"] = (
            float(np.mean(recs)) if recs else 1.0
        )
        log(f"LSH gated (engine config, sim floor {keep_sim}): query "
            f"{dt_g*1e3:.3f} ms ({nq*ns/dt_g/1e9:.2f} G pairs/s-equiv), "
            f"thresholded recall = {d['lsh_gated_thresholded_recall']:.4f}")

    cap.run("lsh", stage_lsh)

    # ---- the sub-linear bucketed prefilter, flat (K1, K3) vs K2 ---------
    def measure_bucketed(ns_b, nq_b, tag):
        from fandom_search_tpu_torch.ops.bucketed import (
            BucketedIndex, bucketed_candidates_flat,
        )

        s_stream, q_stream = bucketed_streams(cfg, ns_b, nq_b)
        windows = shingle_hashes(s_stream, cfg.shingle)
        t0 = time.perf_counter()
        bidx = BucketedIndex.build(windows, cfg.bucketed, cfg.shingle, device=dev)
        d[f"{tag}_build_seconds"] = time.perf_counter() - t0
        d[f"{tag}_overflow_frac"] = bidx.overflow_frac
        sb_pad, nsv_b = _pad_rows(embed_shingles(_tokens(s_stream, dev), mults), 2048)
        qs_dev = _tokens(q_stream, dev)
        qb_dev = embed_shingles(qs_dev, mults)
        max_out = 1 << 16

        def run_exact():
            return topk_dot(qb_dev, sb_pad, nsv_b, k, min_keep=thr)

        def run_bucketed():
            # the flat triple path, as the engine runs it
            return bucketed_candidates_flat(
                qs_dev, qb_dev, bidx.entries, bidx.offsets, sb_pad,
                n=n, cap=cfg.bucketed.cap, num_buckets=bidx.num_buckets,
                salts=bidx.salts, k=k, dim=dim, threshold=thr, max_out=max_out,
            )

        _, ev = _timed(dev, run_exact)
        _, bt = _timed(dev, run_bucketed)
        best_e = best_b = float("inf")
        for _ in range(3):  # interleaved A/B
            best_e = min(best_e, _timed(dev, run_exact)[0])
            best_b = min(best_b, _timed(dev, run_bucketed)[0])

        # thresholded recall vs the exact kernel's above-threshold top-k
        # entries, split into the guaranteed set (>= 3 true matching
        # positions, the pigeonhole bound) and all
        q_windows = shingle_hashes(q_stream, cfg.shingle)
        evn, ein = _host(ev[0]), _host(ev[1])
        qpos_b, sid_b, sc_b = (_host(x) for x in bt[:3])
        got = {}
        for q, s, v in zip(qpos_b, sid_b, sc_b):
            if q >= 0:
                got.setdefault(int(q), []).append(round(float(v) * dim))
        tot = hit = g_tot = g_hit = 0
        for i in range(nq_b):
            keepm = evn[i] >= thr
            if not keepm.any():
                continue
            have = got.get(i, [])
            for v, si in zip(np.round(evn[i][keepm] * dim), ein[i][keepm]):
                guaranteed = int((q_windows[i] == windows[si]).sum()) >= 3
                tot += 1
                g_tot += guaranteed
                if v in have:
                    have.remove(v)
                    hit += 1
                    g_hit += guaranteed
        if int(bt[3]) > max_out:
            raise RuntimeError(f"bench budget overflow: {int(bt[3])} triples > {max_out}")
        d[f"{tag}_exact_seconds"] = best_e
        d[f"{tag}_seconds"] = best_b
        d[f"{tag}_speedup_vs_exact"] = best_e / best_b
        d[f"{tag}_thresholded_recall"] = hit / max(1, tot)
        d[f"{tag}_guaranteed_recall"] = g_hit / max(1, g_tot)
        d[f"{tag}_pairs_per_sec_equiv"] = nq_b * ns_b / best_b
        log(f"bucketed [{tag}] ns={ns_b}: exact {best_e*1e3:.3f} ms vs "
            f"bucketed(flat) {best_b*1e3:.3f} ms (x{best_e/best_b:.2f}), "
            f"thresholded recall {hit/max(1, tot):.4f} "
            f"(guaranteed set {g_hit/max(1, g_tot):.4f}), "
            f"overflow {bidx.overflow_frac:.5f}")

    cap.run("bucketed_small",
            lambda: measure_bucketed(ns, min(nq, 1 << 15), "bucketed_small"))
    big_ns, huge_ns = size["bucketed_big"], size["bucketed_huge"]

    # ---- the hybrid bucketed prefilter on skewed vocabularies -----------
    def measure_skew(tag):
        spec = SKEW[tag]
        ns_c, nq_c = size[tag], min(nq, spec["nq_max"])
        pairs_mode, guarantee_min = spec["pairs_mode"], spec["guarantee_min"]
        from fandom_search_tpu_torch.ops.bucketed import (
            BucketedIndex, bucketed_hybrid,
        )

        bcfg = (dataclasses.replace(cfg.bucketed, pairs=pairs_mode)
                if pairs_mode else cfg.bucketed)
        s_stream, q_stream = skew_streams(cfg, ns_c, nq_c, **spec)
        sw_h = shingle_hashes(s_stream, cfg.shingle)
        bidx = BucketedIndex.build(sw_h, bcfg, cfg.shingle, device=dev)
        d[f"{tag}_overflow_frac"] = bidx.overflow_frac
        s_padz, nsz = _pad_rows(embed_shingles(_tokens(s_stream, dev), mults), 2048)
        qs_devz = _tokens(q_stream, dev)
        q_devz = embed_shingles(qs_devz, mults)
        budgets = {"max_out": 1 << 16, "risk_budget": 1 << 13}

        def run_exact():
            return topk_dot(q_devz, s_padz, nsz, k, min_keep=thr)

        def run_hybrid():
            return hybrid_rerun(lambda max_out, risk_budget: bucketed_hybrid(
                qs_devz, q_devz, bidx.entries, bidx.offsets, s_padz, nsz,
                n=n, cap=bcfg.cap, num_buckets=bidx.num_buckets,
                salts=bidx.salts, k=k, dim=dim, threshold=thr,
                max_out=max_out, risk_budget=risk_budget,
                pairs_mode=bcfg.pairs,
            ), budgets)

        _, ev = _timed(dev, run_exact)
        _, ((hqp, hsi, hsc, hcnt), rc_n) = _timed(dev, run_hybrid)
        best_e = best_h = float("inf")
        for _ in range(3):
            best_e = min(best_e, _timed(dev, run_exact)[0])
            best_h = min(best_h, _timed(dev, run_hybrid)[0])

        q_wh = shingle_hashes(q_stream, cfg.shingle)
        evn, ein = _host(ev[0]), _host(ev[1])
        got = {}
        for q, s, v in zip(_host(hqp)[:hcnt], _host(hsi)[:hcnt],
                           _host(hsc)[:hcnt]):
            if q >= 0:
                got.setdefault(int(q), set()).add((int(s), round(float(v) * dim)))
        tot, hit, g_tot, g_hit = skew_recall_accounting(
            evn, ein, got, q_wh, sw_h, stride=17, thr=thr, dim=dim,
            guarantee_min=guarantee_min,
        )
        d.update({
            f"{tag}_ns": ns_c,
            f"{tag}_risk_frac": rc_n / max(1, nq_c),
            f"{tag}_exact_seconds": best_e,
            f"{tag}_hybrid_seconds": best_h,
            f"{tag}_hybrid_vs_exact": best_e / best_h,
            f"{tag}_thresholded_recall": hit / max(1, tot),
        })
        gmsg = ""
        if guarantee_min is not None:
            d[f"{tag}_guaranteed_recall"] = g_hit / max(1, g_tot)
            gmsg = (f" (guaranteed >={guarantee_min}-match set "
                    f"{g_hit/max(1, g_tot):.4f})")
        log(f"bucketed hybrid [{tag}] ns={ns_c} pairs={bcfg.pairs}: "
            f"overflow {bidx.overflow_frac:.2%}, at-risk {rc_n}/{nq_c} "
            f"({rc_n/max(1, nq_c):.1%}); exact {best_e*1e3:.3f} ms vs "
            f"hybrid {best_h*1e3:.3f} ms (x{best_e/best_h:.2f}); "
            f"thresholded recall {hit/max(1, tot):.4f}{gmsg} ({tot} entries)")

    def run_bucketed_scale_stages():
        """The sub-linear stages, after the e2e stages (the JAX bench's
        order); the estimates decide what the time budget skips."""
        if big_ns:
            cap.run("bucketed_big",
                    lambda: measure_bucketed(big_ns, nq, "bucketed_big"),
                    optional=True, est_s=40)
        if size["bucketed_english"]:
            cap.run("bucketed_english",
                    lambda: measure_skew("bucketed_english"),
                    optional=True, est_s=40)
        if huge_ns:
            cap.run("bucketed_huge",
                    lambda: measure_bucketed(huge_ns, nq, "bucketed_huge"),
                    optional=True, est_s=120)
        if size["bucketed_english_huge"]:
            cap.run("bucketed_english_huge",
                    lambda: measure_skew("bucketed_english_huge"),
                    optional=True, est_s=150)
        # zipf-1.3, where the hybrid reroutes nearly every query, runs
        # only under BENCH_FULL=1 or an explicit BENCH_ZIPF_NS
        if size["bucketed_zipf"]:
            cap.run("bucketed_zipf", lambda: measure_skew("bucketed_zipf"),
                    optional=True, est_s=40)

    # ---- end to end: the engine against the extrapolated CPU oracle -----
    n_works = size["e2e_works"]

    def get_e2e():
        """The e2e world, an engine warmed by one full pass, and that
        pass's rows (memoized; the seed is fixed)."""
        if "e2e" not in _memo:
            r_e2e = np.random.default_rng(42)
            t0 = time.perf_counter()
            lines, index, works, _c = make_e2e_world(r_e2e, n_works)
            log(f"e2e corpus: {n_works} works built in "
                f"{time.perf_counter()-t0:.1f}s")
            eng = SearchEngine(index, cfg, device=dev)
            rows0, _s0 = eng.search_works(works)  # warm: settles the budgets
            _memo["e2e"] = (lines, index, works, eng, rows0)
        return _memo["e2e"]

    if os.environ.get("BENCH_SKIP_E2E"):
        run_bucketed_scale_stages()
    else:
        def stage_e2e():
            from fandom_search_tpu_torch.search.oracle import search_works_oracle

            lines, index, works, eng, _rows0 = get_e2e()
            n_cpu_works = _env_int("BENCH_CPU_E2E_WORKS", 50)
            e2e_reps = _env_int("BENCH_E2E_REPS", 3)
            e2e_runs = []
            parts = {key: [] for key in ("s_batchgen", "s_pull", "s_host")}
            rows = stats = None
            for _ in range(e2e_reps):
                t0 = time.perf_counter()
                rows, stats = eng.search_works(works)
                e2e_runs.append(time.perf_counter() - t0)
                for key, runs in parts.items():
                    runs.append(stats.extra[key])
            e2e_dt = min(e2e_runs)
            log(f"end-to-end: {n_works} works "
                f"({stats.num_query_shingles} shingles) vs "
                f"{index.num_shingles}-shingle script in {e2e_dt:.3f}s, "
                f"{len(rows)} match rows")

            # CPU baselines on a subsample, extrapolated by query-shingle
            # count: the NumPy oracle and, where its packages exist, the
            # reference-style pipeline (BallTree + Levenshtein)
            sample = dict(list(works.items())[:n_cpu_works])
            t0 = time.perf_counter()
            orows, ostats = search_works_oracle(sample, index, cfg)
            cpu_sample_dt = time.perf_counter() - t0
            scale = stats.num_query_shingles / max(1, ostats.num_query_shingles)
            cpu_e2e_est = cpu_sample_dt * scale
            log(f"CPU oracle e2e: {cpu_sample_dt:.2f}s for {n_cpu_works} "
                f"works -> extrapolated {cpu_e2e_est:.1f}s for {n_works} "
                f"(x{scale:.1f} by shingle count)")

            missing = [m for m in _REF_PACKAGES if importlib.util.find_spec(m) is None]
            if missing:
                d["cpu_reference_skipped"] = (
                    f"{', '.join(missing)} not installed: the reference "
                    "pipeline (search/reference_pipeline.py) needs sklearn "
                    "and Levenshtein")
                log(f"reference pipeline skipped: {d['cpu_reference_skipped']}")
            else:
                from fandom_search_tpu_torch.search.reference_pipeline import (
                    ReferenceSearch,
                )

                ref = ReferenceSearch(lines, cfg)
                t0 = time.perf_counter()
                _rrows, rstats = ref.search_works(sample)
                ref_sample_dt = time.perf_counter() - t0
                ref_e2e_est = ref_sample_dt * (
                    stats.num_query_shingles / max(1, rstats.num_query_shingles))
                log(f"reference pipeline (BallTree+Levenshtein) e2e: "
                    f"{ref_sample_dt:.2f}s for {n_cpu_works} works -> "
                    f"extrapolated {ref_e2e_est:.1f}s for {n_works}")
                d.update({
                    "cpu_reference_sample_seconds": ref_sample_dt,
                    "cpu_reference_extrapolated_seconds": ref_e2e_est,
                    "e2e_speedup_vs_reference": ref_e2e_est / e2e_dt,
                })
            # sample row parity on the identity key of the CLI's
            # --selfcheck (scores differ in float detail between paths;
            # span identity must not)
            sample_ids = set(sample)
            rkey = lambda r: (r.work_id, r.fan_token_start, r.line_no)  # noqa: E731
            eng_sample = {rkey(r) for r in rows if r.work_id in sample_ids}
            o_set = {rkey(r) for r in orows}
            d.update({
                "e2e_works": n_works,
                "e2e_seconds": e2e_dt,
                "e2e_seconds_runs": e2e_runs,
                "e2e_stage_seconds": parts,
                "e2e_query_shingles": stats.num_query_shingles,
                "e2e_matches": len(rows),
                "e2e_pairs_per_sec": stats.shingle_pairs / e2e_dt,
                # one fused step a batch: "submit" is the upload and
                # launch time, the rest (device wait, host) is "process"
                "e2e_submit_seconds": stats.seconds_device_topk,
                "e2e_process_seconds": stats.seconds_host,
                "cpu_e2e_sample_works": n_cpu_works,
                "cpu_e2e_sample_seconds": cpu_sample_dt,
                "cpu_e2e_extrapolated_seconds": cpu_e2e_est,
                "e2e_speedup_vs_cpu": cpu_e2e_est / e2e_dt,
                "e2e_sample_match_parity": (
                    len(eng_sample & o_set) / max(1, len(o_set))),
                "e2e_sample_missing_rows": len(o_set - eng_sample),
                "e2e_sample_extra_rows": len(eng_sample - o_set),
            })
            log(f"e2e speedup vs CPU oracle: x{cpu_e2e_est/e2e_dt:.0f}; "
                f"sample row parity {d['e2e_sample_match_parity']:.4f} "
                f"({len(o_set)} oracle rows, "
                f"missing {d['e2e_sample_missing_rows']}, "
                f"extra {d['e2e_sample_extra_rows']})")

        cap.run("e2e", stage_e2e, optional=True, est_s=240)

        # ---- bucketed e2e row parity: the same corpus, prefilter on ----
        def stage_bucketed_e2e():
            from fandom_search_tpu_torch.ops.bucketed import (
                attach_bucketed_prefilter,
            )

            lines, index, works, _eng, rows_exact = get_e2e()
            eng_b = SearchEngine(index, cfg, device=dev)
            attach_bucketed_prefilter(eng_b, cfg.bucketed)
            eng_b.search_works(works)  # warm
            t0 = time.perf_counter()
            rows_b, stats_b = eng_b.search_works(works)
            dt_b = time.perf_counter() - t0
            exact_set, b_set = set(rows_exact), set(rows_b)
            inter = len(exact_set & b_set)
            d.update({
                "bucketed_e2e_works": n_works,
                "bucketed_e2e_seconds": dt_b,
                "bucketed_e2e_rows": len(rows_b),
                "bucketed_e2e_row_parity": inter / max(1, len(exact_set)),
                "bucketed_e2e_missing_rows": len(exact_set - b_set),
                "bucketed_e2e_extra_rows": len(b_set - exact_set),
                "bucketed_e2e_risk_frac": stats_b.extra.get(
                    "bucketed_risk_frac", 0.0),
            })
            ok = not (exact_set - b_set) and not (b_set - exact_set)
            d["bucketed_e2e_parity_ok"] = ok
            d["recall_gate_ok"] = bool(d.get("recall_gate_ok", True)) and ok
            if not ok:
                log("ALERT: bucketed e2e row parity BROKEN")
            log(f"bucketed e2e parity: {len(rows_b)} rows vs "
                f"{len(exact_set)} exact in {dt_b:.3f}s -> parity "
                f"{inter/max(1, len(exact_set)):.4f} "
                f"(missing {len(exact_set-b_set)}, extra "
                f"{len(b_set-exact_set)}, risk_frac "
                f"{d['bucketed_e2e_risk_frac']:.3f})")

        cap.run("bucketed_e2e_parity", stage_bucketed_e2e,
                optional=True, est_s=40)

        run_bucketed_scale_stages()

        # ---- bucketed e2e at flagship index scale ------------------------
        # a whole-franchise script (2^20 shingles, English-like skew)
        # searched through the hybrid (pairs "all"): its rows must equal
        # the exact path's
        big_e2e_shingles = size["e2e_big_shingles"]
        big_e2e_works = size["e2e_big_works"]

        def stage_bucketed_e2e_big():
            from fandom_search_tpu_torch.ops.bucketed import (
                attach_bucketed_prefilter,
            )

            t0 = time.perf_counter()
            lines_b, index_b, works_b, _pl = flagship_world(
                cfg, big_e2e_shingles, big_e2e_works)
            log(f"big-script world: {index_b.num_shingles} script "
                f"shingles ({len(lines_b)} lines), {big_e2e_works} works "
                f"built in {time.perf_counter()-t0:.1f}s")

            eng_x = SearchEngine(index_b, cfg, device=dev)
            rows_x, _sx = eng_x.search_works(works_b)  # warm
            eng_b2 = SearchEngine(index_b, cfg, device=dev)
            attach_bucketed_prefilter(
                eng_b2, dataclasses.replace(cfg.bucketed, pairs="all"))
            rows_b2 = st_b2 = None
            eng_b2.search_works(works_b)               # warm
            dt_x = dt_b2 = float("inf")
            for _ in range(_env_int("BENCH_E2E_BIG_REPS", 1)):  # interleaved A/B
                t0 = time.perf_counter()
                rows_x, _sx = eng_x.search_works(works_b)
                dt_x = min(dt_x, time.perf_counter() - t0)
                t0 = time.perf_counter()
                rows_b2, st_b2 = eng_b2.search_works(works_b)
                dt_b2 = min(dt_b2, time.perf_counter() - t0)
            ex_set, b_set = set(rows_x), set(rows_b2)
            inter = len(ex_set & b_set)
            d.update({
                "bucketed_e2e_big_script_shingles": index_b.num_shingles,
                "bucketed_e2e_big_works": big_e2e_works,
                "bucketed_e2e_big_overflow_frac": eng_b2.bucketed.overflow_frac,
                "bucketed_e2e_big_exact_seconds": dt_x,
                "bucketed_e2e_big_seconds": dt_b2,
                "bucketed_e2e_big_speedup_vs_exact": dt_x / dt_b2,
                "bucketed_e2e_big_rows": len(rows_b2),
                "bucketed_e2e_big_row_parity": inter / max(1, len(ex_set)),
                "bucketed_e2e_big_missing_rows": len(ex_set - b_set),
                "bucketed_e2e_big_extra_rows": len(b_set - ex_set),
                "bucketed_e2e_big_risk_frac": st_b2.extra.get(
                    "bucketed_risk_frac", 0.0),
            })
            ok = not (ex_set - b_set) and not (b_set - ex_set)
            d["bucketed_e2e_big_parity_ok"] = ok
            d["recall_gate_ok"] = bool(d.get("recall_gate_ok", True)) and ok
            if not ok:
                log("ALERT: bucketed e2e BIG row parity BROKEN")
            log(f"bucketed e2e BIG ({index_b.num_shingles}-shingle "
                f"english-skew script): exact {dt_x:.3f}s vs hybrid "
                f"{dt_b2:.3f}s (x{dt_x/dt_b2:.2f} e2e); "
                f"{len(rows_b2)} rows vs {len(ex_set)} exact -> parity "
                f"{inter/max(1, len(ex_set)):.4f} (missing "
                f"{len(ex_set-b_set)}, extra {len(b_set-ex_set)}, "
                f"risk_frac {d['bucketed_e2e_big_risk_frac']:.3f})")

        if big_e2e_shingles:
            cap.run("bucketed_e2e_big", stage_bucketed_e2e_big,
                    optional=True, est_s=200)

        # ---- corpus scale: 100k works -----------------------------------
        scale_works = size["scale_works"]
        if scale_works > n_works:
            def stage_scale():
                from fandom_search_tpu_torch.utils.synthetic import (
                    make_corpus_with_quotes, make_vocab,
                )

                lines, _index, _works, eng, _rows0 = get_e2e()
                r_sc = np.random.default_rng(43)
                t0 = time.perf_counter()
                works_big, _ = make_corpus_with_quotes(
                    r_sc, [ln.text for ln in lines],
                    num_works=scale_works, words_per_work=2000,
                    quotes_per_work=3, vocab=make_vocab(r_sc, 5000),
                )
                log(f"scale corpus: {scale_works} works built in "
                    f"{time.perf_counter()-t0:.1f}s")
                scale_runs = []
                rows_big = stats_big = None
                for _ in range(_env_int("BENCH_SCALE_REPS", 1)):
                    t0 = time.perf_counter()
                    rows_big, stats_big = eng.search_works(works_big)
                    scale_runs.append(time.perf_counter() - t0)
                dt_big = min(scale_runs)
                d.update({
                    "scale_works": scale_works,
                    "scale_seconds": dt_big,
                    "scale_seconds_runs": scale_runs,
                    "scale_query_shingles": stats_big.num_query_shingles,
                    "scale_matches": len(rows_big),
                    "scale_pairs_per_sec": stats_big.shingle_pairs / dt_big,
                })
                log(f"scale e2e: {scale_works} works "
                    f"({stats_big.num_query_shingles} shingles) in "
                    f"{dt_big:.1f}s, {len(rows_big)} rows")

            cap.run("scale", stage_scale, optional=True, est_s=250)

    d["capture_complete"] = True
    Path(FINAL_NAME).write_text(json.dumps(d, indent=2))
    cap.path.unlink(missing_ok=True)
    log(f"details -> {FINAL_NAME}")
    cpu_rate = d.get("cpu_pairs_per_sec")
    print(json.dumps(driver_line(
        "shingle_pairs_per_sec", round(rate_engine), "pairs/s",
        round(rate_engine / cpu_rate, 2) if cpu_rate else 0, backend, False,
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
