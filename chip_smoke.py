#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's exact search path once on one NVIDIA GPU.

    python3 chip_smoke.py [--works 10000] [--seed 0]

Run from the root of a checkout.  Phases, each printed with its result
and time:

1. device: CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them.
2. build: compiles fandom_search_tpu_torch/csrc/*.cu with nvcc.
3. kernels: K1-K4 against their plain PyTorch versions on the card, at
   the shapes of the main path, on inputs from the end-to-end world;
   exact equality is required (tolerance 0: every output is an integer
   or one f32 division of integers).  Prints warm times of both.
4. end to end: SearchEngine.search_works over the world — a 2,000-line
   script (~20k shingles) against 10,000 works of 2,000 words with 3
   planted quotes each (~20M query shingles, ~20 batches of 2^20).
   Every kernel's launch counter must grow; rows on a 50-work sample
   must equal the NumPy oracle's; every planted quote must be found.

It prints the kernel table as one JSON line, then, as its last line,
{"ok": true, "device": {...}}.  Any failure exits non-zero before that.
Imports nothing of JAX and nothing of fandom_search_tpu itself: only the
port, which takes its jax-free config module.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "fandom_search_tpu_torch"
KERNELS = (
    # name, ops module, wrapper, source, TPU kernel it replaces
    ("K1 embed", "embed", "embed_shingles", "csrc/embed.cu",
     "fandom_search_tpu/ops/embed.py:41"),
    ("K2 distance_topk", "distance_topk", "topk_dot", "csrc/distance_topk.cu",
     "fandom_search_tpu/ops/distance_topk.py:104"),
    ("K3 scan", "scan", "scan1d_i32", "csrc/scan.cu",
     "fandom_search_tpu/ops/scan.py:61"),
    ("K4 smith_waterman", "smith_waterman", "sw_normalized",
     "csrc/smith_waterman.cu", "fandom_search_tpu/ops/smith_waterman.py:452"),
)


def phase(name):
    print(f"[{name}] start", flush=True)
    return time.perf_counter()


def done(name, t0, msg=""):
    print(f"[{name}] ok {time.perf_counter() - t0:.3f}s {msg}".rstrip(), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps):
    """Warm time per call in ms: CUDA events around `reps` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_world(seed: int, num_works: int):
    """Feature-length script against the bench's e2e corpus shape."""
    import numpy as np

    from fandom_search_tpu_torch import PipelineConfig
    from fandom_search_tpu_torch.data.script_parser import parse_script
    from fandom_search_tpu_torch.search.index import build_script_index
    from fandom_search_tpu_torch.utils.synthetic import (
        make_corpus_with_quotes, make_script, make_vocab,
    )

    rng = np.random.default_rng(seed)
    cfg = PipelineConfig()
    vocab = make_vocab(rng, 5000)
    lines = parse_script(
        make_script(rng, vocab, num_lines=2000, words_per_line=(6, 14))
    )
    index = build_script_index(lines, cfg.shingle, cfg.search)
    works, planted = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=num_works,
        words_per_work=2000, quotes_per_work=3, vocab=vocab,
    )
    return cfg, index, works, planted


def first_batch_stream(engine, works):
    """The int32 token stream of the engine's first batch (2^20 + n - 1)."""
    import numpy as np
    import torch

    from fandom_search_tpu_torch.data.fast_tokenizer import tokenize_many

    items = sorted(tokenize_many(dict(sorted(works.items())[:1000])).items())
    ext, nspans, _, _ = next(iter(engine._batches(items)))
    t_pad = ext.shape[0] - 2 * nspans
    return torch.from_numpy(ext[:t_pad].view(np.int32).copy()).to(engine.device)


def kernel_checks(engine, works, seed: int):
    """Phase 3: every kernel against its plain version at path shapes."""
    import numpy as np
    import torch

    from fandom_search_tpu_torch.ops.distance_topk import (
        min_keep_int, topk_dot, topk_dot_plain,
    )
    from fandom_search_tpu_torch.ops.embed import embed_shingles, embed_shingles_plain
    from fandom_search_tpu_torch.ops.scan import scan1d_i32, scan1d_i32_plain
    from fandom_search_tpu_torch.ops.smith_waterman import (
        sw_normalized, sw_normalized_plain,
    )

    dev = engine.device
    dix = engine._dix
    cfg = engine.cfg
    rng = np.random.default_rng(seed + 1)
    res = {}

    def sync():
        torch.cuda.synchronize()

    # K1 on a 2^20 + 5-token stream (the first batch of the world)
    t0 = phase("K1 embed")
    tok = first_batch_stream(engine, works)
    check(tok.shape[0] == cfg.search.batch_queries + cfg.shingle.n - 1,
          f"first batch is not full: {tok.shape[0]} tokens")
    got = embed_shingles(tok, dix.mults)
    sync()
    want = embed_shingles_plain(tok, dix.mults)
    sync()
    err = int((got.int() - want.int()).abs().max())
    check(torch.equal(got, want), f"K1 differs from plain: max |err| {err}")
    res["embed"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: embed_shingles(tok, dix.mults), 20),
        plain_ms=cuda_ms(lambda: embed_shingles_plain(tok, dix.mults), 3),
    )
    done("K1 embed", t0, f"T={tok.shape[0]} M={got.shape[0]} {res['embed']}")

    # K2 engine mode on the same 2^20 queries against the whole script
    t0 = phase("K2 distance_topk")
    q = got
    s = dix.s_emb
    ns, k = s.shape[0], cfg.search.k
    thr = cfg.search.candidate_threshold
    keep_i = min_keep_int(thr, cfg.shingle.dim)
    kv, ki = topk_dot(q, s, ns, k, min_keep=thr)
    sync()
    pv, pi = topk_dot_plain(q, s, ns, k, keep_i)
    sync()
    above = pv >= thr
    check(torch.equal(kv[above], pv[above]) and torch.equal(ki[above], pi[above]),
          "K2 engine mode: entries at or above the threshold differ")
    check(not bool(((kv >= thr) & ~above).any()),
          "K2 engine mode: kernel holds an above-threshold entry the plain version lacks")
    check(torch.equal(kv, pv) and torch.equal(ki, pi),
          "K2 engine mode: padding below the threshold differs")
    n_above = int(above.sum())
    check(n_above > 0, "K2 engine mode: no entry above the threshold to compare")
    err = float((kv[above] - pv[above]).abs().max())
    # exact mode on a 2^14-row slice: every slot compared
    qs = q[: 1 << 14].contiguous()
    ev, ei = topk_dot(qs, s, ns, k)
    sync()
    xv, xi = topk_dot_plain(qs, s, ns, k, min_keep_int(-float("inf"), cfg.shingle.dim))
    sync()
    check(torch.equal(ev, xv) and torch.equal(ei, xi), "K2 exact mode differs")
    err = max(err, float((ev - xv).abs().max()))
    # the kernel's other register top-k size (16 < k <= 32), exact mode
    k32 = 32
    ev, ei = topk_dot(qs[: 1 << 12], s, ns, k32)
    sync()
    xv, xi = topk_dot_plain(qs[: 1 << 12], s, ns, k32,
                            min_keep_int(-float("inf"), cfg.shingle.dim))
    sync()
    check(torch.equal(ev, xv) and torch.equal(ei, xi), "K2 exact mode at k=32 differs")
    err = max(err, float((ev - xv).abs().max()))
    res["distance_topk"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: topk_dot(q, s, ns, k, min_keep=thr), 3),
        plain_ms=cuda_ms(lambda: topk_dot_plain(q, s, ns, k, keep_i), 1),
    )
    done("K2 distance_topk", t0,
         f"NQ={q.shape[0]} NS={ns} k={k} above_thr={n_above} {res['distance_topk']}")

    # K3, both ops, at 2^20 and 2^20 + 37
    t0 = phase("K3 scan")
    err = 0
    for n in (1 << 20, (1 << 20) + 37):
        x = torch.from_numpy(rng.integers(-1000, 1000, size=n).astype(np.int32)).to(dev)
        for op in ("add", "max"):
            g = scan1d_i32(x, op)
            sync()
            w = scan1d_i32_plain(x, op)
            sync()
            e = int((g.long() - w.long()).abs().max())
            check(torch.equal(g, w), f"K3 {op} at n={n} differs: max |err| {e}")
            err = max(err, e)
    mask = (torch.from_numpy(rng.random(1 << 20) < 0.01).to(dev)).int()
    res["scan"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: scan1d_i32(mask), 50),
        plain_ms=cuda_ms(lambda: scan1d_i32_plain(mask), 50),
    )
    done("K3 scan", t0, str(res["scan"]))

    # K4 on 8192 length-sorted 64 x 64 pairs with len-0 and ragged rows
    t0 = phase("K4 smith_waterman")
    bsz, la, lb = 8192, cfg.search.window_tokens, cfg.search.max_line_tokens
    a = rng.integers(1, 60, size=(bsz, la)).astype(np.uint32)
    b = rng.integers(1, 60, size=(bsz, lb)).astype(np.uint32)
    len_a = rng.integers(0, la + 1, size=bsz).astype(np.int32)
    len_b = rng.integers(0, lb + 1, size=bsz).astype(np.int32)
    len_a[:64] = 0
    len_b[64:128] = 0
    len_a[128:192], len_b[128:192] = la, lb
    for i in range(192, bsz, 3):
        m = int(min(len_a[i], len_b[i]))
        a[i, :m] = b[i, :m]
    order = np.argsort(-(len_a + len_b), kind="stable")
    to_dev = lambda x: torch.from_numpy(np.ascontiguousarray(x[order]).view(np.int32)).to(dev)  # noqa: E731
    A, B, LA_, LB_ = to_dev(a), to_dev(b), to_dev(len_a), to_dev(len_b)
    xc = cfg.search
    g = sw_normalized(A, B, LA_, LB_, xc)
    sync()
    w = sw_normalized_plain(A, B, LA_, LB_, xc.sw_match, xc.sw_mismatch, xc.sw_gap)
    sync()
    err = float((g - w).abs().max())
    check(torch.equal(g, w), f"K4 differs from plain: max |err| {err}")
    res["smith_waterman"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: sw_normalized(A, B, LA_, LB_, xc), 20),
        plain_ms=cuda_ms(lambda: sw_normalized_plain(
            A, B, LA_, LB_, xc.sw_match, xc.sw_mismatch, xc.sw_gap), 3),
    )
    done("K4 smith_waterman", t0, str(res["smith_waterman"]))
    return res


def end_to_end(engine, works, planted, index, cfg, sample: int = 50):
    """Phase 4: the main path, counted; parity on a sample; recall."""
    import importlib

    import torch

    from fandom_search_tpu_torch.search.oracle import search_works_oracle

    wrappers = {
        mod: getattr(importlib.import_module(f"{PKG}.ops.{mod}"), fn)
        for _, mod, fn, _, _ in KERNELS
    }
    t0 = phase("e2e")
    for w in wrappers.values():
        w.launches = 0
    rows, stats = engine.search_works(works)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {mod: w.launches for mod, w in wrappers.items()}
    for mod, n in launches.items():
        check(n > 0, f"the main path never launched the {mod} kernel")
    print(json.dumps({
        "e2e_seconds": seconds, "works": len(works),
        "query_shingles": stats.num_query_shingles,
        "script_shingles": index.num_shingles, "batches": stats.num_batches,
        "rows": len(rows), "candidates": stats.num_candidates,
        "verified": stats.num_verified,
        "shingle_pairs_per_s": stats.shingle_pairs / seconds,
        "stage_seconds": stats.extra, "launches": launches,
    }), flush=True)

    t1 = time.perf_counter()
    ids = sorted(works)[:sample]
    orows, _ = search_works_oracle({w: works[w] for w in ids}, index, cfg)
    key = lambda r: (r.work_id, r.fan_token_start, r.line_no)  # noqa: E731
    got = [r for r in rows if r.work_id in set(ids)]
    gk, ok_ = {key(r) for r in got}, {key(r) for r in orows}
    parity = len(gk & ok_) / len(gk | ok_) if (gk or ok_) else 1.0
    check(parity == 1.0, f"sample row parity {parity} != 1.0")
    check([r.to_csv_row() for r in got] == [r.to_csv_row() for r in orows],
          "sample rows differ from the oracle's in some field")
    found = {(r.work_id, r.line_no) for r in rows}
    missed = [p for p in planted if (p.work_id, p.line_no) not in found]
    check(not missed, f"{len(missed)} of {len(planted)} planted quotes missed, "
                      f"e.g. {missed[:3]}")
    done("e2e", t0, f"search {seconds:.3f}s; parity {parity} on {len(ids)} works "
                    f"({len(orows)} oracle rows, {time.perf_counter() - t1:.1f}s); "
                    f"{len(planted)} planted quotes found")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--works", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not (ROOT / PKG).is_dir():
        print(f"chip_smoke: {PKG}/ not found beside this script; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    t0 = phase("device")
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    done("device", t0, f"{kind} x{torch.cuda.device_count()} torch {torch.__version__} "
                       f"cuda {torch.version.cuda}")

    from fandom_search_tpu_torch.ops import _cuda

    t0 = phase("build")
    build_s = _cuda.build(force=True)
    _cuda.library()
    done("build", t0, f"nvcc {build_s:.1f}s")

    from fandom_search_tpu_torch.search.engine import SearchEngine

    t0 = phase("world")
    cfg, index, works, planted = make_world(args.seed, args.works)
    engine = SearchEngine(index, cfg, device="cuda")
    done("world", t0, f"{len(index.lines)} lines, {index.num_shingles} script "
                      f"shingles, {len(works)} works, {len(planted)} planted")

    res = kernel_checks(engine, works, args.seed)
    launches = end_to_end(engine, works, planted, index, cfg)

    table = [
        dict(name=name, route="cuda", source=f"{PKG}/{src}", replaces=rep,
             launches=launches[mod], **res[mod])
        for name, mod, _, src, rep in KERNELS
    ]
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
