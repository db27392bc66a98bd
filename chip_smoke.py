#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's search paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--works 10000] [--seed 0]

Run from the root of a checkout.  Phases, each printed with its result
and time:

1. device: CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them.
2. build: compiles fandom_search_tpu_torch/csrc/*.cu with nvcc, and
   builds and loads the native tokenizer from the port's own
   native/fastingest.cpp (fails if it does not load).
3. kernels: K1-K7 (K5 in both its routes) against their plain PyTorch
   versions on the card, at
   the shapes of the paths, on inputs from the end-to-end world; exact
   equality is required (tolerance 0: every output is an integer or one
   f32 division of integers).  Prints warm times of both, the least
   time the card could take (bound) and, where one PyTorch call
   computes the same function, that call's time.  Beside the engine's
   shapes, the shapes the JAX config admits beyond them: K1 at dim 256
   with n 3 and 9; K4 and K5 at LB 65, 96, 128 and 200 with LA 64 and
   100 (timed in turns); K2 and K7 at dim 256 and 512 (2^18 rows, gated)
   and at k 33, 64, 256 and 1000 (2^14 rows, exact and gated); K6 at
   4,096 and 8,192 bits (b1 and s8) and at R 1,025 and 2,048 (2^14 rows,
   exact and gated), every slot equal and timed.  K3: the scan (both
   ops; n 1, 1023, 1025, 2^20, 2^20 + 37) and the compaction (0%, 1%,
   100% set; size below, at and above the count), each call one kernel
   and no memset in the profiler, with CUDA-event and profiler (device)
   times beside torch.cumsum's.  K6: both tensor-core routes (b1, s8)
   on 2^14 rows exact and gated, over bits 32-2048 / R 1-1024, and on
   the full 2^20-row gated batch, every slot; prints the filled slots
   per row, the share of tiles holding an entry and the TOP/s.  K2 and
   K7 (merge="rows"), both on the int8 tensor cores (the check fails if
   either source still calls __dp4a): every case of the edge world in
   utils/topk_cases.py (ns_valid 0 to 3001 around step and tile edges,
   k 1-32, exact and gated, ties across edges, identical padding rows),
   the engine shape gated, 2^14 rows exact at k 10 and 32, and a padding
   batch (the first batch with its last 30% of tokens zero), every slot
   against the plain version; K2 and K7 timed in turns, with TOP/s.
   K2 at dim 128 and k <= 32 runs on warpgroup MMA (topk_dot_wgmma, a
   launch counter of its own that every path at that shape must count);
   it is also held to the plain version at the benchmark cells' launch
   shapes (2^20 x 2^20 and 2^18 x 2^22, gated) and at 2,048 x 2^20 (the
   script in column ranges, gated and exact), on K2_HELD_ROWS rows around
   block boundaries and on a part-filled last block, and timed in turns
   with K7 (the mma.sync producer) beside the bound.
   K5: the packed route (int16 halves on DPX) at the engine's parameters
   and the f32 route at match 2.5 / mismatch -1.25 / gap -0.75, each held
   to its route by the counters, on 8,192 length-sorted 64 x 64 pairs
   (the packed route also equal to K4), a verify batch shaped as the LSH
   path's (16,384 pairs, 64-token windows against 6-13-token script
   segments), unsorted, B 8,191 and 1, widths
   23 x 11, 100 x 64, 1 x 1, the strip shapes and integral parameters
   just inside and outside the packed route's range rule; device and
   event times of K4 and both routes in turns beside the bound (the CUDA
   cores' non-FMA rates; at integral parameters the packed route's own
   instruction count, K4's too).
4. exact end to end: SearchEngine.search_works over the world — a
   2,000-line script (~20k shingles) against 10,000 works of 2,000 words
   with 3 planted quotes each (~20M query shingles, ~20 batches of
   2^20).  K1-K4 must launch, K5 and K6 must not; rows on a 50-work
   sample must equal the NumPy oracle's; every planted quote must be
   found.
5. LSH end to end: a second engine with the LSH prefilter attached
   (LSHConfig() defaults, sw_variant "fast") over the same world.  K1,
   K3, K5's packed route and K6 must launch, K2, K4 and K5's f32 route
   must not; every planted quote must be found; the rows must agree with
   the exact path's on at least 95% of them.  Then the same path over
   600 works at non-integral parameters: K5's f32 route must launch and
   the packed route must not; every planted quote in them found.
6. rows A/B (scripts/merge_rows_ab.py's shape, 2^17 x 2^13, plant
   densities clean, 1% and 5%): topk_dot with merge="rows" (K7) and
   "insert" (K2), counted; K7 equals its plain version in every slot
   and K2 at and above min_keep; both timed per density; merge="rows"
   at min_keep=-inf launches K2, not K7.
7. persist / serve, on a 600-work sample of the world written to disk:
   the CLI's `index` with and without --lsh, `search --index` (rows
   equal a fresh-index search; with --lsh too), loaded LSH codes equal
   fresh ones; a `make_server` on an ephemeral localhost port over the
   loaded index answers 3 POST /search of 200 works (rows equal the
   engine called directly, the first request's also the NumPy
   oracle's), GET /health (a CUDA device) and GET /stats (3 requests);
   `matrix --html` on the search's CSV.
8. profile: one warm `search --index --profile` over the sample; prints
   the device's busy share from the trace (kernel time over wall time).
9. wide configurations: the exact path on the first 600 works at
   ShingleConfig(dim=256), at max_line_tokens=96 and at k 40 with
   batch_queries 2^18; K1-K4 must launch, and the rows of a 40-work
   sample must equal the NumPy oracle's.
10. bucketed end to end: a third engine with the bucketed prefilter
   (BucketedConfig(): triangles, cap 8, load factor 4) over the 10k-work
   world; its tables must come from the native builder.  Where no bucket
   overflows cap (the flat route) K1, K3 and K4 must launch and K2 must
   not; the rows must equal the exact path's, every planted quote found;
   every K3 call of the first batch's candidate stage must equal its
   plain version on the same inputs; prints overflow_frac,
   bucketed_risk_frac, the stage seconds, the budget retries and the
   launches; one warm fused step under sync debug mode.
11. bucketed big: the JAX bench's flagship bucketed world
   (fandom_search_tpu/bench.py's stage_bucketed_e2e_big: seed 23, 30,000
   words, a script of 2^20 / 12 lines of 8-17 words at zipf 1.01, about
   2^20 shingles, 480 works of 2,000 words with 3 quotes and one edit
   each, zipf 1.01) under BucketedConfig(pairs="all"), hybrid on.  The
   exact path and the bucketed one, each searched twice: the rows must
   agree (missing 0, extra 0); overflow_frac > 0 and K2 launched by the
   hybrid's stage 2; on the first batch, every K3 call of the stage (the
   scans of 15.7M probe lengths and of the 6.3M-slot pair stream, the
   max scan, the compactions) must equal its plain version on the same
   inputs, and stage 2's K2 call must equal plain in every slot on
   16,384 of its rows at the full NS; prints the native table build's
   seconds, the risk
   fraction, both paths' seconds, torch.cuda.max_memory_allocated, the
   thresholded recall of the first batch's triples against K2's exact
   top-k, and per batch the device ms (profiler) of the flat stage's
   parts: geometry, segment stream, gather-dot, sort, compaction and
   stage 2 (and of K2 alone in it); one warm fused step under sync debug
   mode.
12. bucketed CLI: `index --bucketed --bucketed-pairs all`, then
   `search --index ... --bucketed` on the 600-work sample; the CSV must
   equal the engine's over the loaded tables; prints the tables' load
   seconds.

13. compress: the exact path over the 10k-work world with
   stream_compress (a fresh engine: batch 1 bootstraps the vocab table
   raw), in turns with warm raw searches on the exact engine (raw,
   compressed, compressed again, raw); rows equal the raw run's and the
   oracle sample's; every batch's decoded stream_ext, read back after
   the run, equal to its raw buffer bit for bit; prints the batches
   encoded and raw, the bytes of each batch's upload both ways, the table
   uploads, the misses, e2e and s_batchgen in turns, the encoder's host
   seconds and one batch's upload and decode ms; one warm compressed step
   (decode included) under sync debug mode.  Then the decode's patch
   path on a world of its own at batch_queries 2^16: a batch carrying
   real patches, a later batch over the patch budget sent raw with its
   words admitted by count, and a table that goes up again after it
   grew; every decoded stream_ext bit-exact, rows equal a raw engine's.
14. sharded: the sharded engine on a 2 x 2 mesh (four distinct cards
   where the machine has them, else four logical shards of cuda:0, as
   printed).  One fused step on the first batch with every kernel call
   held to its plain version at the path's shapes: K1 on each works slice
   with its 5-token halo, K2 on each of the four blocks (the second script
   shard partial), each slice's merged top-k against single-device K2 and
   plain on the whole script in values and indices, every K3 compaction,
   K4 on each works shard.  The 10k-work search, counted: rows equal one
   device's, sample parity 1.0; one step under sync debug mode.  Then
   over 600 works: the mesh with stream compression, with the LSH
   prefilter at sw_variant fast (K5, K6; the first batch's step with
   every K3 compaction and K5's packed route on each works shard held to
   plain), with attach_bucketed_prefilter and with
   attach_bucketed_prefilter_sharded (the first batch's stage with K1 on
   each works slice and every K3 scan and compaction, the cross-shard
   ones included, held to plain), each equal to one device's rows.
15. sharded dryrun: __graft_entry__.py's dry-run world (seed 7, 15
   uniform and 15 stopword-led lines, 40 works and one longer than the
   batch cap) on a 2 x 4 mesh, the fused engine and the sharded bucketed
   hybrid: the first batch's step with every kernel held to plain (three
   of the four script shards lie past the script's end: K2 at ns_valid
   0), and the hybrid's first-batch stage likewise (K1 per works slice,
   every K3 call, the cross-shard compactions, K2's rescue of the
   gathered at-risk rows); rows equal the port's oracle, at-risk queries
   above 0.
16. multihost: a one-rank NCCL world (tcp://127.0.0.1 on a free port,
   world 1, rank 0) runs the sharded engine on a 2 x 2 grid of the
   world's cells (four logical shards of cuda:0), every exchange an
   all_gather, over 600 works: the first batch's step with every K1, K2,
   merge, K3 and K4 call held to plain, the search counted (rows equal
   the one-process mesh's and one device's, sample parity 1.0), one step
   under sync debug mode, the world left; then `search --multihost
   --num-processes 1 --process-id 0 --coordinator 127.0.0.1:<port> --mesh
   1x1` and the same search without --multihost on the 600 works written
   to disk: byte-equal CSVs.  Prints the seconds, the all_gathers and the
   card's name and power limit.
17. host verbs, on the host only: `format` on the world's script (one row
   a script line); `clean` and `getmeta` on three AO3-shaped pages (one
   broken) where bs4 is installed, `search --reference` on 20 works
   where sklearn and Levenshtein are (rows equal ReferenceSearch's,
   planted quotes found); prints which ran and which packages were
   absent.
18. bench: `python -m fandom_search_tpu_torch bench` in a temporary
   directory, in a process of its own, at the JAX bench's default shapes
   (fandom_search_tpu/bench.py) without the 100k-work scale stage
   (BENCH_SCALE_WORKS=0) and with no time budget: every stage from
   kernel_engine to bucketed_e2e_big must complete.  The last stdout line
   must be the six-key result line with backend "gpu", degraded false and
   a positive value; in the details, K2's recall@10 against the NumPy
   oracle, the e2e sample's row parity and every guaranteed recall must be
   1.0 and recall_gate_ok true; the bench's own launch counters (its
   stage_launches, counted from 0 in its process) must show K1, K2, K3,
   K4 and K6 launched and K5 and K7 not.  Prints the result line, each
   stage's seconds and the bench's rates.
19. bench shapes: the bench's kernels held to their plain versions at
   the bench's own shapes, on the data its helpers make
   (fandom_search_tpu_torch/bench.py: kernel_data, sw_data,
   bucketed_streams, skew_streams at its sizes), every slot equal and
   outside its counted run: K1 on 2^17 + 5 and 2^22 + 5 tokens; K2 gated
   and exact at 2^17 x 8,192 and gated at 2^17 x 2^22 (the bucketed_huge
   and bucketed_english_huge references) on K2_HELD_ROWS rows; K6
   ungated and gated at 2^17 x 8,192, and the bench's LSH recall@10
   recomputed from the plain version's candidates; K4 on the sw stage's
   8,192 pairs; the bucketed_huge flat stage and the
   bucketed_english_huge hybrid stage (its at-risk share equal to the
   bench's) with every K1, K2 and K3 call held by stage_vs_plain.  Each
   entry lands in the kernel line under "bench_shapes".  The e2e stages
   run phase 2's engine shapes; bucketed_e2e_big is phase 11's world.
Phases 13-16 run right after phase 4, on its rows and oracle sample;
phases 17, 18 and 19 run last.

It prints the kernel table as one JSON line, then, as its last line,
{"ok": true, "device": {...}}.  Any failure exits non-zero before that.
Imports nothing of JAX and nothing of fandom_search_tpu itself: only the
port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "fandom_search_tpu_torch"
KERNELS = (
    # key (its launch counter: the port's bench.COUNTERS), name, source,
    # TPU kernel it replaces, the path whose launches the table reports
    ("embed_shingles", "K1 embed", "csrc/embed.cu", "fandom_search_tpu/ops/embed.py:41",
     "exact"),
    ("topk_dot", "K2 distance_topk", "csrc/distance_topk.cu",
     "fandom_search_tpu/ops/distance_topk.py:104", "exact"),
    ("scan1d_i32", "K3 scan", "csrc/scan.cu", "fandom_search_tpu/ops/scan.py:61", "exact"),
    ("sw_wide", "K4 smith_waterman", "csrc/smith_waterman.cu",
     "fandom_search_tpu/ops/smith_waterman.py:452", "exact"),
    ("sw_lane_i16", "K5 smith_waterman_lane, packed int16 route (DPX)",
     "csrc/smith_waterman_lane.cu", "fandom_search_tpu/ops/smith_waterman.py:233", "lsh"),
    ("sw_lane_f32", "K5 smith_waterman_lane, f32 route", "csrc/smith_waterman_lane.cu",
     "fandom_search_tpu/ops/smith_waterman.py:233", "lsh_f32"),
    ("hamming_topk", "K6 hamming_topk", "csrc/hamming_topk.cu",
     "fandom_search_tpu/ops/lsh.py:121", "lsh"),
    ("topk_dot_rows", "K7 distance_topk_rows", "csrc/distance_topk_rows.cu",
     "fandom_search_tpu/ops/distance_topk.py:418", "rows_ab"),
    ("topk_dot_wgmma", "K2 distance_topk, warpgroup-MMA route (dim 128, k <= 32)",
     "csrc/distance_topk.cu", "fandom_search_tpu/ops/distance_topk.py:104", "exact"),
)
# which kernels each path must launch; the others must stay at 0 (K2 at
# the engine's dim 128 and k <= 32 runs on warpgroup MMA, topk_dot_wgmma)
EXACT = ("embed_shingles", "topk_dot", "topk_dot_wgmma", "scan1d_i32", "sw_wide")
PATHS = {
    "exact": EXACT,
    # the exact path at dim 256 or k 40: K2 on the mma.sync producer
    "exact_wide": ("embed_shingles", "topk_dot", "scan1d_i32", "sw_wide"),
    "lsh": ("embed_shingles", "scan1d_i32", "sw_lane_i16", "hamming_topk"),
    # the LSH path at non-integral Smith-Waterman parameters: K5's f32 route
    "lsh_f32": ("embed_shingles", "scan1d_i32", "sw_lane_f32", "hamming_topk"),
    "rows_ab": ("topk_dot", "topk_dot_wgmma", "topk_dot_rows"),
    # index (+ --lsh), search --index (+ --lsh: K6, then K4 verifies)
    "index_search": EXACT + ("hamming_topk",),
    "serve": EXACT,
    "profile": EXACT,
    # the bucketed prefilter's flat route (no bucket over cap): K1, K3,
    # K4 verifying; its hybrid adds K2 for the queries at risk
    "bucketed": ("embed_shingles", "scan1d_i32", "sw_wide"),
    "bucketed_hybrid": EXACT,
    # the exact path with stream compression; the sharded engine (its
    # exact step, with compression, with the LSH prefilter at sw_variant
    # fast, with either bucketed attach on the flat route)
    "compress": EXACT,
    "sharded": EXACT,
    "sharded_compress": EXACT,
    "sharded_lsh": ("embed_shingles", "scan1d_i32", "sw_lane_i16", "hamming_topk"),
    "sharded_bucketed": ("embed_shingles", "scan1d_i32", "sw_wide"),
    "sharded_bucketed_sharded": ("embed_shingles", "scan1d_i32", "sw_wide"),
    # the dry-run world on a 2 x 4 mesh: fused, and the sharded hybrid
    "dryrun_fused": EXACT,
    "dryrun_hybrid": EXACT,
    # the sharded engine in a one-rank NCCL world (--multihost)
    "multihost": EXACT,
    # the port's bench (`bench`): K1-K4 and K6, at sw_variant "wide"
    "bench": EXACT + ("hamming_topk",),
}
# the bench phase's stages: the JAX bench's defaults without `scale`
BENCH_STAGES = ("kernel_engine", "kernel_exact", "cpu_oracle", "sw", "sharded", "lsh",
                "bucketed_small", "e2e", "bucketed_e2e_parity", "bucketed_big",
                "bucketed_english", "bucketed_huge", "bucketed_english_huge",
                "bucketed_e2e_big")
BENCH_LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "backend", "degraded"}
# NVIDIA H100 SXM peaks (data sheet, dense): HBM bytes/s, and int8
# tensor-core operations/s (the port's bench.INT8_PEAK_OPS_S; set in main)
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 0.0
# The CUDA cores' rates, in results a clock an SM, from the table
# "Throughput of Native Arithmetic Instructions" of NVIDIA's CUDA C++
# Programming Guide, compute capability 9.0: 32-bit integer add, 32-bit
# integer multiply and multiply-add, "compare, minimum, maximum" and
# 32-bit bitwise operations 64; 32-bit floating-point add 128 (the data
# sheet's 67 TFLOP/s counts an FMA as two operations, and no
# Smith-Waterman or scan operation is an FMA).  On 132 SMs at the card's
# boost clock (nvidia-smi clocks.max.sm; set in main).
SMS = 132
INT32_LANES = SMS * 64
INT32_OPS_S = INT32_LANES * 1.98e9
# worker processes for the NumPy oracle of the serve phase (the card's
# host has 8 cores)
ORACLE_PROCS = 8
# A Smith-Waterman cell in f32 (K4, K5's f32 route): four max, the compare
# and the select of the substitution score at 64 a clock an SM, and two
# adds at 128; the six set the bound (6 / 64 > 8 / 128 at one issue a
# clock for each of an SM's four schedulers).
SW_ALU_OPS_PER_CELL = 6
# Where the parameters admit K5's packed route (i16_route), the same
# scores take fewer instructions: per register of two cells
# (csrc/smith_waterman_lane.cu), three DPX instructions (VIADDMNMX: diag +
# sub, max(up + gap, .) and max(left + gap, ., 0)), the running best
# (__vimax3_s16x2 over two cells and a masked __vmaxs2 a row: 0.5625 at
# sixteen columns a lane) and the substitution score (two compares, two
# selects, one byte permute), all at the 64 a clock an SM of the table's
# compare, minimum and maximum row.  K4 at those parameters computes the
# same function, so it is held to the same bound.
SW_I16_OPS_PER_PAIR = 8.5625
# Host sleep at both ends of a profiled span (device_events).  On an H100
# (scripts/torch_profiler_window.py) kernels sat up to 5.4 ms before their
# own launch on the trace's clock, and one-call traces of K4 held no kernel
# 7 times in 1,500 with no sleep, 6 with 1 ms and 0 with 10 ms.
PROFILE_PAD_S = 0.01
# Tiny kernels launched ahead of a profiled span: on an H100 a trace loses
# its first device events, none at first and more as the process ages,
# whatever the pad (scripts/torch_profiler_lead.py); the span's own events
# are picked out by correlation id (device_events).
PROFILE_LEAD = 256
PROFILE_SPAN = "chip_smoke.profiled"
# Rows of a bucketed stage's K2 call held to plain (stage_vs_plain): the
# plain version takes about a second for 16,384 rows at NS 2^20.
K2_HELD_ROWS = 1 << 14
# the card's name and power limit (nvidia-smi; set in main)
CARD = ""


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


def bound(nbytes: float, ops: float, ops_rate: float):
    """The least time for the work: the larger of its bytes over the
    memory rate and its operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def sw_bound(a, b, len_a, len_b, c):
    """K4's or K5's bound on pairs (a, b) of lengths (len_a, len_b) at the
    Smith-Waterman parameters of ``c``: the tokens inside the lengths and
    the lengths read once, the scores written once; the cells at the
    packed route's operations where ``i16_route`` admits the parameters,
    else at the f32 cell's."""
    from fandom_search_tpu_torch.ops.smith_waterman import i16_route

    na = len_a.long().clamp(0, a.shape[1])
    nb = len_b.long().clamp(0, b.shape[1])
    cells = int((na * nb).sum())
    packed = i16_route(c.sw_match, c.sw_mismatch, c.sw_gap, a.shape[1], b.shape[1])
    per_cell = SW_I16_OPS_PER_PAIR / 2 if packed else SW_ALU_OPS_PER_CELL
    return bound(int(na.sum() + nb.sum()) * 4 + a.shape[0] * 12, per_cell * cells, INT32_OPS_S)


def zero_counters():
    from fandom_search_tpu_torch import bench

    for w, attr in bench.counters().values():
        setattr(w, attr, 0)


def read_counters():
    from fandom_search_tpu_torch import bench

    return bench.read_counters()


def check_launches(path, launches):
    """Exactly the kernels of ``path`` launched."""
    for key, n in launches.items():
        if key in PATHS[path]:
            check(n > 0, f"the {path} path never launched {key}")
        else:
            check(n == 0, f"the {path} path launched {key} {n} times")


def counted(path, run):
    """Run ``run()`` with every launch counter at 0; check that exactly
    the kernels of ``path`` launched (``path`` None: the caller checks);
    return (result, launches)."""
    zero_counters()
    out = run()
    launches = read_counters()
    if path is not None:
        check_launches(path, launches)
    return out, launches


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
    script_text = make_script(rng, vocab, num_lines=2000, words_per_line=(6, 14))
    lines = parse_script(script_text)
    index = build_script_index(lines, cfg.shingle, cfg.search)
    works, planted = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=num_works,
        words_per_work=2000, quotes_per_work=3, vocab=vocab,
    )
    return cfg, index, works, planted, script_text


def first_batch_stream(engine, works):
    """The int32 token stream of the engine's first batch (2^20 + n - 1)."""
    import numpy as np
    import torch

    from fandom_search_tpu_torch.data.fast_tokenizer import tokenize_many

    items = sorted(tokenize_many(dict(sorted(works.items())[:1000])).items())
    ext, nspans, _, _ = next(iter(engine._batches(items)))
    t_pad = ext.shape[0] - 2 * nspans
    return torch.from_numpy(ext[:t_pad].view(np.int32).copy()).to(engine.device)


def no_host_sync(engine, works, path, encoded=False):
    """One warm fused step of the first batch under
    ``torch.cuda.set_sync_debug_mode("error")``: an op inside the step
    that waits for the device (a copy from pageable memory, .item(),
    nonzero, boolean-mask indexing) raises, and the check fails.  With
    ``encoded`` the batch must come out of a warm stream encoder as an
    EncodedBatch, and the step includes its decode on the device (the
    upload and the table's upload stay outside)."""
    import torch

    from fandom_search_tpu_torch.data.fast_tokenizer import tokenize_many
    from fandom_search_tpu_torch.search.engine import EncodedBatch, _decode_stream

    t0 = phase(f"{path} no host sync")
    items = sorted(tokenize_many(dict(sorted(works.items())[:1000])).items())
    payload, nspans, _, _ = next(iter(engine._batches(items)))
    budgets = (engine._cand_budget, engine._verify_budget)
    check(isinstance(payload, EncodedBatch) == encoded,
          f"{path}: the first batch is {type(payload).__name__}")
    if encoded:
        c_dev, table = engine._upload(payload.c_ext), engine._vocab_table_dev()

        def step():
            ext_dev = _decode_stream(c_dev, table, t_pad=payload.t_pad, p_pad=payload.p_pad,
                                     nspans=nspans)
            return engine._fused_call(ext_dev, nspans, *budgets)
    else:
        ext_dev = engine._upload(payload)

        def step():
            return engine._fused_call(ext_dev, nspans, *budgets)
    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    except RuntimeError as e:
        check(False, f"the {path} fused step waits for the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    done(f"{path} no host sync", t0, "one fused step ran with sync debug mode 'error'")


def kernel_checks(engine, works, seed: int):
    """Phase 3: every kernel against its plain version at path shapes."""
    import numpy as np
    import torch

    from fandom_search_tpu_torch.ops.embed import embed_shingles, embed_shingles_plain
    from fandom_search_tpu_torch.ops.smith_waterman import (
        sw_lane, sw_normalized_plain, sw_wide,
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
    n = dix.mults.shape[0]
    res["embed_shingles"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: embed_shingles(tok, dix.mults), 20),
        plain_ms=cuda_ms(lambda: embed_shingles_plain(tok, dix.mults), 3),
        library_ms=None,
        shape=f"T={tok.shape[0]}",
        # tokens and multipliers in, int8 rows out; one 32-bit integer
        # multiply per (row, lane, position)
        **bound(tok.numel() * 4 + dix.mults.numel() * 4 + got.numel(),
                got.numel() * n, INT32_OPS_S),
    )
    # dim 256 at n 3 and 9 on the same stream, every slot
    from fandom_search_tpu_torch.data.hashing import derive_sign_mults

    res["embed_shingles"]["new_shapes"] = shapes = {}
    for n2 in (3, 9):
        mu = torch.from_numpy(derive_sign_mults(cfg.shingle.seed, n2, 256)
                              .view(np.int32).copy()).to(dev)
        t2 = tok[: cfg.search.batch_queries + n2 - 1].contiguous()
        g2 = embed_shingles(t2, mu)
        sync()
        check(torch.equal(g2, embed_shingles_plain(t2, mu)),
              f"K1 differs from plain at n {n2}, dim 256")
        shapes[f"n{n2}_dim256"] = dict(
            ms=cuda_ms(lambda: embed_shingles(t2, mu), 20),
            **bound(t2.numel() * 4 + mu.numel() * 4 + g2.numel(), g2.numel() * n2,
                    INT32_OPS_S))
    done("K1 embed", t0, f"T={tok.shape[0]} M={got.shape[0]} {res['embed_shingles']}")

    res.update(topk_check(engine, tok, got))

    res["scan1d_i32"] = scan_check(dev, rng)

    # K4 on 8192 length-sorted 64 x 64 pairs with len-0 and ragged rows
    t0 = phase("K4 smith_waterman")
    bsz, la, lb = 8192, cfg.search.window_tokens, cfg.search.max_line_tokens
    A, B, LA_, LB_, cells = sw_engine_pairs(rng, dev, bsz, la, lb)
    xc = cfg.search
    g = sw_wide(A, B, LA_, LB_, xc)
    sync()
    w = sw_normalized_plain(A, B, LA_, LB_, xc.sw_match, xc.sw_mismatch, xc.sw_gap)
    sync()
    err = float((g - w).abs().max())
    check(torch.equal(g, w), f"K4 differs from plain: max |err| {err}")
    plain_ms = cuda_ms(lambda: sw_normalized_plain(
        A, B, LA_, LB_, xc.sw_match, xc.sw_mismatch, xc.sw_gap), 3)
    shape = f"B={bsz} {la}x{lb} length-sorted, {cells} cells"
    res["sw_wide"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: sw_wide(A, B, LA_, LB_, xc), 20),
        plain_ms=plain_ms, library_ms=None, shape=shape, **sw_bound(A, B, LA_, LB_, xc),
    )
    done("K4 smith_waterman", t0, str(res["sw_wide"]))

    res.update(sw_lane_check(xc, (A, B, LA_, LB_), cells, g, w, res["sw_wide"], rng))

    res["hamming_topk"] = hamming_check(engine, got)
    return res


def sw_lane_check(xc, pairs, cells, k4_out, want, k4_res, rng):
    """K5's two routes against the plain version in every slot: the packed
    route (``fs_sw_lane_i16``) at the engine's parameters and the f32
    route (``fs_sw_lane``) at match 2.5, mismatch -1.25, gap -0.75, each
    checked to take its route by the counters; on the 8,192 length-sorted
    pairs (the packed route also equal to K4), a verify batch as the LSH
    path makes them (``sw_verify_batch``; K4 too), the 8,192 pairs
    unsorted, B 8,191 and 1, widths 23 x 11, 100 x 64 and 1 x 1, the strip
    shapes LA 64/100 x LB 65/96/128/200 (timed in turns with K4), and
    integral parameters just inside and just outside the packed route's
    range rule.  Device and event times of K4 and both routes in turns at
    the 8,192-pair shape, and device times on the verify batch, beside
    their bounds."""
    import dataclasses

    import torch

    from fandom_search_tpu_torch.ops.smith_waterman import (
        i16_route, sw_lane, sw_normalized_plain, sw_wide,
    )

    t0 = phase("K5 smith_waterman_lane")
    A, B, LA_, LB_ = pairs
    dev = A.device
    xf = dataclasses.replace(xc, sw_match=2.5, sw_mismatch=-1.25, sw_gap=-0.75)
    check(i16_route(xc.sw_match, xc.sw_mismatch, xc.sw_gap, A.shape[1], B.shape[1])
          and not i16_route(xf.sw_match, xf.sw_mismatch, xf.sw_gap, A.shape[1], B.shape[1]),
          "the engine's parameters must take the packed route, 2.5/-1.25/-0.75 the f32 one")

    def plain(a, b, la, lb, c):
        return sw_normalized_plain(a, b, la, lb, c.sw_match, c.sw_mismatch, c.sw_gap)

    def routed(a, b, la, lb, c, what, want=None):
        """K5 on the route ``i16_route`` names: equal to plain in every
        slot, counted once on that route and never on the other."""
        packed = i16_route(c.sw_match, c.sw_mismatch, c.sw_gap, a.shape[1], b.shape[1])
        route = "packed" if packed else "f32"
        want = plain(a, b, la, lb, c) if want is None else want
        n16, n32 = sw_lane.launches_i16, sw_lane.launches_f32
        got = sw_lane(a, b, la, lb, c)
        torch.cuda.synchronize()
        moved = (sw_lane.launches_i16 - n16, sw_lane.launches_f32 - n32)
        check(moved == ((1, 0) if packed else (0, 1)),
              f"K5 on {what} at {c.sw_match}/{c.sw_mismatch}/{c.sw_gap}: counters moved "
              f"{moved}, not once on the {route} route")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        check(torch.equal(got, want), f"K5 ({route} route) differs from plain on {what} "
                                      f"at {c.sw_match}/{c.sw_mismatch}/{c.sw_gap}: "
                                      f"max |err| {err}")
        return got, err

    bsz = A.shape[0]
    g16, e16 = routed(A, B, LA_, LB_, xc, f"{bsz} sorted pairs", want)
    check(torch.equal(g16, k4_out), "K5's packed route differs from K4")
    _, e32 = routed(A, B, LA_, LB_, xf, f"{bsz} sorted pairs")
    cases = [f"{bsz} sorted"]
    # ragged batches and widths, both routes
    VA, VB, VLA, VLB, vcells = sw_verify_batch(rng, dev)
    edge = {
        "verify batch": (VA, VB, VLA, VLB),
        f"{bsz} unsorted": sw_engine_pairs(rng, dev, bsz=bsz, sort=False)[:4],
        f"B {bsz - 1}": sw_engine_pairs(rng, dev, bsz=bsz - 1)[:4],
        "B 1": sw_engine_pairs(rng, dev, bsz=1)[:4],
    }
    widths = {}  # other operand widths the wrappers take, K4's too
    la = A.shape[1]
    for wa, wb in ((23, 11), (100, 64), (1, 1)):
        a2, b2 = A[:, :wa].contiguous(), B[:, :wb].contiguous()
        if wa > la:
            a2 = torch.cat([A, A[:, : wa - la]], dim=1).contiguous()
        widths[f"{wa}x{wb}"] = (a2, b2, LA_.clamp(max=wa), LB_.clamp(max=wb))
    for what, (a2, b2, la2, lb2) in {**edge, **widths}.items():
        w2, e = routed(a2, b2, la2, lb2, xc, what)
        e16 = max(e16, e)
        e32 = max(e32, routed(a2, b2, la2, lb2, xf, what)[1])
        if what in widths or what == "verify batch":
            check(torch.equal(sw_wide(a2, b2, la2, lb2, xc), w2), f"K4 differs from plain at {what}")
        cases.append(what)
    # integral parameters just inside and just outside the range rule
    # (max |p| * (LA + LB + 1) <= 32767), and positive mismatch and gap
    for (a2, b2, la2, lb2), what in ((pairs, "64x64"),
                                     (sw_pairs(rng, 1024, 100, 200, dev)[:4], "100x200")):
        edge_p = 32767 // (a2.shape[1] + b2.shape[1] + 1)
        for m, x, gp, packed in ((edge_p, -1, -1, True), (edge_p + 1, -1, -1, False),
                                 (2, 1, 1, True)):
            c = dataclasses.replace(xc, sw_match=float(m), sw_mismatch=float(x), sw_gap=float(gp))
            check(i16_route(c.sw_match, c.sw_mismatch, c.sw_gap, a2.shape[1], b2.shape[1])
                  == packed, f"i16_route at {m}/{x}/{gp} on {what} is not {packed}")
            routed(a2, b2, la2, lb2, c, what)
            cases.append(f"{what} at {m}/{x}/{gp} ({'packed' if packed else 'f32'})")
    # segments wider than 64 tokens (max_line_tokens > 64): strips, both
    # routes and K4, timed in turns (K4, packed, f32, f32, packed, K4)
    wide = {}
    for wa in (64, 100):
        for wb in (65, 96, 128, 200):
            A2, B2, LA2, LB2, cells2 = sw_pairs(rng, 4096, wa, wb, dev)
            w2, e = routed(A2, B2, LA2, LB2, xc, f"LA {wa} x LB {wb}")
            e16 = max(e16, e)
            e32 = max(e32, routed(A2, B2, LA2, LB2, xf, f"LA {wa} x LB {wb}")[1])
            check(torch.equal(sw_wide(A2, B2, LA2, LB2, xc), w2),
                  f"K4 differs from plain at LA {wa}, LB {wb}")
            t = {"k4": [], "i16": [], "f32": []}
            for key, fn, c in (("k4", sw_wide, xc), ("i16", sw_lane, xc), ("f32", sw_lane, xf),
                               ("f32", sw_lane, xf), ("i16", sw_lane, xc), ("k4", sw_wide, xc)):
                t[key].append(cuda_ms(lambda: fn(A2, B2, LA2, LB2, c), 10))
            wide[f"{wa}x{wb}"] = dict(k4_ms=min(t["k4"]), k5_i16_ms=min(t["i16"]),
                                      k5_f32_ms=min(t["f32"]), cells=cells2)
            cases.append(f"LA {wa} x LB {wb}")
    print(f"[K5 smith_waterman_lane] both routes equal to plain in every slot on: "
          f"{'; '.join(cases)}; strips (event ms, in turns with K4) {wide}", flush=True)

    # times at the 8,192-pair shape and on the verify batch, in turns: K4,
    # packed, f32, f32, packed, K4; device ms from the profiler (one kernel,
    # no memset a call) and event ms
    calls = {"k4": lambda: sw_wide(A, B, LA_, LB_, xc),
             "i16": lambda: sw_lane(A, B, LA_, LB_, xc),
             "f32": lambda: sw_lane(A, B, LA_, LB_, xf)}
    vcalls = {"k4": lambda: sw_wide(VA, VB, VLA, VLB, xc),
              "i16": lambda: sw_lane(VA, VB, VLA, VLB, xc),
              "f32": lambda: sw_lane(VA, VB, VLA, VLB, xf)}
    dev_ms = {k: [] for k in calls}
    ev_ms = {k: [] for k in calls}
    vdev_ms = {k: [] for k in calls}
    for key in ("k4", "i16", "f32", "f32", "i16", "k4"):
        dev_ms[key].append(one_kernel_ms(calls[key], f"sw {key}"))
        ev_ms[key].append(cuda_ms(calls[key], 20))
        vdev_ms[key].append(one_kernel_ms(vcalls[key], f"sw {key} on the verify batch"))
    # the packed route (and K4) at the engine's integral parameters: the
    # packed instructions; the f32 route at 2.5/-1.25/-0.75: the f32 cell's
    b16, b32 = sw_bound(A, B, LA_, LB_, xc), sw_bound(A, B, LA_, LB_, xf)
    vb16 = sw_bound(VA, VB, VLA, VLB, xc)
    base = dict(plain_ms=k4_res["plain_ms"], library_ms=None)
    out = {
        "sw_lane_i16": dict(
            max_abs_err=e16, ms=min(ev_ms["i16"]), device_ms=min(dev_ms["i16"]),
            runs_device_ms=dev_ms["i16"], runs_ms=ev_ms["i16"], shape=k4_res["shape"],
            verify_batch_device_ms=min(vdev_ms["i16"]), verify_batch_bound_ms=vb16["bound_ms"],
            new_shapes=wide, **base, **b16),
        "sw_lane_f32": dict(
            max_abs_err=e32, ms=min(ev_ms["f32"]), device_ms=min(dev_ms["f32"]),
            runs_device_ms=dev_ms["f32"], runs_ms=ev_ms["f32"],
            shape=k4_res["shape"] + ", match 2.5, mismatch -1.25, gap -0.75",
            verify_batch_device_ms=min(vdev_ms["f32"]), new_shapes=wide, **base, **b32),
    }
    k4_res.update(device_ms=min(dev_ms["k4"]), runs_device_ms=dev_ms["k4"],
                  runs_ms_in_turns=ev_ms["k4"], verify_batch_device_ms=min(vdev_ms["k4"]),
                  new_shapes=wide)
    print(json.dumps({"sw_times_8192": {
        "card": CARD, "cells": cells,
        "bound_ms": {"k4 and packed at 2/-1/-1 (packed instructions)": b16["bound_ms"],
                     "f32 route at 2.5/-1.25/-0.75 (f32 cell)": b32["bound_ms"]},
        "device_ms": dev_ms, "event_ms": ev_ms,
        "verify_batch": {"pairs": VA.shape[0], "live": int((VLB > 0).sum()), "cells": vcells,
                         "bound_ms": vb16["bound_ms"], "bound_by": vb16["bound_by"],
                         "device_ms": vdev_ms}}}), flush=True)
    done("K5 smith_waterman_lane", t0, f"packed {out['sw_lane_i16']}; f32 {out['sw_lane_f32']}")
    return out


def sw_engine_pairs(rng, dev, bsz: int = 8192, la: int = 64, lb: int = 64, sort: bool = True):
    """``bsz`` pairs of at most la x lb with len-0 and full rows and a's
    first words equal to b's in every third pair, sorted by -(len_a +
    len_b) as the engine's ``verify_pairs`` sorts them (or not); (a, b,
    len_a, len_b) on ``dev`` and the cells they need."""
    import numpy as np
    import torch

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
    order = (np.argsort(-(len_a + len_b), kind="stable") if sort
             else rng.permutation(bsz))
    to_dev = lambda x: torch.from_numpy(np.ascontiguousarray(x[order]).view(np.int32)).to(dev)  # noqa: E731
    cells = int((np.minimum(len_a, la).astype(np.int64) * np.minimum(len_b, lb)).sum())
    return to_dev(a), to_dev(b), to_dev(len_a), to_dev(len_b), cells


# The script segments' lengths in the batches the LSH path hands K5 in this
# world (10,000 works; scripts/torch_sw_i16_ab.py on an H100): 20 batches
# of 16,384 pairs, 5,102-13,512 of them live, every window 64 tokens.
VERIFY_LEN_B = {6: 18218, 7: 21842, 8: 27827, 9: 30870, 10: 35790, 11: 36849, 12: 41851,
                13: 44314}


def sw_verify_batch(rng, dev, bsz: int = 16384, live: int = 13250):
    """A batch as the LSH path's ``verify_pairs`` hands K5: ``live`` pairs
    of a 64-token window against a 64-wide script segment of 6-13 tokens
    (in VERIFY_LEN_B's proportions; the segment inside the window in every
    third pair), the rest empty, sorted by -(len_a + len_b); (a, b, len_a,
    len_b) on ``dev`` and the cells they need."""
    import numpy as np
    import torch

    lens = np.array(sorted(VERIFY_LEN_B))
    freq = np.array([VERIFY_LEN_B[k] for k in lens], dtype=np.float64)
    a = rng.integers(1, 60, size=(bsz, 64)).astype(np.uint32)
    b = rng.integers(1, 60, size=(bsz, 64)).astype(np.uint32)
    len_a = np.zeros(bsz, np.int32)
    len_b = np.zeros(bsz, np.int32)
    len_a[:live] = 64
    len_b[:live] = rng.choice(lens, size=live, p=freq / freq.sum())
    for i in range(0, live, 3):
        a[i, 20 : 20 + len_b[i]] = b[i, : len_b[i]]
    order = np.argsort(-(len_a + len_b), kind="stable")
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x[order]).view(np.int32)).to(dev)  # noqa: E731
    cells = int((len_a.astype(np.int64) * len_b).sum())
    return t(a), t(b), t(len_a), t(len_b), cells


def sw_pairs(rng, bsz, la, lb, dev):
    """``bsz`` length-sorted pairs of at most la x lb with len-0 and full
    rows and a's words inside b past column 40; (a, b, len_a, len_b) on
    ``dev`` and the cells they need."""
    import numpy as np
    import torch

    a = rng.integers(1, 60, size=(bsz, la)).astype(np.uint32)
    b = rng.integers(1, 60, size=(bsz, lb)).astype(np.uint32)
    len_a = rng.integers(0, la + 1, size=bsz).astype(np.int32)
    len_b = rng.integers(0, lb + 1, size=bsz).astype(np.int32)
    len_a[:32] = 0
    len_b[32:64] = 0
    len_a[64:96], len_b[64:96] = la, lb
    for i in range(96, bsz, 3):
        m = int(min(len_a[i], len_b[i] - 40))
        if m > 0:
            b[i, 40 : 40 + m] = a[i, :m]
    order = np.argsort(-(len_a + len_b), kind="stable")
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x[order]).view(np.int32)).to(dev)  # noqa: E731
    cells = int((len_a.astype(np.int64) * len_b).sum())
    return t(a), t(b), t(len_a), t(len_b), cells


def topk_check(engine, tok, q):
    """K2 and K7 against their plain version in every slot: the edge world
    of ``utils/topk_cases.py`` (every ns_valid, k and mode), the engine
    shape gated, 2^14 rows exact at k 10 and 32, and a padding batch (the
    first batch with its last 30% of tokens zero, as the engine pads a
    partial batch); warm times, TOP/s and the bound."""
    import torch

    from fandom_search_tpu_torch.ops.distance_topk import (
        min_keep_int, topk_dot, topk_dot_plain,
    )
    from fandom_search_tpu_torch.ops.embed import embed_shingles
    from fandom_search_tpu_torch.utils import topk_cases as tc

    for src in ("distance_topk.cu", "distance_topk_rows.cu"):
        check("dp4a" not in (ROOT / PKG / "csrc" / src).read_text(),
              f"csrc/{src} still calls __dp4a: K2 and K7 score on the tensor cores")
    dev = q.device
    cfg = engine.cfg
    dim = cfg.shingle.dim
    inf = float("inf")

    def same(got, want):
        return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    def err(got, want):
        ok = want[0] > -1e38
        return float((got[0][ok] - want[0][ok]).abs().max()) if bool(ok.any()) else 0.0

    t0 = phase("K2/K7 edge cases")
    eq, es = (torch.from_numpy(x).to(dev) for x in tc.edge_world())
    cases = 0
    for ns in tc.NS_VALID:
        for k in tc.KS:
            for mk in (-inf, tc.MIN_KEEP):
                want = topk_dot_plain(eq, es, ns, k, min_keep_int(mk, dim))
                # below min_keep 1/dim "rows" is K2's exact top-k
                for merge in ("insert", "rows") if mk > 0 else ("insert",):
                    got = topk_dot(eq, es, ns, k, min_keep=mk, merge=merge)
                    torch.cuda.synchronize()
                    check(same(got, want), f"{'K7' if merge == 'rows' else 'K2'} differs "
                                           f"from plain on the edge world at ns_valid {ns} "
                                           f"k {k} min_keep {mk}")
                    cases += 1
    done("K2/K7 edge cases", t0, f"{cases} cases (ns_valid {tc.NS_VALID}, k {tc.KS}, "
                                 f"exact and gated) equal to plain in every slot")

    t0 = phase("K2 distance_topk")
    s = engine._dix.s_emb
    ns, k = s.shape[0], cfg.search.k
    thr = cfg.search.candidate_threshold
    keep_i = min_keep_int(thr, dim)
    want = topk_dot_plain(q, s, ns, k, keep_i)
    got = topk_dot(q, s, ns, k, min_keep=thr)
    torch.cuda.synchronize()
    check(same(got, want), "K2 engine mode differs from plain")
    n_above = int((want[0] >= thr).sum())
    check(n_above > 0, "K2 engine mode: no entry above the threshold to compare")
    e2 = err(got, want)
    rows_got = topk_dot(q, s, ns, k, min_keep=thr, merge="rows")
    torch.cuda.synchronize()
    check(same(rows_got, want), "K7 differs from plain at the engine shape")
    e7 = err(rows_got, want)
    # exact mode on 2^14 rows at k 10 and 32
    qs = q[: 1 << 14].contiguous()
    for kk in (k, 32):
        want_x = topk_dot_plain(qs, s, ns, kk, min_keep_int(-inf, dim))
        got_x = topk_dot(qs, s, ns, kk)
        torch.cuda.synchronize()
        check(same(got_x, want_x), f"K2 exact mode differs from plain at k={kk}")
        e2 = max(e2, err(got_x, want_x))
    # the padding batch
    tok_pad = tok.clone()
    tok_pad[int(0.7 * tok.shape[0]):] = 0
    qp = embed_shingles(tok_pad, engine._dix.mults)
    want_p = topk_dot_plain(qp, s, ns, k, keep_i)
    n_above_pad = int((want_p[0] >= thr).sum())
    for merge in ("insert", "rows"):
        got_p = topk_dot(qp, s, ns, k, min_keep=thr, merge=merge)
        torch.cuda.synchronize()
        check(same(got_p, want_p), f"{'K7' if merge == 'rows' else 'K2'} differs from "
                                   f"plain on the padding batch")
        if merge == "rows":
            e7 = max(e7, err(got_p, want_p))
        else:
            e2 = max(e2, err(got_p, want_p))
    # the two designs in turns: K2, K7, K7, K2; then the padding batch
    times = {"insert": [], "rows": []}
    for merge in ("insert", "rows", "rows", "insert"):
        times[merge].append(cuda_ms(lambda: topk_dot(q, s, ns, k, min_keep=thr, merge=merge), 3))
    pad = {m: cuda_ms(lambda: topk_dot(qp, s, ns, k, min_keep=thr, merge=m), 3)
           for m in ("insert", "rows")}
    plain_ms = cuda_ms(lambda: topk_dot_plain(q, s, ns, k, keep_i), 1)
    ops = 2 * q.shape[0] * ns * dim
    shared = dict(
        plain_ms=plain_ms, library_ms=None,
        shape=f"NQ={q.shape[0]} NS={ns} k={k} min_keep={thr}",
        above_thr=n_above, pad_above_thr=n_above_pad,
        **bound(q.numel() + s.numel() + q.shape[0] * k * 8, ops, INT8_OPS_S),
    )
    out = {}
    for key, merge, e in (("topk_dot", "insert", e2), ("topk_dot_rows", "rows", e7)):
        ms = min(times[merge])
        out[key] = dict(max_abs_err=e, ms=ms, runs_ms=times[merge], pad_ms=pad[merge],
                        tops=ops / (ms / 1e3) / 1e12,
                        int8_peak_share=ops / (ms / 1e3) / INT8_OPS_S, **shared)
    done("K2 distance_topk", t0, f"engine shape, 2^14 exact at k {k}/32 and the padding "
                                 f"batch equal to plain in every slot, K2 and K7; "
                                 f"K2 {out['topk_dot']}; K7 {out['topk_dot_rows']}")
    return out


def k2_wgmma_check(seed: int):
    """K2's warpgroup-MMA route (dim 128, k <= 32) at the benchmark cells'
    launch shapes, 2^20 rows against 2^20 script rows (the series' exact
    path) and 2^18 against 2^22 (the canon's at-risk rows), and at 2,048
    against 2^20 (a request's rows, the script cut into column ranges):
    sign embeddings of 6-token shingles with an eighth of the rows copied
    from the script, k 10.  Each shape gated at min_keep 3.5 is held to the
    plain version in every slot on K2_HELD_ROWS rows around block
    boundaries (the whole batch at 2,048 rows, also exact) and, with 173
    rows fewer, on the last, part-filled block; K2 and K7 (the mma.sync
    producer) timed in turns beside the bound.  Fails unless every call
    counted in topk_dot.launches_wgmma."""
    import torch

    from fandom_search_tpu_torch.ops.distance_topk import (
        WGMMA_BLOCK_ROWS, min_keep_int, topk_dot, topk_dot_plain, wgmma_splits,
    )

    t0 = phase("K2 wgmma shapes")
    g = torch.Generator(device="cuda").manual_seed(seed + 18)
    popc = torch.tensor([bin(x).count("1") for x in range(64)], dtype=torch.int8,
                        device="cuda")

    def emb(n):
        # entries 2 * Binomial(6, 1/2) - 6, as six +-1 sign rows summed
        return (popc[torch.randint(0, 64, (n, 128), generator=g, device="cuda")] * 2
                - 6).to(torch.int8)

    def same_rows(got, want, lo, hi):
        return (torch.equal(got[0][lo:hi], want[0]) and torch.equal(got[1][lo:hi], want[1]))

    k, thr, dim = 10, 3.5, 128
    keep = min_keep_int(thr, dim)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, nq, ns in (("series", 1 << 20, 1 << 20), ("canon", 1 << 18, 1 << 22),
                         ("request", 2048, 1 << 20)):
        s = emb(ns)
        q = emb(nq)
        rows = torch.randint(0, nq, (nq // 8,), generator=g, device="cuda")
        q[rows] = s[torch.randint(0, ns, (nq // 8,), generator=g, device="cuda")]
        n0 = topk_dot.launches_wgmma
        got = topk_dot(q, s, ns, k, min_keep=thr)
        part = nq - 173
        got_p = topk_dot(q[:part], s, ns, k, min_keep=thr)
        torch.cuda.synchronize()
        held = []
        mid = nq // 2 // WGMMA_BLOCK_ROWS * WGMMA_BLOCK_ROWS
        lo = max(0, mid - K2_HELD_ROWS // 2)
        hi = min(nq, lo + K2_HELD_ROWS)
        want = topk_dot_plain(q[lo:hi], s, ns, k, keep)
        check(same_rows(got, want, lo, hi),
              f"K2 (wgmma) differs from plain at {name} {nq} x {ns}, rows {lo}-{hi}")
        check(int((want[0] >= thr).sum()) > 0, f"K2 (wgmma) {name}: nothing above min_keep")
        held.append([lo, hi])
        last = (part - 1) // WGMMA_BLOCK_ROWS * WGMMA_BLOCK_ROWS
        want = topk_dot_plain(q[last:part], s, ns, k, keep)
        check(same_rows(got_p, want, last, part),
              f"K2 (wgmma) differs from plain on the part-filled last block at {name} "
              f"{part} x {ns}, rows {last}-{part}")
        held.append([last, part])
        exact = None
        if nq <= K2_HELD_ROWS:
            got_x = topk_dot(q, s, ns, k)
            torch.cuda.synchronize()
            want_x = topk_dot_plain(q, s, ns, k, min_keep_int(-float("inf"), dim))
            check(same_rows(got_x, want_x, 0, nq),
                  f"K2 (wgmma) exact mode differs from plain at {name} {nq} x {ns}")
            exact = cuda_ms(lambda: topk_dot(q, s, ns, k), 3)
        check(topk_dot.launches_wgmma - n0 == 2 + (exact is not None) * 5,
              f"K2 at {name} did not count in topk_dot.launches_wgmma")
        reps = 2 if nq * ns > 1 << 36 else 10
        times = {"insert": [], "rows": []}
        for merge in ("insert", "rows", "rows", "insert"):
            times[merge].append(cuda_ms(
                lambda: topk_dot(q, s, ns, k, min_keep=thr, merge=merge), reps))
        ops = 2 * nq * ns * dim
        ms = min(times["insert"])
        out[name] = dict(
            shape=f"NQ={nq} NS={ns} k={k} min_keep={thr}", splits=wgmma_splits(nq, ns, sms),
            held_rows=held, ms=ms, runs_ms=times["insert"], k7_ms=min(times["rows"]),
            k7_runs_ms=times["rows"], exact_ms=exact, tops=ops / (ms / 1e3) / 1e12,
            int8_peak_share=ops / (ms / 1e3) / INT8_OPS_S,
            **bound(q.numel() + s.numel() + nq * k * 8, ops, INT8_OPS_S))
        del q, s, got, got_p, want
        torch.cuda.empty_cache()
    done("K2 wgmma shapes", t0, f"every held slot equal to plain; {out}")
    return dict(shapes=out)


def topk_wide_check(engine, tok, q, index):
    """K2 and K7 at the shapes the JAX config admits beyond the engine's,
    every slot against the plain version: dim 256 and 512 on the first
    2^18 rows of the first batch against the script's rows embedded at
    that dim, gated at the engine's threshold; k 33, 64, 256 and 1000 on
    2^14 rows at dim 128, exact and gated.  Returns the K2 and the K7
    entries ({shape: dict(ms, bound...)})."""
    import dataclasses

    import numpy as np
    import torch

    from fandom_search_tpu_torch.data.hashing import derive_sign_mults
    from fandom_search_tpu_torch.ops.distance_topk import (
        min_keep_int, topk_dot, topk_dot_plain,
    )
    from fandom_search_tpu_torch.ops.embed import embed_shingles
    from fandom_search_tpu_torch.search.index import build_script_index

    t0 = phase("K2/K7 wide shapes")
    cfg = engine.cfg
    dev = q.device
    thr, k = cfg.search.candidate_threshold, cfg.search.k
    out2, out7 = {}, {}

    def same(got, want):
        return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    def run(name, qq, s, ns, kk, mk, dim, merges):
        want = topk_dot_plain(qq, s, ns, kk, min_keep_int(mk, dim))
        filled = int((want[0] > -1e38).sum())
        check(filled > 0, f"K2/K7 {name}: no entry to compare")
        for merge in merges:
            got = topk_dot(qq, s, ns, kk, min_keep=mk, merge=merge)
            torch.cuda.synchronize()
            check(same(got, want), f"{'K7' if merge == 'rows' else 'K2'} differs from plain "
                                   f"at {name}")
        times = {m: [] for m in merges}
        for merge in merges + merges[::-1]:
            times[merge].append(cuda_ms(lambda: topk_dot(qq, s, ns, kk, min_keep=mk,
                                                         merge=merge), 3))
        ops = 2 * qq.shape[0] * ns * dim
        for merge in merges:
            ms = min(times[merge])
            (out7 if merge == "rows" else out2)[name] = dict(
                ms=ms, filled=filled, tops=ops / (ms / 1e3) / 1e12,
                **bound(qq.numel() + s.numel() + qq.shape[0] * kk * 8, ops, INT8_OPS_S))

    rows = 1 << 18
    for dim in (256, 512):
        scfg = dataclasses.replace(cfg.shingle, dim=dim)
        s = torch.from_numpy(np.ascontiguousarray(
            build_script_index(index.lines, scfg, cfg.search).embeddings)).to(dev)
        mu = torch.from_numpy(derive_sign_mults(scfg.seed, scfg.n, dim)
                              .view(np.int32).copy()).to(dev)
        qd = embed_shingles(tok[: rows + scfg.n - 1].contiguous(), mu)
        run(f"dim{dim}_nq{rows}_k{k}_gated", qd, s, s.shape[0], k, thr, dim, ("insert", "rows"))
        del qd, s
    s = engine._dix.s_emb
    qs = q[: 1 << 14].contiguous()
    dim = cfg.shingle.dim
    for kk in (33, 64, 256, 1000):
        run(f"k{kk}_nq16384_exact", qs, s, s.shape[0], kk, -float("inf"), dim, ("insert",))
        run(f"k{kk}_nq16384_gated", qs, s, s.shape[0], kk, thr, dim, ("insert", "rows"))
    done("K2/K7 wide shapes", t0, f"every slot equal to plain; K2 {out2}; K7 {out7}")
    return out2, out7


def hamming_wide_check(engine, q_emb):
    """K6 at the shapes the JAX config admits beyond the engine's, every
    slot against the plain version on 2^14 rows of the first batch: 4,096
    and 8,192 bits (b1 and s8; rerank 256) and R 1,025 and 2,048 at 1,024
    bits, exact and gated."""
    import torch

    from fandom_search_tpu_torch import LSHConfig
    from fandom_search_tpu_torch.ops.lsh import (
        SENT, LSHIndex, coarse_sim_threshold, encode, hamming_topk, hamming_topk_plain,
    )

    t0 = phase("K6 wide shapes")
    cfg = engine.cfg
    qs = q_emb[: 1 << 14].contiguous()
    out = {}
    for bits, r, routes in ((4096, 256, ("b1", "s8")), (8192, 256, ("b1", "s8")),
                            (1024, 1025, ("b1", "s8")), (1024, 2048, ("b1", "s8"))):
        lcfg = LSHConfig(bits=bits, rerank=r)
        lsh = LSHIndex.build(engine.index.embeddings, lcfg, cfg.shingle,
                             pad_multiple=cfg.search.script_pad_multiple, device=engine.device)
        qc = encode(qs, lsh.projection)
        ns = lsh.ns_valid
        keep = coarse_sim_threshold(cfg.search.candidate_threshold, cfg.shingle.n, bits)
        for mode, mks in (("exact", SENT), ("gated", keep)):
            pv, pi = hamming_topk_plain(qc, lsh.codes_t, ns, r, bits, mks)
            filled = int((pv > -1e38).sum())
            check(filled > 0, f"K6 bits {bits} R {r} {mode}: no entry to compare")
            for mma in routes:
                kv, ki = hamming_topk(qc, lsh.codes_t, ns, r, bits, min_keep_sim=mks, mma=mma)
                torch.cuda.synchronize()
                check(torch.equal(kv, pv) and torch.equal(ki, pi),
                      f"K6 ({mma}) differs from plain at bits {bits} R {r} {mode}")
                ms = cuda_ms(lambda: hamming_topk(qc, lsh.codes_t, ns, r, bits,
                                                  min_keep_sim=mks, mma=mma), 3)
                out[f"bits{bits}_r{r}_{mode}_{mma}"] = dict(
                    ms=ms, filled=filled,
                    **bound(qc.numel() * 4 + lsh.codes_t.numel() * 4 + qc.shape[0] * r * 8,
                            2 * qc.shape[0] * ns * bits, INT8_OPS_S))
            del pv, pi
    done("K6 wide shapes", t0, f"2^14 rows, every slot equal to plain on b1 and s8: {out}")
    return out


def device_events(fn, reps: int = 1):
    """The kernel and memset events of ``reps`` warm calls of ``fn``,
    from a torch.profiler Chrome trace (durations in us), and the number
    of kernel launches those calls made.  The host
    sleeps PROFILE_PAD_S after the profiler starts and again after the
    calls: the trace's device clock can sit ms off the host's, and the
    profiler drops device events that fall outside its capture window.
    It also drops the first device events of a trace, more of them the
    longer the process has run, whatever the pad: PROFILE_LEAD tiny
    kernels go first, and the calls' own events are picked out by their
    launches' correlation ids inside a record_function span."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    lead = torch.zeros((1,), device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(PROFILE_LEAD):
            lead.add_(1)
        with record_function(PROFILE_SPAN):
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    spans = [e for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == PROFILE_SPAN]
    check(len(spans) == 1, f"the trace holds {len(spans)} {PROFILE_SPAN} spans")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    calls = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and t0 <= float(e["ts"]) <= t1]
    ids = {e.get("args", {}).get("correlation") for e in calls}
    mine = [e for e in events if e.get("cat") in ("kernel", "gpu_memset")
            and e.get("args", {}).get("correlation") in ids]
    return ([e for e in mine if e["cat"] == "kernel"],
            [e for e in mine if e["cat"] == "gpu_memset"],
            sum("Launch" in e["name"] and "Kernel" in e["name"] for e in calls))


def one_kernel_ms(fn, what: str, reps: int = 50) -> float:
    """Device ms per call of ``fn``, which must launch exactly one kernel
    and no memset per call."""
    kernels, memsets, _ = device_events(fn, 1)
    check(len(kernels) == 1 and not memsets,
          f"one {what} call ran {[e.get('name') for e in kernels]} kernels and "
          f"{len(memsets)} memsets, not one kernel")
    kernels, memsets, _ = device_events(fn, reps)
    check(len(kernels) == reps and not memsets,
          f"{reps} {what} calls ran {len(kernels)} kernels and {len(memsets)} memsets")
    return sum(float(e["dur"]) for e in kernels) / reps / 1e3


def scan_check(dev, rng):
    """K3: the scan (both ops, small and ragged sizes, wrap-around) and the
    compaction (0%, 1% and 100% set; size below, at and above the count)
    against their plain versions; one kernel per call in the profiler;
    event, device, plain and torch.cumsum times at 2^20."""
    import numpy as np
    import torch

    from fandom_search_tpu_torch.ops.scan import (
        nonzero_compact, nonzero_compact_plain, scan1d_i32, scan1d_i32_plain,
    )

    t0 = phase("K3 scan")
    err = 0
    for n in (1, 1023, 1025, 1 << 20, (1 << 20) + 37):
        for lo, hi in ((-1000, 1000), (-(1 << 31), 1 << 31)):   # the second wraps
            x = torch.from_numpy(rng.integers(lo, hi, size=n).astype(np.int32)).to(dev)
            for op in ("add", "max"):
                g = scan1d_i32(x, op)
                torch.cuda.synchronize()
                w = scan1d_i32_plain(x, op)
                e = int((g.long() - w.long()).abs().max())
                check(torch.equal(g, w), f"K3 {op} at n={n} differs: max |err| {e}")
                err = max(err, e)
    cases = 0
    for n in (1 << 20, (1 << 20) + 37, 1, 5000):
        for frac in (0.0, 0.01, 1.0):
            m = torch.from_numpy(rng.random(n) < frac).to(dev)
            count = int(m.sum())
            for size in sorted({max(1, count // 2), max(1, count), count + 1000, 1 << 17}):
                g = nonzero_compact(m, size)
                torch.cuda.synchronize()
                w = nonzero_compact_plain(m, size)
                check(torch.equal(g, w), f"K3 compaction differs at n={n} set={frac} "
                                         f"count={count} size={size}")
                cases += 1
    print(f"[K3 scan] scan: both ops at n 1/1023/1025/2^20/2^20+37 equal; compaction: "
          f"{cases} cases (0/1/100% set, size below/at/above the count) equal", flush=True)
    mask_b = torch.from_numpy(rng.random(1 << 20) < 0.01).to(dev)
    mask = mask_b.int()
    size = 1 << 17
    out = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: scan1d_i32(mask), 50),
        device_ms=one_kernel_ms(lambda: scan1d_i32(mask), "scan1d_i32"),
        plain_ms=cuda_ms(lambda: scan1d_i32_plain(mask), 50),
        library_ms=cuda_ms(lambda: torch.cumsum(mask, 0, dtype=torch.int32), 50),
        compact_ms=cuda_ms(lambda: nonzero_compact(mask_b, size), 50),
        compact_device_ms=one_kernel_ms(lambda: nonzero_compact(mask_b, size),
                                        "nonzero_compact"),
        compact_plain_ms=cuda_ms(lambda: nonzero_compact_plain(mask_b, size), 50),
        shape=f"N={mask.numel()} add; compaction N={mask.numel()} 1% set size={size}",
        # one 32-bit integer add an element
        **bound(mask.numel() * 8, mask.numel(), INT32_OPS_S),
    )
    lib_kernels, _, _ = device_events(lambda: torch.cumsum(mask, 0, dtype=torch.int32), 50)
    out["library_device_ms"] = sum(float(e["dur"]) for e in lib_kernels) / 50 / 1e3
    done("K3 scan", t0, str(out))
    return out


def hamming_check(engine, q_emb):
    """K6 on the codes of the first batch against the script's codes, at
    the default LSHConfig (1024 bits, rerank 256)."""
    import torch

    from fandom_search_tpu_torch import LSHConfig
    from fandom_search_tpu_torch.ops.lsh import (
        DEFAULT_MMA, SENT, LSHIndex, coarse_sim_threshold, encode, hamming_topk,
        hamming_topk_plain, rerank_exact,
    )

    t0 = phase("K6 hamming_topk")
    cfg = engine.cfg
    lcfg = LSHConfig()
    lsh = LSHIndex.build(engine.index.embeddings, lcfg, cfg.shingle,
                         pad_multiple=cfg.search.script_pad_multiple,
                         device=engine.device)
    q_codes = encode(q_emb, lsh.projection)
    keep = coarse_sim_threshold(cfg.search.candidate_threshold, cfg.shingle.n,
                                lcfg.bits)
    ns, r, bits = lsh.ns_valid, lcfg.rerank, lcfg.bits
    rows = 1 << 14
    qs = q_codes[:rows].contiguous()
    err = 0.0
    # both tensor-core routes (s8 for every bits, b1 where bits % 256 == 0)
    routes = ("s8", "b1")
    for mode, mks in (("exact", SENT), ("gated", keep)):
        pv, pi = hamming_topk_plain(qs, lsh.codes_t, ns, r, bits, mks)
        filled = int((pv > -1e38).sum())
        check(filled > 0, f"K6 {mode} mode: no entry to compare")
        for mma in routes:
            kv, ki = hamming_topk(qs, lsh.codes_t, ns, r, bits, min_keep_sim=mks, mma=mma)
            torch.cuda.synchronize()
            check(torch.equal(kv, pv) and torch.equal(ki, pi),
                  f"K6 ({mma}) {mode} mode differs from plain on {rows} rows")
            err = max(err, float((kv - pv).abs().max()))
        print(f"[K6 hamming_topk] {mode} (min_keep_sim {mks}): {rows} rows "
              f"equal in every slot on {'/'.join(routes)}, {filled} filled", flush=True)
    # the range the wrapper takes: bits 32..2048, R 1..1024, a ragged
    # ns_valid, none valid and fewer valid than R; codes with many ties
    gen = torch.Generator(device=engine.device).manual_seed(7)
    for bits2, r2, ns2 in ((32, 1, 2900), (256, 100, 2900), (2048, 1024, 2900),
                           (2048, 1024, 500), (1024, 256, 0), (768, 40, 2999)):
        words = bits2 // 32
        st = torch.randint(-(1 << 31), 1 << 31, (words, 3000), generator=gen,
                           dtype=torch.int64, device=engine.device).int()
        st[:, 1000:1100] = st[:, 200:300]
        q2 = torch.randint(-(1 << 31), 1 << 31, (1000, words), generator=gen,
                           dtype=torch.int64, device=engine.device).int()
        q2[:50] = st[:, 200:250].T
        for mks in (SENT, bits2 // 4):
            pv, pi = hamming_topk_plain(q2, st, ns2, r2, bits2, mks)
            for mma in routes if bits2 % 256 == 0 else ("s8",):
                kv, ki = hamming_topk(q2, st, ns2, r2, bits2, min_keep_sim=mks, mma=mma)
                check(torch.equal(kv, pv) and torch.equal(ki, pi),
                      f"K6 ({mma}) differs from plain at bits {bits2} R {r2} ns {ns2} "
                      f"min_keep_sim {mks}")
    print("[K6 hamming_topk] bits 32-2048, R 1-1024, ns_valid 0/500/2900/2999: "
          "equal in every slot (b1 where bits % 256 == 0)", flush=True)
    # the full gated batch, every slot
    nq = q_codes.shape[0]
    pv, pi = hamming_topk_plain(q_codes, lsh.codes_t, ns, r, bits, keep)
    for mma in routes:
        kv, ki = hamming_topk(q_codes, lsh.codes_t, ns, r, bits, min_keep_sim=keep, mma=mma)
        torch.cuda.synchronize()
        check(torch.equal(kv, pv) and torch.equal(ki, pi),
              f"K6 ({mma}) gated mode differs from plain on the full {nq}-row batch")
    filled = kv > -1e38
    per_row = filled.sum(dim=1)
    # (64-row block, 128-column tile) pairs holding an entry that passed
    # the gate: the tiles pass 2 would rescore (a floor where a row fills R)
    pairs = (torch.arange(nq, device=kv.device)[:, None] // 64 * 1_000_000
             + ki.long() // 128)[filled]
    n_tiles = -(-nq // 64) * -(-ns // 128)
    flagged = int(torch.unique(pairs).numel())
    print(f"[K6 hamming_topk] gated: all {nq} rows equal in every slot on "
          f"{'/'.join(routes)}; filled slots per row: mean "
          f"{float(per_row.float().mean()):.4f}, max {int(per_row.max())}, rows with any "
          f"{int((per_row > 0).sum())}, rows over 32 {int((per_row > 32).sum())}; tiles "
          f"with an entry {flagged} of {n_tiles} ({flagged / n_tiles:.6f})", flush=True)
    del pv, pi, pairs
    # the two routes in turns: s8, b1, b1, s8
    times = {m: [] for m in routes}
    for mma in routes + routes[::-1]:
        times[mma].append(cuda_ms(lambda: hamming_topk(
            q_codes, lsh.codes_t, ns, r, bits, min_keep_sim=keep, mma=mma), 3))
    route_ms = {m: min(v) for m, v in times.items()}
    out = dict(
        max_abs_err=err,
        ms=route_ms[DEFAULT_MMA],
        mma=DEFAULT_MMA,
        route_ms=times,
        ms_exact_2_14=cuda_ms(lambda: hamming_topk(qs, lsh.codes_t, ns, r, bits), 3),
        ms_gated_2_14=cuda_ms(lambda: hamming_topk(qs, lsh.codes_t, ns, r, bits,
                                                   min_keep_sim=keep), 3),
        filled_per_row=float(per_row.float().mean()),
        entry_tile_share=flagged / n_tiles,
        plain_ms=cuda_ms(lambda: hamming_topk_plain(qs, lsh.codes_t, ns, r,
                                                    bits, keep), 1),
        library_ms=None,
        shape=f"kernel NQ={nq}, plain NQ={rows}; NS={ns} bits={bits} R={r} "
              f"min_keep_sim={keep}",
        # the sign vectors' int8 product on the tensor cores
        **bound(q_codes.numel() * 4 + lsh.codes_t.numel() * 4 + nq * r * 8,
                2 * nq * ns * bits, INT8_OPS_S),
    )
    out["tops"] = {m: 2 * nq * ns * bits / (t / 1e3) / 1e12 for m, t in route_ms.items()}
    # the LSH candidate stage's other parts on the same batch (PyTorch
    # ops, no kernel of their own), so its time can be attributed
    s_f = engine._dix.s_emb.float()
    print(json.dumps({"lsh_stage_ms_per_batch": {
        "rows": nq,
        "encode": cuda_ms(lambda: encode(q_emb, lsh.projection), 3),
        "hamming_topk": out["ms"],
        "rerank_exact": cuda_ms(lambda: rerank_exact(
            q_emb, s_f, ki, kv > -1e38, cfg.search.k, cfg.shingle.dim), 3),
    }}), flush=True)
    done("K6 hamming_topk", t0, str(out))
    return out


def search(engine, works):
    import torch

    t0 = time.perf_counter()
    rows, stats = engine.search_works(works)
    torch.cuda.synchronize()
    return rows, stats, time.perf_counter() - t0


def sample_parity(rows, oracle, what):
    """Row parity of ``rows`` against the oracle's rows ``oracle`` = (work
    ids, rows) of a sample; fails below 1.0 or on any field."""
    ids, orows = oracle
    key = lambda r: (r.work_id, r.fan_token_start, r.line_no)  # noqa: E731
    got = [r for r in rows if r.work_id in set(ids)]
    gk, ok_ = {key(r) for r in got}, {key(r) for r in orows}
    parity = len(gk & ok_) / len(gk | ok_) if (gk or ok_) else 1.0
    check(parity == 1.0, f"{what}: sample row parity {parity} != 1.0")
    check([r.to_csv_row() for r in got] == [r.to_csv_row() for r in orows],
          f"{what}: sample rows differ from the oracle's in some field")
    return parity


def end_to_end(engine, works, planted, index, cfg, sample: int = 50):
    """Phase 4: the exact path, counted; parity on a sample; recall.
    Returns the rows, the launches, the seconds and the oracle's sample."""
    from fandom_search_tpu_torch.search.oracle import search_works_oracle

    t0 = phase("e2e")
    (rows, stats, seconds), launches = counted(
        "exact", lambda: search(engine, works))
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
    parity = sample_parity(rows, (ids, orows), "exact")
    found = {(r.work_id, r.line_no) for r in rows}
    missed = [p for p in planted if (p.work_id, p.line_no) not in found]
    check(not missed, f"{len(missed)} of {len(planted)} planted quotes missed, "
                      f"e.g. {missed[:3]}")
    done("e2e", t0, f"search {seconds:.3f}s; parity {parity} on {len(ids)} works "
                    f"({len(orows)} oracle rows, {time.perf_counter() - t1:.1f}s); "
                    f"{len(planted)} planted quotes found")
    return rows, launches, seconds, (ids, orows)


def lsh_end_to_end(index, cfg, works, planted, exact_rows, device="cuda"):
    """Phase 5: the LSH path (K6's candidate stage, K5 verifying), counted;
    recall; row agreement with the exact path."""
    import dataclasses

    from fandom_search_tpu_torch import LSHConfig
    from fandom_search_tpu_torch.ops.lsh import attach_lsh_prefilter
    from fandom_search_tpu_torch.search.engine import SearchEngine

    t0 = phase("lsh e2e")
    lcfg = dataclasses.replace(
        cfg, search=dataclasses.replace(cfg.search, sw_variant="fast"))
    engine = SearchEngine(index, lcfg, device=device)
    attach_lsh_prefilter(engine, LSHConfig())
    (rows, stats, seconds), launches = counted(
        "lsh", lambda: search(engine, works))
    found = {(r.work_id, r.line_no) for r in rows}
    missed = [p for p in planted if (p.work_id, p.line_no) not in found]
    key = lambda r: (r.work_id, r.fan_token_start, r.fan_token_end, r.line_no)  # noqa: E731
    a = {key(r) for r in exact_rows}
    b = {key(r) for r in rows}
    agreement = len(a & b) / len(a) if a else 1.0
    print(json.dumps({
        "lsh_e2e_seconds": seconds, "works": len(works),
        "query_shingles": stats.num_query_shingles,
        "script_shingles": index.num_shingles, "batches": stats.num_batches,
        "rows": len(rows), "exact_rows": len(a), "rows_in_both": len(a & b),
        "row_agreement": agreement, "candidates": stats.num_candidates,
        "verified": stats.num_verified,
        "stage_seconds": dict(stats.extra,
                              device_topk=stats.seconds_device_topk,
                              host=stats.seconds_host),
        "launches": launches,
    }), flush=True)
    no_host_sync(engine, works, "lsh")
    check(not missed, f"LSH path: {len(missed)} of {len(planted)} planted quotes "
                      f"missed, e.g. {missed[:3]}")
    check(agreement >= 0.95, f"LSH row agreement {agreement} < 0.95")
    done("lsh e2e", t0, f"search {seconds:.3f}s over {len(works)} works; "
                        f"{len(planted)} planted quotes found; row agreement "
                        f"{agreement} ({len(a & b)} of {len(a)} exact rows)")
    return launches


def lsh_f32_path(index, cfg, works, planted, sample: int = 600, device="cuda"):
    """Phase 5b: the LSH path over the first ``sample`` works at
    non-integral Smith-Waterman parameters (match 2.5, mismatch -1.25, gap
    -0.75), which K5's packed route does not take: counted, so K5 must
    launch its f32 route and never the packed one; every planted quote in
    the sample must be found (a contained quote scores 1.0 at any
    parameters)."""
    import dataclasses

    from fandom_search_tpu_torch import LSHConfig
    from fandom_search_tpu_torch.ops.lsh import attach_lsh_prefilter
    from fandom_search_tpu_torch.search.engine import SearchEngine

    t0 = phase("lsh f32 route")
    ids = sorted(works)[:sample]
    sub = {w: works[w] for w in ids}
    fcfg = dataclasses.replace(cfg, search=dataclasses.replace(
        cfg.search, sw_variant="fast", sw_match=2.5, sw_mismatch=-1.25, sw_gap=-0.75))
    engine = SearchEngine(index, fcfg, device=device)
    attach_lsh_prefilter(engine, LSHConfig())
    (rows, stats, seconds), launches = counted("lsh_f32", lambda: search(engine, sub))
    found = {(r.work_id, r.line_no) for r in rows}
    mine = [p for p in planted if p.work_id in sub]
    missed = [p for p in mine if (p.work_id, p.line_no) not in found]
    check(mine and not missed, f"LSH path at f32 parameters: {len(missed)} of {len(mine)} "
                               f"planted quotes missed")
    print(json.dumps({"lsh_f32_route": {"seconds": seconds, "works": len(sub),
                                        "rows": len(rows), "verified": stats.num_verified,
                                        "launches": launches}}), flush=True)
    done("lsh f32 route", t0, f"{len(sub)} works at match 2.5 / mismatch -1.25 / gap -0.75: "
                              f"K5's f32 route only; {len(mine)} planted quotes found")
    return launches


def rows_ab(cfg, seed: int, lnq: int = 17, lns: int = 13, device="cuda"):
    """Phase 6: scripts/merge_rows_ab.py's A/B of merge="rows" (K7)
    against "insert" (K2), at plant densities clean, 1% and 5%."""
    import numpy as np
    import torch

    from fandom_search_tpu_torch.data.shingler import embed_shingles_np
    from fandom_search_tpu_torch.ops.distance_topk import (
        min_keep_int, topk_dot, topk_dot_plain,
    )

    t0 = phase("rows A/B")
    scfg = cfg.shingle
    nq, ns, k, mk = 1 << lnq, 1 << lns, 10, 3.5
    keep_i = min_keep_int(mk, scfg.dim)
    rng = np.random.default_rng(seed + 7)
    s_stream = rng.integers(0, 2**32, size=ns + scfg.n - 1, dtype=np.uint32)
    s = torch.from_numpy(embed_shingles_np(s_stream, scfg)).to(device)
    qs = {}
    for density, stride in (("clean", 0), ("1%", 100), ("5%", 20)):
        q_stream = rng.integers(0, 2**32, size=nq + scfg.n - 1, dtype=np.uint32)
        if stride:
            for qi in range(0, nq, stride):
                si = int(rng.integers(0, ns))
                q_stream[qi : qi + scfg.n] = s_stream[si : si + scfg.n]
        qs[density] = torch.from_numpy(embed_shingles_np(q_stream, scfg)).to(device)

    def run():
        out = {d: (topk_dot(q, s, ns, k, min_keep=mk, merge="rows"),
                   topk_dot(q, s, ns, k, min_keep=mk, merge="insert"))
               for d, q in qs.items()}
        torch.cuda.synchronize()
        return out

    out, launches = counted("rows_ab", run)
    per_density = {}
    err = 0.0
    for d, q in qs.items():
        (rv, ri), (kv, ki) = out[d]
        pv, pi = topk_dot_plain(q, s, ns, k, keep_i)
        torch.cuda.synchronize()
        check(torch.equal(rv, pv) and torch.equal(ri, pi),
              f"rows A/B {d}: K7 differs from the plain version")
        above = kv >= mk
        check(torch.equal(rv[above], kv[above]) and torch.equal(ri[above], ki[above])
              and torch.equal(above, rv >= mk),
              f"rows A/B {d}: K7 differs from K2 at or above min_keep")
        err = max(err, float((rv - pv).abs().max()))
        per_density[d] = dict(
            filled=int(above.sum()),
            k7_ms=cuda_ms(lambda: topk_dot(q, s, ns, k, min_keep=mk, merge="rows"), 10),
            k2_ms=cuda_ms(lambda: topk_dot(q, s, ns, k, min_keep=mk), 10),
        )
    # below min_keep 1/dim "rows" is the exact top-k, which K2 computes
    q = qs["clean"]
    zero_counters()
    topk_dot(q, s, ns, k, merge="rows")
    torch.cuda.synchronize()
    n = read_counters()
    check(n["topk_dot"] == 1 and n["topk_dot_rows"] == 0,
          f"merge='rows' at min_keep=-inf launched {n}")
    print(json.dumps({"rows_ab": {"nq": nq, "ns": ns, "k": k, "min_keep": mk,
                                  "densities": per_density}}), flush=True)
    done("rows A/B", t0, f"K7 equal to plain in every slot and to K2 above "
                         f"{mk} at every density; launches {launches}")
    return launches, err


def _oracle_chunk(works, index, cfg):
    from fandom_search_tpu_torch.search.oracle import search_works_oracle

    return search_works_oracle(works, index, cfg)[0]


def oracle_rows(works, index, cfg):
    """The NumPy oracle's rows for ``works``, over ORACLE_PROCS worker
    processes (it takes ~0.8 s a 2,000-word work on one core)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    ids = sorted(works)
    chunks = [c for c in (ids[i::ORACLE_PROCS] for i in range(ORACLE_PROCS)) if c]
    with ProcessPoolExecutor(len(chunks), mp_context=mp.get_context("spawn")) as ex:
        futs = [ex.submit(_oracle_chunk, {w: works[w] for w in c}, index, cfg)
                for c in chunks]
        return [r for f in futs for r in f.result()]


def cli_json(argv):
    """Run the port's CLI in this process; return its manifest line."""
    import contextlib
    import io

    from fandom_search_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"cli {argv[0]} exited {rc}")
    out = buf.getvalue().strip().splitlines()
    return json.loads(out[-1]) if out else None


def persist_serve(works, script_text, root: Path, sample: int = 600, per_request: int = 200,
                  device="cuda"):
    """Phase 7: index -> search --index -> serve -> matrix --html through
    the port's entry points on a sample of the world's works."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from fandom_search_tpu_torch import cli
    from fandom_search_tpu_torch.ops.lsh import LSHIndex
    from fandom_search_tpu_torch.search.engine import SearchEngine
    from fandom_search_tpu_torch.search.persist import load_index, load_lsh
    from fandom_search_tpu_torch.search.server import SearchService, make_server
    from fandom_search_tpu_torch.search.types import MatchRow

    t0 = phase("persist_serve")
    ids = sorted(works)[:sample]
    script = root / "script.txt"
    script.write_text(script_text, encoding="utf-8")
    wdir = root / "works"
    wdir.mkdir()
    for w in ids:
        (wdir / f"{w}.txt").write_text(works[w], encoding="utf-8")
    idx, idx_lsh = root / "idx", root / "idx_lsh"

    def index_and_search():
        check(cli.main(["index", str(script), "-o", str(idx)]) == 0, "index failed")
        check(cli.main(["index", str(script), "-o", str(idx_lsh), "--lsh",
                        "--device", device]) == 0,
              "index --lsh failed")
        out = {}
        for name, argv in (
            ("loaded", [str(wdir), "--index", str(idx)]),
            ("fresh", [str(wdir), str(script)]),
            ("loaded_lsh", [str(wdir), "--index", str(idx_lsh), "--lsh"]),
            ("fresh_lsh", [str(wdir), str(script), "--lsh"]),
        ):
            out[name] = cli_json(["search", *argv, "-o", str(root / f"{name}.csv"),
                                  "--device", device])
        return out

    manifests, launches = counted("index_search", index_and_search)
    for a, b in (("loaded", "fresh"), ("loaded_lsh", "fresh_lsh")):
        check((root / f"{a}.csv").read_bytes() == (root / f"{b}.csv").read_bytes(),
              f"search --index rows ({a}) differ from a fresh-index search ({b})")
    check(manifests["loaded"]["matches"] > 0, "search --index found no rows")
    t1 = time.perf_counter()
    index, cfg = load_index(idx)
    load_s = time.perf_counter() - t1
    loaded = load_lsh(idx_lsh, cfg.lsh).to(device)
    fresh = LSHIndex.build(index.embeddings, cfg.lsh, cfg.shingle,
                           pad_multiple=cfg.search.script_pad_multiple, device=device)
    check(torch.equal(loaded.codes_t, fresh.codes_t)
          and torch.equal(loaded.projection, fresh.projection)
          and loaded.ns_valid == fresh.ns_valid, "loaded LSH codes differ from fresh ones")
    print(json.dumps({"index_search": {
        "works": len(ids), "load_index_seconds": load_s,
        **{f"{k}_seconds_index": m["seconds_index"] for k, m in manifests.items()},
        **{f"{k}_seconds_search": m["seconds_search"] for k, m in manifests.items()},
        "rows": manifests["loaded"]["matches"], "lsh_rows": manifests["loaded_lsh"]["matches"],
        "launches": launches,
    }}), flush=True)

    # the server over the loaded index, on an ephemeral localhost port
    engine = SearchEngine(index, cfg, device=device)
    service = SearchService(engine, index, cfg)
    warm_s = service.warm()
    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    requests = [{w: works[w] for w in ids[i : i + per_request]}
                for i in range(0, 3 * per_request, per_request)]

    def call(path, body=None):
        data = None if body is None else json.dumps({"works": body}).encode()
        req = urllib.request.Request(base + path, data=data, method="GET" if body is None
                                     else "POST", headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            check(r.status == 200, f"{path}: HTTP {r.status}")
            return json.loads(r.read()), time.perf_counter() - t

    def serve():
        answers = [call("/search", body) for body in requests]
        return answers, call("/health")[0], call("/stats")[0]

    try:
        (answers, health, stats), serve_launches = counted("serve", serve)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "the server thread did not stop")
    check(health["device"].startswith("cuda:" if device == "cuda" else "cpu"),
          f"/health names {health['device']}")
    check(stats["requests"] == 3 and stats["errors"] == 0, f"/stats: {stats}")
    as_json = lambda rows: [dict(zip(MatchRow.CSV_FIELDS, r.to_csv_row()))  # noqa: E731
                            for r in rows]
    for i, (body, (ans, _)) in enumerate(zip(requests, answers)):
        direct, _ = engine.search_works(body)
        check(ans["matches"] == as_json(direct),
              f"request {i}: rows differ from the engine called directly")
        check(ans["works"] == len(body), f"request {i}: {ans['works']} works answered")
    t1 = time.perf_counter()
    orows = oracle_rows(requests[0], index, cfg)
    oracle_s = time.perf_counter() - t1
    key = lambda d: tuple(str(d[f]) for f in MatchRow.CSV_FIELDS)  # noqa: E731
    check(sorted(map(key, answers[0][0]["matches"])) == sorted(map(key, as_json(orows))),
          "request 0: rows differ from the NumPy oracle's")
    check(answers[0][0]["matches"], "request 0 found no rows")
    print(json.dumps({"serve": {
        "warm_seconds": warm_s, "health": health, "stats": stats,
        "requests": [{"works": a["works"], "rows": a["num_matches"],
                      "query_shingles": a["query_shingles"], "seconds": a["seconds"],
                      "queue_seconds": a["queue_seconds"], "client_seconds": c}
                     for a, c in answers],
        "oracle_rows": len(orows), "oracle_seconds": oracle_s, "launches": serve_launches,
    }}), flush=True)

    # matrix --html over the search --index CSV
    check(cli.main(["matrix", str(root / "loaded.csv"), "-o", str(root / "matrix.csv"),
                    "--script", str(script), "--html", str(root / "engagement.html")]) == 0,
          "matrix failed")
    import csv

    with (root / "matrix.csv").open(newline="", encoding="utf-8") as f:
        recs = list(csv.DictReader(f))
    check(len(recs) == len(index.lines)
          and sum(int(r["matches"]) for r in recs) == manifests["loaded"]["matches"],
          "matrix counts do not add up to the search's rows")
    check("Total matches" in (root / "engagement.html").read_text(encoding="utf-8"),
          "engagement.html is not the heatmap page")
    done("persist_serve", t0, f"{len(ids)} works; search --index rows equal a fresh "
                              f"search (exact and --lsh); 3 requests equal the engine, "
                              f"request 0 the oracle ({len(orows)} rows); load_index "
                              f"{load_s:.3f}s; matrix over {len(recs)} lines")
    return {"index_search": launches, "serve": serve_launches}, idx, wdir


def profile_phase(idx: Path, wdir: Path, root: Path, device="cuda"):
    """Phase 8: one warm exact search --index under --profile; the
    device's busy share from the trace."""
    from fandom_search_tpu_torch.utils.profiling import TRACE_NAME, busy_share

    t0 = phase("profile")
    pdir = root / "profile"
    man, launches = counted("profile", lambda: cli_json(
        ["search", str(wdir), "--index", str(idx), "-o", str(root / "profiled.csv"),
         "--profile", str(pdir), "--device", device]))
    share = busy_share(pdir / TRACE_NAME)
    check(share["kernels"] > 0, "the profiler trace holds no kernel event")
    print(json.dumps({"profile": dict(share, seconds_search=man["seconds_search"],
                                      works=man["works"], launches=launches)}), flush=True)
    done("profile", t0, f"busy share {share['busy_share']:.4f} "
                        f"({share['kernel_ms']:.1f} of {share['wall_ms']:.1f} ms)")
    return launches


def wide_configs(index, cfg, works, sample: int = 600, oracle_sample: int = 40,
                 device="cuda"):
    """Phase 9: the exact path on the first ``sample`` works at the
    configurations the CUDA kernels refused before: dim 256, long script
    segments (max_line_tokens 96) and k 40 (batch_queries 2^18); counted,
    and the rows of ``oracle_sample`` works held to the NumPy oracle."""
    import dataclasses

    from fandom_search_tpu_torch.ops.distance_topk import wgmma_route
    from fandom_search_tpu_torch.search.engine import SearchEngine
    from fandom_search_tpu_torch.search.index import build_script_index

    t0 = phase("wide configs")
    ids = sorted(works)[:sample]
    sub = {w: works[w] for w in ids}
    out, launches = {}, {}
    for name, shingle_kw, search_kw in (
        ("dim256", {"dim": 256}, {}),
        ("max_line_tokens96", {}, {"max_line_tokens": 96}),
        ("k40", {}, {"k": 40, "batch_queries": 1 << 18}),
    ):
        c = dataclasses.replace(cfg, shingle=dataclasses.replace(cfg.shingle, **shingle_kw),
                                search=dataclasses.replace(cfg.search, **search_kw))
        idx = build_script_index(index.lines, c.shingle, c.search)
        engine = SearchEngine(idx, c, device=device)
        path = "exact" if wgmma_route(c.shingle.dim, c.search.k) else "exact_wide"
        (rows, stats, seconds), launches[name] = counted(path, lambda: search(engine, sub))
        oids = set(ids[:oracle_sample])
        orows = oracle_rows({w: sub[w] for w in sorted(oids)}, idx, c)
        key = lambda r: (r.work_id, r.fan_token_start, r.line_no)  # noqa: E731
        gk = {key(r) for r in rows if r.work_id in oids}
        ok_ = {key(r) for r in orows}
        parity = len(gk & ok_) / len(gk | ok_) if (gk or ok_) else 1.0
        got = sorted(r.to_csv_row() for r in rows if r.work_id in oids)
        want = sorted(r.to_csv_row() for r in orows)
        check(parity == 1.0 and got == want,
              f"{name}: sample rows differ from the oracle's (parity {parity})")
        check(want, f"{name}: the oracle found no row to compare")
        out[name] = dict(seconds=seconds, rows=len(rows), oracle_rows=len(want),
                         sample_parity=parity, batches=stats.num_batches,
                         candidates=stats.num_candidates, launches=launches[name])
    print(json.dumps({"wide_configs": out}), flush=True)
    done("wide configs", t0, f"{len(ids)} works each at dim 256, max_line_tokens 96 and k 40: "
                             f"sample parity 1.0 against the oracle")
    return launches


def _csv_rows(rows):
    return [r.to_csv_row() for r in rows]


def bucketed_end_to_end(index, cfg, works, planted, exact_rows, device="cuda"):
    """Phase 10: the bucketed prefilter over the 10k-work world, counted;
    rows equal to the exact path's; recall."""
    from fandom_search_tpu_torch import BucketedConfig
    from fandom_search_tpu_torch.ops.bucketed import attach_bucketed_prefilter
    from fandom_search_tpu_torch.search.engine import SearchEngine

    t0 = phase("bucketed e2e")
    engine = SearchEngine(index, cfg, device=device)
    attach_bucketed_prefilter(engine, BucketedConfig())
    b = engine.bucketed
    check(b.builder == "native", f"the bucketed tables came from the {b.builder} builder")
    route = "bucketed" if engine._bucketed_risk_budget is None else "bucketed_hybrid"
    (rows, stats, seconds), launches = counted(route, lambda: search(engine, works))
    found = {(r.work_id, r.line_no) for r in rows}
    missed = [p for p in planted if (p.work_id, p.line_no) not in found]
    same = _csv_rows(rows) == _csv_rows(exact_rows)
    tok = first_batch_stream(engine, works)
    budget = ({} if engine._bucketed_risk_budget is None
              else {"risk_budget": engine._bucketed_risk_budget})
    held, _ = stage_vs_plain("bucketed e2e stage", lambda: engine._candidates_fn(
        tok, max_out=engine._cand_budget, **budget))
    print(json.dumps({"bucketed_e2e": {
        "seconds": seconds, "works": len(works), "route": route,
        "overflow_frac": b.overflow_frac,
        "bucketed_risk_frac": stats.extra.get("bucketed_risk_frac"),
        "table_build_seconds": b.build_seconds, "num_buckets": b.num_buckets,
        "query_shingles": stats.num_query_shingles, "batches": stats.num_batches,
        "budget_retries": launches["embed_shingles"] - stats.num_batches,
        "rows": len(rows), "exact_rows": len(exact_rows), "rows_equal": same,
        "candidates": stats.num_candidates, "verified": stats.num_verified,
        "stage_seconds": dict(stats.extra, device_topk=stats.seconds_device_topk,
                              host=stats.seconds_host),
        "launches": launches, "held_to_plain": held,
    }}), flush=True)
    no_host_sync(engine, works, "bucketed")
    check(same, f"bucketed rows ({len(rows)}) differ from the exact path's "
                f"({len(exact_rows)})")
    check(not missed, f"bucketed path: {len(missed)} of {len(planted)} planted quotes "
                      f"missed, e.g. {missed[:3]}")
    done("bucketed e2e", t0, f"{route} route, overflow_frac {b.overflow_frac}; search "
                             f"{seconds:.3f}s over {len(works)} works; rows equal the "
                             f"exact path's ({len(rows)}); {len(planted)} planted found")
    return launches


def big_world(cfg, shingles: int = 1 << 20, num_works: int = 480, seed: int = 23):
    """fandom_search_tpu/bench.py's stage_bucketed_e2e_big world: English-
    like skew over a 30,000-word vocabulary."""
    from fandom_search_tpu_torch.bench import flagship_world

    _, index, works, planted = flagship_world(cfg, shingles, num_works, seed)
    return index, works, planted


def kernel_events_ms(fn, traces: int = 3):
    """Device ms of one warm call of ``fn``: its kernels' and memsets'
    summed durations in a padded profiler trace (``device_events``),
    the median over those of ``traces`` traces that hold a kernel event
    for every kernel launch their runtime events record.  Returns (ms, or
    None when no trace was whole, kernel launches, whole traces).  On an
    H100, single-call traces taken late in a long process have come back
    without a kernel that they launched; the callers print CUDA-event
    times beside."""
    whole, launched = [], 0
    for _ in range(traces):
        kernels, memsets, launched = device_events(fn, 1)
        if len(kernels) == launched:
            whole.append(sum(float(e["dur"]) for e in kernels + memsets) / 1e3)
    ms = sorted(whole)[len(whole) // 2] if whole else None
    return ms, launched, len(whole)


def stage_vs_plain(path, run, also=()):
    """Run ``run()``, a bucketed candidate stage, with each K1, K2 and K3
    call that ops/bucketed.py and the modules ``also`` make held against
    its plain version on the same inputs: every embed, scan and compaction
    whole, and K2 on the K2_HELD_ROWS contiguous rows around its last
    nonzero row (the at-risk rows come first, the zeroed -1 rows after
    them) at the full NS, every slot equal.  Fails on any difference;
    returns {kernel call: count} and K2's inputs (None when it did not
    run)."""
    import torch

    from fandom_search_tpu_torch.ops import bucketed as B
    from fandom_search_tpu_torch.ops.distance_topk import (
        NEG_INF, min_keep_int, topk_dot_plain,
    )
    from fandom_search_tpu_torch.ops.embed import embed_shingles_plain
    from fandom_search_tpu_torch.ops.scan import nonzero_compact_plain, scan1d_i32_plain

    names = ("embed_shingles", "scan1d_i32", "nonzero_compact", "topk_dot")
    saved = [(m, name, getattr(m, name)) for m in (B, *also) for name in names
             if hasattr(m, name)]
    kernels = {name: fn for _, name, fn in saved}
    calls, k2_args = {}, []

    def held(what):
        calls[what] = calls.get(what, 0) + 1
        print(f"[{path}] {what}: equal to plain", flush=True)

    def embed(tok, mults):
        got = kernels["embed_shingles"](tok, mults)
        check(torch.equal(got, embed_shingles_plain(tok, mults)),
              f"{path}: K1 on {tok.shape[0]} tokens differs from plain")
        held(f"K1 tokens={tok.shape[0]}")
        return got

    def scan(x, op="add"):
        got = kernels["scan1d_i32"](x, op)
        check(torch.equal(got, scan1d_i32_plain(x, op)),
              f"{path}: K3 {op} scan of {x.numel()} elements differs from plain")
        held(f"K3 {op} scan n={x.numel()}")
        return got

    def compact(mask, size):
        got = kernels["nonzero_compact"](mask, size)
        check(torch.equal(got, nonzero_compact_plain(mask, size)),
              f"{path}: K3 compaction of {mask.numel()} to {size} differs from plain")
        held(f"K3 compaction n={mask.numel()} set={int(mask.sum())} size={size}")
        return got

    def k2(q, s, ns, k, *, min_keep=-float("inf"), merge="insert"):
        got = kernels["topk_dot"](q, s, ns, k, min_keep=min_keep, merge=merge)
        live = int(q.ne(0).any(dim=1).sum())
        lo = max(0, min(live - K2_HELD_ROWS // 2, q.shape[0] - K2_HELD_ROWS))
        hi = min(q.shape[0], lo + K2_HELD_ROWS)
        want = topk_dot_plain(q[lo:hi], s, ns, k, min_keep_int(min_keep, q.shape[1]))
        check(torch.equal(got[0][lo:hi], want[0]) and torch.equal(got[1][lo:hi], want[1]),
              f"{path}: K2 differs from plain on rows {lo}..{hi} of {q.shape[0]} x NS {ns}")
        filled = int((want[0] > NEG_INF).sum())
        check(filled > 0, f"{path}: the K2 rows held to plain hold no entry to compare")
        held(f"K2 {q.shape[0]} rows ({live} nonzero) x NS {ns} k {k} min_keep {min_keep}, "
             f"rows {lo}..{hi} held ({filled} filled slots)")
        k2_args.append((q, s, ns, k, min_keep))
        return got

    held_by = dict(embed_shingles=embed, scan1d_i32=scan, nonzero_compact=compact,
                   topk_dot=k2)
    for m, name, _ in saved:
        setattr(m, name, held_by[name])
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    check(any(c.startswith("K3") for c in calls), f"{path}: the stage made no K3 call")
    return calls, (k2_args[0] if k2_args else None)


def bucketed_stage_ms(engine, works):
    """The hybrid's candidate stage on the first batch of ``works``: its
    K2 and K3 calls held to plain (``stage_vs_plain``); each part's
    device ms from the profiler, each part called alone on what the
    parts before it made (``engine.bucketed_stage_parts``); the whole
    stage's device and event ms beside the exact stage's; and the
    thresholded recall of its triples against K2's exact top-k."""
    import torch

    from fandom_search_tpu_torch.data.fast_tokenizer import tokenize_many
    from fandom_search_tpu_torch.ops import bucketed as B
    from fandom_search_tpu_torch.ops.distance_topk import topk_dot
    from fandom_search_tpu_torch.ops.embed import embed_shingles
    from fandom_search_tpu_torch.search.engine import exact_candidates

    scfg, xcfg = engine.cfg.shingle, engine.cfg.search
    dix = engine._dix
    ns = dix.s_emb.shape[0]
    tok = first_batch_stream(engine, works)
    items = sorted(tokenize_many(dict(sorted(works.items())[:1000])).items())
    _, _, spans, _ = next(iter(engine._batches(items)))
    # the batch's query shingles that lie inside its works (the zero
    # tokens padding the stream score above the threshold against many
    # script rows, which no bucket holds)
    real = spans[-1][1] + spans[-1][2] - scfg.n + 1
    max_out, rb = engine._cand_budget, engine._bucketed_risk_budget

    def stage():
        return engine._candidates_fn(tok, max_out=max_out, risk_budget=rb)

    def exact_stage():
        return exact_candidates(tok, dix, search_cfg=xcfg, max_out=max_out)

    held, k2_args = stage_vs_plain("bucketed big stage", stage)
    check(k2_args is not None, "the hybrid's stage made no K2 call")
    parts = engine.bucketed_stage_parts(tok, max_out=max_out, risk_budget=rb)
    _, _, at_risk = parts["geometry"][1]
    row, _, _, pc = parts["segment_stream"][1]
    out = {"queries": tok.shape[0] - scfg.n + 1, "pair_budget": row.shape[0],
           "pairs": int(pc), "at_risk": int(at_risk.sum()), "risk_budget": rb,
           "max_out": max_out, "held_to_plain": held}
    timed = {name: part for name, (part, _) in parts.items()}
    timed["stage2_k2_alone"] = lambda: topk_dot(*k2_args[:4], min_keep=k2_args[4])
    timed["stage"] = stage
    timed["exact_stage"] = exact_stage
    for name, fn in timed.items():
        out[f"{name}_ms"], out[f"{name}_kernels"], out[f"{name}_whole_traces"] = (
            kernel_events_ms(fn))
        out[f"{name}_event_ms"] = cuda_ms(fn, 3)
    del parts, timed
    qpos, _, sc, count, _ = stage()
    q_emb = embed_shingles(tok, dix.mults)
    ev, _ = topk_dot(q_emb[:real].contiguous(), dix.s_emb, ns, xcfg.k)
    torch.cuda.synchronize()
    check(int(count) <= max_out, f"the stage's triples overflow {max_out}")
    out["recall_queries"] = real
    out["recall_vs_exact"], out["recall_entries"] = B.thresholded_recall_vs_exact(
        ev, qpos, sc, count, dim=scfg.dim, threshold=xcfg.candidate_threshold, stride=16)
    return out


def bucketed_big(cfg, device="cuda"):
    """Phase 11: the hybrid over the flagship 2^20-shingle English-skew
    world, against the exact path."""
    import dataclasses

    import torch

    from fandom_search_tpu_torch import BucketedConfig
    from fandom_search_tpu_torch.ops.bucketed import attach_bucketed_prefilter
    from fandom_search_tpu_torch.search.engine import SearchEngine

    t0 = phase("bucketed big")
    bcfg = BucketedConfig(pairs="all")
    cfg = dataclasses.replace(cfg, bucketed=bcfg)
    index, works, planted = big_world(cfg)
    world_s = time.perf_counter() - t0
    print(f"[bucketed big] world: {len(index.lines)} lines, {index.num_shingles} script "
          f"shingles, {len(works)} works ({world_s:.1f}s)", flush=True)
    exact = SearchEngine(index, cfg, device=device)
    (xrows, xstats, x_s), x_launches = counted("exact", lambda: search(exact, works))
    _, _, x2_s = search(exact, works)
    del exact
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = SearchEngine(index, cfg, device=device)
    t1 = time.perf_counter()
    attach_bucketed_prefilter(engine, bcfg)
    attach_s = time.perf_counter() - t1
    b = engine.bucketed
    check(b.builder == "native", f"the bucketed tables came from the {b.builder} builder")
    check(b.overflow_frac > 0 and engine._bucketed_risk_budget is not None,
          f"overflow_frac {b.overflow_frac}: the hybrid route did not attach")
    (brows, bstats, b_s), launches = counted("bucketed_hybrid", lambda: search(engine, works))
    peak = torch.cuda.max_memory_allocated()
    check(launches["topk_dot"] > 0, "the hybrid's stage 2 never launched K2")
    _, _, b2_s = search(engine, works)
    ex, got = set(map(tuple, _csv_rows(xrows))), set(map(tuple, _csv_rows(brows)))
    missing, extra = len(ex - got), len(got - ex)
    found = {(r.work_id, r.line_no) for r in brows}
    stages = bucketed_stage_ms(engine, works)
    print(json.dumps({"bucketed_big": {
        "world_seconds": world_s, "script_lines": len(index.lines),
        "script_shingles": index.num_shingles, "works": len(works),
        "pairs": bcfg.pairs, "num_buckets": b.num_buckets, "overflow_frac": b.overflow_frac,
        "table_build_seconds": b.build_seconds, "table_builder": b.builder,
        "attach_seconds": attach_s,
        "bucketed_risk_frac": bstats.extra.get("bucketed_risk_frac"),
        "risk_budget": engine._bucketed_risk_budget,
        "exact_seconds": [x_s, x2_s], "bucketed_seconds": [b_s, b2_s],
        "exact_rows": len(ex), "rows": len(got), "missing_rows": missing,
        "extra_rows": extra,
        "planted_found": sum((p.work_id, p.line_no) in found for p in planted),
        "planted": len(planted),
        "batches": bstats.num_batches,
        "budget_retries": launches["embed_shingles"] - bstats.num_batches,
        "exact_budget_retries": x_launches["embed_shingles"] - xstats.num_batches,
        "candidates": bstats.num_candidates, "exact_candidates": xstats.num_candidates,
        "max_memory_allocated": peak,
        "stage_seconds": dict(bstats.extra, device_topk=bstats.seconds_device_topk),
        "exact_stage_seconds": dict(xstats.extra, device_topk=xstats.seconds_device_topk),
        "per_batch_device_ms": stages,
        "launches": launches, "exact_launches": x_launches,
    }}), flush=True)
    no_host_sync(engine, works, "bucketed big")
    check(missing == 0 and extra == 0,
          f"bucketed big: {missing} exact rows missing, {extra} extra, of {len(ex)}")
    done("bucketed big", t0, f"{index.num_shingles} shingles, overflow_frac "
                             f"{b.overflow_frac:.5f}, risk frac "
                             f"{bstats.extra.get('bucketed_risk_frac')}; rows {len(got)} "
                             f"= exact (missing 0, extra 0); warm exact {x2_s:.3f}s, "
                             f"bucketed {b2_s:.3f}s")
    del engine
    torch.cuda.empty_cache()
    return launches


def bucketed_cli(root: Path, wdir: Path, device="cuda"):
    """Phase 12: `index --bucketed --bucketed-pairs all`, then `search
    --index --bucketed` over the sample, against the engine over the
    loaded tables."""
    from fandom_search_tpu_torch import BucketedConfig, cli
    from fandom_search_tpu_torch.ops.bucketed import attach_bucketed_prefilter
    from fandom_search_tpu_torch.scrape.clean import load_works_dir
    from fandom_search_tpu_torch.search.engine import SearchEngine
    from fandom_search_tpu_torch.search.persist import load_bucketed, load_index
    from fandom_search_tpu_torch.search.report import write_matches_csv

    t0 = phase("bucketed cli")
    idx = root / "idx_bucketed"

    def run():
        check(cli.main(["index", str(root / "script.txt"), "-o", str(idx), "--bucketed",
                        "--bucketed-pairs", "all", "--device", device]) == 0,
              "index --bucketed failed")
        return cli_json(["search", str(wdir), "--index", str(idx), "--bucketed",
                         "-o", str(root / "bucketed.csv"), "--device", device])

    man, launches = counted(None, run)
    t1 = time.perf_counter()
    bidx = load_bucketed(idx, BucketedConfig(pairs="all"))
    load_s = time.perf_counter() - t1
    check(bidx is not None, "index --bucketed saved no tables for pairs 'all'")
    check_launches("bucketed" if bidx.overflow_frac == 0 else "bucketed_hybrid", launches)
    index, cfg = load_index(idx)
    engine = SearchEngine(index, cfg, device=device)
    attach_bucketed_prefilter(engine, cfg.bucketed, bidx=bidx)
    rows, _ = engine.search_works(load_works_dir(wdir))
    write_matches_csv(rows, root / "bucketed_engine.csv")
    check((root / "bucketed.csv").read_bytes() == (root / "bucketed_engine.csv").read_bytes(),
          "search --index --bucketed rows differ from the engine's")
    check(man["matches"] == len(rows) > 0, f"search --bucketed found {man['matches']} rows")
    print(json.dumps({"bucketed_cli": {
        "works": man["works"], "rows": man["matches"], "pairs": cfg.bucketed.pairs,
        "overflow_frac": bidx.overflow_frac, "load_tables_seconds": load_s,
        "seconds_index": man["seconds_index"], "seconds_search": man["seconds_search"],
        "launches": launches,
    }}), flush=True)
    done("bucketed cli", t0, f"{man['works']} works: CSV equal to the engine's "
                             f"({len(rows)} rows); tables loaded in {load_s:.3f}s")
    return launches


def compress_end_to_end(index, cfg, works, exact_engine, exact_rows, oracle, device="cuda"):
    """Phase 13: the exact path with stream_compress, counted, in turns
    with warm raw searches on the exact engine (raw, compressed on a fresh
    engine, compressed again, raw): rows equal the raw run's, sample
    parity 1.0; every batch's decoded stream_ext of the first compressed
    run, read back after it, equal to its raw buffer bit for bit; the
    uploads both ways, the encoder's host seconds, one batch's upload and
    decode times; then the patch path on its own world
    (``compress_patches``)."""
    import dataclasses

    from fandom_search_tpu_torch.search.engine import EncodedBatch, SearchEngine, _decode_stream

    t0 = phase("compress")
    _, raw_stats, raw_s = search(exact_engine, works)
    ccfg = dataclasses.replace(cfg, search=dataclasses.replace(cfg.search,
                                                               stream_compress=True))
    engine = SearchEngine(index, ccfg, device=device)
    (rows, stats, seconds, sent, enc_s), launches = counted(
        "exact", lambda: decoded_search(engine, works))
    _, warm_stats, warm_s = search(engine, works)
    _, raw2_stats, raw2_s = search(exact_engine, works)
    enc = [p for _, p in sent if isinstance(p, EncodedBatch)]
    same = _csv_rows(rows) == _csv_rows(exact_rows)
    check(same, f"compressed rows ({len(rows)}) differ from the raw run's "
                f"({len(exact_rows)})")
    parity = sample_parity(rows, oracle, "compress")
    raw_bytes = [ext.nbytes for ext, _ in sent]
    sent_bytes = [p.c_ext.nbytes if isinstance(p, EncodedBatch) else p.nbytes
                  for _, p in sent]
    table_bytes = engine.table_uploads * 4 * 65536
    ext0, p0 = next((e, p) for e, p in sent if isinstance(p, EncodedBatch))
    c_dev, table = engine._upload(p0.c_ext), engine._vocab_table_dev()
    timing_ms = {
        "upload_raw": cuda_ms(lambda: engine._upload(ext0), 20),
        "upload_encoded": cuda_ms(lambda: engine._upload(p0.c_ext), 20),
        "decode": cuda_ms(lambda: _decode_stream(c_dev, table, t_pad=p0.t_pad, p_pad=p0.p_pad,
                                                 nspans=(ext0.size - p0.t_pad) // 2), 20),
    }
    print(json.dumps({"compress": {
        "works": len(works), "batches": stats.num_batches, "encoded": len(enc),
        "raw": stats.num_batches - len(enc), "misses": [p.misses for p in enc],
        "patch_budget": sorted({p.p_pad for p in enc}),
        "bytes_per_batch_raw": raw_bytes, "bytes_per_batch_sent": sent_bytes,
        "table_uploads": engine.table_uploads, "table_bytes": table_bytes,
        "upload_ratio": (sum(sent_bytes) + table_bytes) / sum(raw_bytes),
        "vocab_size": engine._venc.size,
        "e2e_seconds_in_turns": {"raw": [raw_s, raw2_s], "compressed": [seconds, warm_s]},
        "s_batchgen_in_turns": {
            "raw": [raw_stats.extra["s_batchgen"], raw2_stats.extra["s_batchgen"]],
            "compressed": [stats.extra["s_batchgen"], warm_stats.extra["s_batchgen"]]},
        "encode_host_seconds": sum(enc_s), "encode_host_seconds_max_batch": max(enc_s),
        "one_batch_ms": timing_ms,
        "stage_seconds": {"raw": raw_stats.extra, "compressed": stats.extra},
        "rows": len(rows), "rows_equal": same, "parity": parity, "launches": launches,
    }}), flush=True)
    no_host_sync(engine, works, "compress", encoded=True)
    patches = compress_patches(index, cfg, device)
    done("compress", t0, f"{len(enc)} of {stats.num_batches} batches encoded, every "
                         f"decode bit-exact; search {seconds:.3f}s, {warm_s:.3f}s (raw "
                         f"{raw_s:.3f}s, {raw2_s:.3f}s); rows "
                         f"equal the raw run's ({len(rows)}), parity {parity}; patch "
                         f"world: misses {patches['misses']}, {patches['raw']} batches "
                         f"raw, {patches['table_uploads']} table uploads")
    return launches


def decoded_search(engine, works):
    """``search`` on a compressing engine, each batch's payload and its
    device stream_ext logged; after the run every decoded stream_ext is
    read back and must equal the raw buffer it encodes, bit for bit.
    Returns (rows, stats, seconds, [(raw ext, payload)], encoder host
    seconds a batch)."""
    import numpy as np

    sent, on_dev, enc_s = [], [], []
    encode, to_dev = engine._encode_payload, engine._device_ext

    def encode_logged(ext, *a):
        t = time.perf_counter()
        sent.append((ext, encode(ext, *a)))
        enc_s.append(time.perf_counter() - t)
        return sent[-1][1]

    def to_dev_logged(payload, nspans):
        on_dev.append(to_dev(payload, nspans))
        return on_dev[-1]

    engine._encode_payload, engine._device_ext = encode_logged, to_dev_logged
    try:
        rows, stats, seconds = search(engine, works)
    finally:
        engine._encode_payload, engine._device_ext = encode, to_dev
    check(len(sent) == len(on_dev) == stats.num_batches,
          f"{len(sent)} payloads, {len(on_dev)} device streams, {stats.num_batches} batches")
    for i, ((ext, _), dev) in enumerate(zip(sent, on_dev)):
        check(np.array_equal(dev.cpu().numpy(), ext.view(np.int32)),
              f"batch {i}: the decoded stream_ext differs from the raw buffer")
    return rows, stats, seconds, sent, enc_s


def compress_patches(index, cfg, device="cuda", words: int = 7500):
    """The decode's patch path: four batches of eight works at batch_queries
    2^16 (patch budget 4,096), over a 16,000-word vocabulary that the
    10k-work world's script does not use.  Batch 1 (words 0-3,999)
    bootstraps the table; batch 2 (the same words, three script quotes a
    work) carries the quotes as real patches, admitted after it; batch 3
    (words 4,000-15,999) misses on every word and goes raw, its words
    admitted by count; batch 4 (all 16,000 words and quotes) is encoded
    against a table that grew, so the table goes up again.  Every decoded
    stream_ext is read back bit-exact and the rows equal a raw engine's."""
    import dataclasses

    import numpy as np

    from fandom_search_tpu_torch.search.engine import EncodedBatch, SearchEngine
    from fandom_search_tpu_torch.utils.synthetic import make_corpus_with_quotes, make_vocab

    rng = np.random.default_rng(29)
    vocab = make_vocab(rng, 16_000)
    lines = [ln.text for ln in index.lines]
    works = {}
    for group, words_of, quotes in (("a", vocab[:4000], 0), ("b", vocab[:4000], 3),
                                    ("c", vocab[4000:], 0), ("d", vocab, 3)):
        part, _ = make_corpus_with_quotes(rng, lines, num_works=8, words_per_work=words,
                                          quotes_per_work=quotes, vocab=words_of)
        works.update({f"{group}{w}": t for w, t in part.items()})
    pcfg = dataclasses.replace(cfg, search=dataclasses.replace(cfg.search,
                                                               batch_queries=1 << 16))
    raw_rows, _, _ = search(SearchEngine(index, pcfg, device=device), works)
    ccfg = dataclasses.replace(pcfg, search=dataclasses.replace(pcfg.search,
                                                                stream_compress=True))
    engine = SearchEngine(index, ccfg, device=device)
    rows, stats, _, sent, _ = decoded_search(engine, works)
    enc = [p for _, p in sent if isinstance(p, EncodedBatch)]
    out = dict(batches=stats.num_batches, encoded=len(enc), raw=stats.num_batches - len(enc),
               misses=[p.misses for p in enc], patch_budget=sorted({p.p_pad for p in enc}),
               table_uploads=engine.table_uploads, vocab_size=engine._venc.size,
               rows=len(rows))
    print(json.dumps({"compress_patches": out}), flush=True)
    check(_csv_rows(rows) == _csv_rows(raw_rows) and rows,
          f"patch world: compressed rows ({len(rows)}) differ from the raw run's "
          f"({len(raw_rows)}), or there are none")
    check(any(m > 0 for m in out["misses"]), "patch world: no encoded batch carried a patch")
    check(any(not isinstance(p, EncodedBatch) for _, p in sent[1:]),
          "patch world: no batch after the first went raw")
    check(out["table_uploads"] > 1, "patch world: the table went up once only")
    return out


def mesh_devices(n: int):
    """``n`` CUDA devices for a grid, and which they are: distinct cards
    when the machine has ``n``, else the cards named in turn (on a machine
    with one card, ``n`` logical shards of cuda:0)."""
    import torch

    count = torch.cuda.device_count()
    if count >= n:
        return [f"cuda:{i}" for i in range(n)], f"{n} distinct devices"
    if count == 1:
        return ["cuda:0"] * n, f"{n} logical shards on cuda:0 (1 card)"
    return [f"cuda:{i % count}" for i in range(n)], f"{n} shards on {count} cards in turn"


def sharded_step_vs_plain(engine, works, sw_route="K4"):
    """One fused step of the sharded engine on the first batch, each kernel
    call held to its plain version on the same inputs, at the shapes the
    path gives them: on the exact candidate stage K1 on each works slice
    with its halo, K2 on each (works slice x script shard) block (the
    last, partial shard included) and the merged top-k of each slice
    against single-device K2 (and plain) on the whole script in values and
    indices; on any stage every K3 compaction of the engine's module, and
    the verify on each works shard, launched on ``sw_route`` ("K4", or
    "K5 packed" for K5's int16 route) alone.  On a grid of several
    processes, the calls of the cells this one owns.  Returns a dict per
    kernel."""
    import torch

    from fandom_search_tpu_torch.data.fast_tokenizer import tokenize_many
    from fandom_search_tpu_torch.ops.distance_topk import min_keep_int, topk_dot_plain
    from fandom_search_tpu_torch.ops.embed import embed_shingles_plain
    from fandom_search_tpu_torch.ops.scan import nonzero_compact_plain
    from fandom_search_tpu_torch.ops.smith_waterman import (
        sw_lane, sw_normalized_plain, sw_wide,
    )
    from fandom_search_tpu_torch.parallel import sharded as S
    from fandom_search_tpu_torch.search import engine as E

    dix = engine._dix
    items = sorted(tokenize_many(dict(sorted(works.items())[:1000])).items())
    ext, nspans, _, _ = next(iter(engine._batches(items)))
    ext_dev = engine._upload(ext)
    orig = dict(embed=S.embed_shingles, topk=S.topk_dot, sharded=S.sharded_topk,
                compact=E.nonzero_compact, sw=S.sw_normalized)
    res = {k: [] for k in ("K1", "K2", "merged", "K3", sw_route)}
    # the counter that sw_route moves: (K4, K5 packed, K5 f32)
    route_at = {"K4": 0, "K5 packed": 1}[sw_route]

    def embed(tok, mults):
        got = orig["embed"](tok, mults)
        check(torch.equal(got, embed_shingles_plain(tok, mults)),
              f"K1 on a works slice of {tok.shape[0]} tokens differs from plain")
        res["K1"].append(dict(tokens=tok.shape[0], rows=got.shape[0],
                              ms=cuda_ms(lambda: orig["embed"](tok, mults), 5)))
        return got

    def topk(q, s, ns, k, *, min_keep):
        got = orig["topk"](q, s, ns, k, min_keep=min_keep)
        want = topk_dot_plain(q, s, ns, k, min_keep_int(min_keep, q.shape[1]))
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"K2 on a {q.shape[0]} x {s.shape[0]} block (ns_valid {ns}) differs from plain")
        res["K2"].append(dict(rows=q.shape[0], shard_rows=s.shape[0], ns_valid=ns,
                              ms=cuda_ms(lambda: orig["topk"](q, s, ns, k, min_keep=min_keep),
                                         5)))
        return got

    def sharded(mesh, q_slices, s_shards, ns_valid, k, *, min_keep, out):
        got = orig["sharded"](mesh, q_slices, s_shards, ns_valid, k, min_keep=min_keep,
                              out=out)
        ns, main = dix.s_emb.shape[0], dix.s_emb.device
        rows_l = next(q for q in q_slices if q is not None).shape[0]
        for i, q_l in enumerate(q_slices):
            if q_l is None:   # a row of other ranks' cells: they hold it
                continue
            q_m = q_l.to(main)
            with torch.cuda.device(main):
                single = orig["topk"](q_m, dix.s_emb, ns, k, min_keep=min_keep)
                plain = topk_dot_plain(q_m, dix.s_emb, ns, k,
                                       min_keep_int(min_keep, q_l.shape[1]))
            sl = slice(i * rows_l, (i + 1) * rows_l)
            for what, want in (("single-device K2", single), ("plain", plain)):
                check(torch.equal(got[0][sl].to(main), want[0])
                      and torch.equal(got[1][sl].to(main), want[1]),
                      f"the merged top-k of works slice {i} differs from {what} on the "
                      f"whole script")
            res["merged"].append(dict(rows=rows_l, shards=len(s_shards[i]), ns=ns))
        return got

    def compact(mask, size):
        got = orig["compact"](mask, size)
        check(torch.equal(got, nonzero_compact_plain(mask, size)),
              f"K3 compaction of {mask.numel()} to {size} differs from plain")
        res["K3"].append(dict(n=mask.numel(), set=int(mask.sum()), size=size))
        return got

    def sw(a, b, len_a, len_b, c):
        n0 = (sw_wide.launches, sw_lane.launches_i16, sw_lane.launches_f32)
        got = orig["sw"](a, b, len_a, len_b, c)
        moved = tuple(x - y for x, y in zip(
            (sw_wide.launches, sw_lane.launches_i16, sw_lane.launches_f32), n0))
        check(torch.equal(got, sw_normalized_plain(a, b, len_a, len_b, c.sw_match,
                                                   c.sw_mismatch, c.sw_gap)),
              f"{sw_route} on a works shard of {a.shape[0]} pairs differs from plain")
        check(a.device.type == "cpu" or 0 < moved[route_at] == sum(moved),
              f"the verify of a works shard launched (K4, K5 packed, K5 f32) {moved}, "
              f"not {sw_route} alone")
        res[sw_route].append(dict(pairs=a.shape[0], live=int((len_a > 0).sum()),
                                  launches=moved))
        return got

    S.embed_shingles, S.topk_dot, S.sharded_topk = embed, topk, sharded
    E.nonzero_compact, S.sw_normalized = compact, sw
    try:
        engine._fused_call(ext_dev, nspans, engine._cand_budget, engine._verify_budget)
        torch.cuda.synchronize()
    finally:
        S.embed_shingles, S.topk_dot, S.sharded_topk = (orig["embed"], orig["topk"],
                                                        orig["sharded"])
        E.nonzero_compact, S.sw_normalized = orig["compact"], orig["sw"]
    # the calls of the cells this process owns (every cell on one process)
    mesh = engine.mesh
    rows = sum(mesh.head(i) is not None for i in range(len(mesh.devices)))
    exact = engine._candidates_fn == engine._exact_candidates
    want = {"K1": rows, "merged": rows,
            "K2": sum(mesh.local(i, j) for i, row in enumerate(mesh.devices)
                      for j in range(len(row))),
            sw_route: sum(mesh.local(i, 0) for i in range(len(mesh.devices)))}
    if not exact:
        want.update(K1=0, K2=0, merged=0)
    got = {k: len(v) for k, v in res.items()}
    check(all(got[k] == n for k, n in want.items()) and res["K3"],
          f"the sharded step made {got} kernel calls, not {want} and a K3 compaction")
    check(not exact or engine._ns_valid_shards[-1] < engine._ns_per_shard,
          f"the last script shard is not partial: {engine._ns_valid_shards}")
    return res


def sharded_end_to_end(index, cfg, works, planted, exact_rows, oracle, exact_s,
                       sample: int = 600, device="cuda"):
    """Phase 14: the sharded engine on a 2 x 2 mesh (distinct devices when
    the machine has four, else four logical shards of cuda:0): the first
    batch's step with every kernel held to plain, the 10k-work search
    counted (rows equal the single-device exact rows, sample parity 1.0),
    one step under sync debug mode; then over ``sample`` works the mesh
    with stream compression, with the LSH prefilter at sw_variant fast,
    with attach_bucketed_prefilter and with
    attach_bucketed_prefilter_sharded, each row set equal to one device's."""
    import dataclasses

    from fandom_search_tpu_torch import BucketedConfig, LSHConfig
    from fandom_search_tpu_torch.config import MeshConfig
    from fandom_search_tpu_torch.ops.bucketed import attach_bucketed_prefilter
    from fandom_search_tpu_torch.ops.lsh import attach_lsh_prefilter
    from fandom_search_tpu_torch.parallel.mesh import make_mesh
    from fandom_search_tpu_torch.parallel import sharded_bucketed as SB
    from fandom_search_tpu_torch.parallel.sharded import ShardedSearchEngine
    from fandom_search_tpu_torch.search.engine import SearchEngine

    t0 = phase("sharded")
    devices, which = mesh_devices(4)
    print(f"[sharded] mesh 2x2 on {which}", flush=True)
    mcfg = dataclasses.replace(cfg, mesh=MeshConfig(works=2, script=2))
    mesh = make_mesh(mcfg.mesh, devices)
    engine = ShardedSearchEngine(index, mcfg, mesh=mesh)
    held = sharded_step_vs_plain(engine, works)
    (rows, stats, seconds), launches = counted("exact", lambda: search(engine, works))
    same = _csv_rows(rows) == _csv_rows(exact_rows)
    check(same, f"sharded rows ({len(rows)}) differ from one device's ({len(exact_rows)})")
    parity = sample_parity(rows, oracle, "sharded")
    found = {(r.work_id, r.line_no) for r in rows}
    check(all((p.work_id, p.line_no) in found for p in planted),
          "the sharded path missed a planted quote")
    no_host_sync(engine, works, "sharded")
    out = {"mesh": "2x2", "devices": which, "works": len(works),
           "ns_valid_shards": engine._ns_valid_shards, "shard_rows": engine._ns_per_shard,
           "e2e_seconds": seconds, "single_device_e2e_seconds": exact_s,
           "stage_seconds": stats.extra, "batches": stats.num_batches, "rows": len(rows),
           "rows_equal": same, "parity": parity, "launches": launches, "held_to_plain": held}
    by_path = {"sharded": launches}
    del engine

    ids = sorted(works)[:sample]
    sub = {w: works[w] for w in ids}
    want = [r for r in _csv_rows(exact_rows) if r[0] in set(ids)]

    def sub_run(path, eng, expect, what):
        (r, _, s), n = counted(path, lambda: search(eng, sub))
        check(_csv_rows(r) == expect, f"sharded {what}: rows ({len(r)}) differ from one "
                                      f"device's ({len(expect)})")
        out[f"{path}_seconds"] = s
        by_path[path] = n
        return eng

    ccfg = dataclasses.replace(mcfg, search=dataclasses.replace(mcfg.search,
                                                                stream_compress=True))
    eng = sub_run("sharded_compress", ShardedSearchEngine(index, ccfg, mesh=mesh), want,
                  "with stream_compress")
    check(eng._venc.ready and eng.table_uploads > 0, "the sharded compressed run sent no "
                                                     "encoded batch")
    lcfg = dataclasses.replace(mcfg, search=dataclasses.replace(mcfg.search, sw_variant="fast"))
    single = SearchEngine(index, lcfg, device=device)
    attach_lsh_prefilter(single, LSHConfig())
    lsh_want = _csv_rows(single.search_works(sub)[0])
    eng = ShardedSearchEngine(index, lcfg, mesh=mesh)
    attach_lsh_prefilter(eng, LSHConfig())
    out["held_to_plain_lsh"] = sharded_step_vs_plain(eng, sub, sw_route="K5 packed")
    sub_run("sharded_lsh", eng, lsh_want, "with --lsh --sw-variant fast")
    eng = ShardedSearchEngine(index, mcfg, mesh=mesh)
    attach_bucketed_prefilter(eng, BucketedConfig())
    check(eng._bucketed_risk_budget is None, "the 10k-work world took the hybrid route")
    sub_run("sharded_bucketed", eng, want, "with attach_bucketed_prefilter")
    eng = ShardedSearchEngine(index, mcfg, mesh=mesh)
    SB.attach_bucketed_prefilter_sharded(eng, BucketedConfig())
    tok = first_batch_stream(eng, sub)
    out["held_to_plain_bucketed_sharded"], _ = stage_vs_plain(
        "sharded bucketed stage", lambda: eng._candidates_fn(tok, max_out=eng._cand_budget),
        also=(SB,))
    sub_run("sharded_bucketed_sharded", eng, want, "with attach_bucketed_prefilter_sharded")
    print(json.dumps({"sharded": out}), flush=True)
    done("sharded", t0, f"mesh 2x2 on {which}: search {seconds:.3f}s (one device "
                        f"{exact_s:.3f}s), rows equal one device's ({len(rows)}), parity "
                        f"{parity}; {sample} works with compression, --lsh fast and both "
                        f"bucketed attaches equal one device's")
    return by_path


def dryrun_world(works_ax: int):
    """``__graft_entry__.py``'s ``dryrun_multichip`` world: seed 7, 15
    uniform and 15 stopword-led lines (their word pairs overflow the
    bucketed cap), 40 works and one work longer than the batch cap
    (works_ax * 512 tokens)."""
    import numpy as np

    from fandom_search_tpu_torch.data.script_parser import parse_script
    from fandom_search_tpu_torch.utils.synthetic import (
        make_corpus_with_quotes, make_script, make_vocab,
    )

    rng = np.random.default_rng(7)
    vocab = make_vocab(rng, 500)
    uniform_txt = make_script(rng, vocab, num_lines=15)
    skew_txt = "\n".join(
        "ALICE: of the of the " + " ".join(rng.choice(vocab, size=6).tolist())
        for _ in range(15))
    lines = parse_script(uniform_txt + "\n" + skew_txt)
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=40, words_per_work=150,
        quotes_per_work=3, vocab=vocab)
    long_w, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=1,
        words_per_work=works_ax * 512 + 700, quotes_per_work=6, vocab=vocab)
    works["workzlong"] = long_w["work00000"]
    return lines, works


def sharded_dryrun():
    """Phase 15: the dry-run world on a 2 x 4 mesh, the fused sharded
    engine and the sharded bucketed hybrid: rows equal to the port's
    oracle, the hybrid's at-risk count above 0."""
    import dataclasses

    from fandom_search_tpu_torch import BucketedConfig, PipelineConfig
    from fandom_search_tpu_torch.config import MeshConfig
    from fandom_search_tpu_torch.parallel.mesh import make_mesh
    from fandom_search_tpu_torch.parallel import sharded_bucketed as SB
    from fandom_search_tpu_torch.parallel.sharded import ShardedSearchEngine
    from fandom_search_tpu_torch.search.index import build_script_index
    from fandom_search_tpu_torch.search.oracle import search_works_oracle

    t0 = phase("sharded dryrun")
    devices, which = mesh_devices(8)
    cfg = PipelineConfig(mesh=MeshConfig(works=2, script=4))
    cfg = dataclasses.replace(cfg, search=dataclasses.replace(cfg.search, batch_queries=1024))
    lines, works = dryrun_world(2)
    index = build_script_index(lines, cfg.shingle, cfg.search)
    orows, _ = search_works_oracle(works, index, cfg)
    want = _csv_rows(orows)
    check(len(want) >= 100, f"dry-run world too sparse: {len(want)} oracle rows")
    mesh = make_mesh(cfg.mesh, devices)
    fused = ShardedSearchEngine(index, cfg, mesh=mesh)
    check(fused._ns_valid_shards[1:] == [0] * 3,
          f"script shards {fused._ns_valid_shards}: expected three past the script's end")
    held = sharded_step_vs_plain(fused, works)
    (rows, stats, s1), n_fused = counted("exact", lambda: search(fused, works))
    check(_csv_rows(rows) == want, f"dry run, fused: {len(rows)} rows against the "
                                   f"oracle's {len(want)}")
    hyb = ShardedSearchEngine(index, cfg, mesh=mesh)
    SB.attach_bucketed_prefilter_sharded(hyb, BucketedConfig())
    check(hyb.bucketed.overflow_frac > 0 and hyb._bucketed_risk_budget is not None,
          "the dry-run world no longer takes the hybrid route")
    # the first batch holds at-risk rows, so K2's rescue has entries to hold
    tok = first_batch_stream(hyb, works)
    held_hyb, _ = stage_vs_plain("sharded hybrid stage", lambda: hyb._candidates_fn(
        tok, max_out=hyb._cand_budget, risk_budget=hyb._bucketed_risk_budget), also=(SB,))
    (rows2, stats2, s2), n_hyb = counted("bucketed_hybrid", lambda: search(hyb, works))
    check(_csv_rows(rows2) == want, f"dry run, bucketed hybrid: {len(rows2)} rows against "
                                    f"the oracle's {len(want)}")
    check(hyb._bucketed_risk_queries > 0, "the hybrid rerouted no at-risk query")
    print(json.dumps({"sharded_dryrun": {
        "mesh": "2x4", "devices": which, "works": len(works), "oracle_rows": len(want),
        "query_shingles": stats.num_query_shingles, "fused_seconds": s1,
        "hybrid_seconds": s2, "overflow_frac": hyb.bucketed.overflow_frac,
        "risk_queries": hyb._bucketed_risk_queries,
        "bucketed_risk_frac": stats2.extra.get("bucketed_risk_frac"),
        "ns_valid_shards": fused._ns_valid_shards, "held_to_plain": held,
        "held_to_plain_hybrid": held_hyb,
        "launches": {"fused": n_fused, "hybrid": n_hyb},
    }}), flush=True)
    done("sharded dryrun", t0, f"mesh 2x4 on {which}: both paths equal the oracle's "
                               f"{len(want)} rows; {hyb._bucketed_risk_queries} at-risk "
                               f"queries rerouted")
    return {"dryrun_fused": n_fused, "dryrun_hybrid": n_hyb}


def free_port() -> int:
    """A free TCP port on the loopback address."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def multihost_phase(index, cfg, works, exact_rows, oracle, script_text, root: Path,
                    sample: int = 600, device="cuda"):
    """Phase 16: --multihost on the card.  A one-rank NCCL world
    (tcp://127.0.0.1:<free port>, world 1, rank 0) runs the sharded engine
    on a 2 x 2 grid of the world's cells (four logical shards of cuda:0)
    through the exchange layer's all_gathers over ``sample`` works: the
    first batch's step with every K1, K2, merge, K3 and K4 call held to
    plain, the search counted (rows equal the one-process mesh's and one
    device's, sample parity 1.0 against the oracle), one step under sync
    debug mode; the world is left.  Then the CLI twice on the sample
    written to disk, `search --multihost --num-processes 1 --process-id 0
    --coordinator 127.0.0.1:<port> --mesh 1x1` and the same search
    without --multihost: byte-equal CSVs."""
    import dataclasses
    import os

    import torch
    import torch.distributed as dist

    from fandom_search_tpu_torch.config import MeshConfig
    from fandom_search_tpu_torch.parallel import mesh as M
    from fandom_search_tpu_torch.parallel.sharded import ShardedSearchEngine

    t0 = phase("multihost")
    # the world lives on the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    ids = sorted(works)[:sample]
    sub = {w: works[w] for w in ids}
    want = [r for r in _csv_rows(exact_rows) if r[0] in set(ids)]
    devices, which = mesh_devices(4)
    mcfg = dataclasses.replace(cfg, mesh=MeshConfig(works=2, script=2))
    one_proc = ShardedSearchEngine(index, mcfg, mesh=M.make_mesh(mcfg.mesh, devices))
    (one_rows, _, one_s), _ = counted("sharded", lambda: search(one_proc, sub))
    del one_proc
    backend = "nccl" if device == "cuda" else "gloo"
    n = M.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device=device,
                               timeout_s=300)
    try:
        want_n = torch.cuda.device_count() if device == "cuda" else 1
        check(dist.get_backend() == backend and n == want_n,
              f"the one-rank world runs {dist.get_backend()} over {n} devices")
        mesh = M.make_mesh(mcfg.mesh, devices, ranks=[0] * 4)
        check(mesh.distributed and mesh.world == 1, "the grid is not the world's")
        engine = ShardedSearchEngine(index, mcfg, mesh=mesh)
        held = sharded_step_vs_plain(engine, sub)
        gathers = []
        orig = dist.all_gather
        dist.all_gather = lambda *a, **k: gathers.append(a[1].numel()) or orig(*a, **k)
        try:
            (rows, stats, seconds), launches = counted("multihost", lambda: search(engine, sub))
        finally:
            dist.all_gather = orig
        check(gathers, "the multihost search made no all_gather")
        check(_csv_rows(rows) == _csv_rows(one_rows) == want,
              f"multihost rows ({len(rows)}) differ from the one-process mesh's "
              f"({len(one_rows)}) or one device's ({len(want)})")
        parity = sample_parity(rows, oracle, "multihost")
        no_host_sync(engine, sub, "multihost")
        del engine
    finally:
        M.shutdown_multihost()
    check(not dist.is_initialized(), "the one-rank world was not left")
    wdir = root / "mh_works"
    wdir.mkdir()
    for w in ids:
        (wdir / f"{w}.txt").write_text(works[w], encoding="utf-8")
    script = root / "mh_script.txt"
    script.write_text(script_text, encoding="utf-8")
    base = ["search", str(wdir), str(script), "--mesh", "1x1", "--device", device]
    t1 = time.perf_counter()
    cli_json([*base, "-o", str(root / "mh.csv"), "--multihost", "--num-processes", "1",
              "--process-id", "0", "--coordinator", f"127.0.0.1:{free_port()}"])
    cli_mh_s = time.perf_counter() - t1
    check(not dist.is_initialized(), "the CLI left its world up")
    cli_json([*base, "-o", str(root / "one.csv")])
    csv_mh, csv_one = (root / "mh.csv").read_bytes(), (root / "one.csv").read_bytes()
    check(csv_mh == csv_one and csv_mh.count(b"\n") > 1,
          "search --multihost wrote another CSV than the same search without it")
    print(json.dumps({"multihost": {
        "world": 1, "backend": backend, "mesh": "2x2", "devices": which, "works": len(sub),
        "e2e_seconds": seconds, "one_process_e2e_seconds": one_s,
        "stage_seconds": stats.extra, "batches": stats.num_batches, "rows": len(rows),
        "all_gathers": len(gathers), "all_gather_bytes": sum(gathers), "parity": parity,
        "launches": launches, "held_to_plain": held, "cli_multihost_seconds": cli_mh_s,
        "cli_rows": csv_mh.count(b"\n") - 1, "card": CARD,
    }}), flush=True)
    done("multihost", t0, f"one-rank {backend} world, mesh 2x2 on {which}: {len(gathers)} "
                          f"all_gathers, rows equal the one-process mesh's and one "
                          f"device's ({len(rows)}), parity {parity}; CLI --multihost CSV "
                          f"equal; {CARD}")
    return launches


HOST_PAGE = """<html><body><dl class="work meta group">
<dd class="fandom tags"><a class="tag">Smoke Fandom</a></dd>
<dd class="character tags"><a class="tag">Alice</a><a class="tag">Bob</a></dd>
<dd class="kudos">{kudos}</dd></dl>
<div id="workskin"><div class="preface group"><h2 class="title heading">{title}</h2>
<h3 class="byline heading"><a href="/users/a">a</a></h3></div>
<div id="chapters"><h3 class="landmark heading">Chapter Text</h3>
<div class="userstuff"><p>{text}</p></div></div></div></body></html>"""


def host_verbs(root: Path, script_text: str, works, planted, sample: int = 20):
    """Phase 17: the host verbs through the CLI, touching no device.
    `format` on the world's script always (one row a script line);
    `clean` and `getmeta` on three AO3-shaped pages (one broken) where bs4
    is installed; `search --reference` on ``sample`` works where sklearn
    and Levenshtein are: its rows equal ReferenceSearch's called
    directly, and its planted quotes found.  Prints which ran and which
    were absent; a verb that runs and fails fails the script."""
    import csv
    import importlib.util

    from fandom_search_tpu_torch import cli
    from fandom_search_tpu_torch.data.script_parser import parse_script

    t0 = phase("host_verbs")
    have = {m: importlib.util.find_spec(m) is not None for m in ("bs4", "sklearn",
                                                                 "Levenshtein")}
    ran, absent = ["format"], [m for m, ok in have.items() if not ok]
    script = root / "hv_script.txt"
    script.write_text(script_text, encoding="utf-8")
    check(cli.main(["format", str(script), "-o", str(root / "lines.csv")]) == 0,
          "format failed")
    with open(root / "lines.csv", newline="", encoding="utf-8") as f:
        got = list(csv.reader(f))
    lines = parse_script(script_text)
    check(got[0] == ["line_no", "speaker", "text"] and len(got) == len(lines) + 1
          and got[1] == [str(lines[0].line_no), lines[0].speaker, lines[0].text],
          f"format wrote {len(got) - 1} rows for {len(lines)} script lines")
    out = {"format_rows": len(got) - 1}
    if have["bs4"]:
        raw = root / "raw"
        raw.mkdir()
        ids = sorted(works)[:2]
        for k, w in enumerate(ids):
            (raw / f"{w}.html").write_text(HOST_PAGE.format(
                kudos=k + 1, title=w, text=works[w][:400]), encoding="utf-8")
        (raw / "broken.html").write_text("<html><h1>Error 500</h1></html>", encoding="utf-8")
        check(cli.main(["clean", str(raw), "-o", str(root / "clean")]) == 0, "clean failed")
        kept = sorted(p.stem for p in (root / "clean").glob("*.txt"))
        check(kept == ids, f"clean kept {kept}, not {ids}")
        check(cli.main(["getmeta", str(raw), "-o", str(root / "meta.csv")]) == 0,
              "getmeta failed")
        with open(root / "meta.csv", newline="", encoding="utf-8") as f:
            meta = list(csv.DictReader(f))
        check([m["work_id"] for m in meta] == ids
              and all(m["characters"] == "Alice; Bob" for m in meta),
              f"getmeta wrote {meta}")
        ran += ["clean", "getmeta"]
        out.update(clean_kept=len(kept), meta_rows=len(meta))
    if have["sklearn"] and have["Levenshtein"]:
        from fandom_search_tpu_torch import PipelineConfig
        from fandom_search_tpu_torch.search.reference_pipeline import ReferenceSearch

        ids = sorted(works)[:sample]
        wdir = root / "ref_works"
        wdir.mkdir()
        for w in ids:
            (wdir / f"{w}.txt").write_text(works[w], encoding="utf-8")
        t1 = time.perf_counter()
        cli_json(["search", str(wdir), str(script), "-o", str(root / "ref.csv"),
                  "--reference"])
        ref_s = time.perf_counter() - t1
        direct, _ = ReferenceSearch(lines, PipelineConfig()).search_works(
            {w: works[w] for w in ids})
        with open(root / "ref.csv", newline="", encoding="utf-8") as f:
            rows = list(csv.reader(f))[1:]
        check(rows and len(rows) == len(direct)
              and [r[0] for r in rows] == [d.work_id for d in direct],
              f"search --reference wrote {len(rows)} rows, ReferenceSearch {len(direct)}")
        found = {(d.work_id, d.line_no) for d in direct}
        missed = [p for p in planted if p.work_id in set(ids)
                  and (p.work_id, p.line_no) not in found]
        check(not missed, f"search --reference missed planted quotes {missed[:3]}")
        ran.append("search --reference")
        out.update(reference_rows=len(rows), reference_seconds=ref_s)
    print(json.dumps({"host_verbs": dict(ran=ran, absent=absent, **out)}), flush=True)
    done("host_verbs", t0, f"ran {', '.join(ran)}; absent packages: "
                           f"{', '.join(absent) or 'none'}")


def bench_phase(root: Path):
    """Phase 18: the port's bench through its CLI verb, in a process of its
    own; returns its launches by kernel (its stage_launches summed) and
    its details."""
    t0 = phase("bench")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "BENCH_SCALE_WORKS": "0",
           "BENCH_TIME_BUDGET_S": "0"}
    r = subprocess.run([sys.executable, "-m", PKG, "bench"], cwd=root, env=env,
                       capture_output=True, text=True, timeout=900)
    check(r.returncode == 0, f"bench exited {r.returncode}:\n{r.stderr[-4000:]}")
    out = r.stdout.strip().splitlines()
    check(len(out) == 1, f"bench printed {len(out)} stdout lines, not one")
    line = json.loads(out[0])
    check(set(line) == BENCH_LINE_KEYS, f"result line keys {sorted(line)}")
    check(line["backend"] == "gpu" and line["degraded"] is False and line["value"] > 0,
          f"result line {line}")
    d = json.loads((root / "torch_bench_details.json").read_text())
    check(d["capture_complete"] and d["stages_done"] == list(BENCH_STAGES)
          and not d.get("stages_skipped_for_time"),
          f"bench stages {d['stages_done']}, skipped {d.get('stages_skipped_for_time')}")
    check(d["kernel_recall_at_10_vs_oracle"] == 1.0,
          f"K2 recall@10 vs the oracle {d['kernel_recall_at_10_vs_oracle']}")
    check(d["e2e_sample_match_parity"] == 1.0,
          f"e2e sample parity {d['e2e_sample_match_parity']}")
    check(d["recall_gate_ok"] is True, "bucketed e2e rows differ from the exact rows")
    guaranteed = {k: v for k, v in d.items() if k.endswith("_guaranteed_recall")}
    check(len(guaranteed) == 5 and all(v == 1.0 for v in guaranteed.values()),
          f"guaranteed recalls {guaranteed}")
    launches = {key: sum(per[key] for per in d["stage_launches"].values())
                for key in read_counters()}
    check_launches("bench", launches)
    rates = {k: v for k, v in d.items() if k.endswith(("per_sec", "per_sec_equiv"))
             or k in ("e2e_seconds_runs", "e2e_stage_seconds", "kernel_engine_int8_peak_share",
                      "build_seconds", "card")}
    print(json.dumps({"bench": dict(line=line, stage_seconds=d["stage_seconds"], **rates)}),
          flush=True)
    done("bench", t0, f"{line['value']:.4g} pairs/s; e2e {min(d['e2e_seconds_runs']):.3f}s "
                      f"of {d['e2e_works']} works; stages {sum(d['stage_seconds'].values()):.1f}s")
    return launches, d


def bench_shapes(details, device="cuda"):
    """Phase 19: the bench's kernels against their plain versions at the
    bench's own shapes, on its own data (bench.py's data helpers at its
    sizes), every slot equal, outside its counted run: K1 on the kernel
    stages' 2^17 + 5 tokens and on bucketed_huge's 2^22 + 5 script tokens;
    K2 gated and exact at 2^17 x 8,192, and gated at 2^17 x 2^22 (the
    flat and the English-skew references) on K2_HELD_ROWS rows; K6
    ungated and gated at 2^17 x 8,192, and the bench's LSH recall@10
    recomputed from the plain version's candidates; K4 on the sw stage's
    8,192 pairs; bucketed_huge's flat stage and bucketed_english_huge's
    hybrid stage (settled budgets) under ``stage_vs_plain``, which holds
    each K1 and K3 call whole and the hybrid's K2 on its at-risk rows.
    The e2e stages run the engine shapes of phase 2 and the flagship
    world is phase 11's.  Returns {kernel key: {shape: dict(ms, plain_ms,
    bound...)}}."""
    import dataclasses

    import numpy as np
    import torch

    from fandom_search_tpu_torch import PipelineConfig, bench
    from fandom_search_tpu_torch.data.hashing import derive_sign_mults
    from fandom_search_tpu_torch.data.shingler import shingle_hashes
    from fandom_search_tpu_torch.ops import bucketed as B
    from fandom_search_tpu_torch.ops.distance_topk import (
        NEG_INF, min_keep_int, topk_dot, topk_dot_plain,
    )
    from fandom_search_tpu_torch.ops.embed import embed_shingles, embed_shingles_plain
    from fandom_search_tpu_torch.ops.lsh import (
        SENT, LSHIndex, coarse_sim_threshold, encode, hamming_topk, hamming_topk_plain,
        rerank_exact,
    )
    from fandom_search_tpu_torch.ops.smith_waterman import sw_normalized_plain, sw_wide
    from fandom_search_tpu_torch.search.oracle import topk_scores_np

    t0 = phase("bench shapes")
    cfg = PipelineConfig()
    size = bench.sizes()
    dev = torch.device(device)
    k, dim, n, thr = cfg.search.k, cfg.shingle.dim, cfg.shingle.n, cfg.search.candidate_threshold
    out = {key: {} for key in ("embed_shingles", "topk_dot", "sw_wide", "hamming_topk")}

    def k1(name, tok, mults):
        got = embed_shingles(tok, mults)
        want = embed_shingles_plain(tok, mults)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K1 differs from plain at the bench's {name}")
        out["embed_shingles"][name] = dict(
            tokens=tok.shape[0], max_abs_err=0.0, ms=cuda_ms(lambda: embed_shingles(tok, mults), 5),
            plain_ms=cuda_ms(lambda: embed_shingles_plain(tok, mults), 1),
            **bound(tok.numel() * 4 + mults.numel() * 4 + got.numel(), got.numel() * n,
                    INT32_OPS_S))
        return got

    def k2(name, q, s, ns, mk, rows=None):
        """K2 on all of ``q``; every slot of its first ``rows`` rows (all
        when None) against plain (``plain_ms`` on those rows)."""
        got = topk_dot(q, s, ns, k, min_keep=mk)
        qh = q if rows is None else q[:rows]
        want = topk_dot_plain(qh, s, ns, k, min_keep_int(mk, dim))
        torch.cuda.synchronize()
        check(torch.equal(got[0][: qh.shape[0]], want[0])
              and torch.equal(got[1][: qh.shape[0]], want[1]),
              f"K2 differs from plain at the bench's {name}")
        filled = int((want[0] > NEG_INF).sum())
        check(filled > 0, f"K2 at the bench's {name}: no entry to compare")
        ops = 2 * q.shape[0] * ns * dim
        out["topk_dot"][name] = dict(
            shape=f"NQ={q.shape[0]} NS={ns} k={k} min_keep={mk}", held_rows=qh.shape[0],
            filled=filled, max_abs_err=0.0,
            ms=cuda_ms(lambda: topk_dot(q, s, ns, k, min_keep=mk), 3),
            plain_ms=cuda_ms(lambda: topk_dot_plain(qh, s, ns, k, min_keep_int(mk, dim)), 1),
            **bound(q.numel() + s.numel() + q.shape[0] * k * 8, ops, INT8_OPS_S))

    # the kernel stages (default_rng(0)): K1, K2 gated and exact, K6
    q_stream, _, s_emb, plant_idx = bench.kernel_data(cfg, size["nq"], size["ns"])
    ops = bench.kernel_operands(dev, cfg, q_stream, s_emb, plant_idx)
    k1(f"kernel_stage_T{ops['tok'].shape[0]}", ops["tok"], ops["mults"])
    q, s_pad, nsv = ops["q_dev"], ops["s_pad"], ops["ns_valid"]
    k2("kernel_engine", q, s_pad, nsv, thr)
    k2("kernel_exact", q, s_pad, nsv, -float("inf"))
    lsh = LSHIndex.build(s_emb, cfg.lsh, cfg.shingle,
                         pad_multiple=cfg.search.script_pad_multiple, device=dev)
    qc = encode(q, lsh.projection)
    r, bits = cfg.lsh.rerank, cfg.lsh.bits
    keep = coarse_sim_threshold(thr, n, bits)
    for mode, mks in (("ungated", SENT), ("gated", keep)):
        pv, pi = hamming_topk_plain(qc, lsh.codes_t, lsh.ns_valid, r, bits, mks)
        kv, ki = hamming_topk(qc, lsh.codes_t, lsh.ns_valid, r, bits, min_keep_sim=mks)
        torch.cuda.synchronize()
        check(torch.equal(kv, pv) and torch.equal(ki, pi),
              f"K6 differs from plain at the bench's lsh stage, {mode} (min_keep_sim {mks})")
        filled = int((pv > NEG_INF).sum())
        check(filled > 0, f"K6 at the bench's lsh stage, {mode}: no entry to compare")
        out["hamming_topk"][f"lsh_stage_{mode}"] = dict(
            shape=f"NQ={qc.shape[0]} NS={lsh.ns_valid} bits={bits} R={r} min_keep_sim={mks}",
            filled=filled, max_abs_err=0.0,
            ms=cuda_ms(lambda: hamming_topk(qc, lsh.codes_t, lsh.ns_valid, r, bits,
                                            min_keep_sim=mks), 3),
            plain_ms=cuda_ms(lambda: hamming_topk_plain(qc, lsh.codes_t, lsh.ns_valid, r, bits,
                                                        mks), 1),
            **bound(qc.numel() * 4 + lsh.codes_t.numel() * 4 + qc.shape[0] * r * 8,
                    2 * qc.shape[0] * lsh.ns_valid * bits, INT8_OPS_S))
        if mode == "ungated":
            # the bench's recall@10, from the plain version's candidates
            cq = size["cpu_nq"]
            lv, _ = rerank_exact(q[:cq], s_pad, pi[:cq], pv[:cq] > NEG_INF / 2, k, dim)
            ovals, _ = topk_scores_np(q[:cq].cpu().numpy(), s_emb, k, dim)
            recall = bench._recall_by_score(ovals, lv.cpu().numpy(), dim, k)
            check(recall == details["lsh_recall_at_10_vs_exact"],
                  f"the bench's LSH recall@10 {details['lsh_recall_at_10_vs_exact']} is not "
                  f"the plain version's {recall}")
        del pv, pi, kv, ki
    del ops, q, s_pad, qc, lsh

    # the sw stage (default_rng(5)): K4
    a, b = bench.sw_data(cfg, size["sw_b"])
    ad, bd = (torch.from_numpy(x.view(np.int32)).to(dev) for x in (a, b))
    la = torch.full((a.shape[0],), a.shape[1], dtype=torch.int32, device=dev)
    lb = torch.full((a.shape[0],), b.shape[1], dtype=torch.int32, device=dev)
    xc = cfg.search
    g = sw_wide(ad, bd, la, lb, xc)
    w = sw_normalized_plain(ad, bd, la, lb, xc.sw_match, xc.sw_mismatch, xc.sw_gap)
    torch.cuda.synchronize()
    check(torch.equal(g, w), "K4 differs from plain at the bench's sw stage")
    out["sw_wide"]["sw_stage"] = dict(
        shape=f"B={a.shape[0]} {a.shape[1]}x{b.shape[1]}", max_abs_err=0.0,
        ms=cuda_ms(lambda: sw_wide(ad, bd, la, lb, xc), 5),
        plain_ms=cuda_ms(lambda: sw_normalized_plain(ad, bd, la, lb, xc.sw_match,
                                                     xc.sw_mismatch, xc.sw_gap), 1),
        **sw_bound(ad, bd, la, lb, xc))

    mults = torch.from_numpy(derive_sign_mults(cfg.shingle.seed, n, dim).view(np.int32)).to(dev)
    held = {}

    # bucketed_huge (default_rng(7)): K1 on the 2^22 + 5 script tokens, the
    # flat stage, its K2 reference on K2_HELD_ROWS rows
    ns_h, nq = size["bucketed_huge"], size["nq"]
    s_stream, q_stream = bench.bucketed_streams(cfg, ns_h, nq)
    bidx = B.BucketedIndex.build(shingle_hashes(s_stream, cfg.shingle), cfg.bucketed,
                                 cfg.shingle, device=dev)
    sb, nsb = bench._pad_rows(k1(f"bucketed_huge_script_T{s_stream.size}",
                                 bench._tokens(s_stream, dev), mults), 2048)
    qs = bench._tokens(q_stream, dev)
    qb = embed_shingles(qs, mults)
    held["bucketed_huge"], _ = stage_vs_plain("bench bucketed_huge", lambda: (
        B.bucketed_candidates_flat(
            qs, qb, bidx.entries, bidx.offsets, sb, n=n, cap=cfg.bucketed.cap,
            num_buckets=bidx.num_buckets, salts=bidx.salts, k=k, dim=dim, threshold=thr,
            max_out=1 << 16)))
    k2("bucketed_huge_exact", qb, sb, nsb, thr, rows=K2_HELD_ROWS)
    del bidx, sb, qs, qb

    # bucketed_english_huge (SKEW): the hybrid at its settled budgets, its
    # K2 reference on K2_HELD_ROWS rows
    tag = "bucketed_english_huge"
    spec = bench.SKEW[tag]
    bcfg = dataclasses.replace(cfg.bucketed, pairs=spec["pairs_mode"])
    nq_c = min(nq, spec["nq_max"])
    s_stream, q_stream = bench.skew_streams(cfg, size[tag], nq_c, **spec)
    bidx = B.BucketedIndex.build(shingle_hashes(s_stream, cfg.shingle), bcfg, cfg.shingle,
                                 device=dev)
    sz, nsz = bench._pad_rows(embed_shingles(bench._tokens(s_stream, dev), mults), 2048)
    qs = bench._tokens(q_stream, dev)
    qz = embed_shingles(qs, mults)

    def hybrid(max_out, risk_budget):
        return B.bucketed_hybrid(
            qs, qz, bidx.entries, bidx.offsets, sz, nsz, n=n, cap=bcfg.cap,
            num_buckets=bidx.num_buckets, salts=bidx.salts, k=k, dim=dim, threshold=thr,
            max_out=max_out, risk_budget=risk_budget, pairs_mode=bcfg.pairs)

    budgets = {"max_out": 1 << 16, "risk_budget": 1 << 13}
    _, risk = bench.hybrid_rerun(hybrid, budgets)
    check(risk / nq_c == details[f"{tag}_risk_frac"],
          f"{tag}: at-risk {risk} of {nq_c}, the bench's {details[f'{tag}_risk_frac']}")
    held[tag], k2_args = stage_vs_plain(f"bench {tag}", lambda: hybrid(
        budgets["max_out"], budgets["risk_budget"]))
    check(k2_args is not None, f"{tag}: the hybrid made no K2 call")
    k2(f"{tag}_exact", qz, sz, nsz, thr, rows=K2_HELD_ROWS)
    del bidx, sz, qs, qz
    torch.cuda.empty_cache()
    print(json.dumps({"bench_shapes": dict(out, stage_calls_held=held)}), flush=True)
    done("bench shapes", t0, "every slot equal to plain: K1 2^17 + 5 and 2^22 + 5 tokens; "
                             "K2 2^17 x 8,192 gated and exact, 2^17 x 2^22 twice; K6 ungated "
                             "and gated; K4; the flat and hybrid stages' K1/K2/K3 calls")
    return out


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
    global CARD
    CARD = smi[0]
    boost = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.strip().splitlines()[0]
    global INT32_OPS_S
    INT32_OPS_S = INT32_LANES * float(boost) * 1e6
    kind = torch.cuda.get_device_name(0)
    done("device", t0, f"{kind} x{torch.cuda.device_count()} torch {torch.__version__} "
                       f"cuda {torch.version.cuda}; boost clock {boost} MHz")

    from fandom_search_tpu_torch import bench
    from fandom_search_tpu_torch.ops import _cuda

    global INT8_OPS_S
    INT8_OPS_S = bench.INT8_PEAK_OPS_S["H100"]
    t0 = phase("build")
    build_s = _cuda.build(force=True)
    _cuda.library()
    from fandom_search_tpu_torch.data import fast_tokenizer

    check(fast_tokenizer.get_lib() is not None,
          f"the native tokenizer did not build or load from {fast_tokenizer._SRC}")
    done("build", t0, f"nvcc {build_s:.1f}s; native tokenizer loaded from "
                      f"{fast_tokenizer._SRC.relative_to(ROOT)}")

    from fandom_search_tpu_torch.ops.embed import embed_shingles
    from fandom_search_tpu_torch.search.engine import SearchEngine

    t0 = phase("world")
    cfg, index, works, planted, script_text = make_world(args.seed, args.works)
    engine = SearchEngine(index, cfg, device="cuda")
    done("world", t0, f"{len(index.lines)} lines, {index.num_shingles} script "
                      f"shingles, {len(works)} works, {len(planted)} planted")

    res = kernel_checks(engine, works, args.seed)
    tok = first_batch_stream(engine, works)
    q_emb = embed_shingles(tok, engine._dix.mults)
    res["topk_dot"]["new_shapes"], res["topk_dot_rows"]["new_shapes"] = topk_wide_check(
        engine, tok, q_emb, index)
    res["topk_dot_wgmma"] = k2_wgmma_check(args.seed)
    res["hamming_topk"]["new_shapes"] = hamming_wide_check(engine, q_emb)
    del q_emb
    launches = {}
    exact_rows, launches["exact"], exact_s, oracle = end_to_end(
        engine, works, planted, index, cfg)
    no_host_sync(engine, works, "exact")
    launches["compress"] = compress_end_to_end(index, cfg, works, engine, exact_rows, oracle)
    launches.update(sharded_end_to_end(index, cfg, works, planted, exact_rows, oracle,
                                       exact_s))
    launches.update(sharded_dryrun())
    with tempfile.TemporaryDirectory() as tmp:
        launches["multihost"] = multihost_phase(index, cfg, works, exact_rows, oracle,
                                                script_text, Path(tmp))
    launches["lsh"] = lsh_end_to_end(index, cfg, works, planted, exact_rows)
    launches["lsh_f32"] = lsh_f32_path(index, cfg, works, planted)
    launches["bucketed"] = bucketed_end_to_end(index, cfg, works, planted, exact_rows)
    launches["bucketed_big"] = bucketed_big(cfg)
    launches["rows_ab"], ab_err = rows_ab(cfg, args.seed)
    res["topk_dot_rows"]["max_abs_err"] = max(res["topk_dot_rows"]["max_abs_err"], ab_err)
    with tempfile.TemporaryDirectory() as tmp:
        by_phase, idx, wdir = persist_serve(works, script_text, Path(tmp))
        launches.update(by_phase)
        launches["profile"] = profile_phase(idx, wdir, Path(tmp))
        launches["bucketed_cli"] = bucketed_cli(Path(tmp), wdir)
    for name, n in wide_configs(index, cfg, works).items():
        launches[f"wide_{name}"] = n
    with tempfile.TemporaryDirectory() as tmp:
        host_verbs(Path(tmp), script_text, works, planted)
    # the bench's process needs the card's memory that this one caches
    del engine, works, planted, exact_rows, oracle
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        launches["bench"], bench_details = bench_phase(Path(tmp))
    for key, shapes in bench_shapes(bench_details).items():
        res[key]["bench_shapes"] = shapes

    table = []
    for key, name, src, rep, path in KERNELS:
        by_path = {p: n[key] for p, n in launches.items()}
        table.append(dict(name=name, route="cuda", source=f"{PKG}/{src}",
                          replaces=rep, launches=by_path[path],
                          launches_by_path=by_path, **res[key]))
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
