"""The port's CLI; counterpart of fandom_search_tpu/cli.py.

    python -m fandom_search_tpu_torch scrape TAG -o raw/ [--start-page N] \\
        [--end-page N] [--delay SECONDS]
    python -m fandom_search_tpu_torch clean raw/ -o works/
    python -m fandom_search_tpu_torch getmeta raw/ -o meta.csv
    python -m fandom_search_tpu_torch format SCRIPT -o lines.csv
    python -m fandom_search_tpu_torch index SCRIPT [SCRIPT ...] -o idx/ [--lsh] \\
        [--bucketed [--bucketed-pairs triangles|all]]
    python -m fandom_search_tpu_torch search WORKS_DIR (SCRIPT ... | --index idx/) \\
        -o matches.csv [--parquet] [--resume-dir DIR] [--profile DIR] \\
        [--lsh | --bucketed [--bucketed-pairs triangles|all]] \\
        [--sw-variant VARIANT] [--stream-compress] [--shards N | --mesh WxS] \\
        [--multihost [--coordinator HOST:PORT --num-processes N --process-id R]] \\
        [--selfcheck N] [--oracle | --reference] [search flags]
    python -m fandom_search_tpu_torch serve (SCRIPT ... | --index idx/) \\
        [--host 127.0.0.1] [--port 8765] [--no-warm] [search flags]
    python -m fandom_search_tpu_torch matrix matches.csv -o matrix.csv \\
        [--script SCRIPT ...] [--html page.html] [--title TITLE]
    python -m fandom_search_tpu_torch bench [--quick] [--device cuda|cpu]
    python -m fandom_search_tpu_torch --version

``scrape``, ``clean``, ``getmeta`` and ``format`` are host code
(``scrape/``, ``data/script_parser.py``), as is ``search --reference``
(the sklearn BallTree + Levenshtein pipeline,
``search/reference_pipeline.py``), which touches no device.
``index`` writes the script index once (``search/persist.py``; ``--lsh``
adds the prefilter's codes, ``--bucketed`` the bucketed tables);
``search --index`` and ``serve --index`` load it, and search flags given
then overlay its stored config, as in the JAX package.  ``--lsh`` swaps
the exact candidate stage for the LSH prefilter (K6 Hamming top-R, then
an exact rerank) inside the engine's device step, ``--bucketed`` for the
bucketed prefilter (``ops/bucketed.py``: bucket probes, exact dots of
the pairs found, K2 for queries that probe an over-cap bucket);
``--sw-variant`` picks the Smith-Waterman kernel: fast, r2 and dyn run
K5, wide, exitw and slide run K4 (the same scores).
``--stream-compress`` uploads the exact path's batches as u16 vocab ids
plus patches, decoded on the device (``search/vocab_stream.py``).
``--shards N`` / ``--mesh WxS`` run the search on a works x script grid
of CUDA devices (``parallel/sharded.py``; with ``--device cpu``, the CPU
named W * S times).  ``--multihost`` first joins a world of processes
over ``torch.distributed`` (NCCL on cuda, gloo on cpu;
``parallel/mesh.py``): the grid then spans every rank's devices, every
rank runs the same command on the same inputs, and every rank writes the
same rows to its own ``-o``.  ``serve`` refuses ``--multihost``.
``--profile DIR`` writes a ``torch.profiler`` Chrome trace of the search.
``bench`` runs the port's benchmark (``bench.py``) in this process: one
JSON line on stdout, its details in ``torch_bench_details.json``.
``--device`` defaults to ``cuda`` and fails when CUDA is missing;
``--device cpu`` is the explicit way to run the kernels' plain PyTorch
versions.  ``search`` prints one JSON manifest line, like the JAX
package's CLI.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import json
import logging
import sys
import time
from pathlib import Path


def _add_search_flags(p: argparse.ArgumentParser) -> None:
    # Defaults are None so a persisted-index config (`search --index`)
    # can tell "user asked for this" from "flag left alone": only
    # explicitly passed flags overlay the stored config.
    p.add_argument("--k", type=int, default=None,
                   help="top-k per query shingle (default 10)")
    p.add_argument("--shingle-n", type=int, default=None,
                   help="words per shingle (default 6; index-bound)")
    p.add_argument("--shingle-dim", type=int, default=None,
                   help="embedding lanes per shingle (default 128; "
                        "index-bound; a multiple of 128).  256 halves the "
                        "overlap estimator's noise sd, for recall-critical "
                        "deployments")
    p.add_argument("--candidate-threshold", type=float, default=None,
                   help="min estimated matching words (of n) to keep a "
                        "candidate (default 3.5)")
    p.add_argument("--verify-threshold", type=float, default=None,
                   help="min normalized alignment score to keep a hit "
                        "(default 0.35)")
    p.add_argument("--chain-gap", type=int, default=None,
                   help="max token gap when chaining hits (default 12)")
    p.add_argument("--batch-queries", type=int, default=None,
                   help="query shingles per device step (default 1048576)")
    p.add_argument("--lookahead-batches", type=int, default=None,
                   help="batches in flight ahead of result consumption "
                        "(default 1)")
    p.add_argument("--stream-compress", action="store_true", default=None,
                   help="u16 vocab-id compression of the exact path's "
                        "query-stream upload, decoded on the device "
                        "(lossless; about half the upload bytes)")
    p.add_argument("--shards", type=int, default=None,
                   help="shard the corpus across N devices (data parallel; "
                        "shorthand for --mesh Nx1)")
    p.add_argument("--mesh", default=None, metavar="WxS",
                   help="device mesh: W works-shards x S script-shards "
                        "(e.g. 4x2)")
    p.add_argument("--sw-variant", default=None, dest="sw_variant",
                   choices=("fast", "r2", "dyn", "wide", "exitw", "slide"),
                   help="Smith-Waterman variant (default wide): fast, r2 "
                        "and dyn run the warp-per-pair kernel K5, wide, "
                        "exitw and slide the thread-per-pair kernel K4; "
                        "all give the same scores")
    p.add_argument("--lsh", action="store_true",
                   help="use the LSH prefilter for candidate generation")
    p.add_argument("--bucketed", action="store_true",
                   help="use the sub-linear bucketed inverted-index "
                        "prefilter (for very large script indexes, e.g. "
                        "whole-season search); queries hitting overflowed "
                        "(stopword-pair) buckets reroute through the exact "
                        "kernel automatically")
    p.add_argument("--bucketed-pairs", choices=("triangles", "all"),
                   default=None,
                   help="probe set: 'triangles' (6 probes, >=3-match "
                        "guarantee) or 'all' (15 probes, >=2-match "
                        "guarantee for recall-critical huge indexes)")
    p.add_argument("--oracle", action="store_true",
                   help="run the NumPy reference pipeline instead of the "
                        "engine")
    p.add_argument("--reference", action="store_true",
                   help="run the reference-style CPU pipeline "
                        "(sklearn BallTree + Levenshtein ratio)")
    p.add_argument("--multihost", action="store_true",
                   help="join a multi-process world (torch.distributed: "
                        "NCCL on cuda, gloo on cpu) before building the "
                        "mesh; without --coordinator the rendezvous comes "
                        "from the standard env vars (MASTER_ADDR, "
                        "MASTER_PORT, WORLD_SIZE, RANK)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host coordinator address (with --multihost)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host process count (with --multihost)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (with --multihost)")
    p.add_argument("--selfcheck", type=int, default=0, metavar="N",
                   help="re-run N sample works through the NumPy oracle "
                        "and report row agreement in the manifest")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without CUDA) or cpu (the "
                        "kernels' plain PyTorch versions)")


def _device(args):
    """The resolved --device; exit 2 with the reason when it is missing."""
    from fandom_search_tpu_torch.search.engine import resolve_device

    try:
        return resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from e


def _maybe_multihost(args) -> None:
    """Join the multi-process world if asked (index, search): before the
    first device use, since a CUDA rank's current device is set there.
    After it the default mesh is the world's global device list
    (parallel/mesh.py); main() leaves the world at exit."""
    if not getattr(args, "multihost", False):
        return
    from fandom_search_tpu_torch.parallel.mesh import initialize_multihost

    try:
        n = initialize_multihost(args.coordinator, args.num_processes,
                                 args.process_id, device=args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from e
    print(f"multihost: joined cluster, {n} global devices", file=sys.stderr)


def _mesh_from_args(args):
    """The MeshConfig of --mesh WxS or --shards N, else None."""
    from fandom_search_tpu_torch.config import MeshConfig

    mesh = getattr(args, "mesh", None)
    if mesh is not None:
        try:
            w, s = (int(x) for x in mesh.lower().split("x"))
        except ValueError:
            raise SystemExit(f"error: --mesh must look like WxS, got {mesh!r}")
        return MeshConfig(works=w, script=s)
    shards = getattr(args, "shards", None)
    if shards is not None:
        return MeshConfig(works=shards)
    return None


def _runtime_overrides(args) -> dict:
    """Runtime-only SearchConfig fields the user explicitly set."""
    out = {}
    for field in ("k", "candidate_threshold", "verify_threshold", "chain_gap",
                  "batch_queries", "lookahead_batches", "stream_compress",
                  "sw_variant"):
        v = getattr(args, field, None)
        if v is not None:
            out[field] = v
    return out


def _pipeline_config(args):
    from fandom_search_tpu_torch.config import (
        BucketedConfig, MeshConfig, PipelineConfig, SearchConfig, ShingleConfig,
    )

    sh_kw = {}
    if args.shingle_n is not None:
        sh_kw["n"] = args.shingle_n
    if getattr(args, "shingle_dim", None) is not None:
        sh_kw["dim"] = args.shingle_dim
    shingle = ShingleConfig(**sh_kw)
    pairs = getattr(args, "bucketed_pairs", None)
    bucketed = BucketedConfig() if pairs is None else BucketedConfig(pairs=pairs)
    return PipelineConfig(
        shingle=shingle,
        search=dataclasses.replace(SearchConfig(), **_runtime_overrides(args)),
        bucketed=bucketed,
        mesh=_mesh_from_args(args) or MeshConfig(),
    )


def _overlay_runtime(cfg, args):
    """Overlay explicit runtime flags onto a persisted-index config.

    The shingle width and embedding dim are baked into the stored
    embeddings and cannot be overridden; warn if the user tries.
    """
    if args.shingle_n is not None and args.shingle_n != cfg.shingle.n:
        print(
            f"warning: --shingle-n {args.shingle_n} ignored; the loaded "
            f"index was built with n={cfg.shingle.n}",
            file=sys.stderr,
        )
    if (getattr(args, "shingle_dim", None) is not None
            and args.shingle_dim != cfg.shingle.dim):
        print(
            f"warning: --shingle-dim {args.shingle_dim} ignored; the "
            f"loaded index was built with dim={cfg.shingle.dim}",
            file=sys.stderr,
        )
    over = _runtime_overrides(args)
    if over:
        cfg = dataclasses.replace(
            cfg, search=dataclasses.replace(cfg.search, **over)
        )
    mesh = _mesh_from_args(args)
    if mesh is not None:
        cfg = dataclasses.replace(cfg, mesh=mesh)
    pairs = getattr(args, "bucketed_pairs", None)
    if pairs is not None:
        cfg = dataclasses.replace(
            cfg, bucketed=dataclasses.replace(cfg.bucketed, pairs=pairs)
        )
    return cfg


def _parse_script_lines(paths):
    """Parse one or many script files into one line list.

    Multi-script: line numbers are renumbered globally and each line
    labeled with its file's stem — the same order and labels
    ``concat_indexes`` produces, so `matrix --script a.txt b.txt` agrees
    with a multi-script search's line_no space.
    """
    from fandom_search_tpu_torch.data.script_parser import parse_script

    paths = list(paths)
    if len(paths) == 1:
        return parse_script(Path(paths[0]).read_text(encoding="utf-8"))
    names = [Path(p).stem for p in paths]
    if len(set(names)) != len(names):
        raise SystemExit(f"error: duplicate script names: {names}")
    lines, off = [], 0
    for p, name in zip(paths, names):
        part = parse_script(Path(p).read_text(encoding="utf-8"))
        lines.extend(
            dataclasses.replace(ln, line_no=off + ln.line_no, script=name)
            for ln in part
        )
        off += len(part)
    return lines


def _build_index_from_scripts(paths, cfg):
    """(lines, index) for one script file or a multi-script set."""
    from fandom_search_tpu_torch.data.script_parser import parse_script
    from fandom_search_tpu_torch.search.index import (
        build_script_index, concat_indexes,
    )

    if len(paths) == 1:
        lines = parse_script(Path(paths[0]).read_text(encoding="utf-8"))
        return lines, build_script_index(lines, cfg.shingle, cfg.search)
    names = [Path(p).stem for p in paths]
    if len(set(names)) != len(names):
        raise SystemExit(f"error: duplicate script names: {names}")
    parts = []
    for p, name in zip(paths, names):
        part_lines = parse_script(Path(p).read_text(encoding="utf-8"))
        parts.append(
            (name, build_script_index(part_lines, cfg.shingle, cfg.search))
        )
    index = concat_indexes(parts)
    return index.lines, index


def _load_or_build(args):
    """(cfg, lines, index) from --index or the script files."""
    if args.index:
        from fandom_search_tpu_torch.search.persist import load_index

        index, cfg = load_index(Path(args.index))
        return _overlay_runtime(cfg, args), index.lines, index
    if not args.script:
        print("error: provide script file(s) or --index", file=sys.stderr)
        raise SystemExit(2)
    cfg = _pipeline_config(args)
    lines, index = _build_index_from_scripts(args.script, cfg)
    return cfg, lines, index


def cmd_scrape(args) -> int:
    from fandom_search_tpu_torch.scrape.ao3 import ScrapeConfig, scrape_tag

    cfg = ScrapeConfig(
        tag=args.tag,
        out_dir=Path(args.out),
        start_page=args.start_page,
        end_page=args.end_page,
        delay_seconds=args.delay,
    )
    n = 0
    for path in scrape_tag(cfg):
        n += 1
        print(path)
    print(f"downloaded {n} works", file=sys.stderr)
    return 0


def cmd_clean(args) -> int:
    from fandom_search_tpu_torch.scrape.clean import clean_corpus

    kept = clean_corpus(Path(args.src), Path(args.out))
    print(f"kept {len(kept)} works", file=sys.stderr)
    return 0


def cmd_getmeta(args) -> int:
    from fandom_search_tpu_torch.scrape.clean import write_metadata_csv

    n = write_metadata_csv(Path(args.src), Path(args.out))
    print(f"wrote metadata for {n} works", file=sys.stderr)
    return 0


def cmd_format(args) -> int:
    from fandom_search_tpu_torch.data.script_parser import parse_script

    lines = parse_script(Path(args.script).read_text(encoding="utf-8"))
    with open(args.out, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["line_no", "speaker", "text"])
        for ln in lines:
            w.writerow([ln.line_no, ln.speaker, ln.text])
    print(f"parsed {len(lines)} script lines", file=sys.stderr)
    return 0


def cmd_index(args) -> int:
    """Build and persist the script index (decoupled from query)."""
    from fandom_search_tpu_torch.search.persist import save_index

    _maybe_multihost(args)
    cfg = _pipeline_config(args)
    lines, index = _build_index_from_scripts(args.script, cfg)
    save_index(index, cfg, Path(args.out))
    if args.lsh:
        from fandom_search_tpu_torch.ops.lsh import LSHIndex
        from fandom_search_tpu_torch.search.persist import save_lsh

        lsh = LSHIndex.build(
            index.embeddings, cfg.lsh, cfg.shingle,
            pad_multiple=cfg.search.script_pad_multiple, device=_device(args),
        )
        save_lsh(Path(args.out), lsh, cfg.lsh)
        print(f"saved LSH codes ({cfg.lsh.bits} bits)", file=sys.stderr)
    if args.bucketed:
        from fandom_search_tpu_torch.ops.bucketed import BucketedIndex
        from fandom_search_tpu_torch.search.persist import save_bucketed

        bidx = BucketedIndex.build(
            index.shingle_windows, cfg.bucketed, cfg.shingle, device=_device(args),
        )
        save_bucketed(Path(args.out), bidx, cfg.bucketed)
        print(
            f"saved bucketed tables ({bidx.num_buckets} buckets, "
            f"overflow {bidx.overflow_frac:.5f})", file=sys.stderr,
        )
    print(f"indexed {len(lines)} lines -> {index.num_shingles} shingles "
          f"at {args.out}", file=sys.stderr)
    return 0


def _build_engine(args, cfg, index, device):
    """The engine on ``device`` (a ``ShardedSearchEngine`` over the
    mesh's devices when it has more than one) with the flags' prefilter
    attached."""
    if args.lsh and args.bucketed:
        raise SystemExit("error: --lsh and --bucketed are exclusive")
    if cfg.mesh.num_devices > 1:
        from fandom_search_tpu_torch.parallel.sharded import ShardedSearchEngine

        eng = ShardedSearchEngine(index, cfg, device=device)
    else:
        from fandom_search_tpu_torch.search.engine import SearchEngine

        eng = SearchEngine(index, cfg, device=device)
    if args.lsh:
        from fandom_search_tpu_torch.ops.lsh import attach_lsh_prefilter

        prebuilt = None
        if args.index:
            from fandom_search_tpu_torch.search.persist import load_lsh

            prebuilt = load_lsh(Path(args.index), cfg.lsh)
        attach_lsh_prefilter(eng, cfg.lsh, lsh=prebuilt)
    if args.bucketed:
        from fandom_search_tpu_torch.ops.bucketed import attach_bucketed_prefilter

        prebuilt_b = None
        if args.index:
            from fandom_search_tpu_torch.search.persist import load_bucketed

            prebuilt_b = load_bucketed(Path(args.index), cfg.bucketed)
        attach_bucketed_prefilter(eng, cfg.bucketed, bidx=prebuilt_b)
    return eng


def _run_search(args, cfg, lines, index, works, device):
    """One search run; returns (rows, stats_dict)."""
    if args.reference:
        from fandom_search_tpu_torch.search.reference_pipeline import ReferenceSearch

        rows, stats = ReferenceSearch(lines, cfg).search_works(works)
        return rows, dataclasses.asdict(stats)
    if args.oracle:
        from fandom_search_tpu_torch.search.oracle import search_works_oracle

        rows, stats = search_works_oracle(works, index, cfg)
        return rows, dataclasses.asdict(stats)
    eng = _build_engine(args, cfg, index, device)
    if args.resume_dir:
        from fandom_search_tpu_torch.search.runner import ResumableRunner

        runner = ResumableRunner(eng, Path(args.resume_dir))
        rows = runner.run(works)
        return rows, runner.stats_summary()
    rows, stats = eng.search_works(works)
    return rows, dataclasses.asdict(stats)


def cmd_search(args) -> int:
    from fandom_search_tpu_torch.scrape.clean import load_works_dir
    from fandom_search_tpu_torch.search.report import (
        write_matches_csv, write_matches_parquet,
    )

    _maybe_multihost(args)
    # the oracle and the reference pipeline run on the host
    device = None if (args.oracle or args.reference) else _device(args)
    t0 = time.perf_counter()
    cfg, lines, index = _load_or_build(args)
    t_index = time.perf_counter() - t0
    works = load_works_dir(Path(args.fanworks))
    t_prep = time.perf_counter() - t0

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from fandom_search_tpu_torch.utils.profiling import device_trace

        profile_ctx = device_trace(args.profile, device or "cpu")
    t0 = time.perf_counter()
    with profile_ctx:
        rows, stats_d = _run_search(args, cfg, lines, index, works, device)
    t_search = time.perf_counter() - t0

    out = Path(args.out)
    if args.parquet:
        write_matches_parquet(rows, out)
    else:
        write_matches_csv(rows, out)
    manifest = {
        "device": str(device or "cpu"),
        "works": len(works),
        "script_lines": len(lines),
        "script_shingles": index.num_shingles,
        "matches": len(rows),
        "seconds_index": round(t_index, 3),
        "seconds_prep": round(t_prep, 3),
        "seconds_search": round(t_search, 3),
        "stats": stats_d,
    }
    qs = stats_d.get("num_query_shingles", 0) or stats_d.get("query_shingles", 0)
    # resumed runs count every unit's shingles, so their rate divides by
    # the units' own compute seconds, not this invocation's wall time
    rate_seconds = stats_d.get("seconds") if stats_d.get("resumable") else t_search
    if qs and rate_seconds:
        manifest["shingle_pairs_per_sec"] = round(qs * index.num_shingles / rate_seconds)
    # (--reference verifies with its own method: its rows are not the
    # oracle's by design)
    if args.selfcheck and not (args.oracle or args.reference):
        from fandom_search_tpu_torch.search.oracle import search_works_oracle

        sample_ids = sorted(works)[: args.selfcheck]
        sample = {w: works[w] for w in sample_ids}
        orows, _ = search_works_oracle(sample, index, cfg)
        key = lambda r: (r.work_id, r.fan_token_start, r.line_no)  # noqa: E731
        got = {key(r) for r in rows if r.work_id in sample}
        want = {key(r) for r in orows}
        manifest["selfcheck"] = {
            "works": len(sample),
            "oracle_rows": len(want),
            "agreement": (
                round(len(got & want) / len(want | got), 4)
                if (want or got) else 1.0
            ),
        }
    print(json.dumps(manifest, default=str))
    return 0


def cmd_serve(args) -> int:
    """Persistent search service (search/server.py): load or build the
    index once, keep the engine warm, answer HTTP/JSON queries."""
    if args.oracle or args.reference:
        print("error: serve runs the engine (no --oracle/--reference)", file=sys.stderr)
        return 2
    if args.multihost:
        # The JAX package's serve --multihost has every rank bind the same
        # port: the second fails ("Address already in use"), and a /search
        # on the first waits forever in a collective no other rank enters.
        print("error: serve does not run --multihost: every rank would bind "
              "the same port, and a request to one rank would wait in a "
              "collective that no other rank enters", file=sys.stderr)
        return 2
    from fandom_search_tpu_torch.search.server import SearchService, make_server

    device = _device(args)
    cfg, lines, index = _load_or_build(args)
    service = SearchService(_build_engine(args, cfg, index, device), index, cfg)
    if not args.no_warm:
        dt = service.warm()
        print(f"warmup search: {dt:.1f}s", file=sys.stderr)
    srv = make_server(service, args.host, args.port)
    print(
        f"serving {len(lines)} script lines ({index.num_shingles} shingles) "
        f"on http://{args.host}:{srv.server_address[1]} "
        f"(GET /health, GET /stats, POST /search)", file=sys.stderr,
    )
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        print("shutting down", file=sys.stderr)
    finally:
        srv.server_close()
    return 0


def cmd_matrix(args) -> int:
    from fandom_search_tpu_torch.search.report import (
        aggregate_matrix, read_matches_csv, write_matrix_csv,
    )

    rows = read_matches_csv(Path(args.matches))
    lines = _parse_script_lines(args.script) if args.script else None
    records = aggregate_matrix(rows, lines)
    write_matrix_csv(records, Path(args.out))
    if args.html:
        from fandom_search_tpu_torch.search.heatmap import write_engagement_html

        write_engagement_html(records, Path(args.html), title=args.title)
    print(f"aggregated {len(rows)} matches over {len(records)} lines"
          + (f"; heatmap -> {args.html}" if args.html else ""),
          file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    from fandom_search_tpu_torch.bench import main as bench_main

    return bench_main((["--quick"] if args.quick else []) + ["--device", args.device])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fandom_search_tpu_torch",
        description="Quote search, PyTorch/CUDA port (scrape, clean, getmeta, "
                    "format, index, search, serve, matrix, bench).",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--version", action="version", version=_version())
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("scrape", help="download an AO3 tag's works")
    sp.add_argument("tag")
    sp.add_argument("-o", "--out", required=True)
    sp.add_argument("--start-page", type=int, default=1)
    sp.add_argument("--end-page", type=int, default=None)
    sp.add_argument("--delay", type=float, default=5.0)
    sp.set_defaults(fn=cmd_scrape)

    cp = sub.add_parser("clean", help="extract story text from scraped HTML")
    cp.add_argument("src")
    cp.add_argument("-o", "--out", required=True)
    cp.set_defaults(fn=cmd_clean)

    mp = sub.add_parser("getmeta", help="extract work metadata CSV")
    mp.add_argument("src")
    mp.add_argument("-o", "--out", required=True)
    mp.set_defaults(fn=cmd_getmeta)

    fp = sub.add_parser("format", help="parse a script into line records")
    fp.add_argument("script")
    fp.add_argument("-o", "--out", required=True)
    fp.set_defaults(fn=cmd_format)

    ip = sub.add_parser("index", help="build + persist the script index")
    ip.add_argument("script", nargs="+",
                    help="script file(s); several build one multi-script "
                         "index with per-script match attribution")
    ip.add_argument("-o", "--out", required=True)
    _add_search_flags(ip)
    ip.set_defaults(fn=cmd_index)

    qp = sub.add_parser("search", help="search the corpus for script quotes")
    qp.add_argument("fanworks", help="dir of cleaned .txt (or .html) works")
    qp.add_argument("script", nargs="*", default=None,
                    help="source script file(s); several search one "
                         "multi-script index in one corpus pass (or use "
                         "--index)")
    qp.add_argument("-o", "--out", required=True)
    qp.add_argument("--parquet", action="store_true")
    qp.add_argument("--index", default=None,
                    help="persisted index dir (from `index`)")
    qp.add_argument("--resume-dir", default=None,
                    help="work-unit dir for resumable runs")
    qp.add_argument("--profile", default=None,
                    help="write a torch.profiler Chrome trace to this dir")
    _add_search_flags(qp)
    qp.set_defaults(fn=cmd_search)

    vp = sub.add_parser(
        "serve", help="persistent search service (resident index, warm engine)",
    )
    vp.add_argument("script", nargs="*", default=None,
                    help="source script file(s) (or use --index)")
    vp.add_argument("--index", default=None,
                    help="persisted index dir (from `index`)")
    vp.add_argument("--host", default="127.0.0.1",
                    help="bind address (default 127.0.0.1)")
    vp.add_argument("--port", type=int, default=8765)
    vp.add_argument("--no-warm", action="store_true",
                    help="skip the warmup search (the first request then "
                         "builds and loads the kernels)")
    _add_search_flags(vp)
    vp.set_defaults(fn=cmd_serve)

    xp = sub.add_parser("matrix", help="per-line engagement aggregation")
    xp.add_argument("matches", help="matches CSV from `search`")
    xp.add_argument("-o", "--out", required=True)
    xp.add_argument("--script", nargs="+", default=None,
                    help="script file(s) for line text/speaker columns "
                         "(same order as the search)")
    xp.add_argument("--html", default=None, metavar="PATH",
                    help="also write a self-contained engagement heatmap "
                         "(the Fan Engagement Meter view)")
    xp.add_argument("--title", default="Fan engagement",
                    help="heatmap page title")
    xp.set_defaults(fn=cmd_matrix)

    bp = sub.add_parser("bench", help="run the standard benchmark")
    bp.add_argument("--quick", action="store_true",
                    help="kernel-only regression check vs bench_expected.json")
    bp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; fails without CUDA) or cpu, which "
                         "runs the kernels' plain versions")
    bp.set_defaults(fn=cmd_bench)
    return p


def _version() -> str:
    """The installed distribution's version, else pyproject.toml's with
    "(source checkout)", as the JAX package's CLI prints it."""
    try:
        from importlib.metadata import version

        return version("fandom-search-tpu")
    except Exception:  # noqa: BLE001 — uninstalled checkout
        try:
            import tomllib

            pyproject = Path(__file__).resolve().parent.parent / "pyproject.toml"
            with open(pyproject, "rb") as f:
                v = tomllib.load(f)["project"]["version"]
            return f"{v} (source checkout)"
        except Exception:  # noqa: BLE001
            return "unknown (source checkout)"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s",
    )
    try:
        return args.fn(args)
    finally:
        if getattr(args, "multihost", False):
            from fandom_search_tpu_torch.parallel.mesh import shutdown_multihost

            shutdown_multihost()


if __name__ == "__main__":
    sys.exit(main())
