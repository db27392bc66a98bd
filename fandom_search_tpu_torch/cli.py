"""``python -m fandom_search_tpu_torch search``; counterpart of fandom_search_tpu/cli.py:474 (cmd_search).

    python -m fandom_search_tpu_torch search WORKS_DIR SCRIPT [SCRIPT ...] \\
        -o matches.csv [--k K] [--candidate-threshold T] \\
        [--verify-threshold V] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and fails when CUDA is missing;
``--device cpu`` is the explicit way to run the kernels' plain PyTorch
versions.  Prints one JSON manifest line, like the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time
from pathlib import Path


def _pipeline_config(args):
    from fandom_search_tpu.config import PipelineConfig, SearchConfig

    over = {}
    if args.k is not None:
        over["k"] = args.k
    if args.candidate_threshold is not None:
        over["candidate_threshold"] = args.candidate_threshold
    if args.verify_threshold is not None:
        over["verify_threshold"] = args.verify_threshold
    return PipelineConfig(search=dataclasses.replace(SearchConfig(), **over))


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


def cmd_search(args) -> int:
    from fandom_search_tpu.scrape.clean import load_works_dir
    from fandom_search_tpu_torch.search.engine import SearchEngine, resolve_device
    from fandom_search_tpu_torch.search.report import write_matches_csv

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from e
    t0 = time.perf_counter()
    cfg = _pipeline_config(args)
    lines, index = _build_index_from_scripts(args.script, cfg)
    works = load_works_dir(Path(args.fanworks))
    t_prep = time.perf_counter() - t0

    t0 = time.perf_counter()
    eng = SearchEngine(index, cfg, device=device)
    rows, stats = eng.search_works(works)
    t_search = time.perf_counter() - t0

    write_matches_csv(rows, Path(args.out))
    manifest = {
        "device": str(device),
        "works": len(works),
        "script_lines": len(lines),
        "script_shingles": index.num_shingles,
        "matches": len(rows),
        "seconds_prep": round(t_prep, 3),
        "seconds_search": round(t_search, 3),
        "stats": dataclasses.asdict(stats),
    }
    if stats.num_query_shingles and t_search:
        manifest["shingle_pairs_per_sec"] = round(
            stats.num_query_shingles * index.num_shingles / t_search
        )
    print(json.dumps(manifest, default=str))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fandom_search_tpu_torch",
        description="Quote search, PyTorch/CUDA port (search verb).",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="cmd", required=True)
    qp = sub.add_parser("search", help="search the corpus for script quotes")
    qp.add_argument("fanworks", help="dir of cleaned .txt (or .html) works")
    qp.add_argument("script", nargs="+",
                    help="source script file(s); several build one index")
    qp.add_argument("-o", "--out", required=True)
    qp.add_argument("--k", type=int, default=None,
                    help="top-k per query shingle (default 10)")
    qp.add_argument("--candidate-threshold", type=float, default=None,
                    help="min estimated matching words (of n) to keep a "
                         "candidate (default 3.5)")
    qp.add_argument("--verify-threshold", type=float, default=None,
                    help="min normalized alignment score to keep a hit "
                         "(default 0.35)")
    qp.add_argument("--device", default="cuda",
                    help="cuda (default; fails without CUDA) or cpu (the "
                         "kernels' plain PyTorch versions)")
    qp.set_defaults(fn=cmd_search)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s",
    )
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
