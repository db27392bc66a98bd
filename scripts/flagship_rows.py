#!/usr/bin/env python3
"""Rows of the bench's flagship world, from the port or from the JAX package.

    python3 scripts/flagship_rows.py --impl port [--count N] \\
        [--prefilter exact|hybrid] [--chunk C] [--out rows.json] \\
        [--dump-world world.json | --world world.json]
    python3 scripts/flagship_rows.py --impl jax ...   (JAX_PLATFORMS=cpu)
    python3 scripts/flagship_rows.py --compare a.json b.json

Builds the world of the bench's ``bucketed_e2e_big`` stage at its
default size (default_rng 23: a script of about 2^20 shingles at zipf
1.01 over 30,000 words, 480 2,000-word works with three one-word-mutated
plants each) with the chosen package's own generators (or loads a world that
``--dump-world`` wrote, so both packages search the same data even
where two machines' numpy draw different worlds; ``draws`` fingerprints
each kind of draw), searches the first ``--count`` works (all by
default; 0: the world only) against the whole script on the chosen
package's engine (the port's on the card), exact or through the bucketed
hybrid (pairs "all"), ``--chunk`` works a search (all at once by
default; a work's rows do not depend on the works searched beside it,
and the JAX engine on the CPU scores a batch's at-risk rows against the
whole script at once, which at 480 works asks for 481 GB), and writes one JSON object: the world's SHA-256
(script text and works, so two packages or two machines can be held to
the same data), the script's shingles, the rows as lists and their
count.  ``--compare`` prints what two such files share and where their
rows differ.  ``--impl jax`` imports the JAX package (its engine with
``use_pallas=False``, on the CPU); ``--impl port`` imports nothing of
it.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


SHINGLES, WORKS = 1 << 20, 480


def world_jax():
    """The JAX bench's stage_bucketed_e2e_big world, built as it builds it."""
    import numpy as np

    from fandom_search_tpu.config import PipelineConfig
    from fandom_search_tpu.data.script_parser import parse_script
    from fandom_search_tpu.search.index import build_script_index
    from fandom_search_tpu.utils.synthetic import (
        make_corpus_with_quotes, make_script, make_vocab,
    )

    cfg = PipelineConfig()
    rng = np.random.default_rng(23)
    vocab = make_vocab(rng, 30000)
    script_text = make_script(rng, vocab, num_lines=max(1, -(-SHINGLES // 12)),
                              words_per_line=(8, 17), zipf_a=1.01)
    lines = parse_script(script_text)
    index = build_script_index(lines, cfg.shingle, cfg.search)
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=WORKS, words_per_work=2000,
        quotes_per_work=3, num_edits=1, vocab=vocab, zipf_a=1.01)
    return cfg, lines, index, works


def world_port():
    from fandom_search_tpu_torch.bench import flagship_world
    from fandom_search_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    lines, index, works, _ = flagship_world(cfg, SHINGLES, WORKS)
    return cfg, lines, index, works


def load_world(impl: str, path: str):
    """A world that ``--dump-world`` wrote, parsed and indexed by ``impl``."""
    pkg = "fandom_search_tpu" if impl == "jax" else "fandom_search_tpu_torch"
    config = __import__(f"{pkg}.config", fromlist=["PipelineConfig"])
    parser = __import__(f"{pkg}.data.script_parser", fromlist=["parse_script"])
    indexer = __import__(f"{pkg}.search.index", fromlist=["build_script_index"])
    world = json.loads(Path(path).read_text())
    cfg = config.PipelineConfig()
    lines = parser.parse_script(world["script"])
    index = indexer.build_script_index(lines, cfg.shingle, cfg.search)
    return cfg, lines, index, world["works"]


def draws() -> dict:
    """numpy's version and a SHA-256 (first 16 hex digits) of each kind of
    draw the world makes from default_rng(23), so two machines can tell
    which draw differs."""
    import numpy as np

    out = {"numpy": np.__version__}
    kinds = {
        "integers": lambda r: r.integers(8, 17, size=1 << 16),
        "zipf_1.01": lambda r: r.zipf(1.01, size=1 << 16),
        "choice_no_replace": lambda r: r.choice(2000, size=64, replace=False),
        "random": lambda r: r.random(1 << 16),
    }
    for name, draw in kinds.items():
        out[name] = hashlib.sha256(np.ascontiguousarray(draw(np.random.default_rng(23)))
                                   .tobytes()).hexdigest()[:16]
    return out


def digest(lines, works) -> str:
    h = hashlib.sha256()
    for ln in lines:
        h.update(f"{ln.line_no}\t{ln.text}\n".encode())
    for wid in sorted(works):
        h.update(f"{wid}\t{works[wid]}\n".encode())
    return h.hexdigest()


def search(impl: str, cfg, index, works, prefilter: str, chunk: int | None):
    bcfg = dataclasses.replace(cfg.bucketed, pairs="all")
    if impl == "jax":
        from fandom_search_tpu.ops.bucketed import attach_bucketed_prefilter
        from fandom_search_tpu.search.engine import SearchEngine

        engine = SearchEngine(index, cfg, use_pallas=False)
    else:
        from fandom_search_tpu_torch.ops.bucketed import attach_bucketed_prefilter
        from fandom_search_tpu_torch.search.engine import SearchEngine

        engine = SearchEngine(index, cfg, device="cuda")
    if prefilter == "hybrid":
        attach_bucketed_prefilter(engine, bcfg)
    ids = sorted(works)
    step = chunk or len(ids)
    rows = []
    for i in range(0, len(ids), step):
        rows += engine.search_works({w: works[w] for w in ids[i: i + step]})[0]
    return rows


def compare(a_path: str, b_path: str) -> int:
    a, b = (json.loads(Path(p).read_text()) for p in (a_path, b_path))
    for key in ("impl", "prefilter", "world_sha256", "script_shingles", "works", "rows_n"):
        print(f"{key}: {a.get(key)} | {b.get(key)}")
    ra, rb = ({tuple(r[:3]) for r in x["rows"]} for x in (a, b))
    fa, fb = ({json.dumps(r) for r in x["rows"]} for x in (a, b))
    print(json.dumps({"same_world": a["world_sha256"] == b["world_sha256"],
                      "same_rows": fa == fb, "span_keys_only_in_a": sorted(ra - rb)[:20],
                      "span_keys_only_in_b": sorted(rb - ra)[:20],
                      "rows_only_in_a": len(fa - fb), "rows_only_in_b": len(fb - fa)}))
    return 0 if fa == fb else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("port", "jax"))
    ap.add_argument("--count", type=int, default=None)
    ap.add_argument("--prefilter", default="exact", choices=("exact", "hybrid"))
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--compare", nargs=2, metavar="ROWS_JSON")
    ap.add_argument("--world", default=None, help="load this world instead of drawing one")
    ap.add_argument("--dump-world", default=None, help="write the drawn world here")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if args.impl is None:
        ap.error("--impl or --compare is required")
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    if args.world:
        cfg, lines, index, works = load_world(args.impl, args.world)
    else:
        cfg, lines, index, works = (world_jax if args.impl == "jax" else world_port)()
    sha = digest(lines, works)
    if args.dump_world:
        Path(args.dump_world).write_text(json.dumps({
            "script": "\n".join(f"{ln.speaker}: {ln.text}" for ln in lines),
            "works": works, "world_sha256": sha}))
    world_s = time.perf_counter() - t0
    ids = sorted(works)[: args.count]
    if not ids:   # --count 0: the world only
        print(json.dumps({"world_sha256": sha, "script_shingles": index.num_shingles,
                          "works": len(works), "draws": draws()}), flush=True)
        return 0
    t0 = time.perf_counter()
    rows = search(args.impl, cfg, index, {w: works[w] for w in ids}, args.prefilter,
                  args.chunk)
    search_s = time.perf_counter() - t0
    out = {"impl": args.impl, "world_file": args.world, "device": "cuda" if args.impl == "port" else "cpu",
           "prefilter": args.prefilter, "chunk": args.chunk, "world_sha256": sha,
           "draws": draws(),
           "script_shingles": index.num_shingles, "works": [ids[0], ids[-1], len(ids)],
           "world_seconds": world_s, "search_seconds": search_s,
           "max_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
           "rows_n": len(rows), "rows": sorted(list(r) for r in rows)}
    text = json.dumps(out)
    if args.out:
        Path(args.out).write_text(text)
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
