"""Times one benchmark call's tokenization on the host, three ways.

Over the works of one ``corpus`` call of a benchmark configuration's world
(``benchmark/harness/world.py``, as a cell makes them):

  * ``chunks``: the scheme the engine used before its ordered stream:
    chunks of 1,024 works, three in flight on two workers, each chunk one
    ``tokenize_many``; seconds to the first work, to the first batch's
    works and to the last work;
  * ``stream``: the engine's ``_work_stream`` (runs of works in sorted
    order, on the caller's thread and ``TOKENIZE_HELPERS`` threads); the
    same three times and its ``tokenize_waits``;
  * ``pool_N``: every work through ``fast_tokenize`` on a pool of N
    threads (1, 4 and 16), the whole call's seconds.

"The first batch's works" are the works up to and including the first
one that does not fit in a batch of ``batch_queries`` tokens beside the
ones before it, when ``_batches`` hands the first batch on.  Nothing runs
on a device: the engine is built over a tiny index with the
configuration's pipeline settings.  Each measurement runs ``--reps``
times, in turns; the texts are the same each time (warm caches).

    python3 scripts/tokenize_stream_timing.py [--config series] [--seed 7] [--reps 5] \
        [--shingles N] [--works N] [--out timing.json]

``--shingles`` and ``--works`` shrink the world for a rehearsal.  Prints
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import world  # noqa: E402
from benchmark.harness.system import pipeline_config  # noqa: E402
from fandom_search_tpu_torch.data.fast_tokenizer import fast_tokenize, get_lib, tokenize_many  # noqa: E402
from fandom_search_tpu_torch.data.script_parser import parse_script  # noqa: E402
from fandom_search_tpu_torch.search.engine import TOKENIZE_HELPERS, EngineStats, SearchEngine  # noqa: E402
from fandom_search_tpu_torch.search.index import build_script_index  # noqa: E402
from fandom_search_tpu_torch.utils.profiling import Tracer  # noqa: E402


def chunk_stream(raw, chunk=1024):
    """The engine's former ``_work_stream`` for raw works alone."""
    ids = sorted(raw)
    spans = [ids[i : i + chunk] for i in range(0, len(ids), chunk)]
    with ThreadPoolExecutor(max_workers=2) as ex:
        pending = deque(ex.submit(tokenize_many, {w: raw[w] for w in sp}) for sp in spans[:3])
        nxt = 3
        while pending:
            done = pending.popleft().result()
            if nxt < len(spans):
                pending.append(ex.submit(tokenize_many, {w: raw[w] for w in spans[nxt]}))
                nxt += 1
            yield from sorted(done.items())


def first_batch_works(raw, batch_queries: int) -> int:
    """How many works of the sorted stream ``_batches`` has taken when it
    hands the first batch on (the first that does not fit included)."""
    total = 0
    for i, w in enumerate(sorted(raw)):
        need = len(fast_tokenize(raw[w]))
        if need == 0:
            continue
        if need > batch_queries or (total + need > batch_queries and total):
            return i + 1
        total += need
    return len(raw)


def timed(stream, first_batch: int) -> dict:
    t0 = time.perf_counter()
    marks = {}
    n = 0
    for n, _ in enumerate(stream, 1):
        if n == 1:
            marks["first_s"] = time.perf_counter() - t0
        if n == first_batch:
            marks["first_batch_s"] = time.perf_counter() - t0
    marks["last_s"] = time.perf_counter() - t0
    marks["works"] = n
    return marks


def pool_seconds(raw, threads: int) -> float:
    keys = sorted(raw)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as ex:
        list(ex.map(lambda k: fast_tokenize(raw[k]), keys))
    return time.perf_counter() - t0


def summary(values):
    return {"min": min(values), "median": statistics.median(values), "max": max(values),
            "runs": values}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="series")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shingles", type=int, default=None)
    ap.add_argument("--works", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    config = json.loads((ROOT / "benchmark" / "configs" / f"{args.config}.json").read_text())
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "corpus.json").read_text())
    traffic["pool_calls"] = 1
    if args.shingles:
        config["script"]["shingles"] = args.shingles
    if args.works:
        traffic["works_per_call"] = args.works
    cfg = pipeline_config(config["pipeline"])
    if get_lib() is None:
        raise SystemExit("the native tokenizer did not load")

    t0 = time.perf_counter()
    vocab, script, ranks = world.make_script_world(args.seed, config["script"])
    raw = world.call_works(world.make_pool(args.seed, vocab, script, ranks, traffic), 0)
    world_s = time.perf_counter() - t0
    tiny = parse_script("\n".join(script.text.splitlines()[:40]))
    engine = SearchEngine(build_script_index(tiny, cfg.shingle, cfg.search), cfg, device="cpu")
    first_batch = first_batch_works(raw, cfg.search.batch_queries)

    runs = {"chunks": [], "stream": []}
    waits = []
    for _ in range(args.reps):
        runs["chunks"].append(timed(chunk_stream(raw), first_batch))
        stats = EngineStats()
        engine._trace = Tracer(stats, "cpu")
        runs["stream"].append(timed(engine._work_stream(dict(raw), {}), first_batch))
        waits.append(stats.extra.get("tokenize_waits", 0.0))
    pools = {f"pool_{t}": summary([pool_seconds(raw, t) for _ in range(args.reps)])
             for t in (1, 4, 16)}

    out = {
        "config": args.config, "seed": args.seed, "reps": args.reps,
        "works": len(raw), "characters": sum(len(t) for t in raw.values()),
        "words": sum(len(fast_tokenize(t)) for t in raw.values()),
        "batch_queries": cfg.search.batch_queries, "first_batch_works": first_batch,
        "helpers": TOKENIZE_HELPERS, "cpu_count": os.cpu_count(),
        "affinity": len(os.sched_getaffinity(0)), "world_s": world_s,
        "stream_tokenize_waits": summary(waits),
        **{f"{k}_{m}": summary([r[m] for r in v])
           for k, v in runs.items() for m in ("first_s", "first_batch_s", "last_s")},
        **pools,
    }
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
