"""One rank of a gloo world for tests/test_torch_multihost.py.

    python tests/torch_multihost_rank.py SPEC.json RANK

Joins the world that SPEC names (``initialize_multihost`` over
``env://`` on the loopback address, gloo, each rank naming the CPU
``local_devices`` times), runs each of SPEC's jobs on the port's
``ShardedSearchEngine`` over the world's global grid, and writes each
job's rows and counts to ``<out>/<job>.r<RANK>.json``.  Imports nothing
of JAX, so a rank starts in the time torch takes to import.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def sharded_world():
    """tests/test_sharded.py's world: seed 23, 20 lines, 10 works."""
    import numpy as np

    from fandom_search_tpu_torch.data.script_parser import parse_script
    from fandom_search_tpu_torch.utils.synthetic import (
        make_corpus_with_quotes, make_script, make_vocab,
    )

    rng = np.random.default_rng(23)
    vocab = make_vocab(rng, 1200)
    lines = parse_script(make_script(rng, vocab, num_lines=20, words_per_line=(7, 12)))
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=10, words_per_work=250,
        quotes_per_work=2, num_edits=0, vocab=vocab,
    )
    return lines, works


def dryrun_world():
    """``__graft_entry__.py``'s dry-run world (``chip_smoke.dryrun_world``)
    at two works rows: its stopword-led lines overflow the bucketed cap."""
    from chip_smoke import dryrun_world as world

    return world(2)


WORLDS = {"sharded": sharded_world, "dryrun": dryrun_world}


def job_config(job):
    """The port's PipelineConfig of a job: its mesh, works * 512 queries
    a batch, and its search overrides."""
    from fandom_search_tpu_torch.config import MeshConfig, PipelineConfig

    w, s = job["mesh"]
    cfg = PipelineConfig(mesh=MeshConfig(works=w, script=s))
    return dataclasses.replace(cfg, search=dataclasses.replace(
        cfg.search, batch_queries=w * 512, **job.get("search", {})))


def run_job(job, world):
    """Rows and counts of one job on the world's grid."""
    from fandom_search_tpu_torch.config import BucketedConfig, LSHConfig
    from fandom_search_tpu_torch.ops.lsh import attach_lsh_prefilter
    from fandom_search_tpu_torch.parallel.sharded import ShardedSearchEngine
    from fandom_search_tpu_torch.parallel.sharded_bucketed import (
        attach_bucketed_prefilter_sharded,
    )
    from fandom_search_tpu_torch.search.index import build_script_index

    lines, works = world
    cfg = job_config(job)
    index = build_script_index(lines, cfg.shingle, cfg.search)
    eng = ShardedSearchEngine(index, cfg, device="cpu")
    if job["path"] == "lsh":
        attach_lsh_prefilter(eng, LSHConfig())
    elif job["path"] == "hybrid":
        attach_bucketed_prefilter_sharded(eng, BucketedConfig())
        # a budget below a batch's at-risk count makes the engine rerun it
        eng._bucketed_risk_budget = job.get("risk_budget", eng._bucketed_risk_budget)
    rows, stats = eng.search_works(works)
    return dict(rows=[r.to_csv_row() for r in rows], batches=stats.num_batches,
                risk_queries=eng._bucketed_risk_queries,
                risk_budget=eng._bucketed_risk_budget,
                table_uploads=eng.table_uploads,
                owned=[[eng.mesh.local(i, j) for j in range(len(row))]
                       for i, row in enumerate(eng.mesh.devices)])


def main(spec_path: str, rank: int) -> int:
    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec["out"])
    import torch

    torch.set_num_threads(1)
    from fandom_search_tpu_torch.config import MeshConfig
    from fandom_search_tpu_torch.parallel import mesh as M

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(spec["port"]),
                      WORLD_SIZE=str(spec["world"]), RANK=str(rank))
    if spec.get("fake_card"):
        # every rank claims one card: the check must refuse the world
        M._identity = lambda dev: "host/GPU-fake"
        try:
            M.initialize_multihost(device="cpu", timeout_s=spec["timeout_s"])
        except ValueError as e:
            (out / f"refused.r{rank}.json").write_text(json.dumps(
                dict(error=str(e), initialized=torch.distributed.is_initialized())))
            return 0
        return 1
    n = M.initialize_multihost(device="cpu", local_devices=spec["local_devices"],
                               timeout_s=spec["timeout_s"])
    try:
        again = M.initialize_multihost(device="cpu", local_devices=7)
        info = dict(global_devices=n, again=again, rank=M.multihost_world().rank)
        try:
            M.make_mesh(MeshConfig(works=spec["local_devices"]))
        except ValueError as e:
            info["idle_refusal"] = str(e)
        (out / f"world.r{rank}.json").write_text(json.dumps(info))
        worlds = {}
        for job in spec["jobs"]:
            if job["world"] not in worlds:
                worlds[job["world"]] = WORLDS[job["world"]]()
            res = run_job(job, worlds[job["world"]])
            (out / f"{job['name']}.r{rank}.json").write_text(json.dumps(res))
    finally:
        M.shutdown_multihost()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
