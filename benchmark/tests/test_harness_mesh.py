"""A cell whose configuration lays a works x script mesh: the harness
builds ``ShardedSearchEngine`` as ``search --mesh`` does, counts each K2
block's rows, spans the exchange and merge, and reduces every card of
the trace.  On the CPU the grid is the CPU named once a cell."""

import contextlib
import json

import pytest
import torch

from benchmark.harness import cells, runner, system, world
from benchmark.harness import trace as tr
from benchmark.harness.roofline import k2_bound_s
from conftest import ROOT, TINY_CELL, add_tiny_cell

SPANS = ("batchgen_share.sweep", "pull_wait_share.sweep", "host_post_share.sweep")


@pytest.fixture
def mesh_bench(tmp_path):
    return add_tiny_cell(tmp_path, mesh=(2, 2))


def _checks(result):
    return {k: v["value"] for k, v in result["checks"].items()}


def test_mesh_cell_runs_the_sharded_engine_and_is_correct(mesh_bench):
    cell = cells.load_cell(TINY_CELL, mesh_bench)
    assert cell.chips == 4
    vocab, script, _ = world.make_script_world(3, cell.config["script"])
    engine = system.build_engine(script.text, cell.config, "cpu", {})
    assert type(engine).__name__ == "ShardedSearchEngine"
    assert engine.mesh.shape == {"works": 2, "script": 2}
    assert system.engine_devices(engine) == [torch.device("cpu")]
    r = runner.run(TINY_CELL, 2**31 + 41, 0.1, False, device="cpu", bench_json=mesh_bench)
    assert r["correct"] and _checks(r) == {"rows_missing": 0, "rows_extra": 0}


def test_traced_mesh_run_reads_every_program_span_metric(mesh_bench):
    spec = json.loads(mesh_bench.read_text())
    listed = {m["name"] for m in spec["per_layer"] if TINY_CELL in m["workloads"]}
    spans = {m["name"] for m in spec["per_layer"]
             if TINY_CELL in m["workloads"] and m["source"] == "program_span"}
    assert spans == set(SPANS)
    assert {"mesh_straggler.sweep", "mesh_merge_share.sweep", "k2_roofline.sweep"} <= listed
    r = runner.run(TINY_CELL, 2**31 + 43, 0.1, True, device="cpu", bench_json=mesh_bench)
    assert r["correct"]
    # the CPU has no device trace: the device metrics read nothing
    assert set(r["metrics"]) == spans


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_block_bounds_add_up_to_the_one_card_bound(tmp_path, monkeypatch, mesh):
    """Each K2 block needs its works slice's work shingles against its
    shard's valid rows (none past the script's end: 1 x 4 leaves two
    shards empty), so a batch's block bounds add up to its bound on one
    card against the whole script."""
    names = []

    @contextlib.contextmanager
    def recorded(name):
        names.append(name)
        yield

    monkeypatch.setattr(tr, "record_function", recorded)
    cell = cells.load_cell(TINY_CELL, add_tiny_cell(tmp_path, mesh=mesh))
    vocab, script, ranks = world.make_script_world(29, cell.config["script"])
    pool = world.make_pool(29, vocab, script, ranks, cell.traffic)
    one_card = dict(cell.config, pipeline={k: v for k, v in cell.config["pipeline"].items()
                                           if k != "mesh"})

    def first_batch(config, blocks):
        names.clear()
        with tr.Spans() as spans:
            engine = system.build_engine(script.text, config, "cpu", {})
            _, st = engine.search_works(world.call_works(pool, 1))
            rows, _ = spans.counts()
        shapes = [n.split("|")[1:] for n in names if n.startswith("bench.k2|")]
        assert len(shapes) == len(rows) and st.num_batches >= 1
        calls = [(rows[int(i)], int(ns), int(d), int(k)) for i, ns, d, k in shapes[:blocks]]
        return calls, engine

    single, _ = first_batch(one_card, 1)
    blocks, engine = first_batch(cell.config, mesh[0] * mesh[1])
    assert [ns for _, ns, _, _ in blocks] == engine._ns_valid_shards * mesh[0]
    assert sum(nq * ns for nq, ns, _, _ in blocks) == single[0][0] * single[0][1] > 0
    assert (sum(k2_bound_s(*c) for c in blocks)
            == pytest.approx(k2_bound_s(*single[0]), rel=1e-12))


def test_spans_restore_the_sharded_functions():
    from fandom_search_tpu_torch.parallel import sharded

    names = ("sharded_topk", "topk_dot", "sw_normalized", "merge_topk", "gather")
    before = {n: getattr(sharded, n) for n in names}
    with tr.Spans():
        assert all(getattr(sharded, n) is not before[n] for n in names)
    assert {n: getattr(sharded, n) for n in names} == before


def test_mesh_that_is_not_the_cells_chips_is_refused(mesh_bench):
    spec = json.loads(mesh_bench.read_text())
    next(w for w in spec["workloads"] if w["name"] == TINY_CELL)["chips"] = 1
    mesh_bench.write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="lays its mesh over 4 card"):
        cells.load_cell(TINY_CELL, mesh_bench)


def test_exchange_left_out_is_not_correct(mesh_bench, monkeypatch):
    """The blocks' lists and verify tiles of every cell but the stream's
    own never reach the stream's card: zeros arrive in their place."""
    from fandom_search_tpu_torch.parallel import sharded

    gather = sharded.gather

    def stream_cell_only(mesh, cells_, parts, spec, out):
        got = gather(mesh, cells_, parts, spec, out)
        return [g if c == (0, 0) else tuple(torch.zeros_like(t) for t in g)
                for c, g in zip(cells_, got)]

    monkeypatch.setattr(sharded, "gather", stream_cell_only)
    r = runner.run(TINY_CELL, 11, 0.1, False, device="cpu", bench_json=mesh_bench)
    assert not r["correct"] and _checks(r)["rows_missing"] > 0


def test_control_is_not_correct_on_the_mesh_cell(mesh_bench):
    r = runner.control(TINY_CELL, 2**31 + 47, device="cpu", bench_json=mesh_bench)
    assert not r["correct"] and _checks(r)["rows_missing"] > 0


def _write_trace(path):
    ann = "user_annotation"
    events = [
        {"cat": ann, "name": tr.WINDOW_SPAN, "ts": 0, "dur": 1000, "tid": 1},
        {"cat": ann, "name": "bench.gather", "ts": 100, "dur": 50, "tid": 1},
        {"cat": ann, "name": "bench.merge", "ts": 200, "dur": 50, "tid": 1},
        {"cat": ann, "name": "host.pull", "ts": 700, "dur": 290, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 110, "dur": 5, "tid": 1,
         "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 120, "dur": 5, "tid": 1,
         "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 210, "dur": 5, "tid": 1,
         "args": {"correlation": 3}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 400, "dur": 5, "tid": 1,
         "args": {"correlation": 4}},
        # a peer copy enqueued on card 1 that lands on the stream's card 0
        # (the profiler names a peer copy's cards so, with no "device")
        {"cat": "gpu_memcpy", "name": "Memcpy PtoP", "ts": 120, "dur": 30,
         "args": {"fromDevice": 1, "inDevice": 1, "toDevice": 0, "correlation": 1}},
        # a copy between two other cards
        {"cat": "gpu_memcpy", "name": "Memcpy PtoP", "ts": 130, "dur": 40,
         "args": {"fromDevice": 3, "inDevice": 3, "toDevice": 2, "correlation": 2}},
        {"cat": "kernel", "name": "merge", "ts": 220, "dur": 20,
         "args": {"device": 0, "correlation": 3}},
        {"cat": "kernel", "name": "topk_kernel", "ts": 410, "dur": 260,
         "args": {"device": 1, "correlation": 4}},
    ]
    path.write_text(json.dumps({"traceEvents": events}))


def test_trace_reduction_and_mesh_readers(tmp_path):
    path = tmp_path / "trace.json"
    _write_trace(path)
    summary = tr.reduce_trace(path, [0, 1, 2, 3], [], [])
    assert summary.busy_s == pytest.approx({0: 20e-6, 1: 290e-6, 2: 0.0, 3: 40e-6})
    assert summary.exchange_s == pytest.approx(50e-6)
    readers = cells.metric_readers(["mesh_straggler.sweep", "mesh_merge_share.sweep"],
                                   ROOT / "benchmark")
    ctx = runner.Context(cell=None, window_s=summary.window_s, calls=[], trace=summary)
    assert readers["mesh_merge_share.sweep"].read(ctx) == pytest.approx(5.0)
    assert readers["mesh_straggler.sweep"].read(ctx) == pytest.approx(100.0 * (290 / 87.5 - 1))
    one = tr.reduce_trace(path, [1], [], [])
    ctx = runner.Context(cell=None, window_s=one.window_s, calls=[], trace=one)
    assert readers["mesh_straggler.sweep"].read(ctx) is None
    assert readers["mesh_merge_share.sweep"].read(ctx) == pytest.approx(3.0)
