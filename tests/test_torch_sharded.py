"""The port's works x script sharding against the JAX package.

Tolerance: 0.  ``sharded_topk``'s values and indices compare exactly with
JAX ``sharded_topk(use_pallas=False)`` on its 8 virtual CPU devices
(tests/conftest.py) and with the port's single-device ``topk_dot``; the
sharded engine's MatchRows compare field by field (rounded scores
included) with the port's single engine, JAX's ``ShardedSearchEngine``
and JAX's single engine, all with ``use_pallas=False`` on the JAX side.
The port's grids name the CPU once per shard, the counterpart of the
virtual devices.  The worlds are those of tests/test_sharded.py.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fandom_search_tpu import cli as jcli
from fandom_search_tpu.config import BucketedConfig as JBucketedConfig
from fandom_search_tpu.config import LSHConfig as JLSHConfig
from fandom_search_tpu.config import MeshConfig as JMeshConfig
from fandom_search_tpu.config import PipelineConfig
from fandom_search_tpu.data.script_parser import parse_script
from fandom_search_tpu.ops.bucketed import attach_bucketed_prefilter as jattach_bucketed
from fandom_search_tpu.ops.lsh import attach_lsh_prefilter as jattach_lsh
from fandom_search_tpu.parallel.mesh import make_mesh as jmake_mesh
from fandom_search_tpu.parallel.sharded import ShardedSearchEngine as JShardedEngine
from fandom_search_tpu.parallel.sharded import sharded_topk as jsharded_topk
from fandom_search_tpu.search.engine import SearchEngine as JaxEngine
from fandom_search_tpu.search.index import build_script_index
from fandom_search_tpu.utils import jit_cache
from fandom_search_tpu.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)
from fandom_search_tpu_torch import cli
from fandom_search_tpu_torch.config import BucketedConfig, LSHConfig, MeshConfig
from fandom_search_tpu_torch.config import PipelineConfig as PortConfig
from fandom_search_tpu_torch.ops.bucketed import attach_bucketed_prefilter
from fandom_search_tpu_torch.ops.distance_topk import NEG_INF, topk_dot
from fandom_search_tpu_torch.ops.lsh import attach_lsh_prefilter
from fandom_search_tpu_torch.parallel.mesh import (
    AXIS_SCRIPT,
    AXIS_WORKS,
    make_mesh,
    mesh_shape_for,
)
from fandom_search_tpu_torch.parallel.sharded import (
    ShardedSearchEngine,
    merge_topk,
    place_script_shards,
    sharded_topk,
)
from fandom_search_tpu_torch.search.engine import SearchEngine

K, DIM = 10, 128
MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]
CPU8 = ["cpu"] * 8
EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,prefer,want", [
    (1, 1, (1, 1)), (8, 1, (8, 1)), (8, 2, (4, 2)), (8, 4, (2, 4)),
    (6, 4, (2, 3)), (7, 4, (7, 1)), (256, 8, (32, 8)),
])
def test_mesh_shape_for_matches_jax(n, prefer, want):
    from fandom_search_tpu.parallel.mesh import mesh_shape_for as jshape

    assert mesh_shape_for(n, prefer_script=prefer) == jshape(n, prefer_script=prefer) == want


def test_make_mesh_grid_and_refusals(monkeypatch):
    mesh = make_mesh(MeshConfig(works=4, script=2), CPU8)
    assert mesh.shape == {AXIS_WORKS: 4, AXIS_SCRIPT: 2} and mesh.num_devices == 8
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)
    with pytest.raises(ValueError, match="mesh 3x3 needs 9 devices, have 8"):
        make_mesh(MeshConfig(works=3, script=3), CPU8)
    with pytest.raises(ValueError) as jerr:
        jmake_mesh(JMeshConfig(works=3, script=3))
    assert str(jerr.value) == "mesh 3x3 needs 9 devices, have 8"
    # the default grid is the CUDA devices, refused when there are too few
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 0"):
        make_mesh(MeshConfig(works=2))
    with pytest.raises(ValueError):
        mesh_shape_for(0)


def _topk_world(script):
    """tests/test_sharded.py:31's world: 700 script rows in shards of 512
    per script device, with duplicate rows planted across the 512 and
    1024 boundaries and queries equal to them (ties across shards)."""
    rng = np.random.default_rng(42)
    ns_true = 700
    per = -(-ns_true // (script * 512)) * 512
    q = rng.integers(-6, 7, size=(8 * 256, DIM)).astype(np.int8)
    s = np.zeros((per * script, DIM), dtype=np.int8)
    s[:ns_true] = rng.integers(-6, 7, size=(ns_true, DIM)).astype(np.int8)
    s[512] = s[511]
    s[600] = s[100]
    s[513] = s[100]
    q[:64] = s[511]
    q[64:128] = s[100]
    ns_valid = np.clip(ns_true - np.arange(script) * per, 0, per).astype(np.int32)
    return q, s, ns_valid, ns_true


def _sharded_topk(mesh, q, s, ns_valid, **kw):
    """The port's sharded_topk as the engine calls it: q split into works
    slices, the script placed once."""
    q_slices = list(torch.from_numpy(q).chunk(mesh.shape[AXIS_WORKS]))
    shards = place_script_shards(mesh, torch.from_numpy(s))
    return sharded_topk(mesh, q_slices, shards, ns_valid.tolist(), K, **kw)


@pytest.mark.parametrize("works,script", MESHES)
def test_sharded_topk_matches_jax_and_single(works, script):
    q, s, ns_valid, ns_true = _topk_world(script)
    if script > 1:
        assert (ns_valid[1:] < ns_valid[0]).all() and (script < 4 or ns_valid[-1] == 0)
    jv, ji = jsharded_topk(jmake_mesh(JMeshConfig(works=works, script=script)),
                           jnp.asarray(q), jnp.asarray(s), jnp.asarray(ns_valid), K, DIM,
                           use_pallas=False)
    mesh = make_mesh(MeshConfig(works=works, script=script), CPU8)
    v, i = _sharded_topk(mesh, q, s, ns_valid)
    sv, si = topk_dot(torch.from_numpy(q), torch.from_numpy(s[:ns_true]), ns_true, K)
    assert torch.equal(v, sv) and torch.equal(i, si)
    assert np.array_equal(v.numpy(), np.asarray(jv))
    assert np.array_equal(i.numpy(), np.asarray(ji))
    assert (i[:64, 0] == 511).all() and (i[:64, 1] == 512).all()
    assert (i[64:128, :3] == torch.tensor([100, 513, 600], dtype=torch.int32)).all()


@pytest.mark.parametrize("works,script", MESHES)
def test_sharded_topk_gated_matches_single(works, script):
    """With min_keep (the engine's call) every slot equals the single
    device's gated top-k: empties (NEG_INF, 0), also on rows whose only
    kept entries lie in a later shard."""
    q, s, ns_valid, ns_true = _topk_world(script)
    mesh = make_mesh(MeshConfig(works=works, script=script), CPU8)
    for keep in (2.0, 8.0):
        v, i = _sharded_topk(mesh, q, s, ns_valid, min_keep=keep)
        sv, si = topk_dot(torch.from_numpy(q), torch.from_numpy(s[:ns_true]), ns_true, K,
                          min_keep=keep)
        assert torch.equal(v, sv) and torch.equal(i, si)
    # at 8.0 only the planted rows keep entries, fewer than k of them
    assert (v[:128, 0] > NEG_INF).all() and (v[:128, -1] == NEG_INF).all()
    assert (v[128:] == NEG_INF).all() and (i[v == NEG_INF] == 0).all()


def test_merge_topk_orders_negative_scores_and_ties():
    vals = torch.tensor([[-0.5, NEG_INF, 0.25, -0.5, 1.0, NEG_INF]], dtype=torch.float32)
    idx = torch.tensor([[7, 3, 9, 2, 40, 1]], dtype=torch.int32)
    v, i = merge_topk(vals, idx, 6)
    assert v.tolist() == [[1.0, 0.25, -0.5, -0.5, NEG_INF, NEG_INF]]
    assert i.tolist() == [[40, 9, 2, 7, 0, 0]]


@pytest.fixture(scope="module")
def world():
    """tests/test_sharded.py's world, indexed by the JAX package."""
    rng = np.random.default_rng(23)
    vocab = make_vocab(rng, 1200)
    lines = parse_script(make_script(rng, vocab, num_lines=20, words_per_line=(7, 12)))
    works, planted = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=10, words_per_work=250,
        quotes_per_work=2, num_edits=0, vocab=vocab,
    )
    index = build_script_index(lines, PipelineConfig().shingle, PipelineConfig().search)
    return index, works, planted


def _cfgs(works=1, script=1, **kw):
    """(JAX config, port config) on a works x script mesh."""
    j = PipelineConfig(mesh=JMeshConfig(works=works, script=script))
    p = PortConfig(mesh=MeshConfig(works=works, script=script))
    return (dataclasses.replace(j, search=dataclasses.replace(j.search, **kw)),
            dataclasses.replace(p, search=dataclasses.replace(p.search, **kw)))


def _rows(rows):
    return [r.to_csv_row() for r in rows]


@pytest.fixture(scope="module")
def single_rows(world):
    """One device's rows, the port's equal to the JAX engine's."""
    index, works, _ = world
    jcfg, pcfg = _cfgs(batch_queries=2048)
    rows, _ = SearchEngine.from_index(index, pcfg, device="cpu").search_works(works)
    jrows, _ = JaxEngine(index, jcfg, use_pallas=False).search_works(works)
    assert rows and _rows(rows) == _rows(jrows)
    return _rows(rows)


@pytest.mark.parametrize("works_ax,script_ax", [(4, 2), (8, 1), (1, 8)])
def test_sharded_engine_matches_single_and_jax(world, single_rows, works_ax, script_ax):
    index, works, planted = world
    jcfg, pcfg = _cfgs(works_ax, script_ax, batch_queries=works_ax * 512)
    eng = ShardedSearchEngine.from_index(index, pcfg, device="cpu")
    assert eng.mesh.shape == {AXIS_WORKS: works_ax, AXIS_SCRIPT: script_ax}
    rows, stats = eng.search_works(works)
    jrows, jstats = JShardedEngine(index, jcfg, use_pallas=False).search_works(works)
    assert _rows(rows) == _rows(jrows) == single_rows
    assert stats.num_batches == jstats.num_batches and stats.num_verified > 0
    found = {(r.work_id, r.line_no) for r in rows}
    assert all((p.work_id, p.line_no) in found for p in planted)
    if script_ax == 8:
        assert eng._ns_valid_shards[2:] == [0] * 6   # script shards past the end


def test_sharded_batch_granule_alignment(world):
    """Stream buckets stay works-shardable: granule % (works*256) == 0;
    a batch size that does not split is refused as JAX refuses it."""
    index, _, _ = world
    jcfg, pcfg = _cfgs(4, 2, batch_queries=1 << 18)
    eng = ShardedSearchEngine.from_index(index, pcfg, device="cpu")
    assert eng._batch_granule == JShardedEngine(index, jcfg, use_pallas=False)._batch_granule
    assert eng._batch_granule % (4 * 256) == 0
    b = eng._batch_granule
    while b < pcfg.search.batch_queries:
        assert b % (4 * 256) == 0
        b *= 2
    _, bad = _cfgs(4, 2, batch_queries=1536)
    with pytest.raises(ValueError, match=r"divisible by works_shards\*256 \(1024\)"):
        ShardedSearchEngine.from_index(index, bad, device="cpu")


@pytest.mark.parametrize("prefilter", ["lsh", "lsh_fast", "bucketed"])
def test_sharded_engine_with_prefilters(world, single_rows, prefilter):
    """The LSH and bucketed prefilters swap the candidate stage on the
    sharded engine too and reproduce its rows; the verify stays split
    over the works devices (K5 for sw_variant fast)."""
    index, works, _ = world
    kw = dict(batch_queries=2048, sw_variant="fast") if prefilter == "lsh_fast" else dict(
        batch_queries=2048)
    jcfg, pcfg = _cfgs(2, 1, **kw)
    eng = ShardedSearchEngine.from_index(index, pcfg, device="cpu")
    jeng = JShardedEngine(index, jcfg, use_pallas=False)
    if prefilter == "bucketed":
        attach_bucketed_prefilter(eng, BucketedConfig())
        jattach_bucketed(jeng, JBucketedConfig())
    else:
        attach_lsh_prefilter(eng, LSHConfig())
        jattach_lsh(jeng, JLSHConfig())
    calls = []
    sw = eng._sw_fn
    eng._sw_fn = lambda *a: calls.append(a[0].shape[0]) or sw(*a)
    rows, stats = eng.search_works(works)
    jrows, _ = jeng.search_works(works)
    assert _rows(rows) == _rows(jrows) == single_rows and stats.num_verified > 0
    assert calls   # the works-split verify scored every batch


def test_sharded_engine_with_stream_compression(world, single_rows):
    """Compressed uploads decode on the stream's device before the
    sharded step: rows equal the uncompressed sharded engine's and the
    JAX sharded engine's with compression, past the bootstrap batch."""
    index, works, _ = world
    jcfg, pcfg = _cfgs(4, 2, batch_queries=4 * 512, stream_compress=True)
    eng = ShardedSearchEngine.from_index(index, pcfg, device="cpu")
    rows, stats = eng.search_works(works)
    jeng = JShardedEngine(index, jcfg, use_pallas=False)
    jrows, _ = jeng.search_works(works)
    assert stats.num_batches > 1 and eng._venc.ready and eng.table_uploads >= 1
    assert np.array_equal(eng._venc.table(), jeng._venc.table())
    assert _rows(rows) == _rows(jrows) == single_rows


def test_sharded_engine_slide_variant(world):
    """sw_variant "slide" runs K4 on the sharded engine as on one device
    (JAX coerces it to "wide" there); the rows are equal."""
    index, works, _ = world
    jcfg, pcfg = _cfgs(2, 2, batch_queries=2 * 512, sw_variant="slide")
    rows, _ = ShardedSearchEngine.from_index(index, pcfg, device="cpu").search_works(works)
    single, _ = SearchEngine.from_index(index, pcfg, device="cpu").search_works(works)
    jrows, _ = JShardedEngine(index, jcfg, use_pallas=False).search_works(works)
    assert rows and _rows(rows) == _rows(single) == _rows(jrows)


@pytest.mark.parametrize("flags", [["--shards", "2"], ["--mesh", "2x2"]])
def test_cli_shards_and_mesh_match_jax(tmp_path, monkeypatch, flags):
    monkeypatch.setattr(jit_cache, "enable_persistent_cache", lambda *a, **k: None)
    args = ["search", str(EXAMPLES / "fanworks"), str(EXAMPLES / "script.txt"),
            "--batch-queries", "4096", *flags]
    assert jcli.main([*args, "-o", str(tmp_path / "j.csv"), "--cpu", "--no-pallas"]) == 0
    assert cli.main([*args, "-o", str(tmp_path / "p.csv"), "--device", "cpu"]) == 0
    assert cli.main(["search", str(EXAMPLES / "fanworks"), str(EXAMPLES / "script.txt"),
                     "--batch-queries", "4096", "-o", str(tmp_path / "one.csv"),
                     "--device", "cpu"]) == 0
    got = (tmp_path / "p.csv").read_bytes()
    assert got == (tmp_path / "j.csv").read_bytes() == (tmp_path / "one.csv").read_bytes()
    assert got.count(b"\n") > 1


def test_cli_refuses_malformed_mesh_and_missing_devices(tmp_path, capsys, monkeypatch):
    from types import SimpleNamespace

    for bad in ("2by2", "2x2x2", "x"):
        with pytest.raises(SystemExit) as e:
            cli._mesh_from_args(SimpleNamespace(mesh=bad, shards=None))
        with pytest.raises(SystemExit) as je:
            jcli._mesh_from_args(SimpleNamespace(mesh=bad, shards=None))
        assert str(e.value) == str(je.value) == f"error: --mesh must look like WxS, got {bad!r}"
    got = cli._mesh_from_args(SimpleNamespace(mesh=None, shards=3))
    assert (got.works, got.script) == (3, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices, have 1"):
        cli.main(["search", str(EXAMPLES / "fanworks"), str(EXAMPLES / "script.txt"),
                  "-o", str(tmp_path / "x.csv"), "--mesh", "2x2"])
