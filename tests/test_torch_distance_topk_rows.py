"""K7 (merge="rows") in the port's topk_dot against the JAX rows kernel.

Tolerance: 0.  Scores are integers divided by a power-of-two dim in f32
and indices are integers.  The JAX rows kernel keeps only entries at or
above ``min_keep`` (its kill loop inserts nothing below it), so the
port's plain version equals the interpreted Pallas kernel in every slot,
padding included (np.array_equal on the whole [NQ, k] outputs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fandom_search_tpu.config import ShingleConfig
from fandom_search_tpu.data.shingler import embed_shingles_np
from fandom_search_tpu.ops.distance_topk import pad_rows, topk_dot_jnp, topk_dot_pallas
from fandom_search_tpu_torch.ops import _cuda
from fandom_search_tpu_torch.ops import distance_topk as dt
from fandom_search_tpu_torch.utils import topk_cases as tc

K, DIM = 10, 128
NQ, NS = 512, 4096
SCFG = ShingleConfig()


@pytest.fixture(scope="module")
def script():
    """The script side of tests/test_distance_topk.py's rows world: a
    4096-shingle stream with a repeated region (tied scores)."""
    rng = np.random.default_rng(326)
    s_stream = rng.integers(0, 2**32, size=NS + SCFG.n - 1, dtype=np.uint32)
    s_stream[100:130] = s_stream[100]
    return s_stream, embed_shingles_np(s_stream, SCFG)


def _queries(seed, s_stream, stride):
    """Random query shingles with a script window planted every
    ``stride`` rows (0: none)."""
    rng = np.random.default_rng(seed)
    q_stream = rng.integers(0, 2**32, size=NQ + SCFG.n - 1, dtype=np.uint32)
    if stride:
        for qi in range(0, NQ, stride):
            si = int(rng.integers(0, NS - 20))
            q_stream[qi : qi + SCFG.n] = s_stream[si : si + SCFG.n]
    return embed_shingles_np(q_stream, SCFG)


def _port(q, s, ns_valid, min_keep, merge):
    v, i = dt.topk_dot(torch.from_numpy(q), torch.from_numpy(s), ns_valid, K,
                       min_keep=min_keep, merge=merge)
    return v.numpy(), i.numpy()


def _jax(q, s, ns_valid, min_keep, merge, q_transposed=True):
    sp, nsv = pad_rows(jnp.asarray(s), 512)
    qj = jnp.asarray(np.ascontiguousarray(q.T)) if q_transposed else jnp.asarray(q)
    v, i = topk_dot_pallas(
        qj, sp, ns_valid if ns_valid < s.shape[0] else nsv, K, DIM, tile_s=512,
        interpret=True, min_keep=min_keep, q_transposed=q_transposed, merge=merge,
    )
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("stride,min_keep", [(101, 3.5), (3, 3.5), (3, 1.0 / DIM)])
def test_rows_equals_jax_rows_kernel_every_slot(script, stride, min_keep):
    """Sparse (one entrant row per firing tile) and dense (many entrant
    rows, multi-entrant rows) plantings, at the engine's threshold and at
    the lowest one that reaches the rows kernel."""
    s_stream, s_emb = script
    q = _queries(stride, s_stream, stride)
    v, i = _port(q, s_emb, NS, min_keep, "rows")
    jv, ji = _jax(q, s_emb, NS, min_keep, "rows")
    assert np.array_equal(v, jv) and np.array_equal(i, ji)
    assert (v >= min_keep).sum() > (20 if stride > 50 else 50)
    assert ((v >= min_keep) | (v == dt.NEG_INF)).all()


def test_rows_ragged_ns_valid_equals_jax(script):
    """Columns past ns_valid never enter, inside the last tile too."""
    s_stream, s_emb = script
    q = _queries(7, s_stream, 3)
    v, i = _port(q, s_emb, 3001, 3.5, "rows")
    jv, ji = _jax(q, s_emb, 3001, 3.5, "rows")
    assert np.array_equal(v, jv) and np.array_equal(i, ji)
    assert (i < 3001).all() and (v >= 3.5).any()


def test_rows_exact_mode_routes_to_insert(script):
    """Below min_keep 1/dim JAX sends "rows" to "insertloop": the exact
    full top-k, equal to merge="insert" and to the JAX kernel."""
    s_stream, s_emb = script
    q = _queries(1, s_stream, 0)
    for mk in (-float("inf"), 0.0):
        v, i = _port(q, s_emb, NS, mk, "rows")
        vi, ii = _port(q, s_emb, NS, mk, "insert")
        assert np.array_equal(v, vi) and np.array_equal(i, ii)
    jv, ji = _jax(q, s_emb, NS, -float("inf"), "rows", q_transposed=False)
    assert np.array_equal(v, jv) and np.array_equal(i, ji)
    assert (v > dt.NEG_INF).all()


def test_unknown_merge_raises_jax_error():
    q = np.zeros((128, DIM), np.int8)
    s = np.zeros((512, DIM), np.int8)
    with pytest.raises(ValueError) as je:
        topk_dot_pallas(jnp.asarray(q), jnp.asarray(s), 512, K, DIM, tile_s=512,
                        interpret=True, merge="fast")
    with pytest.raises(ValueError) as pe:
        _port(q, s, 512, -float("inf"), "fast")
    assert str(pe.value) == str(je.value)


class _FakeLib:
    """Records the kernel entry points called; every launch succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("merge,min_keep,entry", [
    ("rows", 3.5, "fs_topk_rows"),
    ("rows", 1.0 / DIM, "fs_topk_rows"),
    ("rows", 0.0, "fs_topk"),
    ("rows", -float("inf"), "fs_topk"),
    ("insert", 3.5, "fs_topk"),
    ("insertloop", 3.5, "fs_topk"),
    ("rebuild", -float("inf"), "fs_topk"),
])
def test_wrapper_routes_to_k7_or_k2(monkeypatch, merge, min_keep, entry):
    """On the kernel route, "rows" at min_keep >= 1/dim calls
    fs_topk_rows and counts launches_rows; everything else calls fs_topk
    and counts launches."""
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(dt.topk_dot, "launches", 0)
    monkeypatch.setattr(dt.topk_dot, "launches_rows", 0)
    q = torch.zeros((5, DIM), dtype=torch.int8)
    s = torch.zeros((64, DIM), dtype=torch.int8)
    v, i = dt.topk_dot(q, s, 60, K, min_keep=min_keep, merge=merge)
    assert v.shape == i.shape == (5, K)
    (name, args), = lib.calls
    assert name == entry
    assert args[4:9] == (5, 60, DIM, K, dt.min_keep_int(min_keep, DIM))
    rows = entry == "fs_topk_rows"
    assert (dt.topk_dot.launches, dt.topk_dot.launches_rows) == (int(not rows), int(rows))


# ---- the edge world of the tensor-core designs (utils/topk_cases.py)


@pytest.fixture(scope="module")
def edge():
    q, s = tc.edge_world()
    tops = {}
    for ns in tc.NS_VALID:
        v = np.full((q.shape[0], 32), dt.NEG_INF, np.float32)
        i = np.zeros((q.shape[0], 32), np.int32)
        if ns:
            kk = min(32, ns)
            jv, ji = topk_dot_jnp(q, s[:ns], kk, DIM)
            v[:, :kk], i[:, :kk] = np.asarray(jv), np.asarray(ji)
        tops[ns] = v, i
    return q, s, tops


def _port_k(q, s, ns_valid, k, min_keep):
    v, i = dt.topk_dot(torch.from_numpy(q), torch.from_numpy(s), ns_valid, k,
                       min_keep=min_keep, merge="rows")
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("gated", [False, True], ids=["exact", "gated"])
@pytest.mark.parametrize("k", tc.KS)
@pytest.mark.parametrize("ns_valid", tc.NS_VALID)
def test_rows_edge_world_matches_jnp(edge, ns_valid, k, gated):
    """merge="rows" in every slot against topk_dot_jnp (entries below
    min_keep as padding): ns_valid around a step's and a tile's edge, k 1
    to 32, at the engine's threshold and exact (which K2 computes)."""
    q, s, tops = edge
    mk = tc.MIN_KEEP if gated else -float("inf")
    v, i = _port_k(q, s, ns_valid, k, mk)
    ev, ei = (x[:, :k] for x in tops[ns_valid])
    drop = ev < mk
    assert np.array_equal(v, np.where(drop, dt.NEG_INF, ev))
    assert np.array_equal(i, np.where(drop, 0, ei))


@pytest.mark.parametrize("ns_valid", [tc.TILE + 1, 3001])
def test_rows_edge_world_equals_jax_rows_kernel(edge, ns_valid):
    """The interpreted JAX rows kernel on the edge world: ties across step
    and tile edges, identical padding rows with more passing columns than a
    step holds, every slot."""
    q, s, _ = edge
    nq = q.shape[0]
    qp = np.zeros((-(-nq // 128) * 128, DIM), np.int8)
    qp[:nq] = q
    v, i = _port_k(q, s, ns_valid, K, tc.MIN_KEEP)
    jv, ji = _jax(qp, s, ns_valid, tc.MIN_KEEP, "rows")
    assert np.array_equal(v, jv[:nq]) and np.array_equal(i, ji[:nq])
    assert (v >= tc.MIN_KEEP).any()
