"""K2 distance top-k: the port's plain version against the JAX package.

Tolerance: 0.  Scores are integers divided by a power-of-two dim in
f32 and indices are integers, so vals and idx compare exactly
(np.array_equal) against topk_dot_jnp (exact mode) and against the
interpreted Pallas kernel (engine mode, at and above the threshold).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fandom_search_tpu.ops.distance_topk import (
    NEG_INF as JAX_NEG_INF,
    pad_rows,
    topk_dot_jnp,
    topk_dot_pallas,
)
from fandom_search_tpu.search.oracle import topk_scores_np
from fandom_search_tpu_torch.ops.distance_topk import NEG_INF, topk_dot
from fandom_search_tpu_torch.utils import topk_cases as tc

K, DIM = 10, 128


def _rand_emb(rng, n, dim=DIM):
    return rng.integers(-6, 7, size=(n, dim)).astype(np.int8)


def _port(q, s, k=K, ns_valid=None, min_keep=-float("inf")):
    ns_valid = s.shape[0] if ns_valid is None else ns_valid
    v, i = topk_dot(torch.from_numpy(q), torch.from_numpy(s), ns_valid, k,
                    min_keep=min_keep)
    return v.numpy(), i.numpy()


def _exact(q, s, k=K, dim=DIM):
    v, i = topk_dot_jnp(q, s, k, dim)
    return np.asarray(v), np.asarray(i)


def test_neg_inf_matches_jax():
    assert NEG_INF == JAX_NEG_INF


@pytest.mark.parametrize("nq,ns", [(100, 300), (300, 777), (256, 2148), (1, 10)])
def test_plain_exact_matches_jnp(rng, nq, ns):
    q, s = _rand_emb(rng, nq), _rand_emb(rng, ns)
    v, i = _port(q, s)
    ev, ei = _exact(q, s)
    assert np.array_equal(v, ev) and np.array_equal(i, ei)


def test_plain_duplicate_rows_ties_lowest_index(rng):
    s_half = _rand_emb(rng, 256)
    s = np.concatenate([s_half, s_half], axis=0)
    q = s_half[:64]
    v, i = _port(q, s)
    ev, ei = _exact(q, s)
    assert np.array_equal(v, ev) and np.array_equal(i, ei)


def test_plain_boundary_ties_match_oracle_and_jnp(rng):
    # more than k exactly-tied scores at the k-th slot
    base = rng.integers(-3, 4, size=(5, DIM)).astype(np.int8)
    s = base[rng.integers(0, 5, size=300)]
    q = base[rng.integers(0, 5, size=64)]
    v, i = _port(q, s)
    ov, oi = topk_scores_np(q, s, K, DIM)
    ev, ei = _exact(q, s)
    assert np.array_equal(i, oi) and np.array_equal(i, ei)
    assert np.array_equal(v, ev) and np.array_equal(v, ov)


def test_plain_repeated_words_score_bound(rng):
    # entries at +-n stack to dots of n^2 * dim, the packing's bound
    q = _rand_emb(rng, 32)
    s = _rand_emb(rng, 200)
    q[0] = s[7] = 6
    s[9] = 6
    v, i = _port(q, s)
    ev, ei = _exact(q, s)
    assert np.array_equal(v, ev) and np.array_equal(i, ei)
    assert v[0, 0] == 36.0 and list(i[0, :2]) == [7, 9]


@pytest.mark.parametrize("dim2", [256, 512])
def test_plain_wide_dims_exact(rng, dim2):
    q, s = _rand_emb(rng, 64, dim2), _rand_emb(rng, 150, dim2)
    s[5] = q[0] = 6
    v, i = _port(q, s)
    ev, ei = _exact(q, s, dim=dim2)
    assert np.array_equal(v, ev) and np.array_equal(i, ei)


def test_plain_ns_valid_and_k_above_ns_match_pallas(rng):
    # ns_valid < NS masks the tail; slots past ns_valid are (NEG_INF, 0)
    q, s = _rand_emb(rng, 128), _rand_emb(rng, 2048)
    for ns_valid in (6, 1000):
        v, i = _port(q, s, ns_valid=ns_valid)
        pv, pi = topk_dot_pallas(
            jnp.asarray(q), jnp.asarray(s), ns_valid, K, DIM, interpret=True
        )
        assert np.array_equal(v, np.asarray(pv))
        assert np.array_equal(i, np.asarray(pi))
    assert (v[:, 6:] != NEG_INF).all()
    v6, i6 = _port(q, s, ns_valid=6)
    assert (v6[:, 6:] == NEG_INF).all() and (i6[:, 6:] == 0).all()


def test_plain_engine_mode_matches_pallas_above_threshold(rng):
    """min_keep=3.5 against the engine's call (lane-major q, gated):
    equal at and above the threshold, no fabricated entry above it."""
    thr = 3.5
    q, s = _rand_emb(rng, 256), _rand_emb(rng, 3000)
    s[100:150] = q[:50]
    s[2500:2510] = q[:10]  # ties across distant columns
    v, i = _port(q, s, min_keep=thr)
    s_pad, ns = pad_rows(jnp.asarray(s), 2048)
    pv, pi = topk_dot_pallas(
        jnp.asarray(q.T.copy()), s_pad, ns, K, DIM, interpret=True,
        q_transposed=True, min_keep=thr, max_abs_score=6 * 6 * DIM,
    )
    pv, pi = np.asarray(pv), np.asarray(pi)
    keep = pv >= thr
    assert keep.any()
    assert np.array_equal(v[keep], pv[keep]) and np.array_equal(i[keep], pi[keep])
    assert not ((v >= thr) & ~keep).any()
    # and against the exact top-k: the port keeps exactly its
    # above-threshold entries and pads the rest
    ev, ei = _exact(q, s)
    above = ev >= thr
    assert np.array_equal(v[above], ev[above]) and np.array_equal(i[above], ei[above])
    assert (v[~above] == NEG_INF).all() and (i[~above] == 0).all()


def test_plain_empty_inputs():
    q = np.zeros((0, DIM), np.int8)
    s = np.zeros((5, DIM), np.int8)
    v, i = _port(q, s)
    assert v.shape == (0, K) and i.shape == (0, K)
    v, i = _port(np.ones((3, DIM), np.int8), s, ns_valid=0)
    assert (v == NEG_INF).all() and (i == 0).all()


def test_topk_rejects_bad_arguments():
    q = torch.zeros((4, DIM), dtype=torch.int8)
    s = torch.zeros((8, DIM), dtype=torch.int8)
    with pytest.raises(ValueError):
        topk_dot(q.int(), s, 8, K)
    with pytest.raises(ValueError):
        topk_dot(q, s, 9, K)
    with pytest.raises(ValueError):
        topk_dot(q, s[:, :64], 8, K)


# ---- the edge world of the tensor-core designs (utils/topk_cases.py)


def _jnp_top(q, s, ns_valid, kmax=32):
    """topk_dot_jnp over s[:ns_valid], padded to kmax slots with
    (NEG_INF, 0): every k <= kmax is a prefix (lax.top_k is sorted and
    stable)."""
    v = np.full((q.shape[0], kmax), JAX_NEG_INF, np.float32)
    i = np.zeros((q.shape[0], kmax), np.int32)
    if ns_valid:
        kk = min(kmax, ns_valid)
        jv, ji = _exact(q, s[:ns_valid], k=kk)
        v[:, :kk], i[:, :kk] = jv, ji
    return v, i


@pytest.fixture(scope="module")
def edge():
    q, s = tc.edge_world()
    return q, s, {ns: _jnp_top(q, s, ns) for ns in tc.NS_VALID}


def expected_edge(edge, ns_valid, k, min_keep):
    """The JAX op's top-k of the edge world, entries below min_keep
    replaced by padding (the port keeps only entries >= min_keep)."""
    ev, ei = (x[:, :k] for x in edge[2][ns_valid])
    drop = ev < min_keep
    return np.where(drop, NEG_INF, ev), np.where(drop, 0, ei)


def test_edge_world_holds_the_cases(edge):
    q, s, _ = edge
    sc = q.astype(np.int64) @ s.astype(np.int64).T
    keep = int(np.ceil(tc.MIN_KEEP * DIM))
    assert q.shape[0] % 256 != 0
    for r, (a, b) in enumerate(((31, 32), (63, 64), (127, 128))):
        assert sc[r, a] == sc[r, b] == sc[r].max()     # ties across an edge
    assert (sc[5, 400:440] == sc[5].max()).all()          # more ties than a step
    pad = sc[100:]
    assert (pad == pad[0]).all()                          # identical rows
    assert (pad[0, 1024:1056] >= keep).all()              # a whole step passes
    assert (pad[0, :3001] >= keep).sum() > 4 * tc.STEP    # many steps pass
    assert pad[0, 2500] == pad[0, 2999] > pad[0, 1000]    # a late, higher tie


@pytest.mark.parametrize("gated", [False, True], ids=["exact", "gated"])
@pytest.mark.parametrize("k", tc.KS)
@pytest.mark.parametrize("ns_valid", tc.NS_VALID)
def test_plain_edge_world_matches_jnp(edge, ns_valid, k, gated):
    """Every slot, at ns_valid around a step's and a tile's edge, k = 1 to
    32, exact and at the engine's threshold."""
    mk = tc.MIN_KEEP if gated else -float("inf")
    v, i = _port(edge[0], edge[1], k=k, ns_valid=ns_valid, min_keep=mk)
    ev, ei = expected_edge(edge, ns_valid, k, mk)
    assert np.array_equal(v, ev) and np.array_equal(i, ei)


# ---- shapes beyond the engine's: dim a multiple of 128, k above 32


@pytest.mark.parametrize("dim,k", [(256, 10), (256, 33), (128, 64), (256, 64), (512, 33)])
def test_plain_wide_dim_and_large_k_match_pallas(rng, dim, k):
    """Every slot of the exact top-k equals the Pallas kernel's in
    interpret mode at dim 256/512 and k 33/64 (the chunked producer and
    the large-k merge of K2 and K7 on the card); at the engine's
    threshold the entries at and above it equal the kernel's, with ties
    across tiles."""
    q, s = _rand_emb(rng, 128, dim), _rand_emb(rng, 1024, dim)
    s[100:150] = q[:50]
    s[700:720] = q[:20]                               # ties across distant columns
    v, i = _port(q, s, k=k, ns_valid=1000)
    pv, pi = topk_dot_pallas(jnp.asarray(q), jnp.asarray(s), 1000, k, dim, tile_s=512,
                             interpret=True)
    assert np.array_equal(v, np.asarray(pv)) and np.array_equal(i, np.asarray(pi))
    assert np.array_equal(i[:20, :2], np.stack([np.arange(100, 120), np.arange(700, 720)], 1))
    # the engine's call: gated, every script row valid
    thr = 3.5
    v, i = _port(q, s, k=k, min_keep=thr)
    pv, pi = topk_dot_pallas(
        jnp.asarray(q.T.copy()), jnp.asarray(s), 1024, k, dim, tile_s=512, interpret=True,
        q_transposed=True, min_keep=thr, max_abs_score=6 * 6 * dim,
    )
    pv, pi = np.asarray(pv), np.asarray(pi)
    keep = pv >= thr
    assert keep[:50].all(axis=0)[0]
    assert np.array_equal(v[keep], pv[keep]) and np.array_equal(i[keep], pi[keep])
    assert not ((v >= thr) & ~keep).any()
    for merge in ("rows", "insert"):
        rv, ri = topk_dot(torch.from_numpy(q), torch.from_numpy(s), 1024, k,
                          min_keep=thr, merge=merge)
        assert np.array_equal(rv.numpy(), v) and np.array_equal(ri.numpy(), i)


class _FakeLib:
    """Records the kernel entry points called; every launch succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("dim,k,merge,min_keep,entry", [
    (256, 10, "insert", 3.5, "fs_topk"),
    (512, 10, "rows", 3.5, "fs_topk_rows"),
    (128, 33, "insert", -float("inf"), "fs_topk"),
    (128, 1000, "rows", 3.5, "fs_topk_rows"),
    (256, 64, "rows", -float("inf"), "fs_topk"),
    (1024, 256, "insert", 3.5, "fs_topk"),
])
def test_wrapper_launches_any_dim_and_k(monkeypatch, dim, k, merge, min_keep, entry):
    """dim any multiple of 128 and k above 32 reach K2 or K7 with their
    shape; a dim the kernels cannot tile is still refused."""
    from fandom_search_tpu_torch.ops import _cuda
    from fandom_search_tpu_torch.ops import distance_topk as dt

    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(dt.topk_dot, "launches", 0)
    monkeypatch.setattr(dt.topk_dot, "launches_rows", 0)
    q = torch.zeros((7, dim), dtype=torch.int8)
    s = torch.zeros((300, dim), dtype=torch.int8)
    v, i = topk_dot(q, s, 290, k, min_keep=min_keep, merge=merge)
    assert v.shape == i.shape == (7, k)
    (name, args), = lib.calls
    assert name == entry
    assert args[2] == v.data_ptr() and args[3] == i.data_ptr()
    assert args[4:10] == (7, 290, dim, k, dt.min_keep_int(min_keep, dim), 1.0 / dim)
    rows = entry == "fs_topk_rows"
    assert (dt.topk_dot.launches, dt.topk_dot.launches_rows) == (int(not rows), int(rows))
    with pytest.raises(ValueError, match="multiple of 128"):
        topk_dot(torch.zeros((7, 192), dtype=torch.int8),
                 torch.zeros((300, 192), dtype=torch.int8), 290, k)
    assert len(lib.calls) == 1
