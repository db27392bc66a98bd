"""The bucketed prefilter's ops: the port against the JAX package.

Tolerance: 0.  Salts, bucket ids and tables are integers; candidate
triples are (query, script row) integers with scores that are integer
dots divided by a power-of-two dim in f32; counts are integers.  Every
output compares exactly (np.array_equal) against the JAX functions, on
the worlds of tests/test_bucketed.py.  The JAX flat path runs both of
its impls ("seg", which the port follows, and "gather", its A/B
control); the JAX hybrid runs its exact fallback through jnp
(``use_pallas=False``), whose entries at or above the threshold are
K2's.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fandom_search_tpu.ops.bucketed as jb
from fandom_search_tpu.config import BucketedConfig, PipelineConfig
from fandom_search_tpu.data.hashing import fmix32 as jfmix32
from fandom_search_tpu.data.shingler import embed_shingles_np, shingle_hashes
from fandom_search_tpu.ops.distance_topk import pad_rows, topk_dot_jnp
from fandom_search_tpu_torch.config import BucketedConfig as PortBucketedConfig
from fandom_search_tpu_torch.config import ShingleConfig as PortShingleConfig
from fandom_search_tpu_torch.ops import bucketed as pb
from fandom_search_tpu_torch.search.engine import _next_pow2

CFG = PipelineConfig()
SCFG = CFG.shingle
K = CFG.search.k
DIM = SCFG.dim
THR = CFG.search.candidate_threshold
BCFG = BucketedConfig()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tensors are small, and the suite's workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    """numpy (uint32 as int32 bit patterns) -> torch."""
    x = np.ascontiguousarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def _world(rng, nq=512, ns=1500, plant_every=7):
    """tests/test_bucketed.py's world: random streams with planted
    near-quotes (<= 2 positions of a script shingle mutated)."""
    s_stream = rng.integers(0, 2**32, size=ns + SCFG.n - 1, dtype=np.uint32)
    q_stream = rng.integers(0, 2**32, size=nq + SCFG.n - 1, dtype=np.uint32)
    for qi in range(0, nq, plant_every):
        si = int(rng.integers(0, ns))
        q_stream[qi : qi + SCFG.n] = s_stream[si : si + SCFG.n]
        n_mut = int(rng.integers(0, 3))
        for p in rng.choice(SCFG.n, size=n_mut, replace=False):
            q_stream[qi + p] = rng.integers(0, 2**32, dtype=np.uint32)
    return q_stream, s_stream


def _hot_world(rng):
    """tests/test_bucketed.py:522's world: planted near-quotes with a hot
    run spliced in, so some buckets overflow cap (at-risk queries)."""
    q_stream, s_stream = _world(rng, nq=700, ns=2000)
    q_stream[90:140] = 7
    s_stream[300:420] = 7
    return q_stream, s_stream


def _zipf_stream(rng, count, a=1.05, vocab=1 << 11):
    """tests/test_bucketed.py:454's English-like skew (word ids spread
    over uint32 by a golden-ratio multiply, so hashes reach 2^31 and
    above)."""
    return ((rng.zipf(a, size=count) % vocab).astype(np.uint32)
            * np.uint32(0x9E3779B9))


def _tables(windows, bcfg):
    """(JAX index, port native, port NumPy) for the same windows."""
    pcfg = PortBucketedConfig(**dataclasses.asdict(bcfg))
    build = functools.partial(pb.BucketedIndex.build, windows, pcfg, PortShingleConfig(),
                              device="cpu")
    native = build()
    orig = pb._build_tables_native
    pb._build_tables_native = lambda *a, **k: None   # as if the library were absent
    try:
        ref = build()
    finally:
        pb._build_tables_native = orig
    return jb.BucketedIndex.build(windows, bcfg, SCFG), native, ref


def _drive_hybrid(stream, q_emb, entries, offsets, s_emb, ns_valid, *, max_out,
                  risk_budget, grow_max_out, **kw):
    """The JAX ``drive_hybrid``'s retry contract over the port's device
    hybrid (the engine runs the same retry in ``_process_fused``): grow
    the risk budget, then ``max_out``, pow2, until both fit."""
    while True:
        *out, rc = pb.bucketed_hybrid(stream, q_emb, entries, offsets, s_emb, ns_valid,
                                      max_out=max_out, risk_budget=risk_budget, **kw)
        rc = int(rc)
        if rc > risk_budget:
            risk_budget = _next_pow2(rc, risk_budget * 2)
        elif grow_max_out and int(out[3]) > max_out:
            max_out = _next_pow2(int(out[3]), max_out * 2)
        else:
            return tuple(out), rc, max_out, risk_budget


def _same(got, want):
    got = [g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w), (g, w)


@pytest.mark.parametrize("mode", ["triangles", "all"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 9])
def test_pairs_and_salts_match(n, mode):
    assert pb._pairs_for(n, mode) == jb._pairs_for(n, mode)
    p = len(jb._pairs_for(n, mode))
    for seed in (0, BCFG.seed, 2**32 - 1):
        assert np.array_equal(pb._derive_salts(seed, p), jb._derive_salts(seed, p))


def test_bucket_ids_match_at_and_above_2_31(rng):
    """The port's NumPy and torch (int64, masked to 32 bits) hashes give
    the JAX package's ids on uint32 values across the whole range."""
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1, 0x9E3779B9,
                     0x85EBCA6B], dtype=np.uint32)
    w_a = np.concatenate([edge, rng.integers(0, 2**32, size=4000, dtype=np.uint32)])
    w_b = np.concatenate([edge[::-1], rng.integers(0, 2**32, size=4000, dtype=np.uint32)])
    assert (w_a >= 2**31).sum() > 1000
    for salt in (0, 2**31, 2**32 - 1, int(jb._derive_salts(BCFG.seed, 1)[0])):
        for nb in (1024, 1 << 22):
            want = jb._bucket_ids(w_a, w_b, np.uint32(salt), nb)
            want_j = np.asarray(jb._bucket_ids(jnp.asarray(w_a), jnp.asarray(w_b),
                                               jnp.uint32(salt), nb))
            got_np = pb._bucket_ids(w_a, w_b, salt, nb)
            got_t = pb._bucket_ids(_t(w_a).long() & 0xFFFFFFFF,
                                   _t(w_b).long() & 0xFFFFFFFF, salt, nb)
            assert np.array_equal(want, want_j)
            assert got_np.dtype == np.int32 and np.array_equal(got_np, want)
            assert np.array_equal(got_t.numpy(), want)
    h = torch.from_numpy(w_a.astype(np.int64))
    assert np.array_equal(pb._fmix32_t(h).numpy(), jfmix32(w_a).astype(np.int64))


@pytest.mark.parametrize("mode", ["triangles", "all"])
@pytest.mark.parametrize("world", ["uniform", "hot_pair", "zipf"])
def test_tables_match_jax_native_and_numpy(rng, mode, world):
    """entries, offsets, salts and overflow_frac: the port's native
    builder, its NumPy twin and the JAX build agree; the skewed worlds
    overflow."""
    if world == "zipf":
        s_stream = _zipf_stream(rng, 3000)
    else:
        s_stream = rng.integers(0, 2**32, size=3000, dtype=np.uint32)
        if world == "hot_pair":
            s_stream[::3], s_stream[1::3] = 7, 9
    windows = shingle_hashes(s_stream, SCFG)
    want, nat, ref = _tables(windows, dataclasses.replace(BCFG, pairs=mode))
    assert (nat.builder, ref.builder) == ("native", "numpy")
    for got in (nat, ref):
        assert np.array_equal(got.entries.numpy(), np.asarray(want.entries))
        assert np.array_equal(got.offsets.numpy(), np.asarray(want.offsets))
        assert (got.num_buckets, got.salts, got.ns_valid, got.overflow_frac) == (
            want.num_buckets, want.salts, want.ns_valid, want.overflow_frac)
    assert (want.overflow_frac > 0) == (world != "uniform")


def test_table_build_edges():
    """No shingles: one zero column, as the JAX build; a CUDA device
    without the native builder is refused, not served by NumPy."""
    windows = np.zeros((0, SCFG.n), dtype=np.uint32)
    want = jb.BucketedIndex.build(windows, BCFG, SCFG)
    got = pb.BucketedIndex.build(windows, PortBucketedConfig(), PortShingleConfig(),
                                 device="cpu")
    assert got.builder == "empty" and got.overflow_frac == want.overflow_frac == 0.0
    assert np.array_equal(got.entries.numpy(), np.asarray(want.entries))
    assert np.array_equal(got.offsets.numpy(), np.asarray(want.offsets))
    back = pb.BucketedIndex.from_arrays(got.entries.numpy(), got.offsets.numpy(),
                                        got.num_buckets, got.salts, 0, 0.0).to("cpu")
    assert torch.equal(back.entries, got.entries) and back.builder == "loaded"


def test_table_build_refuses_numpy_on_cuda(monkeypatch):
    monkeypatch.setattr(pb, "_build_tables_native", lambda *a, **k: None)
    windows = shingle_hashes(np.arange(40, dtype=np.uint32), SCFG)
    with pytest.raises(RuntimeError, match="native bucketed table builder"):
        pb.BucketedIndex.build(windows, PortBucketedConfig(), PortShingleConfig(),
                               device="cuda")
    got = pb.BucketedIndex.build(windows, PortBucketedConfig(), PortShingleConfig(),
                                 device="cpu")
    assert got.builder == "numpy"


@pytest.mark.parametrize("ln,start,budget", [
    ([3, 2, 0, 0], [100, 200, 300, 400], 5),     # exact fill, trailing empties
    ([4, 3], [0, 50], 5),                        # overflow: mass 7 > 5
    ([0, 2, 0, 1, 3], [9, 20, 30, 40, 50], 16),  # leading and inner empties
])
def test_seg_stream_matches(ln, start, budget):
    want = jb._seg_stream(jnp.asarray(ln, jnp.int32), jnp.asarray(start, jnp.int32),
                          budget)
    got = pb._seg_stream(torch.tensor(ln, dtype=torch.int32),
                         torch.tensor(start, dtype=torch.int32), budget)
    _same(got, want)
    if budget == 5 and len(ln) == 4:
        assert got[0].tolist() == [0, 0, 0, 1, 1]
        assert got[1].tolist() == [100, 101, 102, 200, 201]


def _flat_kw(bidx, mode, max_out=4096):
    return dict(n=SCFG.n, cap=BCFG.cap, num_buckets=bidx.num_buckets, salts=bidx.salts,
                k=K, dim=DIM, threshold=THR, max_out=max_out, pairs_mode=mode)


@pytest.mark.parametrize("mode", ["triangles", "all"])
def test_flat_and_hybrid_parts_match_seg_and_gather(rng, mode):
    """Flat triples and counts against both JAX impls, and the hybrid's
    stage 1 (at-risk queries dropped, their rows compacted)."""
    q_stream, s_stream = _hot_world(rng)
    windows = shingle_hashes(s_stream, SCFG)
    q_emb = embed_shingles_np(q_stream, SCFG)
    s_emb = embed_shingles_np(s_stream, SCFG)
    s_pad, _ = pad_rows(s_emb, 512)
    want_idx, got_idx, _ = _tables(windows, dataclasses.replace(BCFG, pairs=mode))
    kw = _flat_kw(want_idx, mode)
    jargs = (jnp.asarray(q_stream), jnp.asarray(q_emb), want_idx.entries,
             want_idx.offsets, jnp.asarray(s_pad))
    pargs = (_t(q_stream), _t(q_emb), got_idx.entries, got_idx.offsets, _t(s_emb))
    got = pb.bucketed_candidates_flat(*pargs, **kw)
    for impl in ("seg", "gather"):
        _same(got, jb.bucketed_candidates_flat(*jargs, impl=impl, **kw))
    assert int(got[3]) > 100
    hot = pb.bucketed_hybrid_parts(*pargs, risk_budget=256, **kw)
    for impl in ("seg", "gather"):
        _same(hot, jb.bucketed_hybrid_parts(*jargs, risk_budget=256, impl=impl, **kw))
    assert int(hot[5]) > 0


def test_flat_budget_overflow_count_matches(rng):
    """Every shingle identical: at max_out 4 the pair stream overflows
    its budget and the triples overflow max_out; the count (> max_out)
    is the JAX package's, so the engine's retry grows both budgets
    alike.  At 2^14 both fit."""
    nq, ns = 1024, 800
    q_stream = np.empty(nq + SCFG.n - 1, np.uint32)
    s_stream = np.empty(ns + SCFG.n - 1, np.uint32)
    q_stream[0::2], q_stream[1::2] = 111, 222
    s_stream[0::2], s_stream[1::2] = 111, 222
    windows = shingle_hashes(s_stream, SCFG)
    q_emb = embed_shingles_np(q_stream, SCFG)
    s_emb = embed_shingles_np(s_stream, SCFG)
    want_idx, got_idx, _ = _tables(windows, BCFG)
    for max_out in (4, 1 << 14):
        kw = _flat_kw(want_idx, "triangles", max_out)
        want = jb.bucketed_candidates_flat(
            jnp.asarray(q_stream), jnp.asarray(q_emb), want_idx.entries,
            want_idx.offsets, jnp.asarray(pad_rows(s_emb, 512)[0]), **kw)
        got = pb.bucketed_candidates_flat(_t(q_stream), _t(q_emb), got_idx.entries,
                                          got_idx.offsets, _t(s_emb), **kw)
        _same(got, want)
        assert (int(got[3]) > max_out) == (max_out == 4)


def test_flat_rejects_degenerate_stream(rng):
    q_stream, s_stream = _world(rng, nq=64, ns=500)
    windows = shingle_hashes(s_stream, SCFG)
    q_emb = embed_shingles_np(q_stream, SCFG)
    _, got_idx, _ = _tables(windows, BCFG)
    with pytest.raises(ValueError, match="shorter than the shingle"):
        pb.bucketed_candidates_flat(
            _t(q_stream[: SCFG.n - 1]), _t(q_emb), got_idx.entries, got_idx.offsets,
            _t(embed_shingles_np(s_stream, SCFG)), **_flat_kw(got_idx, "triangles"))


@pytest.mark.parametrize("mode", ["triangles", "all"])
def test_probe_candidates_and_bucketed_topk_match(rng, mode):
    q_stream, s_stream = _hot_world(rng)
    windows = shingle_hashes(s_stream, SCFG)
    q_emb = embed_shingles_np(q_stream, SCFG)
    s_emb = embed_shingles_np(s_stream, SCFG)
    bcfg = dataclasses.replace(BCFG, pairs=mode)
    want_idx, got_idx, _ = _tables(windows, bcfg)
    geo = dict(n=SCFG.n, cap=bcfg.cap, num_buckets=want_idx.num_buckets,
               salts=want_idx.salts, pairs_mode=mode)
    got = pb.probe_candidates(_t(q_stream), got_idx.entries, got_idx.offsets, **geo)
    _same(got, jb.probe_candidates(jnp.asarray(q_stream), want_idx.entries,
                                   want_idx.offsets, **geo))
    assert got[2].any() and not got[2].all()
    s_pad, _ = pad_rows(s_emb, 512)
    want = jb.bucketed_topk(q_emb, q_stream, want_idx, s_pad, K, DIM, bcfg, SCFG)
    got = pb.bucketed_topk(_t(q_emb), _t(q_stream), got_idx, _t(s_emb), K, DIM,
                           PortBucketedConfig(pairs=mode), PortShingleConfig())
    _same(got, want)


@pytest.fixture(scope="module")
def zipf_world():
    """tests/test_bucketed.py:440's English-skew world under pairs "all"."""
    rng = np.random.default_rng(42)
    n, ns, nq = SCFG.n, 8192, 2048
    s_stream = _zipf_stream(rng, ns + n - 1)
    q_stream = _zipf_stream(rng, nq + n - 1)
    for qi in range(0, nq, 10):
        si = int(rng.integers(0, ns))
        q_stream[qi : qi + n] = s_stream[si : si + n]
    bcfg = dataclasses.replace(BCFG, pairs="all")
    windows = shingle_hashes(s_stream, SCFG)
    want_idx, got_idx, _ = _tables(windows, bcfg)
    q_emb = embed_shingles_np(q_stream, SCFG)
    s_emb = embed_shingles_np(s_stream, SCFG)
    return q_stream, q_emb, s_emb, want_idx, got_idx


@pytest.mark.parametrize("risk_budget,max_out", [(1024, 1 << 15), (64, 64)])
def test_drive_hybrid_matches(zipf_world, risk_budget, max_out):
    """The hybrid's merged triples against the JAX ``drive_hybrid``; the
    second case starts both budgets low, so the risk budget and max_out
    grow (pow2) on both sides."""
    q_stream, q_emb, s_emb, want_idx, got_idx = zipf_world
    ns = s_emb.shape[0]
    s_pad, nsv = pad_rows(jnp.asarray(s_emb), 2048)
    kw = dict(n=SCFG.n, cap=BCFG.cap, num_buckets=want_idx.num_buckets,
              salts=want_idx.salts, k=K, dim=DIM, threshold=THR, pairs_mode="all",
              max_out=max_out, risk_budget=risk_budget, grow_max_out=True)
    (wq, ws, wsc, wc), wrc, wmo, wrb = jb.drive_hybrid(
        jnp.asarray(q_stream), jnp.asarray(q_emb), want_idx.entries, want_idx.offsets,
        s_pad, nsv, use_pallas=False, **kw)
    (gq, gs, gsc, gc), grc, gmo, grb = _drive_hybrid(
        _t(q_stream), _t(q_emb), got_idx.entries, got_idx.offsets, _t(s_emb), ns, **kw)
    c = int(wc)
    assert (grc, gmo, grb, int(gc)) == (wrc, wmo, wrb, c)
    assert 0 < grc < 0.3 * q_emb.shape[0] and c > 0
    # slots past the count are padding (their scores are whatever the
    # compaction read), so the triples compare up to it
    _same([gq[:c], gs[:c], gsc[:c]], [np.asarray(x)[:c] for x in (wq, ws, wsc)])
    if risk_budget < 1024:
        assert grb > risk_budget and gmo > max_out
    # and the thresholded recall against the exact top-k, the JAX helper's
    ev, _ = topk_dot_jnp(jnp.asarray(q_emb), s_pad, K, DIM)
    want = jb.thresholded_recall_vs_exact(ev, wq, wsc, wc, dim=DIM, threshold=THR)
    got = pb.thresholded_recall_vs_exact(np.asarray(ev), gq, gsc, gc, dim=DIM,
                                         threshold=THR)
    assert got == want and got[1] > 0


def test_exact_on_risk_rows_and_merge_match(zipf_world):
    """Stage 2 on a -1 padded row list (K2's plain version against the
    JAX jnp fallback; padding rows keep nothing), then the merge."""
    q_stream, q_emb, s_emb, _, _ = zipf_world
    rows = np.full(512, -1, np.int32)
    rows[:300] = np.arange(0, 3000, 10)
    s_pad, nsv = pad_rows(jnp.asarray(s_emb), 2048)
    kw = dict(k=K, dim=DIM, threshold=THR, max_out=2048)
    want = jb.exact_on_risk_rows(jnp.asarray(q_emb), jnp.asarray(rows), s_pad, nsv,
                                 use_pallas=False, **kw)
    got = pb.exact_on_risk_rows(_t(q_emb), _t(rows), _t(s_emb), s_emb.shape[0], **kw)
    c = int(want[3])
    assert int(got[3]) == c > 0
    _same([g[:c] for g in got[:3]], [np.asarray(w)[:c] for w in want[:3]])
    assert (got[0][c:] == -1).all()
    qb = np.arange(64, dtype=np.int32)
    sb = qb * 3
    scb = qb.astype(np.float32) / 8
    for cb in (0, 17, 64):
        w = jb.merge_triples(jnp.asarray(qb), jnp.asarray(sb), jnp.asarray(scb),
                             jnp.int32(cb), *want, max_out=64)
        g = pb.merge_triples(_t(qb), _t(sb), _t(scb), torch.tensor(cb, dtype=torch.int32),
                             *got, max_out=64)
        _same(g, w)


def test_next_qpow2_matches():
    for n in list(range(0, 5000, 7)) + [56700, 123457, 1 << 20, 5 * (1 << 20) + 8]:
        for floor in (1, 1024):
            assert pb._next_qpow2(n, floor) == jb._next_qpow2(n, floor)
    assert pb._pair_budget(1 << 20, 15, 1 << 14) == 6291456
