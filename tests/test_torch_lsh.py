"""K6 and the LSH prefilter's ops: the port against the JAX package.

Tolerance: 0.  Codes are integers, Hamming similarities are integers
carried in f32, exact scores are integers divided by a power-of-two dim
in f32, and indices are integers, so every output compares exactly
(np.array_equal) against the JAX functions, with ``hamming_topk_pallas``
run in interpret mode as tests/test_lsh.py runs it.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fandom_search_tpu.ops.lsh as jlsh
from fandom_search_tpu.config import LSHConfig, ShingleConfig
from fandom_search_tpu.ops.distance_topk import pad_rows
from fandom_search_tpu_torch.config import LSHConfig as PortLSHConfig
from fandom_search_tpu_torch.config import ShingleConfig as PortShingleConfig
from fandom_search_tpu_torch.ops import _cuda
from fandom_search_tpu_torch.ops import lsh

DIM = 128


def _t(x):
    """numpy (uint32 as int32 bit patterns) -> torch."""
    x = np.ascontiguousarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def _codes(rng, n, words):
    return rng.integers(0, 2**32, size=(n, words), dtype=np.uint64).astype(np.uint32)


def _jax_hamming(q, st, ns_valid, r, bits, **kw):
    v, i = jlsh.hamming_topk_pallas(
        jnp.asarray(q), jnp.asarray(st), ns_valid, r, bits, interpret=True, **kw
    )
    return np.asarray(v), np.asarray(i)


def _port_hamming(q, st, ns_valid, r, bits, min_keep_sim=lsh.SENT):
    v, i = lsh.hamming_topk(_t(q), _t(st), ns_valid, r, bits,
                            min_keep_sim=min_keep_sim)
    return v.numpy(), i.numpy()


def _world(rng, bits, nq=256, ns_pad=1024):
    """Query and script codes with exact copies, near copies (a few bits
    flipped) and duplicated script columns, so sims tie."""
    words = bits // 32
    s = _codes(rng, ns_pad, words)
    s[600:700] = s[100:200]                      # duplicate columns
    q = _codes(rng, nq, words)
    q[:40] = s[100:140]                          # exact copies
    flip = rng.integers(0, 2, size=(40, words), dtype=np.uint64).astype(np.uint32)
    q[40:80] = s[300:340] ^ (flip << np.uint32(5))  # near copies
    return q, np.ascontiguousarray(s.T)


@pytest.mark.parametrize("bits", [256, 1024])
@pytest.mark.parametrize("r", [16, 128])
@pytest.mark.parametrize("ns_valid", [1000, 10])
def test_plain_hamming_exact_matches_pallas(rng, bits, r, ns_valid):
    """Every slot: ns_valid < NS_pad masks the tail, duplicated columns
    tie and go to the lowest column, and ns_valid < R leaves empty slots."""
    q, st = _world(rng, bits)
    got = _port_hamming(q, st, ns_valid, r, bits)
    want = _jax_hamming(q, st, ns_valid, r, bits)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    if ns_valid < r:
        assert (got[0][:, ns_valid:] == lsh.NEG_INF).all()
        assert (got[1][:, ns_valid:] == 0).all()
    else:
        assert (got[0][:40, 0] == bits).all()
        assert np.array_equal(got[1][:40, 0], np.arange(100, 140))
        assert np.array_equal(got[1][:40, 1], np.arange(600, 640))


@pytest.mark.parametrize("r,ns_valid", [(1100, 1500), (1030, 900)])
def test_plain_hamming_wide_codes_long_lists_match_pallas(rng, r, ns_valid):
    """bits 4096 with R above 1024 (K6's wide-code route and its lists
    longer than 1024 on the card): every slot equals the Pallas kernel's
    in interpret mode, ties to the lowest column, padding past ns_valid."""
    q, st = _world(rng, 4096, nq=256, ns_pad=2048)
    got = _port_hamming(q, st, ns_valid, r, 4096)
    want = _jax_hamming(q, st, ns_valid, r, 4096)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert (got[0][:, :min(r, ns_valid)] > lsh.NEG_INF).all()
    assert (got[0][:, ns_valid:] == lsh.NEG_INF).all()


@pytest.mark.parametrize("bits", [256, 1024])
def test_plain_hamming_gated_matches_pallas_above_threshold(rng, bits):
    """With min_keep_sim the entries at or above it equal the JAX
    kernel's; the rest of a row is padding."""
    q, st = _world(rng, bits)
    mks = bits // 2
    v, i = _port_hamming(q, st, 1000, 64, bits, min_keep_sim=mks)
    jv, ji = _jax_hamming(q, st, 1000, 64, bits, min_keep_sim=mks)
    keep = jv >= mks
    assert keep[:80].any()
    assert np.array_equal(v[keep], jv[keep]) and np.array_equal(i[keep], ji[keep])
    assert not ((v >= mks) & ~keep).any()
    assert (v[~keep] == lsh.NEG_INF).all() and (i[~keep] == 0).all()
    # and against the exact top-R: the gated rows keep its kept part
    ev, ei = _port_hamming(q, st, 1000, 64, bits)
    above = ev >= mks
    assert np.array_equal(v[above], ev[above]) and np.array_equal(i[above], ei[above])


def test_plain_hamming_matches_pallas_column_chunks(rng, monkeypatch):
    """JAX's chunked path (shrunk to 9 column bits: 512-column chunks,
    three of them) equals the port's unchunked result in every slot."""
    monkeypatch.setattr(jlsh, "_COL_BITS", 9)
    monkeypatch.setattr(jlsh, "_COL_MASK", (1 << 9) - 1)
    q, st = _world(rng, 256, ns_pad=1536)
    st[:, 1100:1150] = st[:, 150:200]            # ties across chunks
    got = _port_hamming(q, st, 1300, 32, 256)
    want = _jax_hamming(q, st, 1300, 32, 256)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def _emb(rng, n):
    return rng.integers(-6, 7, size=(n, DIM)).astype(np.int8)


@pytest.mark.parametrize("bits,seed", [(1024, 0xB175), (256, 7)])
def test_projection_and_encode_match(rng, bits, seed):
    jcfg, pcfg = LSHConfig(bits=bits, seed=seed), PortLSHConfig(bits=bits, seed=seed)
    proj = lsh.make_projection(pcfg, DIM)
    assert np.array_equal(proj, jlsh.make_projection(jcfg, DIM))
    emb = _emb(rng, 300)
    emb[7] = 0                                   # zero rows: every score 0
    emb[100:110] = 0
    got = lsh.encode(torch.from_numpy(emb), torch.from_numpy(proj)).numpy()
    want = np.asarray(jlsh.encode(jnp.asarray(emb), jnp.asarray(proj)))
    assert got.shape == (300, bits // 32) and got.dtype == np.int32
    assert np.array_equal(got.view(np.uint32), want)
    assert (got[7] == -1).all()                  # score 0 sets the bit


def test_lsh_index_and_lsh_topk_match(rng):
    """LSHIndex.build keeps JAX's layout, and the whole two-stage top-k
    (exact mode) equals JAX's lsh_topk."""
    cfg, pcfg = LSHConfig(bits=256, rerank=64), PortLSHConfig(bits=256, rerank=64)
    s_emb = _emb(rng, 700)
    s_emb[400:450] = s_emb[50:100]
    q_emb = _emb(rng, 200)
    q_emb[:60] = s_emb[30:90]
    jidx = jlsh.LSHIndex.build(s_emb, cfg, ShingleConfig())
    pidx = lsh.LSHIndex.build(s_emb, pcfg, PortShingleConfig(), device="cpu")
    assert pidx.ns_valid == jidx.ns_valid == 700
    assert np.array_equal(pidx.codes_t.numpy().view(np.uint32), np.asarray(jidx.codes_t))
    assert np.array_equal(pidx.projection.numpy(), np.asarray(jidx.projection))
    s_pad, _ = pad_rows(jnp.asarray(s_emb), 512)
    jv, ji = jlsh.lsh_topk(q_emb, jidx, s_pad, 10, DIM, cfg, interpret=True)
    v, i = lsh.lsh_topk(torch.from_numpy(q_emb), pidx, torch.from_numpy(s_emb),
                        10, DIM, pcfg)
    assert np.array_equal(v.numpy(), np.asarray(jv))
    assert np.array_equal(i.numpy(), np.asarray(ji))
    assert np.array_equal(i.numpy()[:20, 0], np.arange(30, 50))


def test_rerank_exact_ties_go_to_the_lowest_position(rng):
    """Equal exact scores rank by position in the R-list, not by script
    row; invalid slots score NEG_INF and keep their stage-1 row."""
    s = _emb(rng, 512)
    s[200:230] = s[10:40]                        # equal exact scores
    q = _emb(rng, 64)
    q[:30] = s[10:40]
    r, k = 24, 10
    cand = rng.integers(0, 512, size=(64, r)).astype(np.int32)
    cand[:30, 3] = np.arange(200, 230)           # the higher row comes first
    cand[:30, 9] = np.arange(10, 40)
    ok = rng.random((64, r)) < 0.8
    ok[:30, [3, 9]] = True
    ok[60:] = False                              # rows with no valid slot
    ok[50, :5] = True
    ok[50, 5:] = False                           # fewer valid than k
    jv, ji = jlsh.rerank_exact(jnp.asarray(q), jnp.asarray(s), jnp.asarray(cand),
                               jnp.asarray(ok), k, DIM)
    v, i = lsh.rerank_exact(torch.from_numpy(q), torch.from_numpy(s),
                            torch.from_numpy(cand), torch.from_numpy(ok), k, DIM)
    assert np.array_equal(v.numpy(), np.asarray(jv))
    assert np.array_equal(i.numpy(), np.asarray(ji))
    assert np.array_equal(i.numpy()[:30, 0], np.arange(200, 230))
    assert (v.numpy()[60:] == lsh.NEG_INF).all()


@pytest.mark.parametrize("thr,n,bits", [(3.5, 6, 1024), (3.5, 6, 256),
                                        (5.0, 6, 2048), (0.0, 3, 64), (9.0, 6, 512)])
def test_coarse_sim_threshold_matches(thr, n, bits):
    assert lsh.coarse_sim_threshold(thr, n, bits) == jlsh.coarse_sim_threshold(thr, n, bits)


class _FakeLib:
    """Records the kernel entry points called; every launch succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_cuda(monkeypatch):
    """CPU tensors take the kernel route, into a fake library."""
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda device: 0)
    return lib


@pytest.mark.parametrize("mks,h_max", [(lsh.SENT, 1024), (229, 397), (1025, -1)])
def test_hamming_wrapper_launches_k6(fake_cuda, mks, h_max):
    """One call of the kernel with the shape, the gate and the default
    tensor-core route (b1 at 1,024 bits)."""
    q = torch.zeros((5, 32), dtype=torch.int32)
    st = torch.zeros((32, 2048), dtype=torch.int32)
    before = lsh.hamming_topk.launches
    v, i = lsh.hamming_topk(q, st, 2000, 256, 1024, min_keep_sim=mks)
    assert v.shape == i.shape == (5, 256)
    (name, args), = fake_cuda.calls
    assert name == "fs_hamming_topk"
    assert args[4:15] == (0, 0, 5, 32, 2048, 2000, 256, 1024, h_max, 1, 0)
    assert lsh.hamming_topk.launches == before + 1


@pytest.mark.parametrize("bits,mma,route", [(1024, "s8", 0), (1024, "b1", 1),
                                            (256, None, 1), (96, None, 0),
                                            (2048, None, 1), (800, "s8", 0)])
def test_hamming_wrapper_routes(fake_cuda, bits, mma, route):
    """The route the kernel is asked for: the default takes b1 where bits
    is a multiple of 256 and s8 elsewhere; an explicit route is kept."""
    w = bits // 32
    q = torch.zeros((3, w), dtype=torch.int32)
    st = torch.zeros((w, 600), dtype=torch.int32)
    lsh.hamming_topk(q, st, 600, 16, bits, mma=mma)
    (name, args), = fake_cuda.calls
    assert args[13] == route


def test_hamming_wrapper_refuses_bad_routes(fake_cuda):
    q = torch.zeros((3, 3), dtype=torch.int32)
    st = torch.zeros((3, 600), dtype=torch.int32)
    with pytest.raises(ValueError, match="mma"):
        lsh.hamming_topk(q, st, 600, 16, 96, mma="b1")
    with pytest.raises(ValueError, match="mma"):
        lsh.hamming_topk(q, st, 600, 16, 96, mma="int4")
    assert not fake_cuda.calls


@pytest.mark.parametrize("mma", ["s8", "b1"])
def test_plain_hamming_ignores_the_route(rng, mma):
    """On the CPU both routes run the plain version: the same slots."""
    q, st = _world(rng, 256)
    want = _jax_hamming(q, st, 1000, 32, 256)
    v, i = lsh.hamming_topk(_t(q), _t(st), 1000, 32, 256, mma=mma)
    assert np.array_equal(v.numpy(), want[0]) and np.array_equal(i.numpy(), want[1])


def test_hamming_wrapper_rejects_bad_arguments(monkeypatch):
    q = torch.zeros((4, 8), dtype=torch.int32)
    st = torch.zeros((8, 512), dtype=torch.int32)
    for args in ((q.long(), st, 512, 16, 256), (q, st.long(), 512, 16, 256),
                 (q, st, 512, 16, 288), (q, st, 512, 16, 250),
                 (q, st, 513, 16, 256), (q, st, 512, 0, 256),
                 (q[:, :7], st, 512, 16, 256)):
        with pytest.raises(ValueError):
            lsh.hamming_topk(*args)
    # the kernel's own limit, checked before any launch: the JAX package's
    # packing holds bits <= 8192
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    q2 = torch.zeros((4, 257), dtype=torch.int32)
    with pytest.raises(ValueError, match="bits <= 8192"):
        lsh.hamming_topk(q2, torch.zeros((257, 512), dtype=torch.int32), 512, 16, 8224)
    assert not lib.calls


@pytest.mark.parametrize("nq,bits,r,mma,route,rows,launches", [
    (4, 256, 1025, None, 1, 0, 1),         # R above 1024: the same launch
    (4, 2080, 16, None, 0, 64, 1),         # wide codes on s8: a histogram scratch
    (5000, 4096, 2048, None, 1, 4096, 2),  # wide on b1, rows in two chunks
    (100, 8192, 300, "s8", 0, 128, 1),
])
def test_hamming_wrapper_wide_codes_and_long_lists(fake_cuda, nq, bits, r, mma, route, rows,
                                                   launches):
    """bits up to 8192 and any R reach K6: codes wider than 2048 bits pass
    an int32 [rows, h_max + 1] scratch and its row count, and the launch
    counter grows by the launches the kernel walks the rows in."""
    w = bits // 32
    q = torch.zeros((nq, w), dtype=torch.int32)
    st = torch.zeros((w, 3000), dtype=torch.int32)
    before = lsh.hamming_topk.launches
    v, i = lsh.hamming_topk(q, st, 2999, r, bits, mma=mma)
    assert v.shape == i.shape == (nq, r)
    (name, args), = fake_cuda.calls
    assert name == "fs_hamming_topk"
    assert (args[4] != 0) == (rows > 0) and args[5] == rows
    assert args[6:14] == (nq, w, 3000, 2999, r, bits, bits, route)
    assert lsh.hamming_topk.launches == before + launches


def test_attach_refuses_k_above_rerank():
    eng = SimpleNamespace(cfg=SimpleNamespace(search=SimpleNamespace(k=300)))
    with pytest.raises(ValueError, match="cannot exceed the LSH rerank"):
        lsh.attach_lsh_prefilter(eng, PortLSHConfig())
