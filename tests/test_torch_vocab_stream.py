"""The port's u16 stream compression against the JAX package.

Tolerance: 0.  ``StreamVocab`` runs the sequences of
tests/test_vocab_stream.py on both packages and every table, id, patch
and count compares exactly; ``_decode_stream`` compares bit for bit with
the JAX ``_decode_stream_jit`` on the same upload; engine rows and the
CLI's CSV compare field by field (rounded scores included) with the JAX
engine's and CLI's, with ``use_pallas=False`` / ``--no-pallas`` on the
JAX side as in tests/test_vocab_stream.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fandom_search_tpu import cli as jcli
from fandom_search_tpu.config import PipelineConfig
from fandom_search_tpu.data import fast_tokenizer as jfast
from fandom_search_tpu.data.script_parser import parse_script
from fandom_search_tpu.search import vocab_stream as jvs
from fandom_search_tpu.search.engine import SearchEngine as JaxEngine
from fandom_search_tpu.search.engine import _decode_stream_jit
from fandom_search_tpu.search.index import build_script_index
from fandom_search_tpu.utils import jit_cache
from fandom_search_tpu.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)
from fandom_search_tpu_torch import cli
from fandom_search_tpu_torch.config import PipelineConfig as PortConfig
from fandom_search_tpu_torch.data import fast_tokenizer
from fandom_search_tpu_torch.search import vocab_stream as vs
from fandom_search_tpu_torch.search.engine import (
    EncodedBatch,
    SearchEngine,
    _decode_stream,
)

BATCH = 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_state(a, b):
    """Two StreamVocabs hold the same table, lookup shadow and probe table."""
    assert (a.size, a.version, a.ready) == (b.size, b.version, b.ready)
    for f in ("_hashes", "_sorted", "_order", "_pk", "_pv"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert np.array_equal(a.table(), b.table())


def _same_encoding(got, want):
    for x, y in zip(got[:3], want[:3]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert got[3] == want[3]


def _seq_bootstrap(rng, v):
    first = rng.integers(1, 2**32, 5000, dtype=np.uint32)
    v.bootstrap(first)
    return [v.encode(first)]


def _seq_misses(rng, v):
    v.bootstrap(rng.integers(1, 2**20, 1000, dtype=np.uint32))
    stream = np.concatenate([rng.integers(1, 2**20, 500, dtype=np.uint32),
                             rng.integers(2**24, 2**32, 500, dtype=np.uint32)])
    rng.shuffle(stream)
    out = [v.encode(stream)]
    v.admit(out[0][2])           # the engine admits an encoded batch's misses
    out.append(v.encode(stream))
    return out


def _seq_ids_stable(rng, v):
    base = rng.integers(1, 2**31, 3000, dtype=np.uint32)
    v.bootstrap(base)
    out = [v.encode(base)]
    v.admit(np.array([1, 2, 3, 2**32 - 5, 2**32 - 4], dtype=np.uint32))
    out.append(v.encode(base))
    assert np.array_equal(out[0][0], out[1][0])
    return out


def _seq_capacity(rng, v):
    uniq = rng.permutation(np.arange(1, vs.CAPACITY + 2000, dtype=np.uint32))
    heavy = uniq[:100]
    stream = np.concatenate([np.repeat(heavy, 50), uniq])
    rng.shuffle(stream)
    v.bootstrap(stream)
    assert v.size == vs.CAPACITY
    out = [v.encode(heavy)]
    v.admit(np.array([2**32 - 1], dtype=np.uint32))   # a no-op at capacity
    v.admit_counted(stream[:1000])
    return out


def _seq_zero_pad(rng, v):
    v.bootstrap(np.array([7, 9, 11], dtype=np.uint32))
    out = [v.encode(np.zeros(64, np.uint32))]
    assert out[0][3] == 0
    return out


def _seq_heavy_miss(rng, v):
    """A raw-fallback batch: frequency admission, then the miss cap."""
    v.bootstrap(rng.integers(1, 2**16, 800, dtype=np.uint32))
    heavy = rng.integers(2**20, 2**32, 6000, dtype=np.uint32)
    out = [v.encode(heavy, miss_cap=100)]
    v.admit_counted(heavy)
    out.append(v.encode(heavy, miss_cap=100))
    return out


SEQUENCES = {
    "bootstrap": _seq_bootstrap, "misses": _seq_misses, "ids_stable": _seq_ids_stable,
    "capacity": _seq_capacity, "zero_pad": _seq_zero_pad, "heavy_miss": _seq_heavy_miss,
}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_stream_vocab_matches_jax(monkeypatch, name, native):
    """The same sequence of bootstrap / admit / encode calls on both
    packages' StreamVocab, native scan or NumPy searchsorted on both."""
    if native:
        assert fast_tokenizer.get_lib() is not None and jfast.get_lib() is not None
    else:
        monkeypatch.setattr(fast_tokenizer, "get_lib", lambda: None)
        monkeypatch.setattr(jfast, "get_lib", lambda: None)
    port, ref = vs.StreamVocab(), jvs.StreamVocab()
    got = SEQUENCES[name](np.random.default_rng(3), port)
    want = SEQUENCES[name](np.random.default_rng(3), ref)
    _same_state(port, ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_encoding(g, w)


def test_native_and_numpy_encode_agree_under_miss_cap(monkeypatch):
    """fs_encode_stream, bound by the port, and the searchsorted path give
    the same ids, patches and exact total, with and without a miss cap."""
    rng = np.random.default_rng(5)
    v = vs.StreamVocab()
    pool = rng.integers(1, 2**26, 3000, dtype=np.uint32)
    v.bootstrap(pool)
    stream = np.concatenate([rng.choice(pool, 2000).astype(np.uint32),
                             rng.integers(2**28, 2**32, 300, dtype=np.uint32)])
    rng.shuffle(stream)
    assert fast_tokenizer.get_lib() is not None
    nat = [v.encode(stream), v.encode(stream, miss_cap=77)]
    monkeypatch.setattr(fast_tokenizer, "get_lib", lambda: None)
    ref = [v.encode(stream), v.encode(stream, miss_cap=77)]
    for g, w in zip(nat, ref):
        _same_encoding(g, w)
    assert nat[1][3] == nat[0][3] > 77 and nat[1][1].size == 77


def _upload(vocab, stream, sp, p_pad):
    """The engine's compressed layout of ``stream`` (u32 [t_pad]) and the
    span table ``sp``: the SearchEngine._encode_payload packing."""
    t_pad = stream.size
    ids, mpos, mhash, total = vocab.encode(stream)
    assert 0 < total <= p_pad
    h = (t_pad + 1) // 2
    if t_pad % 2:
        ids = np.concatenate([ids, np.zeros(1, np.uint16)])
    c = np.empty(h + 2 * p_pad + 2 * (sp.size // 2), np.uint32)
    c[:h] = ids.view(np.uint32)
    c[h : h + p_pad] = t_pad
    c[h : h + mpos.size] = mpos
    c[h + p_pad : h + 2 * p_pad] = 0
    c[h + p_pad : h + p_pad + mhash.size] = mhash
    c[h + 2 * p_pad :] = sp
    return c


@pytest.mark.parametrize("t_pad", [1024, 1029, 1])
def test_decode_stream_matches_jax(t_pad):
    """Odd t_pad (a zero id packed into the last half-word), ids at and
    above 0x8000 (the arithmetic shift), pad patches (the dropped slot)."""
    rng = np.random.default_rng(t_pad)
    v = vs.StreamVocab()
    pool = np.unique(rng.integers(1, 2**31, 40_000, dtype=np.uint32))
    v.bootstrap(pool)
    assert v.size > 0x8000
    nspans, p_pad = 8, 64
    stream = np.zeros(t_pad, np.uint32)
    valid = max(1, t_pad - 50)
    stream[:valid] = rng.choice(pool, valid)
    stream[: min(20, valid)] = rng.integers(2**31, 2**32, min(20, valid), dtype=np.uint32)
    rng.shuffle(stream[:valid])
    sp = rng.integers(0, 2**32, 2 * nspans, dtype=np.uint32)
    c = _upload(v, stream, sp, p_pad)
    ids = v.encode(stream)[0]
    assert (ids[ids != vs.SENTINEL] >= 0x8000).any() or t_pad == 1
    want = np.asarray(_decode_stream_jit(jnp.asarray(c), jnp.asarray(v.table()),
                                         t_pad=t_pad, p_pad=p_pad, nspans=nspans))
    got = _decode_stream(torch.from_numpy(c.view(np.int32)),
                         torch.from_numpy(v.table().view(np.int32)),
                         t_pad=t_pad, p_pad=p_pad, nspans=nspans)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(want, np.concatenate([stream, sp]))


@pytest.fixture(scope="module")
def world2():
    """tests/test_vocab_stream.py's world2."""
    cfg = PipelineConfig()
    rng = np.random.default_rng(21)
    vocab = make_vocab(rng, 1200)
    lines = parse_script(make_script(rng, vocab, num_lines=20, words_per_line=(7, 12)))
    index = build_script_index(lines, cfg.shingle, cfg.search)
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=10, words_per_work=400,
        quotes_per_work=2, num_edits=1, vocab=vocab,
    )
    return works, index


def _cfgs(**kw):
    j, p = PipelineConfig(), PortConfig()
    return (dataclasses.replace(j, search=dataclasses.replace(j.search, **kw)),
            dataclasses.replace(p, search=dataclasses.replace(p.search, **kw)))


def _rows(rows):
    return [r.to_csv_row() for r in rows]


def test_engine_rows_with_and_without_compression_match_jax(world2):
    """Batch 1 bootstraps raw, later batches go encoded: the port's rows
    with compression equal its rows without, and the JAX engine's with
    and without."""
    works, index = world2
    jcfg, pcfg = _cfgs(batch_queries=BATCH, stream_compress=True)
    jeng = JaxEngine(index, jcfg, use_pallas=False)
    jrows, jstats = jeng.search_works(works)
    eng = SearchEngine.from_index(index, pcfg, device="cpu")
    kinds = []
    encode = eng._encode_payload
    eng._encode_payload = lambda *a: kinds.append(encode(*a)) or kinds[-1]
    rows, stats = eng.search_works(works)
    assert stats.num_batches == jstats.num_batches > 1
    assert isinstance(kinds[0], np.ndarray)                  # the bootstrap
    assert sum(isinstance(k, EncodedBatch) for k in kinds) == stats.num_batches - 1
    assert eng._venc.ready and eng._venc.version == jeng._venc.version
    assert np.array_equal(eng._venc.table(), jeng._venc.table())
    _, raw_cfg = _cfgs(batch_queries=BATCH)
    raw_rows, _ = SearchEngine.from_index(index, raw_cfg, device="cpu").search_works(works)
    assert rows and _rows(rows) == _rows(jrows) == _rows(raw_rows)
    for f in ("num_query_shingles", "num_candidates", "num_verified"):
        assert getattr(stats, f) == getattr(jstats, f), f


def test_encoded_payload_matches_jax_and_falls_back_raw(world2):
    """The port's EncodedBatch is the JAX engine's "enc" payload word for
    word; a batch whose misses pass the patch budget goes raw on both."""
    from fandom_search_tpu.data.tokenizer import Tokenized as JTokenized
    from fandom_search_tpu_torch.data.fast_tokenizer import tokenize_many
    from fandom_search_tpu_torch.data.tokenizer import Tokenized

    works, index = world2

    def payloads(items, batch):
        jcfg, pcfg = _cfgs(batch_queries=batch, stream_compress=True)
        jeng = JaxEngine(index, jcfg, use_pallas=False)
        eng = SearchEngine.from_index(index, pcfg, device="cpu")
        got = list(eng._batches(items))
        want = list(jeng._batches([(w, JTokenized(text=t.text, offsets=t.offsets, hashes=t.hashes))
                                   for w, t in items]))
        assert len(got) == len(want) > 2
        for (payload, nspans, spans, fresh), (_, jp, jspans, jfresh) in zip(got, want):
            assert (spans, fresh) == (jspans, jfresh)
            if isinstance(payload, EncodedBatch):
                assert jp[0] == "enc" and (payload.t_pad, payload.p_pad, nspans) == jp[2:]
                assert np.array_equal(payload.c_ext, jp[1])
            else:
                assert jp[0] == "raw" and np.array_equal(payload, jp[1])
        assert np.array_equal(eng._venc.table(), jeng._venc.table())
        return [isinstance(p, EncodedBatch) for p, *_ in got]

    assert payloads(sorted(tokenize_many(works).items()), BATCH)[1:] == [True] * 9
    # works of 10,000 fresh random hashes, a batch each: every batch after
    # the first misses more tokens than its 4,096-slot patch budget
    rng = np.random.default_rng(8)
    heavy = [(f"w{i}", Tokenized(text="", offsets=np.zeros((10_000, 2), np.int32),
                                 hashes=rng.integers(1, 2**32, 10_000, dtype=np.uint32)))
             for i in range(3)]
    assert payloads(heavy, 1 << 14) == [False] * 3


def test_prefilters_upload_raw(world2):
    """As on the JAX engine, the LSH and bucketed prefilters take raw
    uploads: with stream_compress on, the table never bootstraps."""
    from fandom_search_tpu_torch.config import BucketedConfig, LSHConfig
    from fandom_search_tpu_torch.ops.bucketed import attach_bucketed_prefilter
    from fandom_search_tpu_torch.ops.lsh import attach_lsh_prefilter

    works, index = world2
    _, pcfg = _cfgs(batch_queries=4096, stream_compress=True)
    _, raw = _cfgs(batch_queries=4096)
    for attach, c in ((attach_lsh_prefilter, LSHConfig()),
                      (attach_bucketed_prefilter, BucketedConfig())):
        eng = SearchEngine.from_index(index, pcfg, device="cpu")
        attach(eng, c)
        base = SearchEngine.from_index(index, raw, device="cpu")
        attach(base, c)
        assert _rows(eng.search_works(works)[0]) == _rows(base.search_works(works)[0])
        assert eng._venc is None and eng.table_uploads == 0


def test_cli_stream_compress_matches_jax(tmp_path, monkeypatch):
    """`search --stream-compress` writes the JAX CLI's CSV byte for byte."""
    monkeypatch.setattr(jit_cache, "enable_persistent_cache", lambda *a, **k: None)
    from pathlib import Path

    ex = Path(__file__).resolve().parent.parent / "examples"
    flags = ["--stream-compress", "--batch-queries", "2048"]
    assert jcli.main(["search", str(ex / "fanworks"), str(ex / "script.txt"), "-o",
                      str(tmp_path / "j.csv"), "--cpu", "--no-pallas", *flags]) == 0
    assert cli.main(["search", str(ex / "fanworks"), str(ex / "script.txt"), "-o",
                     str(tmp_path / "p.csv"), "--device", "cpu", *flags]) == 0
    assert cli.main(["search", str(ex / "fanworks"), str(ex / "script.txt"), "-o",
                     str(tmp_path / "raw.csv"), "--device", "cpu", "--batch-queries",
                     "2048"]) == 0
    got = (tmp_path / "p.csv").read_bytes()
    assert got == (tmp_path / "j.csv").read_bytes() == (tmp_path / "raw.csv").read_bytes()
    assert got.count(b"\n") > 1
