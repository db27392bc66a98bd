"""K1 embed: the port's plain version against the JAX package.

Tolerance: 0.  Embeddings are integers, so every comparison is exact
(np.array_equal).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fandom_search_tpu.config import ShingleConfig
from fandom_search_tpu.data.hashing import derive_sign_mults
from fandom_search_tpu.data.shingler import embed_shingles_np
from fandom_search_tpu.ops.embed import embed_shingles_pallas_t
from fandom_search_tpu_torch.ops import _cuda
from fandom_search_tpu_torch.ops.embed import embed_shingles
from fandom_search_tpu_torch.ops.scan import scan1d_i32

CFG = ShingleConfig()


def _mults(cfg=CFG):
    m = derive_sign_mults(cfg.seed, cfg.n, cfg.dim).view(np.int32)
    return torch.from_numpy(m.copy())


def _port(tokens_u32, cfg=CFG):
    t = torch.from_numpy(tokens_u32.astype(np.uint32).view(np.int32).copy())
    return embed_shingles(t, _mults(cfg)).numpy()


def _tokens(rng, t_len, vocab=None):
    if vocab is None:
        return rng.integers(0, 2**32, size=t_len, dtype=np.uint64).astype(np.uint32)
    words = rng.integers(0, 2**32, size=vocab, dtype=np.uint64).astype(np.uint32)
    return words[rng.integers(0, vocab, size=t_len)]


@pytest.mark.parametrize("t_len", [0, 3, 5, 6, 7, 100, 517, 2053])
def test_plain_embed_matches_host_oracle(rng, t_len):
    toks = _tokens(rng, t_len)
    got = _port(toks)
    want = embed_shingles_np(toks, CFG)
    assert got.dtype == np.int8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("t_len", [6, 100, 2053])
def test_plain_embed_matches_pallas_interpret(rng, t_len):
    toks = _tokens(rng, t_len)
    m = t_len - CFG.n + 1
    want = np.asarray(
        embed_shingles_pallas_t(jnp.asarray(toks), CFG, interpret=True)
    ).T[:m]
    assert np.array_equal(_port(toks), want)


def test_plain_embed_repeated_words_reach_bounds(rng):
    # one word repeated: every shingle of the run embeds identically;
    # a five-word vocabulary repeats shingles throughout the rest
    toks = np.concatenate([
        np.full(40, 0xDEADBEEF, np.uint32), _tokens(rng, 300, vocab=5)
    ])
    got = _port(toks)
    assert np.array_equal(got, embed_shingles_np(toks, CFG))
    assert (got[:35] == got[0]).all()
    assert np.abs(got).max() == CFG.n


@pytest.mark.parametrize("n", [3, 6, 9])
def test_plain_embed_other_widths(rng, n):
    cfg = ShingleConfig(n=n, dim=256, seed=7)
    toks = _tokens(rng, 333)
    assert np.array_equal(_port(toks, cfg), embed_shingles_np(toks, cfg))


def test_embed_rejects_bad_dtypes():
    with pytest.raises(ValueError):
        embed_shingles(torch.zeros(10, dtype=torch.int64), _mults())
    with pytest.raises(ValueError):
        embed_shingles(torch.zeros(10, dtype=torch.int32), _mults().long())


def test_wrappers_take_plain_versions_only_on_cpu():
    """A wrapper runs its plain version only for CPU tensors; any other
    device, or a mix, raises instead of falling back."""
    meta = torch.empty(10, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        scan1d_i32(meta)
    with pytest.raises(ValueError, match="more than one device"):
        embed_shingles(meta, _mults())


def test_kernel_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda, "NVCC_FALLBACK", tmp_path / "nvcc")
    monkeypatch.setattr(_cuda, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build()


class _FakeLib:
    """Records the kernel entry points called; every launch succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("n,dim", [(6, 128), (3, 256), (9, 256), (50, 256), (1, 1024)])
def test_embed_wrapper_launches_any_width(monkeypatch, n, dim):
    """Every n >= 1 and dim the JAX config takes reach K1 in one launch
    (the multipliers stay in registers up to n = 12, in L1 above), with
    no shared-memory bound on n * dim."""
    from fandom_search_tpu_torch.ops import embed as embed_mod

    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(embed_mod, "embed_shingles_plain", None)
    tok = torch.zeros(1000, dtype=torch.int32)
    mults = _mults(ShingleConfig(n=n, dim=dim, seed=3))
    before = embed_shingles.launches
    out = embed_shingles(tok, mults)
    assert out.shape == (1000 - n + 1, dim) and out.dtype == torch.int8
    (name, args), = lib.calls
    assert name == "fs_embed"
    assert args[:3] == (tok.data_ptr(), mults.data_ptr(), out.data_ptr())
    assert args[3:] == (1000 - n + 1, n, dim, 0)
    assert embed_shingles.launches == before + 1
