"""K3 scan and the compactions built on it: the port against the JAX package.

Tolerance: 0.  Every value is an integer (or a gathered f32 score), so
every comparison is exact (np.array_equal).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fandom_search_tpu.ops.scan import scan1d_i32 as jax_scan
from fandom_search_tpu.search.engine import (
    compact_candidates as jax_compact_candidates,
    nonzero_compact as jax_nonzero_compact,
)
from fandom_search_tpu_torch.ops.scan import scan1d_i32
from fandom_search_tpu_torch.search.engine import (
    compact_candidates,
    nonzero_compact,
)

# ragged tails around the Pallas kernel's 512x128 tile and the CUDA
# kernel's 1024-element chunk
SIZES = [1, 7, 1023, 1025, 65537]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", ["add", "max"])
def test_plain_scan_matches_pallas_interpret(rng, n, op):
    x = rng.integers(-1000, 1000, size=n).astype(np.int32)
    got = scan1d_i32(torch.from_numpy(x), op).numpy()
    want = np.asarray(jax_scan(jnp.asarray(x), op, interpret=True))
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def test_scan_empty_and_bad_op():
    assert scan1d_i32(torch.zeros(0, dtype=torch.int32)).shape == (0,)
    with pytest.raises(ValueError):
        scan1d_i32(torch.zeros(4, dtype=torch.int32), "min")
    with pytest.raises(ValueError):
        scan1d_i32(torch.zeros(4, dtype=torch.int64))


@pytest.mark.parametrize(
    "frac,size", [(0.0, 64), (0.01, 128), (0.5, 4096), (1.0, 512), (0.5, 100)]
)
def test_nonzero_compact_matches_jax(rng, frac, size):
    mask = rng.random(4096) < frac
    got = nonzero_compact(torch.from_numpy(mask), size).numpy()
    want = np.asarray(jax_nonzero_compact(jnp.asarray(mask), size))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("max_out", [4, 64, 2048])
def test_compact_candidates_matches_jax(rng, max_out):
    """Includes budget overflow: true counts above max_out keep the
    first max_out candidates in row-major order and report the count."""
    nq, k, ns = 3000, 10, 500
    vals = (rng.integers(-600, 700, size=(nq, k)) / 128).astype(np.float32)
    vals = -np.sort(-vals, axis=1)
    idx = rng.integers(0, ns + 50, size=(nq, k)).astype(np.int32)
    got = compact_candidates(
        torch.from_numpy(vals), torch.from_numpy(idx), 3.5, ns, k, max_out
    )
    want = jax_compact_candidates(
        jnp.asarray(vals), jnp.asarray(idx), 3.5, ns, k, max_out
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[3]) > 4  # the smallest budget overflows


# ragged sizes around the CUDA kernel's 4096-element chunk; sizes above
# n, below the count (overflow) and all-true masks
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 12289])
@pytest.mark.parametrize("frac,size", [(0.3, 5000), (1.0, 64), (1.0, 20000),
                                       (0.02, 1), (0.0, 3)])
def test_nonzero_compact_ragged_matches_jax(rng, n, frac, size):
    mask = rng.random(n) < frac
    got = nonzero_compact(torch.from_numpy(mask), size).numpy()
    want = np.asarray(jax_nonzero_compact(jnp.asarray(mask), size))
    assert got.dtype == np.int32 and got.shape == (size,)
    assert np.array_equal(got, want)


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
    """CPU tensors take the kernel route, into a fake library; the plain
    versions raise, so a "CUDA" tensor never reaches them."""
    from fandom_search_tpu_torch.ops import _cuda
    from fandom_search_tpu_torch.ops import scan as scan_mod

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor took the plain route")

    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(scan_mod, "scan1d_i32_plain", plain)
    monkeypatch.setattr(scan_mod, "nonzero_compact_plain", plain)
    return lib


@pytest.mark.parametrize("op,code", [("add", 0), ("max", 1)])
def test_scan_wrapper_is_one_launch(fake_cuda, op, code):
    x = torch.zeros(5000, dtype=torch.int32)
    before = scan1d_i32.launches
    out = scan1d_i32(x, op)
    assert out.shape == (5000,) and out.dtype == torch.int32
    (name, args), = fake_cuda.calls
    assert name == "fs_scan"
    assert args[0] == x.data_ptr() and args[1] == out.data_ptr()
    assert args[3:] == (5000, code, 4096, 0)
    assert scan1d_i32.launches == before + 1
    # the scratch words are reused, with no reset, by the next call
    scan1d_i32(x, op)
    assert fake_cuda.calls[1][1][2] == args[2]


def test_compact_wrapper_is_one_launch(fake_cuda):
    mask = torch.zeros((300, 10), dtype=torch.bool)
    before = scan1d_i32.launches
    out = nonzero_compact(mask, 777)
    assert out.shape == (777,) and out.dtype == torch.int32
    (name, args), = fake_cuda.calls
    assert name == "fs_compact"
    assert args[0] == mask.data_ptr() and args[1] == out.data_ptr()
    assert args[3:] == (3000, 777, 4096, 0)
    assert scan1d_i32.launches == before + 1


def test_wrappers_refuse_what_the_kernel_does_not_take(fake_cuda):
    with pytest.raises(ValueError, match="bool"):
        nonzero_compact(torch.zeros(8, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="contiguous"):
        nonzero_compact(torch.zeros((4, 4), dtype=torch.bool).T, 4)
    with pytest.raises(ValueError, match="contiguous"):
        scan1d_i32(torch.zeros(8, dtype=torch.int32)[::2])
    with pytest.raises(ValueError, match="size"):
        nonzero_compact(torch.zeros(8, dtype=torch.bool), -1)
    # nothing to compute: no launch
    assert nonzero_compact(torch.zeros(8, dtype=torch.bool), 0).shape == (0,)
    assert scan1d_i32(torch.zeros(0, dtype=torch.int32)).shape == (0,)
    assert not fake_cuda.calls
