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
