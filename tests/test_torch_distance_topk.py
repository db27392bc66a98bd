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
