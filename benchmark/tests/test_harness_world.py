"""The generator: one world a seed, on every numpy."""

import hashlib

import numpy as np

from benchmark.harness import world

SCRIPT = {"shingles": 3000, "vocab": 2000, "zipf_a": 1.01, "words_per_line": [8, 17],
          "speakers": ["ALICE", "BOB", "CAROL"]}
CORPUS = {"works_per_call": 12, "pool_calls": 2, "quotes": {"per_work": 3, "edits": 1},
          "lengths": {"median": 300, "sigma": 1.2, "min": 100, "max": 5000}}
UNEDITED = dict(CORPUS, quotes={"per_work": 3, "edits": 0})


def _world(seed, traffic=CORPUS):
    vocab, script, ranks = world.make_script_world(seed, SCRIPT)
    return script, world.make_pool(seed, vocab, script, ranks, traffic)


def _digest(script, pool) -> str:
    h = hashlib.sha256(script.text.encode())
    for call in pool:
        for t in call.texts:
            h.update(t.encode())
    return h.hexdigest()


def test_same_seed_same_world():
    for traffic in (CORPUS, UNEDITED):
        a, b = _world(2**31 + 7, traffic), _world(2**31 + 7, traffic)
        assert _digest(*a) == _digest(*b)
        assert _digest(*a) != _digest(*_world(2**31 + 8, traffic))


def test_golden_world():
    """The world of one seed, pinned: a numpy whose draws differ fails
    here (the card's numpy runs this test too)."""
    assert _digest(*_world(12345)) == GOLDEN


def test_lengths_are_one_set_for_every_seed_and_call():
    _, p1 = _world(1)
    _, p2 = _world(2)
    sets = [np.sort(c.words) for c in p1 + p2]
    assert all((s == sets[0]).all() for s in sets)
    assert len({tuple(c.words) for c in p1 + p2}) == 4      # but in other orders
    want = world.work_lengths(12, 300, 1.2, 100, 5000)
    assert (sets[0] == np.sort(want)).all()


def test_guide_table_equals_searchsorted():
    cdf = world.folded_zipf_cdf(1.01, 3000)
    assert np.all(np.diff(cdf) > 0) and cdf[-1] == 1.0
    ranks = world.Ranks(3000, cdf)
    got = ranks.draw(np.random.default_rng(5), 200_000)
    u = np.random.default_rng(5).random(200_000)
    assert (got == np.minimum(np.searchsorted(cdf, u, side="right"), 2999)).all()


def test_folded_zipf_matches_the_folded_draw():
    """Where numpy's sampler is exact (a = 1.2: no mass near 2^53), the
    table's head ranks agree with a large numpy zipf sample."""
    cdf = world.folded_zipf_cdf(1.2, 1000)
    pmf = np.diff(np.concatenate([[0.0], cdf]))
    draws = (np.random.default_rng(0).zipf(1.2, size=2_000_000) - 1) % 1000
    emp = np.bincount(draws, minlength=1000) / len(draws)
    assert np.allclose(pmf[:5], emp[:5], rtol=0.03)


def test_folded_zipf_at_1_01_is_conditioned_on_int64():
    """At a = 1.01 numpy rejects the draws above 2^63 - 1 (64% of the
    law); the table conditions on that, so its top word takes about 2.8%
    of the words, not the unconditioned 1.0%.  numpy's float acceptance
    test also passes every proposal above 2^53, which leaves its own head
    lighter by under 15%."""
    cdf = world.folded_zipf_cdf(1.01, 30000)
    assert 0.0275 < cdf[0] < 0.0281
    draws = (np.random.default_rng(0).zipf(1.01, size=2_000_000) - 1) % 30000
    emp = np.bincount(draws, minlength=30000) / len(draws)
    assert 1.0 < cdf[0] / emp[0] < 1.15 and 1.0 < cdf[99] / emp[:100].sum() < 1.15


def test_quotes_are_script_lines():
    script, pool = _world(3, UNEDITED)
    words = set(" ".join(t for c in pool for t in c.texts).split())
    lines = [ln.split(": ", 1)[1] for ln in script.text.splitlines()]
    assert sum(ln in " ".join(pool[0].texts) for ln in lines) > 0
    assert words
    for call in pool:
        for t, n in zip(call.texts, call.words):
            assert len(t.split()) == n


GOLDEN = "f9f5fc6dc015fd4064af055698a26256196cb9421ff915de08a7ff9ca3139b9c"
