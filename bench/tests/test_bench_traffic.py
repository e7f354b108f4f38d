"""The traffic generator: determinism per seed, the same work for every
seed, the closed loop's hand-over order."""

import bench_tiny  # noqa: F401
import numpy as np
import pytest

from benchlib import spec, streams, weights

SERVE = spec.read_json(spec.BENCH / "workloads" / "serve-longprompt.json")


def _loop(seed, traffic=SERVE, vocab=151936):
    return streams.closed_loop(traffic, seed, vocab)


def test_same_seed_same_stream():
    a, b = _loop(2**31 + 17), _loop(2**31 + 17)
    assert [(len(p), o) for p, o in a] == [(len(p), o) for p, o in b]
    assert all(np.array_equal(p, q) for (p, _), (q, _) in zip(a, b))


def test_seeds_differ_in_order_not_in_work():
    """Every block of ``clients`` requests holds the same prompt lengths
    whatever the seed, in another order; the output lengths, which set the
    schedule of admissions, come in one fixed order."""
    a, b = _loop(1), _loop(2**31 + 99)
    assert [len(p) for p, _ in a] != [len(p) for p, _ in b]
    assert [o for _, o in a] == [o for _, o in b]
    c = SERVE["clients"]
    for i in range(0, len(a), c):
        assert sorted(len(p) for p, _ in a[i:i + c]) == \
            sorted(len(p) for p, _ in b[i:i + c])
        assert sorted(o for _, o in a[i:i + c]) == list(
            np.rint(np.linspace(16, 64, c)).astype(int))


def test_lengths_within_the_mix():
    loop = _loop(5)
    assert len(loop) == SERVE["clients"] * SERVE["blocks"]
    assert min(len(p) for p, _ in loop) == SERVE["prompt_len"]["lo"]
    assert max(len(p) for p, _ in loop) == SERVE["prompt_len"]["hi"]
    assert {o for _, o in loop} <= set(range(16, 65))
    # every prompt falls in the 2,048 bucket and fits the cache
    assert all(1024 < len(p) <= 2048 for p, _ in loop)
    assert max(len(p) + o for p, o in loop) < SERVE["engine"]["max_len"]
    assert all(0 <= p.min() and p.max() < 151936 for p, _ in loop)


@pytest.mark.parametrize("dist", ["uniform", "lognormal"])
def test_other_length_laws_are_deterministic(dist):
    spec_ = {"dist": dist, "lo": 4, "hi": 48}
    a = streams.lengths(np.random.default_rng(3), spec_, 100, 8)
    b = streams.lengths(np.random.default_rng(3), spec_, 100, 8)
    assert np.array_equal(a, b) and a.min() >= 4 and a.max() <= 48


def test_shared_documents_prefix_every_prompt():
    traffic = dict(SERVE, shared_prefix={"docs": 2, "len": 64})
    loop = _loop(7, traffic, vocab=1000)
    heads = {tuple(p[:64]) for p, _ in loop}
    assert len(heads) == 2


def test_token_batches_per_step():
    a = weights.token_batch(2**31 + 3, 4, 2, 16, 500, "cpu")
    b = weights.token_batch(2**31 + 3, 4, 2, 16, 500, "cpu")
    c = weights.token_batch(2**31 + 3, 5, 2, 16, 500, "cpu")
    assert all(a[k].equal(b[k]) for k in a)
    assert not a["tokens"].equal(c["tokens"])
    assert a["tokens"][:, 1:].equal(a["labels"][:, :-1])
