"""The mixes: deterministic by seed, the same work for every seed, and the
stated distributions."""
import json
import math

import numpy as np
import pytest

from specbench.lib import bench, traffic

MIXES = sorted(p.stem for p in (bench.HERE / "mixes").glob("*.json"))


def load(name):
    return json.loads((bench.HERE / "mixes" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = load(name)
    a = traffic.requests(mix, 2 ** 31 + 17, 152064)
    b = traffic.requests(mix, 2 ** 31 + 17, 152064)
    assert len(a) == mix["requests"]
    for x, y in zip(a, b):
        assert x.max_new_tokens == y.max_new_tokens
        assert np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_serves_the_same_work(name):
    """Every seed sends the same (prompt, output) lengths in the same order,
    each block of them the distribution's quantiles; the seed changes the
    token ids."""
    mix = load(name)
    a = traffic.requests(mix, 1, 1000)
    b = traffic.requests(mix, 2 ** 32 + 5, 1000)
    assert [(len(r.prompt), r.max_new_tokens) for r in a] == \
        [(len(r.prompt), r.max_new_tokens) for r in b]
    k, want = mix["block"], sorted(map(tuple, traffic.block_pairs(mix)))
    fresh, _ = traffic.drawn(mix, 1, 1000)
    for s in range(0, mix["requests"], k):
        assert sorted((len(r.prompt), r.max_new_tokens)
                      for r in fresh[s:s + k]) == want
    assert [len(r.prompt) for r in a[:k]] != sorted(len(r.prompt)
                                                    for r in a[:k])
    assert not np.array_equal(a[0].prompt[:8], b[0].prompt[:8])


@pytest.mark.parametrize("name", MIXES)
def test_first_wave_stands_for_a_loop_in_steady_state(name):
    """Each of the first ``clients`` requests keeps a share of its output
    (the shares the quantiles (j + 0.5) / clients) and carries the rest as
    generated tokens in its prompt; later requests are as drawn."""
    mix = load(name)
    n = mix["clients"]
    warm = traffic.requests(mix, 2 ** 31 + 7, 1000)
    fresh, _ = traffic.drawn(mix, 2 ** 31 + 7, 1000)
    shares = []
    for w, f in zip(warm[:n], fresh[:n]):
        assert np.array_equal(w.prompt[:len(f.prompt)], f.prompt)
        assert len(w.prompt) + w.max_new_tokens == \
            len(f.prompt) + f.max_new_tokens
        assert 1 <= w.max_new_tokens <= f.max_new_tokens
        shares.append((w.max_new_tokens, f.max_new_tokens))
    # ceil(u * L) / L lies within 1 / L above u
    got = np.sort([keep / total for keep, total in shares])
    u = (np.arange(n) + 0.5) / n
    assert np.all(np.abs(got - u) <= 1 / min(t for _, t in shares))
    for w, f in zip(warm[n:], fresh[n:]):
        assert w.max_new_tokens == f.max_new_tokens
        assert np.array_equal(w.prompt, f.prompt)


@pytest.mark.parametrize("name", MIXES)
def test_lengths_follow_their_distributions(name):
    mix = load(name)
    pairs = traffic.block_pairs(mix)
    for col, key in ((0, "prompt_tokens"), (1, "output_tokens")):
        spec, x = mix[key], np.sort(pairs[:, col])
        assert spec["min"] <= x[0] and x[-1] <= spec["max"]
        u = (np.arange(len(x)) + 0.5) / len(x)
        if spec["dist"] == "uniform":
            want = spec["min"] + u * (spec["max"] - spec["min"])
        else:
            lo, hi = math.log(spec["min"]), math.log(spec["max"])
            want = np.exp(lo + u * (hi - lo))
        assert np.all(np.abs(x - want) <= 0.5 + 1e-9)


def test_token_ids_uniform_over_the_vocabulary():
    mix = load("db-chat")
    ids = np.concatenate([r.prompt for r in
                          traffic.requests(mix, 99, 1000)[:64]])
    assert ids.min() >= 0 and ids.max() < 1000
    counts = np.bincount(ids, minlength=1000)
    # chi-square of uniform counts: mean 999 over 999 degrees of freedom
    exp = len(ids) / 1000
    chi2 = float(((counts - exp) ** 2 / exp).sum())
    assert 850 < chi2 < 1150
