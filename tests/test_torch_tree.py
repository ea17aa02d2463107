"""The port's prediction tree and speculative helpers against the JAX
package's, on the same random candidate streams (numpy, seeded).

Tree arrays (tokens, parent, depth, mask) and counters must be exactly
equal; cumulative log-probabilities are fp32 sums of the same numbers in
the same order, so they are compared exactly too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import speculative as jspec
from repro.core import tree as jtree
from repro_torch.core import speculative as spec
from repro_torch.core import tree as ttree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_tree(t, j):
    for name in ("tokens", "logprob", "parent", "depth", "mask"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    assert (t.n_nodes, t.layer_start, t.layer_size) == \
        (int(j.n_nodes), int(j.layer_start), int(j.layer_size))


def _candidates(rng, w, c, vocab, layer_size, coarse):
    tok = rng.integers(0, vocab, (w, c)).astype(np.int32)
    lp = -rng.exponential(2.0, (w, c)).astype(np.float32)
    if coarse:          # few distinct values: many exact ties in the top-w
        lp = -np.round(-lp).astype(np.float32)
    lp[layer_size:] = np.float32(jtree.NEG_INF)
    return tok, lp


@pytest.mark.parametrize("seed,w,c,capacity,coarse", [
    (0, 4, 2, 17, False), (1, 8, 4, 65, False), (2, 3, 3, 10, True),
    (3, 8, 4, 33, True)])
def test_random_streams_match_jax(seed, w, c, capacity, coarse):
    """Expand, prune on hits, restart on misses: every state equal."""
    rng = np.random.default_rng(seed)
    vocab = 7 if coarse else 50            # small vocab: repeated tokens
    t, j = ttree.tree_init(capacity, 3), jtree.tree_init(capacity, 3)
    for _ in range(9):
        ttok, tidx, tvalid, tmask = ttree.last_layer(t, w)
        jtok, jidx, jvalid, jmask = jtree.last_layer(j, w)
        for a, b in ((ttok, jtok), (tidx, jidx), (tvalid, jvalid),
                     (tmask, jmask)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        tok, lp = _candidates(rng, w, c, vocab, t.layer_size, coarse)
        t = ttree.tree_expand(t, torch.tensor(tok), torch.tensor(lp), w)
        j = jtree.tree_expand(j, jnp.asarray(tok), jnp.asarray(lp), w)
        assert_same_tree(t, j)
        assert ttree.root_argmax_child(t) == int(jtree.root_argmax_child(j))
        x = int(rng.integers(0, vocab))
        hit = ttree.find_child_with_token(t, x)
        assert hit == int(jtree.find_child_with_token(j, x))
        if rng.random() < 0.6 and hit >= 0:
            t, tmap = ttree.tree_prune_to_child(t, hit)
            j, jmap = jtree.tree_prune_to_child(j, hit)
            np.testing.assert_array_equal(tmap.numpy(), np.asarray(jmap))
            assert_same_tree(t, j)
        elif rng.random() < 0.3:
            t, j = ttree.tree_init(capacity, x), jtree.tree_init(capacity, x)


def test_expand_truncates_at_capacity_like_jax():
    t, j = ttree.tree_init(6, 1), jtree.tree_init(6, 1)
    rng = np.random.default_rng(9)
    for _ in range(3):
        tok, lp = _candidates(rng, 4, 2, 30, t.layer_size, False)
        t = ttree.tree_expand(t, torch.tensor(tok), torch.tensor(lp), 4)
        j = jtree.tree_expand(j, jnp.asarray(tok), jnp.asarray(lp), 4)
        assert_same_tree(t, j)
    assert t.n_nodes == 6


def test_draft_candidates_match_jax():
    """Per-node top-c with ties broken toward the lower token id."""
    rng = np.random.default_rng(4)
    logits = np.round(rng.normal(size=(5, 40)), 1).astype(np.float32)
    logits[:, 7] = logits[:, 3] = logits.max() + 1      # an exact tie
    valid = np.array([True, True, False, True, False])
    ttok, tlp = spec.draft_candidates(torch.tensor(logits),
                                      torch.tensor(valid), 4)
    jtok, jlp = jspec.draft_candidates(jnp.asarray(logits),
                                       jnp.asarray(valid), 4)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=0,
                               atol=1e-6)
    assert ttok[0, 0] == 3 and ttok[0, 1] == 7


def test_remap_tree_caches_matches_jax():
    """Prune compaction of capacity + w tree-cache rows."""
    rng = np.random.default_rng(2)
    cap, w, n_layers = 9, 3, 2
    index_map = np.array([-1, 0, -1, 1, 2, -1, 3, -1, -1], np.int32)
    buf = rng.normal(size=(n_layers, 1, cap + w, 2, 4)).astype(np.float32)
    jout = jspec.remap_tree_caches(
        {"stack": [{"k": jnp.asarray(buf), "v": jnp.asarray(-buf)}]},
        jnp.asarray(index_map), cap)
    tout = spec.remap_tree_caches(
        [{"k": torch.tensor(buf[i]), "v": torch.tensor(-buf[i])}
         for i in range(n_layers)], torch.tensor(index_map), cap)
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            np.stack([c[name].numpy() for c in tout]),
            np.asarray(jout["stack"][0][name]))


@pytest.mark.parametrize("temperature,top_k,top_p", [(0.0, 0, 1.0),
                                                     (0.7, 5, 0.9)])
def test_select_token(temperature, top_k, top_p):
    """Greedy picks the first maximum (as jnp.argmax); sampling stays in
    the top-k / top-p support."""
    logits = torch.tensor([0.5, 2.0, 2.0, -1.0, 1.9, 0.0])
    sp = spec.SamplingParams(temperature=temperature, top_k=top_k,
                             top_p=top_p)
    gen = torch.Generator().manual_seed(0)
    picks = {spec.select_token(logits, sp, gen) for _ in range(50)}
    if temperature == 0.0:
        assert picks == {int(jnp.argmax(jnp.asarray(logits.numpy())))} == {1}
    else:
        assert picks <= {0, 1, 2, 4, 5} and len(picks) > 1
