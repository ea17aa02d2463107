"""The tree attention wrappers' merged mode (``past=``: the committed-prefix
half handed to the tree kernel, whose epilogue merges the two halves on a
card) in its plain version: bit-equal to ``combine_lse`` over the two
halves, the same call as the ``ops`` entry points, and within 1e-5 of the
JAX package's two-level attention (the jnp oracle for the dense caches,
the Pallas paged kernels in interpret mode for the paged ones), in fp32
and int8, on the same numpy inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash, ops, paged, tree_block

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU thread pool and XLA's contend in one process
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kv(rng, b, kvh, length, hd, int8):
    """K, V [B, KV, L, hd] (int8 with [B, KV, L] scales when ``int8``)."""
    out = {}
    for name in ("k", "v"):
        if int8:
            out[name] = rng.integers(-127, 128, size=(b, kvh, length, hd)
                                     ).astype(np.int8)
            out[name + "_scale"] = (rng.random((b, kvh, length)) * 0.02
                                    + 1e-3).astype(np.float32)
        else:
            out[name] = rng.normal(size=(b, kvh, length, hd)).astype(
                np.float32)
    return out


def _mask(rng, b, n, t):
    mask = rng.random((b, n, t)) > 0.5
    mask[:, :, 0] = True                   # every row sees the root
    return mask


def _sc(d, prefix=""):
    """The int8 scales of ``d`` as keyword arguments (``prefix`` "t" for
    the tree half of the ops entry points: kt_scale, vt_scale)."""
    return {k[0] + prefix + k[1:]: d[k] for k in ("k_scale", "v_scale")
            if k in d}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("past_len", [[30, 0, 45], [7]])
def test_merged_tree_attention_dense(int8, past_len):
    rng = np.random.default_rng(len(past_len) + 2 * int8)
    b, h, kvh, n, hd, lmax, t = len(past_len), 4, 2, 6, 32, 48, 20
    q = torch.from_numpy(rng.normal(size=(b, h, n, hd)).astype(np.float32))
    past_kv = {k: torch.from_numpy(x) for k, x in
               _kv(rng, b, kvh, lmax, hd, int8).items()}
    tree_kv = {k: torch.from_numpy(x) for k, x in
               _kv(rng, b, kvh, t, hd, int8).items()}
    mask = torch.from_numpy(_mask(rng, b, n, t))
    plen = torch.tensor(past_len, dtype=torch.int32)
    past = flash.flash_attention_lse(q, past_kv["k"], past_kv["v"], plen,
                                     **_sc(past_kv))
    tree = tree_block.tree_block_attention(q, tree_kv["k"], tree_kv["v"],
                                           mask, **_sc(tree_kv))
    merged = tree_block.tree_block_attention(
        q, tree_kv["k"], tree_kv["v"], mask, past=past, **_sc(tree_kv))
    assert torch.equal(merged, tree_block.combine_lse([past, tree]))
    entry = ops.tree_attention(q, past_kv["k"], past_kv["v"], tree_kv["k"],
                               tree_kv["v"], mask, plen, **_sc(past_kv),
                               **_sc(tree_kv, "t"))
    assert torch.equal(entry, merged)
    args = [jnp.asarray(x.numpy()) for x in
            (q, past_kv["k"], past_kv["v"], tree_kv["k"], tree_kv["v"],
             mask, plen)]
    if int8:
        want = jref.tree_attention_quant_ref(
            *args, k_scale=jnp.asarray(past_kv["k_scale"].numpy()),
            v_scale=jnp.asarray(past_kv["v_scale"].numpy()),
            kt_scale=jnp.asarray(tree_kv["k_scale"].numpy()),
            vt_scale=jnp.asarray(tree_kv["v_scale"].numpy()))
    else:
        want = jref.tree_attention_ref(*args)
    np.testing.assert_allclose(merged.numpy(), np.asarray(want), **TOL)


def _blocked(dense, page, rows, seed):
    """[B, KV, L, ...] -> ([Nb, KV, page, ...] pool, [B, mb] table): row
    b's first ``rows[b]`` logical rows in shuffled physical blocks, the
    rest of its table on the null block (whose rows are noise)."""
    b, kvh, length = dense.shape[:3]
    mb = -(-length // page)
    need = [-(-r // page) for r in rows]
    rng = np.random.default_rng(seed)
    ids = 1 + rng.permutation(sum(need))
    pool = rng.normal(size=(1 + sum(need), kvh, page, *dense.shape[3:]))
    pool = pool.astype(dense.dtype)
    table = np.zeros((b, mb), np.int32)
    i = 0
    for bb in range(b):
        for j in range(need[bb]):
            chunk = dense[bb, :, j * page:(j + 1) * page]
            pool[ids[i], :, :chunk.shape[1]] = chunk
            table[bb, j] = ids[i]
            i += 1
    return pool, table


@pytest.mark.parametrize("int8", [False, True])
def test_merged_tree_attention_paged(int8):
    """T = 13 over pages of 8 (the last block's tail past T); the merged
    paged wrapper against combine_lse, ops.paged_tree_attention and the
    JAX Pallas paged path."""
    rng = np.random.default_rng(51 + int8)
    b, h, kvh, n, hd, page, lmax, t = 2, 4, 2, 4, 32, 8, 32, 13
    q = rng.normal(size=(b, h, n, hd)).astype(np.float32)
    plen = np.asarray([11, 30], np.int32)
    ppools, tpools, ptable, ttable = {}, {}, None, None
    for name, x in _kv(rng, b, kvh, lmax, hd, int8).items():
        ppools[name], ptable = _blocked(x, page, plen, seed=3)
    for name, x in _kv(rng, b, kvh, t, hd, int8).items():
        tpools[name], ttable = _blocked(x, page, (t, t), seed=4)
    mask = _mask(rng, b, n, t)
    tp = {k: torch.from_numpy(x) for k, x in ppools.items()}
    tt = {k: torch.from_numpy(x) for k, x in tpools.items()}
    tq = torch.from_numpy(q)
    tpt, ttt = torch.from_numpy(ptable), torch.from_numpy(ttable)
    tmask, tplen = torch.from_numpy(mask), torch.from_numpy(plen)
    past = paged.paged_flash_attention_lse(tq, tp["k"], tp["v"], tpt, tplen,
                                           **_sc(tp))
    tree = paged.paged_tree_block_attention(tq, tt["k"], tt["v"], ttt,
                                            tmask, **_sc(tt))
    merged = paged.paged_tree_block_attention(tq, tt["k"], tt["v"], ttt,
                                              tmask, past=past, **_sc(tt))
    assert torch.equal(merged, tree_block.combine_lse([past, tree]))
    kw = lambda p, s, cv: ({} if not int8 else dict(
        k_scale=cv(p["k_scale"]), v_scale=cv(p["v_scale"]),
        kt_scale=cv(s["k_scale"]), vt_scale=cv(s["v_scale"])))
    entry = ops.paged_tree_attention(tq, tp["k"], tp["v"], tpt, tt["k"],
                                     tt["v"], ttt, tmask, tplen,
                                     **kw(tp, tt, lambda x: x))
    assert torch.equal(entry, merged)
    want = jops.paged_tree_attention(
        *(jnp.asarray(x) for x in (q, ppools["k"], ppools["v"], ptable,
                                   tpools["k"], tpools["v"], ttable, mask,
                                   plen)),
        **kw(ppools, tpools, jnp.asarray))
    np.testing.assert_allclose(merged.numpy(), np.asarray(want), **TOL)
