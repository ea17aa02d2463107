"""The port's paged attention (the plain versions of the two paged
kernels, the paged entry points of ``kernels.ops`` and the paged
oracles of ``kernels.ref``) against the JAX package's Pallas kernels in
interpret mode and its oracles, on the same numpy inputs: fp32 and int8
pools, per-row ``kv_len``, shuffled physical blocks, null blocks past each
row's horizon, and a tree buffer whose length is not a multiple of the
page.

Tolerances: 1e-5 absolute and relative against the JAX package (fp32
sums in another order).  Against the port's dense plain versions on the
original dense cache the paged plain versions must be bit-equal: they
gather the same values and run the same arithmetic at the same shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import paged as jpaged
from repro.kernels import ref as jref
from repro_torch.kernels import flash, ops, paged, ref, tree_block

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _blocked(dense, page, rows, seed):
    """[B, KV, L, ...] -> ([Nb, KV, page, ...] pool, [B, mb] table) with
    row b's first ``rows[b]`` logical rows in shuffled physical blocks and
    the rest of its table on the null block (whose rows are noise)."""
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


def _pools(kv, page, rows, seed):
    pools, table = {}, None
    for name, x in kv.items():
        pools[name], table = _blocked(x, page, rows, seed)
    return pools, table


def _t(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


FLASH_CASES = [  # (b, h, kv, n, hd, page, length, kv_len)
    (3, 4, 2, 4, 32, 16, 64, (20, 64, 37)),
    (2, 2, 1, 1, 32, 8, 48, (47, 9)),
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_paged_flash_plain_matches_pallas(case, int8):
    """(o, m, l) of the plain paged flash version against the Pallas
    ``paged_flash_attention_lse`` (interpret mode); and bit-equal to the
    dense plain version on the dense cache."""
    b, h, kvh, n, hd, page, length, kv_len = case
    rng = np.random.default_rng(sum(case[:5]) + int8)
    q = rng.normal(size=(b, h, n, hd)).astype(np.float32)
    kv = _kv(rng, b, kvh, length, hd, int8)
    pools, table = _pools(kv, page, kv_len, seed=7)
    kvl = np.asarray(kv_len, np.int32)
    qpos = (kvl[:, None] - 1 + np.arange(n)[None] // 2).astype(np.int32)
    tp = _t(pools)
    sc = {k: tp[k] for k in ("k_scale", "v_scale") if k in tp}
    got = paged.paged_flash_attention_lse(
        torch.as_tensor(q), tp["k"], tp["v"], torch.as_tensor(table),
        torch.as_tensor(kvl), torch.as_tensor(qpos), **sc)
    jp = _j(pools)
    jsc = {k: jp[k] for k in ("k_scale", "v_scale") if k in jp}
    want = jpaged.paged_flash_attention_lse(
        jnp.asarray(q), jp["k"], jp["v"], jnp.asarray(table),
        jnp.asarray(kvl), jnp.asarray(qpos), **jsc)
    _close(got[0], want[0])
    _close(got[1], np.asarray(want[1])[..., 0])
    _close(got[2], np.asarray(want[2])[..., 0])
    # the dense plain version on the dense cache (padded to mb * page)
    pad = table.shape[1] * page - length
    dense = _t({k: np.pad(v, [(0, 0), (0, 0), (0, pad)]
                          + [(0, 0)] * (v.ndim - 3)) for k, v in kv.items()})
    dsc = {k: dense[k] for k in ("k_scale", "v_scale") if k in dense}
    dense_got = flash.flash_attention_lse(
        torch.as_tensor(q), dense["k"], dense["v"], torch.as_tensor(kvl),
        torch.as_tensor(qpos), **dsc)
    for g, d in zip(got, dense_got):
        assert torch.equal(g, d)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_tree_plain_matches_pallas(int8):
    """T = 13 over pages of 8: the last block's tail is past T; the plain
    paged tree version against the Pallas ``paged_tree_block_attention``
    and bit-equal to the dense plain version."""
    rng = np.random.default_rng(11 + int8)
    b, h, kvh, n, hd, page, t = 2, 4, 2, 4, 32, 8, 13
    q = rng.normal(size=(b, h, n, hd)).astype(np.float32)
    kv = _kv(rng, b, kvh, t, hd, int8)
    pools, table = _pools(kv, page, (t, t), seed=8)
    mask = rng.random((b, n, t)) > 0.4
    mask[:, :, 0] = True
    mask[1, -1] = False                                  # an empty row
    tp = _t(pools)
    sc = {k: tp[k] for k in ("k_scale", "v_scale") if k in tp}
    got = paged.paged_tree_block_attention(
        torch.as_tensor(q), tp["k"], tp["v"], torch.as_tensor(table),
        torch.as_tensor(mask), **sc)
    jp = _j(pools)
    jsc = {k: jp[k] for k in ("k_scale", "v_scale") if k in jp}
    want = jpaged.paged_tree_block_attention(
        jnp.asarray(q), jp["k"], jp["v"], jnp.asarray(table),
        jnp.asarray(mask), **jsc)
    _close(got[0], want[0])
    _close(got[1], np.asarray(want[1])[..., 0])
    _close(got[2], np.asarray(want[2])[..., 0])
    dense = _t(kv)
    dsc = {k: dense[k] for k in ("k_scale", "v_scale") if k in dense}
    dense_got = tree_block.tree_block_attention(
        torch.as_tensor(q), dense["k"], dense["v"], torch.as_tensor(mask),
        **dsc)
    for g, d in zip(got, dense_got):
        assert torch.equal(g, d)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_tree_attention_entry_point(int8):
    """``ops.paged_tree_attention`` (both halves, LSE-merged) against the
    JAX package's Pallas path and its paged oracle, and the port's paged
    oracle against the JAX oracle."""
    rng = np.random.default_rng(21 + int8)
    b, h, kvh, n, hd, page, lmax, t = 2, 4, 2, 4, 32, 8, 32, 13
    q = rng.normal(size=(b, h, n, hd)).astype(np.float32)
    past = _kv(rng, b, kvh, lmax, hd, int8)
    tree = _kv(rng, b, kvh, t, hd, int8)
    plen = np.asarray([11, 30], np.int32)
    ppools, ptable = _pools(past, page, plen, seed=3)
    tpools, ttable = _pools(tree, page, (t, t), seed=4)
    mask = rng.random((b, n, t)) > 0.4
    mask[:, :, 0] = True
    args = lambda p, tp, cv: (cv(p["k"]), cv(p["v"]), cv(ptable),
                              cv(tp["k"]), cv(tp["v"]), cv(ttable),
                              cv(mask), cv(plen))
    kw = lambda p, tp, cv: ({} if not int8 else dict(
        k_scale=cv(p["k_scale"]), v_scale=cv(p["v_scale"]),
        kt_scale=cv(tp["k_scale"]), vt_scale=cv(tp["v_scale"])))
    got = ops.paged_tree_attention(torch.as_tensor(q),
                                   *args(ppools, tpools, torch.as_tensor),
                                   **kw(ppools, tpools, torch.as_tensor))
    want = jops.paged_tree_attention(jnp.asarray(q),
                                     *args(ppools, tpools, jnp.asarray),
                                     **kw(ppools, tpools, jnp.asarray))
    oracle = ref.paged_tree_attention_ref(
        torch.as_tensor(q), *args(ppools, tpools, torch.as_tensor),
        **kw(ppools, tpools, torch.as_tensor))
    joracle = jref.paged_tree_attention_ref(
        jnp.asarray(q), *args(ppools, tpools, jnp.asarray),
        **kw(ppools, tpools, jnp.asarray))
    _close(got, want)
    _close(oracle, joracle)
    _close(got, oracle)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_attention_entry_point(int8):
    """``ops.paged_decode_attention`` with per-row ``kv_len`` against the
    JAX Pallas path, row by row (the JAX entry point broadcasts
    ``kv_len - 1`` over the queries, so it takes one row at a time), and
    against the port's and the JAX package's paged oracles."""
    rng = np.random.default_rng(31 + int8)
    b, h, kvh, hd, page, lmax = 2, 4, 2, 32, 8, 40
    q = rng.normal(size=(b, h, 1, hd)).astype(np.float32)
    kv = _kv(rng, b, kvh, lmax, hd, int8)
    kvl = np.asarray([33, 7], np.int32)
    pools, table = _pools(kv, page, kvl, seed=5)
    tp, jp = _t(pools), _j(pools)
    sc = {k: tp[k] for k in ("k_scale", "v_scale") if k in tp}
    jsc = {k: jp[k] for k in ("k_scale", "v_scale") if k in jp}
    got = ops.paged_decode_attention(torch.as_tensor(q), tp["k"], tp["v"],
                                     torch.as_tensor(table),
                                     torch.as_tensor(kvl), **sc)
    for i in range(b):
        want = jops.paged_decode_attention(
            jnp.asarray(q[i:i + 1]), jp["k"], jp["v"],
            jnp.asarray(table[i:i + 1]), int(kvl[i]), **jsc)
        _close(got[i:i + 1], want)
    oracle = ref.paged_decode_attention_ref(
        torch.as_tensor(q), tp["k"], tp["v"], torch.as_tensor(table),
        torch.as_tensor(kvl), **sc)
    joracle = jref.paged_decode_attention_ref(
        jnp.asarray(q), jp["k"], jp["v"], jnp.asarray(table),
        jnp.asarray(kvl), **jsc)
    _close(oracle, joracle)
    _close(got, oracle)


def test_gather_pool_matches_jax_gather_ref():
    rng = np.random.default_rng(41)
    kv = _kv(rng, 2, 3, 32, 8, False)
    pools, table = _pools(kv, 8, (32, 17), seed=6)
    for name in ("k", "v"):
        got = paged.gather_pool(torch.as_tensor(pools[name]),
                                torch.as_tensor(table), 32)
        want = jref.paged_gather_ref(jnp.asarray(pools[name]),
                                     jnp.asarray(table), 32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            ref.paged_gather_ref(torch.as_tensor(pools[name]),
                                 torch.as_tensor(table), 32).numpy(),
            np.asarray(want))
