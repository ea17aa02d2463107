"""The attention kernels' plain versions at head_dim 256 (Gemma) against
the JAX package's Pallas kernels in interpret mode, on the same numpy
inputs: flash (a tree-verify past half, decode, a causal prompt), the
tree kernel, and both paged kernels, in fp32 and int8, plus the merged
tree-verify entry point, and RecurrentGemma's windowed local attention
(16 query heads over one KV head, window 8 and 2048, query tiles that
straddle the window edge) with the kernel plan's cover of it.  Small shapes (a few keys and heads at the full
head width).  Tolerance: 1e-5 (fp32 sums in another order).  The CUDA
instances at head_dim 256 are held to these plain versions on the card
(``test_torch_hd256_cuda.py``, ``test_torch_tree_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged as jpaged
from repro.kernels import ref as jref
from repro.kernels.flash import flash_attention_lse as jflash
from repro.kernels.tree_block import tree_block_attention as jtree
from repro_torch.kernels import flash, ops, paged, tree_block
from test_torch_paged_ops import _j, _kv, _pools, _t

HD = 256
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _scales(d):
    return {k: d[k] for k in ("k_scale", "v_scale") if k in d}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n,length,kv_len,causal", [
    (4, 48, (40, 17), False),      # a tree-verify past half
    (1, 48, (33, 48), False),      # decode
    (12, 12, (12, 12), True),      # a causal prompt
])
def test_flash_plain_matches_pallas_hd256(n, length, kv_len, causal, int8):
    rng = np.random.default_rng(n + length + int8)
    b, h, kvh = 2, 4, 2
    q = rng.normal(size=(b, h, n, HD)).astype(np.float32)
    kv = _kv(rng, b, kvh, length, HD, int8)
    kvl = np.asarray(kv_len, np.int32)
    qpos = (np.broadcast_to(np.arange(n), (b, n)) if causal
            else kvl[:, None] - 1 + np.arange(n) // 2)
    qpos = np.ascontiguousarray(qpos, np.int32)
    jkw = _scales(_j(kv))
    jo, jm, jl = jflash(jnp.asarray(q), jnp.asarray(kv["k"]),
                        jnp.asarray(kv["v"]), jnp.asarray(kvl),
                        jnp.asarray(qpos), causal=causal, block_k=16, **jkw)
    tkv = _t(kv)
    o, m, l = flash.flash_attention_lse(
        torch.as_tensor(q), tkv["k"], tkv["v"], torch.as_tensor(kvl),
        torch.as_tensor(qpos), causal=causal, **_scales(tkv))
    _close(o, jo)
    _close(m, np.asarray(jm)[..., 0])
    _close(l, np.asarray(jl)[..., 0])


@pytest.mark.parametrize("int8", [False, True])
def test_tree_plain_matches_pallas_hd256(int8):
    rng = np.random.default_rng(5 + int8)
    b, h, kvh, n, t = 2, 4, 2, 4, 21
    q = rng.normal(size=(b, h, n, HD)).astype(np.float32)
    kv = _kv(rng, b, kvh, t, HD, int8)
    mask = rng.random((b, n, t)) < 0.4
    mask[:, :, 0] = True
    mask[1, -1] = False                              # an empty row
    jo, jm, jl = jtree(jnp.asarray(q), jnp.asarray(kv["k"]),
                       jnp.asarray(kv["v"]), jnp.asarray(mask),
                       **_scales(_j(kv)))
    tkv = _t(kv)
    o, m, l = tree_block.tree_block_attention(
        torch.as_tensor(q), tkv["k"], tkv["v"], torch.as_tensor(mask),
        **_scales(tkv))
    _close(o, jo)
    _close(m, np.asarray(jm)[..., 0])
    _close(l, np.asarray(jl)[..., 0])


@pytest.mark.parametrize("int8", [False, True])
def test_paged_plain_matches_pallas_hd256(int8):
    """Paged flash (bucket 2, pages of 8) and the paged tree kernel
    (T = 13, the last block's tail past T) against the Pallas paged
    kernels."""
    rng = np.random.default_rng(9 + int8)
    b, h, kvh, n, page, length = 2, 4, 2, 4, 8, 32
    q = rng.normal(size=(b, h, n, HD)).astype(np.float32)
    kv = _kv(rng, b, kvh, length, HD, int8)
    kv_len = (20, 32)
    pools, table = _pools(kv, page, kv_len, seed=3)
    kvl = np.asarray(kv_len, np.int32)
    qpos = (kvl[:, None] - 1 + np.arange(n)[None] // 2).astype(np.int32)
    tp, jp = _t(pools), _j(pools)
    got = paged.paged_flash_attention_lse(
        torch.as_tensor(q), tp["k"], tp["v"], torch.as_tensor(table),
        torch.as_tensor(kvl), torch.as_tensor(qpos), **_scales(tp))
    want = jpaged.paged_flash_attention_lse(
        jnp.asarray(q), jp["k"], jp["v"], jnp.asarray(table),
        jnp.asarray(kvl), jnp.asarray(qpos), **_scales(jp))
    _close(got[0], want[0])
    _close(got[1], np.asarray(want[1])[..., 0])
    _close(got[2], np.asarray(want[2])[..., 0])

    t = 13
    tkv = _kv(rng, b, kvh, t, HD, int8)
    tpools, ttable = _pools(tkv, page, (t, t), seed=4)
    mask = rng.random((b, n, t)) > 0.4
    mask[:, :, 0] = True
    ttp, tjp = _t(tpools), _j(tpools)
    got = paged.paged_tree_block_attention(
        torch.as_tensor(q), ttp["k"], ttp["v"], torch.as_tensor(ttable),
        torch.as_tensor(mask), **_scales(ttp))
    want = jpaged.paged_tree_block_attention(
        jnp.asarray(q), tjp["k"], tjp["v"], jnp.asarray(ttable),
        jnp.asarray(mask), **_scales(tjp))
    _close(got[0], want[0])
    _close(got[1], np.asarray(want[1])[..., 0])
    _close(got[2], np.asarray(want[2])[..., 0])


def test_tree_attention_entry_point_matches_ref_hd256():
    """The merged tree-verify entry point (the flash half merged in the
    tree kernel's epilogue on the card, ``combine_lse`` here) against the
    JAX joint-softmax oracle; a row with an empty committed prefix."""
    rng = np.random.default_rng(12)
    b = 2
    q = rng.normal(size=(b, 4, 6, HD)).astype(np.float32)
    kp, vp = (rng.normal(size=(b, 2, 40, HD)).astype(np.float32)
              for _ in range(2))
    kt, vt = (rng.normal(size=(b, 2, 15, HD)).astype(np.float32)
              for _ in range(2))
    mask = rng.random((b, 6, 15)) < 0.5
    mask[:, :, 0] = True
    plen = np.asarray([33, 0], np.int32)
    want = jref.tree_attention_ref(*map(jnp.asarray,
                                        (q, kp, vp, kt, vt, mask, plen)))
    got = ops.tree_attention(*map(torch.as_tensor,
                                  (q, kp, vp, kt, vt, mask, plen)))
    _close(got, want)


# RecurrentGemma's local attention: 16 query heads over one KV head at
# head_dim 256, within a window (8 at its smoke size, 2048 published);
# queries are (prompt-like) causal runs whose tiles straddle the window
# edge, or decode steps at kv_len - 1
WINDOW_CASES = [
    # n, length, kv_len, first query position (None: decode), window
    (1, 48, (40, 17), None, 8),
    (12, 48, (48, 30), (36, 18), 8),
    (1, 2112, (2100, 2112), None, 2048),
    (64, 2112, (2112, 2100), (2048, 2036), 2048),
]


def _window_inputs(rng, n, length, kv_len, q0):
    b, h, kvh = 2, 16, 1
    q = rng.normal(size=(b, h, n, HD)).astype(np.float32)
    kv = _kv(rng, b, kvh, length, HD, False)
    kvl = np.asarray(kv_len, np.int32)
    qpos = (kvl[:, None] - 1 if q0 is None
            else np.asarray(q0)[:, None] + np.arange(n))
    return q, kv, kvl, np.ascontiguousarray(qpos, np.int32)


@pytest.mark.parametrize("n,length,kv_len,q0,window", WINDOW_CASES)
def test_flash_window_mqa_plain_matches_pallas_hd256(n, length, kv_len, q0,
                                                     window):
    """The plain version's window (keys with kpos > qpos - window, the
    reference's rule) against the Pallas kernel's, MQA 16:1; every case
    masks keys below the window.  o and m within 1e-5 absolute, l (a sum
    of up to 2048 exponentials, about 100 here) within 1e-5 relative."""
    rng = np.random.default_rng(n + length + window)
    q, kv, kvl, qpos = _window_inputs(rng, n, length, kv_len, q0)
    causal = q0 is not None
    assert (qpos - window + 1 > 0).any()       # the window cuts keys
    jo, jm, jl = jflash(jnp.asarray(q), jnp.asarray(kv["k"]),
                        jnp.asarray(kv["v"]), jnp.asarray(kvl),
                        jnp.asarray(qpos), causal=causal, window=window,
                        block_k=512 if length > 512 else 16)
    tkv = _t(kv)
    o, m, l = flash.flash_attention_lse(
        torch.as_tensor(q), tkv["k"], tkv["v"], torch.as_tensor(kvl),
        torch.as_tensor(qpos), causal=causal, window=window)
    _close(o, jo)
    _close(m, np.asarray(jm)[..., 0])
    np.testing.assert_allclose(np.asarray(l), np.asarray(jl)[..., 0],
                               rtol=1e-5, atol=0)
    if q0 is None:      # decode: the entry point the local layers call
        dec = ops.decode_attention(torch.as_tensor(q), tkv["k"], tkv["v"],
                                   torch.as_tensor(kvl), window=window)
        _close(dec, jo)


@pytest.mark.parametrize("n,length,kv_len,q0,window", WINDOW_CASES)
def test_flash_window_chunk_plan_covers_mqa_tiles(n, length, kv_len, q0,
                                                  window):
    """The kernel's plan at 16:1 (4 queries of 16 heads a CTA): each query
    tile's chunks cover every key any of its queries attends, the window's
    first key included when a tile straddles the window edge."""
    rng = np.random.default_rng(0)
    _, _, kvl, qpos = _window_inputs(rng, n, length, kv_len, q0)
    causal = q0 is not None
    valid = flash.valid_mask(2, n, length, torch.as_tensor(kvl),
                             torch.as_tensor(qpos), causal, window, "cpu")
    c, bq = flash.chunk_keys(HD), flash.queries_per_cta(16)
    assert bq == 4
    plan = flash.chunk_plan(HD, length, kvl, qpos, n, 16, causal=causal,
                            window=window)
    for b, tiles in enumerate(plan):
        for t, (lo, hi) in enumerate(tiles):
            keys = torch.nonzero(valid[b, t * bq:(t + 1) * bq].any(0))[:, 0]
            assert keys.numel()
            assert lo * c <= int(keys.min()) and int(keys.max()) < hi * c
