"""The attention kernels' plain versions at head_dim 256 (Gemma) against
the JAX package's Pallas kernels in interpret mode, on the same numpy
inputs: flash (a tree-verify past half, decode, a causal prompt), the
tree kernel, and both paged kernels, in fp32 and int8, plus the merged
tree-verify entry point.  Small shapes (a few keys and heads at the full
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
