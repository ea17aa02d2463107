"""The attention kernels' head_dim 256 instances (Gemma) on a card: the
flash kernel (dense and paged, fp32 and int8) at the main path's shapes
(the tree-verify past half, decode, causal prefill, a long cache, and
RecurrentGemma's windowed MQA local attention) against its plain version, each row of a batch against a B = 1 call, and the
paged kernels bit for bit against the dense kernels on the gathered view.
The tree kernel's head_dim 256 cases are in ``test_torch_tree_cuda.py``.
Every test here is marked ``cuda_kernel`` and skips on a host without a
card.  The file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_hd256_cuda.py

Tolerances (``chip_smoke.py``'s, as at head_dim 128): against the plain
version 1e-4 absolute and 1e-5 relative.
"""
import pytest
import torch

from repro_torch.kernels import flash, paged, quant, tree_block
from repro_torch.models import paging

HD = 256
PAGE = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode; test_torch_hd256.py holds the plain versions at "
                    "head_dim 256 to the JAX package)")
    return torch.device("cuda")


def _kv(cuda, b, length, kvh, int8, gen):
    """K/V as [B,KV,L,HD] views of [B,L,KV,HD] caches (int8 with [B,KV,L]
    scale views)."""
    out = {}
    for name in ("k", "v"):
        x = torch.randn(b, length, kvh, HD, generator=gen).to(cuda)
        if int8:
            x, sc = quant.quantize_rows(x)
            out[name + "_scale"] = sc.transpose(1, 2)
        out[name] = x.transpose(1, 2)
    return out


def _scales(d):
    return {k: d[k] for k in ("k_scale", "v_scale") if k in d}


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n,causal,length", [
    (8, False, 512),       # the tree-verify past half (Gemma: 16 heads)
    (1, False, 512),       # decode
    (70, True, 70),        # causal prefill of a prompt
    (8, False, 6144),      # a long cache: 96 chunks
])
def test_flash_hd256_matches_plain_and_rows_alone(cuda, int8, n, causal,
                                                  length):
    b, h, kvh = 3, 16, 16
    gen = torch.Generator().manual_seed(n + length)
    q = torch.randn(b, h, n, HD, generator=gen).to(cuda)
    kv = _kv(cuda, b, length, kvh, int8, gen)
    kvl = torch.tensor([length if causal else length - 312, 1,
                        length // 2], dtype=torch.int32, device=cuda)
    qpos = (((kvl.long() - 1)[:, None] + torch.arange(n, device=cuda) // 2)
            if not causal else torch.arange(n, device=cuda).expand(b, n))
    qpos = qpos.to(torch.int32).contiguous()
    sc = _scales(kv)
    got = flash.flash_attention_lse(q, kv["k"], kv["v"], kvl, qpos,
                                    causal=causal, **sc)
    want = flash.flash_attention_lse_plain(q, kv["k"], kv["v"], kvl, qpos,
                                           scale=HD ** -0.5, causal=causal,
                                           **sc)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    for r in range(b):
        alone = flash.flash_attention_lse(
            q[r:r + 1], kv["k"][r:r + 1], kv["v"][r:r + 1], kvl[r:r + 1],
            qpos[r:r + 1], causal=causal,
            **{k: x[r:r + 1] for k, x in sc.items()})
        for g, a in zip(got, alone):
            assert torch.equal(g[r], a[0])


def _pools(dense, rows, gen):
    """Shuffled paged copies of [B,KV,L,...] views backing ``rows[b]``
    logical rows each: ({name: pool view [Nb,KV,page,...]}, table)."""
    b, length = dense["k"].shape[0], dense["k"].shape[2]
    mb = paging.n_blocks(length, PAGE)
    need = [paging.n_blocks(r, PAGE) for r in rows]
    ids = 1 + torch.randperm(sum(need), generator=gen)
    table = torch.zeros(b, mb, dtype=torch.int32)
    i = 0
    for row, c in enumerate(need):
        table[row, :c] = ids[i:i + c]
        i += c
    table = table.to(dense["k"].device)
    pools = {}
    for name, x in dense.items():
        p = paging.make_paged(x.transpose(1, 2).contiguous(), table, PAGE)
        pools[name] = paging.pool_view(p.pages, PAGE)
    return pools, table


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n", [8, 1])
def test_paged_flash_hd256_equals_dense(cuda, int8, n):
    """Bucket 3 on 16-row pages: the paged flash kernel against its plain
    version and, bit for bit, the dense kernel on the gathered view."""
    b, h, kvh, length = 3, 16, 16, 512
    kv_len = (90, 200, 130)
    gen = torch.Generator().manual_seed(11 + n)
    q = torch.randn(b, h, n, HD, generator=gen).to(cuda)
    kv = _kv(cuda, b, length, kvh, int8, gen)
    pools, table = _pools(kv, kv_len, torch.Generator().manual_seed(2))
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    qpos = ((kvl.long() - 1)[:, None] + torch.arange(n, device=cuda) // 2
            ).to(torch.int32)
    psc = _scales(pools)
    got = paged.paged_flash_attention_lse(q, pools["k"], pools["v"], table,
                                          kvl, qpos, **psc)
    want = paged.paged_flash_attention_lse_plain(
        q, pools["k"], pools["v"], table, kvl, qpos, scale=HD ** -0.5, **psc)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    dense = {k: paged.gather_pool(v, table, length) for k, v in pools.items()}
    ref = flash.flash_attention_lse(q, dense["k"], dense["v"], kvl, qpos,
                                    **_scales(dense))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("int8", [False, True])
def test_paged_tree_hd256_equals_dense(cuda, int8):
    """T = 105 (two double-buffered stages at head_dim 256 and more) on
    16-row pages: against the plain version and the dense kernel."""
    b, h, kvh, n, t = 3, 16, 16, 8, 105
    gen = torch.Generator().manual_seed(21)
    q = torch.randn(b, h, n, HD, generator=gen).to(cuda)
    kv = _kv(cuda, b, t, kvh, int8, gen)
    mask = (torch.rand(b, n, t, generator=gen) < 0.3).to(cuda)
    mask[:, :, 0] = True
    mask[:, -1] = False
    pools, table = _pools(kv, (t, t, t), torch.Generator().manual_seed(4))
    psc = _scales(pools)
    got = paged.paged_tree_block_attention(q, pools["k"], pools["v"], table,
                                           mask, **psc)
    want = paged.paged_tree_block_attention_plain(
        q, pools["k"], pools["v"], table, mask, scale=HD ** -0.5, **psc)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    dense = {k: paged.gather_pool(v, table, t) for k, v in pools.items()}
    ref = tree_block.tree_block_attention(q, dense["k"], dense["v"], mask,
                                          **_scales(dense))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# RecurrentGemma's local attention (16 query heads over one KV head,
# window 8 at its smoke size and 2048 published): decode at kv_len - 1,
# and causal query runs whose 4-query tiles straddle the window edge
WINDOW_CASES = [
    # n, length, kv_len, first query position (None: decode), window
    (1, 48, (40, 17), None, 8),
    (12, 48, (48, 30), (36, 18), 8),
    (1, 4096, (3000, 2112), None, 2048),
    (64, 2112, (2112, 2100), (2048, 2036), 2048),
]


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("n,length,kv_len,q0,window", WINDOW_CASES)
def test_flash_hd256_window_mqa_matches_plain_and_rows_alone(
        cuda, n, length, kv_len, q0, window):
    b, h, kvh = 2, 16, 1
    gen = torch.Generator().manual_seed(n + length + window)
    q = torch.randn(b, h, n, HD, generator=gen).to(cuda)
    kv = _kv(cuda, b, length, kvh, False, gen)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    causal = q0 is not None
    qpos = ((kvl.long() - 1)[:, None] if q0 is None else
            torch.tensor(q0, device=cuda)[:, None]
            + torch.arange(n, device=cuda))
    qpos = qpos.to(torch.int32).contiguous()
    got = flash.flash_attention_lse(q, kv["k"], kv["v"], kvl, qpos,
                                    causal=causal, window=window)
    want = flash.flash_attention_lse_plain(q, kv["k"], kv["v"], kvl, qpos,
                                           scale=HD ** -0.5, causal=causal,
                                           window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    for r in range(b):
        alone = flash.flash_attention_lse(
            q[r:r + 1], kv["k"][r:r + 1], kv["v"][r:r + 1], kvl[r:r + 1],
            qpos[r:r + 1], causal=causal, window=window)
        for g, a in zip(got, alone):
            assert torch.equal(g[r], a[0])
