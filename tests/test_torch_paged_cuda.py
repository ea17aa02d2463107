"""The paged attention kernels of the port on a card: each against its
plain version and against the dense kernel on the gathered view, at the
main path's shapes (the target's and the draft's tree verify at bucket 3,
decode), in fp32 and int8; and the dense flash kernel over long caches,
whose chunk merge takes its other path.  Every test here is marked ``cuda_kernel`` and
skips on a host without a card.  The file imports no JAX, so it runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_paged_cuda.py

Tolerances: against the plain version 1e-4 absolute and 1e-5 relative
(fp32 sums in another order, as for the dense kernels).  Against the
dense kernel on the gathered view the paged kernel must be bit-equal: it
runs the same tile loop in the same order, reading the same values from
other addresses.
"""
import pytest
import torch

from repro_torch.kernels import flash, paged, quant, tree_block
from repro_torch.models import paging


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode; test_torch_paged_ops.py holds their plain "
                    "versions to the JAX package)")
    return torch.device("cuda")


def _pool(dense, rows, page, gen):
    """A shuffled paged copy of ``dense`` [B, L, KV, ...]: row b backs
    ``rows[b]`` logical rows with blocks drawn in a random order, the rest
    of its table is the null block.  Returns (flat pool, table)."""
    b, length = dense.shape[:2]
    mb = paging.n_blocks(length, page)
    need = [paging.n_blocks(r, page) for r in rows]
    ids = 1 + torch.randperm(sum(need), generator=gen)
    table = torch.zeros(b, mb, dtype=torch.int32)
    i = 0
    for row, n in enumerate(need):
        table[row, :n] = ids[i:i + n]
        i += n
    p = paging.make_paged(dense, table.to(dense.device), page)
    return p.pages, p.table


def _case(cuda, b, kvh, hd, length, rows, page, seed, int8):
    """Random K/V [B, L, KV, hd] (int8 with scales when ``int8``) on the
    card, as shuffled pools viewed [Nb, KV, page, ...] sharing one table:
    ({"k", "v"[, "k_scale", "v_scale"]: pool view}, table)."""
    gen = torch.Generator().manual_seed(seed)
    dense = {}
    for name in ("k", "v"):
        x = torch.randn(b, length, kvh, hd, generator=gen).to(cuda)
        if int8:
            x, dense[name + "_scale"] = quant.quantize_rows(x)
        dense[name] = x
    pools = {}
    for name, x in dense.items():
        pool, table = _pool(x, rows, page,
                            torch.Generator().manual_seed(seed + 1))
        pools[name] = paging.pool_view(pool, page)
    return pools, table


def _scales(pools, int8):
    return ({k: pools[k] for k in ("k_scale", "v_scale")} if int8 else {})


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("h,kvh,hd,n,kv_len", [
    (64, 8, 128, 8, (90, 200, 130)),      # target tree verify, bucket 3
    (32, 8, 64, 8, (90, 200, 130)),       # draft
    (64, 8, 128, 1, (91, 201, 131)),      # decode
])
def test_paged_flash_matches_plain_and_dense(cuda, int8, h, kvh, hd, n,
                                             kv_len):
    b, length, page = 3, 512, 16
    pools, table = _case(cuda, b, kvh, hd, length, kv_len, page, 0, int8)
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(b, h, n, hd, generator=gen).to(cuda)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    qpos = (kvl.long() - 1)[:, None] + torch.arange(n, device=cuda) // 2
    qpos = qpos.to(torch.int32)
    pkw = _scales(pools, int8)
    got = paged.paged_flash_attention_lse(q, pools["k"], pools["v"], table,
                                          kvl, qpos, **pkw)
    want = paged.paged_flash_attention_lse_plain(
        q, pools["k"], pools["v"], table, kvl, qpos, scale=hd ** -0.5, **pkw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    # the dense kernel over the view gathered through the table
    dense = {k: paged.gather_pool(v, table, length)
             for k, v in pools.items()}
    dkw = _scales(dense, int8)
    ref = flash.flash_attention_lse(q, dense["k"], dense["v"], kvl, qpos,
                                    **dkw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("h,kvh,hd", [(64, 8, 128), (32, 8, 64)])
def test_paged_tree_matches_plain_and_dense(cuda, int8, h, kvh, hd):
    """T = 105 (8 stages, width 8) over pages of 16: 7 logical blocks, the
    last 7 rows of the last one past T."""
    b, t, page, n = 3, 105, 16, 8
    pools, table = _case(cuda, b, kvh, hd, t, (t, t, t), page, 1, int8)
    gen = torch.Generator().manual_seed(6)
    q = torch.randn(b, h, n, hd, generator=gen).to(cuda)
    mask = (torch.rand(b, n, t, generator=gen) < 0.3).to(cuda)
    mask[:, -1] = False                              # an empty row
    pkw = _scales(pools, int8)
    got = paged.paged_tree_block_attention(q, pools["k"], pools["v"], table,
                                           mask, **pkw)
    want = paged.paged_tree_block_attention_plain(
        q, pools["k"], pools["v"], table, mask, scale=hd ** -0.5, **pkw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    dense = {k: paged.gather_pool(v, table, t) for k, v in pools.items()}
    dkw = _scales(dense, int8)
    ref = tree_block.tree_block_attention(q, dense["k"], dense["v"], mask,
                                          **dkw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("length", [1024, 6144])
def test_flash_long_cache_matches_plain_and_rows_alone(cuda, length):
    """Caches of 16 and 96 chunks: the last CTA's merge with the chunk
    weights in shared memory, and (96 chunks at head_dim 128) the merge
    that reads them from global memory; each row equals a B = 1 call."""
    gen = torch.Generator().manual_seed(length)
    b, h, kvh, n, hd = 2, 64, 8, 8, 128
    q = torch.randn(b, h, n, hd, generator=gen).to(cuda)
    k, v = (torch.randn(b, length, kvh, hd, generator=gen).to(cuda)
            .transpose(1, 2) for _ in range(2))
    kvl = torch.tensor([length - 5, length // 3], dtype=torch.int32,
                       device=cuda)
    qpos = ((kvl.long() - 1)[:, None] + torch.arange(n, device=cuda) // 2
            ).to(torch.int32)
    got = flash.flash_attention_lse(q, k, v, kvl, qpos)
    want = flash.flash_attention_lse_plain(q, k, v, kvl, qpos,
                                           scale=hd ** -0.5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    for r in range(b):
        alone = flash.flash_attention_lse(q[r:r + 1], k[r:r + 1],
                                          v[r:r + 1], kvl[r:r + 1],
                                          qpos[r:r + 1])
        for g, a in zip(got, alone):
            assert torch.equal(g[r], a[0])
