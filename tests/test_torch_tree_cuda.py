"""The tree attention kernel of the port on a card, in its four modes
(dense and paged, fp32 and int8) and its merge epilogue: against the plain
version over tree buffers of one wave and of several stages, each row of a
B = 3 call against a B = 1 call, the paged kernel against the dense kernel
on the gathered view, and the merged mode against ``combine_lse`` over the
kernel's own two halves.  Every test here is marked ``cuda_kernel`` and
skips on a host without a card.  The file imports no JAX, so it runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_tree_cuda.py

Tolerances (``chip_smoke.py``'s): against the plain version o 1e-4
absolute, m 1e-5 relative to max(|m|, 1) and l 1e-4 relative (fp32 sums
in another order; 3xTF32 products carry about 21 bits of each fp32
product).  Bit for bit: a row alone against the same row in a batch (a
row's plan and sums depend on its own keys only), paged against dense
(the same plan reading the same values from other addresses), and the
merged output against ``combine_lse`` over the kernel's standalone halves
(the epilogue repeats its arithmetic, step for step).
"""
import pytest
import torch

from repro_torch.kernels import flash, paged, quant, tree_block
from repro_torch.models import paging

PAGE = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode; test_torch_tree_plan.py and "
                    "test_torch_tree_merge.py hold the plan and the plain "
                    "versions)")
    return torch.device("cuda")


def _case(cuda, b, kvh, rep, n, hd, t, int8, seed):
    """q [B,H,n,hd], K/V as [B,KV,T,hd] views of [B,T,KV,hd] caches (int8
    with [B,KV,T] scale views), and a [B,n,T] mask with an empty row."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, kvh * rep, n, hd, generator=gen).to(cuda)
    kv = {}
    for name in ("k", "v"):
        x = torch.randn(b, t, kvh, hd, generator=gen).to(cuda)
        if int8:
            x, sc = quant.quantize_rows(x)
            kv[name + "_scale"] = sc.transpose(1, 2)
        kv[name] = x.transpose(1, 2)
    mask = (torch.rand(b, n, t, generator=gen) < 0.3).to(cuda)
    mask[:, :, 0] = True                           # the root
    mask[:, -1] = False                            # an empty row
    return q, kv, mask


def _scales(d):
    return {k: d[k] for k in ("k_scale", "v_scale") if k in d}


def _check_close(got, want):
    """chip_smoke.py's tolerances: o absolute, m relative to max(|m|, 1)
    (a score), l relative."""
    (o, m, l), (o2, m2, l2) = got, want
    assert float((o - o2).abs().max()) <= 1e-4
    assert float(((m - m2).abs() / m2.abs().clamp_min(1.0)).max()) <= 1e-5
    assert float(((l - l2).abs() / l2.abs().clamp_min(1e-30)).max()) <= 1e-4


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("t", [1, 33, 73, 105, 300])
def test_tree_kernel_matches_plain_and_rows_alone(cuda, t, rep, hd, int8):
    b, kvh, n = 3, 2, 8
    q, kv, mask = _case(cuda, b, kvh, rep, n, hd, t, int8, t + rep + hd)
    sc = _scales(kv)
    got = tree_block.tree_block_attention(q, kv["k"], kv["v"], mask, **sc)
    want = tree_block.tree_block_attention_plain(q, kv["k"], kv["v"], mask,
                                                 scale=hd ** -0.5, **sc)
    _check_close(got, want)
    assert (got[0][:, :, -1] == 0).all() and (got[2][:, :, -1] == 0).all()
    assert (got[1][:, :, -1] == flash.NEG_INF).all()
    for r in range(b):
        alone = tree_block.tree_block_attention(
            q[r:r + 1], kv["k"][r:r + 1], kv["v"][r:r + 1], mask[r:r + 1],
            **{k: x[r:r + 1] for k, x in sc.items()})
        for g, a in zip(got, alone):
            assert torch.equal(g[r], a[0])


def _pools(dense, t, gen):
    """Shuffled paged copies of [B,KV,T,...] views: ({name: pool view
    [Nb,KV,page,...]}, table [B, mb])."""
    b = dense["k"].shape[0]
    need = paging.n_blocks(t, PAGE)
    ids = 1 + torch.randperm(b * need, generator=gen)
    table = ids.reshape(b, need).to(torch.int32)
    pools = {}
    for name, x in dense.items():
        p = paging.make_paged(x.transpose(1, 2).contiguous(),
                              table.to(x.device), PAGE)
        pools[name] = paging.pool_view(p.pages, PAGE)
    return pools, table.to(dense["k"].device)


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("t", [1, 33, 105, 300])
def test_paged_tree_kernel_equals_dense(cuda, t, hd, int8):
    """The paged kernel over a shuffled pool (the tail of the last block
    past T) against the plain version and, bit for bit, the dense kernel
    on the gathered view."""
    b, kvh, rep, n = 3, 2, 8, 8
    q, kv, mask = _case(cuda, b, kvh, rep, n, hd, t, int8, 7 * t + hd)
    pools, table = _pools(kv, t, torch.Generator().manual_seed(t))
    psc = _scales(pools)
    got = paged.paged_tree_block_attention(q, pools["k"], pools["v"], table,
                                           mask, **psc)
    want = paged.paged_tree_block_attention_plain(
        q, pools["k"], pools["v"], table, mask, scale=hd ** -0.5, **psc)
    _check_close(got, want)
    dense = {k: paged.gather_pool(x, table, t) for k, x in pools.items()}
    ref = tree_block.tree_block_attention(q, dense["k"], dense["v"], mask,
                                          **_scales(dense))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("paged_mode", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_merged_mode_equals_combine_lse(cuda, hd, int8, paged_mode):
    """``past=`` (the flash kernel's half) gives combine_lse over the two
    kernels' own halves, bit for bit, and the ops entry points are the
    same call; a row with an empty committed prefix takes the tree half."""
    b, kvh, rep, n, t, length = 3, 2, 8, 8, 105, 256
    q, kv, mask = _case(cuda, b, kvh, rep, n, hd, t, int8, hd + int8)
    gen = torch.Generator().manual_seed(hd)
    past_kv = {}
    for name in ("k", "v"):
        x = torch.randn(b, length, kvh, hd, generator=gen).to(cuda)
        if int8:
            x, s = quant.quantize_rows(x)
            past_kv[name + "_scale"] = s.transpose(1, 2)
        past_kv[name] = x.transpose(1, 2)
    kvl = torch.tensor([200, 0, 37], dtype=torch.int32, device=cuda)
    qpos = ((kvl.long() - 1).clamp_min(0)[:, None]
            + torch.arange(n, device=cuda) // 2).to(torch.int32)
    past = flash.flash_attention_lse(q, past_kv["k"], past_kv["v"], kvl,
                                     qpos, **_scales(past_kv))
    if paged_mode:
        pools, table = _pools(kv, t, torch.Generator().manual_seed(3))
        sc = _scales(pools)
        tree = paged.paged_tree_block_attention(
            q, pools["k"], pools["v"], table, mask, **sc)
        merged = paged.paged_tree_block_attention(
            q, pools["k"], pools["v"], table, mask, past=past, **sc)
    else:
        sc = _scales(kv)
        tree = tree_block.tree_block_attention(q, kv["k"], kv["v"], mask,
                                               **sc)
        merged = tree_block.tree_block_attention(q, kv["k"], kv["v"], mask,
                                                 past=past, **sc)
    want = tree_block.combine_lse([past, tree])
    assert torch.equal(merged, want)
    plain = tree_block.tree_block_attention_plain(
        q, kv["k"], kv["v"], mask, scale=hd ** -0.5, past=past,
        **_scales(kv))
    torch.testing.assert_close(merged, plain, rtol=0, atol=1e-4)
