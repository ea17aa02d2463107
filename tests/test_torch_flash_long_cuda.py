"""The flash kernel's plan for long key spans on a card: a 65,536-row cache
(1024 chunks of 64 keys, 16 groups) at batch 2 with different kv_len,
with long_500k's 4096-key window and without, in fp32 and int8.  Every
test here is marked ``cuda_kernel`` and skips on a host without a card;
the file imports no JAX, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_long_cuda.py

Checked: the kernel against ``flash_attention_lse_plain`` at
``chip_smoke.py`` phase 2's tolerances (o 1e-4 absolute, m 1e-5 and l
1e-4 relative: fp32 sums in another order); bit for bit: the paged mode
against the dense kernel over the gathered view, a row alone against the
row in the batch, the decode on a paged cache that backs only the
window's pages against the decode over every row, a causal prefill in
48-query chunks against one shot across a group edge, and a CUDA graph's
replay against the eager launch.  The grid: a row of at most max(G, cap)
CTAs whatever the length.
"""
import pytest
import torch

from repro_torch.kernels import flash, ops, paged, quant
from repro_torch.models import paging

ROWS = 65536
WINDOW = 4096
PAGE = 16
KV_LEN = (ROWS, 50001)
TOL = dict(o=1e-4, m=1e-5, l=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode; test_torch_flash_long_plan.py holds the plan's "
                    "plain mirrors)")
    return torch.device("cuda")


def _kv(cuda, b, length, kvh, hd, int8, seed):
    """K/V [B, L, KV, hd] on the card (int8 with [B, L, KV] scales)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name in ("k", "v"):
        x = torch.randn(b, length, kvh, hd, generator=gen).to(cuda)
        if int8:
            x, out[name + "_scale"] = quant.quantize_rows(x)
        out[name] = x
    return out


def _view(kv):
    """The [B, KV, L, ...] views the kernel takes."""
    return {k: x.transpose(1, 2) for k, x in kv.items()}


def _scales(kv):
    return {k: kv[k] for k in ("k_scale", "v_scale") if k in kv}


def _close(got, want):
    o, m, l = got
    o2, m2, l2 = want
    assert float((o - o2).abs().max()) <= TOL["o"]
    assert float(((m - m2).abs() / m2.abs().clamp_min(1.0)).max()) <= TOL["m"]
    assert float(((l - l2).abs() / l2.abs().clamp_min(1e-30)).max()) <= \
        TOL["l"]


def _equal(got, want):
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _decode(cuda, n, seed):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(len(KV_LEN), 40, n, 128, generator=gen).to(cuda)
    kvl = torch.tensor(KV_LEN, dtype=torch.int32, device=cuda)
    qpos = ((kvl.long() - n)[:, None] + torch.arange(n, device=cuda)).to(
        torch.int32)
    return q, kvl, qpos


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [WINDOW, 0])
@pytest.mark.parametrize("n", [1, 8])
def test_long_cache_matches_plain_rows_alone_and_paged(cuda, int8, window,
                                                       n):
    """Qwen2.5-32B's widths (40 heads over 8 KV heads of 128); n = 8 is a
    tree verify's past half, whose window straddles a group edge on the
    short row."""
    kv = _kv(cuda, len(KV_LEN), ROWS, 8, 128, int8, 1)
    dense = _view(kv)
    q, kvl, qpos = _decode(cuda, n, 2)
    kw = dict(window=window, **_scales(dense))
    got = flash.flash_attention_lse(q, dense["k"], dense["v"], kvl, qpos,
                                    **kw)
    _close(got, flash.flash_attention_lse_plain(
        q, dense["k"], dense["v"], kvl, qpos, scale=128 ** -0.5, **kw))
    for r in range(len(KV_LEN)):
        alone = flash.flash_attention_lse(
            q[r:r + 1], dense["k"][r:r + 1], dense["v"][r:r + 1],
            kvl[r:r + 1], qpos[r:r + 1], window=window,
            **{k: x[r:r + 1] for k, x in _scales(dense).items()})
        _equal([x[r] for x in got], [x[0] for x in alone])
    # paged: shuffled pages of 16 rows; the dense kernel over the view
    # gathered through the table gives the same bits
    gen = torch.Generator().manual_seed(3)
    mb = ROWS // PAGE
    ids = 1 + torch.randperm(len(KV_LEN) * mb, generator=gen)
    table = ids.view(len(KV_LEN), mb).to(torch.int32).to(cuda)
    pools = {}
    for name, x in kv.items():
        p = paging.make_paged(x, table, PAGE)
        pools[name] = paging.pool_view(p.pages, PAGE)
    pgot = paged.paged_flash_attention_lse(q, pools["k"], pools["v"], table,
                                           kvl, qpos, window=window,
                                           **_scales(pools))
    gathered = {k: paged.gather_pool(x, table, ROWS)
                for k, x in pools.items()}
    _equal(pgot, flash.flash_attention_lse(
        q, gathered["k"], gathered["v"], kvl, qpos, window=window,
        **_scales(gathered)))
    _equal(pgot, got)


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("int8", [False, True])
def test_window_pages_alone_equal_every_row(cuda, int8):
    """A decode at the last row of each batch row, on a paged cache whose
    table backs only the pages the 4096-key window reaches (the rest is
    the null block), gives the bits of the dense decode over all rows."""
    kv = _kv(cuda, len(KV_LEN), ROWS, 8, 128, int8, 4)
    dense = _view(kv)
    q, kvl, qpos = _decode(cuda, 1, 5)
    full = flash.flash_attention_lse(q, dense["k"], dense["v"], kvl, qpos,
                                     window=WINDOW, **_scales(dense))
    mb = ROWS // PAGE
    table = torch.zeros(len(KV_LEN), mb, dtype=torch.int32)
    nxt = 1
    for r, k in enumerate(KV_LEN):
        lo, hi = (k - WINDOW) // PAGE, -(-k // PAGE)
        table[r, lo:hi] = torch.arange(nxt, nxt + hi - lo)
        nxt += hi - lo
    table = table.to(cuda)
    pools = {}
    for name, x in kv.items():
        p = paging.make_paged(x, table, PAGE)
        pools[name] = paging.pool_view(p.pages, PAGE)
    assert pools["k"].shape[0] == nxt            # the window's pages only
    got = paged.paged_flash_attention_lse(q, pools["k"], pools["v"], table,
                                          kvl, qpos, window=WINDOW,
                                          **_scales(pools))
    _equal(got, full)


@pytest.mark.cuda_kernel
def test_chunked_prefill_equals_one_shot_across_groups(cuda):
    """A 4224-token causal prefill (hd 128: 66 chunks, 2 groups) in 48-query
    chunks over the cache that holds them (query tiles of 32 that start
    elsewhere than one shot's) gives one shot's bits."""
    s, h, kvh, hd = 4224, 16, 8, 128
    gen = torch.Generator().manual_seed(6)
    q = torch.randn(1, h, s, hd, generator=gen).to(cuda)
    k, v = (torch.randn(1, kvh, s, hd, generator=gen).to(cuda)
            for _ in range(2))
    pos = torch.arange(s, device=cuda)
    one = ops.prefill_attention(q, k, v, pos)
    for q0 in range(0, s, 48):
        part = ops.chunk_attention(
            q[:, :, q0:q0 + 48], k, v,
            torch.tensor([q0 + 48], dtype=torch.int32, device=cuda),
            pos[q0:q0 + 48][None])
        assert torch.equal(part, one[:, :, q0:q0 + 48])


@pytest.mark.cuda_kernel
def test_grid_is_bounded_and_a_graph_replays_the_bits(cuda):
    """At 65,536 and 524,288 rows a grid row holds max(G, cap) CTAs; at
    512 rows one a chunk.  A CUDA graph captures the long launch (no host
    read of kv_len) and its replay gives the eager bits."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for length, b in ((ROWS, 2), (524288, 1), (512, 1)):
        x, y, z = flash.launch_grid(b, 40, 8, 1, length, 128)
        assert (y, z) == (1, b * 8)
        # one or two CTAs an SM, as registers and shared memory allow
        assert x in {flash.grid_x(128, length, b * 8, per_sm, sms)
                     for per_sm in (1, 2)}
    kv = _view(_kv(cuda, len(KV_LEN), ROWS, 8, 128, False, 7))
    q, kvl, qpos = _decode(cuda, 1, 8)

    def run():
        return flash.flash_attention_lse(q, kv["k"], kv["v"], kvl, qpos,
                                         window=WINDOW)
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = run()
    graph.replay()
    torch.cuda.synchronize()
    _equal(out, eager)
