"""What the tree attention kernel promises about its plan and arithmetic,
checked on the CPU with plain PyTorch (no JAX; the kernel itself runs only
on a card, in ``test_torch_tree_cuda.py``).

* The plan (``tree_block.tree_plan``, the specification of the kernel's
  plan that the card tests hold the kernel to): the CTAs' row tiles cover
  every (query, head) row once, and the stages and the warps' shares cover
  every key of the buffer exactly once, for buffers of one wave, at the
  wave's edge and of several stages.
* Merging the warps' (acc, m, l) in warp order (the kernel's epilogue;
  ``flash.merge_chunks`` is the same arithmetic) equals the plain version
  within 1e-6, with warps that hold no key and rows with no valid key.
* The masked 3xTF32 split (``tree_block.split_tf32``) gives back x
  exactly, and an emulation of the three products meets fp32 dot products
  within 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash, tree_block

# the tree capacities of 4 and 8 stages (73, 105), MMA-tile and mask-word
# edges, and the edges of one wave (64 keys at head_dim 256, 128 at 128,
# 256 at 64)
BUFFERS = [1, 31, 32, 33, 64, 65, 73, 105, 127, 128, 129, 256, 257, 300]


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("t", BUFFERS)
def test_tree_plan_covers_every_key_once(t, hd):
    plan = tree_block.tree_plan(t, hd)
    seen = torch.zeros(t, dtype=torch.int32)
    t_next = 0
    for t0, tl, shares in plan.stages:
        assert t0 == t_next and 0 < tl <= plan.stage_keys
        t_next = t0 + tl
        assert len(shares) == tree_block.WARPS
        lo_next = t0
        for lo, hi in shares:            # contiguous, in warp order
            assert lo == lo_next and lo <= hi
            # a share starts on a 16-key block (an empty one at the end)
            assert (lo - t0) % tree_block.BLOCK == 0 or lo == t0 + tl
            lo_next = hi
            seen[lo:hi] += 1
        assert lo_next == t0 + tl
    assert t_next == t
    assert (seen == 1).all()
    # one wave while the buffer fits, else double-buffered stages
    if t <= tree_block.wave_keys(hd):
        assert len(plan.stages) == 1
    else:
        assert plan.stage_keys == tree_block.wave_keys(hd) // 2
    # the launch passes the stage keys; the kernel derives the rest
    assert plan.stage_keys == tree_block.stage_keys(t, hd)


@pytest.mark.parametrize("n,rep", [(8, 8), (8, 4), (5, 1), (3, 64), (1, 3),
                                   (7, 5)])
def test_row_tiles_cover_every_query_head_row_once(n, rep):
    """The CTAs of a (batch row, KV head) at any GQA group: consecutive
    tiles of at most ROWS (query, head) rows, every row once."""
    tiles = tree_block.row_tiles(n, rep)
    assert [r0 for r0, _ in tiles] == list(range(0, n * rep,
                                                 tree_block.ROWS))
    assert sum(c for _, c in tiles) == n * rep
    assert all(0 < c <= tree_block.ROWS for _, c in tiles)


def _share_partial(qs, k, v, valid):
    """One warp's (acc, m, l) over its keys: masked scores -1e30, m from
    -1e30, p zeroed where masked, acc unnormalised.  A warp with no keys
    keeps its initial state (0, -1e30, 0)."""
    if k.shape[2] == 0:
        m = torch.full(qs.shape[:-1], flash.NEG_INF)
        return torch.zeros_like(qs), m, torch.zeros_like(m)
    s = torch.einsum("bgrnd,bgld->bgrnl", qs, k)
    s = torch.where(valid, s, torch.full((), flash.NEG_INF))
    m = torch.maximum(s.amax(-1), torch.full((), flash.NEG_INF))
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros(()))
    return torch.einsum("bgrnl,bgld->bgrnd", p, v), m, p.sum(-1)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("t", [1, 33, 73, 105, 129, 300])
def test_merging_warp_shares_in_order_equals_plain(t, hd):
    rng = np.random.default_rng(t + hd)
    b, h, kvh, n = 2, 8, 2, 6
    rep = h // kvh
    q = torch.from_numpy(rng.normal(size=(b, h, n, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, kvh, t, hd)).astype(
        np.float32)) for _ in range(2))
    mask = torch.from_numpy(rng.random((b, n, t)) < 0.3)
    mask[:, 0, 0] = True
    mask[1, -1] = False                    # a row with no valid key
    scale = hd ** -0.5
    want = tree_block.tree_block_attention_plain(q, k, v, mask, scale=scale)
    plan = tree_block.tree_plan(t, hd)
    qs = (q * scale).reshape(b, kvh, rep, n, hd)
    valid = mask[:, None, None]
    parts = []
    for s in range(tree_block.WARPS):      # each warp over all its stages
        keys = torch.cat([torch.arange(*shares[s])
                          for _, _, shares in plan.stages])
        parts.append(_share_partial(qs, k[:, :, keys], v[:, :, keys],
                                    valid[..., keys]))
    if t == 1:                             # every warp but the first idle
        assert all(not lp.any() for _, _, lp in parts[1:])
    o, m, l = flash.merge_chunks(parts)
    for got, ref in zip((o.reshape(b, h, n, hd), m.reshape(b, h, n),
                         l.reshape(b, h, n)), want):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    assert (m.reshape(b, h, n)[1, :, -1] == flash.NEG_INF).all()
    assert (o.reshape(b, h, n, hd)[1, :, -1] == 0).all()
    assert (l.reshape(b, h, n)[1, :, -1] == 0).all()


def _edge_values():
    f32 = np.finfo(np.float32)
    vals = [0.0, -0.0, 1.0, -1.0, f32.max, -f32.max, f32.tiny, -f32.tiny,
            1e-30, -1e-25, 3.0e38, 1.0000001, 65504.0, 2.0 ** -100,
            np.nextafter(np.float32(1), np.float32(2))]
    return torch.tensor(np.array(vals, np.float32))


def _tf32(x):
    """What the MMA reads of an fp32 operand: its top 19 bits."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def test_tf32_split_reconstructs_x_exactly():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(
        -30, 30, size=4096)).astype(np.float32))
    for vals in (x, _edge_values()):
        big, small = tree_block.split_tf32(vals)
        assert torch.equal(_tf32(big), big)          # big is TF32 exactly
        assert torch.equal(big + small, vals)
        assert torch.equal(big.double() + small.double(), vals.double())
        assert (small.abs() <= big.abs() * 2.0 ** -10).all()


def _emulate_3xtf32_dot(a, b):
    """a [M, K] times b [K, N] as the kernels compute it: per 8-wide k
    step three MMAs (small * big, big * small, big * big) accumulate apart
    in fp32, each an exact sum of the step's products rounded once, then
    add, small ones first."""
    (ab, as_), (bb, bs) = tree_block.split_tf32(a), tree_block.split_tf32(b)
    as_, bs = _tf32(as_), _tf32(bs)
    acc = [torch.zeros(a.shape[0], b.shape[1]) for _ in range(3)]
    for k0 in range(0, a.shape[1], 8):
        sl = slice(k0, k0 + 8)
        for i, (x, y) in enumerate(((as_, bb), (ab, bs), (ab, bb))):
            acc[i] = acc[i] + (x[:, sl].double() @ y[sl].double()).float()
    return acc[2] + (acc[0] + acc[1])


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_3xtf32_product_meets_fp32(hd):
    """Scores q.k at the model's scale and P.V with probabilities in
    [0, 1]: within 1e-5 of the float64 product, as close as an fp32 sum."""
    rng = np.random.default_rng(hd)
    q = torch.from_numpy(rng.normal(size=(16, hd)).astype(np.float32)
                         * hd ** -0.5)
    k = torch.from_numpy(rng.normal(size=(hd, 105)).astype(np.float32))
    p = torch.from_numpy(rng.random((16, 112)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(112, hd)).astype(np.float32))
    for a, b in ((q, k), (p, v)):
        want = a.double() @ b.double()
        got = _emulate_3xtf32_dot(a, b)
        fp32 = (a @ b).double()
        assert float((got.double() - want).abs().max()) <= 1e-5
        assert float((fp32 - want).abs().max()) <= 1e-5
        # one TF32 product alone is far off: the split is what keeps fp32
        one = (_tf32(a).double() @ _tf32(b).double())
        assert float((one - want).abs().max()) > 1e-4
