"""Port attention kernels (plain versions on the CPU) against the JAX
package's Pallas kernels in interpret mode and its jnp oracles, on the
same numpy inputs.  Tolerance: atol 1e-5 (fp32 sums in another order).

Tests marked ``cuda_kernel`` hold the CUDA kernels against their plain
versions on a card and skip on a host without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash import flash_attention_lse as jflash
from repro.kernels.tree_block import tree_block_attention as jtree
from repro.models.attention import gqa_attend as jgqa_attend
from repro_torch.kernels import flash, ops, ref, tree_block
from repro_torch.models.attention import gqa_attend

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU thread pool and XLA's contend in one process
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


FLASH_CASES = [
    # b, h, kv, n, hd, L, kv_len, causal, window
    (1, 4, 2, 8, 32, 96, [40], False, 0),
    (3, 4, 1, 5, 16, 64, [17, 0, 64], False, 0),      # empty row, full row
    (2, 8, 8, 16, 32, 48, [48, 30], True, 0),
    (2, 4, 2, 6, 32, 80, [70, 33], False, 12),
    (1, 2, 1, 12, 16, 40, [40], True, 5),
]


@pytest.mark.parametrize("b,h,kv,n,hd,length,kv_len,causal,window",
                         FLASH_CASES)
def test_flash_plain_matches_pallas(b, h, kv, n, hd, length, kv_len, causal,
                                    window):
    rng = np.random.default_rng(n * 31 + hd)
    q, k, v = (_rand(rng, b, h, n, hd), _rand(rng, b, kv, length, hd),
               _rand(rng, b, kv, length, hd))
    kvl = np.asarray(kv_len, np.int32)
    if causal:
        qpos = np.broadcast_to(np.arange(length - n, length, dtype=np.int32),
                               (b, n))
    else:
        qpos = np.maximum(kvl[:, None] - 1, 0) + np.arange(n) // 2
    qpos = np.ascontiguousarray(qpos, np.int32)
    jo, jm, jl = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(kvl), jnp.asarray(qpos), causal=causal,
                        window=window, block_k=16)
    o, m, l = flash.flash_attention_lse(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(kvl),
        torch.tensor(qpos), causal=causal, window=window)
    _close(o, jo)
    _close(m, np.asarray(jm)[..., 0])
    _close(l, np.asarray(jl)[..., 0])


def test_flash_reads_cache_layout_by_stride():
    """A [B,L,KV,hd] cache passed as a transposed view gives the same
    result as a contiguous [B,KV,L,hd] copy."""
    rng = np.random.default_rng(3)
    q = torch.tensor(_rand(rng, 2, 3, 4, 4, 16)[0])        # [3,4,4,16]
    cache = torch.tensor(_rand(rng, 3, 20, 2, 16))          # [B,L,KV,hd]
    view = cache.transpose(1, 2)
    got = flash.flash_attention_lse(q, view, view, [5, 20, 0])
    want = flash.flash_attention_lse(q, view.contiguous(), view.contiguous(),
                                     [5, 20, 0])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


TREE_CASES = [
    # b, h, kv, n, hd, T, per_row_mask
    (1, 4, 2, 8, 32, 24, False),
    (3, 8, 2, 4, 16, 41, True),
    (2, 2, 2, 6, 32, 13, True),
]


@pytest.mark.parametrize("b,h,kv,n,hd,t,per_row", TREE_CASES)
def test_tree_block_plain_matches_pallas(b, h, kv, n, hd, t, per_row):
    rng = np.random.default_rng(t)
    q, k, v = (_rand(rng, b, h, n, hd), _rand(rng, b, kv, t, hd),
               _rand(rng, b, kv, t, hd))
    mask = rng.random((b, n, t) if per_row else (n, t)) < 0.4
    mask[..., -1, :] = False                        # an all-false row
    jo, jm, jl = jtree(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(mask))
    o, m, l = tree_block.tree_block_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(mask))
    _close(o, jo)
    _close(m, np.asarray(jm)[..., 0])
    _close(l, np.asarray(jl)[..., 0])
    assert (o[..., -1, :] == 0).all() and (l[..., -1] == 0).all()


@pytest.mark.parametrize("past_len", [[30], [30, 0], [7, 45]])
def test_tree_attention_matches_ref(past_len):
    """Two kernels + combine_lse == the joint-softmax oracle (JAX and
    port); an empty committed prefix gets weight 0."""
    rng = np.random.default_rng(len(past_len) * 7 + past_len[0])
    b = len(past_len)
    q = _rand(rng, b, 4, 6, 32)
    kp, vp = _rand(rng, b, 2, 48, 32), _rand(rng, b, 2, 48, 32)
    kt, vt = _rand(rng, b, 2, 20, 32), _rand(rng, b, 2, 20, 32)
    mask = rng.random((b, 6, 20)) < 0.5
    mask[:, :, 0] = True                             # every row sees the root
    plen = np.asarray(past_len, np.int32)
    want = jref.tree_attention_ref(*map(jnp.asarray,
                                        (q, kp, vp, kt, vt, mask, plen)))
    args = tuple(map(torch.tensor, (q, kp, vp, kt, vt, mask, plen)))
    _close(ops.tree_attention(*args), want)
    _close(ref.tree_attention_ref(*args), want)


@pytest.mark.parametrize("window", [0, 9])
def test_decode_attention_matches_ref(window):
    rng = np.random.default_rng(window)
    q, k, v = _rand(rng, 2, 4, 1, 32), _rand(rng, 2, 2, 40, 32), \
        _rand(rng, 2, 2, 40, 32)
    want = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), 33, window=window)
    args = tuple(map(torch.tensor, (q, k, v)))
    _close(ops.decode_attention(*args, 33, window=window), want)
    _close(ref.decode_attention_ref(*args, 33, window=window), want)


def test_prefill_attention_matches_gqa_attend():
    """Causal kernel path == the JAX model's masked gqa_attend (and the
    port's copy of it) on [B,S,H,hd] layouts."""
    rng = np.random.default_rng(11)
    s = 10
    q, k, v = _rand(rng, 2, s, 4, 16), _rand(rng, 2, s, 2, 16), \
        _rand(rng, 2, s, 2, 16)
    causal = np.tril(np.ones((s, s), bool))[None, None]
    want = jgqa_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(causal))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    got = ops.prefill_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                tv.transpose(1, 2), torch.arange(s))
    _close(got.transpose(1, 2), want)
    _close(gqa_attend(tq, tk, tv, torch.tensor(causal)), want)


def test_combine_lse_matches_joint_softmax():
    rng = np.random.default_rng(5)
    q = torch.tensor(_rand(rng, 1, 2, 4, 16))
    k1, v1 = (torch.tensor(_rand(rng, 1, 2, 30, 16)) for _ in range(2))
    k2, v2 = (torch.tensor(_rand(rng, 1, 2, 9, 16)) for _ in range(2))
    mask = torch.ones(4, 9, dtype=torch.bool)
    got = ops.combine_lse([flash.flash_attention_lse(q, k1, v1, 30),
                           tree_block.tree_block_attention(q, k2, v2, mask)])
    _close(got, ref.tree_attention_ref(q, k1, v1, k2, v2, mask, 30))


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card gets no silent
    fallback."""
    q = torch.empty(1, 2, 3, 16, device="meta")
    kv = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(RuntimeError, match="no flash_attention_lse"):
        flash.flash_attention_lse(q, kv, kv, 4)
    with pytest.raises(RuntimeError, match="no tree_block_attention"):
        tree_block.tree_block_attention(
            q, kv, kv, torch.ones(3, 8, dtype=torch.bool, device="meta"))


def test_plain_versions_count_no_launches():
    before = (flash.flash_attention_lse.launches,
              tree_block.tree_block_attention.launches)
    test_combine_lse_matches_joint_softmax()
    assert (flash.flash_attention_lse.launches,
            tree_block.tree_block_attention.launches) == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode; "
                    "their plain versions are tested above)")
    return torch.device("cuda")


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("case", FLASH_CASES[:3])
def test_flash_kernel_matches_plain_on_card(cuda, case):
    b, h, kv, n, hd, length, kv_len, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, h, n, hd, generator=gen, device=cuda)
    k, v = (torch.randn(b, kv, length, hd, generator=gen, device=cuda)
            for _ in range(2))
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    qpos = torch.arange(length - n, length, device=cuda).expand(b, n)
    got = flash.flash_attention_lse(q, k, v, kvl, qpos, causal=causal,
                                    window=window)
    want = flash.flash_attention_lse_plain(
        q, k, v, kvl, qpos.to(torch.int32).contiguous(), scale=hd ** -0.5,
        causal=causal, window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda_kernel
def test_tree_kernel_matches_plain_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, 64, 8, 128, generator=gen, device=cuda)
    k, v = (torch.randn(2, 8, 105, 128, generator=gen, device=cuda)
            for _ in range(2))
    mask = torch.rand(2, 8, 105, generator=gen, device=cuda) < 0.3
    got = tree_block.tree_block_attention(q, k, v, mask)
    want = tree_block.tree_block_attention_plain(q, k, v, mask,
                                                 scale=128 ** -0.5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
