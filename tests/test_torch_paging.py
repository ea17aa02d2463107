"""The port's block-paged KV storage against the JAX package's on the same
numpy inputs: ``models.paging`` (round trip through a shuffled table,
null-block aliasing and dropped writes, per-slot row writes and gathers,
slot views sharing the pool, per-slot select) and the host allocator
(``PagePool``/``PageAllocator``), whose tables must equal the
reference's over the same sequence of operations.

Every comparison is exact: the helpers move values without arithmetic.
Rows of the null block are don't-care in both packages (duplicate writes
land there in an unspecified order), so only backed rows are compared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import paging as jpaging
from repro.serving.scheduler import PageAllocator as JaxPageAllocator
from repro_torch.models import paging
from repro_torch.serving.scheduler import PageAllocator, PagePool


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(arr):
    return torch.as_tensor(arr), jnp.asarray(arr)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _paged_pair(rng, b, length, row, page, table):
    dense = rng.normal(size=(b, length, *row)).astype(np.float32)
    t, j = _both(dense)
    return (dense, paging.make_paged(t, table, page),
            jpaging.make_paged(j, table, page))


def _backed(table, page, length):
    """[B, L] bool: logical rows backed by a real block."""
    ls = np.arange(length)
    return np.asarray(table)[:, ls // page] != 0


@pytest.mark.parametrize("row", [(5,), (2, 3)])
def test_round_trip_shuffled_table(row):
    """Dense -> pool + table -> dense is the identity for any block
    permutation, and the port's pool is the reference's pool."""
    rng = np.random.default_rng(0)
    b, length, page = 3, 20, 8
    mb = paging.n_blocks(length, page)
    table = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
    dense, p, jp = _paged_pair(rng, b, length, row, page, table)
    assert paging.is_paged(p) and p.slots == b and p.length == length
    assert paging.to_dense(p).shape == jpaging.dense_shape(jp) == dense.shape
    _eq(p.pages, jp.pages)
    _eq(paging.to_dense(p), dense)
    upd = rng.normal(size=dense.shape).astype(np.float32)
    _eq(paging.to_dense(paging.from_dense(p, torch.as_tensor(upd))),
        jpaging.to_dense(jpaging.from_dense(jp, jnp.asarray(upd))))


def test_pool_view_is_the_kernel_layout():
    """``pool_view`` is the reference's ``_pool_kv`` / ``_pool_scales``
    blocked layout, as a view of the flat pool (no copy)."""
    from repro.models.attention import _pool_kv, _pool_scales
    rng = np.random.default_rng(9)
    table = np.asarray([[2, 1], [3, 4]], np.int32)
    for row, ref in (((2, 4), _pool_kv), ((2,), _pool_scales)):
        _, p, jp = _paged_pair(rng, 2, 16, row, 8, table)
        view = paging.pool_view(p.pages, 8)
        assert view.data_ptr() == p.pages.data_ptr()
        _eq(view, ref(jp))


def test_null_block_aliasing_and_write_drop():
    """Unallocated logical blocks alias one null block; masked-off and
    out-of-range ``write_len_rows`` rows land in it and leave every backed
    row of every slot as it was, in both packages alike."""
    rng = np.random.default_rng(2)
    b, length, d, page = 2, 16, 3, 8
    table = np.asarray([[1, 0], [2, 0]], np.int32)
    dense, p, jp = _paged_pair(rng, b, length, (d,), page, table)
    got = paging.to_dense(p).numpy()
    _eq(got[:, :page], dense[:, :page])
    _eq(got[0, page:], got[1, page:])        # one shared null block
    u = rng.normal(size=(b, 4, d)).astype(np.float32)
    kw = dict(starts=[4, length], on=[False, True])
    p2 = paging.write_len_rows(p, torch.as_tensor(u), **kw)
    jp2 = jpaging.write_len_rows(jp, jnp.asarray(u), **kw)
    _eq(paging.to_dense(p2)[:, :page], dense[:, :page])
    _eq(paging.to_dense(p2)[:, :page], jpaging.to_dense(jp2)[:, :page])


def test_write_len_rows_and_take_len_rows():
    rng = np.random.default_rng(3)
    b, length, row, page = 2, 24, (2, 4), 8
    table = (1 + rng.permutation(b * 3)).reshape(b, 3).astype(np.int32)
    _, p, jp = _paged_pair(rng, b, length, row, page, table)
    u = rng.normal(size=(b, 5, *row)).astype(np.float32)
    starts = np.asarray([2, 21], np.int32)      # slot 1 runs off the end
    paging.write_len_rows(p, torch.as_tensor(u), starts)
    jp = jpaging.write_len_rows(jp, jnp.asarray(u), starts)
    backed = _backed(table, page, length)
    _eq(paging.to_dense(p)[backed], jpaging.to_dense(jp)[backed])
    idx = np.asarray([[2, 3, 6], [21, 22, 23]], np.int32)
    _eq(paging.take_len_rows(p, idx), jpaging.take_len_rows(jp, idx))
    # the physical rows of a write, shared by the leaves of one table
    rows = paging.len_rows(p, starts, 5)
    assert rows.shape == (b, 5) and int(rows[1, 3:].abs().sum()) == 0


def test_slice_slots_adopt_pool_and_write_slot_rows():
    """A slot view shares the pool, so writes through it are in the arena;
    ``adopt_pool`` keeps the full table; ``write_slot_rows`` writes whole
    slots through the table and leaves the others as they were."""
    rng = np.random.default_rng(4)
    b, length, d, page = 3, 16, 4, 8
    table = (1 + rng.permutation(b * 2)).reshape(b, 2).astype(np.int32)
    dense, p, jp = _paged_pair(rng, b, length, (d,), page, table)
    view = paging.slice_slots(p, 1, 2)
    jview = jpaging.slice_slots(jp, 1, 2)
    _eq(paging.to_dense(view), jpaging.to_dense(jview))
    upd = rng.normal(size=(2, length, d)).astype(np.float32)
    paging.from_dense(view, torch.as_tensor(upd))
    merged = paging.adopt_pool(p, view)
    jmerged = jpaging.adopt_pool(jp, jpaging.from_dense(jview,
                                                        jnp.asarray(upd)))
    assert merged is p and torch.equal(merged.table, p.table)
    _eq(paging.to_dense(merged), jpaging.to_dense(jmerged))
    _eq(paging.to_dense(p)[0], dense[0])
    with pytest.raises(ValueError, match="share the pool"):
        paging.adopt_pool(p, paging.Paged(p.pages.clone(), p.table, page,
                                          length))
    upd2 = rng.normal(size=(1, length, d)).astype(np.float32)
    paging.write_slot_rows(p, torch.as_tensor(upd2), 2)
    jmerged = jpaging.write_slot_rows(jmerged, jnp.asarray(upd2), 2)
    _eq(paging.to_dense(p), jpaging.to_dense(jmerged))


def test_where_slots_selects_blocks_per_slot():
    rng = np.random.default_rng(5)
    b, length, d, page = 3, 16, 4, 8
    table = (1 + np.arange(b * 2, dtype=np.int32)).reshape(b, 2)
    _, old, jold = _paged_pair(rng, b, length, (d,), page, table)
    fresh = rng.normal(size=(b, length, d)).astype(np.float32)
    new = paging.from_dense(paging.Paged(old.pages.clone(), old.table, page,
                                         length), torch.as_tensor(fresh))
    jnew = jpaging.from_dense(jold, jnp.asarray(fresh))
    on = np.asarray([True, False, True])
    got = paging.to_dense(paging.where_slots(on, new, old))
    _eq(got, jpaging.to_dense(jpaging.where_slots(on, jnew, jold)))
    _eq(got[1], paging.to_dense(old)[1])
    _eq(got[0], fresh[0])


def test_densify_repaginate_any_paged():
    """A port cache (a list of per-layer dicts) densifies to copies and
    repaginates in place; dense leaves pass through."""
    rng = np.random.default_rng(6)
    table = (1 + np.arange(4, dtype=np.int32)).reshape(2, 2)
    dense, p, _ = _paged_pair(rng, 2, 16, (4,), 8, table)
    cache = [{"k": p, "state": torch.zeros(2, 3)}]
    assert paging.any_paged(cache)
    d = paging.densify(cache)
    assert not paging.any_paged(d)
    _eq(d[0]["k"], dense)
    upd = [{k: v + 1.0 for k, v in layer.items()} for layer in d]
    back = paging.repaginate(cache, upd)
    assert back[0]["k"] is p
    _eq(paging.to_dense(p), dense + 1.0)
    _eq(back[0]["state"], np.ones((2, 3)))


def test_page_pool_order_and_null_block():
    pool = PagePool(4)
    assert pool.alloc(2) == [1, 2] and pool.alloc(3) is None
    pool.free([2])
    assert pool.alloc(2) == [2, 3] and pool.peak == 3
    with pytest.raises(RuntimeError, match="null block"):
        pool.free([0])


def test_page_allocator_tables_equal_jax():
    """The same sequence of ensure / release / grow operations on both
    allocators gives equal tables, pool counts and counters."""
    kw = dict(slots=3, page=8, max_len=40, tree_capacity=13,
              model_blocks=9, tree_blocks=5)
    ours, ref = PageAllocator(**kw), JaxPageAllocator(**kw)
    ops = [("ensure", "model", 0, 19), ("ensure", "tree", 0, 13),
           ("ensure", "model", 1, 33), ("ensure", "tree", 1, 1),
           ("release", "model", 0), ("ensure", "model", 2, 17),
           ("ensure", "tree", 1, 12), ("ensure", "model", 0, 40),
           ("release", "tree", 0), ("ensure", "tree", 2, 13),
           ("ensure", "model", 1, 40)]
    for op in ops:
        got = getattr(ours, op[0])(*op[1:])
        want = getattr(ref, op[0])(*op[1:])
        assert got == want, op
        np.testing.assert_array_equal(ours.model_table, ref.model_table)
        np.testing.assert_array_equal(ours.tree_table, ref.tree_table)
    assert ours.counters() == ref.counters()
    assert ours.expand_copies == ref.expand_copies > 0
    with pytest.raises(ValueError, match="power of two"):
        PageAllocator(**dict(kw, page=12))


def test_where_cache_rows_dense_and_paged():
    """``transformer.where_cache_rows`` selects per slot, on a dense and
    on a paged cache alike."""
    from repro_torch.models import transformer as tf
    rng = np.random.default_rng(7)
    table = (1 + np.arange(6, dtype=np.int32)).reshape(3, 2)
    old_d, old_p, _ = _paged_pair(rng, 3, 16, (2, 4), 8, table)
    new_d = rng.normal(size=old_d.shape).astype(np.float32)
    new_p = paging.from_dense(paging.Paged(old_p.pages.clone(), old_p.table,
                                           8, 16), torch.as_tensor(new_d))
    on = np.asarray([False, True, True])
    want = np.where(on[:, None, None, None], new_d, old_d)
    dense = tf.where_cache_rows(on, [{"k": torch.as_tensor(new_d)}],
                                [{"k": torch.as_tensor(old_d)}])
    _eq(dense[0]["k"], want)
    paged = tf.where_cache_rows(on, [{"k": new_p}], [{"k": old_p}])
    _eq(paging.to_dense(paged[0]["k"]), want)


@pytest.mark.parametrize("quant", [False, True])
def test_decode_step_on_paged_cache_equals_dense(quant):
    """``decode_step`` over a paged copy of a prefilled cache (shuffled
    blocks, each row backing its own length) gives the dense cache's
    logits, and writes the new row through the table."""
    from repro_torch.configs import pipedec_pair
    from repro_torch.core.speculative import ModelBundle
    from repro_torch.models import transformer as tf
    bundle = ModelBundle(tf.init_model(pipedec_pair.DRAFT_SMOKE, seed=4,
                                       device="cpu"))
    if quant:
        bundle = bundle.quantize()
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 512, (2, 9))
    dense = bundle.init_cache(2, 32)
    bundle.prefill(tokens, dense)
    table = np.asarray([[3, 1, 0, 0], [2, 4, 0, 0]], np.int32)
    paged = [{k: paging.make_paged(v, table, 8) for k, v in layer.items()}
             for layer in dense]
    tok = rng.integers(0, 512, 2)
    want, _ = bundle.decode(tok, dense, 9)
    got, _ = bundle.decode(tok, paged, 9)
    _eq(got, want)
    for layer_d, layer_p in zip(dense, paged):
        for k in layer_d:
            _eq(paging.to_dense(layer_p[k])[:, :10], layer_d[k][:, :10])
