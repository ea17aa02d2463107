"""The port's byte data pipeline against the JAX package's (numpy both).

Equality is exact: the same bytes from ``synthetic_corpus`` and the same
arrays, in the same order, from ``ByteCorpus`` and ``batch_iterator``.
"""
import itertools

import numpy as np
import pytest

from repro import data as jdata
from repro_torch import data as tdata


@pytest.mark.parametrize("n_bytes,seed,order,concentration", [
    (1, 0, 2, 0.05), (257, 0, 2, 0.05), (1 << 12, 1, 2, 0.05),
    (1 << 11, 3, 1, 0.05), (1 << 10, 7, 3, 0.5), (1 << 12, 0, 2, 1.0)])
def test_synthetic_corpus_bytes_equal(n_bytes, seed, order, concentration):
    want = jdata.synthetic_corpus(n_bytes, seed=seed, order=order,
                                  concentration=concentration)
    got = tdata.synthetic_corpus(n_bytes, seed=seed, order=order,
                                 concentration=concentration)
    assert isinstance(got, bytes) and got == want


def test_specials_equal():
    from repro.data import pipeline as jp
    assert (tdata.BOS, tdata.EOS, tdata.PAD, tdata.BYTE_VOCAB) == \
        (jp.BOS, jp.EOS, jp.PAD, jp.BYTE_VOCAB)


def _corpora(seq, batch, seed, n_bytes=1 << 12):
    text = jdata.synthetic_corpus(n_bytes, seed=seed)
    return (jdata.ByteCorpus(text, jdata.DataConfig(seq, batch, seed)),
            tdata.ByteCorpus(text, tdata.DataConfig(seq, batch, seed)))


@pytest.mark.parametrize("seq", [16, 32, 100])
def test_corpus_examples_equal(seq):
    jc, tc = _corpora(seq, 4, 0)
    assert len(tc) == len(jc) > 0
    np.testing.assert_array_equal(tc.tokens, jc.tokens)
    for i in range(len(jc)):
        for got, want in zip(tc.example(i), jc.example(i)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tc.example(i)[1][:-1],
                                      tc.example(i)[0][1:])


@pytest.mark.parametrize("shuffle,host_count,epochs", [
    (True, 1, 2), (False, 1, 1), (True, 2, 2), (False, 2, 1)])
def test_batch_iterator_equal(shuffle, host_count, epochs):
    jc, tc = _corpora(32, 3, 5)
    for host in range(host_count):
        kw = dict(epochs=epochs, shuffle=shuffle, host_id=host,
                  host_count=host_count)
        got = list(tdata.batch_iterator(tc, **kw))
        want = list(jdata.batch_iterator(jc, **kw))
        assert len(got) == len(want) > 0
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.shape == (3, 32) and gx.dtype == wx.dtype
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_batch_iterator_endless_prefix_equal():
    """The trainer's ``epochs=1000`` stream: its first batches, across an
    epoch boundary, are the JAX package's."""
    jc, tc = _corpora(64, 8, 0, n_bytes=1 << 12)
    n = 3 * (len(jc) // 8) + 2
    got = itertools.islice(tdata.batch_iterator(tc, epochs=1000), n)
    want = itertools.islice(jdata.batch_iterator(jc, epochs=1000), n)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
