"""Data pipeline: byte-level corpus, packing, batching, host sharding.

The port's own copy of the JAX package's ``repro/data/pipeline.py``
(numpy only): a tokenizer-free byte vocabulary (256 bytes + specials) so
training runs offline, and a synthetic Markov corpus with learnable
structure, so a draft and a target trained on it agree as a real pair
does.  The same seed gives the same bytes and the same batches, in the
same order, as the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

BOS, EOS, PAD = 256, 257, 258
BYTE_VOCAB = 260  # 256 bytes + BOS/EOS/PAD + 1 spare


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Example length, batch size and the shuffle seed."""
    seq_len: int = 256
    batch_size: int = 8
    seed: int = 0


class ByteCorpus:
    """Packs raw bytes into fixed-length next-token-prediction examples."""

    def __init__(self, text: bytes, cfg: DataConfig):
        self.cfg = cfg
        ids = np.frombuffer(text, dtype=np.uint8).astype(np.int32)
        n = (len(ids) - 1) // cfg.seq_len * cfg.seq_len
        self.tokens = ids[: n + 1]

    def __len__(self) -> int:
        return (len(self.tokens) - 1) // self.cfg.seq_len

    def example(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, labels) of example ``i``: labels are tokens shifted by
        one."""
        s = i * self.cfg.seq_len
        chunk = self.tokens[s: s + self.cfg.seq_len + 1]
        return chunk[:-1], chunk[1:]


def synthetic_corpus(n_bytes: int = 1 << 16, seed: int = 0,
                     order: int = 2, concentration: float = 0.05) -> bytes:
    """Markov-chain bytes over a small alphabet: compressible, learnable.

    Low ``concentration`` gives near-deterministic transitions, so small
    models trained on it agree strongly.  One ``rng.choice`` per byte, as
    in the JAX package: a vectorised draw would change the random stream
    and so the bytes."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abcdefgh ., \n", dtype=np.uint8)
    k = len(alpha)
    trans = rng.dirichlet(np.ones(k) * concentration, size=k ** order)
    out = np.zeros(n_bytes, np.uint8)
    state = 0
    for i in range(n_bytes):
        nxt = rng.choice(k, p=trans[state])
        out[i] = alpha[nxt]
        state = (state * k + nxt) % (k ** order)
    return out.tobytes()


def batch_iterator(corpus: ByteCorpus, *, epochs: int = 1, shuffle=True,
                   host_id: int = 0, host_count: int = 1
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (tokens [B,S], labels [B,S]); host-sharded round robin."""
    cfg = corpus.cfg
    rng = np.random.default_rng(cfg.seed)
    n = len(corpus)
    for _ in range(epochs):
        order = rng.permutation(n) if shuffle else np.arange(n)
        order = order[host_id::host_count]
        for s in range(0, len(order) - cfg.batch_size + 1, cfg.batch_size):
            idx = order[s: s + cfg.batch_size]
            xs, ys = zip(*(corpus.example(i) for i in idx))
            yield np.stack(xs), np.stack(ys)
