"""Byte-level training data: corpus, packing, batching, host sharding."""
from repro_torch.data.pipeline import (BOS, BYTE_VOCAB, EOS, PAD, ByteCorpus,
                                       DataConfig, batch_iterator,
                                       synthetic_corpus)

__all__ = ["BOS", "BYTE_VOCAB", "EOS", "PAD", "ByteCorpus", "DataConfig",
           "batch_iterator", "synthetic_corpus"]
