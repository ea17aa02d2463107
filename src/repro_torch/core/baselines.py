"""Plain autoregressive decoding: the paper's PP baseline and the ground
truth every speculative engine must reproduce token for token (greedy).

The static-tree STPP baseline of the JAX package arrives in a later slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.speculative import (ModelBundle, SamplingParams,
                                          select_token)


def generate_autoregressive(target: ModelBundle, prompt: np.ndarray,
                            max_new_tokens: int, *,
                            sampling: SamplingParams = SamplingParams(),
                            max_len: int = 512,
                            generator: Optional[torch.Generator] = None
                            ) -> np.ndarray:
    """One token per full forward pass: prefill, then ``max_new_tokens``
    decode steps.  Returns the 1 + max_new_tokens committed tokens."""
    cache = target.init_cache(1, max_len)
    logits, cache = target.prefill(np.asarray(prompt, np.int64)[None], cache)
    model_len = len(prompt)
    tok = select_token(logits[0], sampling, generator)
    out = [tok]
    for _ in range(max_new_tokens):
        logits, cache = target.decode([tok], cache, model_len)
        model_len += 1
        tok = select_token(logits[0], sampling, generator)
        out.append(tok)
    return np.asarray(out[: 1 + max_new_tokens])
