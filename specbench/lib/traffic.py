"""The one traffic generator: a mix file's parameters and a seed in, the
ordered request list out.

Lengths are stratified and fixed, so that every seed serves the same work
in the same order: each block of ``block`` requests holds the distribution's
quantiles at (i + 0.5) / block, prompts paired with outputs and each block
ordered by permutations that do not depend on the seed.  In a closed loop
the order decides which requests share an admission, so a seed that
reordered them would change the work inside the window.  The seed draws the
token ids (and, in ``weights``, the weights).

The closed loop starts in steady state: the first ``clients`` requests stand
for the requests its clients have in flight at a moment of steady state.  Request i of them keeps ``ceil(u_i * L_i)`` of its
``L_i`` output tokens (at least one), the u_i the quantiles (j + 0.5) /
clients in a seed-free order, and its prompt carries the tokens it has
already generated (seeded ids), so completions and cache lengths are spread
from the first timestep and not all at their start.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np


@dataclasses.dataclass
class Req:
    uid: int
    prompt: np.ndarray        # int64 token ids
    max_new_tokens: int


def seed_bits(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator for stream ``tags`` of run seed ``seed`` (any
    whole number)."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 63), *tags]))


def quantile(spec: dict, u: np.ndarray) -> np.ndarray:
    """Whole lengths at quantiles ``u`` of a ``uniform`` or ``loguniform``
    distribution over [min, max]."""
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "uniform":
        x = lo + u * (hi - lo)
    elif spec["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def block_pairs(mix: dict) -> np.ndarray:
    """[block, 2] (prompt, output) lengths of every block."""
    b = mix["block"]
    u = (np.arange(b) + 0.5) / b
    prompts = quantile(mix["prompt_tokens"], u)
    outputs = quantile(mix["output_tokens"], u)
    pairing = np.random.default_rng(0).permutation(b)
    return np.stack([prompts, outputs[pairing]], 1)


def drawn(mix: dict, seed: int, vocab: int):
    """(the requests as drawn, the seed's stream of token ids after them),
    before the loop's steady start."""
    pairs = block_pairs(mix)
    order, ids = np.random.default_rng(1), seed_bits(seed, 2)
    out: List[Req] = []
    while len(out) < mix["requests"]:
        for plen, olen in pairs[order.permutation(len(pairs))]:
            out.append(Req(len(out), ids.integers(0, vocab, int(plen),
                                                  dtype=np.int64), int(olen)))
    return out[:mix["requests"]], ids


def requests(mix: dict, seed: int, vocab: int) -> List[Req]:
    """The run's requests in submission order, the first ``clients`` of
    them in flight in steady state."""
    out, ids = drawn(mix, seed, vocab)
    n = mix["clients"]
    u = (np.random.default_rng(3).permutation(n) + 0.5) / n
    for r, f in zip(out[:n], u):
        keep = max(1, math.ceil(f * r.max_new_tokens))
        done = ids.integers(0, vocab, r.max_new_tokens - keep, dtype=np.int64)
        r.prompt = np.concatenate([r.prompt, done])
        r.max_new_tokens = keep
    return out
