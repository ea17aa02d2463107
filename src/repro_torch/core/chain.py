"""Chain-mode speculative decoding: PipeDec with a tree of width 1.

The draft proposes a linear chain, each pipeline stage processes a
different chain position (PipeDec with w = c = 1), and a mismatch rolls
back to the accepted prefix.  It is how the recurrent families (Mamba-2,
RecurrentGemma, attention+SSD hybrids) speculate, since they have no
ancestor-mask trick; on an attention model it is the width-1 ablation of
the dynamic tree.  Losslessness is the same as PipeDec's: every committed
token is the target's own argmax or sample.

Logical engine (one device, the pipeline's information schedule): logits
exit ``n_stages`` timesteps after their token enters.

Rollback.  The JAX engine keeps one immutable cache per chain position.
The port's caches are written in place.  For an attention layer, "the
state after chain position i" is the cache read up to length
``model_len + i``: a decode at position p writes row p and attends rows
[0, p], so rows past the length are never read, and a later decode at the
same position overwrites them; rolling back only resets the chain length
(fp32 or int8, whose rows and scales are written per row).  A recurrent
layer's state is not indexed by position, so the engine keeps a copy of
the recurrent leaves only, one per chain position, for target and draft
(``snapshots[i]`` is the state after chain[:i]; the live cache always
holds the last one): a hit drops the oldest copy, a miss copies snapshot
``min(pos, len - 1)`` back into the live cache in place.  An attention
model has no recurrent leaf and makes no copy (``snapshot_copies`` counts
the leaves copied, restores included).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.pipedec import GenStats
from repro_torch.core.speculative import (ModelBundle, SamplingParams,
                                          select_token)
from repro_torch.models.transformer import RECURRENT_KINDS, layer_kinds


# tokens a chain may run ahead of a full pipeline
CHAIN_SLACK = 4


@dataclasses.dataclass
class ChainConfig:
    """Chain (width-1 tree) speculative pipeline config."""
    n_stages: int = 4
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)

    @property
    def chain_cap(self) -> int:
        """Longest chain (committed token plus speculation) in flight."""
        return self.n_stages + CHAIN_SLACK


def recurrent_leaves(cfg, cache) -> list:
    """The recurrent layers' state dicts of a per-layer cache (empty for
    an attention model)."""
    return [c for kind, c in zip(layer_kinds(cfg), cache)
            if kind in RECURRENT_KINDS]


class _Snapshots:
    """Copies of one cache's recurrent leaves, one per chain position."""

    def __init__(self, cfg, cache):
        self.live = recurrent_leaves(cfg, cache)
        self.copies = 0
        self.states = [self._copy()]

    def _copy(self) -> list:
        self.copies += sum(len(c) for c in self.live)
        return [{k: v.clone() for k, v in c.items()} for c in self.live]

    def push(self) -> None:
        """Keep the live state (after one more chain token)."""
        if self.live:
            self.states.append(self._copy())

    def shift(self) -> None:
        """The oldest chain position was committed: drop its copy."""
        if self.live:
            self.states = self.states[1:]

    def restore(self, p: int) -> None:
        """Roll the live state back to snapshot ``p``, in place; it
        becomes the only snapshot."""
        if not self.live:
            return
        snap = self.states[min(p, len(self.states) - 1)]
        for live, saved in zip(self.live, snap):
            for k, v in live.items():
                v.copy_(saved[k])
        self.copies += sum(len(c) for c in self.live)
        self.states = [snap]


@dataclasses.dataclass
class _Flight:
    exit_t: int
    pos: int                  # chain position these logits verify
    logits: torch.Tensor      # [V]


class ChainSpecEngine:
    """Draft-in-pipeline chain speculative decoding."""

    def __init__(self, target: ModelBundle, draft: ModelBundle,
                 ccfg: ChainConfig, max_len: int = 512):
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError("target and draft must share a vocabulary")
        self.target, self.draft, self.ccfg = target, draft, ccfg
        self.max_len = max_len
        self.snapshot_copies = 0   # recurrent leaves copied, all requests

    def generate(self, prompt: np.ndarray, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None):
        """Run one request: (the 1 + max_new_tokens committed tokens,
        GenStats).  ``generator`` draws the samples when sampling."""
        c = self.ccfg
        tgt, drf = self.target, self.draft

        t_cache = tgt.init_cache(1, self.max_len)
        d_cache = drf.init_cache(1, self.max_len)
        prompt_b = np.asarray(prompt, np.int64)[None]
        t_logits, t_cache = tgt.prefill(prompt_b, t_cache)
        _, d_cache = drf.prefill(prompt_b, d_cache)
        model_len = len(prompt)   # no prefix offset, as in the reference
        committed = [select_token(t_logits[0], c.sampling, generator)]

        # chain[0] is the last committed token; spec_len chain tokens have
        # been decoded past the committed prefix, so both caches hold
        # model_len + spec_len valid rows, and the recurrent snapshots
        # spec_len + 1 states
        snaps = (_Snapshots(tgt.cfg, t_cache), _Snapshots(drf.cfg, d_cache))
        chain: List[int] = [committed[-1]]
        spec_len = 0
        flights: List[_Flight] = []
        stats = GenStats()
        t = 0
        limit = max_new_tokens * (c.n_stages + 2) + 16

        while len(committed) < 1 + max_new_tokens and t < limit:
            t += 1
            stats.timesteps = t

            # entry: the next chain token enters the pipeline
            if spec_len < len(chain) and len(chain) <= c.chain_cap:
                tok = [chain[spec_len]]
                lg, t_cache = tgt.decode(tok, t_cache, model_len + spec_len)
                flights.append(_Flight(t + c.n_stages - 1, spec_len + 1,
                                       lg[0]))
                # the draft decodes the same token and proposes the next
                dlg, d_cache = drf.decode(tok, d_cache, model_len + spec_len)
                chain.append(int(torch.argmax(dlg[0])))
                for sn in snaps:
                    sn.push()
                spec_len += 1
                stats.entries += 1

            # exit and sync
            exiting = [f for f in flights if f.exit_t == t]
            flights = [f for f in flights if f.exit_t != t]
            for fl in exiting:
                x = select_token(fl.logits, c.sampling, generator)
                committed.append(x)
                stats.commits += 1
                model_len += 1
                if fl.pos < len(chain) and chain[fl.pos] == x:
                    stats.hits += 1
                    # the chain's head is consumed: shift the window
                    chain = chain[1:]
                    for sn in snaps:
                        sn.shift()
                    spec_len -= 1
                    for f2 in flights:
                        f2.pos -= 1
                else:
                    stats.misses += 1
                    # roll back to the accepted prefix: the first
                    # model_len rows of each attention cache, the
                    # recurrent state after chain[:pos] (module docstring)
                    for sn in snaps:
                        sn.restore(fl.pos)
                    chain = [x]
                    spec_len = 0
                    flights = []
                if len(committed) >= 1 + max_new_tokens:
                    break
            stats.commits_per_step.append(0)

        self.snapshot_copies += sum(sn.copies for sn in snaps)
        return np.asarray(committed[: 1 + max_new_tokens]), stats
