"""The paper's baselines: plain autoregressive decoding (PP) and
static-tree speculative decoding (STPP, after SpecInfer).

``generate_autoregressive`` is also the ground truth every speculative
engine must reproduce token for token (greedy).  STPP shares the target
model and the dynamic-tree machinery (``core.tree``) with PipeDec: its
"static" tree is built to full depth by the draft, then verified by the
target in one pass over the whole tree, instead of layer by layer.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import tree as tree_lib
from repro_torch.core.speculative import (ModelBundle, SamplingParams,
                                          draft_candidates, select_token)


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
    model_len = target.prefix_len + len(prompt)
    tok = select_token(logits[0], sampling, generator)
    out = [tok]
    for _ in range(max_new_tokens):
        logits, cache = target.decode([tok], cache, model_len)
        model_len += 1
        tok = select_token(logits[0], sampling, generator)
        out.append(tok)
    return np.asarray(out[: 1 + max_new_tokens])


@dataclasses.dataclass
class STPPConfig:
    """Static-tree speculative decoding config: fixed depth, width and
    branch per round (PipeDec's tree is dynamic instead)."""
    depth: int = 4
    width: int = 8
    branch: int = 4
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)

    @property
    def capacity(self) -> int:
        """Tree node slots: the root plus ``depth`` full layers."""
        return 1 + self.width * self.depth


@dataclasses.dataclass
class STPPStats:
    """Per-request STPP counters: rounds, commits, draft tree layers and
    the tokens each round accepted beyond its first."""
    rounds: int = 0
    commits: int = 0
    draft_steps: int = 0
    accepted_per_round: List[int] = dataclasses.field(default_factory=list)

    @property
    def mean_accepted(self) -> float:
        """Accepted draft tokens per round."""
        return float(np.mean(self.accepted_per_round)) if self.rounds else 0.0


class STPPEngine:
    """STPP: the draft grows a static tree, the target verifies all of it
    in one tree-verify call, and the longest path the target agrees with
    is committed; repeat."""

    def __init__(self, target: ModelBundle, draft: ModelBundle,
                 scfg: STPPConfig, max_len: int = 512):
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError("target and draft must share a vocabulary")
        self.target, self.draft, self.scfg = target, draft, scfg
        self.max_len = max_len

    def generate(self, prompt: np.ndarray, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None):
        """Run one request: (the 1 + max_new_tokens committed tokens,
        STPPStats).  ``generator`` draws the samples when sampling."""
        s = self.scfg
        w, c, cap = s.width, s.branch, s.capacity
        tcap = cap + w                 # width-w slack for the layer writes
        tgt, drf = self.target, self.draft
        dev = tgt.device

        t_cache = tgt.init_cache(1, self.max_len)
        d_cache = drf.init_cache(1, self.max_len)
        prompt_b = np.asarray(prompt, np.int64)[None]
        t_logits, t_cache = tgt.prefill(prompt_b, t_cache)
        _, d_cache = drf.prefill(prompt_b, d_cache)
        model_len = tgt.prefix_len + len(prompt)   # the reference's rule

        root = select_token(t_logits[0], s.sampling, generator)
        committed = [root]
        stats = STPPStats()
        while len(committed) < 1 + max_new_tokens:
            stats.rounds += 1
            tree = tree_lib.tree_init(cap, root)
            # zeroed: a leaf of the last layer is never drafted, and a
            # round that accepts it commits its zero draft row (as the
            # JAX engine does)
            d_tree = drf.init_tree_caches(1, tcap)
            t_tree = tgt.init_tree_caches(1, tcap)

            # the draft builds the tree, one layer per tree verify
            for _ in range(s.depth):
                tokens, idxs, valid, mask_rows = tree_lib.last_layer(tree, w)
                depths = torch.where(valid, tree.depth[idxs], 0)
                pmask = F.pad(mask_rows, (0, tcap - cap))
                dlogits, d_tree = drf.tree_verify(
                    tokens[None].to(dev), (model_len + depths)[None].to(dev),
                    pmask[None].to(dev), d_cache, model_len, d_tree,
                    tree.layer_start)
                stats.draft_steps += 1
                cand_tok, cand_lp = draft_candidates(dlogits[0], valid, c)
                tree = tree_lib.tree_expand(tree, cand_tok, cand_lp, w)

            # the target verifies the whole tree in one pass
            valid_all = tree.valid()
            tokens_all = torch.where(valid_all, tree.tokens, 0)
            depths_all = torch.where(valid_all, tree.depth, 0)
            pmask = F.pad(tree.mask & valid_all[:, None], (0, tcap - cap))
            v_logits, t_tree = tgt.tree_verify(
                tokens_all[None].to(dev), (model_len + depths_all)[None].to(
                    dev), pmask[None].to(dev), t_cache, model_len, t_tree, 0)
            v_logits = v_logits[0]                          # [cap, V]

            # walk the longest path the target agrees with
            cur, accepted = 0, 0
            while True:
                x = select_token(v_logits[cur], s.sampling, generator)
                committed.append(x)
                t_cache = tgt.commit(t_cache, t_tree, cur, model_len)
                d_cache = drf.commit(d_cache, d_tree, cur, model_len)
                model_len += 1
                nxt = tree_lib.find_child_with_token(tree, x, cur)
                if nxt < 0 or len(committed) >= 1 + max_new_tokens:
                    root = x
                    break
                cur = nxt
                accepted += 1
            stats.accepted_per_round.append(accepted)

        stats.commits = len(committed) - 1
        return np.asarray(committed[: 1 + max_new_tokens]), stats
