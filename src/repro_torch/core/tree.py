"""Dynamic prediction tree (paper 3.3) in fixed-capacity packed form.

The same arrays and operations as the JAX package's ``repro/core/tree.py``:
a buffer of ``capacity`` slots holding a packed BFS-ordered prefix of
``n_nodes`` nodes, with per-node token, cumulative log-probability, parent
and depth, and the ancestor-or-self mask that tree attention reads.

  * ``tree_init``           - one root node (the last committed token);
  * ``tree_expand``         - append one layer: the global top-``w`` draft
    candidates by cumulative log-probability (paper 3.3.3);
  * ``tree_prune_to_child`` - keep the subtree of a depth-1 child and
    compact it to the buffer prefix, returning the old -> new index map.

The tree is host state.  Its arrays hold a few thousand entries at most,
so the port keeps them as CPU tensors and the engine ships one layer's
tokens, positions and mask rows to the card per timestep; the counters
(``n_nodes``, ``layer_start``, ``layer_size``) are Python ints.

Ties: ``jax.lax.top_k`` puts the lower index first among equal scores, and
many scores of ``tree_expand`` tie at -1e30, so the port selects with a
stable descending sort, which keeps that order.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

NEG_INF = -1e30


class Tree(NamedTuple):
    """The dynamic prediction tree, packed into fixed-capacity arrays."""
    tokens: torch.Tensor      # [N] int32
    logprob: torch.Tensor     # [N] f32 cumulative log-prob from root (root=0)
    parent: torch.Tensor      # [N] int32, -1 for root / invalid
    depth: torch.Tensor       # [N] int32 (root=0), -1 invalid
    mask: torch.Tensor        # [N, N] bool, ancestor-or-self
    n_nodes: int              # packed prefix length
    layer_start: int          # first index of the deepest layer
    layer_size: int           # valid nodes in the deepest layer

    @property
    def capacity(self) -> int:
        """Buffer slots N."""
        return self.tokens.shape[0]

    def valid(self) -> torch.Tensor:
        """[N] bool: slot holds a node."""
        return torch.arange(self.capacity) < self.n_nodes


def tree_init(capacity: int, root_token: int) -> Tree:
    """Fresh single-node tree holding ``root_token`` at index 0."""
    tokens = torch.zeros(capacity, dtype=torch.int32)
    tokens[0] = int(root_token)
    logprob = torch.full((capacity,), NEG_INF, dtype=torch.float32)
    logprob[0] = 0.0
    parent = torch.full((capacity,), -1, dtype=torch.int32)
    depth = torch.full((capacity,), -1, dtype=torch.int32)
    depth[0] = 0
    mask = torch.zeros((capacity, capacity), dtype=torch.bool)
    mask[0, 0] = True
    return Tree(tokens, logprob, parent, depth, mask, n_nodes=1,
                layer_start=0, layer_size=1)


def last_layer(tree: Tree, w: int):
    """Deepest layer padded to ``w``: (tokens [w], node_idx [w], valid [w],
    mask_rows [w, N] ancestor-or-self rows of those nodes)."""
    idx = tree.layer_start + torch.arange(w)
    valid = torch.arange(w) < tree.layer_size
    safe = torch.where(valid, idx, 0)
    tokens = torch.where(valid, tree.tokens[safe], 0).to(torch.int32)
    mask_rows = tree.mask[safe] & valid[:, None]
    return tokens, safe, valid, mask_rows


def tree_expand(tree: Tree, cand_tokens: torch.Tensor,
                cand_logprobs: torch.Tensor, w: int) -> Tree:
    """Append one layer from draft candidates of the current deepest layer.

    cand_tokens/cand_logprobs: [w, c], row i for the i-th node of the
    deepest layer (padded rows carry -1e30 log-probability).  Appends up to
    ``w`` nodes; ``layer_size`` counts the ones that fit and are valid.
    """
    n = tree.capacity
    c = cand_tokens.shape[1]
    row_valid = torch.arange(w) < tree.layer_size
    parent_idx = torch.where(row_valid, tree.layer_start + torch.arange(w), 0)
    neg = torch.tensor(NEG_INF, dtype=torch.float32)
    parent_lp = torch.where(row_valid, tree.logprob[parent_idx], neg)
    cum = cand_logprobs.float() + parent_lp[:, None]          # [w, c]
    cum = torch.where(row_valid[:, None], cum, neg)

    flat = cum.reshape(-1)
    k = min(w, flat.shape[0])
    top_lp, top_ix = torch.sort(flat, descending=True, stable=True)
    top_lp, top_ix = top_lp[:k], top_ix[:k]
    slot_ok = (torch.arange(k) < n - tree.n_nodes) & (top_lp > NEG_INF / 2)
    new_size = int(slot_ok.sum())

    sel_parent = parent_idx[top_ix // c]
    sel_token = cand_tokens.reshape(-1)[top_ix].to(torch.int32)
    start = tree.n_nodes
    dest = (start + torch.arange(k))[slot_ok]                 # kept slots
    sel_parent, sel_token = sel_parent[slot_ok], sel_token[slot_ok]

    tokens, logprob = tree.tokens.clone(), tree.logprob.clone()
    parent, depth = tree.parent.clone(), tree.depth.clone()
    mask = tree.mask.clone()
    tokens[dest] = sel_token
    logprob[dest] = top_lp[slot_ok]
    parent[dest] = sel_parent.to(torch.int32)
    depth[dest] = tree.depth[sel_parent] + 1
    new_rows = tree.mask[sel_parent]                          # parent rows
    new_rows[torch.arange(dest.shape[0]), dest] = True        # + self
    mask[dest] = new_rows
    return Tree(tokens, logprob, parent, depth, mask,
                n_nodes=start + new_size, layer_start=start,
                layer_size=new_size)


def find_child_with_token(tree: Tree, token: int, parent_idx: int = 0) -> int:
    """hit_index (paper 3.3.4): the first (highest-probability, BFS order)
    child of ``parent_idx`` whose token is ``token``; -1 on a miss."""
    hit = (tree.parent == parent_idx) & tree.valid() & \
        (tree.tokens == int(token))
    idx = hit.nonzero()
    return int(idx[0, 0]) if idx.numel() else -1


def root_argmax_child(tree: Tree) -> int:
    """Most probable depth-1 child (the first among equals)."""
    is_child = (tree.parent == 0) & (tree.depth == 1) & tree.valid()
    score = torch.where(is_child, tree.logprob,
                        torch.tensor(NEG_INF, dtype=torch.float32))
    return int(torch.argmax(score))


def tree_prune_to_child(tree: Tree, child_idx: int
                        ) -> Tuple[Tree, torch.Tensor]:
    """Prune to the subtree rooted at depth-1 node ``child_idx`` and compact
    it (paper 3.3.4: keep = column ``M[:, hit]``).

    Returns (new_tree, index_map [N] int32) with index_map[i] the new index
    of old node i, or -1 where it was dropped.
    """
    n = tree.capacity
    ar = torch.arange(n)
    keep = tree.mask[:, child_idx] & tree.valid()       # descendants-or-self
    index_map = torch.where(keep, torch.cumsum(keep, 0) - 1,
                            -1).to(torch.int32)
    new_n = int(keep.sum())

    # gather order: old indices of surviving nodes, BFS order preserved
    g = torch.argsort(torch.where(keep, ar, n + ar), stable=True)
    live = ar < new_n
    tokens = torch.where(live, tree.tokens[g], 0).to(torch.int32)
    logprob = torch.where(live, tree.logprob[g] - tree.logprob[child_idx],
                          torch.tensor(NEG_INF, dtype=torch.float32))
    depth = torch.where(live, tree.depth[g] - 1, -1).to(torch.int32)
    old_parent = tree.parent[g].long()
    parent = torch.where(
        live, torch.where(g == child_idx, -1,
                          index_map[old_parent.clamp_min(0)]),
        -1).to(torch.int32)
    mask = tree.mask[g][:, g] & live[:, None] & live[None, :]

    max_depth = int(torch.where(live, depth, -1).max())
    is_deepest = live & (depth == max_depth)
    layer_start = int(torch.argmax(is_deepest.to(torch.int32)))
    return Tree(tokens, logprob, parent, depth, mask, n_nodes=new_n,
                layer_start=layer_start,
                layer_size=int(is_deepest.sum())), index_map
