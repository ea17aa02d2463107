"""Serving front door: a request queue and two greedy execution modes.

  * ``mode="pp"``      - batched autoregressive decode, the paper's PP
                         baseline: requests are bucketed by prompt length and
                         decoded in lockstep batches of up to ``max_batch``
                         rows, each batch running to its longest
                         ``max_new_tokens``.
  * ``mode="pipedec"`` - latency-oriented: the pipeline works on one
                         request at a time with the dynamic prediction tree
                         (the paper's single-request system).

``mode="pipedec-db"`` (SpecPipe-DB continuous batching) is not ported yet:
asking for it raises ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from repro_torch.core.speculative import ModelBundle

MODES = ("pp", "pipedec")


@dataclasses.dataclass
class Request:
    """One generation request: prompt and token budget."""
    uid: int
    prompt: np.ndarray
    max_new_tokens: int = 32


@dataclasses.dataclass
class Result:
    """Per-request outcome: tokens, wall-clock latency and the engine's
    per-request stats (``GenStats`` in pipedec mode, None in pp mode)."""
    uid: int
    tokens: np.ndarray
    latency_s: float
    stats: Optional[object] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    """Queue ``Request``s, pick a mode and ``run()`` them."""

    def __init__(self, target: ModelBundle,
                 draft: Optional[ModelBundle] = None, *, mode: str = "pp",
                 max_batch: int = 8, max_len: int = 512,
                 pipedec: Optional[PipeDecConfig] = None):
        if mode == "pipedec-db":
            raise NotImplementedError(
                "mode='pipedec-db' (SpecPipe-DB) is not ported yet: "
                "ROADMAP.md queue 1, item 7 (SpecPipe-DB, local)")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode == "pipedec" and draft is None:
            raise ValueError("pipedec mode needs a draft model")
        self.target, self.draft, self.mode = target, draft, mode
        self.max_batch, self.max_len = max_batch, max_len
        self.pipedec_cfg = pipedec or PipeDecConfig()
        self.queue: List[Request] = []

    def submit(self, req: Request) -> None:
        """Queue one request."""
        self.queue.append(req)

    def _run_pp_batch(self, batch: List[Request]) -> List[Result]:
        t0 = time.perf_counter()
        tgt = self.target
        prompts = np.stack([r.prompt for r in batch]).astype(np.int64)
        b, s = prompts.shape
        new = max(r.max_new_tokens for r in batch)
        cache = tgt.init_cache(b, self.max_len)
        logits, cache = tgt.prefill(prompts, cache)
        toks = torch.argmax(logits, -1).tolist()
        outs = [[t] for t in toks]
        model_len = s
        for _ in range(new):
            logits, cache = tgt.decode(toks, cache, model_len)
            model_len += 1
            toks = torch.argmax(logits, -1).tolist()
            for out, t in zip(outs, toks):
                out.append(t)
        _sync(tgt.device)
        dt = time.perf_counter() - t0
        return [Result(r.uid, np.asarray(o[: r.max_new_tokens + 1]), dt)
                for r, o in zip(batch, outs)]

    def _run_pipedec_one(self, req: Request) -> Result:
        t0 = time.perf_counter()
        eng = PipeDecEngine(self.target, self.draft, self.pipedec_cfg,
                            max_len=self.max_len)
        out, stats = eng.generate(req.prompt, req.max_new_tokens)
        _sync(self.target.device)
        return Result(req.uid, out, time.perf_counter() - t0, stats)

    def run(self) -> Dict[int, Result]:
        """Serve every queued request; returns results by uid."""
        results: Dict[int, Result] = {}
        queue, self.queue = self.queue, []
        if self.mode == "pipedec":
            for req in queue:
                results[req.uid] = self._run_pipedec_one(req)
            return results
        buckets = collections.defaultdict(list)
        for r in queue:
            buckets[len(r.prompt)].append(r)
        for _, reqs in sorted(buckets.items()):
            for i in range(0, len(reqs), self.max_batch):
                for res in self._run_pp_batch(reqs[i: i + self.max_batch]):
                    results[res.uid] = res
        return results
