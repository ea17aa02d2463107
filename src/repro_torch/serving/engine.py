"""Serving front door: a request queue and three execution modes.

  * ``mode="pp"``         - batched autoregressive decode, the paper's PP
                            baseline: requests are bucketed by prompt
                            length and decoded in lockstep batches of up
                            to ``max_batch`` rows, each batch running to
                            its longest ``max_new_tokens``.  The first
                            token is the prefill's argmax; each decode
                            step samples per row from ``sampling`` when
                            its temperature is above 0 (``generator``
                            draws), else takes the argmax.
  * ``mode="pipedec"``    - latency-oriented: the pipeline works on one
                            request at a time with the dynamic prediction
                            tree (the paper's single-request system).
  * ``mode="pipedec-db"`` - SpecPipe-DB dynamic batching
                            (``serving.dynbatch.SpecPipeDBEngine``): up to
                            ``max_batch`` requests' trees share every
                            pipeline timestep, and finished requests are
                            replaced from the queue without draining the
                            pipeline.  ``executor`` picks the compute
                            backend (default: the dense local arena;
                            ``LocalFusedExecutor(paged=True)`` the paged
                            one); the run's ``DBStats`` stay in
                            ``db_stats``.

Every mode stops a request at ``eos_token``, the eos included.  A
recurrent target (Mamba-2, RecurrentGemma) is served in pp mode; the two
tree modes refuse it (``transformer.check_tree_supported``: recurrent
models speculate in chain mode, ``core.chain``).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from repro_torch.core.speculative import (ModelBundle, SamplingParams,
                                          select_token)
from repro_torch.models import transformer as tf

MODES = ("pp", "pipedec", "pipedec-db")


@dataclasses.dataclass
class Request:
    """One generation request: prompt and token budget, plus the DB
    mode's admission knobs and a per-request sampling override."""
    uid: int
    prompt: np.ndarray
    max_new_tokens: int = 32
    arrival_t: int = 0        # arrival time in pipeline timesteps (DB mode)
    priority: int = 0         # admission priority (higher = sooner; ties
                              # and all-default traffic are exact FIFO)
    deadline_t: Optional[int] = None   # boosts admission as it nears
    sampling: Optional[SamplingParams] = None  # overrides the engine's


@dataclasses.dataclass
class Result:
    """Per-request outcome: tokens, wall-clock latency and the engine's
    per-request stats (``GenStats`` in the pipedec modes, None in pp
    mode)."""
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
                 pipedec: Optional[PipeDecConfig] = None,
                 sampling: SamplingParams = SamplingParams(),
                 eos_token: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 executor=None):
        """``sampling`` and ``generator`` (on the target's device) drive
        pp mode's decode steps; None draws each batch from a generator
        seeded with 0.  The speculative modes sample per request
        (``Request.sampling``, else ``pipedec.sampling``)."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode != "pp" and draft is None:
            raise ValueError(f"{mode} mode needs a draft model")
        if executor is not None and mode != "pipedec-db":
            raise ValueError("executor backends apply to mode='pipedec-db'")
        if mode != "pp":   # the tree modes: recurrent models run pp only
            for bundle in (target, draft):
                tf.check_tree_supported(bundle.cfg, f"{mode}'s tree verify")
        self.target, self.draft, self.mode = target, draft, mode
        self.max_batch, self.max_len = max_batch, max_len
        self.pipedec_cfg = pipedec or PipeDecConfig()
        self.sampling, self.eos_token = sampling, eos_token
        self.generator = generator
        self.executor = executor
        self.db_stats = None      # DBStats after a mode="pipedec-db" run
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
        gen = self.generator
        if gen is None and self.sampling.temperature > 0:
            gen = torch.Generator(device=tgt.device)
            gen.manual_seed(0)
        for _ in range(new):
            logits, cache = tgt.decode(toks, cache, model_len)
            model_len += 1
            if self.sampling.temperature > 0:
                toks = [select_token(row, self.sampling, gen)
                        for row in logits]
            else:
                toks = torch.argmax(logits, -1).tolist()
            for out, t in zip(outs, toks):
                out.append(t)
        _sync(tgt.device)
        dt = time.perf_counter() - t0
        return [Result(r.uid, self._cut(o[: r.max_new_tokens + 1]), dt)
                for r, o in zip(batch, outs)]

    def _cut(self, tokens: List[int]) -> np.ndarray:
        """Tokens up to the first ``eos_token``, the eos included."""
        if self.eos_token is not None and self.eos_token in tokens:
            tokens = tokens[: tokens.index(self.eos_token) + 1]
        return np.asarray(tokens)

    def _run_pipedec_one(self, req: Request) -> Result:
        t0 = time.perf_counter()
        eng = PipeDecEngine(self.target, self.draft, self.pipedec_cfg,
                            max_len=self.max_len)
        out, stats = eng.generate(req.prompt, req.max_new_tokens,
                                  eos=self.eos_token, sampling=req.sampling)
        _sync(self.target.device)
        return Result(req.uid, out, time.perf_counter() - t0, stats)

    def run(self, on_token=None) -> Dict[int, Result]:
        """Serve every queued request; returns results by uid.
        ``on_token(uid, token, timestep)`` streams committed tokens in
        mode="pipedec-db" (the batch modes ignore it)."""
        results: Dict[int, Result] = {}
        queue, self.queue = self.queue, []
        if self.mode == "pipedec":
            for req in queue:
                results[req.uid] = self._run_pipedec_one(req)
            return results
        if self.mode == "pipedec-db":
            from repro_torch.serving.dynbatch import SpecPipeDBEngine
            eng = SpecPipeDBEngine(self.target, self.draft, self.pipedec_cfg,
                                   max_len=self.max_len,
                                   max_slots=self.max_batch,
                                   eos_token=self.eos_token,
                                   executor=self.executor)
            for req in queue:
                eng.submit(req)
            results = eng.run(on_token=on_token)
            _sync(self.target.device)
            self.db_stats = eng.stats
            return results
        buckets = collections.defaultdict(list)
        for r in queue:
            buckets[len(r.prompt)].append(r)
        for _, reqs in sorted(buckets.items()):
            for i in range(0, len(reqs), self.max_batch):
                for res in self._run_pp_batch(reqs[i: i + self.max_batch]):
                    results[res.uid] = res
        return results
