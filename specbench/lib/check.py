"""How ``correct`` is decided: the plain reference over a seeded sample of the
requests the run served, against what the program served them.

A request's served tokens are every token streamed to it by the close of the
run, finished or not: a decode window of 32 slots finishes few requests, and
a token streamed is an answer the user already has.  At each served token's
position ``compare`` reads two things against the reference's logits there:

- the gap by which the served token's logit lies below the reference's best
  (served tokens are greedy, so on a sound run it is 0 or a near tie);
- the program's own logits of that token (``serve.Capture``, at a seeded
  set of vocabulary ids): the largest distance from the reference's, over
  the root mean square of the reference's at those ids.

``numbers`` keeps the widest gap and the median of the distances, and
``judge`` holds them to the configuration's limits
(``limits/<configuration>.json``, with the readings they were set from).
The control is the reference itself in the next precision below the
configuration's (TF32 products for float32 with TF32 off), put in the
program's place: its argmax as the served tokens, its logits as the
program's, through the same ``compare``, ``numbers`` and ``judge``.
"""
from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from specbench.lib import traffic, weights

LIMITS = Path(__file__).resolve().parents[1] / "limits"
MIN_TOKENS = 64           # served tokens the sample must hold at least
# the distances are held at their median: a precision below the
# configuration's moves every token's logits, while an fp32 near tie in a
# router (MoE) moves a few tokens' far; the widest gap catches a token
# altered where it is produced
DIST_QUANTILE = 0.5


def sample(run, seed: int) -> List[int]:
    """The request with the most served tokens, and others drawn from the
    seed up to the mix's ``check.requests``."""
    fin = sorted(run.served, key=lambda u: (-len(run.served[u]), u))
    if not fin:
        return []
    rest = fin[1:]
    n = min(run.mix["check"]["requests"] - 1, len(rest))
    pick = traffic.seed_bits(seed, 3).choice(len(rest), n, replace=False) \
        if n else []
    return [fin[0]] + [rest[i] for i in sorted(pick)]


def sequences(run, uids) -> List[Tuple[np.ndarray, np.ndarray]]:
    prompts = {r.uid: r.prompt for r in run.requests}
    return [(prompts[u], run.served[u]) for u in uids]


@contextlib.contextmanager
def precision(mode: str, device):
    """``fp32`` (TF32 off) or ``tf32``: TF32 products on the card, and on
    the CPU products of operands rounded to TF32's 10-bit mantissa."""
    if mode == "fp32":
        yield
        return
    if device.type == "cuda":
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        return
    with _Tf32Products():
        yield


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (10 mantissa bits)."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


class _Tf32Products(torch.overrides.TorchFunctionMode):
    OPS = {torch.matmul, torch.Tensor.__matmul__, torch.Tensor.matmul}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            args = tuple(tf32_round(a) if isinstance(a, torch.Tensor) else a
                         for a in args)
        return func(*args, **(kwargs or {}))


def ref_logits(w: dict, cfg: dict, prompt, served, device) -> torch.Tensor:
    """The reference's logits [len(served), V] at the served tokens'
    positions (token i is predicted at position len(prompt) - 1 + i)."""
    ref, _ = weights.family(cfg)
    seq = torch.as_tensor(np.concatenate([prompt, served]), device=device)
    with torch.no_grad():
        out = ref.logits(w, cfg, seq)
    return out[len(prompt) - 1: len(prompt) - 1 + len(served)]


def compare(ref: torch.Tensor, ids: torch.Tensor, got: torch.Tensor,
            tokens) -> Tuple[float, torch.Tensor]:
    """(widest gap of ``tokens`` below the best of ``ref`` [n, V], the
    distance of ``got`` [n, K] from ``ref`` at ``ids`` for each row)."""
    tok = torch.as_tensor(np.asarray(tokens), device=ref.device)
    gap = float((ref.max(1).values - ref.gather(1, tok[:, None])[:, 0]).max())
    want = ref.index_select(1, ids)
    dist = (got.to(ref.device) - want).abs().max(1).values \
        / want.pow(2).mean(1).sqrt()
    return gap, dist


def limits_of(cfg: dict) -> dict:
    """The configuration's limits file; one without it fails its check."""
    path = LIMITS / f"{cfg['name']}.json"
    return json.loads(path.read_text()) if path.exists() else \
        {"max_logit_gap": -1.0, "logit_dist": -1.0}


def numbers(gaps: List[float], dists: List[torch.Tensor], limits: dict,
            tokens: int) -> Dict:
    """The compared numbers over a sample, each with its limit."""
    d = torch.cat(dists).double() if dists else torch.ones(1)
    return {"max_logit_gap": {"value": max(gaps, default=float("inf")),
                              "limit": limits["max_logit_gap"]},
            "logit_dist_median": {
                "value": float(torch.quantile(d, DIST_QUANTILE)),
                "limit": limits["logit_dist"]},
            "served_tokens_checked": {"value": tokens, "limit": MIN_TOKENS}}


def judge(compared: Dict) -> bool:
    """Every number at or under its limit, and enough tokens checked."""
    return all((v["value"] >= v["limit"]) if k == "served_tokens_checked"
               else (v["value"] <= v["limit"]) for k, v in compared.items())


def program_rows(run, uid: int, n: int):
    """The program's kept rows of a request's first ``n`` served tokens
    [n, K], or None if one is missing."""
    rows = run.logits.rows.get(uid, {})
    if any(k not in rows for k in range(n)):
        return None
    return torch.stack([rows[k] for k in range(n)])


def check(run, seed: int, device) -> Dict:
    """The compared numbers of a run, each with its limit, and ``correct``."""
    uids = sample(run, seed)
    limits = limits_of(run.cfg)
    ids = run.logits.ids.to(device)
    gaps, dists, tokens, whole = [], [], 0, True
    for uid, (prompt, served) in zip(uids, sequences(run, uids)):
        got = program_rows(run, uid, len(served))
        if got is None:
            whole = False
            continue
        ref = ref_logits(run.weights, run.cfg, prompt, served, device)
        gap, dist = compare(ref, ids, got, served)
        gaps.append(gap)
        dists.append(dist.cpu())
        tokens += len(served)
        del ref
    compared = numbers(gaps, dists, limits, tokens)
    ok = bool(uids) and whole and judge(compared)
    return {"correct": ok, "compared": compared, "uids": uids,
            "max_dist": float(torch.cat(dists).max()) if dists else None}


def control(run, seed: int, device) -> Dict:
    """The program's numbers and the control's over the same sample: the
    reference with TF32 products in the program's place."""
    limits = limits_of(run.cfg)
    ids = run.logits.ids.to(device)
    prog = check(run, seed, device)
    gaps, dists, tokens = [], [], 0
    for prompt, served in sequences(run, prog["uids"]):
        with precision("fp32", device):
            full = ref_logits(run.weights, run.cfg, prompt, served, device)
        with precision("tf32", device):
            low = ref_logits(run.weights, run.cfg, prompt, served, device)
        gap, dist = compare(full, ids, low.index_select(1, ids),
                            low.argmax(1).cpu().numpy())
        gaps.append(gap)
        dists.append(dist.cpu())
        tokens += len(served)
        del full, low
    ctrl = numbers(gaps, dists, limits, tokens)
    return {"program": prog["compared"], "program_correct": prog["correct"],
            "program_max_dist": prog["max_dist"],
            "control": ctrl, "control_correct": judge(ctrl),
            "control_max_dist": float(torch.cat(dists).max())}
