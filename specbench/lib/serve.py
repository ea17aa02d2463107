"""One run of a cell: the program set up from the seed, a closed loop of as
many clients as slots driven through ``SpecPipeDBEngine.steps()`` for the
window, every committed token stamped by the host clock, and the served
requests handed back for the check with the program's own logits of each
token they were served.

The program is always SpecPipe-DB over ``LocalFusedExecutor`` with a paged
arena and the target as its own draft; a mix's ``serving`` block sets the
slots, the page and the ``PipeDecConfig`` (n_stages, width, branch).

The first timestep admits the first ``slots`` requests (the loop's clients
all send at once; those requests stand for a loop in steady state) and
counts as set-up; the window starts after it on a full loop.  A finished
request frees its slot, and the next request of the list is sent at that
moment and admitted FIFO at the next timestep's refill.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from specbench.lib import counts, trace, traffic, weights

TRACE_STEPS = 20          # timesteps under the profiler in a traced run
DRAIN_STEPS = 8           # timesteps after the window for late first tokens
LOGIT_IDS = 2048          # vocabulary ids at which served logits are kept


@dataclasses.dataclass
class Step:
    end: float                # host clock at the end of the timestep
    flops: float = 0.0        # model FLOPs of its useful rows
    prefill_s: float = 0.0    # seconds inside executor.prefill
    traced: bool = False


@dataclasses.dataclass
class Run:
    cfg: dict
    mix: dict
    setup_s: float
    t0: float                 # window start and end, host clock
    t1: float
    steps: List[Step]
    stamps: Dict[int, List[float]]
    sent: Dict[int, float]    # send time of every request sent so far
    served: Dict[int, np.ndarray]   # tokens streamed to each request
    finished: List[int]
    requests: List[traffic.Req]
    weights: dict
    peak_setup_bytes: int = 0
    peak_window_bytes: int = 0
    logits: Optional["Capture"] = None
    trace: Optional[dict] = None
    attn_least_s: Optional[float] = None
    attn_calls: int = 0
    device: str = "cpu"
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def in_window(self, t: float) -> bool:
        return self.t0 <= t <= self.t1


class Capture:
    """The program's own logits of every token it serves, at ``ids`` (a
    seeded set of vocabulary ids): for a request's first token the last row
    of its admission prefill, for each later one the row of the exiting
    flight that ``exit_apply`` selects it from (the root's row of the fused
    verify).  Rows are gathered once a timestep (``flush``) and stay on the
    device: ``rows[uid][k]`` is the row of served token k."""

    def __init__(self, eng, reqs, ids: torch.Tensor):
        self.ids, self.reqs = ids, reqs
        self.rows: Dict[int, Dict[int, torch.Tensor]] = {r.uid: {}
                                                         for r in reqs}
        self.owner: Dict[int, int] = {}      # id(DecodeState) -> uid
        self.admitted = 0
        self.pending: list = []              # (uid, k, [V] row)
        inner = eng.inner
        real_init, real_exit = inner.init_state, inner.exit_apply

        def init_state(prompt, max_new_tokens, prefill_fn=None, **kw):
            req = reqs[self.admitted]        # admission is FIFO
            if not np.array_equal(np.asarray(prompt), req.prompt):
                raise RuntimeError("admission left the request list's order")
            self.admitted += 1

            def prefill(p):
                out = prefill_fn(p)
                self.pending.append((req.uid, 0, out[0]))
                return out
            st = real_init(prompt, max_new_tokens, prefill_fn=prefill, **kw)
            self.owner[id(st)] = req.uid
            return st

        def exit_apply(st, fl, root_row, **kw):
            self.pending.append((self.owner[id(st)], len(st.committed),
                                 fl.logits[root_row]))
            return real_exit(st, fl, root_row, **kw)

        inner.init_state, inner.exit_apply = init_state, exit_apply

    def flush(self) -> None:
        """One gather of the timestep's rows at ``ids``."""
        if not self.pending:
            return
        got = torch.stack([r for _, _, r in self.pending]).index_select(
            1, self.ids)
        for (uid, k, _), row in zip(self.pending, got):
            self.rows[uid][k] = row
        self.pending = []


def logit_ids(seed: int, vocab: int, device) -> torch.Tensor:
    """The seeded, sorted vocabulary ids at which served logits are kept."""
    n = min(LOGIT_IDS, vocab)
    pick = np.sort(traffic.seed_bits(seed, 4).choice(vocab, n, replace=False))
    return torch.as_tensor(pick, device=device)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels() -> None:
    """Compile the attention kernels the path launches, one nvcc each at
    once, into the checkout's build directory (reused once built)."""
    from repro_torch.kernels import build
    build.build(["flash_attention_lse", "tree_block_attention"])


def max_len_of(mix: dict, tree_rows: int, page: int) -> int:
    rows = (mix["prompt_tokens"]["max"] + mix["output_tokens"]["max"] + 1
            + tree_rows)
    return -(-rows // page) * page


def run(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float) -> Run:
    import repro_torch  # noqa: F401  (switches TF32 off)
    from repro_torch.core.pipedec import PipeDecConfig
    from repro_torch.serving import LocalFusedExecutor
    from repro_torch.serving.dynbatch import SpecPipeDBEngine
    from repro_torch.serving.engine import Request
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the engine's host work is small CPU tensors: one thread runs it
    # without a pool's wake-ups, and steadier from run to run
    torch.set_num_threads(1)
    sv = mix["serving"]
    if mix["clients"] != sv["slots"]:
        raise ValueError("a closed loop of as many clients as slots")
    parts = {"start": time.perf_counter() - t_start}
    if device.type == "cuda":
        build_kernels()
    parts["kernels"] = time.perf_counter() - t_start
    ref, _ = weights.family(cfg)
    w = weights.make(ref.weight_spec(cfg), seed, device)
    target = weights.port_model(cfg, w)
    sync(device)
    parts["weights"] = time.perf_counter() - t_start
    pcfg = PipeDecConfig(n_stages=sv["n_stages"], width=sv["width"],
                         branch=sv["branch"])
    slots = sv["slots"]
    max_len = max_len_of(mix, pcfg.tree_buffer_capacity, sv["page"])
    ex = LocalFusedExecutor(target, target, slots=slots, max_len=max_len,
                            tree_capacity=pcfg.tree_buffer_capacity,
                            capacity=pcfg.capacity, paged=True,
                            page=sv["page"])
    eng = SpecPipeDBEngine(target, target, pcfg, max_len=max_len,
                           max_slots=slots, executor=ex)
    reqs = traffic.requests(mix, seed, cfg["vocab_size"])
    if len(reqs) <= slots:
        raise ValueError("the request list must outlast the first admission")
    for r in reqs:
        eng.submit(Request(r.uid, r.prompt, r.max_new_tokens))
    cap = Capture(eng, reqs, logit_ids(seed, cfg["vocab_size"], device))

    # the harness's wrappers around the calls into the executor: FLOPs of
    # the useful rows (target and its self-draft alike), prefill seconds,
    # host spans in the traced window
    state = {"tracing": False, "step": Step(0.0)}

    def prefill(slot, prompt, real=ex.prefill):
        if traced:
            sync(device)
        a = time.perf_counter()
        with trace.span("prefill", state["tracing"]):
            out = real(slot, prompt)
        if traced:
            sync(device)
        state["step"].prefill_s += time.perf_counter() - a
        state["step"].flops += 2 * counts.prefill_flops(
            cfg, int(np.asarray(prompt).shape[-1]))
        return out

    def verify_rows(tokens, positions, masks, model_len, write_idx, row_on,
                    real=ex.verify_rows):
        state["step"].flops += 2 * counts.verify_flops(
            cfg, model_len, np.asarray(masks), row_on)
        with trace.span("verify_rows", state["tracing"]):
            return real(tokens, positions, masks, model_len, write_idx,
                        row_on)

    def wrap(name):
        real = getattr(ex, name)

        def call(*a, **kw):
            with trace.span(name, state["tracing"]):
                return real(*a, **kw)
        return call

    ex.prefill, ex.verify_rows = prefill, verify_rows
    ex.commit_rows, ex.remap_rows = wrap("commit_rows"), wrap("remap_rows")

    stamps: Dict[int, List[float]] = {r.uid: [] for r in reqs}
    served: Dict[int, List[int]] = {r.uid: [] for r in reqs}

    def on_token(uid, tok, timestep):
        stamps[uid].append(time.perf_counter())
        served[uid].append(tok)

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if traced:
        # the profiler's first start sets up its tracer for seconds: done
        # here, so that the traced timesteps are not slowed by it
        with profile(activities=acts):
            torch.ones(1, device=device).add_(1)
            sync(device)
    gen = eng.steps(seed=seed, on_token=on_token)
    parts["engine"] = time.perf_counter() - t_start
    next(gen)
    cap.flush()
    sync(device)
    setup_s = time.perf_counter() - t_start
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sent = {r.uid: -np.inf for r in reqs[:slots]}   # sent during set-up
    steps: List[Step] = []
    done = len(eng.results)
    paged = trace.PagedCalls() if traced else None
    prof, window_span, traced_steps = None, None, 0

    def stop_trace():
        sync(device)
        window_span.__exit__(None, None, None)
        prof.stop()
        state["tracing"] = paged.on = False

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if traced and prof is None and \
                time.perf_counter() - t0 >= seconds / 4:
            sync(device)
            prof = profile(activities=acts)
            prof.start()
            window_span = trace.span("window", True)
            window_span.__enter__()
            state["tracing"] = paged.on = True
        step = state["step"] = Step(0.0, traced=state["tracing"])
        try:
            next(gen)
        except StopIteration:
            raise RuntimeError("the request list ran out inside the window")
        cap.flush()
        now = step.end = time.perf_counter()
        steps.append(step)
        for _ in range(len(eng.results) - done):
            nxt = len(sent)
            if nxt < len(reqs):
                sent[reqs[nxt].uid] = now
        done = len(eng.results)
        if state["tracing"]:
            traced_steps += 1
            if traced_steps >= TRACE_STEPS:
                stop_trace()
    sync(device)
    t1 = time.perf_counter()
    if state["tracing"]:        # the window closed inside the traced run
        stop_trace()
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    # requests sent inside the window get their first token (late, not
    # lost: the wait counts in their time to first token)
    for _ in range(DRAIN_STEPS):
        if all(stamps[u] for u in sent):
            break
        next(gen, None)
        cap.flush()
    gen.close()
    out = Run(cfg=cfg, mix=mix, setup_s=setup_s, t0=t0, t1=t1, steps=steps,
              stamps=stamps, sent=sent,
              served={u: np.asarray(t, np.int64) for u, t in served.items()
                      if t},
              finished=sorted(eng.results),
              requests=reqs, weights=w, logits=cap,
              peak_setup_bytes=peak_setup,
              peak_window_bytes=peak_window, device=str(device),
              setup_parts=parts)
    if prof is not None:
        out.trace = trace.reduce(prof, traced_steps)
        out.attn_least_s = paged.least_s()
        out.attn_calls = len(paged.calls)
    if paged is not None:
        paged.restore()
    del eng, ex, gen, target, prof, paged
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def ttft_ms(run: Run, q: float) -> Optional[float]:
    """The q-th percentile of send-to-first-token over every request sent
    in the window, or None if one of them never got its first token."""
    sent = {u: s for u, s in run.sent.items() if run.in_window(s)}
    if not sent or not all(run.stamps[u] for u in sent):
        return None
    return 1e3 * float(np.percentile(
        [run.stamps[u][0] - s for u, s in sent.items()], q))


def untraced(run: Run) -> list:
    """(seconds, Step) of every timestep of the window outside the traced
    timesteps."""
    out, prev = [], run.t0
    for s in run.steps:
        if not s.traced:
            out.append((s.end - prev, s))
        prev = s.end
    return out
