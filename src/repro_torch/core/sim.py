"""Wall-clock model of the deployments (PP / STPP / PipeDec /
SpecPipe-DB): the paper's Fig. 5 / Fig. 8 cost model, in plain Python.

The logical engines (``pipedec.py``, ``baselines.py``, ``chain.py``) give
exact token traces and acceptance statistics; this module prices those
traces in seconds from per-stage hardware times (``StageHardware``), which
the caller measures or derives (``stage_hardware_from_roofline``: layer
times, the stage hand-off's link rate and the per-timestep sync cost, all
given explicitly).  The same functions and signatures as the JAX
package's ``repro/core/sim.py``; only ``stage_hardware_from_roofline``
takes ``link_bw`` and ``t_sync`` without defaults.

Timing model (paper §2.4):
  PP        latency/token  = Σ_i T_c,i + Σ_i T_t,i
  PipeDec   timestep       = max(T_draft, C·max_i T_c,i + max_i T_t,i)
            latency/token  = timestep / tokens_per_timestep(measured)
  STPP      round          = depth·T_draft + Σ_i T_c,i(tree) + Σ T_t,i
            latency/token  = round / (accepted_per_round + 1)
  SpecPipe-DB  timestep    = max(T_draft·s(B), s(B)·max_i T_c,i + max T_t,i)
            throughput     = B · tokens_per_timestep / timestep
            TBT            = timestep / tokens_per_timestep
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class StageHardware:
    """Per-stage times in seconds for a given verification width."""
    n_stages: int
    t_stage_one: float        # stage compute, width-1 (vanilla decode)
    t_stage_width: float      # stage compute, width-w tree layer (C·max T_c)
    t_comm: float             # inter-stage activation transfer
    t_draft: float            # draft model full forward (one tree layer)
    t_sync: float = 0.0       # hit_index broadcast + prune


def pp_latency_per_token(hw: StageHardware) -> float:
    """Seconds/token for plain PP: one full ring traversal per token."""
    return hw.n_stages * hw.t_stage_one + (hw.n_stages - 1) * hw.t_comm


def pipedec_latency_per_token(hw: StageHardware,
                              tokens_per_timestep: float) -> float:
    """Seconds/token for single-request SpecPipe: one timestep
    (max(draft, hop) + sync) amortised over tokens/timestep.
    """
    timestep = max(hw.t_draft, hw.t_stage_width + hw.t_comm) + hw.t_sync
    return timestep / max(tokens_per_timestep, 1e-9)


def stpp_latency_per_token(hw: StageHardware, depth: int,
                           mean_accepted: float) -> float:
    """Seconds/token for STPP: a serial draft+full-verify round
    amortised over the mean accepted path.
    """
    t_round = depth * hw.t_draft \
        + hw.n_stages * hw.t_stage_width + (hw.n_stages - 1) * hw.t_comm
    return t_round / (mean_accepted + 1.0)


def stage_hardware_from_roofline(
        *, n_stages: int, layer_time_one: float, layer_time_width: float,
        layers_per_stage: float, bytes_per_activation: float,
        link_bw: float, t_draft: float = 0.0,
        t_sync: float) -> StageHardware:
    """Build stage times from per-layer times.

    layer_time_one/width: the time of one target layer at verification
    width 1 / w (measured, or the dominant roofline term); the hand-off
    prices one activation tensor at ``link_bw`` bytes per second over the
    link between two stages (the paper's 10 GbE is one such link);
    ``t_sync`` is the per-timestep hit-index broadcast and prune.  Both
    describe the deployment being modelled, so neither has a default.
    """
    return StageHardware(
        n_stages=n_stages,
        t_stage_one=layer_time_one * layers_per_stage,
        t_stage_width=layer_time_width * layers_per_stage,
        t_comm=bytes_per_activation / link_bw,
        t_draft=t_draft,
        t_sync=t_sync)


# --------------------------------------------------------------------------
# throughput (Fig. 8): k concurrent requests
# --------------------------------------------------------------------------
def pp_throughput(hw: StageHardware, batch: int,
                  batch_scale: Callable[[int], float] = None) -> float:
    """Tokens/s for PP with ``batch`` concurrent requests: the pipeline
    overlaps batches, so steady-state emits ``batch`` tokens per pipeline
    *stage* time (all stages busy on different requests)."""
    s = batch_scale(batch) if batch_scale else 1.0
    stage = hw.t_stage_one * s + hw.t_comm
    # pipeline full: one batch of tokens per stage-time
    return batch / stage if batch >= hw.n_stages else \
        batch / (hw.n_stages * stage / max(batch, 1))


def pipedec_throughput(hw: StageHardware, batch: int,
                       tokens_per_timestep: float,
                       batch_scale: Callable[[int], float] = None) -> float:
    """PipeDec serialises tasks (whole pipeline per task), so throughput is
    batch-independent: tokens/s = 1/latency."""
    del batch, batch_scale
    return 1.0 / pipedec_latency_per_token(hw, tokens_per_timestep)


def stpp_throughput(hw: StageHardware, batch: int, depth: int,
                    mean_accepted: float,
                    batch_scale: Callable[[int], float] = None) -> float:
    """Tokens/s for STPP with ``batch`` tasks overlapping their verify
    passes across stages.
    """
    s = batch_scale(batch) if batch_scale else 1.0
    stage = hw.t_stage_width * s + hw.t_comm
    # with k≥1 concurrent tasks the pipeline overlaps different tasks'
    # verify passes; draft runs on its own device, overlapped.
    rounds_per_s = min(batch, hw.n_stages) / (hw.n_stages * stage)
    tokens_per_round = mean_accepted + 1.0
    return rounds_per_s * tokens_per_round


# --------------------------------------------------------------------------
# SpecPipe-DB (dynamic batching): ``batch`` requests share every pipeline
# timestep — their tree layers are stacked along the batch axis in each
# stage, so stage compute grows by batch_scale(batch) (sub-linear while the
# verify pass stays memory-bound) while token output grows linearly with
# occupancy.  Engine: repro_torch.serving.dynbatch.SpecPipeDBEngine.
# --------------------------------------------------------------------------
def specpipe_db_timestep(hw: StageHardware, batch: int,
                         batch_scale: Callable[[int], float] = None) -> float:
    """``batch_scale(batch)`` is the stage-time inflation from stacking
    ``batch`` width-w layers in one verify pass.  ``None`` models the fully
    memory-bound regime (stage time independent of batch — param streaming
    dominates), the SAME convention as ``pp_throughput``/``stpp_throughput``
    above; pass a roofline-derived scale for a finite-compute curve."""
    s = batch_scale(batch) if batch_scale else 1.0
    return max(hw.t_draft * s, hw.t_stage_width * s + hw.t_comm) + hw.t_sync


def specpipe_db_throughput(hw: StageHardware, batch: int,
                           tokens_per_timestep: float,
                           batch_scale: Callable[[int], float] = None
                           ) -> float:
    """Tokens/s with ``batch`` concurrent requests: each timestep emits
    ~``batch * tokens_per_timestep`` tokens (per-request acceptance is
    unchanged by batching — the DB engine runs the same per-request
    schedule, only stacked)."""
    ts = specpipe_db_timestep(hw, batch, batch_scale)
    return batch * tokens_per_timestep / ts


def specpipe_db_tbt(hw: StageHardware, batch: int,
                    tokens_per_timestep: float,
                    batch_scale: Callable[[int], float] = None) -> float:
    """Time-between-tokens for ONE request under DB (the paper's TBT
    metric): each request still advances every timestep, so TBT degrades
    only by the batched stage-time inflation, not by round-robin stalls."""
    ts = specpipe_db_timestep(hw, batch, batch_scale)
    return ts / max(tokens_per_timestep, 1e-9)


# --------------------------------------------------------------------------
# SpecPipe-DB on a sharded deployment (one pipeline stage per device):
# the batched tree layers ride the stage-to-stage activation ring, so the
# per-hop transfer cost is explicit.  ``flush=True`` prices the
# synchronous-flush schedule (each timestep pushes the batched entry
# through all n_stages hops inside one dispatch — the bit-exact reference
# schedule); ``flush=False`` prices the steady-state overlapped
# deployment (ring always full, ONE tick per timestep with deferred exit
# logits and in-ring pruning propagation — the paper's wall-clock
# regime).  The JAX package runs both (its ``ShardedPipelineExecutor``
# and ``OverlappedShardedExecutor``); the port does not have them yet.
#
# Steady-state cost terms:
#   * ``ctrl_rate`` × ``t_ctrl`` — the gated in-ring ctrl: only the
#     fraction of ticks whose ctrl message is active pays the per-stage
#     commit-scatter + prune-gather cost ``t_ctrl`` (ungated executors
#     pay it every tick: ``ctrl_rate=1``; the measured rate is
#     ``calls["ctrl_active_ticks"] / calls["pipeline_tick"]``).
#   * ``prefill_rate`` × ``t_prefill`` — admission prefill: the flush
#     schedule pays a separate prefill dispatch per admission
#     (``prefill_rate`` admissions per timestep); the overlapped schedule
#     rides the prompt through the tick's prefill lane (prefill-in-ring),
#     so the separate term vanishes and only the (already-counted) hop is
#     paid.
# --------------------------------------------------------------------------
def specpipe_db_sharded_timestep(hw: StageHardware, batch: int,
                                 batch_scale: Callable[[int], float] = None,
                                 flush: bool = False,
                                 ctrl_rate: float = 0.0,
                                 t_ctrl: float = 0.0,
                                 prefill_rate: float = 0.0,
                                 t_prefill: float = 0.0) -> float:
    """Per-timestep cost of the sharded deployment: flush pays
    n_stages hops + separate ctrl/prefill dispatches; overlapped
    pays ONE hop with gated ctrl riding it.
    """
    s = batch_scale(batch) if batch_scale else 1.0
    hop = hw.t_stage_width * s + hw.t_comm
    if flush:
        # flush: n_stages hops per timestep, a separate central
        # commit/remap application (ctrl_rate prices how often), and a
        # separate prefill dispatch per admission
        steps = hw.n_stages * hop + ctrl_rate * t_ctrl \
            + prefill_rate * t_prefill
        return max(hw.t_draft * s, steps) + hw.t_sync
    # overlapped: ONE hop per timestep; the gated ctrl rides the hop only
    # on active ticks, and prefill-in-ring amortises admission into the
    # same hop (no separate term)
    return max(hw.t_draft * s, hop + ctrl_rate * t_ctrl) + hw.t_sync


def specpipe_db_sharded_throughput(hw: StageHardware, batch: int,
                                   tokens_per_timestep: float,
                                   batch_scale: Callable[[int], float]
                                   = None, flush: bool = False,
                                   **cost_terms) -> float:
    """Tokens/s = batch * tokens_per_timestep / sharded timestep."""
    ts = specpipe_db_sharded_timestep(hw, batch, batch_scale, flush,
                                      **cost_terms)
    return batch * tokens_per_timestep / ts


def specpipe_db_sharded_tbt(hw: StageHardware, batch: int,
                            tokens_per_timestep: float,
                            batch_scale: Callable[[int], float] = None,
                            flush: bool = False, **cost_terms) -> float:
    """Time-between-tokens = sharded timestep / tokens_per_timestep."""
    ts = specpipe_db_sharded_timestep(hw, batch, batch_scale, flush,
                                      **cost_terms)
    return ts / max(tokens_per_timestep, 1e-9)


# --------------------------------------------------------------------------
# Async free-running stages + disaggregated draft (the JAX package's
# ``AsyncPipelineExecutor``): no host lockstep, so the per-timestep host
# synchronisation term ``t_sync`` — the barrier the overlapped schedule
# still pays to dispatch its one tick and broadcast hit indices — drops
# out entirely.  The draft term leaves the max() too: the disaggregated
# draft actor speculates on its own device concurrently with the target
# hops, so steady-state throughput is gated by the slowest stage hop (plus
# the gated ctrl share), with the draft only binding if it is slower than
# the whole target pipe — the PipeInfer/PipeSpec regime.
# --------------------------------------------------------------------------
def specpipe_db_async_timestep(hw: StageHardware, batch: int,
                               batch_scale: Callable[[int], float] = None,
                               ctrl_rate: float = 0.0,
                               t_ctrl: float = 0.0) -> float:
    """Steady-state per-timestep cost of the async free-running schedule:
    ``max(draft, hop + ctrl_rate * t_ctrl)`` with NO ``t_sync`` — the
    lockstep barrier is gone, and per-stage inbox queues absorb jitter."""
    s = batch_scale(batch) if batch_scale else 1.0
    hop = hw.t_stage_width * s + hw.t_comm
    return max(hw.t_draft * s, hop + ctrl_rate * t_ctrl)


def specpipe_db_async_throughput(hw: StageHardware, batch: int,
                                 tokens_per_timestep: float,
                                 batch_scale: Callable[[int], float]
                                 = None, **cost_terms) -> float:
    """Tokens/s = batch * tokens_per_timestep / async timestep."""
    ts = specpipe_db_async_timestep(hw, batch, batch_scale, **cost_terms)
    return batch * tokens_per_timestep / ts


def specpipe_db_async_tbt(hw: StageHardware, batch: int,
                          tokens_per_timestep: float,
                          batch_scale: Callable[[int], float] = None,
                          **cost_terms) -> float:
    """Time-between-tokens = async timestep / tokens_per_timestep."""
    ts = specpipe_db_async_timestep(hw, batch, batch_scale, **cost_terms)
    return ts / max(tokens_per_timestep, 1e-9)
