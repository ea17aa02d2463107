#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printed as JSON objects, one per line:

  1. card      - device name, power limit (as nvidia-smi reports it), the
                 kernels' build time from ``src/repro_torch/csrc`` and what
                 each kernel instance compiles to (ptxas registers, shared
                 memory and spills; counts of tensor-core MMAs and
                 asynchronous copies in its SASS);
  2. kernels   - each hand-written kernel, in each of its modes (fp32 and
                 int8 K/V for the attention kernels), against its plain
                 PyTorch version on the card at the main path's shapes,
                 at STPP's whole-tree verify (33 queries, a 41-row tree
                 buffer with fully masked rows) and, for the head_dim 256
                 instances (the ``hd256`` rows), at Gemma-7b's: max
                 errors against the stated tolerances, kernel / plain /
                 library times (CUDA events) and the least time the card
                 could take; the dequant-matmul's M-independence (every row
                 of each case, and rows of an M = 128 call, give the same
                 bits as M = 1 calls); the paged attention kernels' batch
                 independence (each row of a bucket-3 case gives the same
                 bits as a B = 1 call); the tree-verify entry points, whose tree
                 kernel merges the committed-prefix half in its epilogue,
                 against ops.combine_lse over the two kernels' halves; and
                 one CUDA launch per wrapper call of every kernel, two per
                 tree-verify entry point (torch.profiler);
  3. serve     - the main path: ServingEngine(mode="pipedec") over the
                 paper's pair at published widths (target cut to 8 layers,
                 one per pipeline stage, the draft to 4; 3 requests;
                 seeded random weights), greedy
                 tokens checked against plain autoregressive decoding, and
                 the kernels' launch counts checked against the model calls;
  4. self-draft - draft = target: every tree prediction must hit;
  5. serve-db  - SpecPipe-DB (``ServingEngine(mode="pipedec-db")``, the
                 local executor, 3 slots) over the same pair and prompts,
                 with staggered arrivals, once on the dense arena and once
                 on the block-paged one (16-row pages), whose tree verify
                 runs the paged kernels: tokens checked against phase 3's
                 autoregressive tokens, the paged run's tokens and
                 per-request stats against the dense run's, bit for bit;
  6. self-draft-db - the 8-layer target as its own draft on the paged
                 arena, 3 requests on 2 slots: every prediction hits, so
                 the paged commit and the batched prune remap run;
 6a. serve-db-sharded - phase 5's requests on the 8-stage pipeline ring
                 (``ShardedPipelineExecutor``: one flush of the ring per
                 timestep, the target's 8 layers one per stage), dense and
                 paged: tokens against phase 3's autoregressive tokens,
                 tokens, per-request stats and the logits of every
                 committed token against phase 5's run bit for bit, one
                 flush per timestep with entries; wall ms and launches
                 per timestep beside phase 5's;
 6b. serve-db-overlap - the same on the overlapped ring
                 (``OverlappedShardedExecutor``: one tick per timestep,
                 deferred exit logits, commits and prunes riding the ring,
                 prompts streaming through its 64-token prefill lane):
                 tokens against phase 3's (near-tie rule) and phase 5's,
                 one tick per timestep, no separate prefill, the
                 ctrl-active share of the ticks and the largest logit
                 difference against phase 5;
 6c. self-draft-db-overlap - the 8-layer target as its own draft on the
                 overlapped 8-stage ring, paged, 3 requests on 2 slots:
                 every prediction hits, so commits and prunes propagate
                 through every stage, and each retire kills;
 6d. serve-db-async - phase 5's requests on ``AsyncPipelineExecutor``
                 (8 free-running stage actors and a draft actor, one CUDA
                 stream each, dense arena): tokens against phase 3's and
                 6a's (near-tie rule), logits within 1e-4 of phase 5's,
                 one stage step per entry per stage, a drained pipe, no
                 actor thread after shutdown (called twice); wall ms per
                 timestep beside 6a's and 6b's, each stage actor's busy
                 and idle seconds and inbox depth, the draft's lead;
 6e. self-draft-db-async - 6c's requests on the async executor (dense):
                 every prediction hits;
  7. stpp      - the paper's static-tree baseline (``STPPEngine``, depth
                 4, width 8, branch 4: the target verifies 33 nodes in one
                 pass) over the same pair and prompts: tokens checked
                 against phase 3's autoregressive tokens, launch counts
                 against the rounds and draft steps;
  8. self-draft-stpp - the 8-layer target as its own STPP draft: every
                 round but the last accepts a token;
  9. chain     - chain speculation (``ChainSpecEngine``, 8 stages, a
                 width-1 tree) over the same pair: lossless, one flash
                 launch per layer per decode;
 10. self-draft-chain - the target as its own chain draft: no miss;
 11. sim       - the cost model (``core/sim.py``) priced with this card's
                 times: a target decoder layer at width 1 and 8, the
                 draft's tree verify, an activation copy, and the exit
                 step (commit and prune) of an 8-stage self-draft PipeDec
                 run, timed in a second run of it; modelled ms per token
                 of PP, STPP and PipeDec beside the measured ones;
 12. serve-int8 - the int8 path: the same pair and requests after
                 ``ModelBundle.quantize()`` (int8 projections through the
                 dequant-matmul kernel, int8 KV caches through the attention
                 kernels' int8 mode), checked against int8 autoregressive
                 decoding (it runs after the fp32 phases, which need the
                 fp32 target that quantizing frees);
 13. stpp-int8 - STPP over the int8 pair, checked against phase 12's int8
                 autoregressive tokens (``dequant_matmul`` at M = 33);
 14. self-draft-int8 - the int8 target as its own draft;
 15. serve-db-int8 - the int8 pair on the paged arena, checked against
                 phase 12's int8 autoregressive tokens;
15a. serve-db-int8-sharded - phase 15's requests on the int8 flush ring,
                 dense and paged: tokens, per-request stats, every
                 committed token's logits and the counted dequant_matmul
                 launches equal to phase 15's;
15b. serve-db-int8-overlap - the same on the int8 overlapped ring and the
                 int8 async executor (dense): tokens equal to phase 15's
                 (near-tie rule), logits within 1e-3;
 16. cli       - ``repro_torch.launch.serve.main`` in pp, pipedec and
                 pipedec-db --paged modes, fp32 and ``--quant int8``, and
                 pipedec-db --executor sharded [--overlap] and --executor
                 async, fp32 and int8, pipedec with ``--target-arch``
                 qwen2-moe-a2.7b and deepseek-v2-236b, and the smoke pair
                 on the card against the same weights on the CPU, fp32
                 and int8, and with the MoE and MLA smoke targets;
16a. family-<arch> - the attention families at published widths
                 (FAMILY_ARCHS: Qwen 2.5 and 1.5 and Moonlight cut to 8
                 layers, Gemma-7b whole, Qwen-MoE to 12, DeepSeek-V2 to
                 3):
                 PipeDec (8 stages, width 8, branch 4) with a seeded
                 2-layer dense draft on two prompts, lossless against
                 autoregressive decoding (near-tie rule); the target as its
                 own draft, acceptance 1.0; flash and tree launches layers
                 x calls (Gemma's on the head_dim 256 instances, none for
                 DeepSeek's MLA, which attends in plain PyTorch); wall ms
                 per token and peak memory;
16d. family-mamba2-130m, family-recurrentgemma-9b - the recurrent
                 families whole at published width (Mamba-2: 24 SSD layers;
                 RecurrentGemma: 26 RG-LRU and 12 local attention layers,
                 window 2048, about 37.6 GB in fp32) with the random
                 2-layer draft: pp (two 64-token requests in one batch),
                 chain speculation (8 stages) with the random draft on a
                 64-token prompt and (RecurrentGemma) a 2112-token one
                 past the window, and with the target as its own draft
                 (acceptance 1.0, no miss), lossless against
                 autoregressive decoding (near-tie rule); the PipeDec
                 refusal (NotImplementedError naming chain-mode);
                 RecurrentGemma's head_dim 256 flash launches (windowed)
                 12 x the target's calls; ms per token of each, the long
                 prompt's prefill ms, snapshot copies per timestep, peak
                 memory;
16b. family-db - SpecPipe-DB (3 slots, arrivals 0, 0, 3) for Gemma,
                 Moonlight and DeepSeek on dense and paged arenas at
                 dropless MoE capacity: paged equals dense bit for bit,
                 lossless; a run at the published capacity factor reports
                 whether its tokens still equal autoregressive decoding;
16c. family-int8 - Gemma and Qwen 2.5 after ``quantize()``: lossless
                 against int8 autoregressive decoding, dequant_matmul
                 launches 7 x layers x calls, Gemma's int8 attention on
                 the head_dim 256 int8 instances;
16e. window    - long_500k's window override (4096 keys,
                 ``launch.specs.window_override``) at Qwen2.5-32B's
                 published width, 8 of 64 layers, with the seeded 2-layer
                 draft: one layer's decode attention at 524,288 rows
                 against its plain version, with and without the window,
                 kernel / plain / SDPA times beside the bound; one decode
                 at row 524,287 of a seeded 524,288-row cache (34.4 GB of
                 K/V) through the bundle's override, 8 flash launches,
                 its logits against the same decode on a paged cache that
                 backs only the window's rows, ms a step with and without
                 the override; the windowed tree-verify entry points,
                 dense and paged, against plain; two prompts of 4160 and
                 4224 tokens: PipeDec lossless against autoregressive
                 decoding, SpecPipe-DB paged equal to dense, the 8-stage
                 flush ring equal to the local run bit for bit, the
                 overlapped ring with its prefill lane off, launches as
                 the calls imply;
16f. dryrun    - ``python -m repro_torch.launch.dryrun --all
                 --both-meshes`` in a subprocess, alone (80 rows ok, its
                 seconds), and meanwhile
                 Gemma-7b's and Qwen-MoE's bf16 weights and
                 a 1 x 32,768 cache built on the card: the specs' byte
                 counts against the bytes held, the allocator's requested
                 bytes and ``memory_allocated`` within its rounding;
 17. sharded-check - ``python -m repro_torch.launch.sharded_check
                 --stages 4`` with --overlap --async --quant, then with
                 --overlap --paged --quant, each in a process of its own:
                 every executor's tokens equal the single-request
                 engine's on tiny models, with the scenarios.

Between phases 2 and 3, with no serving model on the card:

  train      - the training path (``launch.steps.make_train_step``:
               ``loss_fn`` under autograd, attention in plain PyTorch,
               AdamW) at published widths: 20 steps of the draft
               (LLaMA-3.2-1B whole) with remat off and 20 with remat on,
               5 of one LLaMA-3.1-70B layer, at the JAX CLI's defaults on
               the trainer's byte corpus, and 3 draft steps at S 2048
               (batch 1; chunked attention, 8 CE chunks) with remat off
               and 3 with remat on; ms per step (CUDA events),
               tokens per second, peak memory, the card's idle share and
               top operations (torch.profiler) and the share of the fp32
               peak; checks: finite losses, the draft's loss falls, remat
               on equals off at step 0, step 0 equals a float64 copy of
               the draft on the card, no kernel of the port launches;
  train-families - every family the port serves trained at published
               width (``TRAIN_FAMILIES``; depth cut where 80 GB forces
               it): Whisper-base whole with seeded [8, 1500, 512] frames
               (the encoder under autograd) and on tokens alone (its
               encoder and cross weights must move by AdamW's decay
               alone), InternVL2 (2 of 48 layers, a seeded [8, 256, 6144]
               prefix), Mamba-2 whole, RecurrentGemma (3 of 38: one rra
               unit) and Qwen-MoE (2 of 24), 3 AdamW steps each at 8 x
               128 with remat (Gemma, Qwen2.5 and DeepSeek-V2's dense MLA
               layer are cut for the run time); ms per step, tokens
               per second, peak memory, busy ms and idle share
               (torch.profiler), the share of the fp32 peak counted from
               each family's own products; checks: finite values, no
               kernel launch, weights on the card, TF32 off, step 0
               within 1e-5 of a float64 copy (Mamba-2's at 8 layers, its
               16 and 24 reported beside a weight-noise probe of the
               float64 grad norm);
  train-pair - the smoke pair trained here on one corpus by
               ``launch.train.train`` (the benchmarks' recipe), saved,
               reloaded through ``launch.serve.build_bundle(ckpt=)`` (bit
               for bit) and served by ``ServingEngine`` in pipedec and pp
               modes on held-out prompts: lossless against
               autoregressive decoding, launch counts against the model
               calls, acceptance with a trained draft; and the training
               CLI for 3 steps.

Phase 2 also holds each paged kernel (the paged modes of the two attention
kernels) against its plain version and, bit for bit, against the dense
kernel on the view gathered through the block table.  Every serving
phase and each CLI run set the kernels' launch counts to 0 just before
they run and check them just after against the model calls.

Then the card's name and power limit as nvidia-smi reports them, the
per-kernel summary line and, last, the result line.  Any failed
check makes the exit code 1 and suppresses the result line.  Without CUDA,
or without the port's sources beside this file, it exits 1 at once.
"""
from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# products per fp32 product: the attention kernels' 3xTF32, the
# dequant-matmul's bf16 terms of x (kernels/quant.py PASSES)
TF32_PASSES = 3
# SASS instructions counted per kernel instance: the tensor-core MMAs of the
# attention kernels (TF32) and of the dequant-matmul (bf16), and cp.async
SASS_COUNTED = ("HMMA.1688.F32.TF32", "HMMA.16816.F32.BF16", "LDGSTS")

# kernel vs plain tolerances: fp32 sums taken in another order.  The int8
# modes dequantize each row exactly as the plain versions do (float(q) *
# scale, one rounding), so they are held to the same tolerances.
TOL_O_ABS = 1e-4
TOL_M_REL = 1e-5
TOL_L_REL = 1e-4
# the tree kernel's merge epilogue against ops.combine_lse over the
# kernel's own two halves: the same arithmetic in the same order, so equal
# bits are expected; 1e-6 (a few ulps of outputs of size about 1) would
# cover an expf that differs by an ulp between the CUDA math library
# PyTorch was built with and the one nvcc links here
TOL_MERGE = 1e-6
# dequant_matmul vs plain: outputs of size about 1 (LeCun-normal weights,
# as in the model), fp32 sums over K taken in another order than cuBLAS's
TOL_DQ_ABS = 1e-4
# card vs CPU on the int8 smoke pair: a K/V value within an ulp of a
# rounding boundary may quantize one int8 step apart (fp32 sums differ in
# order), which moves a logit by up to about 1e-3
TOL_INT8_CARD_CPU = 1e-3
# near-tie rule of the lossless check: a token may differ from plain
# decoding only where the autoregressive top-2 logit margin is below this
NEAR_TIE = 1e-3
# the async executor's committed-token logits against the local
# executor's: its stages run every slot row (the local verify a bucket of
# them), so the sgemms see another M and may sum in another order
TOL_ASYNC_LOGITS = 1e-4
# the int8 overlapped ring and async executor against the int8 local
# executor: the int8 parity tolerance (tests/test_torch_quant_model.py):
# a K/V value at a rounding tie may quantize one step apart
TOL_INT8_RING = 1e-3
# the sharded-check subprocesses (tiny models, 8 stages)
SHARDED_CHECK_TIMEOUT_S = 420

TARGET_LAYERS = 8        # one layer per stage of the paper's 8-stage pipeline
# the serving draft (LLaMA-3.2-1B, 16 layers) cut to 4 layers and the
# serving phases to 3 requests, so that the run, with the family phases,
# stays inside its time limit (PERF.md section 4)
DRAFT_LAYERS = 4
SERVE_REQUESTS = 3
SHARDED_CHECK_STAGES = 4
# 16 new tokens a serving request (32 until the window and dryrun phases:
# a run with them on a slow host took 1280.8 s, PERF.md section 4)
SERVE_NEW_TOKENS = 16
SELF_DRAFT_NEW_TOKENS = 40
# SpecPipe-DB: slots, the arrival timestep of each of phase 3's prompts (a
# slot is recycled and the bucket changes size during the run), the arena
# length and the page size of the paged arena
DB_SLOTS = 3
DB_ARRIVALS = (0, 0, 3, 6)
DB_INT8_REQUESTS = 2
# the chain phase's requests (of phase 3's prompts): with random weights
# the draft misses, so each token costs about n_stages timesteps
CHAIN_REQUESTS = 4
DB_MAX_LEN = 512
PAGE = 16
# self-draft-db-overlap: 3 requests on 2 slots (self-draft-db's prompts)
SELF_DRAFT_DB_PROMPTS = ([3, 3, 8], [5, 1, 9, 2], [7, 7])
# STPP (the static-tree baseline): depth, width and branch as the JAX
# package's STPPConfig defaults; the target verifies all 1 + 4 * 8 nodes
# in one pass against a tree buffer with width-8 slack
STPP_DEPTH, STPP_WIDTH, STPP_BRANCH = 4, 8, 4
STPP_NODES = 1 + STPP_DEPTH * STPP_WIDTH
STPP_T = STPP_NODES + STPP_WIDTH
# projections per layer per forward call, each one dequant_matmul launch
PROJECTIONS = 7
WHISPER_FRAMES = 1500     # whisper-base's encoder.max_source_positions
RG_WINDOW = 2048          # recurrentgemma-9b's local attention window
RG_LONG_PROMPT = 2112     # a prompt past the window
# phase train: the JAX CLI's defaults (batch 8, seq 128, lr 3e-4) on the
# trainer's corpus (seed 0, 2^18 bytes); the draft's steps (run with remat
# off and on), the 1-layer target's; the steps before the timed median;
# the draft's steps run to profile (the first outside the window)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR, TRAIN_CORPUS = 8, 128, 3e-4, 1 << 18
TRAIN_STEPS, TRAIN_TARGET_STEPS, TRAIN_WARMUP, TRAIN_PROFILE = 20, 5, 2, 3
# and a few draft steps at S 2048 (batch 1, remat off and on), where the
# training attention is the chunked form (a checkpoint per 1024-row query
# chunk) and the loss sums 8 CE chunks of 256 rows
TRAIN_LONG_BATCH, TRAIN_LONG_SEQ, TRAIN_LONG_STEPS = 1, 2048, 3
# remat on against off: the same products on the same inputs (the
# recomputed forward repeats the first), so equal bits are expected; fp32
# against a float64 copy of the draft on the same batch: a loss and a
# grad norm summed over 1024 tokens and 1.24 B weights in fp32
TOL_REMAT = 1e-6
TOL_F64 = 1e-5
# phase train-families: (line, registry id, decoder layers (None: whole),
# modality input in the batch, depths of the float64 check where it is
# held below the line's own); at published width, the depth cut where 80
# GB of fp32 weights, grads, two moments and a float64 copy force it
TRAIN_FAMILIES = (
    ("whisper-base", "whisper-base", None, "frames", ()),
    ("whisper-base tokens only", "whisper-base", None, None, ()),
    ("internvl2-26b", "internvl2-26b", 2, "prefix", ()),
    # the seeded 24-layer Mamba-2 amplifies fp32 rounding through its
    # depth (step 0's grad norm 4.6e-3 from float64 at 24 layers in the
    # first card run, the loss 4.5e-8), so the check is held at 8 layers
    # and the line reports 16 and 24 and the weight-noise probe
    ("mamba2-130m", "mamba2-130m", None, None, (8, 16)),
    ("recurrentgemma-9b", "recurrentgemma-9b", 3, None, ()),
    ("qwen2-moe-a2.7b", "qwen2-moe-a2.7b", 2, None, ()))
# cut for the run time (a whole run took 1095.5 s on a slow host, past
# 1050 s; the CPU tests hold these families' training): ("gemma-7b",
# "gemma-7b", 2, None, ()), ("qwen2.5-32b", "qwen2.5-32b", 1, None, ()),
# and DeepSeek-V2's first_dense layer (MLA, a dense MLP; one MoE layer is
# about 3.8 B weights, past the card with AdamW): ("deepseek-v2-236b",
# "deepseek-v2-236b", 1, None, ()); ``_train_family(*line, batches)``
# trains one
# the weight noise of the float64 conditioning probe: fp32's half ulp
F64_WEIGHT_NOISE = 6e-8
TRAIN_FAMILY_STEPS = 3
# a zero-gradient step moves a weight by the decay alone: p (1 - lr wd)
# against p - lr (wd p), fp32 rounding of one product and one sum
TOL_DECAY = 1e-6
# phase train-pair: the benchmarks' recipe (benchmarks/common.py), their
# held-out prompts (6 x 32 bytes of corpus seed 3) and 32 new tokens each
PAIR_STEPS, PAIR_BATCH, PAIR_SEQ, PAIR_LR, PAIR_CORPUS = (400, 8, 64, 2e-3,
                                                          1 << 17)
PAIR_PROMPTS, PAIR_PROMPT_LEN, PAIR_NEW_TOKENS, PAIR_MAX_LEN = 6, 32, 32, 256


def _peak(name: str) -> float:
    """A published H100 SXM peak of ``repro_torch.launch.analysis``: HBM
    bytes/s, and FLOP/s of the tensor cores' dense TF32 (the attention
    kernels' 3xTF32 products) and bf16 (the dequant-matmul's passes), and
    of IEEE fp32 outside the tensor cores (training's sgemm, TF32 off)."""
    from repro_torch.launch import analysis
    return getattr(analysis, name)


def emit(obj) -> None:
    """Print one JSON object on its own line."""
    print(json.dumps(obj), flush=True)


def bail(msg: str) -> None:
    """Exit 1 before any result is printed."""
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _event_ms(run, batches: int, per_batch: int) -> float:
    import torch
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def cuda_ms(fn, batches: int = 21, per_batch: int = 10):
    """(device_ms, eager_ms) of one call of ``fn``, each the median over
    ``batches`` of the mean CUDA-event time of ``per_batch`` back-to-back
    calls.  device_ms replays the calls from a CUDA graph, so it is the
    card's time with the host's launch cost removed; eager_ms calls ``fn``
    from Python as the port does today, so a call that the host cannot
    launch as fast as the card runs it is timed at the host's rate."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()        # warm-up on the capture stream, which owns the scratch
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(per_batch):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device_ms = _event_ms(graph.replay, batches, per_batch)

    def eager():
        for _ in range(per_batch):
            fn()
    return device_ms, _event_ms(eager, batches, per_batch)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def _bound(valid, b, h, kvh, n, hd, extra_bytes, int8=False,
           shared_kv=False):
    """Least time (ms) for attention over ``valid`` [B,n,L] (query may
    attend key): every input byte read once (q, the K/V rows some query of
    the batch row attends, at 1 byte an element plus 4 bytes of scale per
    row and KV head when ``int8``, ``extra_bytes`` of masks, bounds and a
    merged past half), every output byte written once (o, m, l);
    operations 4*hd per (head, query, key) pair that is attended (QK and
    PV), each fp32 product three TF32 products on the tensor cores (both
    attention kernels), at the TF32 peak. ``shared_kv``: the B rows read
    one K/V row (batch stride 0), so a key some row attends is counted
    once, not once per batch row."""
    if shared_kv:
        rows = int(valid.any(1).any(0).sum())      # distinct keys attended
    else:
        rows = int(valid.any(1).sum())             # attended keys over B
    kv_row = 2 * (hd + 4) if int8 else 2 * 4 * hd
    nbytes = 4 * (2 * b * h * n * hd + 2 * b * h * n) + rows * kvh * kv_row
    nbytes += extra_bytes
    flops = 4 * hd * (h * int(valid.sum()))
    return _roofline(nbytes, TF32_PASSES * flops, _peak("TF32_FLOP_PER_S"))


def _roofline(nbytes, flops, peak):
    t_bytes = nbytes / _peak("HBM_BYTES_PER_S") * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _errors(got, want):
    (o, m, l), (o2, m2, l2) = got, want
    err_o = float((o - o2).abs().max())
    err_m = float(((m - m2).abs() / m2.abs().clamp_min(1.0)).max())
    err_l = float(((l - l2).abs() / l2.abs().clamp_min(1e-30)).max())
    return err_o, err_m, err_l


# rows of the kernels line, one per kernel and mode: (name, source, the
# TPU kernel it replaces)
KERNEL_ROWS = (
    ("flash_attention_lse", "src/repro_torch/csrc/flash_attention_lse.cu",
     "src/repro/kernels/flash.py:102"),
    ("flash_attention_lse int8",
     "src/repro_torch/csrc/flash_attention_lse.cu",
     "src/repro/kernels/flash.py:102"),
    ("tree_block_attention", "src/repro_torch/csrc/tree_block_attention.cu",
     "src/repro/kernels/tree_block.py:54"),
    ("tree_block_attention int8",
     "src/repro_torch/csrc/tree_block_attention.cu",
     "src/repro/kernels/tree_block.py:54"),
    ("dequant_matmul", "src/repro_torch/csrc/dequant_matmul.cu",
     "src/repro/kernels/quant.py:113"),
    ("paged_flash_attention_lse",
     "src/repro_torch/csrc/flash_attention_lse.cu",
     "src/repro/kernels/paged.py:50"),
    ("paged_flash_attention_lse int8",
     "src/repro_torch/csrc/flash_attention_lse.cu",
     "src/repro/kernels/paged.py:50"),
    ("paged_tree_block_attention",
     "src/repro_torch/csrc/tree_block_attention.cu",
     "src/repro/kernels/paged.py:186"),
    ("paged_tree_block_attention int8",
     "src/repro_torch/csrc/tree_block_attention.cu",
     "src/repro/kernels/paged.py:186"),
)
# the head_dim 256 instances (Gemma) of the four attention kernels, fp32
# and int8: rows of their own, with their own launch counters
HD256 = " hd256"
KERNEL_ROWS += tuple((name + HD256, src, replaces)
                     for name, src, replaces in KERNEL_ROWS
                     if "attention" in name)
# the head_dim 256 flash instance with a window (RecurrentGemma's local
# attention, 16 query heads over one KV head): a row of its own, counted
# apart (its launches are also in the "flash_attention_lse hd256" row)
HD256_WINDOW = HD256 + " window"
KERNEL_ROWS += (("flash_attention_lse" + HD256_WINDOW,
                 "src/repro_torch/csrc/flash_attention_lse.cu",
                 "src/repro/kernels/flash.py:102"),)


def kernel_cases(torch, dev):
    """The phase-2 attention cases: (name, row, args dict); ``row`` names
    the kernel and mode (a KERNEL_ROWS entry)."""
    from repro_torch.kernels.quant import quantize_rows
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def kv(b, length, kvh, hd, int8):
        """K and V in the cache layout [B,L,KV,hd] as [B,KV,L,hd] views,
        int8 with [B,KV,L] scale views when ``int8``."""
        out = {}
        for name in ("k", "v"):
            x = rnd(b, length, kvh, hd)
            if int8:
                x, sc = quantize_rows(x)
                out[name + "_scale"] = sc.transpose(1, 2)
            out[name] = x.transpose(1, 2)
        return out

    def flash_case(name, b, h, kvh, n, hd, length, kv_len, *, causal=False,
                   window=0, main=False, int8=False, shared_kv=False,
                   q0=None):
        """``shared_kv``: one K/V batch row expanded over the B rows of q
        (batch stride 0), as a DB bucket's cross-attention reads the one
        encoder output.  ``q0``: the causal queries' first position per
        row (else 0)."""
        q = rnd(b, n, h, hd).transpose(1, 2)          # [B,H,n,hd] view
        kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        if causal:
            qpos = torch.arange(n, device=dev).expand(b, n)
            if q0 is not None:
                qpos = qpos + torch.tensor(q0, device=dev)[:, None]
        else:   # tree-layer positions: committed prefix + depth
            qpos = (kvl.long() - 1)[:, None] + torch.arange(n, device=dev) // 2
        row = ("flash_attention_lse" + (" int8" if int8 else "")
               + (HD256 if hd > 128 else "")
               + (" window" if hd > 128 and window else ""))
        kvs = kv(1 if shared_kv else b, length, kvh, hd, int8)
        if shared_kv:
            kvs = {k: x.expand(b, *x.shape[1:]) for k, x in kvs.items()}
        return name, row, dict(q=q, **kvs,
                               kv_len=kvl, qpos=qpos.to(torch.int32),
                               causal=causal, window=window, main=main)

    def tree_case(name, b, h, kvh, n, hd, t, *, main=False, int8=False,
                  mask=None):
        q = rnd(b, n, h, hd).transpose(1, 2)
        if mask is None:
            mask = torch.rand(b, n, t, generator=gen, device=dev) < 0.3
            mask[:, -1] = False                       # an empty row
        row = ("tree_block_attention" + (" int8" if int8 else "")
               + (HD256 if hd > 128 else ""))
        return name, row, dict(q=q, **kv(b, t, kvh, hd, int8), mask=mask,
                               main=main)

    return [
        flash_case("flash/tree-past target B=1", 1, 64, 8, 8, 128, 512, [200],
                   main=True),
        flash_case("flash/tree-past target B=4", 4, 64, 8, 8, 128, 512,
                   [200, 37, 512, 0]),
        flash_case("flash/decode target", 1, 64, 8, 1, 128, 512, [200]),
        flash_case("flash/prefill causal S=128", 1, 64, 8, 128, 128, 128,
                   [128], causal=True),
        flash_case("flash/window 64", 1, 64, 8, 8, 128, 512, [300],
                   window=64),
        flash_case("flash/tree-past draft B=1", 1, 32, 8, 8, 64, 512, [200]),
        tree_case("tree/target B=1 T=105", 1, 64, 8, 8, 128, 105, main=True),
        tree_case("tree/target B=4 T=105", 4, 64, 8, 8, 128, 105),
        tree_case("tree/target B=1 T=73 (4 stages)", 1, 64, 8, 8, 128, 73),
        tree_case("tree/draft B=1 T=105", 1, 32, 8, 8, 64, 105),
        flash_case("flash int8/tree-past target B=1", 1, 64, 8, 8, 128, 512,
                   [200], main=True, int8=True),
        flash_case("flash int8/decode target", 1, 64, 8, 1, 128, 512, [200],
                   int8=True),
        flash_case("flash int8/prefill causal S=128", 1, 64, 8, 128, 128,
                   128, [128], causal=True, int8=True),
        flash_case("flash int8/tree-past draft B=1", 1, 32, 8, 8, 64, 512,
                   [200], int8=True),
        tree_case("tree int8/target B=1 T=105", 1, 64, 8, 8, 128, 105,
                  main=True, int8=True),
        tree_case("tree int8/draft B=1 T=105", 1, 32, 8, 8, 64, 105,
                  int8=True),
        # STPP's one-pass verify of the whole static tree (depth 4, width
        # 8: 33 queries, a 41-row tree buffer; the unfilled nodes' rows
        # are fully masked)
        flash_case("flash/stpp-past target n=33", 1, 64, 8, STPP_NODES, 128,
                   512, [200]),
        flash_case("flash int8/stpp-past target n=33", 1, 64, 8, STPP_NODES,
                   128, 512, [200], int8=True),
        tree_case("tree/stpp target n=33 T=41", 1, 64, 8, STPP_NODES, 128,
                  STPP_T, mask=stpp_mask(torch, dev)),
        tree_case("tree int8/stpp target n=33 T=41", 1, 64, 8, STPP_NODES,
                  128, STPP_T, int8=True, mask=stpp_mask(torch, dev)),
        # Gemma-7b (16 heads, 16 KV heads, head_dim 256): the head_dim 256
        # instances at its tree-verify past half, decode and tree
        flash_case("flash hd256/tree-past gemma B=1", 1, 16, 16, 8, 256, 512,
                   [200], main=True),
        flash_case("flash hd256/decode gemma", 1, 16, 16, 1, 256, 512,
                   [200]),
        flash_case("flash hd256/prefill causal gemma S=128", 1, 16, 16, 128,
                   256, 128, [128], causal=True),
        tree_case("tree hd256/gemma B=1 T=105", 1, 16, 16, 8, 256, 105,
                  main=True),
        flash_case("flash int8 hd256/tree-past gemma B=1", 1, 16, 16, 8, 256,
                   512, [200], main=True, int8=True),
        flash_case("flash int8 hd256/decode gemma", 1, 16, 16, 1, 256, 512,
                   [200], int8=True),
        tree_case("tree int8 hd256/gemma B=1 T=105", 1, 16, 16, 8, 256, 105,
                  main=True, int8=True),
        # Whisper-base (8 heads, 8 KV heads, head_dim 64 through the 128
        # instance): the encoder's bidirectional self-attention over its
        # 1500 frames, and a DB bucket's cross-attention, 3 rows of a tree
        # layer over the one encoder output (K/V batch stride 0)
        flash_case("flash/encoder whisper T=1500", 1, 8, 8, WHISPER_FRAMES,
                   64, WHISPER_FRAMES, [WHISPER_FRAMES]),
        flash_case("flash/cross whisper B=3 n=8 T=1500", 3, 8, 8, 8, 64,
                   WHISPER_FRAMES, [WHISPER_FRAMES] * 3, shared_kv=True),
        # RecurrentGemma's local attention (16 heads over one KV head,
        # head_dim 256, window 2048): a decode at row 3000 of a 4096-row
        # cache, and 64 causal queries at 2048-2111 whose 4-query tiles
        # straddle the window's edge
        flash_case("flash hd256 window/decode recurrentgemma L=4096", 1, 16,
                   1, 1, 256, 4096, [3000], window=RG_WINDOW, main=True),
        flash_case("flash hd256 window/prefill recurrentgemma n=64", 1, 16,
                   1, 64, 256, RG_LONG_PROMPT, [RG_LONG_PROMPT],
                   causal=True, window=RG_WINDOW, q0=[RG_WINDOW]),
        # decode_32k's span at batch 8 (Qwen2.5-32B's widths: 40 heads over
        # 8 KV heads of 128): 512 chunks in 8 groups, rows of 32,768 keys
        # and shorter; a grid row of max(G, cap) CTAs
        flash_case("flash/decode_32k span B=8", len(DECODE_32K_KV_LEN), 40, 8,
                   1, 128, DECODE_32K_ROWS, list(DECODE_32K_KV_LEN)),
    ]


def stpp_mask(torch, dev, seed=0):
    """The [1, 33, 41] mask of STPP's whole-tree verify: a static tree
    grown by the port's tree code from seeded random draft log-probs
    (depth 4, width 8, branch 4), each node's ancestor-or-self row,
    unfilled nodes' rows all False, padded with the width-8 slack."""
    import torch.nn.functional as F
    from repro_torch.core import tree as tree_lib
    gen = torch.Generator().manual_seed(seed)
    tree = tree_lib.tree_init(STPP_NODES, 0)
    for _ in range(STPP_DEPTH):
        valid = torch.arange(STPP_WIDTH) < tree.layer_size
        logp = torch.log_softmax(torch.randn(STPP_WIDTH, 64, generator=gen),
                                 -1)
        lp, tok = torch.sort(logp, dim=-1, descending=True, stable=True)
        lp = torch.where(valid[:, None], lp[:, :STPP_BRANCH],
                         torch.tensor(tree_lib.NEG_INF))
        tree = tree_lib.tree_expand(tree, tok[:, :STPP_BRANCH].to(
            torch.int32), lp, STPP_WIDTH)
    mask = F.pad(tree.mask & tree.valid()[:, None],
                 (0, STPP_T - STPP_NODES))
    if mask.any(1).all():
        raise AssertionError("the STPP tree left no node unfilled")
    return mask[None].to(dev)


# (name, M, K, N, main): the projections of the main path.  Target: w_q
# and w_o (8192 x 8192), w_k/w_v (8192 x 1024), w_gate/w_up (8192 x 28672),
# w_down (28672 x 8192); draft: d 2048, ff 8192.  M = 8 is a tree verify
# (width 8), 1 a decode, 128 a prefill.
DQ_CASES = (
    ("dq/target w_q M=8", 8, 8192, 8192, False),
    ("dq/target w_k M=8", 8, 8192, 1024, False),
    ("dq/target w_gate M=8", 8, 8192, 28672, True),
    ("dq/target w_o M=8", 8, 8192, 8192, False),
    ("dq/target w_down M=8", 8, 28672, 8192, False),
    ("dq/target w_gate M=1", 1, 8192, 28672, False),
    ("dq/target w_gate M=128", 128, 8192, 28672, False),
    ("dq/draft w_q M=8", 8, 2048, 2048, False),
    ("dq/draft w_k M=8", 8, 2048, 512, False),
    ("dq/draft w_gate M=8", 8, 2048, 8192, False),
    ("dq/draft w_down M=8", 8, 8192, 2048, False),
)


def _flash_plan(torch, q, k, int8):
    """What a flash launch of these shapes takes: its CTAs (the kernel
    library's own grid rule), its scratch bytes (partials and counters),
    and the peak of ``torch.cuda.max_memory_allocated`` so far in GB."""
    from repro_torch.kernels import flash
    b, h, n, hd = q.shape
    kvh, length = k.shape[1], k.shape[2]
    x, y, z = flash.launch_grid(b, h, kvh, n, length, hd, int8=int8)
    floats, ints = flash.scratch_sizes(b, kvh, n, h // kvh, length, hd)
    return {"ctas": x * y * z, "grid": [x, y, z],
            "scratch_bytes": 4 * (floats + ints),
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
            / 1e9}


def _summarise(summary, row_name, err, main, case, timing):
    s = summary.setdefault(row_name, {"max_abs_err": 0.0})
    s["max_abs_err"] = max(s["max_abs_err"], err)
    if main:
        s.update(case=case, **timing)


def phase_kernels(state):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash, tree_block
    from repro_torch.kernels.flash import dequant_kv, valid_mask
    dev = torch.device("cuda")
    summary = {}
    bad = []
    for name, row_name, a in kernel_cases(torch, dev):
        q, k, v = a["q"], a["k"], a["v"]
        b, h, n, hd = q.shape
        kvh, length = k.shape[1], k.shape[2]
        rep = h // kvh
        scale = 1.0 / hd ** 0.5
        qkw = {key: a[key] for key in ("k_scale", "v_scale") if key in a}
        int8 = bool(qkw)
        if row_name.startswith("flash"):
            def run(a=a, qkw=qkw):
                return flash.flash_attention_lse(
                    a["q"], a["k"], a["v"], a["kv_len"], a["qpos"],
                    causal=a["causal"], window=a["window"], **qkw)

            def plain(a=a, qkw=qkw):
                return flash.flash_attention_lse_plain(
                    a["q"], a["k"], a["v"], a["kv_len"], a["qpos"],
                    scale=scale, causal=a["causal"], window=a["window"],
                    **qkw)
            valid = valid_mask(b, n, length, a["kv_len"], a["qpos"],
                               a["causal"], a["window"], dev)
            extra = 4 * b + 4 * b * n
        else:
            def run(a=a, qkw=qkw):
                return tree_block.tree_block_attention(
                    a["q"], a["k"], a["v"], a["mask"], **qkw)

            def plain(a=a, qkw=qkw):
                return tree_block.tree_block_attention_plain(
                    a["q"], a["k"], a["v"], a["mask"], scale=scale, **qkw)
            valid = a["mask"]
            extra = b * n * length
        torch.cuda.reset_peak_memory_stats()
        got = run()
        torch.cuda.synchronize()
        plan = (_flash_plan(torch, q, k, int8)
                if row_name.startswith("flash") else {})
        err_o, err_m, err_l = _errors(got, plain())
        ok = err_o <= TOL_O_ABS and err_m <= TOL_M_REL and err_l <= TOL_L_REL
        # the library yardstick: one SDPA call over the same mask, on the
        # fp32 K/V (int8: a dequantized fp32 copy, made outside the timing;
        # no PyTorch call takes int8 K/V with row scales)
        lib_k, lib_v = dequant_kv(k, v, qkw.get("k_scale"),
                                  qkw.get("v_scale"))
        lib_mask = valid[:, None]

        def library(q=q, k=lib_k, v=lib_v, lib_mask=lib_mask):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask,
                                                  enable_gqa=rep > 1)
        bound_ms, bound_by = _bound(valid, b, h, kvh, n, hd, extra, int8,
                                    shared_kv=b > 1 and k.stride(0) == 0)
        (k_ms, k_eager), (p_ms, p_eager) = cuda_ms(run), cuda_ms(plain)
        lib_ms, lib_eager = cuda_ms(library)
        row = {"phase": "kernels", "case": name, "kernel": row_name,
               "shapes": {"q": list(q.shape), "kv": list(k.shape),
                          "kv_dtype": str(k.dtype)},
               "max_abs_err": err_o, "m_rel_err": err_m, "l_rel_err": err_l,
               "tol": {"o_abs": TOL_O_ABS, "m_rel": TOL_M_REL,
                       "l_rel": TOL_L_REL},
               "ok": ok, "kernel_ms": k_ms, "plain_ms": p_ms,
               "library_ms": lib_ms,
               "library": "SDPA" + (" on a dequantized fp32 copy"
                                    if int8 else ""),
               "bound_ms": bound_ms, "bound_by": bound_by, "eager_ms": {
                   "kernel": k_eager, "plain": p_eager, "library": lib_eager},
               **plan}
        emit(row)
        if not ok:
            bad.append(name)
        _summarise(summary, row_name, err_o, a["main"], name, dict(
            ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms))
    bad += dequant_cases(torch, dev, summary)
    bad += paged_cases(torch, dev, summary)
    bad += merged_cases(torch, dev)
    bad += one_launch_cases(torch, dev)
    state["kernel_summary"] = summary
    if bad:
        raise AssertionError(f"kernels disagree with plain: {bad}")


def _rows_equal_m1(torch, quant, x, q8, scale, got, rows):
    """Each row of ``rows`` of the M-row result ``got`` bit-equal to an
    M = 1 call on that row alone."""
    return all(torch.equal(quant.dequant_matmul(x[i:i + 1], q8, scale)[0],
                           got[i]) for i in rows)


def dequant_cases(torch, dev, summary):
    """dequant_matmul at the main path's shapes: kernel against plain,
    times, bound, and the M-independence checks: every row of the case
    against an M = 1 call, and the same weights at M = 128 (a prefill),
    whose rows (a spread of them, and the first 8 as one M = 8 call) must
    equal M = 1 and M = 8 calls bit for bit.  Returns failed cases."""
    from repro_torch.kernels import quant
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    bad = []
    for name, m, k, n, main in DQ_CASES:
        x = torch.randn(m, k, generator=gen, device=dev)
        w = torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
        q8, scale = quant.quantize_weight(w, 1)
        w_fp32 = quant.dequantize_weight(q8, scale)   # what fp32 serving holds
        del w

        def run(x=x, q8=q8, scale=scale):
            return quant.dequant_matmul(x, q8, scale)

        def plain(x=x, q8=q8, scale=scale):
            return quant.dequant_matmul_plain(x, q8, scale)

        def library(x=x, w_fp32=w_fp32):
            return torch.mm(x, w_fp32)
        got = run()
        torch.cuda.synchronize()
        err = float((got - plain()).abs().max())
        # a row's bits must not depend on M: every row alone against the
        # same row of the M-row call, and at M = 128
        same_rows = _rows_equal_m1(torch, quant, x, q8, scale, got,
                                   range(m))
        x128 = torch.randn(128, k, generator=gen, device=dev)
        got128 = quant.dequant_matmul(x128, q8, scale)
        err128 = float((got128 - quant.dequant_matmul_plain(
            x128, q8, scale)).abs().max())
        same128 = (_rows_equal_m1(torch, quant, x128, q8, scale, got128,
                                  (0, 1, 7, 8, 63, 64, 100, 127))
                   and torch.equal(quant.dequant_matmul(x128[:8], q8, scale),
                                   got128[:8]))
        del x128, got128
        ok = (err <= TOL_DQ_ABS and err128 <= TOL_DQ_ABS and same_rows
              and same128)
        # the kernel's products: PASSES bf16 terms of x against the exact
        # bf16 weights, at the tensor cores' bf16 peak
        bound_ms, bound_by = _roofline(
            k * n + 4 * n + 4 * m * k + 4 * m * n,
            quant.PASSES * 2 * m * k * n, _peak("BF16_FLOP_PER_S"))
        (k_ms, k_eager), (p_ms, p_eager) = cuda_ms(run), cuda_ms(plain)
        lib_ms, lib_eager = cuda_ms(library)
        splits, chunk = quant.k_split(k, n)
        emit({"phase": "kernels", "case": name, "kernel": "dequant_matmul",
              "shapes": {"x": [m, k], "w_q": [k, n]},
              "k_splits": splits, "k_per_split": chunk,
              "passes": quant.PASSES,
              "max_abs_err": err, "max_abs_err_m128": err128,
              "tol": {"abs": TOL_DQ_ABS},
              "m1_bit_equal": same_rows, "m128_rows_bit_equal": same128,
              "ok": ok, "kernel_ms": k_ms,
              "plain_ms": p_ms, "library_ms": lib_ms,
              "library": "torch.mm on the dequantized fp32 weight (what "
                         "the fp32 path pays through cuBLAS)",
              "bound_ms": bound_ms, "bound_by": bound_by,
              "eager_ms": {"kernel": k_eager, "plain": p_eager,
                           "library": lib_eager}})
        if not ok:
            bad.append(name)
        _summarise(summary, "dequant_matmul", err, main, name, dict(
            ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms))
        del x, q8, scale, w_fp32
    return bad


# (name, h, kvh, hd, n, kv_len per row or None for a tree case, main): the
# paged kernels at the DB path's bucket 3.  Flash: the tree-verify past
# half (n = 8) and decode (n = 1) over a 512-row arena; tree: T = 105 (8
# stages, width 8), 7 blocks of 16 rows, the last 7 rows past T.
PAGED_CASES = (
    ("paged flash/tree-past target B=3", 64, 8, 128, 8, (90, 200, 130),
     True),
    ("paged flash/tree-past draft B=3", 32, 8, 64, 8, (90, 200, 130),
     False),
    ("paged flash/decode target B=3", 64, 8, 128, 1, (91, 201, 131), False),
    ("paged tree/target B=3 T=105", 64, 8, 128, 8, None, True),
    ("paged tree/draft B=3 T=105", 32, 8, 64, 8, None, False),
    ("paged flash hd256/tree-past gemma B=3", 16, 16, 256, 8,
     (90, 200, 130), True),
    ("paged flash hd256/decode gemma B=3", 16, 16, 256, 1, (91, 201, 131),
     False),
    ("paged tree hd256/gemma B=3 T=105", 16, 16, 256, 8, None, True),
)
PAGED_B, PAGED_T = 3, 105
# (heads, KV heads, head_dim) of the target's attention and of Gemma-7b's
TARGET_HEADS, GEMMA_HEADS = (64, 8, 128), (16, 16, 256)


def _paged_pool(torch, dense, horizon, gen):
    """A shuffled paged copy of ``dense`` [B, L, KV, ...]: row b backs its
    first ``horizon[b]`` rows with blocks in a random order, and the rest
    of its table is the null block.  Returns (pool view [Nb, KV, page,
    ...], table [B, mb] int32), both on the card."""
    from repro_torch.models import paging
    b, length = dense.shape[:2]
    need = [paging.n_blocks(h, PAGE) for h in horizon]
    ids = 1 + torch.randperm(sum(need), generator=gen)
    table = torch.zeros(b, paging.n_blocks(length, PAGE), dtype=torch.int32)
    i = 0
    for row, n in enumerate(need):
        table[row, :n] = ids[i:i + n]
        i += n
    p = paging.make_paged(dense, table.to(dense.device), PAGE)
    return paging.pool_view(p.pages, PAGE), p.table


def paged_cases(torch, dev, summary):
    """The paged kernels against their plain versions and, bit for bit,
    against the dense kernel on the view gathered through the table and
    each batch row against a B = 1 call; with kernel, dense, plain and
    library times and the bound.  Returns the failed cases."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash, paged, tree_block
    from repro_torch.kernels.flash import dequant_kv, valid_mask
    from repro_torch.kernels.quant import quantize_rows
    bad = []
    for int8 in (False, True):
        for name, h, kvh, hd, n, kv_len, main in PAGED_CASES:
            gen = torch.Generator().manual_seed(len(name) + 7 * int8)
            b = PAGED_B
            length = DB_MAX_LEN if kv_len else PAGED_T
            # each row backs its horizon (its rows, plus a tree's slack in
            # the model arena); the table is the null block past it
            horizon = ([min(length, k + PAGED_T) for k in kv_len] if kv_len
                       else [length] * b)
            kv = {}
            for part in ("k", "v"):
                x = torch.randn(b, length, kvh, hd, generator=gen).to(dev)
                if int8:
                    x, kv[part + "_scale"] = quantize_rows(x)
                kv[part] = x
            pools = {}
            for key, x in kv.items():
                pools[key], table = _paged_pool(
                    torch, x, horizon, torch.Generator().manual_seed(1))
            q = torch.randn(b, h, n, hd, generator=gen).to(dev)
            sc = {k: pools[k] for k in ("k_scale", "v_scale") if int8}
            scale = 1.0 / hd ** 0.5
            nb = table.shape[1]
            dense = {k: paged.gather_pool(v, table, nb * PAGE if kv_len
                                          else length)
                     for k, v in pools.items()}
            dsc = {k: dense[k] for k in ("k_scale", "v_scale") if int8}
            if kv_len:
                kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
                qpos = ((kvl.long() - 1)[:, None]
                        + torch.arange(n, device=dev) // 2).to(torch.int32)
                row = "paged_flash_attention_lse"

                def run(q=q, pools=pools, table=table, kvl=kvl, qpos=qpos,
                        sc=sc):
                    return paged.paged_flash_attention_lse(
                        q, pools["k"], pools["v"], table, kvl, qpos, **sc)

                def plain(q=q, pools=pools, table=table, kvl=kvl, qpos=qpos,
                          sc=sc):
                    return paged.paged_flash_attention_lse_plain(
                        q, pools["k"], pools["v"], table, kvl, qpos,
                        scale=scale, **sc)

                def dense_run(q=q, dense=dense, kvl=kvl, qpos=qpos, dsc=dsc):
                    return flash.flash_attention_lse(
                        q, dense["k"], dense["v"], kvl, qpos, **dsc)
                valid = valid_mask(b, n, nb * PAGE, kvl, qpos, False, 0, dev)
                extra = 4 * b * nb + 4 * b + 4 * b * n
            else:
                mask = torch.rand(b, n, length, generator=gen) < 0.3
                mask[:, -1] = False                       # an empty row
                mask = mask.to(dev)
                row = "paged_tree_block_attention"

                def run(q=q, pools=pools, table=table, mask=mask, sc=sc):
                    return paged.paged_tree_block_attention(
                        q, pools["k"], pools["v"], table, mask, **sc)

                def plain(q=q, pools=pools, table=table, mask=mask, sc=sc):
                    return paged.paged_tree_block_attention_plain(
                        q, pools["k"], pools["v"], table, mask, scale=scale,
                        **sc)

                def dense_run(q=q, dense=dense, mask=mask, dsc=dsc):
                    return tree_block.tree_block_attention(
                        q, dense["k"], dense["v"], mask, **dsc)
                valid = mask
                extra = 4 * b * nb + b * n * length
            row += (" int8" if int8 else "") + (HD256 if hd > 128 else "")
            got = run()
            torch.cuda.synchronize()
            err_o, err_m, err_l = _errors(got, plain())
            ref = dense_run()
            bit_equal = all(torch.equal(g, r) for g, r in zip(got, ref))
            err_dense = float((got[0] - ref[0]).abs().max())
            # each batch row bit-equal to a B = 1 call on it alone (a row's
            # plan and sums depend on its own keys only)
            def alone(r, q=q, pools=pools, table=table, sc=sc,
                      kv_len=kv_len):
                if kv_len:
                    return paged.paged_flash_attention_lse(
                        q[r:r + 1], pools["k"], pools["v"], table[r:r + 1],
                        kvl[r:r + 1], qpos[r:r + 1], **sc)
                return paged.paged_tree_block_attention(
                    q[r:r + 1], pools["k"], pools["v"], table[r:r + 1],
                    mask[r:r + 1], **sc)
            rows_alone = all(all(torch.equal(g[r], a[0])
                                 for g, a in zip(got, alone(r)))
                             for r in range(b))
            ok = (err_o <= TOL_O_ABS and err_m <= TOL_M_REL
                  and err_l <= TOL_L_REL and bit_equal and rows_alone)
            # the library yardstick: SDPA on the gathered (int8:
            # dequantized) fp32 view, made outside the timing; no PyTorch
            # call takes a block table
            lib_k, lib_v = dequant_kv(dense["k"], dense["v"],
                                      dsc.get("k_scale"), dsc.get("v_scale"))

            def library(q=q, k=lib_k, v=lib_v, mask=valid[:, None]):
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=h // kvh > 1)
            bound_ms, bound_by = _bound(valid, b, h, kvh, n, hd, extra, int8)
            (k_ms, k_eager), (p_ms, p_eager) = cuda_ms(run), cuda_ms(plain)
            (d_ms, d_eager), (lib_ms, lib_eager) = (cuda_ms(dense_run),
                                                     cuda_ms(library))
            emit({"phase": "kernels", "case": name + (" int8" if int8
                                                       else ""),
                  "kernel": row, "shapes": {
                      "q": list(q.shape), "pool": list(pools["k"].shape),
                      "table": list(table.shape), "kv_dtype": str(
                          pools["k"].dtype), "page": PAGE,
                      "kv_len": list(kv_len) if kv_len else None},
                  "max_abs_err": err_o, "m_rel_err": err_m,
                  "l_rel_err": err_l, "tol": {"o_abs": TOL_O_ABS,
                                              "m_rel": TOL_M_REL,
                                              "l_rel": TOL_L_REL},
                  "dense_bit_equal": bit_equal,
                  "rows_bit_equal_b1": rows_alone,
                  "max_abs_err_vs_dense": err_dense, "ok": ok,
                  "kernel_ms": k_ms, "dense_ms": d_ms, "plain_ms": p_ms,
                  "library_ms": lib_ms,
                  "library": "SDPA on the gathered" + (
                      ", dequantized fp32" if int8 else " fp32") + " view",
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "eager_ms": {"kernel": k_eager, "dense": d_eager,
                               "plain": p_eager, "library": lib_eager}})
            if not ok:
                bad.append(name)
            _summarise(summary, row, err_o, main, name, dict(
                ms=k_ms, dense_ms=d_ms, plain_ms=p_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms))
    return bad


def merged_cases(torch, dev):
    """The tree-verify entry points (``ops.tree_attention``, and
    ``ops.paged_tree_attention`` at bucket 3) at the target's main-path
    shapes, and ``ops.tree_attention`` at STPP's whole-tree verify (33
    queries, T = 41, fully masked rows for the unfilled nodes), fp32 and
    int8: the tree kernel merges the committed-prefix half in its
    epilogue.  Its output against ``combine_lse`` over the two
    kernels' standalone halves (bit for bit), against the plain version
    (o tolerance); the entry point's time against the two halves plus the
    eager ``combine_lse`` (the composition before the epilogue).  Returns
    the failed cases."""
    from repro_torch.kernels import flash, ops, paged, tree_block
    from repro_torch.kernels.quant import quantize_rows
    bad = []
    for paged_mode, n, t, seed, (h, kvh, hd) in (
            (False, 8, PAGED_T, 11, TARGET_HEADS),
            (True, 8, PAGED_T, 11, TARGET_HEADS),
            (False, STPP_NODES, STPP_T, 21, TARGET_HEADS),
            (False, 8, PAGED_T, 31, GEMMA_HEADS),
            (True, 8, PAGED_T, 31, GEMMA_HEADS)):
        stpp = n == STPP_NODES
        for int8 in (False, True):
            gen = torch.Generator().manual_seed(seed + 2 * paged_mode + int8)
            b = PAGED_B if paged_mode else 1
            kv_len = (90, 200, 130)[:b] if paged_mode else (200,)
            q = torch.randn(b, n, h, hd, generator=gen).to(dev).transpose(
                1, 2)                                  # as the model's q
            if stpp:
                mask = stpp_mask(torch, dev, seed=int(int8))
            else:
                mask = torch.rand(b, n, t, generator=gen) < 0.3
                mask[:, :, 0] = True                   # the root
                mask = mask.to(dev)
            kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
            qpos = ((kvl.long() - 1)[:, None]
                    + torch.arange(n, device=dev) // 2).to(torch.int32)
            halves = {}
            for half, length in (("past", DB_MAX_LEN), ("tree", t)):
                d = {}
                for part in ("k", "v"):
                    x = torch.randn(b, length, kvh, hd, generator=gen).to(dev)
                    if int8:
                        x, d[part + "_scale"] = quantize_rows(x)
                    d[part] = x
                if paged_mode:
                    horizon = ([min(length, k + t) for k in kv_len]
                               if half == "past" else [t] * b)
                    views = {}
                    for key, x in d.items():
                        views[key], table = _paged_pool(
                            torch, x, horizon, torch.Generator().manual_seed(
                                len(half)))
                    halves[half] = (views, table)
                else:
                    halves[half] = ({k: x.transpose(1, 2)
                                     for k, x in d.items()}, None)
            (pk, ptable), (tk, ttable) = halves["past"], halves["tree"]
            psc = {k: pk[k] for k in ("k_scale", "v_scale") if int8}
            tsc = {k: tk[k] for k in ("k_scale", "v_scale") if int8}
            esc = {"kt_scale": tsc.get("k_scale"),
                   "vt_scale": tsc.get("v_scale")} if int8 else {}
            if paged_mode:
                def past_fn(q=q, pk=pk, ptable=ptable, kvl=kvl, qpos=qpos,
                            psc=psc):
                    return paged.paged_flash_attention_lse(
                        q, pk["k"], pk["v"], ptable, kvl, qpos, **psc)

                def tree_fn(past=None, q=q, tk=tk, ttable=ttable, mask=mask,
                            tsc=tsc):
                    return paged.paged_tree_block_attention(
                        q, tk["k"], tk["v"], ttable, mask, past=past, **tsc)

                def entry(q=q, pk=pk, ptable=ptable, tk=tk, ttable=ttable,
                          mask=mask, kvl=kvl, qpos=qpos, psc=psc, esc=esc):
                    return ops.paged_tree_attention(
                        q, pk["k"], pk["v"], ptable, tk["k"], tk["v"],
                        ttable, mask, kvl, qpos=qpos, **psc, **esc)

                def plain(q=q, pk=pk, ptable=ptable, tk=tk, ttable=ttable,
                          mask=mask, kvl=kvl, qpos=qpos, psc=psc, tsc=tsc):
                    scale = hd ** -0.5
                    past = paged.paged_flash_attention_lse_plain(
                        q, pk["k"], pk["v"], ptable, kvl, qpos, scale=scale,
                        **psc)
                    return paged.paged_tree_block_attention_plain(
                        q, tk["k"], tk["v"], ttable, mask, scale=scale,
                        past=past, **tsc)
            else:
                def past_fn(q=q, pk=pk, kvl=kvl, qpos=qpos, psc=psc):
                    return flash.flash_attention_lse(
                        q, pk["k"], pk["v"], kvl, qpos, **psc)

                def tree_fn(past=None, q=q, tk=tk, mask=mask, tsc=tsc):
                    return tree_block.tree_block_attention(
                        q, tk["k"], tk["v"], mask, past=past, **tsc)

                def entry(q=q, pk=pk, tk=tk, mask=mask, kvl=kvl, qpos=qpos,
                          psc=psc, esc=esc):
                    return ops.tree_attention(
                        q, pk["k"], pk["v"], tk["k"], tk["v"], mask, kvl,
                        qpos=qpos, **psc, **esc)

                def plain(q=q, pk=pk, tk=tk, mask=mask, kvl=kvl, qpos=qpos,
                          psc=psc, tsc=tsc):
                    scale = hd ** -0.5
                    past = flash.flash_attention_lse_plain(
                        q, pk["k"], pk["v"], kvl, qpos, scale=scale, **psc)
                    return tree_block.tree_block_attention_plain(
                        q, tk["k"], tk["v"], mask, scale=scale, past=past,
                        **tsc)

            def halves_then_combine(past_fn=past_fn, tree_fn=tree_fn):
                return tree_block.combine_lse([past_fn(), tree_fn()])
            got = entry()
            halves_out = (past_fn(), tree_fn())
            torch.cuda.synchronize()
            want = tree_block.combine_lse(list(halves_out))
            bit_equal = torch.equal(got, want)
            err_halves = float((got - want).abs().max())
            err_plain = float((got - plain()).abs().max())
            ok = err_halves <= TOL_MERGE and err_plain <= TOL_O_ABS
            row = {"phase": "kernels",
                   "case": ("paged " if paged_mode else "") + "merged "
                   "tree verify %s B=%d T=%d%s%s" % (
                       "gemma hd256" if hd > 128 else "target", b, t,
                       " n=33 (stpp)" * stpp, " int8" * int8),
                   "entry": "ops." + ("paged_" * paged_mode) +
                   "tree_attention",
                   "bit_equal_combine_lse": bit_equal,
                   "max_abs_err_vs_combine_lse": err_halves,
                   "tol_vs_combine_lse": TOL_MERGE,
                   "max_abs_err_vs_plain": err_plain, "ok": ok,
                   "entry_ms": cuda_ms(entry)[0],
                   "halves_then_combine_lse_ms": cuda_ms(
                       halves_then_combine)[0],
                   "plain_ms": cuda_ms(plain)[0]}
            emit(row)
            if not ok:
                bad.append(row["case"])
    return bad


def _cuda_launches(torch, fn):
    """CUDA kernel launches (``cudaLaunchKernel`` calls) that one call of
    ``fn`` makes, counted by torch.profiler; ``fn`` runs once before, so
    first-use builds and scratch allocations stay outside the window."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))


def one_launch_cases(torch, dev):
    """Each wrapper call of the redesigned kernels is one CUDA launch:
    dequant_matmul with and without a K split and at M = 128, the flash
    kernel dense and paged, fp32 and int8, over several chunks, and the
    tree kernel dense and paged, fp32 and int8; a tree-verify entry point
    (ops.tree_attention, ops.paged_tree_attention) is two, flash and the
    tree kernel with its merge epilogue.  The launch counters count calls,
    one each.  Returns failed cases."""
    from repro_torch.kernels import flash, ops, paged, quant, tree_block
    from repro_torch.kernels.quant import quantize_rows
    from repro_torch.models import paging
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for m, k, n in ((8, 8192, 1024), (128, 2048, 2048), (1, 96, 200)):
        x = torch.randn(m, k, generator=gen, device=dev)
        q8, sc = quant.quantize_weight(
            torch.randn(k, n, generator=gen, device=dev), 1)
        cases.append((f"dequant_matmul M={m} K={k} N={n} splits="
                      f"{quant.k_split(k, n)[0]}",
                      lambda x=x, q8=q8, sc=sc: quant.dequant_matmul(
                          x, q8, sc), 1))
    kvl = torch.tensor([200], dtype=torch.int32, device=dev)
    qpos = (199 + torch.arange(8, device=dev) // 2)[None].to(torch.int32)
    table = (1 + torch.arange(32, device=dev, dtype=torch.int32))[None]
    t_table = table[:, :paging.n_blocks(PAGED_T, PAGE)].contiguous()
    mask = torch.rand(1, 8, PAGED_T, generator=gen, device=dev) < 0.3

    def pool(x):
        """[1, L, ...] as a pool view behind ``table``: the null block,
        then x's rows in order, the last block padded with zeros."""
        pad = x.new_zeros((-x.shape[1] % PAGE, *x.shape[2:]))
        return paging.pool_view(torch.cat([torch.zeros_like(x[0, :PAGE]),
                                           x[0], pad]), PAGE)
    for (h, kvh, hd), int8 in ((TARGET_HEADS, False), (TARGET_HEADS, True),
                               (GEMMA_HEADS, False), (GEMMA_HEADS, True)):
        q = torch.randn(1, h, 8, hd, generator=gen, device=dev)
        kv, sc, tkv, tsc = [], {}, [], {}
        for name in ("k", "v"):
            for length, xs, scs in ((512, kv, sc), (PAGED_T, tkv, tsc)):
                x = torch.randn(1, length, kvh, hd, generator=gen,
                                device=dev)
                if int8:
                    x, scs[name + "_scale"] = quantize_rows(x)
                xs.append(x)
        mode = (" int8" if int8 else "") + (HD256 if hd > 128 else "")
        heads = {k: v.transpose(1, 2) for k, v in sc.items()}
        theads = {k: v.transpose(1, 2) for k, v in tsc.items()}
        cases.append(("flash_attention_lse" + mode,
                      lambda q=q, kv=kv, heads=heads:
                      flash.flash_attention_lse(
                          q, kv[0].transpose(1, 2), kv[1].transpose(1, 2),
                          kvl, qpos, **heads), 1))
        pools = [pool(x) for x in kv]
        psc = {k: pool(v) for k, v in sc.items()}
        cases.append(("paged_flash_attention_lse" + mode,
                      lambda q=q, pools=pools, psc=psc:
                      paged.paged_flash_attention_lse(
                          q, pools[0], pools[1], table, kvl, qpos, **psc), 1))
        cases.append(("tree_block_attention" + mode,
                      lambda q=q, tkv=tkv, theads=theads:
                      tree_block.tree_block_attention(
                          q, tkv[0].transpose(1, 2), tkv[1].transpose(1, 2),
                          mask, **theads), 1))
        tpools = [pool(x) for x in tkv]
        tpsc = {k: pool(v) for k, v in tsc.items()}
        cases.append(("paged_tree_block_attention" + mode,
                      lambda q=q, tpools=tpools, tpsc=tpsc:
                      paged.paged_tree_block_attention(
                          q, tpools[0], tpools[1], t_table, mask, **tpsc), 1))
        esc = {"kt_scale": theads.get("k_scale"),
               "vt_scale": theads.get("v_scale")} if int8 else {}
        cases.append(("ops.tree_attention" + mode,
                      lambda q=q, kv=kv, tkv=tkv, heads=heads, esc=esc:
                      ops.tree_attention(
                          q, kv[0].transpose(1, 2), kv[1].transpose(1, 2),
                          tkv[0].transpose(1, 2), tkv[1].transpose(1, 2),
                          mask, kvl, qpos=qpos, **heads, **esc), 2))
        pesc = {"kt_scale": tpsc.get("k_scale"),
                "vt_scale": tpsc.get("v_scale")} if int8 else {}
        cases.append(("ops.paged_tree_attention" + mode,
                      lambda q=q, pools=pools, tpools=tpools, psc=psc,
                      pesc=pesc:
                      ops.paged_tree_attention(
                          q, pools[0], pools[1], table, tpools[0], tpools[1],
                          t_table, mask, kvl, qpos=qpos, **psc, **pesc), 2))
    bad, counts = [], {}
    for name, fn, want in cases:
        counts[name] = _cuda_launches(torch, fn)
        if counts[name] != want:
            bad.append(f"{name}: {counts[name]} launches, not {want}")
    emit({"phase": "kernels", "check": "one CUDA launch per wrapper call, "
          "two per tree-verify entry point (torch.profiler, "
          "cudaLaunchKernel)", "launches": counts, "ok": not bad})
    return bad


# ---------------------------------------------------------------------------
# launch counts: zeroed before a path runs, checked against its model calls
# ---------------------------------------------------------------------------
def _counters():
    """(row name, wrapper, counter attribute) of every KERNEL_ROWS entry."""
    from repro_torch.kernels import flash, paged, quant, tree_block
    out = []
    for row, fn in (("flash_attention_lse", flash.flash_attention_lse),
                    ("tree_block_attention", tree_block.tree_block_attention),
                    ("paged_flash_attention_lse",
                     paged.paged_flash_attention_lse),
                    ("paged_tree_block_attention",
                     paged.paged_tree_block_attention)):
        out += [(row, fn, "launches"), (row + " int8", fn, "launches_int8"),
                (row + HD256, fn, "launches_hd256"),
                (row + " int8" + HD256, fn, "launches_int8_hd256")]
    return (*out, ("flash_attention_lse" + HD256_WINDOW,
                   flash.flash_attention_lse, "launches_hd256_window"),
            ("dequant_matmul", quant.dequant_matmul, "launches"))


def zero_launches(*bundles):
    """Set every kernel's launch counts and the bundles' call counts to 0."""
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)
    for b in bundles:
        if b is not None:
            b.calls.clear()


def read_launches(*bundles, paged=False):
    """(launches, expected): the kernels' counts by KERNEL_ROWS name, and
    what the bundles' calls imply.  Each forward pass launches flash once
    per layer, and each tree verify the tree kernel once per layer, in
    their int8 mode for an int8 bundle; each forward pass of an int8
    bundle also launches dequant_matmul once per projection of each layer.
    A fused DB tree verify (``tree_verify_rows``) on a ``paged`` arena
    launches the paged flash and paged tree kernels instead of the dense
    ones.  An MLA model (DeepSeek) attends in plain PyTorch, with no
    launch; a model whose head_dim is over 128 (Gemma) launches the
    head_dim 256 instances, counted in the ``hd256`` rows as well.  A
    bundle carrying an encoder output (Whisper) also launches flash once
    per layer of every model call for its cross-attention, on a paged
    arena too (the encoder output is one dense tensor).  Only attention
    layers launch: a recurrent layer (SSD, RG-LRU) runs in plain PyTorch,
    so Mamba-2 launches nothing and RecurrentGemma flash once per local
    layer, on the head_dim 256 instance with its window (also counted in
    the ``hd256 window`` row).  A bundle that serves as both target and
    draft is counted once."""
    launches = {row: getattr(fn, attr) for row, fn, attr in _counters()}
    expect = collections.Counter(dict.fromkeys(launches, 0))
    uniq = {id(b): b for b in bundles if b is not None}.values()
    for b in uniq:
        layers, windowed = _attention_layers(b.cfg)
        calls = b.calls
        rows = calls.get("tree_verify_rows", 0)
        trees = calls.get("tree_verify", 0) + (0 if paged else rows)
        forward = sum(calls.get(k, 0) for k in ("prefill", "decode",
                                                "prefill_chunk")) + trees
        cross = b.cfg.num_layers if getattr(b, "cross_kv", None) else 0
        int8 = b.cfg.quant == "int8"
        modes = [" int8" if int8 else ""]
        if b.cfg.resolved_head_dim > 128:
            modes.append(modes[0] + HD256)
        if b.cfg.resolved_head_dim > 128 and not int8:
            expect["flash_attention_lse" + HD256_WINDOW] += windowed * forward
        for mode in modes:
            expect["flash_attention_lse" + mode] += layers * forward + \
                cross * (forward + (rows if paged else 0))
            expect["tree_block_attention" + mode] += layers * trees
            if paged:
                expect["paged_flash_attention_lse" + mode] += layers * rows
                expect["paged_tree_block_attention" + mode] += layers * rows
        if int8:
            expect["dequant_matmul"] += PROJECTIONS * layers * (
                forward + (rows if paged else 0))
    return launches, dict(expect)


def _attention_layers(cfg):
    """(layers that launch attention kernels, those of them with a
    window): an MLA model attends in plain PyTorch, a recurrent layer has
    no attention."""
    from repro_torch.models import transformer as tf
    if cfg.mla is not None:
        return 0, 0
    kinds = tf.layer_kinds(cfg)
    att = [w for k, w in zip(kinds, tf.layer_windows(cfg))
           if k not in tf.RECURRENT_KINDS]
    return len(att), sum(w > 0 for w in att)


def launches_ok(launches, expect, used):
    """Counts equal what the calls imply, and every kernel of ``used``
    (the path's kernels) ran."""
    return launches == expect and all(launches[k] for k in used)


FP32_PATH = ("flash_attention_lse", "tree_block_attention")
INT8_PATH = ("flash_attention_lse int8", "tree_block_attention int8",
             "dequant_matmul")
# the paged DB path: the dense flash kernel only in admission prefill
PAGED_PATH = ("flash_attention_lse", "paged_flash_attention_lse",
              "paged_tree_block_attention")
PAGED_INT8_PATH = ("flash_attention_lse int8",
                   "paged_flash_attention_lse int8",
                   "paged_tree_block_attention int8", "dequant_matmul")


# ---------------------------------------------------------------------------
# phases train and train-pair: the training path, then a pair trained here
# ---------------------------------------------------------------------------
def _byte_batches(data, batch: int, seq: int, n: int):
    """The first ``n`` batches ``launch.train.train`` takes at seed 0 from
    the corpus bytes ``data``."""
    from repro_torch.data import ByteCorpus, DataConfig, batch_iterator
    corpus = ByteCorpus(data, DataConfig(seq_len=seq, batch_size=batch,
                                         seed=0))
    it = batch_iterator(corpus, epochs=1000)
    return [{"tokens": t, "labels": y} for t, y in
            (next(it) for _ in range(n))]


def _f64_check(model, batch, *, dtype=None, noise: float = 0.0):
    """Loss and global grad norm of ``batch`` for a float64 (or
    ``dtype``) copy of ``model`` on the card (the reference of the fp32
    step): the train step's loss (``steps.batch_loss``, no remat), a
    weight the loss does not reach counting 0.  ``noise`` > 0 first
    scales each weight of the copy by 1 + noise * N(0, 1) (seed 0)."""
    import copy
    import torch
    from repro_torch.launch.steps import batch_loss
    from repro_torch.models.layers import trainable
    ref = copy.deepcopy(model).to(dtype or torch.float64)
    params = trainable(ref)
    if noise:
        gen = torch.Generator(device=params[0].device).manual_seed(0)
        with torch.no_grad():
            for p in params:
                p.mul_(1 + noise * torch.randn(p.shape, generator=gen,
                                               device=p.device,
                                               dtype=p.dtype))
    loss = batch_loss(ref, batch, remat=False)
    loss.backward()
    gnorm = torch.sqrt(sum(torch.sum(p.grad.square()) for p in params
                           if p.grad is not None))
    out = (loss.item(), gnorm.item())
    del ref, params, loss
    torch.cuda.empty_cache()
    return out


def _rel_err(got, want):
    """[loss, grad norm] relative errors of ``got`` against ``want``."""
    return [abs(g - w) / abs(w) for g, w in zip(got, want)]


def _f64_depths(cfg, depths, batch):
    """For each depth in ``depths``: the model cut to that depth, seeded
    on the card, step 0's fp32 loss and grad norm against its float64
    copy's.  Returns {depth: [loss, grad norm] relative errors}."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tf
    out = {}
    for k in depths:
        model = tf.init_model(dataclasses.replace(cfg, num_layers=k),
                              seed=0, device="cuda")
        out[k] = _rel_err(_f64_check(model, batch, dtype=torch.float32),
                          _f64_check(model, batch))
        del model
    return out


def _train_flop(cfg, batch: int, seq: int, *, prefix: int = 0,
                frames: int = 0) -> float:
    """FLOPs of the products of one training step, the backward counted
    as twice the forward, over the decoder's ``batch`` x (``prefix`` +
    ``seq``) rows, each layer by its kind: the projections of attention
    (GQA, or MLA's low-rank ones and the expansion of each row's keys and
    values) and the two attention products over the whole score matrix
    that plain attention computes; the MLP; a MoE block's router, the
    grouped products over every expert's ``capacity`` rows (computed
    whether filled or not) and its shared experts; an SSD layer's
    projections, depthwise conv and chunked scan (C B^T, the in-chunk
    product, the state in and out of each chunk); an RG-LRU layer's
    projections, gates and conv (its scan is elementwise); with
    ``frames``, the encoder's layers over them and each decoder layer's
    cross-attention (its K/V projections per frame); the unembedding of
    the ``seq`` rows (the input embedding is a lookup, not a product).
    Remat's recomputed forward is not counted."""
    from repro_torch.models import moe, transformer as tf
    d, hd, h, kvh = (cfg.d_model, cfg.resolved_head_dim, cfg.num_heads,
                     cfg.num_kv_heads)
    gated = 3 if cfg.mlp_variant in ("swiglu", "geglu") else 2

    def gqa(keys, heads=h):          # per query row
        return d * hd * 2 * (heads + kvh) + 2 * keys * heads * hd

    def mla(keys):
        m = cfg.mla
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        q = (d * m.q_lora_rank + m.q_lora_rank * h * qd if m.q_lora_rank
             else d * h * qd)
        rows = (d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim))
        return (q + rows + h * m.v_head_dim * d
                + keys * h * (qd + m.v_head_dim))

    s_all = prefix + seq
    rows = batch * s_all
    macs = batch * seq * d * cfg.vocab_size
    for i, kind in enumerate(tf.layer_kinds(cfg)):
        if kind == "ssm":
            sc = cfg.ssm
            di, n = sc.d_inner(d), sc.d_state
            nh, q = sc.num_heads(d), min(sc.chunk, s_all)
            macs += rows * (d * (2 * di + 2 * n + nh) + di * d
                            + sc.d_conv * (di + 2 * n)
                            + q * n + q * nh * sc.head_dim
                            + 2 * nh * sc.head_dim * n)
            continue
        if kind == "rglru":
            w = cfg.rglru.lru_width or d
            macs += rows * (3 * d * w + 2 * w * w + cfg.rglru.d_conv * w)
        else:
            macs += rows * (mla(s_all) if cfg.mla is not None
                            else gqa(s_all))
        if frames and cfg.is_encdec:      # cross: q, o, attention; k, v
            macs += rows * (2 * d * h * hd + 2 * frames * h * hd)
            macs += batch * frames * 2 * d * kvh * hd
        if cfg.layer_is_moe(i):
            mo = cfg.moe
            f = mo.d_ff_expert
            macs += rows * (d * mo.num_experts
                            + 3 * d * f * mo.num_shared_experts)
            macs += mo.num_experts * moe.capacity(rows, cfg) * 3 * d * f
        else:
            macs += rows * gated * d * cfg.d_ff
    if frames and cfg.is_encdec:
        enc = cfg.encoder
        macs += batch * frames * enc.num_layers * (
            gqa(frames) + 2 * d * (enc.d_ff or cfg.d_ff))
    return 6.0 * macs


def _train_run(model, batches, steps: int, *, remat: bool,
               profile_calls: int, warmup: int = TRAIN_WARMUP,
               after_step0=None):
    """``steps`` AdamW steps of ``launch.train.train``'s recipe (lr
    TRAIN_LR, ``max(10, steps // 20)`` warm-up steps) on ``batches``
    through ``make_train_step``, each timed with CUDA events (the median
    past the first ``warmup``); then ``profile_calls`` more steps, all
    but the first under torch.profiler.  ``after_step0(metrics)``, when
    given, runs after step 0 (a synchronising check).  Returns the run's
    numbers; no kernel of the port may launch."""
    import statistics
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.layers import trainable
    from repro_torch.optim import AdamWConfig, adamw_init

    params = trainable(model)
    opt = adamw_init(params)
    step = make_train_step(model.cfg, AdamWConfig(
        lr=TRAIN_LR, warmup_steps=max(10, steps // 20), total_steps=steps),
        remat=remat)
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = []
    for batch in batches[:steps]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        opt, metrics = step(model, opt, batch)
        end.record()
        timed.append((start, end, metrics))
        if after_step0 is not None and len(timed) == 1:
            after_step0(metrics)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = [a.elapsed_time(b) for a, b, _ in timed]
    extra = iter(batches[steps:])
    holder = [opt]

    def one_step():
        holder[0], _ = step(model, holder[0], next(extra))
    busy_ms, top = _device_profile(one_step, profile_calls - 1, top=8)
    launches, _ = read_launches()
    n_params = sum(p.numel() for p in params)
    b, s = batches[0]["tokens"].shape
    modal = {k: batches[0][v].shape[1] for k, v in
             (("prefix", "prefix_embeds"), ("frames", "frames"))
             if batches[0].get(v) is not None}
    flop = _train_flop(model.cfg, b, s, **modal)
    step_ms = statistics.median(ms[warmup:])
    return {"remat": remat, "steps": steps, "batch": b, "seq": s, **modal,
            "loss": [float(m["loss"]) for *_, m in timed],
            "grad_norm": [float(m["grad_norm"]) for *_, m in timed],
            "lr_schedule": [float(m["lr"]) for *_, m in timed],
            "ms_per_step": step_ms, "step_ms": ms,
            "tokens_per_s": b * s / step_ms * 1e3,
            "peak_mem_gb": peak_gb, "params": n_params,
            "tflop_per_step": flop / 1e12,
            "fp32_peak_share": flop / (step_ms / 1e3)
            / _peak("FP32_FLOP_PER_S"),
            "busy_ms_per_step": busy_ms,
            "idle_share": 1 - busy_ms / step_ms,
            "profiled_steps": profile_calls - 1, "top_device_ops": top,
            "kernel_launches": sum(launches.values()),
            "on_card": all(p.is_cuda for p in params)}


def _train_line(name, cfg, full_layers, run, extra, checks,
                phase="train"):
    emit({"phase": phase, "model": name, "config": cfg.name,
          "layers": f"{cfg.num_layers} of {full_layers}",
          "lr": TRAIN_LR,
          "fp32_peak_flop_per_s": _peak("FP32_FLOP_PER_S"), **run, **extra,
          "checks": checks, "ok": all(checks.values())})
    return all(checks.values())


def _draft_runs(batches, steps: int, profile_calls: int):
    """The draft (LLaMA-3.2-1B whole, seed 0) trained on ``batches`` with
    remat off and on, and the float64 loss and grad norm of the first
    batch.  Returns ({remat: run}, (loss, grad norm))."""
    import gc
    import torch
    from repro_torch.configs import pipedec_pair
    from repro_torch.models import transformer as tf
    runs = {}
    for remat in (False, True):
        model = tf.init_model(pipedec_pair.DRAFT, seed=0, device="cuda")
        if not remat:      # the float64 reference of step 0's batch
            f64 = _f64_check(model, batches[0])
        runs[remat] = _train_run(model, batches, steps, remat=remat,
                                 profile_calls=profile_calls)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return runs, f64


def _draft_checks(runs, f64, common, *, falls: bool):
    """Each draft run's line: ``common`` checks, finite values, the loss
    falling (when ``falls``), step 0 of remat on against off and of remat
    off against the float64 copy.  Returns whether all held."""
    import math
    from repro_torch.configs import pipedec_pair
    off = runs[False]
    ok = True
    for remat, run in runs.items():
        losses = run["loss"]
        checks = {"finite": all(map(math.isfinite, losses + run["grad_norm"])),
                  "no_kernel_launch": run["kernel_launches"] == 0,
                  "on_card": run["on_card"], **common}
        if falls:
            checks["loss_falls"] = sum(losses[-5:]) / 5 < losses[0]
        if remat:
            err = [abs(run[k][0] - off[k][0]) / abs(off[k][0])
                   for k in ("loss", "grad_norm")]
            checks["remat_equal"] = max(err) <= TOL_REMAT
            extra = {"remat_rel_err": {"loss": err[0], "grad_norm": err[1],
                                       "tol": TOL_REMAT}}
        else:
            err = [abs(off[k][0] - ref) / abs(ref)
                   for k, ref in zip(("loss", "grad_norm"), f64)]
            checks["f64_equal"] = max(err) <= TOL_F64
            extra = {"f64": {"loss": f64[0], "grad_norm": f64[1],
                             "rel_err": err, "tol": TOL_F64}}
        ok = _train_line("draft", pipedec_pair.DRAFT,
                         pipedec_pair.DRAFT.num_layers, run, extra,
                         checks) and ok
    return ok


def phase_train(state):
    """The training path at published widths: the draft (LLaMA-3.2-1B
    whole) with remat off and on at S 128 and at S 2048, and one
    LLaMA-3.1-70B layer."""
    import dataclasses
    import gc
    import math
    import torch
    from repro_torch.configs import pipedec_pair
    from repro_torch.data import synthetic_corpus
    from repro_torch.models import transformer as tf

    data = synthetic_corpus(TRAIN_CORPUS, seed=0)
    batches = _byte_batches(data, TRAIN_BATCH, TRAIN_SEQ,
                            TRAIN_STEPS + TRAIN_PROFILE)
    long_batches = _byte_batches(data, TRAIN_LONG_BATCH, TRAIN_LONG_SEQ,
                                 TRAIN_LONG_STEPS + 2)
    common = {"tf32_off": not torch.backends.cuda.matmul.allow_tf32,
              "byte_tokens": all(b["tokens"].max() < 260
                                 for b in batches + long_batches)}
    ok = _draft_checks(*_draft_runs(batches, TRAIN_STEPS, TRAIN_PROFILE),
                       common, falls=True)
    ok = _draft_checks(*_draft_runs(long_batches, TRAIN_LONG_STEPS, 2),
                       common, falls=False) and ok

    tcfg = dataclasses.replace(pipedec_pair.TARGET, num_layers=1)
    model = tf.init_model(tcfg, seed=0, device="cuda")
    run = _train_run(model, batches, TRAIN_TARGET_STEPS, remat=True,
                     profile_calls=2)
    checks = {"finite": all(map(math.isfinite, run["loss"]
                                + run["grad_norm"])),
              "no_kernel_launch": run["kernel_launches"] == 0,
              "on_card": run["on_card"],
              "tf32_off": common["tf32_off"]}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    ok = _train_line("target", tcfg, pipedec_pair.TARGET.num_layers, run,
                     {}, checks) and ok
    if not ok:
        raise AssertionError("train phase failed: see its lines")


def _decay_check(model, names):
    """``after_step0`` for a zero-gradient AdamW step: each weight of
    ``model`` named in ``names`` must equal its value before the step times
    ``1 - lr * weight_decay`` (m and v stay 0, so the update is the decay
    alone).  Fills and returns {"max_rel_err", "moved"}: the largest
    ``|p - want| / max|p_before|`` and whether every weight changed."""
    import torch
    from repro_torch.optim import AdamWConfig
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n in names}
    out = {"weights": len(before), "tol": TOL_DECAY}

    def check(metrics):
        factor = 1 - float(metrics["lr"]) * AdamWConfig().weight_decay
        errs, moved = [], True
        for n, p in model.named_parameters():
            if n in before:
                b = before[n]
                errs.append(((p.detach() - b * factor).abs().max()
                             / b.abs().max().clamp_min(1e-30)).item())
                moved = moved and not torch.equal(p.detach(), b)
        out.update(max_rel_err=max(errs), moved=moved)
        before.clear()
    return out, check


def _train_family(name, arch, layers, modal, f64_cut, batches):
    """One ``train-families`` line: ``arch`` at published width, cut to
    ``layers`` decoder layers (None: whole), seeded on the card, with
    ``modal`` ("frames", "prefix" or None) in every batch; step 0 of the
    fp32 run against a float64 copy, TRAIN_FAMILY_STEPS AdamW steps with
    remat through ``make_train_step``.  With ``f64_cut`` (depths), the
    float64 check is held at the first of them (fp32 against float64 of
    the model cut there), and the line reports the relative errors at
    each depth and at the whole one, and how far the whole model's
    float64 grad norm moves when its weights are scaled by 1 + 6e-8 N(0,
    1) (fp32 rounding of the weights alone).  Without frames an
    encoder-decoder's encoder and cross sub-layers take no gradient:
    their weights must move by the decay alone.  Returns whether every
    check held."""
    import dataclasses
    import gc
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import frontends
    from repro_torch.models import transformer as tf
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
    model = tf.init_model(cfg, seed=0, device="cuda")
    extra = {}
    if modal == "frames":
        extra["frames"] = frontends.stub_audio_frames(
            cfg, TRAIN_BATCH, seed=2, device="cuda")
    elif modal == "prefix":
        extra["prefix_embeds"] = frontends.stub_vision_prefix(
            cfg, TRAIN_BATCH, seed=2, device="cuda")
    batches = [{**b, **extra} for b in batches]
    f64 = _f64_check(model, batches[0])
    if f64_cut:
        noisy = _f64_check(model, batches[0], noise=F64_WEIGHT_NOISE)
    decay, after0 = None, None
    if cfg.is_encdec and modal is None:
        names = {n for n, _ in model.named_parameters()
                 if n.startswith("encoder.") or ".cross" in n}
        decay, after0 = _decay_check(model, names)
    run = _train_run(model, batches, TRAIN_FAMILY_STEPS, remat=True,
                     profile_calls=2, warmup=1, after_step0=after0)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    err = _rel_err([run["loss"][0], run["grad_norm"][0]], f64)
    f64_line = {"loss": f64[0], "grad_norm": f64[1], "rel_err": err,
                "tol": TOL_F64, "depth": cfg.num_layers}
    if f64_cut:
        cut = _f64_depths(cfg, f64_cut, batches[0])
        f64_line.update(
            depth=f64_cut[0], whole_rel_err=err,
            rel_err=cut[f64_cut[0]],
            rel_err_by_depth={**cut, cfg.num_layers: err},
            weight_noise=F64_WEIGHT_NOISE,
            noise_rel_change=_rel_err(noisy, f64))
    checks = {"finite": all(map(math.isfinite, run["loss"]
                                + run["grad_norm"])),
              "no_kernel_launch": run["kernel_launches"] == 0,
              "on_card": run["on_card"],
              "tf32_off": not torch.backends.cuda.matmul.allow_tf32,
              "f64_equal": max(f64_line["rel_err"]) <= TOL_F64}
    info = {"f64": f64_line, "modal_input": modal}
    if cfg.is_encdec:
        info["encoder_layers"] = cfg.encoder.num_layers
    if decay is not None:
        checks["zero_grad_decay"] = (decay.get("moved", False) and
                                     decay["max_rel_err"] <= TOL_DECAY)
        info["zero_grad_decay"] = decay
    return _train_line(name, cfg, full.num_layers, run, info, checks,
                       phase="train-families")


def phase_train_families(state):
    """Every family the port serves trained at published width
    (TRAIN_FAMILIES), TRAIN_FAMILY_STEPS AdamW steps each at the JAX CLI's
    batch on the trainer's corpus."""
    import gc
    import torch
    from repro_torch.data import synthetic_corpus
    batches = _byte_batches(synthetic_corpus(TRAIN_CORPUS, seed=0),
                            TRAIN_BATCH, TRAIN_SEQ, TRAIN_FAMILY_STEPS + 2)
    failed = []
    for name, arch, layers, modal, f64_cut in TRAIN_FAMILIES:
        try:
            if not _train_family(name, arch, layers, modal, f64_cut,
                                 batches):
                failed.append(name)
        except Exception as exc:   # record, train the other families
            traceback.print_exc()
            failed.append(name)
            emit({"phase": "train-families", "model": name, "ok": False,
                  "error": repr(exc)})
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"train-families failed: {failed}")


def _eval_prompts():
    """Held-out prompts: the first PAIR_PROMPT_LEN bytes of examples of
    another seed's corpus (``benchmarks/common.py`` ``eval_prompts``)."""
    import numpy as np
    from repro_torch.data import ByteCorpus, DataConfig, synthetic_corpus
    corpus = ByteCorpus(synthetic_corpus(1 << 14, seed=3),
                        DataConfig(seq_len=PAIR_PROMPT_LEN, batch_size=1))
    return [corpus.example(i)[0].astype(np.int64)
            for i in range(PAIR_PROMPTS)]


def _pair_serve(mode, target, draft, prompts, path):
    """Serve ``prompts`` with ``ServingEngine(mode)``, one request at a
    time (pp: ``max_batch`` 1), PAIR_NEW_TOKENS each; launch counts
    checked against the model calls.  Returns (results, wall s, launch
    line, launches ok)."""
    import torch
    from repro_torch.core.pipedec import PipeDecConfig
    from repro_torch.serving import Request, ServingEngine
    engine = ServingEngine(target, draft, mode=mode, max_batch=1,
                           max_len=PAIR_MAX_LEN,
                           pipedec=PipeDecConfig(n_stages=4, width=8,
                                                 branch=4))
    for uid, p in enumerate(prompts):
        engine.submit(Request(uid, p, PAIR_NEW_TOKENS))
    zero_launches(target, draft)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, expect = read_launches(target, draft)
    good = launches_ok(launches, expect, path)
    return results, wall_s, {"launches": launches,
                             "expected_launches": expect}, good


def phase_train_pair(state):
    """The smoke pair trained on the card on one corpus (the benchmarks'
    recipe), saved, reloaded and served losslessly by PipeDec and PP."""
    import numpy as np
    import torch
    from repro_torch import configs as cfg_reg
    from repro_torch.core.baselines import generate_autoregressive
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer as tf

    ckdir = ROOT / "build" / "train_pair"
    trained, losses, train_s = {}, {}, {}
    for arch in ("pipedec-target", "pipedec-draft"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            trained[arch], losses[arch] = train.train(
                cfg_reg.get_config(arch, smoke=True), steps=PAIR_STEPS,
                batch=PAIR_BATCH, seq=PAIR_SEQ, lr=PAIR_LR, seed=0,
                log_every=0, corpus_bytes=PAIR_CORPUS,
                ckpt=str(ckdir / f"{arch}.npz"), device="cuda")
        torch.cuda.synchronize()
        train_s[arch] = time.perf_counter() - t0
    prompts = _eval_prompts()
    batch = np.stack(prompts)
    bundles, reload_equal = {}, {}
    for arch, model in trained.items():
        bundles[arch] = serve.build_bundle(
            arch, seed=0, ckpt=str(ckdir / f"{arch}.npz"), device="cuda")
        with torch.no_grad():
            reload_equal[arch] = torch.equal(
                tf.forward(bundles[arch].model, batch),
                tf.forward(model, batch))
    del trained
    target, draft = bundles["pipedec-target"], bundles["pipedec-draft"]

    res_pd, wall_pd, launch_pd, ok_pd = _pair_serve(
        "pipedec", target, draft, prompts, FP32_PATH)
    res_pp, wall_pp, launch_pp, ok_pp = _pair_serve(
        "pp", target, None, prompts, ("flash_attention_lse",))
    rows, lossless = [], True
    for uid, p in enumerate(prompts):
        want = generate_autoregressive(target, p, PAIR_NEW_TOKENS,
                                       max_len=PAIR_MAX_LEN)
        same_pd, tie_pd = _lossless(target, p, res_pd[uid].tokens, want)
        same_pp, tie_pp = _lossless(target, p, res_pp[uid].tokens, want)
        lossless = lossless and same_pd and same_pp
        st = res_pd[uid].stats
        rows.append({"uid": uid, "pipedec_lossless": same_pd,
                     "pp_lossless": same_pp, "near_tie": tie_pd or tie_pp,
                     "hits": st.hits, "misses": st.misses,
                     "commits": st.commits, "timesteps": st.timesteps,
                     "acceptance": st.acceptance,
                     "tokens_per_timestep": st.tokens_per_timestep})
    hits = sum(r["hits"] for r in rows)
    misses = sum(r["misses"] for r in rows)
    new_tokens = PAIR_PROMPTS * PAIR_NEW_TOKENS

    buf = io.StringIO()
    cli_path = str(ckdir / "cli.npz")
    with contextlib.redirect_stdout(buf):
        _, cli_losses = train.main(["--arch", "pipedec-draft", "--smoke",
                                    "--steps", "3", "--batch", "2",
                                    "--seq", "32", "--ckpt", cli_path])
    cli_ok = (len(cli_losses) == 3 and all(np.isfinite(cli_losses))
              and serve.build_bundle("pipedec-draft", seed=0, ckpt=cli_path,
                                     device="cuda").model.device.type
              == "cuda")

    final = {a: float(np.mean(v[-10:])) for a, v in losses.items()}
    checks = {"losses_finite": all(np.isfinite(v).all()
                                   for v in losses.values()),
              "losses_fall": all(v[-1] < v[0] for v in losses.values()),
              "reload_bit_equal": all(reload_equal.values()),
              "lossless": lossless, "pipedec_launches": ok_pd,
              "pp_launches": ok_pp, "cli": cli_ok}
    emit({"phase": "train-pair", "ok": all(checks.values()),
          "checks": checks,
          "recipe": {"steps": PAIR_STEPS, "batch": PAIR_BATCH,
                     "seq": PAIR_SEQ, "lr": PAIR_LR,
                     "corpus_bytes": PAIR_CORPUS, "seed": 0},
          "first_loss": {a: v[0] for a, v in losses.items()},
          "final_loss_mean_last_10": final,
          "last_loss": {a: v[-1] for a, v in losses.items()},
          "train_s": train_s,
          "pipedec_config": {"n_stages": 4, "width": 8, "branch": 4},
          "prompts": PAIR_PROMPTS, "prompt_len": PAIR_PROMPT_LEN,
          "new_tokens": PAIR_NEW_TOKENS,
          "acceptance": hits / max(hits + misses, 1), "hits": hits,
          "misses": misses,
          "tokens_per_timestep": sum(r["commits"] for r in rows)
          / sum(r["timesteps"] for r in rows),
          "pipedec_ms_per_token": 1e3 * wall_pd / new_tokens,
          "pp_ms_per_token": 1e3 * wall_pp / new_tokens,
          "launches": {"pipedec": launch_pd, "pp": launch_pp},
          "cli_losses": cli_losses, "cli_printed":
          buf.getvalue().strip().splitlines(), "requests": rows})
    if not all(checks.values()):
        raise AssertionError("train-pair phase failed: see its line")


# ---------------------------------------------------------------------------
# phase 3: full-width serving, the main path
# ---------------------------------------------------------------------------
def _margin(bundle, prefix):
    """Top-2 logit margin of the next-token prediction after ``prefix``."""
    import numpy as np
    import torch
    cache = bundle.init_cache(1, len(prefix) + 1)
    logits, _ = bundle.prefill(np.asarray(prefix, np.int64)[None], cache)
    top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1])


def _lossless(bundle, prompt, got, want):
    """Compare speculative ``got`` with autoregressive ``want`` tokens;
    returns (ok, near_tie_position or None)."""
    for i, (x, y) in enumerate(zip(got.tolist(), want.tolist())):
        if x == y:
            continue
        margin = _margin(bundle, list(prompt) + want.tolist()[:i])
        return margin < NEAR_TIE, {"position": i, "margin": margin}
    return len(got) == len(want), None


def _serve(phase, state, target, draft, path, extra):
    """The main path's serving run: the phase-3 requests through
    ServingEngine(mode="pipedec"), 8 stages, width 8, branch 4; tokens
    checked against autoregressive decoding of ``target`` (near-tie rule),
    launch counts against the model calls, with every kernel of ``path``
    launched.  Emits the phase line; raises if a check fails."""
    import numpy as np
    import torch
    from repro_torch.configs import pipedec_pair
    from repro_torch.core.baselines import generate_autoregressive
    from repro_torch.core.pipedec import PipeDecConfig
    from repro_torch.serving import Request, ServingEngine

    rng = np.random.default_rng(0)
    lens = [64, 96, 128, 80][:SERVE_REQUESTS]
    prompts = [rng.integers(0, target.cfg.vocab_size, size=s).astype(
        np.int64) for s in lens]
    pcfg = PipeDecConfig(n_stages=8, width=8, branch=4)
    engine = ServingEngine(target, draft, mode="pipedec", pipedec=pcfg,
                           max_len=256)
    for uid, p in enumerate(prompts):
        engine.submit(Request(uid, p, SERVE_NEW_TOKENS))

    zero_launches(target, draft)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches, expect = read_launches(target, draft)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state["launches"].update({k: launches[k] for k in path})
    tc, dc = dict(target.calls), dict(draft.calls)

    rows, ok = [], launches_ok(launches, expect, path)
    state["prompts"] = prompts
    ar = state.setdefault("autoregressive", {})[phase] = {}
    ar_s = 0.0
    for uid, p in enumerate(prompts):
        res = results[uid]
        t0 = time.perf_counter()
        want = ar[uid] = generate_autoregressive(target, p, SERVE_NEW_TOKENS,
                                                 max_len=256)
        torch.cuda.synchronize()
        ar_s += time.perf_counter() - t0
        same, tie = _lossless(target, p, res.tokens, want)
        ok = ok and same
        st = res.stats
        rows.append({"uid": uid, "prompt_len": len(p),
                     "latency_s": res.latency_s,
                     "acceptance": st.acceptance,
                     "tokens_per_timestep": st.tokens_per_timestep,
                     "timesteps": st.timesteps, "hits": st.hits,
                     "misses": st.misses, "lossless": same,
                     "near_tie": tie})
    new_tokens = len(prompts) * SERVE_NEW_TOKENS
    state.setdefault("measured", {})[phase] = {
        "pipedec_ms_per_token": 1e3 * serve_s / new_tokens,
        "pp_ms_per_token": 1e3 * ar_s / new_tokens,
        "tokens_per_timestep": sum(results[u].stats.commits
                                   for u in results)
        / sum(r["timesteps"] for r in rows)}
    emit({"phase": phase, "ok": ok, "mode": "pipedec",
          "quant": target.cfg.quant or "none",
          "target": target.cfg.name, "draft": draft.cfg.name,
          "reduced": {"target_layers": f"{target.cfg.num_layers} of "
                      f"{pipedec_pair.TARGET.num_layers}",
                      "draft_layers": f"{draft.cfg.num_layers} of "
                      f"{pipedec_pair.DRAFT.num_layers}"},
          "pipedec": {"n_stages": 8, "width": 8, "branch": 4},
          "new_tokens": SERVE_NEW_TOKENS, **extra, "serve_s": serve_s,
          "autoregressive_s": ar_s,
          "timesteps": sum(r["timesteps"] for r in rows),
          "peak_mem_gb": peak_gb, "calls": {"target": tc, "draft": dc},
          "launches": launches, "expected_launches": expect,
          "requests": rows})
    if not ok:
        raise AssertionError(f"{phase} phase failed: see its line")


def phase_serve(state):
    import dataclasses
    import torch
    from repro_torch.configs import pipedec_pair
    from repro_torch.core.speculative import ModelBundle
    from repro_torch.models import transformer as tf

    tcfg = dataclasses.replace(pipedec_pair.TARGET, num_layers=TARGET_LAYERS)
    t0 = time.perf_counter()
    target = ModelBundle(tf.init_model(tcfg, seed=0, device="cuda"))
    dcfg = dataclasses.replace(pipedec_pair.DRAFT, num_layers=DRAFT_LAYERS)
    draft = ModelBundle(tf.init_model(dcfg, seed=1, device="cuda"))
    torch.cuda.synchronize()
    state["target"], state["draft"] = target, draft
    _serve("serve", state, target, draft, FP32_PATH,
           {"init_s": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# phases 4 and 14: self-draft (every prediction hits)
# ---------------------------------------------------------------------------
def _self_draft(phase, target, path):
    import numpy as np
    from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
    eng = PipeDecEngine(target, target,
                        PipeDecConfig(n_stages=4, width=8, branch=4))
    zero_launches(target)
    t0 = time.perf_counter()
    out, st = eng.generate(np.array([3, 3, 8]), SELF_DRAFT_NEW_TOKENS)
    wall_s = time.perf_counter() - t0
    launches, expect = read_launches(target)
    counted = launches_ok(launches, expect, path)
    ok = st.acceptance == 1.0 and st.tokens_per_timestep > 0.75 and counted
    emit({"phase": phase, "ok": ok, "quant": target.cfg.quant or "none",
          "acceptance": st.acceptance,
          "tokens_per_timestep": st.tokens_per_timestep,
          "timesteps": st.timesteps, "commits": st.commits,
          "commits_per_step": "".join(map(str, st.commits_per_step)),
          "calls": dict(target.calls), "launches": launches,
          "expected_launches": expect, "wall_s": wall_s})
    if not ok:
        raise AssertionError(f"{phase}: acceptance must be 1.0, "
                             "tokens/timestep > 0.75 and launches as expected")


def phase_self_draft(state):
    _self_draft("self-draft", state["target"], FP32_PATH)


# ---------------------------------------------------------------------------
# phases 5, 6 and 15: SpecPipe-DB at full width, dense and paged arenas
# ---------------------------------------------------------------------------
STATS = ("timesteps", "commits", "hits", "misses", "entries",
         "commits_per_step")


@contextlib.contextmanager
def exit_logits():
    """Record, per request, the target logits each token after the first
    is selected from at exit (a copy of the root's row): {id(GenStats):
    [logits [V], ...]}.  A resolved future of the overlapped ring is
    recorded as its value."""
    from repro_torch.core.pipedec import PipeDecEngine
    seen, real = {}, PipeDecEngine.exit_apply

    def exit_apply(self, st, fl, root_row, **kw):
        logits = fl.logits
        if hasattr(logits, "resolve"):
            logits = logits.resolve()
        seen.setdefault(id(st.stats), []).append(logits[root_row].clone())
        return real(self, st, fl, root_row, **kw)
    PipeDecEngine.exit_apply = exit_apply
    try:
        yield seen
    finally:
        PipeDecEngine.exit_apply = real


def _db_run(target, draft, requests, *, paged, slots, pcfg):
    """One SpecPipe-DB run through ServingEngine(mode="pipedec-db") on the
    local executor; launch counts zeroed just before and read just after.
    Returns (engine, results, executor, serve_s, peak_gb, launches,
    expect)."""
    import torch
    from repro_torch.serving import (LocalFusedExecutor, Request,
                                     ServingEngine)
    ex = LocalFusedExecutor(target, draft, slots=slots, max_len=DB_MAX_LEN,
                            tree_capacity=pcfg.tree_buffer_capacity,
                            capacity=pcfg.capacity, paged=paged, page=PAGE)
    engine = ServingEngine(target, draft, mode="pipedec-db", max_batch=slots,
                           max_len=DB_MAX_LEN, pipedec=pcfg, executor=ex)
    for uid, prompt, new, arrival in requests:
        engine.submit(Request(uid, prompt, new, arrival_t=arrival))
    zero_launches(target, draft)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with exit_logits() as seen:
        t0 = time.perf_counter()
        results = engine.run()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    for r in results.values():
        r.exit_logits = seen.get(id(r.stats), [])
    launches, expect = read_launches(target, draft, paged=paged)
    return (engine, results, ex, serve_s,
            torch.cuda.max_memory_allocated() / 1e9, launches, expect)


def _db_phase(phase, state, target, draft, requests, want, path, slots,
              pcfg, paged_only=False):
    """Serve ``requests`` (uid, prompt, new tokens, arrival) with
    SpecPipe-DB on the dense and then the paged arena (the paged one only
    when ``paged_only``); tokens against ``want`` by uid (near-tie rule),
    the paged run's tokens and GenStats against the dense run's, and the
    launch counts against the model calls (``path`` on the paged run).
    Emits one line per run; raises if a check fails."""
    from repro_torch.configs import pipedec_pair
    runs, ok = {}, True
    for paged in ((True,) if paged_only else (False, True)):
        engine, res, ex, serve_s, peak_gb, launches, expect = _db_run(
            target, draft, requests, paged=paged, slots=slots, pcfg=pcfg)
        st = engine.db_stats
        counted = launches_ok(launches, expect,
                              path if paged else
                              tuple(p.replace("paged_", "") for p in path))
        counted = counted and ex.calls["verify_rows"] == sum(
            st.verify_dispatches)
        if paged:
            counted = counted and all(
                launches[r] == 0 for r in launches
                if r.startswith("tree_block_attention"))
            state["launches"].update({k: launches[k] for k in path
                                      if k.startswith("paged_")})
        rows, good = [], counted
        for uid, prompt, new, arrival in requests:
            r = res[uid]
            same, tie = _lossless(target, prompt, r.tokens, want[uid])
            good = good and same
            rows.append({"uid": uid, "prompt_len": len(prompt),
                         "arrival_t": arrival, "latency_s": r.latency_s,
                         "acceptance": r.stats.acceptance,
                         "tokens_per_timestep": r.stats.tokens_per_timestep,
                         "timesteps": r.stats.timesteps, "hits": r.stats.hits,
                         "lossless": same, "near_tie": tie})
        runs[paged] = res
        state.setdefault("db_runs", {})[phase, paged] = {
            "results": res, "timesteps": st.timesteps,
            "ms_per_timestep": 1e3 * serve_s / max(st.timesteps, 1),
            "launches": launches,
            "launches_per_timestep": sum(launches.values())
            / max(st.timesteps, 1)}
        if paged and not paged_only:
            same_run = all(
                (runs[True][u].tokens == runs[False][u].tokens).all()
                and all(getattr(runs[True][u].stats, k)
                        == getattr(runs[False][u].stats, k) for k in STATS)
                for u in runs[False])
            good = good and same_run
        ok = ok and good
        emit({"phase": phase, "ok": good, "mode": "pipedec-db",
              "arena": "paged" if paged else "dense",
              "page": PAGE if paged else None,
              "quant": target.cfg.quant or "none",
              "target": target.cfg.name, "draft": draft.cfg.name,
              "reduced": {"target_layers": f"{target.cfg.num_layers} of "
                          f"{pipedec_pair.TARGET.num_layers}",
                          "draft_layers": f"{draft.cfg.num_layers} of "
                          f"{pipedec_pair.DRAFT.num_layers}"},
              "pipedec": {"n_stages": pcfg.n_stages, "width": pcfg.width,
                          "branch": pcfg.branch},
              "slots": slots, "max_len": DB_MAX_LEN,
              "paged_equals_dense": (same_run if paged and not paged_only
                                     else None),
              "timesteps": st.timesteps,
              "peak_occupancy": st.peak_occupancy,
              "tokens_per_timestep": st.tokens_per_timestep,
              "acceptance_rate": st.acceptance_rate,
              "serve_s": serve_s, "ms_per_timestep":
                  1e3 * serve_s / max(st.timesteps, 1),
              "pool_bytes": engine.executor.arena.pool_bytes(),
              "peak_mem_gb": peak_gb,
              "executor_calls": dict(ex.calls),
              "calls": {"target": dict(target.calls),
                        "draft": dict(draft.calls)},
              "launches": launches, "expected_launches": expect,
              "page_counters": st.page_counters[-1] if paged else None,
              "requests": rows})
    if not ok:
        raise AssertionError(f"{phase} phase failed: see its lines")


def _db_requests(state, n):
    prompts = state["prompts"][:n]
    return [(uid, p, SERVE_NEW_TOKENS, DB_ARRIVALS[uid])
            for uid, p in enumerate(prompts)]


def phase_serve_db(state):
    from repro_torch.core.pipedec import PipeDecConfig
    _db_phase("serve-db", state, state["target"], state["draft"],
              _db_requests(state, SERVE_REQUESTS),
              state["autoregressive"]["serve"], PAGED_PATH, DB_SLOTS,
              PipeDecConfig(n_stages=8, width=8, branch=4))


def phase_self_draft_db(state):
    """The 8-layer target as its own draft, 4 stages, paged, 3 requests
    on 2 slots: every prediction hits, so the paged commit and the batched
    prune remap run.  Per request: acceptance 1.0, more than 0.75 tokens
    per timestep and tokens equal to autoregressive decoding (near-tie
    rule); remap_rows > 0.  The single-request engine's tokens per
    timestep on the same prompts are printed beside (the tree's shape, so
    its capacity stalls, depends on the prompt)."""
    import numpy as np
    from repro_torch.core.baselines import generate_autoregressive
    from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
    target = state["target"]
    pcfg = PipeDecConfig(n_stages=4, width=8, branch=4)
    prompts = [np.array([3, 3, 8]), np.array([5, 1, 9, 2]),
               np.array([7, 7])]
    requests = [(uid, p, SELF_DRAFT_NEW_TOKENS, 0)
                for uid, p in enumerate(prompts)]
    engine, res, ex, serve_s, _, launches, expect = _db_run(
        target, target, requests, paged=True, slots=2, pcfg=pcfg)
    calls = dict(target.calls)          # before the reference runs below
    per, ok = {}, True
    single = PipeDecEngine(target, target, pcfg)
    for uid, prompt, new, _ in requests:
        st = res[uid].stats
        same, tie = _lossless(target, prompt, res[uid].tokens,
                              generate_autoregressive(target, prompt, new))
        per[uid] = {"acceptance": st.acceptance,
                    "tokens_per_timestep": st.tokens_per_timestep,
                    "single_request_tokens_per_timestep":
                        single.generate(prompt, new)[1].tokens_per_timestep,
                    "lossless": same, "near_tie": tie}
        ok = ok and same and st.acceptance == 1.0 and \
            st.tokens_per_timestep > 0.75
    ok = (ok and ex.calls["remap_rows"] > 0
          and launches_ok(launches, expect, PAGED_PATH))
    emit({"phase": "self-draft-db", "ok": ok, "arena": "paged",
          "quant": target.cfg.quant or "none", "slots": 2,
          "per_request": per,
          "timesteps": engine.db_stats.timesteps,
          "peak_occupancy": engine.db_stats.peak_occupancy,
          "executor_calls": dict(ex.calls), "calls": calls,
          "launches": launches, "expected_launches": expect,
          "wall_s": serve_s})
    if not ok:
        raise AssertionError("self-draft-db: lossless tokens, acceptance "
                             "1.0, tokens/timestep > 0.75, remap_rows > 0 "
                             "and launches as expected are required")


def phase_serve_db_int8(state):
    from repro_torch.core.pipedec import PipeDecConfig
    _db_phase("serve-db-int8", state, state["target_int8"],
              state["draft_int8"], _db_requests(state, DB_INT8_REQUESTS),
              state["autoregressive"]["serve-int8"], PAGED_INT8_PATH,
              DB_INT8_REQUESTS, PipeDecConfig(n_stages=8, width=8, branch=4),
              paged_only=True)


# ---------------------------------------------------------------------------
# phases serve-db-sharded, serve-db-overlap, self-draft-db-overlap,
# serve-db-async and self-draft-db-async: SpecPipe-DB on the 8-stage ring
# (launch/pipeline.py) and on its free-running stage actors
# ---------------------------------------------------------------------------
def read_ring_launches(ex, *bundles, paged=False):
    """``read_launches`` plus the stage applications of executor ``ex``
    (None: no executor): each layer the ring (or a stage actor) runs in
    tree mode launches the dense flash and tree kernels once, and each
    layer of its chunk prefill the dense flash kernel once, in their int8
    mode for an int8 target (the ring's caches are dense, or densified
    around it), and also in their head_dim 256 instance (counted in the
    ``hd256`` rows too) for a target whose head_dim is over 128 (Gemma);
    a cross sub-layer (Whisper) adds one flash launch a layer; an int8
    target's projections launch dequant_matmul 7 times a layer."""
    launches, expect = read_launches(*bundles, paged=paged)
    if ex is None:
        return launches, expect
    layers = ex.calls["stage_layers"]
    chunk_layers = ex.calls["prefill_layers"]
    cfg = ex.target.cfg
    int8 = cfg.quant == "int8"
    modes = [" int8" if int8 else ""]
    if cfg.resolved_head_dim > 128:
        modes.append(modes[0] + HD256)
    cross = layers if ex.target.cross_kv is not None else 0
    for mode in modes:
        expect["flash_attention_lse" + mode] += layers + chunk_layers + cross
        expect["tree_block_attention" + mode] += layers
    if int8:
        expect["dequant_matmul"] += PROJECTIONS * (layers + chunk_layers)
    return launches, expect


# the ring's path: the target's stage applications on the dense kernels;
# the draft's verify on the paged kernels over a paged arena
RING_PATHS = {False: FP32_PATH,
              True: FP32_PATH + ("paged_flash_attention_lse",
                                 "paged_tree_block_attention")}
RING_INT8_PATHS = {False: INT8_PATH,
                   True: INT8_PATH + ("paged_flash_attention_lse int8",
                                      "paged_tree_block_attention int8")}
# async: every blocking wait of the pipe (a failed actor raises within it)
ASYNC_TIMEOUT_S = 120.0


def _async_threads():
    import threading
    return [t.name for t in threading.enumerate()
            if t.name.startswith("async-")]


def _ring_run(kind, target, draft, requests, *, paged, slots, pcfg):
    """One SpecPipe-DB run on the stage ring through
    ServingEngine(mode="pipedec-db"): ``ShardedPipelineExecutor`` (flush),
    ``OverlappedShardedExecutor`` (its prefill lane: 64-token chunks, so
    the 64-128-token prompts stream in one or two) or
    ``AsyncPipelineExecutor`` (``async``: one actor thread and CUDA stream
    per stage and one for the draft; dense only, shut down after the run,
    twice); launch counts zeroed just before and read just after, exit
    logits recorded.  Returns (engine, results, executor, serve_s,
    peak_gb, launches, expect)."""
    import torch
    from repro_torch.serving import (AsyncPipelineExecutor,
                                     OverlappedShardedExecutor, Request,
                                     ServingEngine, ShardedPipelineExecutor)
    kw = dict(slots=slots, max_len=DB_MAX_LEN,
              tree_capacity=pcfg.tree_buffer_capacity,
              capacity=pcfg.capacity, n_stages=pcfg.n_stages)
    if kind == "async":
        ex = AsyncPipelineExecutor(target, draft, timeout_s=ASYNC_TIMEOUT_S,
                                   **kw)
    elif kind == "overlap":
        ex = OverlappedShardedExecutor(target, draft, paged=paged, page=PAGE,
                                       **kw)
    else:
        ex = ShardedPipelineExecutor(target, draft, paged=paged, page=PAGE,
                                     **kw)
    engine = ServingEngine(target, draft, mode="pipedec-db", max_batch=slots,
                           max_len=DB_MAX_LEN, pipedec=pcfg, executor=ex)
    for uid, prompt, new, arrival in requests:
        engine.submit(Request(uid, prompt, new, arrival_t=arrival))
    zero_launches(target, draft)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with exit_logits() as seen:
            t0 = time.perf_counter()
            results = engine.run()
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
    finally:
        if kind == "async":
            ex.shutdown()
            ex.shutdown()                       # idempotent
    for r in results.values():
        r.exit_logits = seen.get(id(r.stats), [])
    launches, expect = read_ring_launches(ex, target, draft, paged=paged)
    return (engine, results, ex, serve_s,
            torch.cuda.max_memory_allocated() / 1e9, launches, expect)


def _logit_diff(got, want):
    """Largest |difference| between two requests' exit logits (None when
    their counts differ: the token streams parted)."""
    if len(got) != len(want):
        return None
    return max((float((a - b).abs().max()) for a, b in zip(got, want)),
               default=0.0)


def _actors(ex):
    """The async executor's per-stage actor counters and draft lead."""
    c = ex.counters()
    return {"stages": [{k: s[k] for k in ("busy_s", "idle_s", "max_depth",
                                          "stale_rows")}
                       for s in c["stages"]],
            "max_draft_lead": c["max_draft_lead"],
            "pushed": c["pushed"], "consumed": c["consumed"]}


def _executor_ok(kind, ex, st, target, draft, n_requests):
    """The schedule's own checks over the run's ``DBStats`` ``st``: one
    flush per timestep with entries; one tick per timestep and every
    admission through the prefill lane, no separate prefill (overlapped),
    or with the lane off (a prefix or an encoder output) none in the ring
    and one separate prefill per admission; one entry message per
    timestep with entries, one stage step per entry per stage, a drained
    pipe, one separate prefill per admission and no actor thread left
    (async)."""
    if kind == "flush":
        return ex.calls["pipeline_verify"] == sum(
            st.verify_dispatches) == ex.calls["verify_rows"]
    ticks = (ex.calls["pipeline_tick"] == st.timesteps
             and st.tick_dispatches == [1] * st.timesteps)
    per_bundle = n_requests * (2 if target is draft else 1)
    apart = (st.separate_prefill_dispatches == n_requests
             and all(b.calls["prefill"] == per_bundle
                     for b in (target, draft)))
    if kind == "overlap":
        lane = (st.separate_prefill_dispatches == 0
                and not target.calls["prefill"]
                and not draft.calls["prefill"])
        if not ex.prefill_cap:
            lane = apart and ex.calls["prefill_in_ring"] == 0
        return ticks and ex.calls["drain_tick"] == 0 and lane
    return (ticks and ex.calls["entry_msgs"] == sum(st.verify_dispatches)
            and ex.calls["stage_steps"] == ex.calls["entry_msgs"]
            * ex.n_stages
            and ex._consumed == ex._pushed and apart
            and not _async_threads())


def _ring_phase(phase, kind, state, *, arenas=(False, True), quant=False,
                local=("serve-db", None), tol=None):
    """The serve-db requests (phase 3's prompts, 3 slots, arrivals 0, 0,
    3, 6, SERVE_NEW_TOKENS new tokens; with ``quant`` serve-db-int8's:
    the int8 pair, 2 requests on 2 slots) on the 8-stage ring of
    ``kind``, on each arena
    of ``arenas``: tokens against phase 3's autoregressive tokens
    (near-tie rule); tokens and per-request GenStats against the local
    run ``local`` (its phase, and its arena or None for the same one);
    the logits of every committed token against the local run's: equal
    bits for the flush, within ``tol`` (when given) otherwise, where only
    a near-tie may part the tokens; launch counts against the model calls
    and the stage applications; the schedule's own checks
    (``_executor_ok``).  The flush also equals the local run in counted
    dequant_matmul launches.  Prints wall ms and launches per timestep
    beside the local run's (and the async actors' counters).  Raises if a
    check fails."""
    from repro_torch.configs import pipedec_pair
    from repro_torch.core.pipedec import PipeDecConfig
    if quant:
        target, draft = state["target_int8"], state["draft_int8"]
        requests, slots = _db_requests(state, DB_INT8_REQUESTS), \
            DB_INT8_REQUESTS
        want = state["autoregressive"]["serve-int8"]
        paths = RING_INT8_PATHS
    else:
        target, draft = state["target"], state["draft"]
        requests, slots = _db_requests(state, SERVE_REQUESTS), DB_SLOTS
        want = state["autoregressive"]["serve"]
        paths = RING_PATHS
    pcfg = PipeDecConfig(n_stages=8, width=8, branch=4)
    ok = True
    for paged in arenas:
        lref = state["db_runs"][local[0],
                                paged if local[1] is None else local[1]]
        engine, res, ex, serve_s, peak_gb, launches, expect = _ring_run(
            kind, target, draft, requests, paged=paged, slots=slots,
            pcfg=pcfg)
        st = engine.db_stats
        good = (launches_ok(launches, expect, paths[paged])
                and _executor_ok(kind, ex, engine.db_stats, target, draft,
                                 len(requests)))
        if kind == "flush" and quant:
            good = good and st.timesteps == lref["timesteps"] and \
                launches["dequant_matmul"] == \
                lref["launches"]["dequant_matmul"]
        rows, worst = [], 0.0
        for uid, prompt, new, arrival in requests:
            r, lr = res[uid], lref["results"][uid]
            same, tie = _lossless(target, prompt, r.tokens, want[uid])
            as_local = bool((r.tokens == lr.tokens).all()) and all(
                getattr(r.stats, k) == getattr(lr.stats, k) for k in STATS)
            diff = _logit_diff(r.exit_logits, lr.exit_logits)
            good = good and same and (as_local or tie is not None)
            if kind == "flush":
                good = good and diff == 0.0
            elif tol is not None:
                good = good and (diff is not None and diff <= tol
                                 or tie is not None)
            worst = max(worst, diff or 0.0)
            rows.append({"uid": uid, "prompt_len": len(prompt),
                         "arrival_t": arrival, "latency_s": r.latency_s,
                         "acceptance": r.stats.acceptance,
                         "timesteps": r.stats.timesteps,
                         "lossless": same, "near_tie": tie,
                         "equals_local": as_local,
                         "max_logit_diff_vs_local": diff})
        ok = ok and good
        n = max(st.timesteps, 1)
        rings = state.setdefault("ring_runs", {})
        rings[phase, paged] = {"results": res,
                               "ms_per_timestep": 1e3 * serve_s / n}
        emit({"phase": phase, "ok": good, "mode": "pipedec-db",
              "executor": "async" if kind == "async" else "sharded",
              "overlap": kind == "overlap",
              "arena": "paged" if paged else "dense",
              "page": PAGE if paged else None,
              "quant": target.cfg.quant or "none",
              "target": target.cfg.name, "draft": draft.cfg.name,
              "reduced": {"target_layers": f"{target.cfg.num_layers} of "
                          f"{pipedec_pair.TARGET.num_layers}",
                          "draft_layers": f"{draft.cfg.num_layers} of "
                          f"{pipedec_pair.DRAFT.num_layers}"},
              "n_stages": pcfg.n_stages, "slots": slots,
              "max_len": DB_MAX_LEN,
              "prefill_cap": getattr(ex, "prefill_cap", None),
              "local_run": {"phase": local[0], "arena": "paged" if (
                  paged if local[1] is None else local[1]) else "dense"},
              "timesteps": st.timesteps,
              "local_timesteps": lref["timesteps"],
              "peak_occupancy": st.peak_occupancy,
              "tokens_per_timestep": st.tokens_per_timestep,
              "acceptance_rate": st.acceptance_rate,
              "serve_s": serve_s, "ms_per_timestep": 1e3 * serve_s / n,
              "local_ms_per_timestep": lref["ms_per_timestep"],
              "ring_ms_per_timestep": {
                  f"{ph} {'paged' if pg else 'dense'}": v["ms_per_timestep"]
                  for (ph, pg), v in rings.items() if ph != phase},
              "launches_per_timestep": sum(launches.values()) / n,
              "local_launches_per_timestep": lref["launches_per_timestep"],
              "dequant_matmul_per_timestep": launches["dequant_matmul"] / n,
              "local_dequant_matmul_per_timestep":
                  lref["launches"]["dequant_matmul"]
                  / max(lref["timesteps"], 1),
              "max_logit_diff_vs_local": worst, "logit_tol": tol,
              "ctrl_active_share": (ex.calls["ctrl_active_ticks"]
                                    / max(ex.calls["pipeline_tick"], 1)
                                    if kind == "overlap" else None),
              "actors": _actors(ex) if kind == "async" else None,
              "async_threads_after_shutdown": _async_threads(),
              "peak_mem_gb": peak_gb, "executor_calls": dict(ex.calls),
              "calls": {"target": dict(target.calls),
                        "draft": dict(draft.calls)},
              "launches": launches, "expected_launches": expect,
              "requests": rows})
    if not ok:
        raise AssertionError(f"{phase} phase failed: see its lines")


def phase_serve_db_sharded(state):
    _ring_phase("serve-db-sharded", "flush", state)


def phase_serve_db_overlap(state):
    _ring_phase("serve-db-overlap", "overlap", state)


def phase_serve_db_async(state):
    """serve-db's requests on the async executor (dense): tokens against
    phase 3's and serve-db-sharded's (near-tie rule), logits within 1e-4
    of serve-db's, the actors' checks; wall ms per timestep beside the
    flush's and the overlapped ring's."""
    _ring_phase("serve-db-async", "async", state, arenas=(False,),
                tol=TOL_ASYNC_LOGITS)
    sharded = state["ring_runs"]["serve-db-sharded", False]["results"]
    mine = state["ring_runs"]["serve-db-async", False]["results"]
    target = state["target"]
    ok = True
    for uid, prompt, _, _ in _db_requests(state, SERVE_REQUESTS):
        same, tie = _lossless(target, prompt, mine[uid].tokens,
                              sharded[uid].tokens)
        ok = ok and same
    emit({"phase": "serve-db-async", "check": "tokens against "
          "serve-db-sharded (near-tie rule)", "ok": ok})
    if not ok:
        raise AssertionError("serve-db-async: tokens part from "
                             "serve-db-sharded's")


def _self_draft_ring(phase, kind, paged, state):
    """The 8-layer target as its own draft on the 8-stage ring of
    ``kind``, 3 requests on 2 slots: every prediction hits, so the ctrl
    channel commits and compacts at every stage, and each retire kills.
    Per request: acceptance 1.0 and tokens equal to autoregressive
    decoding (near-tie rule); remap_rows, ctrl and stage ctrl
    applications > 0; the schedule's checks; launch counts against the
    model calls."""
    from repro_torch.core.baselines import generate_autoregressive
    from repro_torch.core.pipedec import PipeDecConfig
    import numpy as np
    target = state["target"]
    pcfg = PipeDecConfig(n_stages=8, width=8, branch=4)
    requests = [(uid, np.array(p), SELF_DRAFT_NEW_TOKENS, 0)
                for uid, p in enumerate(SELF_DRAFT_DB_PROMPTS)]
    engine, res, ex, serve_s, _, launches, expect = _ring_run(
        kind, target, target, requests, paged=paged, slots=2, pcfg=pcfg)
    calls = dict(target.calls)    # before the reference runs below
    schedule_ok = _executor_ok(kind, ex, engine.db_stats, target, target,
                               len(requests))
    st = engine.db_stats
    per, ok = {}, True
    for uid, prompt, new, _ in requests:
        g = res[uid].stats
        same, tie = _lossless(target, prompt, res[uid].tokens,
                              generate_autoregressive(target, prompt, new))
        per[uid] = {"acceptance": g.acceptance,
                    "tokens_per_timestep": g.tokens_per_timestep,
                    "lossless": same, "near_tie": tie}
        ok = ok and same and g.acceptance == 1.0
    ctrl = ex.calls["ctrl_active_ticks" if kind == "overlap"
                    else "ctrl_msgs"]
    ok = (ok and ex.calls["remap_rows"] > 0 and ctrl > 0
          and ex.calls["stage_ctrl"] > 0 and ex.calls["kill"] >= 3
          and schedule_ok and launches_ok(launches, expect,
                                          RING_PATHS[paged]))
    emit({"phase": phase, "ok": ok, "arena": "paged" if paged else "dense",
          "executor": "async" if kind == "async" else "sharded",
          "n_stages": pcfg.n_stages, "slots": 2, "per_request": per,
          "timesteps": st.timesteps, "peak_occupancy": st.peak_occupancy,
          "ms_per_timestep": 1e3 * serve_s / max(st.timesteps, 1),
          "ctrl_active_share": (ex.calls["ctrl_active_ticks"]
                                / max(ex.calls["pipeline_tick"], 1)
                                if kind == "overlap" else None),
          "actors": _actors(ex) if kind == "async" else None,
          "executor_calls": dict(ex.calls), "calls": calls,
          "launches": launches, "expected_launches": expect,
          "wall_s": serve_s})
    if not ok:
        raise AssertionError(f"{phase}: lossless tokens, acceptance 1.0, "
                             "ctrl commits and compacts, kills, the "
                             "schedule's checks and launches as expected "
                             "are required")


def phase_self_draft_db_overlap(state):
    _self_draft_ring("self-draft-db-overlap", "overlap", True, state)


def phase_self_draft_db_async(state):
    _self_draft_ring("self-draft-db-async", "async", False, state)


def phase_serve_db_int8_sharded(state):
    """serve-db-int8's requests on the int8 flush ring, dense and paged:
    tokens, GenStats and every committed token's logits equal to
    serve-db-int8's (the local executor on the paged arena: the paged
    kernels equal the dense ones bit for bit), and its counted
    dequant_matmul launches."""
    _ring_phase("serve-db-int8-sharded", "flush", state, quant=True,
                local=("serve-db-int8", True))


def phase_serve_db_int8_overlap(state):
    """serve-db-int8's requests on the int8 overlapped ring and the int8
    async executor (dense): tokens equal to serve-db-int8's (near-tie
    rule), logits within the int8 parity tolerance."""
    failed = []
    for phase, kind in (("serve-db-int8-overlap", "overlap"),
                        ("serve-db-int8-async", "async")):
        try:
            _ring_phase(phase, kind, state, arenas=(False,), quant=True,
                        local=("serve-db-int8", True), tol=TOL_INT8_RING)
        except AssertionError:
            failed.append(phase)
    if failed:
        raise AssertionError(f"{failed} failed: see their lines")


def phase_sharded_check(state):
    """The port's sharded_check at SHARDED_CHECK_STAGES stages in processes
    of its own: the
    overlapped, async and int8 legs, then the paged one; each must print
    SHARDED_CHECK ok."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    legs = (("--overlap", "--async", "--quant"),
            ("--overlap", "--paged", "--quant"))
    t0 = time.perf_counter()
    # the legs are host-bound (tiny models): both run at once
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.sharded_check",
         "--stages", str(SHARDED_CHECK_STAGES), *flags],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for flags in legs]
    ok = True
    for flags, proc in zip(legs, procs):
        try:
            out, err = proc.communicate(timeout=SHARDED_CHECK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        lines = out.strip().splitlines()
        status = lines[-1] if lines else ""
        good = proc.returncode == 0 and status.startswith(
            f"SHARDED_CHECK ok stages={SHARDED_CHECK_STAGES}")
        ok = ok and good
        emit({"phase": "sharded-check", "flags": " ".join(flags),
              "ok": good, "rc": proc.returncode, "status": status,
              "wall_s": time.perf_counter() - t0,
              "summary": json.loads(lines[-2]) if good else None,
              "stderr_tail": None if good else err[-3000:]})
    if not ok:
        raise AssertionError("sharded-check failed: see its lines")


# ---------------------------------------------------------------------------
# phases 7-10 and 13: the paper's baselines at full width, STPP and chain
# speculation
# ---------------------------------------------------------------------------
def _gen_stats(st):
    """A GenStats as a phase line prints it: STATS (commits_per_step as
    one string of digits) and the two rates derived from them."""
    row = {k: getattr(st, k) for k in STATS}
    row["commits_per_step"] = "".join(map(str, st.commits_per_step))
    return {**row, "acceptance": st.acceptance,
            "tokens_per_timestep": st.tokens_per_timestep}


def _calls(target, draft):
    tc = dict(target.calls)
    if draft is target:
        return {"target_as_draft": tc}
    return {"target": tc, "draft": dict(draft.calls)}


def _self_draft_requests(state, target):
    """The self-draft prompt and its autoregressive tokens (computed once),
    as (prompts, want) by uid."""
    import numpy as np
    from repro_torch.core.baselines import generate_autoregressive
    prompt = np.array([3, 3, 8])
    ar = state["autoregressive"]
    if "self-draft" not in ar:
        ar["self-draft"] = generate_autoregressive(target, prompt,
                                                   SELF_DRAFT_NEW_TOKENS)
    return [prompt], [ar["self-draft"]]


def _stpp_phase(phase, state, target, draft, prompts, want, new_tokens,
                path):
    """STPP (depth 4, width 8, branch 4), ``new_tokens`` for each of
    ``prompts``: tokens against ``want`` by uid (near-tie rule); launch
    counts against the model calls (a round is one target tree verify of
    the whole tree and ``depth`` draft tree verifies), with every kernel of
    ``path`` launched.  With the target as its own draft, the target's
    greedy child of the root is always among the draft's branch-4
    candidates, so every round but a request's last must accept a token,
    except at a near-tie of the target's top two logits.  Emits the phase
    line; raises if a check fails."""
    import torch
    from repro_torch.core.baselines import STPPConfig, STPPEngine
    self_draft = draft is target
    eng = STPPEngine(target, draft, STPPConfig(STPP_DEPTH, STPP_WIDTH,
                                               STPP_BRANCH), max_len=256)
    zero_launches(target, draft)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [eng.generate(p, new_tokens) for p in prompts]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, expect = read_launches(target, draft)
    tc, dc = target.calls.get("tree_verify"), draft.calls.get("tree_verify")
    rounds = sum(st.rounds for _, st in outs)
    steps = sum(st.draft_steps for _, st in outs)
    verifies = (tc == rounds + steps if self_draft
                else tc == rounds and dc == steps)
    ok = (launches_ok(launches, expect, path) and verifies
          and steps == STPP_DEPTH * rounds)
    rows = []
    for uid, (p, (out, st)) in enumerate(zip(prompts, outs)):
        same, tie = _lossless(target, p, out, want[uid])
        # round r's first token is out[pos], the target's choice after
        # prompt + out[:pos]
        empty, pos = [], 1
        for r, acc in enumerate(st.accepted_per_round[:-1]):
            if acc == 0:
                empty.append({"round": r, "position": pos,
                              "margin": _margin(target, list(p)
                                                + out.tolist()[:pos])})
            pos += acc + 1
        ok = ok and same and not (
            self_draft and any(e["margin"] >= NEAR_TIE for e in empty))
        rows.append({"uid": uid, "prompt_len": len(p), "rounds": st.rounds,
                     "mean_accepted": st.mean_accepted,
                     "accepted_per_round": st.accepted_per_round,
                     "rounds_accepting_none": empty,
                     "lossless": same, "near_tie": tie})
    accepted = sum(sum(st.accepted_per_round) for _, st in outs)
    tokens = len(prompts) * new_tokens
    state.setdefault("measured", {})[phase] = {
        "stpp_ms_per_token": 1e3 * wall_s / tokens,
        "mean_accepted": accepted / rounds}
    emit({"phase": phase, "ok": ok, "mode": "stpp",
          "quant": target.cfg.quant or "none",
          "target": target.cfg.name,
          "draft": "target" if self_draft else draft.cfg.name,
          "stpp": {"depth": STPP_DEPTH, "width": STPP_WIDTH,
                   "branch": STPP_BRANCH, "verify_queries": STPP_NODES,
                   "tree_rows": STPP_T},
          "new_tokens": new_tokens, "rounds": rounds,
          "mean_accepted": accepted / rounds, "wall_s": wall_s,
          "ms_per_round": 1e3 * wall_s / rounds,
          "ms_per_token": 1e3 * wall_s / tokens,
          "calls": _calls(target, draft), "launches": launches,
          "expected_launches": expect, "requests": rows})
    if not ok:
        raise AssertionError(f"{phase} phase failed: see its line")


def phase_stpp(state):
    _stpp_phase("stpp", state, state["target"], state["draft"],
                state["prompts"], state["autoregressive"]["serve"],
                SERVE_NEW_TOKENS, FP32_PATH)


def phase_self_draft_stpp(state):
    target = state["target"]
    _stpp_phase("self-draft-stpp", state, target, target,
                *_self_draft_requests(state, target), SELF_DRAFT_NEW_TOKENS,
                FP32_PATH)


def phase_stpp_int8(state):
    _stpp_phase("stpp-int8", state, state["target_int8"],
                state["draft_int8"], state["prompts"],
                state["autoregressive"]["serve-int8"], SERVE_NEW_TOKENS,
                INT8_PATH)


def _chain_phase(phase, state, target, draft, prompts, want, new_tokens):
    """ChainSpecEngine(n_stages=8), ``new_tokens`` for each of
    ``prompts``: tokens against ``want`` by uid (near-tie rule); one
    target and one draft decode per chain entry, so one flash launch per
    layer per decode and no tree kernel.  With the target as its own
    draft, the draft's decode is the target's, so no chain token may miss.
    Emits the phase line; raises if a check fails."""
    import torch
    from repro_torch.core.chain import ChainConfig, ChainSpecEngine
    self_draft = draft is target
    eng = ChainSpecEngine(target, draft, ChainConfig(n_stages=8),
                          max_len=256)
    zero_launches(target, draft)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [eng.generate(p, new_tokens) for p in prompts]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, expect = read_launches(target, draft)
    tc, dc = target.calls.get("decode"), draft.calls.get("decode")
    entries = sum(st.entries for _, st in outs)
    decodes = tc == 2 * entries if self_draft else tc == dc == entries
    ok = launches_ok(launches, expect, ("flash_attention_lse",)) and decodes
    rows = []
    for uid, (p, (out, st)) in enumerate(zip(prompts, outs)):
        same, tie = _lossless(target, p, out, want[uid])
        ok = ok and same and not (self_draft and st.misses)
        rows.append({"uid": uid, "prompt_len": len(p), **_gen_stats(st),
                     "lossless": same, "near_tie": tie})
    timesteps = sum(st.timesteps for _, st in outs)
    tokens = len(prompts) * new_tokens
    state.setdefault("measured", {})[phase] = {
        "chain_ms_per_token": 1e3 * wall_s / tokens}
    emit({"phase": phase, "ok": ok, "n_stages": 8,
          "target": target.cfg.name,
          "draft": "target" if self_draft else draft.cfg.name,
          "new_tokens": new_tokens, "timesteps": timesteps,
          "tokens_per_timestep": sum(st.commits for _, st in outs)
          / timesteps,
          "wall_s": wall_s, "ms_per_timestep": 1e3 * wall_s / timesteps,
          "ms_per_token": 1e3 * wall_s / tokens,
          "calls": _calls(target, draft), "launches": launches,
          "expected_launches": expect, "requests": rows})
    if not ok:
        raise AssertionError(f"{phase} phase failed: see its line")


def phase_chain(state):
    _chain_phase("chain", state, state["target"], state["draft"],
                 state["prompts"][:CHAIN_REQUESTS],
                 state["autoregressive"]["serve"], SERVE_NEW_TOKENS)


def phase_self_draft_chain(state):
    target = state["target"]
    _chain_phase("self-draft-chain", state, target, target,
                 *_self_draft_requests(state, target), SELF_DRAFT_NEW_TOKENS)


# ---------------------------------------------------------------------------
# phase 11: the cost model (core/sim.py) priced with this card's times
# ---------------------------------------------------------------------------
def _eager_ms(fn, warmup: int = 3, batches: int = 21, per_batch: int = 5):
    """Median CUDA-event time (ms) of one call of ``fn`` called from Python
    as the model calls it, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def batch():
        for _ in range(per_batch):
            fn()
    return _event_ms(batch, batches, per_batch)


def stage_calls(target, draft):
    """The calls the ``sim`` phase times, by name: one target decoder layer
    at M = 1 (a decode at position 200) and at a width-8 tree layer (a
    tree verify over 200 committed rows and a 105-row tree buffer), each
    called as ``transformer`` calls it (norms, attention through the
    kernels, MLP; no LM head); the draft's whole width-8 tree verify; a
    device-to-device copy of one width-8 fp32 activation (the stage
    hand-off).  Returns (calls, the activation's bytes)."""
    import torch
    from repro_torch.core.pipedec import PipeDecConfig
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import mlp

    cfg, dev = target.cfg, target.device
    w, past = 8, 200
    t_rows = PipeDecConfig(n_stages=8, width=w, branch=4).tree_buffer_capacity
    write_at = 1 + 3 * w                     # the tree's fourth layer
    gen = torch.Generator(device=dev).manual_seed(5)
    layer = target.model.layers[0]
    cache = attn.init_kv_cache(cfg, 1, DB_MAX_LEN, dev)
    tcache = attn.init_kv_cache(cfg, 1, t_rows, dev)
    x1 = torch.randn(1, 1, cfg.d_model, generator=gen, device=dev)
    xw = torch.randn(1, w, cfg.d_model, generator=gen, device=dev)
    position = torch.tensor([past], device=dev)
    kv_len = (position + 1).to(torch.int32)
    positions = torch.full((1, w), past + 3, device=dev)
    mlen = torch.tensor([past], dtype=torch.int32, device=dev)
    mask = torch.rand(1, w, t_rows, generator=gen, device=dev) < 0.3
    mask[:, :, 0] = True                     # the root

    def block(x, y):
        x = x + y
        return x + mlp(layer.ffn, layer.norm2(x))

    def layer_one():
        y, _ = attn.attn_decode(layer.mixer, cfg, layer.norm1(x1), position,
                                cache, [past], kv_len,
                                window=cfg.sliding_window)
        return block(x1, y)

    def layer_width():
        y, _ = attn.attn_tree_verify(
            layer.mixer, cfg, layer.norm1(xw), positions, model_cache=cache,
            model_len=mlen, tree_cache=tcache, tree_write_index=[write_at],
            tree_mask=mask, window=cfg.sliding_window)
        return block(xw, y)

    d_cache = draft.init_cache(1, DB_MAX_LEN)
    d_tree = draft.init_tree_caches(1, t_rows)
    tokens = torch.randint(0, cfg.vocab_size, (1, w), generator=gen,
                           device=dev)

    def draft_verify():
        return draft.tree_verify(tokens, positions, mask, d_cache, past,
                                 d_tree, write_at)
    act = torch.randn(1, w, cfg.d_model, generator=gen, device=dev)
    act_to = torch.empty_like(act)
    return ({"layer_one": layer_one, "layer_width": layer_width,
             "draft_tree_verify": draft_verify,
             "activation_copy": lambda: act_to.copy_(act)},
            act.numel() * act.element_size())


def empty_row_calls(target):
    """A target layer's tree-verify attention at ``serve-db``'s shapes (a
    bucket of ``DB_SLOTS`` rows over ``DB_MAX_LEN``-row caches, 200 and 37
    committed, and the width-8 tree buffer at its fourth layer), its last
    slot empty (``cache_len`` 0, an all-false mask, no pages), on the
    dense and on the paged arena, each with the empty row's select
    (``empty``: the reference's mean of V) and without it (the kernels'
    zero row), so that the select's cost a layer is the difference; and
    ``attention.empty_rows``, built once a verify for all layers."""
    import numpy as np
    import torch
    from repro_torch.core.pipedec import PipeDecConfig
    from repro_torch.models import attention as attn
    from repro_torch.models import paging

    cfg, dev = target.cfg, target.device
    b, w, past = DB_SLOTS, 8, 200
    t_rows = PipeDecConfig(n_stages=8, width=w, branch=4).tree_buffer_capacity
    gen = torch.Generator(device=dev).manual_seed(6)
    rng = np.random.default_rng(6)
    mixer = target.model.layers[0].mixer

    def filled(length):
        cache = attn.init_kv_cache(cfg, b, length, dev)
        for buf in cache.values():
            buf.normal_(generator=gen)
        return cache

    def paged(cache):
        length = next(iter(cache.values())).shape[1]
        mb = paging.n_blocks(length, PAGE)
        table = 1 + rng.permutation(b * mb).reshape(b, mb)
        table[-1] = 0                        # the empty slot holds no page
        return {name: paging.make_paged(buf, table, PAGE)
                for name, buf in cache.items()}

    dense = (filled(DB_MAX_LEN), filled(t_rows))
    arenas = {"dense": dense, "paged": tuple(paged(c) for c in dense)}
    x = torch.randn(b, w, cfg.d_model, generator=gen, device=dev)
    mlen = torch.tensor([past, 37, 0], dtype=torch.int32, device=dev)
    positions = (mlen.long() + 3)[:, None].expand(b, w)
    mask = torch.rand(b, w, t_rows, generator=gen, device=dev) < 0.3
    mask[:, :, 0] = True                     # the root
    mask[-1] = False                         # the empty slot's rows
    write_at = [1 + 3 * w] * b

    def build(caches):
        return lambda: attn.empty_rows([b - 1], mask, *caches, write_at)

    def call(caches, empty):
        return lambda: attn.attn_tree_verify(
            mixer, cfg, x, positions, model_cache=caches[0],
            model_len=mlen, tree_cache=caches[1], tree_write_index=write_at,
            tree_mask=mask, window=cfg.sliding_window, empty=empty)
    calls = {}
    for arena, caches in arenas.items():
        calls[f"{arena}_zero"] = call(caches, None)
        calls[f"{arena}_select"] = call(caches, build(caches)())
        calls[f"{arena}_build"] = build(caches)
    return calls


def _device_profile(fn, calls: int = 5, top: int = 0):
    """(busy ms, top device operations) of one call of ``fn``: the sum of
    the durations of the kernels and copies it runs on the card in a
    torch.profiler window of ``calls`` calls (after one call outside it),
    over ``calls``; and the ``top`` largest of them by name, as [name, ms
    per call, launches per call].  Beside an eager time the busy time says
    how far the host holds the card back."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name][0] += ev.time_range.elapsed_us() / 1e3 / calls
            by_name[ev.name][1] += 1 / calls
    busy = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return busy, [[name[:96], ms, n] for name, (ms, n) in ranked]


def _timed_exits(engine):
    """Time each of ``engine``'s exit steps (commit and prune, the
    timestep's sync): the card is drained before the step, so the time is
    the step's own, host and copies, until the card is done with it.
    Returns the list that the times (ms) go to."""
    import torch
    times, apply = [], engine.exit_apply

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        return out
    engine.exit_apply = timed
    return times


def _self_draft_pipedec(state, target):
    """PipeDec at the model's 8 stages (width 8, branch 4) with the target
    as its own draft, on the self-draft prompt: one timed run, then a
    second run of the same request whose exit steps are timed alone
    (``_timed_exits``; the draining would slow the timed run).  Returns
    (ms per token, tokens per timestep, exit-step times in ms); raises
    unless every prediction hits and the tokens are lossless."""
    import torch
    from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
    (prompt,), (want,) = _self_draft_requests(state, target)
    pcfg = PipeDecConfig(n_stages=8, width=8, branch=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, st = PipeDecEngine(target, target, pcfg).generate(
        prompt, SELF_DRAFT_NEW_TOKENS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    timed = PipeDecEngine(target, target, pcfg)
    exit_ms = _timed_exits(timed)
    out2, st2 = timed.generate(prompt, SELF_DRAFT_NEW_TOKENS)
    same, _ = _lossless(target, prompt, out, want)
    if not (same and st.acceptance == 1.0 and (out2 == out).all()
            and st2.timesteps == st.timesteps):
        raise AssertionError("sim: the 8-stage self-draft PipeDec runs must "
                             "hit every prediction, be lossless and agree")
    return (1e3 * wall_s / SELF_DRAFT_NEW_TOKENS, st.tokens_per_timestep,
            exit_ms)


def phase_sim(state):
    """Stage times measured on the card (``stage_calls``, CUDA events,
    medians after warm-up; the kernels' device busy time beside), from
    which ``sim.stage_hardware_from_roofline`` models LLaMA-70B's 80
    layers over 8 stages of 10, with ``t_sync`` the median exit step of an
    8-stage self-draft PipeDec run.  The modelled ms per token of PP, STPP
    and PipeDec are printed beside the single-card wall ms per token of
    the matching runs (8 target layers on one card): for PipeDec, phase
    serve (random draft) and the 8-stage self-draft run timed here, so
    that every input of the model comes from the 8 stages it prices."""
    import dataclasses
    import math
    import torch
    from repro_torch.core import sim

    target, draft = state["target"], state["draft"]
    measured = state["measured"]
    cfg = target.cfg
    sd_ms, sd_tpt, exit_ms = _self_draft_pipedec(state, target)
    measured["self-draft-pipedec-8"] = {"pipedec_ms_per_token": sd_ms,
                                        "tokens_per_timestep": sd_tpt}
    calls, act_bytes = stage_calls(target, draft)
    times = {name + "_ms": _eager_ms(fn) for name, fn in calls.items()}
    times["exit_step_ms"] = statistics.median(exit_ms)
    # the copy is a memcpy, not a kernel: the profiler window shows no
    # device time for it
    busy = {name + "_ms": _device_profile(fn)[0]
            for name, fn in calls.items() if name != "activation_copy"}
    hw = sim.stage_hardware_from_roofline(
        n_stages=8, layer_time_one=times["layer_one_ms"] / 1e3,
        layer_time_width=times["layer_width_ms"] / 1e3,
        layers_per_stage=10, bytes_per_activation=act_bytes,
        link_bw=act_bytes / (times["activation_copy_ms"] / 1e3),
        t_draft=times["draft_tree_verify_ms"] / 1e3,
        t_sync=times["exit_step_ms"] / 1e3)
    pp_ms = 1e3 * sim.pp_latency_per_token(hw)
    empty_calls = empty_row_calls(target)
    outs = {name: fn()[0] for name, fn in empty_calls.items()
            if not name.endswith("_build")}
    live_equal = all(torch.equal(outs[f"{a}_zero"][:-1],
                                 outs[f"{a}_select"][:-1])
                     for a in ("dense", "paged"))
    empty = {"eager_ms": {name: _eager_ms(fn)
                          for name, fn in empty_calls.items()},
             "device_busy_ms": {name: _device_profile(fn)[0]
                                for name, fn in empty_calls.items()}}
    modelled, beside = {}, {}
    for regime, dec, stpp, chain in (
            ("self-draft", "self-draft-pipedec-8", "self-draft-stpp",
             "self-draft-chain"),
            ("random-draft", "serve", "stpp", "chain")):
        tpt = measured[dec]["tokens_per_timestep"]
        acc = measured[stpp]["mean_accepted"]
        modelled[regime] = {
            "pp": pp_ms,
            "stpp": 1e3 * sim.stpp_latency_per_token(hw, STPP_DEPTH, acc),
            "pipedec": 1e3 * sim.pipedec_latency_per_token(hw, tpt),
            "inputs": {"tokens_per_timestep": tpt, "mean_accepted": acc}}
        beside[regime] = {
            "pp": measured["serve"]["pp_ms_per_token"],
            "stpp": measured[stpp]["stpp_ms_per_token"],
            "pipedec": measured[dec]["pipedec_ms_per_token"],
            "chain": measured[chain]["chain_ms_per_token"]}
    values = [v for m in modelled.values() for k, v in m.items()
              if k != "inputs"] + list(times.values()) + list(busy.values())
    values += [v for m in empty.values() for v in m.values()]
    ok = all(math.isfinite(v) and v > 0 for v in values) and live_equal
    emit({"phase": "sim", "ok": ok,
          "model": "core/sim.py priced with this card's layer times: "
                   "LLaMA-70B's 80 layers over 8 stages of 10, hand-off at "
                   "the card's device-to-device copy rate (a model, not a "
                   "measurement of a pipeline)",
          "stage_times": times, "device_busy": busy,
          "empty_row_select": dict(
              empty, live_rows_equal=live_equal,
              case=f"one target layer's tree-verify attention, "
                          f"bucket {DB_SLOTS} over {DB_MAX_LEN}-row caches, "
                          f"the last slot empty; with the F2 select and "
                          f"without (the kernels' zero row); _build: "
                          f"attention.empty_rows, once a verify"),
          "exit_step_ms": {"median": times["exit_step_ms"],
                           "min": min(exit_ms), "max": max(exit_ms),
                           "n": len(exit_ms)},
          "activation_bytes": act_bytes,
          "hardware": dataclasses.asdict(hw),
          "modelled_ms_per_token": modelled,
          "measured_ms_per_token_one_card": beside,
          "measured_is": f"wall ms per new token on one card "
                         f"({cfg.num_layers} target layers), all at 8 "
                         f"stages: PP, phase serve's autoregressive "
                         f"decoding; PipeDec, phase serve and the "
                         f"8-stage self-draft run timed here; STPP and "
                         f"chain, their phases"})
    if not ok:
        raise AssertionError("sim: every stage time, device busy time and "
                             "modelled value must be finite and positive, "
                             "and the F2 select must leave the live rows "
                             "as they are")


# ---------------------------------------------------------------------------
# phase 12: the int8 serving path at full width
# ---------------------------------------------------------------------------
def phase_serve_int8(state):
    """Quantize phase 3's fp32 target on the card and free its fp32
    projections, then quantize its draft the same way, so the fp32 pair
    never lives beside the int8 one (peak about 36 + 5 + 15 GB while the
    target is quantized)."""
    import gc
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fp32 = state.pop("target")
    target = fp32.quantize()
    del fp32
    fp32 = state.pop("draft")
    draft = fp32.quantize()
    del fp32
    gc.collect()
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    quantize_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    state["target_int8"], state["draft_int8"] = target, draft
    _serve("serve-int8", state, target, draft, INT8_PATH,
           {"quantize_s": quantize_s, "quantize_peak_mem_gb":
            quantize_peak_gb, "resident_gb":
            torch.cuda.memory_allocated() / 1e9})


def phase_self_draft_int8(state):
    _self_draft("self-draft-int8", state["target_int8"], INT8_PATH)


# ---------------------------------------------------------------------------
# phase 16: the CLI, and the card against the CPU on the same weights
# ---------------------------------------------------------------------------
CLI_RUNS = (  # (mode flags, --quant, the kernels that run on that path)
    (("--mode", "pp"), "none", ("flash_attention_lse",)),  # no tree in pp
    (("--mode", "pipedec"), "none", FP32_PATH),
    (("--mode", "pipedec-db", "--paged"), "none", PAGED_PATH),
    (("--mode", "pipedec-db", "--executor", "sharded"), "none", FP32_PATH),
    (("--mode", "pipedec-db", "--executor", "sharded", "--overlap"), "none",
     FP32_PATH),
    (("--mode", "pipedec-db", "--executor", "async"), "none", FP32_PATH),
    (("--mode", "pipedec-db", "--executor", "sharded"), "int8", INT8_PATH),
    (("--mode", "pipedec-db", "--executor", "sharded", "--overlap"), "int8",
     INT8_PATH),
    (("--mode", "pipedec-db", "--executor", "async"), "int8", INT8_PATH),
    (("--mode", "pp"), "int8", ("flash_attention_lse int8",
                                "dequant_matmul")),
    (("--mode", "pipedec"), "int8", INT8_PATH),
    (("--mode", "pipedec-db", "--paged"), "int8", PAGED_INT8_PATH),
    # the MoE and MLA families at their smoke sizes with the default draft
    (("--mode", "pipedec", "--target-arch", "qwen2-moe-a2.7b"), "none",
     FP32_PATH),
    (("--mode", "pipedec", "--target-arch", "deepseek-v2-236b"), "none",
     FP32_PATH),
)


def _card_vs_cpu(quant, tol, target_arch="pipedec-target"):
    """The smoke pair (``target_arch``'s smoke model as the target) with
    the same weights on the card and on the CPU (int8: each quantized on
    its own device): prefill logits within ``tol``, equal int8 weights,
    equal PipeDec tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, pipedec_pair
    from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
    from repro_torch.core.speculative import ModelBundle
    from repro_torch.models import transformer as tf

    pcfg = PipeDecConfig(n_stages=4, width=8, branch=4)
    pair = ((get_config(target_arch, smoke=True), 0),
            (pipedec_pair.DRAFT_SMOKE, 1))
    cpu = [ModelBundle(tf.init_model(c, seed=s, device="cpu"))
           for c, s in pair]
    gpu = [ModelBundle(tf.init_model(c, seed=s, device="cpu").to("cuda"))
           for c, s in pair]
    weights_equal = True
    if quant == "int8":
        cpu = [b.quantize() for b in cpu]
        gpu = [b.quantize() for b in gpu]
        weights_equal = all(
            torch.equal(wc.cpu(), wg.cpu()) for bc, bg in zip(cpu, gpu)
            for wc, wg in zip(bc.model.buffers(), bg.model.buffers()))
    prompt = np.random.default_rng(1).integers(0, 512, size=16)
    l_cpu, _ = cpu[0].prefill(prompt[None], cpu[0].init_cache(1, 32))
    l_gpu, _ = gpu[0].prefill(prompt[None], gpu[0].init_cache(1, 32))
    err = float((l_cpu - l_gpu.cpu()).abs().max())
    out_cpu, _ = PipeDecEngine(*cpu, pcfg).generate(prompt, 16)
    out_gpu, _ = PipeDecEngine(*gpu, pcfg).generate(prompt, 16)
    same = bool(np.array_equal(out_cpu, out_gpu))
    good = err <= tol and same and weights_equal
    emit({"phase": "cli", "check": "card vs CPU, smoke pair, same weights",
          "target": pair[0][0].name,
          "quant": quant, "ok": good, "prefill_logits_max_abs_err": err,
          "tol": tol, "int8_weights_equal": weights_equal,
          "pipedec_tokens_equal": same})
    return good


def phase_cli(state):
    import gc
    import torch
    from repro_torch.launch import serve

    for key in ("target", "draft", "target_int8", "draft_int8"):
        state.pop(key, None)
    gc.collect()
    torch.cuda.empty_cache()
    ok = True
    for flags, quant, used in CLI_RUNS:
        buf = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            engine, res = serve.main([*flags, "--requests", "3",
                                      "--new-tokens", "12", "--quant", quant])
        wall_s = time.perf_counter() - t0
        launches, expect = read_ring_launches(
            engine.executor, engine.target, engine.draft,
            paged="--paged" in flags)
        good = len(res) == 3 and all(
            len(r.tokens) == 13 and (r.tokens >= 0).all()
            and (r.tokens < engine.target.cfg.vocab_size).all()
            for r in res.values())
        good = good and launches_ok(launches, expect, used)
        ok = ok and good
        emit({"phase": "cli", "flags": " ".join(flags), "quant": quant,
              "ok": good,
              "wall_s": wall_s,
              "calls": {"target": dict(engine.target.calls),
                        "draft": dict(engine.draft.calls)
                        if engine.draft is not None else None},
              "launches": launches, "expected_launches": expect,
              "printed": buf.getvalue().strip().splitlines()})

    good = _card_vs_cpu("none", 1e-4)
    good = _card_vs_cpu("int8", TOL_INT8_CARD_CPU) and good
    for arch in ("qwen2-moe-a2.7b", "deepseek-v2-236b"):
        good = _card_vs_cpu("none", 1e-4, arch) and good
    if not (ok and good):
        raise AssertionError("cli phase failed: see its lines")


# ---------------------------------------------------------------------------
# phases family-*: the attention families at published widths
# ---------------------------------------------------------------------------
# (arch, target layers): Qwen 2.5 and 1.5 and Moonlight cut to 8 layers (a
# layer per stage, as phase 3's target), Gemma-7b whole, Qwen-MoE cut to
# 12 of its 24 (2 layers a stage on the ring, the last two stages
# padding; whole until the window and dryrun phases took the run's time,
# PERF.md section 4), and DeepSeek-V2 cut to its dense first layer and
# two MoE layers (15.9 GB each)
FAMILY_ARCHS = (("qwen2.5-32b", 8), ("qwen1.5-32b", 8), ("gemma-7b", 28),
                ("moonshot-v1-16b-a3b", 8), ("qwen2-moe-a2.7b", 12),
                ("deepseek-v2-236b", 3))
# the modality families: InternVL2-26B's language model cut to 8 of its 48
# layers (1.56 GB a layer in fp32; 48 would not fit the card), with a
# seeded 256-token vision prefix; Whisper-base whole (6 decoder layers, and
# 6 encoder layers over seeded [1, 1500, 512] frames)
FAMILY_MODAL_ARCHS = (("internvl2-26b", 8), ("whisper-base", 6))
FAMILY_PROMPT_LENS = (64, 128, 96)     # PipeDec takes the first two
# 8 new tokens a family run (8 PipeDec timesteps a token with the random
# draft): the whole script must stay well inside its 1200 s limit (16
# until the ring runs of family-db took it past 1000 s, PERF.md section 4)
FAMILY_NEW_TOKENS = 8
FAMILY_DB_ARCHS = ("gemma-7b", "moonshot-v1-16b-a3b", "deepseek-v2-236b",
                   "qwen2-moe-a2.7b", "internvl2-26b", "whisper-base")
FAMILY_DB_ARRIVALS = (0, 0, 3)
# 4 new tokens a family-db request (8 until the window and dryrun phases
# took the run's time; about 35 timesteps a run, past DB_WINDOW)
FAMILY_DB_NEW_TOKENS = 4
# the families on the 8-stage ring, one mechanism each: GeGLU at hd 256
# (4 layers a stage, the last stage all padding), QKV bias with MoE, the
# 256-row prefix with the prefill lane off, the cross sub-layer (2 stages
# all padding); each run is held to the family's local family-db run.
# The paged overlapped run is Gemma's alone and the async runs are
# InternVL2's and Whisper's alone: with all four runs a family the whole
# script took 1004 s of its 1200 s limit (PERF.md section 4)
FAMILY_RING_RUNS = {
    "gemma-7b": (("flush", False), ("overlap", False), ("overlap", True)),
    "qwen2-moe-a2.7b": (("flush", False), ("overlap", False)),
    "internvl2-26b": (("flush", False), ("overlap", False),
                      ("async", False)),
    "whisper-base": (("flush", False), ("overlap", False),
                     ("async", False))}
FAMILY_RING_ARCHS = tuple(FAMILY_RING_RUNS)
# the timesteps of a family-db dense run traced by torch.profiler (start,
# count): past the third arrival and the overlapped ring's joins
DB_WINDOW = (12, 5)
FAMILY_INT8_ARCHS = ("gemma-7b", "qwen2.5-32b")
FAMILY_INT8_NEW_TOKENS = 8
FAMILY_MAX_LEN = 256      # cache rows past a vision prefix
# the recurrent families whole at published width: Mamba-2 (24 SSD
# layers, no attention) and RecurrentGemma (26 RG-LRU and 12 local
# attention layers, about 37.6 GB in fp32), served by pp and chain
# speculation; RecurrentGemma's third prompt is past its 2048-key window
FAMILY_RECURRENT_ARCHS = (("mamba2-130m", 24), ("recurrentgemma-9b", 38))
RECURRENT_PROMPT_LENS = {"mamba2-130m": (64, 64),
                         "recurrentgemma-9b": (64, 64, RG_LONG_PROMPT)}
RECURRENT_MAX_LEN = {"mamba2-130m": 256, "recurrentgemma-9b": 2304}


def _family_cfgs(arch, *, dropless=False):
    """(target, draft) configs: the arch at published widths cut to its
    FAMILY_ARCHS depth (MoE at the published capacity factor, or at the
    dropless one, the number of experts), and the random draft: a 2-layer
    dense SwiGLU model (d 1024, 8 heads / 2 KV, d_ff 2816) with the
    target's vocabulary."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.config import ModelConfig
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=dict(
        FAMILY_ARCHS + FAMILY_MODAL_ARCHS + FAMILY_RECURRENT_ARCHS)[arch])
    if dropless and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    draft = ModelConfig(name="family-draft", family="dense", num_layers=2,
                        d_model=1024, num_heads=8, num_kv_heads=2,
                        d_ff=2816, vocab_size=cfg.vocab_size)
    return cfg, draft


def _family_bundles(arch, *, dropless=False, modal=None):
    """Seeded random target and draft on the card.  A VLM target carries
    a seeded vision prefix, an encoder-decoder target the encoder output
    of seeded frames (the draft neither, as in the reference); ``modal``
    (a dict) gets the encoder's eager ms per call, its flash launches per
    call and the modality input's shape."""
    from repro_torch.core.speculative import ModelBundle
    from repro_torch.models import encdec, frontends
    from repro_torch.models import transformer as tf
    cfg, dcfg = _family_cfgs(arch, dropless=dropless)
    model = tf.init_model(cfg, seed=0, device="cuda")
    kw, info = {}, {}
    if cfg.prefix_tokens:
        kw["prefix_embeds"] = frontends.stub_vision_prefix(cfg, 1, seed=2)
        info["prefix"] = list(kw["prefix_embeds"].shape)
    if cfg.is_encdec:
        frames = frontends.stub_audio_frames(cfg, 1, seed=2)
        zero_launches()
        kw["enc_out"] = encdec.encode(model.encoder, cfg, frames)
        launches, _ = read_launches()
        info.update(frames=list(frames.shape),
                    encoder_layers=cfg.encoder.num_layers,
                    encoder_flash_launches=launches["flash_attention_lse"],
                    encoder_ms=_eager_ms(lambda: encdec.encode(
                        model.encoder, cfg, frames), warmup=1, batches=5,
                        per_batch=2))
    if modal is not None:
        modal.update(info)
    return (ModelBundle(model, **kw),
            ModelBundle(tf.init_model(dcfg, seed=1, device="cuda")))


def _share_weights(bundle, cfg):
    """A bundle of ``cfg`` (the same shapes, another capacity factor)
    holding ``bundle``'s weights, not a copy."""
    from repro_torch.core.speculative import ModelBundle
    from repro_torch.models import transformer as tf
    model = tf.Transformer(cfg, "meta")
    model.load_state_dict(bundle.model.state_dict(), assign=True)
    return ModelBundle(model)


def _family_prompts(vocab):
    import numpy as np
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=n).astype(np.int64)
            for n in FAMILY_PROMPT_LENS]


def _family_path(cfg, int8=False):
    """The attention kernels a family's run must launch: the draft's
    (head_dim 128) always, and the head_dim 256 instances for Gemma."""
    path = INT8_PATH if int8 else FP32_PATH
    if cfg.resolved_head_dim > 128:
        path += tuple(p + HD256 for p in path if "attention" in p)
    return path


def _free(*names, state=None):
    import gc
    import torch
    if state is not None:
        for key in names:
            state.pop(key, None)
    gc.collect()
    torch.cuda.empty_cache()


def _family_max_len(cfg):
    """Cache rows of a family run: FAMILY_MAX_LEN past the vision prefix."""
    return FAMILY_MAX_LEN + cfg.prefix_tokens


def _autoregressive(target, prompts, new_tokens, max_len=None):
    """Autoregressive tokens of each prompt and the wall ms per token
    (``max_len`` cache rows, ``_family_max_len`` when None)."""
    import torch
    from repro_torch.core.baselines import generate_autoregressive
    t0 = time.perf_counter()
    want = [generate_autoregressive(
        target, p, new_tokens,
        max_len=max_len or _family_max_len(target.cfg)) for p in prompts]
    torch.cuda.synchronize()
    return want, 1e3 * (time.perf_counter() - t0) / (len(prompts)
                                                     * new_tokens)


def _family_pipedec(target, draft, prompts, want, new_tokens, path,
                    max_len=None):
    """PipeDec (8 stages, width 8, branch 4) through
    ServingEngine(mode="pipedec") on ``prompts``; tokens against ``want``
    (near-tie rule), launch counts against the calls.  Returns (ok, row)."""
    import torch
    from repro_torch.core.pipedec import PipeDecConfig
    from repro_torch.serving import Request, ServingEngine
    engine = ServingEngine(target, draft, mode="pipedec",
                           pipedec=PipeDecConfig(n_stages=8, width=8,
                                                 branch=4),
                           max_len=max_len or _family_max_len(target.cfg))
    for uid, p in enumerate(prompts):
        engine.submit(Request(uid, p, new_tokens))
    zero_launches(target, draft)
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, expect = read_launches(target, draft)
    ok = launches_ok(launches, expect, path)
    rows = []
    for uid, p in enumerate(prompts):
        res = results[uid]
        same, tie = _lossless(target, p, res.tokens, want[uid])
        ok = ok and same
        rows.append({"uid": uid, "prompt_len": len(p), "lossless": same,
                     "near_tie": tie, **_gen_stats(res.stats)})
    return ok, {"ms_per_token": 1e3 * wall_s / (len(prompts) * new_tokens),
                "wall_s": wall_s, "launches": launches,
                "expected_launches": expect,
                "calls": _calls(target, draft), "requests": rows}


def phase_family(arch):
    """A family at published widths (FAMILY_ARCHS depth, seeded random
    weights, fp32): PipeDec with the random draft on two prompts, lossless
    against autoregressive decoding (near-tie rule); the target as its own
    draft, acceptance 1.0; flash and tree launches layers x calls (0 for
    the MLA target, which attends in plain PyTorch; Gemma's through the
    head_dim 256 instances; Whisper's plus one flash launch a layer for
    the cross-attention of every call, and the encoder's, one a layer,
    counted apart); wall ms per token of both and of autoregressive
    decoding, the encoder's ms; peak memory.  InternVL2 and Whisper carry
    their seeded prefix or encoder output in the target bundle, and the
    committed length counts the prefix for the draft too (the
    reference's rule)."""
    def run(state):
        import torch
        from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
        _free("target", "draft", "target_int8", "draft_int8", state=state)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        modal = {}
        target, draft = _family_bundles(arch, modal=modal)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cfg = target.cfg
        path = _family_path(cfg)
        prompts = _family_prompts(cfg.vocab_size)[:2]
        want, ar_ms = _autoregressive(target, prompts, FAMILY_NEW_TOKENS)
        ok, rand = _family_pipedec(target, draft, prompts, want,
                                   FAMILY_NEW_TOKENS, path)
        if cfg.resolved_head_dim > 128:
            state["launches"].update({k: rand["launches"][k] for k in path
                                      if k.endswith(HD256)})
        # the target as its own draft: every prediction hits
        eng = PipeDecEngine(target, target, PipeDecConfig(n_stages=8,
                                                          width=8, branch=4),
                            max_len=_family_max_len(cfg))
        zero_launches(target)
        t0 = time.perf_counter()
        out, st = eng.generate(prompts[0], FAMILY_NEW_TOKENS)
        torch.cuda.synchronize()
        self_s = time.perf_counter() - t0
        launches, expect = read_launches(target)
        self_same, self_tie = _lossless(target, prompts[0], out, want[0])
        self_ok = (st.acceptance == 1.0 and self_same
                   and launches == expect)
        if modal.get("encoder_layers"):
            modal["encoder_ok"] = (modal["encoder_flash_launches"]
                                   == modal["encoder_layers"])
            self_ok = self_ok and modal["encoder_ok"]
        ok = ok and self_ok
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        emit({"phase": f"family-{arch}", "ok": ok, "target": cfg.name,
              "family": cfg.family, "draft": draft.cfg.name,
              "reduced": {"target_layers": f"{cfg.num_layers} of "
                          f"{_full_layers(arch)}"},
              "head_dim": cfg.resolved_head_dim,
              "attention": "plain PyTorch (MLA)" if cfg.mla is not None
              else "kernels" + (" (head_dim 256 instances)"
                                if cfg.resolved_head_dim > 128 else ""),
              "moe": None if cfg.moe is None else {
                  "experts": cfg.moe.num_experts,
                  "top_k": cfg.moe.experts_per_token,
                  "shared": cfg.moe.num_shared_experts,
                  "first_dense": cfg.moe.first_dense,
                  "capacity_factor": cfg.moe.capacity_factor},
              "modality": modal or None,
              "pipedec": {"n_stages": 8, "width": 8, "branch": 4},
              "new_tokens": FAMILY_NEW_TOKENS, "init_s": init_s,
              "autoregressive_ms_per_token": ar_ms,
              "random_draft": rand,
              "self_draft": {"ok": self_ok, "lossless": self_same,
                             "near_tie": self_tie, "wall_s": self_s,
                             "ms_per_token": 1e3 * self_s
                             / FAMILY_NEW_TOKENS, **_gen_stats(st),
                             "launches": launches,
                             "expected_launches": expect},
              "peak_mem_gb": peak_gb})
        del target, draft, eng
        _free()
        if not ok:
            raise AssertionError(f"family-{arch} failed: see its line")
    return run


def _sync_s(t0):
    import torch
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _recurrent_pp(target, prompts, want, new_tokens, max_len, path):
    """ServingEngine(mode="pp") over ``prompts`` in one batch: tokens
    against ``want`` (near-tie rule), launches against the calls."""
    from repro_torch.serving import Request, ServingEngine
    engine = ServingEngine(target, mode="pp", max_batch=len(prompts),
                           max_len=max_len)
    for uid, p in enumerate(prompts):
        engine.submit(Request(uid, p, new_tokens))
    zero_launches(target)
    t0 = time.perf_counter()
    results = engine.run()
    wall_s = _sync_s(t0)
    launches, expect = read_launches(target)
    ok = launches_ok(launches, expect, path)
    rows = []
    for uid, p in enumerate(prompts):
        same, tie = _lossless(target, p, results[uid].tokens, want[uid])
        ok = ok and same
        rows.append({"uid": uid, "prompt_len": len(p), "lossless": same,
                     "near_tie": tie})
    return ok, {"ok": ok, "batch": len(prompts), "wall_s": wall_s,
                "ms_per_token": 1e3 * wall_s / new_tokens,
                "launches": launches, "expected_launches": expect,
                "calls": dict(target.calls), "requests": rows}


def _recurrent_chain(target, draft, prompts, want, new_tokens, max_len,
                     path):
    """ChainSpecEngine (8 stages) over ``prompts``: tokens against
    ``want`` (near-tie rule), launches against the calls; with the target
    as its own draft, acceptance 1.0 and no miss.  Reports the recurrent
    snapshot copies (leaves copied) per timestep."""
    from repro_torch.core.chain import ChainConfig, ChainSpecEngine
    eng = ChainSpecEngine(target, draft, ChainConfig(n_stages=8),
                          max_len=max_len)
    zero_launches(target, draft)
    t0 = time.perf_counter()
    outs = [eng.generate(p, new_tokens) for p in prompts]
    wall_s = _sync_s(t0)
    launches, expect = read_launches(target, draft)
    ok = launches_ok(launches, expect, path)
    rows = []
    for uid, (p, (out, st)) in enumerate(zip(prompts, outs)):
        same, tie = _lossless(target, p, out, want[uid])
        ok = ok and same
        if draft is target:
            ok = ok and st.acceptance == 1.0 and st.misses == 0
        rows.append({"uid": uid, "prompt_len": len(p), **_gen_stats(st),
                     "lossless": same, "near_tie": tie})
    timesteps = sum(st.timesteps for _, st in outs)
    return ok, {"ok": ok, "n_stages": 8, "wall_s": wall_s,
                "ms_per_token": 1e3 * wall_s / (len(prompts) * new_tokens),
                "ms_per_timestep": 1e3 * wall_s / timesteps,
                "timesteps": timesteps,
                "hits": sum(st.hits for _, st in outs),
                "misses": sum(st.misses for _, st in outs),
                "snapshot_copies": eng.snapshot_copies,
                "snapshot_copies_per_timestep":
                    eng.snapshot_copies / timesteps,
                "launches": launches, "expected_launches": expect,
                "calls": _calls(target, draft), "requests": rows}


def phase_recurrent(arch):
    """A recurrent family whole at published width (seeded random weights,
    fp32) with the families' random 2-layer draft: autoregressive decoding
    of each prompt (the reference); ``ServingEngine(mode="pp")`` over the
    two 64-token prompts in one batch; chain speculation (8 stages) with
    the random draft on the first prompt and the last (RecurrentGemma's
    2112-token one, past its window) and with the target as its own draft
    (acceptance 1.0, no miss), all lossless (near-tie rule); the tree
    modes' refusal (``ServingEngine(mode="pipedec")`` raises naming
    chain-mode); launches against the calls (Mamba-2's target none,
    RecurrentGemma's the head_dim 256 flash instance with its window once
    per local layer per call); ms per token, the long prompt's prefill
    ms, snapshot copies per timestep and peak memory."""
    def run(state):
        import numpy as np
        import torch
        from repro_torch.core.baselines import generate_autoregressive
        from repro_torch.models import transformer as tf
        from repro_torch.serving import ServingEngine
        _free("target", "draft", "target_int8", "draft_int8", state=state)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        target, draft = _family_bundles(arch)
        init_s = _sync_s(t0)
        cfg = target.cfg
        max_len = RECURRENT_MAX_LEN[arch]
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int64)
                   for n in RECURRENT_PROMPT_LENS[arch]]
        new = FAMILY_NEW_TOKENS
        t0 = time.perf_counter()
        want = [generate_autoregressive(target, p, new, max_len=max_len)
                for p in prompts]
        ar_ms = 1e3 * _sync_s(t0) / (len(prompts) * new)
        n_attn, n_win = _attention_layers(cfg)
        t_path = (("flash_attention_lse", "flash_attention_lse" + HD256,
                   "flash_attention_lse" + HD256_WINDOW) if n_attn else ())
        pp_ok, pp = _recurrent_pp(target, prompts[:2], want[:2], new,
                                  max_len, t_path)
        chain_prompts = [prompts[0], prompts[-1]]
        chain_want = [want[0], want[-1]]
        ch_ok, chain = _recurrent_chain(
            target, draft, chain_prompts, chain_want, new, max_len,
            tuple(dict.fromkeys(("flash_attention_lse",) + t_path)))
        hd256 = chain["launches"]["flash_attention_lse" + HD256]
        tc = chain["calls"]["target"]
        target_calls = tc.get("prefill", 0) + tc.get("decode", 0)
        launch_rule = hd256 == n_attn * target_calls
        self_ok, self_chain = _recurrent_chain(
            target, target, prompts[:1], want[:1], new, max_len, t_path)
        try:
            ServingEngine(target, draft, mode="pipedec", max_len=max_len)
            refusal = None
        except NotImplementedError as exc:
            refusal = str(exc)
        refusal_ok = refusal is not None and "chain-mode" in refusal
        long_ms = None
        if cfg.rglru is not None and len(prompts[-1]) > cfg.rglru.window:
            long = prompts[-1][None]
            cache = target.init_cache(1, max_len)
            long_ms = _eager_ms(lambda: target.prefill(long, cache),
                                warmup=1, batches=3, per_batch=1)
        for k in ("flash_attention_lse" + HD256,
                  "flash_attention_lse" + HD256_WINDOW):
            state["launches"][k] = (state["launches"].get(k, 0)
                                    + chain["launches"][k])
        ok = pp_ok and ch_ok and self_ok and refusal_ok and launch_rule
        emit({"phase": f"family-{arch}", "ok": ok, "target": cfg.name,
              "family": cfg.family, "draft": draft.cfg.name,
              "layers": {"total": cfg.num_layers,
                         "kinds": dict(collections.Counter(
                             tf.layer_kinds(cfg))),
                         "attention": n_attn, "windowed": n_win},
              "reduced": {}, "d_model": cfg.d_model,
              "head_dim": cfg.resolved_head_dim if n_attn else None,
              "window": cfg.rglru.window if cfg.rglru else None,
              "prompt_lens": [len(p) for p in prompts],
              "new_tokens": new, "max_len": max_len, "init_s": init_s,
              "params_gb": sum(p.numel() for p in target.model.parameters())
              * 4 / 1e9,
              "autoregressive_ms_per_token": ar_ms,
              "long_prompt_prefill_ms": long_ms,
              "pp": pp, "random_chain": chain, "self_chain": self_chain,
              "hd256_launches_rule": {
                  "ok": launch_rule, "hd256": hd256,
                  "attention_layers": n_attn,
                  "target_prefill_and_decode_calls": target_calls},
              "pipedec_refusal": {"ok": refusal_ok, "message": refusal},
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        del target, draft
        _free()
        if not ok:
            raise AssertionError(f"family-{arch} failed: see its line")
    return run


def _full_layers(arch):
    from repro_torch.configs import get_config
    return get_config(arch).num_layers


def _device_window(steps, n):
    """Run the next ``n`` timesteps of the generator ``steps`` under
    torch.profiler (CUDA activity), the card synchronized at both ends.
    Returns {"steps", "wall_ms" (per timestep, profiled), "busy_ms" (the
    union of the card's kernel and copy intervals per timestep, every
    stream together), "kernel_ms" (their sum), "device_ops" (per
    timestep), "idle_share" (1 - busy / profiled wall)}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    end, k = object(), 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while k < n and next(steps, end) is not end:
            k += 1
        wall_ms = 1e3 * _sync_s(t0)
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    busy, last = 0, None
    for a, b in spans:
        if last is not None and a < last:
            busy += max(b - last, 0)
            last = max(last, b)
        else:
            busy += b - a
            last = b
    per = max(k, 1)
    return {"steps": k, "wall_ms": wall_ms / per,
            "busy_ms": busy / 1e3 / per,
            "kernel_ms": sum(b - a for a, b in spans) / 1e3 / per,
            "device_ops": len(spans) / per,
            "idle_share": 1.0 - busy / 1e3 / wall_ms if wall_ms else None}


def _family_db_drive(kind, target, draft, requests, *, paged, pcfg,
                     window=None, max_len=DB_MAX_LEN):
    """One SpecPipe-DB run of the family-db requests (DB_SLOTS slots) on
    the local executor (``kind`` "local") or the 8-stage ring's flush,
    overlapped or async executor, driven timestep by timestep through
    ``SpecPipeDBEngine.steps`` (what ``ServingEngine.run`` runs); launch
    counts zeroed just before and read just after, exit logits recorded;
    ``max_len`` cache rows a slot.
    ``window`` (start, count): those timesteps run under the profiler
    (``_device_window``) and the others are timed on the host clock, so
    ``ms_per_timestep`` leaves the traced ones out.  Returns a dict."""
    import torch
    from repro_torch.serving import (AsyncPipelineExecutor,
                                     LocalFusedExecutor,
                                     OverlappedShardedExecutor, Request,
                                     ShardedPipelineExecutor,
                                     SpecPipeDBEngine)
    kw = dict(slots=DB_SLOTS, max_len=max_len,
              tree_capacity=pcfg.tree_buffer_capacity,
              capacity=pcfg.capacity)
    if kind == "local":
        ex = LocalFusedExecutor(target, draft, paged=paged, page=PAGE, **kw)
    elif kind == "async":
        ex = AsyncPipelineExecutor(target, draft, n_stages=pcfg.n_stages,
                                   timeout_s=ASYNC_TIMEOUT_S, **kw)
    else:
        cls = (OverlappedShardedExecutor if kind == "overlap"
               else ShardedPipelineExecutor)
        ex = cls(target, draft, n_stages=pcfg.n_stages, paged=paged,
                 page=PAGE, **kw)
    db = SpecPipeDBEngine(target, draft, pcfg, max_len=max_len,
                          max_slots=DB_SLOTS, executor=ex)
    for uid, prompt, new, arrival in requests:
        db.submit(Request(uid, prompt, new, arrival_t=arrival))
    start, count = window or (-1, 0)
    zero_launches(target, draft)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed_s, timed, dev, end = 0.0, 0, None, object()
    t_run = time.perf_counter()
    try:
        with exit_logits() as seen:
            steps = db.steps()
            t0 = time.perf_counter()
            while True:
                if timed == start and dev is None:
                    timed_s += _sync_s(t0)
                    dev = _device_window(steps, count)
                    t0 = time.perf_counter()
                    if dev["steps"] < count:
                        break
                    continue
                if next(steps, end) is end:
                    break
                timed += 1
            timed_s += _sync_s(t0)
    finally:
        if kind == "async":
            ex.shutdown()
    run_s = time.perf_counter() - t_run
    results = db.results
    for r in results.values():
        r.exit_logits = seen.get(id(r.stats), [])
    launches, expect = read_ring_launches(
        None if kind == "local" else ex, target, draft, paged=paged)
    st = db.stats
    return {"kind": kind, "paged": paged, "ex": ex, "stats": st,
            "results": results, "run_s": run_s,
            "ms_per_timestep": 1e3 * timed_s / max(timed, 1),
            "timed_timesteps": timed, "device": dev,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "expected_launches": expect,
            "launches_per_timestep": sum(launches.values())
            / max(st.timesteps, 1)}


def _ring_vs(run, ref, target, requests, *, bits):
    """Per request of ``run`` against the run ``ref``: tokens (the
    near-tie rule), GenStats, and the largest exit-logit difference;
    ``bits`` asks for equal tokens, stats and logits.  Returns (ok,
    rows)."""
    ok, rows = True, []
    for uid, prompt, _, _ in requests:
        r, lr = run["results"][uid], ref["results"][uid]
        same, tie = _lossless(target, prompt, r.tokens, lr.tokens)
        as_ref = bool((r.tokens == lr.tokens).all()) and all(
            getattr(r.stats, k) == getattr(lr.stats, k) for k in STATS)
        diff = _logit_diff(r.exit_logits, lr.exit_logits)
        if bits:
            good = as_ref and diff == 0.0
        else:
            good = same and (as_ref or tie is not None) and (
                tie is not None or diff is not None
                and diff <= TOL_ASYNC_LOGITS)
        ok = ok and good
        rows.append({"uid": uid, "ok": good, "equals": as_ref,
                     "near_tie": tie, "max_logit_diff": diff})
    return ok, rows


def _family_ring(state, arch, target, draft, requests, want, local, pcfg):
    """The family's requests on the 8-stage ring (its FAMILY_RING_RUNS): the
    flush equal to the local dense run bit for bit (tokens, GenStats,
    exit logits); the overlapped and async runs equal to it in tokens but
    at a near-tie, logits within TOL_ASYNC_LOGITS; the paged overlapped
    run equal to the dense one bit for bit; every run lossless against
    autoregressive decoding, launches as the calls and stage applications
    imply (``read_ring_launches``), the schedule's own checks
    (``_executor_ok``; a prefix or an encoder output turns the overlapped
    ring's lane off).  Prints each run's wall ms per timestep beside the
    local run's, the card's busy ms and idle share in the traced window,
    launches per timestep, stage applications and kills, peak memory and
    seconds.  Returns whether every run passed."""
    cfg = target.cfg
    ok, runs = True, {}
    for kind, paged in FAMILY_RING_RUNS[arch]:
        run = _family_db_drive(kind, target, draft, requests, paged=paged,
                               pcfg=pcfg, window=None if paged else DB_WINDOW)
        runs[kind, paged] = run
        ex, st = run["ex"], run["stats"]
        path = _family_path(cfg)
        if paged:
            path += ("paged_flash_attention_lse",
                     "paged_tree_block_attention")
        good = (launches_ok(run["launches"], run["expected_launches"], path)
                and _executor_ok(kind, ex, st, target, draft,
                                 len(requests)))
        for uid, p, _, _ in requests:
            same, _tie = _lossless(target, p, run["results"][uid].tokens,
                                   want[uid])
            good = good and same
        vs_local, rows = _ring_vs(run, local, target, requests,
                                  bits=kind == "flush")
        good = good and vs_local
        vs_dense = None
        if paged:
            vs_dense, _ = _ring_vs(run, runs[kind, False], target,
                                   requests, bits=True)
            good = good and vs_dense
        ok = ok and good
        for k in run["launches"]:
            if k.endswith(HD256) and run["launches"][k]:
                state["launches"][k] = (state["launches"].get(k, 0)
                                        + run["launches"][k])
        n = max(st.timesteps, 1)
        emit({"phase": "family-db", "ring": kind, "ok": good,
              "executor": "async" if kind == "async" else "sharded",
              "overlap": kind == "overlap",
              "arena": "paged" if paged else "dense",
              "target": cfg.name, "draft": draft.cfg.name,
              "reduced": {"target_layers": f"{cfg.num_layers} of "
                          f"{_full_layers(arch)}"},
              "n_stages": pcfg.n_stages,
              "layers_per_stage": -(-cfg.num_layers // pcfg.n_stages),
              "slots": DB_SLOTS,
              "prefill_cap": getattr(ex, "prefill_cap", None),
              "modality": ("prefix" if target.prefix_embeds is not None
                           else "encoder output"
                           if target.enc_out is not None else None),
              "timesteps": st.timesteps,
              "local_timesteps": local["stats"].timesteps,
              "ms_per_timestep": run["ms_per_timestep"],
              "local_ms_per_timestep": local["ms_per_timestep"],
              "device": run["device"], "local_device": local["device"],
              "launches_per_timestep": run["launches_per_timestep"],
              "local_launches_per_timestep":
                  local["launches_per_timestep"],
              "stage_applications": ex.calls["stage_apply"]
              or ex.calls["stage_steps"],
              "stage_layers": ex.calls["stage_layers"],
              "stage_applications_per_timestep":
                  (ex.calls["stage_apply"] or ex.calls["stage_steps"]) / n,
              "kills": ex.calls["kill"],
              "actors": _actors(ex) if kind == "async" else None,
              "paged_equals_dense": vs_dense,
              "vs_local": rows, "peak_mem_gb": run["peak_gb"],
              "run_s": run["run_s"], "executor_calls": dict(ex.calls),
              "launches": run["launches"],
              "expected_launches": run["expected_launches"]})
        run.pop("ex")
    return ok


def phase_family_db(state):
    """SpecPipe-DB (3 slots, arrivals 0, 0, 3, the local executor) for
    Gemma-7b, Moonlight, DeepSeek-V2, Qwen-MoE, InternVL2 (its vision
    prefix serving every slot) and Whisper (its encoder output
    cross-attended by every row of a bucket) at their family-phase depths,
    dense and paged arenas: paged equals dense bit for bit (tokens,
    GenStats), tokens equal autoregressive decoding, launches as the calls
    imply.  MoE runs at dropless capacity here (a batched verify routes up
    to 24 tokens together, which the published capacity may drop, in the
    reference too); for Moonlight and DeepSeek a further dense run at the
    published capacity factor reports whether its tokens still equal
    autoregressive decoding at that factor (Qwen-MoE's time goes to its
    ring runs).  Then FAMILY_RING_ARCHS on the 8-stage ring
    (``_family_ring``), held to the family's local dense run, whose
    DB_WINDOW timesteps are traced for the card's busy time."""
    import torch
    from repro_torch.core.pipedec import PipeDecConfig
    pcfg = PipeDecConfig(n_stages=8, width=8, branch=4)
    ok = True
    for arch in FAMILY_DB_ARCHS:
        t_arch = time.perf_counter()
        _free()
        torch.cuda.reset_peak_memory_stats()
        target, draft = _family_bundles(arch, dropless=True)
        cfg = target.cfg
        prompts = _family_prompts(cfg.vocab_size)
        want, _ = _autoregressive(target, prompts, FAMILY_DB_NEW_TOKENS)
        requests = [(uid, p, FAMILY_DB_NEW_TOKENS, FAMILY_DB_ARRIVALS[uid])
                    for uid, p in enumerate(prompts)]
        ring = arch in FAMILY_RING_ARCHS
        runs = {}
        for paged in (False, True):
            run = _family_db_drive(
                "local", target, draft, requests, paged=paged, pcfg=pcfg,
                window=DB_WINDOW if ring and not paged else None)
            res, ex = run["results"], run["ex"]
            launches, expect = run["launches"], run["expected_launches"]
            path = _family_path(cfg)
            if paged:
                path = ("flash_attention_lse", "paged_flash_attention_lse",
                        "paged_tree_block_attention")
                if cfg.resolved_head_dim > 128:
                    path += tuple(p + HD256 for p in path)
                    state["launches"].update(
                        {k: launches[k] for k in path
                         if k.startswith("paged_") and k.endswith(HD256)})
            good = launches_ok(launches, expect, path)
            rows = []
            for uid, p, _, arrival in requests:
                same, tie = _lossless(target, p, res[uid].tokens, want[uid])
                good = good and same
                rows.append({"uid": uid, "prompt_len": len(p),
                             "arrival_t": arrival, "lossless": same,
                             "near_tie": tie, **_gen_stats(res[uid].stats)})
            runs[paged] = run
            same_run = None
            if paged:
                same_run = all(
                    (runs[True]["results"][u].tokens
                     == runs[False]["results"][u].tokens).all()
                    and all(getattr(runs[True]["results"][u].stats, k)
                            == getattr(runs[False]["results"][u].stats, k)
                            for k in STATS) for u in res)
                good = good and same_run
            ok = ok and good
            st = run["stats"]
            emit({"phase": "family-db", "ok": good, "target": cfg.name,
                  "draft": draft.cfg.name,
                  "reduced": {"target_layers": f"{cfg.num_layers} of "
                              f"{_full_layers(arch)}"},
                  "arena": "paged" if paged else "dense",
                  "capacity_factor": (cfg.moe.capacity_factor
                                      if cfg.moe is not None else None),
                  "modality": ("prefix" if target.prefix_embeds is not None
                               else "encoder output"
                               if target.enc_out is not None else None),
                  "slots": DB_SLOTS, "paged_equals_dense": same_run,
                  "timesteps": st.timesteps,
                  "tokens_per_timestep": st.tokens_per_timestep,
                  "ms_per_timestep": run["ms_per_timestep"],
                  "device": run["device"],
                  "launches_per_timestep": run["launches_per_timestep"],
                  "peak_mem_gb": run["peak_gb"],
                  "executor_calls": dict(ex.calls),
                  "launches": launches, "expected_launches": expect,
                  "requests": rows})
            run.pop("ex")
            del ex
        if cfg.moe is not None and not ring:
            # the published capacity factor: a report, not a check
            pub_cfg, _ = _family_cfgs(arch)
            pub = _share_weights(target, pub_cfg)
            pub_want, _ = _autoregressive(pub, prompts, FAMILY_DB_NEW_TOKENS)
            _, res, _, _, _, _, _ = _db_run(pub, draft, requests,
                                            paged=False, slots=DB_SLOTS,
                                            pcfg=pcfg)
            emit({"phase": "family-db", "report": "published capacity",
                  "target": cfg.name,
                  "capacity_factor": pub_cfg.moe.capacity_factor,
                  "tokens_equal_autoregressive": {
                      uid: bool((res[uid].tokens == pub_want[uid]).all())
                      for uid in res}})
            del pub
        if ring:
            ok = _family_ring(state, arch, target, draft, requests, want,
                              runs[False], pcfg) and ok
        emit({"phase": "family-db", "target": cfg.name,
              "arch_s": time.perf_counter() - t_arch})
        del target, draft, runs
    _free()
    if not ok:
        raise AssertionError("family-db failed: see its lines")


def phase_family_int8(state):
    """Gemma-7b (whole) and Qwen 2.5 (8 layers) after ``quantize()`` of
    target and draft on the card: PipeDec with the random draft, lossless
    against int8 autoregressive decoding; dequant_matmul launches 7 x
    layers x calls; Gemma's int8 attention through the head_dim 256 int8
    instances, and, on a paged SpecPipe-DB arena (the two prompts at
    once), through the paged ones."""
    import torch
    from repro_torch.core.pipedec import PipeDecConfig
    ok = True
    for arch in FAMILY_INT8_ARCHS:
        _free()
        torch.cuda.reset_peak_memory_stats()
        target, draft = _family_bundles(arch)
        t0 = time.perf_counter()
        target, draft = target.quantize(), draft.quantize()
        _free()
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        cfg = target.cfg
        path = _family_path(cfg, int8=True)
        prompts = _family_prompts(cfg.vocab_size)[:2]
        want, ar_ms = _autoregressive(target, prompts,
                                      FAMILY_INT8_NEW_TOKENS)
        good, rand = _family_pipedec(target, draft, prompts, want,
                                     FAMILY_INT8_NEW_TOKENS, path)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        db = None
        if cfg.resolved_head_dim > 128:
            state["launches"].update({k: rand["launches"][k] for k in path
                                      if k.endswith(HD256)})
            requests = [(uid, p, FAMILY_INT8_NEW_TOKENS, 0)
                        for uid, p in enumerate(prompts)]
            _, res, _, serve_s, _, launches, expect = _db_run(
                target, draft, requests, paged=True, slots=DB_SLOTS,
                pcfg=PipeDecConfig(n_stages=8, width=8, branch=4))
            paged_path = tuple(p + HD256 for p in PAGED_INT8_PATH
                               if "attention" in p)
            db_ok = launches_ok(launches, expect,
                                PAGED_INT8_PATH + paged_path)
            for uid, p, _, _ in requests:
                db_ok = db_ok and _lossless(target, p, res[uid].tokens,
                                            want[uid])[0]
            state["launches"].update({k: launches[k] for k in paged_path
                                      if k.startswith("paged_")})
            good = good and db_ok
            db = {"ok": db_ok, "arena": "paged", "serve_s": serve_s,
                  "launches": launches, "expected_launches": expect}
        ok = ok and good
        emit({"phase": "family-int8", "ok": good, "target": cfg.name,
              "quant": "int8", "draft": draft.cfg.name,
              "reduced": {"target_layers": f"{cfg.num_layers} of "
                          f"{_full_layers(arch)}"},
              "quantize_s": quantize_s,
              "autoregressive_ms_per_token": ar_ms, "random_draft": rand,
              "db_paged": db, "peak_mem_gb": peak_gb})
        del target, draft
    _free()
    if not ok:
        raise AssertionError("family-int8 failed: see its lines")


# ---------------------------------------------------------------------------
# phases window and dryrun: long_500k's window override, the dry run
# ---------------------------------------------------------------------------
# Qwen2.5-32B at published width cut to 8 of 64 layers: a 524,288-row
# cache is 4.29 GB a layer (8 KV heads x 128 x 4 B x 2), 34.4 GB at 8,
# beside about 22 GB of fp32 weights
WINDOW_ARCH = "qwen2.5-32b"
# decode_32k's span at batch 8 (the shape's 32,768 rows; a batch of rows
# at 32,768 keys and shorter)
DECODE_32K_ROWS = 32768
DECODE_32K_KV_LEN = (32768, 32768, 30720, 28000, 24576, 20000, 16384, 8192)
WINDOW_PROMPT_LENS = (4160, 4224)      # past the 4096-key window
WINDOW_NEW_TOKENS = 8
WINDOW_MAX_LEN = 4352                  # serving cache rows (272 pages)
# the long decode: the kernel's (o, m, l) against the plain version on one
# layer's cache, at phase 2's tolerances; the model's logits on the
# 524,288-row cache against those on the window's 4096 rows held at their
# positions (a paged cache whose table backs only the window's pages)
TOL_WINDOW_LOGITS = 1e-4
# the dry run: every arch x shape x mesh in a subprocess (its passes in a
# process a CPU core), alone in phase dryrun beside nothing timed;
# parameters and a 1 x 32,768 cache at bf16 on the card against the
# specs' byte counts (the caching allocator rounds each block up to 512
# bytes)
DRYRUN_TIMEOUT_S = 300
DRYRUN_CARD_ARCHS = ("gemma-7b", "qwen2-moe-a2.7b")
DRYRUN_CARD_ROWS = 32768
ALLOC_ROUND = 512


def _window_bound(cfg, rows, kv_rows, weights_bytes=0, layers=1):
    """Least ms for one decode token: ``kv_rows`` attended K/V rows in
    each of ``layers`` layers, plus ``weights_bytes`` read once, over the
    HBM rate; and the fp32 K/V bytes a layer holds at ``rows``."""
    row = cfg.num_kv_heads * cfg.resolved_head_dim * 4 * 2
    return ((layers * kv_rows * row + weights_bytes)
            / _peak("HBM_BYTES_PER_S") * 1e3, rows * row)


def _long_attention(h, kvh, hd, rows, kv_len, windows, seed):
    """Decode attention at long spans: q [B, H, 1, hd] at each batch row's
    last valid position over seeded K/V [B, KV, rows, hd] (``kv_len``
    valid rows each), once per window of ``windows``: the kernel against
    its plain version (phase 2's tolerances), kernel, plain and SDPA times
    (SDPA with the same mask over the whole cache), the bound, and the
    launch's CTAs, scratch bytes and peak allocated memory."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash
    from repro_torch.kernels.flash import valid_mask
    dev = torch.device("cuda")
    b = len(kv_len)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, 1, hd, device=dev, generator=gen)
    k = torch.randn(b, kvh, rows, hd, device=dev, generator=gen)
    v = torch.randn(b, kvh, rows, hd, device=dev, generator=gen)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    qpos = (kvl - 1)[:, None].contiguous()
    out, ok = [], True
    for w in windows:
        def run(w=w):
            return flash.flash_attention_lse(q, k, v, kvl, qpos, window=w)

        def plain(w=w):
            return flash.flash_attention_lse_plain(
                q, k, v, kvl, qpos, scale=hd ** -0.5, window=w)
        valid = valid_mask(b, 1, rows, kvl, qpos, False, w, dev)

        def library(mask=valid[:, None]):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        torch.cuda.reset_peak_memory_stats()
        got = run()
        torch.cuda.synchronize()
        plan = _flash_plan(torch, q, k, False)
        err_o, err_m, err_l = _errors(got, plain())
        good = (err_o <= TOL_O_ABS and err_m <= TOL_M_REL
                and err_l <= TOL_L_REL)
        ok = ok and good
        bound_ms, bound_by = _bound(valid, b, h, kvh, 1, hd, 8 * b)
        k_ms, k_eager = cuda_ms(run, batches=11, per_batch=5)
        out.append({"window": w, "rows": rows, "batch": b,
                    "kv_len": list(kv_len),
                    "attended_rows": int(valid.sum()), "ok": good,
                    "max_abs_err": err_o, "m_rel_err": err_m,
                    "l_rel_err": err_l, "kernel_ms": k_ms,
                    "kernel_eager_ms": k_eager,
                    "plain_ms": _eager_ms(plain, warmup=1, batches=3,
                                          per_batch=1),
                    "library_ms": _eager_ms(library, warmup=1, batches=3,
                                            per_batch=1),
                    "library": "SDPA (enable_gqa) with the mask over the "
                               "whole cache",
                    "bound_ms": bound_ms, "bound_by": bound_by, **plan})
    del q, k, v
    _free()
    return ok, out


def _long_decode_layer(cfg, rows, window):
    """One layer's decode attention at ``rows`` keys (q [1, H, 1, hd] at
    position rows - 1 over seeded K/V [1, KV, rows, hd]) with the window
    and without (``_long_attention``; the plain version's GQA expansion is
    5 x 4.29 GB, so it runs here, with no model on the card)."""
    return _long_attention(cfg.num_heads, cfg.num_kv_heads,
                           cfg.resolved_head_dim, rows, [rows],
                           (window, 0), 40)


def _window_paged(cache, window, page):
    """Per layer, a paged copy of ``cache`` whose table backs only the
    window's last pages (the rest is the null block): the window's rows
    held at their positions in ``window`` rows of storage."""
    import torch
    from repro_torch.models import paging
    rows = next(iter(cache[0].values())).shape[1]
    n, w = rows // page, window // page
    table = torch.zeros(1, n, dtype=torch.int32, device="cuda")
    table[0, n - w:] = torch.arange(1, w + 1, dtype=torch.int32)
    return [{name: paging.make_paged(buf, table, page)
             for name, buf in layer.items()} for layer in cache]


def _long_decode(target, rows, window):
    """One decode token at row ``rows - 1`` of a seeded ``rows``-row cache
    (no prefill) through the bundle's window override: launches (flash
    once a layer), logits against the same decode on the window's rows
    alone (``_window_paged``: paged flash once a layer), ms a step with
    the override and without it (every row read; flash once a layer too),
    each against its bound (weights read once, of an untied input
    embedding only the token's row, plus the attended K/V rows)."""
    import torch
    from repro_torch.core.speculative import ModelBundle
    cfg = target.cfg
    torch.cuda.reset_peak_memory_stats()
    cache = target.init_cache(1, rows)
    gen = torch.Generator(device="cuda").manual_seed(41)
    for layer in cache:
        for buf in layer.values():
            buf.normal_(generator=gen)
    small = _window_paged(cache, window, PAGE)
    token = torch.tensor([7], device="cuda")
    zero_launches(target)
    dense, _ = target.decode(token, cache, rows - 1)
    torch.cuda.synchronize()
    launches, expect = read_launches(target)
    dense_ok = (launches_ok(launches, expect, ("flash_attention_lse",))
                and launches["flash_attention_lse"] == cfg.num_layers)
    zero_launches(target)
    paged, _ = target.decode(token, small, rows - 1)
    torch.cuda.synchronize()
    p_launches, _ = read_launches()
    paged_ok = (p_launches["paged_flash_attention_lse"] == cfg.num_layers
                and sum(p_launches.values()) == cfg.num_layers)
    diff = float((dense - paged).abs().max())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    free = ModelBundle(target.model)
    zero_launches(target)
    free.decode(token, cache, rows - 1)
    torch.cuda.synchronize()
    f_launches, _ = read_launches(target)
    free_ok = (f_launches["flash_attention_lse"] == cfg.num_layers
               and sum(f_launches.values()) == cfg.num_layers)
    # every weight read once, but of an untied input embedding only the
    # token's row (a tied table is the LM head's, read whole)
    table = target.model.embed.table
    weights = sum(p.numel() * p.element_size()
                  for p in target.model.parameters())
    if not cfg.tie_embeddings:
        weights -= (table.shape[0] - 1) * table.shape[1] * table.element_size()
    win_bound, layer_bytes = _window_bound(cfg, rows, window, weights,
                                           cfg.num_layers)
    full_bound, _ = _window_bound(cfg, rows, rows, weights, cfg.num_layers)
    win_layer, _ = _window_bound(cfg, rows, window)
    full_layer, _ = _window_bound(cfg, rows, rows)
    ms_win = _eager_ms(lambda: target.decode(token, cache, rows - 1),
                       warmup=1, batches=5, per_batch=2)
    ms_full = _eager_ms(lambda: free.decode(token, cache, rows - 1),
                        warmup=1, batches=5, per_batch=2)
    ok = (dense_ok and paged_ok and free_ok
          and bool(torch.isfinite(dense).all()) and diff <= TOL_WINDOW_LOGITS)
    del cache, small
    _free()
    return ok, {"ok": ok, "rows": rows, "position": rows - 1,
                "window_override": window, "layers": cfg.num_layers,
                "kv_gb": layer_bytes * cfg.num_layers / 1e9,
                "weights_gb": weights / 1e9, "peak_mem_gb": peak_gb,
                "launches": launches, "expected_launches": expect,
                "paged_launches": p_launches,
                "no_override_launches": f_launches,
                "logits_vs_window_rows": {"max_abs_diff": diff,
                                          "bit_equal": diff == 0.0,
                                          "tol": TOL_WINDOW_LOGITS},
                "ms_per_step": {"override": ms_win, "no_override": ms_full},
                "bound_ms_per_step": {"override": win_bound,
                                      "no_override": full_bound},
                "bound_ms_per_layer_attention": {"override": win_layer,
                                                 "no_override": full_layer}}


def _window_tree_cases(cfg, window, t):
    """The windowed tree-verify entry points at the serving shape (8
    queries at a committed length of 4224 over a 4352-row cache, a T-row
    tree buffer), dense and paged: against the plain version, with entry,
    plain and SDPA times (one SDPA call over the committed rows and the
    tree rows with the joint mask) and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash, ops, paged, tree_block
    from repro_torch.kernels.flash import valid_mask
    dev = torch.device("cuda")
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    n, length, committed = 8, WINDOW_MAX_LEN, WINDOW_PROMPT_LENS[-1]
    rows, ok = [], True
    for paged_mode in (False, True):
        gen = torch.Generator().manual_seed(50 + paged_mode)
        q = torch.randn(1, n, h, hd, generator=gen).to(dev).transpose(1, 2)
        mask = torch.rand(1, n, t, generator=gen) < 0.3
        mask[:, :, 0] = True
        mask = mask.to(dev)
        kvl = torch.tensor([committed], dtype=torch.int32, device=dev)
        qpos = (committed + torch.arange(n, device=dev) // 2).to(
            torch.int32)[None]
        dense = {half: {p: torch.randn(1, ln, kvh, hd, generator=gen).to(dev)
                        for p in "kv"}
                 for half, ln in (("past", length), ("tree", t))}
        scale = hd ** -0.5
        if paged_mode:
            pools = {}
            for half, horizon in (("past", [length]), ("tree", [t])):
                views = {}
                for p, x in dense[half].items():
                    views[p], table = _paged_pool(
                        torch, x, horizon,
                        torch.Generator().manual_seed(len(half)))
                pools[half] = (views, table)
            (pk, ptab), (tk, ttab) = pools["past"], pools["tree"]

            def entry():
                return ops.paged_tree_attention(
                    q, pk["k"], pk["v"], ptab, tk["k"], tk["v"], ttab, mask,
                    kvl, qpos=qpos, window=window)

            def plain():
                past = paged.paged_flash_attention_lse_plain(
                    q, pk["k"], pk["v"], ptab, kvl, qpos, scale=scale,
                    window=window)
                return paged.paged_tree_block_attention_plain(
                    q, tk["k"], tk["v"], ttab, mask, scale=scale, past=past)
        else:
            pk = {p: x.transpose(1, 2) for p, x in dense["past"].items()}
            tk = {p: x.transpose(1, 2) for p, x in dense["tree"].items()}

            def entry():
                return ops.tree_attention(q, pk["k"], pk["v"], tk["k"],
                                          tk["v"], mask, kvl, qpos=qpos,
                                          window=window)

            def plain():
                past = flash.flash_attention_lse_plain(
                    q, pk["k"], pk["v"], kvl, qpos, scale=scale,
                    window=window)
                return tree_block.tree_block_attention_plain(
                    q, tk["k"], tk["v"], mask, scale=scale, past=past)
        past_valid = valid_mask(1, n, length, kvl, qpos, False, window, dev)
        joint = torch.cat([past_valid, mask], -1)
        lib_k = torch.cat([dense["past"]["k"], dense["tree"]["k"]],
                          1).transpose(1, 2)
        lib_v = torch.cat([dense["past"]["v"], dense["tree"]["v"]],
                          1).transpose(1, 2)

        def library():
            return F.scaled_dot_product_attention(
                q, lib_k, lib_v, attn_mask=joint[:, None], enable_gqa=True)
        got = entry()
        torch.cuda.synchronize()
        err = float((got - plain()).abs().max())
        err_lib = float((got - library()).abs().max())
        good = err <= TOL_O_ABS
        ok = ok and good
        bound_ms, bound_by = _bound(joint, 1, h, kvh, n, hd,
                                    8 + 4 * n + n * t)
        rows.append({"case": ("paged " if paged_mode else "")
                     + f"windowed tree verify B=1 n={n} L={length} T={t}",
                     "entry": "ops." + "paged_" * paged_mode
                     + "tree_attention", "window": window,
                     "committed": committed,
                     "attended_past_rows": int(past_valid.any(1).sum()),
                     "ok": good, "max_abs_err": err,
                     "max_abs_err_vs_library": err_lib, "tol": TOL_O_ABS,
                     "entry_ms": cuda_ms(entry)[0],
                     "plain_ms": cuda_ms(plain)[0],
                     "library_ms": cuda_ms(library)[0],
                     "library": "SDPA (enable_gqa) over the committed and "
                                "tree rows, the joint mask",
                     "bound_ms": bound_ms, "bound_by": bound_by})
    return ok, rows


def _window_serving(target, draft, window):
    """The two prompts past the window, 8 new tokens, both bundles with
    the override: PipeDec (8 stages, width 8, branch 4) lossless against
    autoregressive decoding; SpecPipe-DB on the dense and the paged arena
    (paged equals dense bit for bit), on the 8-stage flush ring (equal to
    the local dense run bit for bit) and on the overlapped ring (its
    prefill lane off, tokens equal at a near-tie, logits within
    TOL_ASYNC_LOGITS); launches as the calls imply.  Returns (ok, line)."""
    import numpy as np
    from repro_torch.core.pipedec import PipeDecConfig
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, target.cfg.vocab_size, size=n).astype(
        np.int64) for n in WINDOW_PROMPT_LENS]
    new = WINDOW_NEW_TOKENS
    want, ar_ms = _autoregressive(target, prompts, new,
                                  max_len=WINDOW_MAX_LEN)
    ok, pipedec = _family_pipedec(target, draft, prompts, want, new,
                                  FP32_PATH, max_len=WINDOW_MAX_LEN)
    pcfg = PipeDecConfig(n_stages=8, width=8, branch=4)
    requests = [(uid, p, new, 0) for uid, p in enumerate(prompts)]
    runs, lines = {}, []
    for kind, paged in (("local", False), ("local", True), ("flush", False),
                        ("overlap", False)):
        run = _family_db_drive(kind, target, draft, requests, paged=paged,
                               pcfg=pcfg, max_len=WINDOW_MAX_LEN)
        runs[kind, paged] = run
        ex, st = run["ex"], run["stats"]
        path = PAGED_PATH if paged else FP32_PATH
        good = launches_ok(run["launches"], run["expected_launches"], path)
        if kind != "local":
            good = good and _executor_ok(kind, ex, st, target, draft,
                                         len(requests))
        for uid, p, _, _ in requests:
            good = good and _lossless(target, p, run["results"][uid].tokens,
                                      want[uid])[0]
        vs = None
        if (kind, paged) != ("local", False):
            vs_ok, vs = _ring_vs(run, runs["local", False], target,
                                 requests, bits=kind != "overlap")
            good = good and vs_ok
        if kind == "overlap":
            good = good and ex.prefill_cap == 0
        ok = ok and good
        lines.append({"kind": kind, "arena": "paged" if paged else "dense",
                      "ok": good, "prefill_cap": getattr(ex, "prefill_cap",
                                                         None),
                      "timesteps": st.timesteps,
                      "ms_per_timestep": run["ms_per_timestep"],
                      "run_s": run["run_s"], "peak_mem_gb": run["peak_gb"],
                      "vs_local_dense": vs, "launches": run["launches"],
                      "expected_launches": run["expected_launches"],
                      "executor_calls": dict(ex.calls)})
        run.pop("ex")
    return ok, {"prompt_lens": list(WINDOW_PROMPT_LENS), "new_tokens": new,
                "max_len": WINDOW_MAX_LEN,
                "autoregressive_ms_per_token": ar_ms, "pipedec": pipedec,
                "db": lines}


def _kill_tree(pid):
    """SIGKILL process ``pid`` and every descendant it has (the dry run's
    worker pool), children first read from ``/proc``."""
    def children(p):
        try:
            tasks = Path(f"/proc/{p}/task").iterdir()
            kids = [int(c) for t in tasks
                    for c in (t / "children").read_text().split()]
        except OSError:
            return []
        return kids + [g for k in kids for g in children(k)]
    for p in [pid] + children(pid):
        try:
            os.kill(p, signal.SIGKILL)
        except ProcessLookupError:
            pass


def phase_window(state):
    """long_500k's window override (``launch.specs.window_override``: 4096
    keys) at Qwen2.5-32B's published width, cut to 8 of 64 layers, fp32:
    one layer's windowed decode attention at 524,288 rows against the
    plain version and timed with and without the window; the 8-layer
    target (and the seeded 2-layer draft) with the override on a seeded
    524,288-row cache, one decode at its last row; the windowed
    tree-verify entry points, dense and paged, at the serving shape; the
    two prompts past the window served by PipeDec, SpecPipe-DB (dense,
    paged), the flush ring and the overlapped ring (``_window_serving``)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipedec import PipeDecConfig
    from repro_torch.core.speculative import ModelBundle
    from repro_torch.launch import specs
    from repro_torch.models import transformer as tf
    _free("target", "draft", "target_int8", "draft_int8", state=state)
    t0 = time.perf_counter()
    full = get_config(WINDOW_ARCH)
    long = specs.SHAPES["long_500k"]
    window = specs.window_override(full, long)
    rows = long.seq_len
    layer_ok, layer = _long_decode_layer(full, rows, window)
    span_ok, span = _long_attention(full.num_heads, full.num_kv_heads,
                                    full.resolved_head_dim, DECODE_32K_ROWS,
                                    DECODE_32K_KV_LEN, (0,), 42)
    cfg, dcfg = _family_cfgs(WINDOW_ARCH)
    target = ModelBundle(tf.init_model(cfg, seed=0, device="cuda"),
                         window_override=window)
    draft = ModelBundle(tf.init_model(dcfg, seed=1, device="cuda"),
                        window_override=window)
    decode_ok, decode = _long_decode(target, rows, window)
    tree_ok, tree = _window_tree_cases(
        cfg, window, PipeDecConfig(n_stages=8, width=8,
                                   branch=4).tree_buffer_capacity)
    serve_ok, serve = _window_serving(target, draft, window)
    ok = (window == 4096 and layer_ok and span_ok and decode_ok and tree_ok
          and serve_ok)
    emit({"phase": "window", "ok": ok, "target": cfg.name,
          "draft": dcfg.name, "shape": dataclasses.asdict(long),
          "window_override": window,
          "reduced": {"target_layers": f"{cfg.num_layers} of "
                      f"{full.num_layers}"},
          "long_decode_layer": layer, "decode_32k_span": span[0],
          "long_decode": decode,
          "tree_verify": tree, "serving": serve,
          "seconds": time.perf_counter() - t0})
    del target, draft
    _free()
    if not ok:
        raise AssertionError("window failed: see its line")


def _card_bytes(make):
    """``make()``'s tensors, built on the card, and {"tensors", "bytes"
    they hold, "requested" (the caching allocator's requested bytes
    grown), "allocated" (``torch.cuda.memory_allocated()`` grown), "low",
    "high"}: the allocator rounds each request up to 512 bytes, and
    leaves a block over 1 MiB unsplit when its segment's tail is at most
    1 MiB, so it counts between the sum of the 512-byte roundings and that
    with each block over 1 MiB rounded up to its 2 MiB segment."""
    import torch

    def requested():
        return torch.cuda.memory_stats().get("requested_bytes.all.current")
    _free()
    before, req = torch.cuda.memory_allocated(), requested()
    tensors = make()
    torch.cuda.synchronize()
    sizes = [t.numel() * t.element_size() for t in tensors]

    def up(n, unit):
        return -(-n // unit) * unit
    return tensors, {
        "tensors": len(tensors), "bytes": sum(sizes),
        "requested": None if req is None else requested() - req,
        "allocated": torch.cuda.memory_allocated() - before,
        "low": sum(up(n, ALLOC_ROUND) for n in sizes),
        "high": sum(up(n, ALLOC_ROUND) if n <= 1 << 20 else up(n, 2 << 20)
                    for n in sizes)}


def _card_specs_bytes():
    """(ok, lines): for each DRYRUN_CARD_ARCHS model at bf16, its
    parameters (``specs.param_specs`` built on the card) and a 1 x
    DRYRUN_CARD_ROWS cache (``specs.cache_specs``), the specs' bytes (and
    the sharding module's on a 1 x 1 host mesh) against the bytes the
    tensors hold and what the allocator took (``_card_bytes``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding, specs
    from repro_torch.launch.mesh import make_host_mesh
    ok, card = True, []
    mesh = make_host_mesh(1, 1)
    for arch in DRYRUN_CARD_ARCHS:
        cfg = get_config(arch)
        model = specs.param_specs(cfg)
        want_p = sum(p.numel() * p.element_size()
                     for p in model.parameters())
        shard_p = sharding.device_bytes(
            sharding.param_leaves(model),
            lambda p, s, cfg=cfg: sharding.param_pspec(p, s, cfg, mesh), mesh)
        params, got_p = _card_bytes(
            lambda: list(model.to_empty(device="cuda").parameters()))
        cache_meta = specs.cache_specs(cfg, 1, DRYRUN_CARD_ROWS)
        want_c = sum(t.numel() * t.element_size() for layer in cache_meta
                     for t in layer.values())
        cache, got_c = _card_bytes(
            lambda: [torch.empty_like(t, device="cuda")
                     for layer in cache_meta for t in layer.values()])
        good = shard_p == want_p
        lines = {}
        for what, want, got in (("params", want_p, got_p),
                                ("cache", want_c, got_c)):
            good = (good and want == got["bytes"]
                    and got["requested"] in (None, want)
                    and got["low"] <= got["allocated"] <= got["high"])
            lines[what] = {"specs_bytes": want, **got,
                           "allocated_over_specs": got["allocated"] - want}
        lines["params"]["host_mesh_bytes"] = shard_p
        ok = ok and good
        card.append({"arch": arch, "ok": good, "dtype": "bfloat16",
                     "cache_shape": [1, DRYRUN_CARD_ROWS], **lines})
        del model, params, cache
        _free()
    return ok, card


def phase_dryrun(state):
    """``python -m repro_torch.launch.dryrun --all --both-meshes`` in a
    subprocess that this phase starts and waits for, so that no phase is
    timed while its worker pool takes every host core: every arch x shape
    x mesh row ok.  Meanwhile,
    for Gemma-7b and Qwen-MoE at bf16, the parameters
    (``specs.param_specs`` built on the card) and a 1 x 32,768 cache
    (``specs.cache_specs``): the specs' byte counts (and the sharding
    module's on a 1 x 1 host mesh) equal to the bytes the tensors hold and
    the allocator's requested bytes, and ``torch.cuda.memory_allocated()``
    within the allocator's rounding (``_card_specs_bytes``; bytes, no
    time)."""
    _free("target", "draft", "target_int8", "draft_int8", state=state)
    out = ROOT / "build" / "dryrun_rows.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--both-meshes", "--out", str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ok, card = _card_specs_bytes()
        stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            _kill_tree(proc.pid)
            proc.communicate()
    dry_s = time.perf_counter() - t0
    rows = ([json.loads(line) for line in out.read_text().splitlines()]
            if out.exists() else [])
    tail = stdout.strip().splitlines()[-1:]
    dry_ok = proc.returncode == 0 and len(rows) == 80
    ok = ok and dry_ok
    by_shape = collections.defaultdict(float)
    for r in rows:
        by_shape[r["shape"]] = max(by_shape[r["shape"]], r["pass_s"])
    emit({"phase": "dryrun", "ok": ok,
          "command": "python -m repro_torch.launch.dryrun --all "
                     "--both-meshes", "cpu_count": os.cpu_count(),
          "returncode": proc.returncode, "rows": len(rows),
          "rows_ok": dry_ok, "seconds": dry_s, "last_line": tail,
          "stderr_tail": stderr[-2000:] if proc.returncode else None,
          "slowest_pass_s_by_shape": dict(by_shape),
          "meshes": sorted({r["mesh"] for r in rows}), "card": card})
    if not ok:
        raise AssertionError("dryrun failed: see its line")


# ---------------------------------------------------------------------------
def _ptxas(text: str):
    """ptxas's report lines (registers, shared memory, spills) by mangled
    kernel name, from nvcc's ``-Xptxas -v`` output."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
            out[cur] = []
        elif cur and ("registers" in line or "spill" in line):
            out[cur].append(line.split("ptxas info    :")[-1].strip())
    return out


def compiled(build, name: str, nvcc_report: str):
    """One row per kernel instance of source ``name``: its demangled name,
    ptxas's report (when this run built it) and the SASS_COUNTED counts of
    its code (``cuobjdump -sass`` of the built library)."""
    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if line.strip().startswith("Function : "):
            cur = line.split(":", 1)[1].strip()
            counts[cur] = dict.fromkeys(SASS_COUNTED, 0)
        elif cur:
            for key in SASS_COUNTED:
                if re.search(rf"\b{re.escape(key)}\b", line):
                    counts[cur][key] += 1
    ptxas = _ptxas(nvcc_report)
    keys = sorted(set(counts) | set(ptxas))
    try:
        pretty = subprocess.run(["c++filt"], input="\n".join(keys),
                                capture_output=True, text=True,
                                check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        pretty = keys
    return [{"kernel": p, "ptxas": ptxas.get(k), "sass": counts.get(k)}
            for k, p in zip(keys, pretty)]


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        bail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    try:
        import torch
    except ImportError:
        bail("PyTorch is not installed")
    if not torch.cuda.is_available():
        bail("CUDA is not available: this script runs the port on one "
             "NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (switches TF32 off)
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    reports = build.build(build.KERNELS)
    build_s = time.perf_counter() - t0
    emit({"phase": "card", "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi[0] if smi else None,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s})
    for name in build.KERNELS:
        for row in compiled(build, name, reports.get(name, "")):
            emit({"phase": "card", "source": name, **row})

    state, failed = {"launches": {}}, []
    for name, phase in (("kernels", phase_kernels), ("train", phase_train),
                        ("train-families", phase_train_families),
                        ("train-pair", phase_train_pair),
                        ("serve", phase_serve),
                        ("self-draft", phase_self_draft),
                        ("serve-db", phase_serve_db),
                        ("self-draft-db", phase_self_draft_db),
                        ("serve-db-sharded", phase_serve_db_sharded),
                        ("serve-db-overlap", phase_serve_db_overlap),
                        ("self-draft-db-overlap",
                         phase_self_draft_db_overlap),
                        ("serve-db-async", phase_serve_db_async),
                        ("self-draft-db-async", phase_self_draft_db_async),
                        ("stpp", phase_stpp),
                        ("self-draft-stpp", phase_self_draft_stpp),
                        ("chain", phase_chain),
                        ("self-draft-chain", phase_self_draft_chain),
                        ("sim", phase_sim),
                        ("serve-int8", phase_serve_int8),
                        ("stpp-int8", phase_stpp_int8),
                        ("self-draft-int8", phase_self_draft_int8),
                        ("serve-db-int8", phase_serve_db_int8),
                        ("serve-db-int8-sharded",
                         phase_serve_db_int8_sharded),
                        ("serve-db-int8-overlap",
                         phase_serve_db_int8_overlap),
                        ("cli", phase_cli),
                        *((f"family-{arch}", phase_family(arch))
                          for arch, _ in FAMILY_ARCHS
                          + FAMILY_MODAL_ARCHS),
                        *((f"family-{arch}", phase_recurrent(arch))
                          for arch, _ in FAMILY_RECURRENT_ARCHS),
                        ("family-db", phase_family_db),
                        ("family-int8", phase_family_int8),
                        ("window", phase_window),
                        ("dryrun", phase_dryrun),
                        ("sharded-check", phase_sharded_check)):
        t0 = time.perf_counter()
        try:
            phase(state)
        except Exception as exc:   # record, run the other phases, exit 1
            traceback.print_exc()
            failed.append(name)
            emit({"phase": name, "ok": False, "error": repr(exc)})
        emit({"phase": name, "done_s": time.perf_counter() - t0})

    summary = state.get("kernel_summary", {})
    launches = state.get("launches", {})
    rows = []
    for name, src, replaces in KERNEL_ROWS:
        s = summary.get(name, {})
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches.get(name, 0),
                     "max_abs_err": s.get("max_abs_err"), "ms": s.get("ms"),
                     "dense_ms": s.get("dense_ms"),
                     "plain_ms": s.get("plain_ms"),
                     "bound_ms": s.get("bound_ms"),
                     "bound_by": s.get("bound_by"),
                     "library_ms": s.get("library_ms"),
                     "case": s.get("case")})
    print(smi[0] if smi else "nvidia-smi: no reading", flush=True)
    emit({"kernels": rows})
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
