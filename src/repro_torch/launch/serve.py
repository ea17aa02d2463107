"""Serving CLI of the port: build the smoke-size target + draft and run a
batch of requests through the ServingEngine in pp, pipedec or pipedec-db
mode.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode pipedec
  PYTHONPATH=src python -m repro_torch.launch.serve --mode pipedec-db \
      --paged --slots 3

runs the smoke-size pair on the card; ``--device cpu`` runs it on the
CPU.  ``--target-arch`` and ``--draft-arch`` pick other architectures
of the registry at their smoke sizes (the JAX CLI's flags and defaults):

  PYTHONPATH=src python -m repro_torch.launch.serve --target-arch gemma-7b
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --target-arch deepseek-v2-236b --mode pipedec-db --paged
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --target-arch whisper-base --mode pipedec-db

``internvl2-26b`` and ``whisper-base`` are served text-only, with no
vision prefix and no encoder output, as the reference's CLI serves them
(a Whisper decoder then skips its cross-attention).  The recurrent
families are served in pp mode; the tree modes refuse them with
``NotImplementedError`` (recurrent models speculate in chain mode,
``core.chain``, which this CLI does not offer, as the reference's does
not):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --target-arch recurrentgemma-9b --mode pp --device cpu

``--quant int8`` serves both bundles quantized
(``ModelBundle.quantize()``: int8 projections through the dequant-matmul
kernel, an int8 KV cache through the attention kernels' int8 mode).
``--mode pipedec-db`` serves SpecPipe-DB with ``--slots`` slots, over a
dense arena or, with ``--paged``, a block-paged one (``--page-size`` rows
per block).  ``--executor local`` (the default) runs the fused local
executor, whose paged tree verify runs the paged attention kernels;
``--executor sharded`` runs the target on the ``--stages``-stage ring
(``launch.pipeline``), one flush of the ring per timestep, and with
``--overlap`` one ring tick per timestep (the paper's steady state, with
admission prefill in the ring).  ``--executor async`` runs the stages as
free-running actors with the draft on an actor of its own
(``AsyncPipelineExecutor``; no ``--paged``), and shuts them down at the
end.  ``--quant int8`` serves every executor.  ``-h`` lists the flags.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode pipedec-db \
      --executor sharded --overlap --stages 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --mode pipedec-db \
      --executor async --quant int8
"""
from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np

from repro_torch import configs as cfg_reg
from repro_torch.checkpoint import from_jax_params, load_pytree
from repro_torch.core.pipedec import PipeDecConfig
from repro_torch.core.speculative import ModelBundle
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.serving import (AsyncPipelineExecutor, LocalFusedExecutor,
                                 OverlappedShardedExecutor, Request, Result,
                                 ServingEngine, ShardedPipelineExecutor)


def build_bundle(arch: str, *, seed: int, ckpt: str = "",
                 device: DeviceLike = None) -> ModelBundle:
    """The smoke-size config of one arch on ``device``, with seeded random
    weights or the ``{"params": ...}`` of checkpoint ``ckpt`` (written by
    either package's trainer), wrapped as a ``ModelBundle``."""
    cfg = cfg_reg.get_config(arch, smoke=True)
    dev = resolve_device(device)
    if ckpt:
        return ModelBundle(from_jax_params(cfg, load_pytree(ckpt)["params"],
                                           device=dev))
    return ModelBundle(tf.init_model(cfg, seed=seed, device=dev))


def main(argv=None) -> Tuple[ServingEngine, Dict[int, Result]]:
    """CLI entry: build target + draft, serve ``--requests`` seeded
    prompts and print one line per request.  Returns the engine (its
    bundles carry the call counts) and the results by uid."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--mode", choices=["pp", "pipedec", "pipedec-db"],
                    default="pipedec")
    ap.add_argument("--executor", choices=["local", "sharded", "async"],
                    default="local",
                    help="pipedec-db compute backend: local (fused, one "
                         "device), sharded (the target on the "
                         "--stages-stage ring) or async (free-running "
                         "stage actors and a draft actor)")
    ap.add_argument("--overlap", action="store_true",
                    help="sharded executor only: one ring tick per "
                         "timestep with deferred exit logits and prefill "
                         "in the ring, instead of one flush per timestep")
    ap.add_argument("--target-arch", default="pipedec-target",
                    help="the target's architecture (configs: a public id "
                         "such as gemma-7b or deepseek-v2-236b), smoke size")
    ap.add_argument("--draft-arch", default="pipedec-draft",
                    help="the draft's architecture, smoke size (every "
                         "smoke config has the same 512-token vocabulary)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--branch", type=int, default=4)
    ap.add_argument("--slots", type=int, default=3,
                    help="pp: rows per lockstep batch; pipedec-db: KV "
                         "slots (requests sharing a timestep)")
    ap.add_argument("--quant", choices=["none", "int8"], default="none",
                    help="int8: serve both bundles quantized "
                         "(ModelBundle.quantize(): per-out-channel int8 "
                         "weights and an int8 KV cache)")
    ap.add_argument("--paged", action="store_true",
                    help="pipedec-db only: a block-paged KV arena "
                         "(pools behind per-slot block tables; each "
                         "request backs its horizon, not max_len)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="rows per KV block under --paged (a power of two)")
    args = ap.parse_args(argv)
    if args.paged and args.mode != "pipedec-db":
        ap.error("--paged needs --mode pipedec-db")
    if args.executor != "local" and args.mode != "pipedec-db":
        ap.error(f"--executor {args.executor} needs --mode pipedec-db")
    if args.overlap and args.executor != "sharded":
        ap.error("--overlap needs --mode pipedec-db --executor sharded")
    if args.executor == "async" and args.paged:
        ap.error("--executor async has no paged arena: use --executor "
                 "sharded --paged")

    target = build_bundle(args.target_arch, seed=0, device=args.device)
    draft = None
    if args.mode != "pp":
        draft = build_bundle(args.draft_arch, seed=1, device=args.device)
    if args.quant == "int8":
        target = target.quantize()
        draft = draft.quantize() if draft is not None else None
    pcfg = PipeDecConfig(n_stages=args.stages, width=args.width,
                         branch=args.branch)
    max_len = 512
    executor = None
    if args.mode == "pipedec-db":
        kw = dict(slots=args.slots, max_len=max_len,
                  tree_capacity=pcfg.tree_buffer_capacity,
                  capacity=pcfg.capacity, paged=args.paged,
                  page=args.page_size)
        if args.executor == "async":
            kw.pop("page")
            executor = AsyncPipelineExecutor(target, draft,
                                             n_stages=args.stages, **kw)
        elif args.executor == "sharded":
            cls = (OverlappedShardedExecutor if args.overlap
                   else ShardedPipelineExecutor)
            executor = cls(target, draft, n_stages=args.stages, **kw)
        else:
            executor = LocalFusedExecutor(target, draft, **kw)
    engine = ServingEngine(target, draft, mode=args.mode,
                           max_batch=args.slots, max_len=max_len,
                           pipedec=pcfg, executor=executor)
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        prompt = rng.integers(0, target.cfg.vocab_size,
                              size=8).astype(np.int64)
        engine.submit(Request(uid, prompt, args.new_tokens))
    try:
        results = engine.run()
    finally:
        if args.executor == "async" and executor is not None:
            executor.shutdown()
    for uid, res in sorted(results.items()):
        extra = ""
        if res.stats is not None:
            extra = (f" acc={res.stats.acceptance:.2f}"
                     f" tps={res.stats.tokens_per_timestep:.2f}")
        print(f"req {uid}: {res.tokens.tolist()[:10]}... "
              f"{res.latency_s * 1e3:.1f}ms{extra}")
    return engine, results


if __name__ == "__main__":
    main()
