"""Training driver of the port: AdamW on the synthetic byte corpus.

  PYTHONPATH=src python -m repro_torch.launch.train --arch pipedec-draft \
      --smoke --steps 50 --batch 8 --seq 128 [--ckpt out.npz]

trains on the card; ``--device cpu`` trains on the CPU.  The loop is the
JAX package's ``repro/launch/train.py``: the corpus and the batches come
from ``--seed`` (0) as there, ``warmup_steps = max(10, steps // 20)``,
cosine decay to 0 at ``--steps``.  The weights are the port's own draw
from the seed (the JAX package's distributions, not its values).  A
checkpoint is the JAX parameter pytree (``{"params": ...}``, flat-key
``.npz``), which the JAX package and ``launch.serve.build_bundle(ckpt=)``
both load.  ``--arch`` takes every registry id the port serves.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch import configs as cfg_reg
from repro_torch.checkpoint import save_pytree, to_jax_params
from repro_torch.data import (BYTE_VOCAB, ByteCorpus, DataConfig,
                              batch_iterator, synthetic_corpus)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tf
from repro_torch.models.layers import trainable
from repro_torch.optim import AdamWConfig, adamw_init


def train(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
          seed: int = 0, ckpt: str = "", log_every: int = 10,
          corpus_bytes: int = 1 << 18, device: DeviceLike = None):
    """Train ``cfg`` on the synthetic byte corpus for ``steps`` steps on
    ``device`` (the card unless the caller asks for the CPU); returns
    (model, losses) and saves a checkpoint to ``ckpt`` when given.  The
    returned model's weights take no gradient, as a served model's.  Every
    family the port serves trains, on tokens and labels alone as in the
    JAX CLI (an encoder-decoder without frames, a VLM without a prefix);
    int8 configs are refused (``layers.trainable``)."""
    tf.check_supported(cfg)
    if cfg.vocab_size < BYTE_VOCAB:
        raise ValueError(f"the byte pipeline needs vocab >= {BYTE_VOCAB}, "
                         f"{cfg.name} has {cfg.vocab_size}")
    dev = resolve_device(device)
    model = tf.init_model(cfg, seed=seed, device=dev)
    params = trainable(model)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(10, steps // 20),
                          total_steps=steps)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, opt_cfg, remat=False)

    data_cfg = DataConfig(seq_len=seq, batch_size=batch, seed=seed)
    corpus = ByteCorpus(synthetic_corpus(corpus_bytes, seed=seed), data_cfg)
    it = batch_iterator(corpus, epochs=1000)

    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        tokens, labels = next(it)
        opt, metrics = step_fn(model, opt, {"tokens": tokens,
                                            "labels": labels})
        losses.append(float(metrics["loss"]))
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)",
                  flush=True)
    model.requires_grad_(False)
    if ckpt:
        save_pytree(ckpt, {"params": to_jax_params(model)})
        print(f"saved checkpoint to {ckpt}")
    return model, losses


def main(argv=None):
    """CLI entry: train one arch (``--smoke`` for the reduced config).
    Returns (model, losses)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="pipedec-target")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    cfg = cfg_reg.get_config(args.arch, smoke=args.smoke)
    if cfg.vocab_size < BYTE_VOCAB:
        cfg = dataclasses.replace(cfg, vocab_size=BYTE_VOCAB)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
