"""Roofline terms of one step on the reference's production mesh, and the
H100's published peaks: the port of the JAX package's
``repro/launch/analysis.py``.

The reference lowers and compiles each step with XLA on 512 fake devices
and reads the partitioned module: ``cost_analysis`` flops and bytes
accessed, the collective bytes parsed from the HLO text
(``collective_bytes``, ``_shape_bytes``) and ``memory_analysis`` (with
the compiler's temporaries).  The port has no compiler and no partitioned
module, so those stay with XLA and are not ported.  Here:

  * ``flops`` are the products that ``torch.utils.flop_counter.
    FlopCounterMode`` counts over one meta-device pass of the whole
    (unpartitioned) step (``launch.dryrun``): matmuls, batched matmuls and
    attention, 2 per multiply-add, nothing else (no softmax, norm or
    elementwise op), so they are not comparable with XLA's ``hlo_flops``.
    The plain attention the meta pass runs computes every key row and
    masks (a window, a causal bound), so a windowed or causal attention
    counts more products than the kernels make;
  * memory is what one device holds under the sharding rules
    (``launch.sharding``): weights, optimizer moments (fp32, ZeRO-1),
    cache and step inputs; no temporaries, there being no compiler to
    plan them.  ``t_memory`` reads each of those bytes once;
  * there is no collective term.
"""
from __future__ import annotations

import dataclasses

# Published H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W
# limit): HBM bandwidth; the tensor cores' TF32 (the attention kernels'
# 3xTF32 products) and bf16 (the dequant-matmul's passes, and the dry
# run's bf16 steps) rates; fp32 outside the tensor cores (training's IEEE
# sgemm, TF32 off)
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12


def model_flops_estimate(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS = 6 N D for a training step, 2 N D for a prefill, 2 N
    per sequence for a decode step (N the active parameters, D the
    tokens), as the reference estimates it."""
    n_active = cfg.param_count(active_only=True)
    if kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


@dataclasses.dataclass
class Roofline:
    """One (arch, shape, mesh) row: the step's counted products, the bytes
    one device holds, and what they would take at the H100's bf16 and HBM
    peaks (``t_compute`` over the per-device share of the products)."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float
    model_flops: float
    param_bytes: int
    opt_bytes: int
    cache_bytes: int
    input_bytes: int
    window_override: int = -1

    @property
    def per_device_mem(self) -> int:
        return (self.param_bytes + self.opt_bytes + self.cache_bytes
                + self.input_bytes)

    @property
    def t_compute(self) -> float:
        return self.flops / self.chips / BF16_FLOP_PER_S

    @property
    def t_memory(self) -> float:
        return self.per_device_mem / HBM_BYTES_PER_S

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def row(self, **extra) -> dict:
        out = {"arch": self.arch, "shape": self.shape, "mesh": self.mesh,
               "chips": self.chips, "flops": self.flops,
               "flops_per_device": self.flops / self.chips,
               "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
               "bottleneck": self.bottleneck,
               "model_flops": self.model_flops,
               "useful_ratio": self.useful_ratio,
               "per_device_mem": self.per_device_mem,
               "param_bytes": self.param_bytes,
               "opt_bytes": self.opt_bytes,
               "cache_bytes": self.cache_bytes,
               "input_bytes": self.input_bytes,
               "window_override": self.window_override}
        out.update(extra)
        return out


def roofline(arch: str, shape, mesh, *, flops: float, cfg, param_bytes: int,
             opt_bytes: int = 0, cache_bytes: int = 0, input_bytes: int = 0,
             window_override: int = -1) -> Roofline:
    """The ``Roofline`` of one counted step (``launch.dryrun``)."""
    return Roofline(arch=arch, shape=shape.name, mesh=mesh.desc,
                    chips=mesh.size, flops=float(flops),
                    model_flops=model_flops_estimate(cfg, shape, shape.kind),
                    param_bytes=param_bytes, opt_bytes=opt_bytes,
                    cache_bytes=cache_bytes, input_bytes=input_bytes,
                    window_override=window_override)
