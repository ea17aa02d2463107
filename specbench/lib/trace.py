"""The traced window: ``torch.profiler`` over a run of timesteps, reduced to
device busy time, launches, device time by kernel name, idle gaps by what the
host was doing, and the calls of the paged attention entry points.

Host spans are ``record_function`` ranges named ``specbench.<what>`` that the
harness puts around its calls into the program's layers; ``specbench.window``
covers the whole traced window, so device and host times share its clock.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Optional

import numpy as np

from specbench.lib import counts

WINDOW = "specbench.window"
# the paged kernels' instances (template argument kPaged true)
PAGED_FLASH = "flash_attention_lse_kernel<float, true"
PAGED_TREE = "tree_block_attention_kernel<float, true"


def span(name: str, on: bool):
    """A host span named ``specbench.<name>`` when tracing, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(f"specbench.{name}")


class PagedCalls:
    """Wraps the paged attention entry points that ``kernels.ops`` calls and
    keeps, while ``on``, each call's shapes and the tensors its counts need
    (read on the host after the window, so the window syncs nothing)."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.on, self.calls = ops, False, []
        self.real = (ops.paged_flash_attention_lse,
                     ops.paged_tree_block_attention)
        flash, tree = self.real

        def flash_rec(q, k_pool, v_pool, table, kv_len, qpos=None, **kw):
            if self.on:
                if kw.get("window", 0) or kw.get("causal", False):
                    raise ValueError("the count covers the tree verify's "
                                     "unmasked past half only")
                self.calls.append(("flash", tuple(q.shape), k_pool.shape[1],
                                   table.shape[1], kv_len))
            return flash(q, k_pool, v_pool, table, kv_len, qpos, **kw)

        def tree_rec(q, k_pool, v_pool, table, tree_mask, **kw):
            if self.on:
                self.calls.append(("tree", tuple(q.shape), k_pool.shape[1],
                                   table.shape[1], tree_mask,
                                   kw.get("past") is not None))
            return tree(q, k_pool, v_pool, table, tree_mask, **kw)

        ops.paged_flash_attention_lse = flash_rec
        ops.paged_tree_block_attention = tree_rec

    def restore(self) -> None:
        (self.ops.paged_flash_attention_lse,
         self.ops.paged_tree_block_attention) = self.real

    def least_s(self) -> float:
        """Summed least time of every recorded call."""
        total = 0.0
        for c in self.calls:
            if c[0] == "flash":
                _, shape, kvh, mb, kv_len = c
                kv = kv_len.cpu().numpy() if hasattr(kv_len, "cpu") \
                    else np.full(shape[0], kv_len)
                total += counts.paged_flash_least_s(shape, kvh, mb, kv)
            else:
                _, shape, kvh, mb, mask, merged = c
                m = mask.cpu().numpy()
                m = np.broadcast_to(m if m.ndim == 3 else m[None],
                                    (shape[0], shape[2], m.shape[-1]))
                total += counts.paged_tree_least_s(shape, kvh, mb, m, merged)
        return total


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def reduce(prof, timesteps: int) -> Optional[Dict]:
    """Device busy and window seconds, kernel launches, device seconds by
    kernel name, the paged kernels' device seconds and call counts, and idle
    seconds by the host span that was open (None without a window span)."""
    from torch.autograd import DeviceType
    window, host, device = None, [], []
    for e in prof.profiler.kineto_results.events():
        name, on_cpu = e.name(), e.device_type() == DeviceType.CPU
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if name.startswith("specbench."):
            # the host span, or its annotation on the device's timeline
            if not on_cpu:
                continue
            if name == WINDOW:
                window = (a, b)
            else:
                host.append((a, b, name[len("specbench."):]))
        elif e.device_type() == DeviceType.CUDA:
            kind = "copy" if name.startswith(("Memcpy", "Memset")) \
                else "kernel"
            device.append((a, b, name, kind))
    if window is None:
        return None
    w0, w1 = window
    inside = [(max(a, w0), min(b, w1), n, k) for a, b, n, k in device
              if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _, _ in inside])
    by_name: Dict[str, float] = collections.defaultdict(float)
    paged = {"flash": [0.0, 0], "tree": [0.0, 0]}
    for a, b, n, k in inside:
        by_name[n] += (b - a) / 1e9
        for key, frag in (("flash", PAGED_FLASH), ("tree", PAGED_TREE)):
            if frag in n:
                paged[key][0] += (b - a) / 1e9
                paged[key][1] += 1
    # idle gaps, each named by the innermost host span open at its middle
    idle: Dict[str, float] = collections.defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        open_ = [s for s in host if s[0] <= mid < s[1]]
        what = max(open_, key=lambda s: s[0])[2] if open_ else \
            "engine host code"
        idle[what] += (b - a) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "launches": sum(1 for *_, k in inside if k == "kernel"),
            "timesteps": timesteps,
            "paged_device_s": paged["flash"][0] + paged["tree"][0],
            "paged_kernels": paged["flash"][1] + paged["tree"][1],
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                                key=lambda x: -x[1])[:10]}
