"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``build/repro_torch_kernels/<name>-<hash>.so`` under the
repository root.  The hash covers the sources, the shared headers and the
compiler flags, so an edit rebuilds and an unchanged tree reuses the
library.  Nothing is built at import: the first launch builds what it
needs, and ``build`` compiles a set of kernels with one nvcc each, all
started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("flash_attention_lse", "tree_block_attention", "dequant_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Loaded launch functions by symbol.  A loaded shared library lives as
# long as the process, so this cache is process-wide by nature.  The lock
# makes the first use from several threads at once (the async executor's
# actors) build and load each library once.
_LAUNCHERS: Dict[str, ctypes._CFuncPtr] = {}
_LOAD_LOCK = threading.Lock()


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the shared library of kernel ``name`` lives once built."""
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(cand) if cand.exists() else None
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            "src/repro_torch/csrc at first use and need the CUDA toolkit "
            "(put nvcc on PATH or set CUDA_HOME)")
    return found


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every kernel of ``names`` whose library is missing, one nvcc
    process each, all running at once.  Returns nvcc's report (ptxas
    registers, shared memory, spills) by kernel name; raises with the
    compiler's output if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{text}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def launcher(name: str, argtypes: Sequence,
             symbol: str = "") -> ctypes._CFuncPtr:
    """The C launch function ``symbol`` (default ``<name>_launch``) of
    kernel source ``name``, built and loaded on first use.  It returns a
    ``cudaError_t``; 0 means the launch was accepted."""
    symbol = symbol or f"{name}_launch"
    fn = _LAUNCHERS.get(symbol)
    if fn is None:
        with _LOAD_LOCK:
            fn = _LAUNCHERS.get(symbol)
            if fn is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                fn = getattr(lib, symbol)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _LAUNCHERS[symbol] = fn
    return fn


# Each kernel's device scratch (partial sums and per-tile counters) by
# (kernel, device, stream).  It only grows, is never freed, and the
# counters are zero between calls (the kernels reset them), so a CUDA
# graph that captured a launch keeps valid buffers as long as no later
# call of the same kernel needs more; a kernel warmed up on the capture
# stream allocates nothing inside the capture.  Launches on one stream run
# in order and may share a scratch; launches on two streams may run at
# once (the async executor's stage actors), so each stream has its own.
_SCRATCH: Dict[tuple, tuple] = {}


def scratch(name: str, device, floats: int, ints: int):
    """(work fp32, counters int32) on ``device`` for kernel ``name`` on
    the current stream, with at least ``floats`` and ``ints`` elements;
    counters start at zero."""
    import torch
    key = (name, device.index if device.index is not None
           else torch.cuda.current_device(),
           torch.cuda.current_stream(device).cuda_stream)
    work, count = _SCRATCH.get(key, (None, None))
    if work is None or work.numel() < floats:
        work = torch.empty(max(floats, 1), dtype=torch.float32, device=device)
    if count is None or count.numel() < ints:
        count = torch.zeros(max(ints, 1), dtype=torch.int32, device=device)
    _SCRATCH[key] = (work, count)
    return work, count


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")
