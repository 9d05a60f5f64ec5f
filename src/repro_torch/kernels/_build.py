"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``
— no PyTorch headers, so a build takes seconds.  The libraries go to
``build/repro_torch/`` at the root of the checkout, named by a hash of
the sources and flags, so a changed source rebuilds and an unchanged one
loads at once.  :func:`build_all` starts one ``nvcc`` per source, all at
the same time; the first kernel call builds whatever is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("nm_spmm", "paged_attention", "flash_attention", "bsr_matmul",
           "csa_matmul", "lookahead_decode")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

#: Receivers of the meta route's costs, ``sink(kernel, cost)``:
#: ``launch.analysis`` adds one while it counts a step.
COST_SINKS: List[Callable[[str, dict], None]] = []
#: Above 0 while a wrapper's meta route builds its output: the ops it
#: issues are the kernel's, whose work its ``cost`` already reported.
META_DEPTH = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel (one ``nvcc`` each).

    Returns ``{name: ptxas report}`` for what was built.  Raises with
    the compiler's output when a build fails."""
    todo = [(n, _lib_path(n)) for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs: List[tuple] = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed = {}, []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            failed.append(f"--- {name} (exit {p.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a non-zero ``cudaGetLastError``."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would track any of ``tensors``: the kernels have
    no backward, and a launch through ``ctypes`` would silently cut the
    graph (the grads would come back as zero).  Training runs the plain
    cache-less route, which reaches no kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: an input requires grad, and the kernel "
                           "has no backward (train through the cache-less "
                           "forward)")


def on_meta(name: str, cost: dict, make: Callable[[], torch.Tensor],
            *tensors: torch.Tensor) -> torch.Tensor:
    """The shape-only route of a kernel wrapper on ``meta`` tensors: report
    the call's ``cost`` (``{"flops", "bytes"}``) to every sink and return
    ``make()``, the output's shape on ``meta``; no arithmetic runs.  Every
    operand must lie on ``meta`` too."""
    global META_DEPTH
    if any(t.device.type != "meta" for t in tensors):
        raise ValueError(f"{name}: unsupported device mix: a meta tensor "
                         "with operands on " + ", ".join(
                             sorted({str(t.device) for t in tensors})))
    for sink in COST_SINKS:
        sink(name, cost)
    META_DEPTH += 1
    try:
        return make()
    finally:
        META_DEPTH -= 1


def smem_bytes(name: str, symbol: str, *args: int) -> int:
    """Call the ``extern "C" int <symbol>(int...)`` of ``csrc/<name>.cu``
    that reports the dynamic shared memory per block its launcher passes
    for these arguments; raise if it lists no such tile."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_int
    got = fn(*args)
    if got < 0:
        raise ValueError(f"{symbol}{args}: the launcher lists no such tile")
    return got
