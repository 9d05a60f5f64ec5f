"""Fault-tolerant checkpointing: atomic, digested, async — the JAX
package's ``checkpoint/store.py`` for the port's trees.

Layout (one directory per step):

  <dir>/step_000000042/
    manifest.json      {step, meta, arrays: {path: shape, dtype, sha256}}
    arrays.npz         the tree's leaves by '/'-joined path
  <dir>/LATEST         text file: "step_000000042"  (atomic rename target)

Guarantees:
  * **Atomicity**: write to ``<name>.tmp``, fsync, ``os.replace`` — a
    crash mid-write never corrupts LATEST or a finished step.
  * **Integrity**: sha256 digest per array (computed in threads),
    verified on load; a corrupt or incomplete step is skipped and the
    previous one restored.
  * **Async**: ``CheckpointManager.save(..., blocking=False)`` copies the
    tensors to the host, then hands them to a writer thread; ``wait()``
    joins it and raises what it raised, ``check()`` raises without
    joining.
  * **Retention**: the ``keep`` most recent steps are kept.
  * **bfloat16**: numpy has no bfloat16, so a bf16 leaf is stored as
    its ``uint16`` bits, its dtype named in the manifest; the digest is
    over the stored bytes.

Leaves are tensors (any device) or numpy arrays; ``None`` leaves (a mask
tree's dense entries) are not stored and come back as ``None``.
Restoring onto another mesh comes with tensor parallelism (ROADMAP queue
1 item 13).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import unflatten, with_paths

#: what a damaged or incomplete step raises on load
LOAD_ERRORS = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """(the array as stored, its dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)   # later writes can't reach it
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _dtype_name(t.dtype)
    a = np.asarray(leaf)
    return a, a.dtype.name


def _to_host(tree: Any) -> Dict[str, Tuple[np.ndarray, str]]:
    return {k: _host(v) for k, v in with_paths(tree) if v is not None}


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).data).hexdigest()


def _digests(arrays: Dict[str, np.ndarray]) -> Dict[str, str]:
    """sha256 of every array, in threads (``hashlib`` releases the GIL
    on large buffers)."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return dict(zip(arrays, pool.map(_digest, arrays.values())))


def _write(directory: str, step: int, flat: Dict[str, Tuple[np.ndarray, str]],
           meta: Optional[dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    final = os.path.join(directory, name)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: a for k, (a, _) in flat.items()})
    digests = _digests({k: a for k, (a, _) in flat.items()})
    manifest = {
        "step": step,
        "meta": meta or {},
        "arrays": {k: {"shape": list(a.shape), "dtype": dt,
                       "sha256": digests[k]} for k, (a, dt) in flat.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)

    latest_tmp = os.path.join(directory, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    return final


def save_checkpoint(directory: str, step: int, tree: Any,
                    meta: Optional[dict] = None) -> str:
    """Write one atomic checkpoint; returns the step directory."""
    return _write(directory, step, _to_host(tree), meta)


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load_checkpoint(step_dir: str, verify: bool = True
                    ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Load one step → (CPU tensors by path, manifest), each array's
    digest verified."""
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(step_dir, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    arrays = manifest["arrays"]
    if verify:
        got = _digests({k: flat[k] for k in arrays})
        for k, info in arrays.items():
            if got[k] != info["sha256"]:
                raise IOError(f"digest mismatch for {k!r} in {step_dir}")
    return {k: _tensor(a, arrays[k]["dtype"]) for k, a in flat.items()}, \
        manifest


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(d for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def restore_latest(directory: str, template: Any, device=None
                   ) -> Optional[Tuple[Any, int]]:
    """Restore the newest valid checkpoint into ``template``'s tree.

    Walks backwards over steps, so one damaged checkpoint does not brick
    the run.  Each leaf takes the template leaf's dtype and goes to
    ``device`` (default: stays on the CPU); a ``None`` template leaf
    stays ``None``.  Returns ``(tree, step)``, or ``None`` when no valid
    checkpoint exists."""
    for name in reversed(_steps(directory)):
        try:
            flat, manifest = load_checkpoint(os.path.join(directory, name))
        except LOAD_ERRORS:
            continue
        out = []
        for key, leaf in with_paths(template):
            if leaf is None:
                out.append(None)
                continue
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = flat[key]
            want = getattr(leaf, "dtype", None)
            if isinstance(want, torch.dtype) and t.dtype != want:
                t = t.to(want)
            out.append(t if device is None else t.to(device))
        return unflatten(template, out), int(manifest["step"])
    return None


class CheckpointManager:
    """Async, retention-managed checkpoint writer.  ``timings`` records,
    per save, the seconds the caller was stalled (the copy to the host)
    and the seconds until the write finished."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.timings: list = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, meta: Optional[dict] = None,
             blocking: bool = False) -> None:
        self.wait()                       # one in-flight write at a time
        t0 = time.perf_counter()
        flat = _to_host(tree)             # transfer now
        stall = time.perf_counter() - t0
        record = {"step": step, "stall_s": stall}
        self.timings.append(record)

        def work():
            try:
                _write(self.directory, step, flat, meta)
                self._gc()
                record["total_s"] = time.perf_counter() - t0
            except BaseException as e:     # surfaced on the next wait()
                self._error = e

        if blocking:
            work()
            self.check()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.check()

    def check(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, template: Any, device=None):
        self.wait()
        return restore_latest(self.directory, template, device)

    def _gc(self) -> None:
        steps = _steps(self.directory)
        for name in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)
