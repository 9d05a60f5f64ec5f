"""The autotune cache of the port: dispatch key → the launch plan that ran
fastest on the card.

A key is ``kernel|M<M>|K<K>|N<N>|<dtype>|<pattern>|<arch>``: the kernel,
the rows of ``x``, the weight's (or paged view's) geometry, the dtype,
the sparsity pattern (``kernels.dispatch.SparsityDescriptor.pattern``)
and the target, ``sm90`` for the hand-written kernels (the plain
version's rows, swept on the CPU, carry ``ref``).  A value is the full
launch plan (``kernels/tiling.py``'s dict) plus the sweep's timings:
``us`` of the winner, ``rule_us`` of the tiling rule's plan and the
number of ``skipped`` candidates.

The wrappers consult it on every launch (:func:`resolve`): a hit runs
the cached plan, a miss the tiling rule.  Nothing here sweeps: sweeps
happen in ``dispatch.tune``, ``dispatch.select(autotune=True)`` and
``benchmarks.warm_autotune`` only.  The file is
``REPRO_TORCH_AUTOTUNE_CACHE`` or ``~/.cache/repro_torch/autotune.json``;
a corrupt or partly written file is ignored with one warning and rebuilt
by the next ``put``, as the JAX package's cache is.
"""

from __future__ import annotations

import json
import os
import threading
import warnings
from typing import Callable, Dict, Optional, Tuple

ARCH = "sm90"
#: Fields of a cache entry that describe the sweep, not the plan.
SWEEP_FIELDS = ("us", "rule_us", "skipped")


def default_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "autotune.json"))


class AutotuneCache:
    """Persistent map: dispatch key → ``{plan fields..., "us": ...}``.

    Loaded on first use; every ``put`` rewrites the file (one entry per
    distinct geometry).  A corrupt file (truncated JSON from a killed
    process, or valid JSON that is not an object of objects) never takes
    dispatch down: it is ignored with one warning and rebuilt by the next
    ``put``.  ``version`` counts the changes, so lookups memoized against
    it see every ``put`` and ``clear``."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_path()
        self._data: Optional[Dict[str, dict]] = None
        self._lock = threading.Lock()
        self._warned = False
        self.version = 0

    def _warn_corrupt(self, why: str) -> None:
        if not self._warned:
            self._warned = True
            warnings.warn(
                f"ignoring corrupt autotune cache {self.path!r} ({why}); "
                "it will be rebuilt on the next sweep",
                RuntimeWarning, stacklevel=3)

    def _load(self) -> Dict[str, dict]:
        if self._data is None:
            try:
                with open(self.path) as f:
                    data = json.load(f)
            except OSError:
                data = {}
            except ValueError as e:           # truncated / invalid JSON
                self._warn_corrupt(str(e))
                data = {}
            if not isinstance(data, dict):
                self._warn_corrupt(
                    f"top level is {type(data).__name__}, expected object")
                data = {}
            elif any(not isinstance(v, dict) for v in data.values()):
                self._warn_corrupt("non-object entries dropped")
                data = {k: v for k, v in data.items()
                        if isinstance(v, dict)}
            self._data = data
        return self._data

    def get(self, key: str) -> Optional[dict]:
        return self._load().get(key)

    def put(self, key: str, value: dict) -> None:
        with self._lock:
            data = self._load()
            data[key] = value
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
            self.version += 1

    def clear(self) -> None:
        with self._lock:
            self._data = {}
            self.version += 1
            try:
                os.remove(self.path)
            except OSError:
                pass

    def keys(self):
        return list(self._load())

    def __len__(self) -> int:
        return len(self._load())


_CACHE = AutotuneCache()


def autotune_cache() -> AutotuneCache:
    """The process-global cache (tests swap it with
    :func:`set_autotune_cache`)."""
    return _CACHE


def set_autotune_cache(cache: AutotuneCache) -> AutotuneCache:
    global _CACHE
    old, _CACHE = _CACHE, cache
    _memo.clear()
    return old


def dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def key(kernel: str, M: int, K: int, N: int, dtype: str, pattern: str,
        arch: str = ARCH) -> str:
    return f"{kernel}|M{M}|K{K}|N{N}|{dtype}|{pattern}|{arch}"


def plan_of(entry: dict) -> dict:
    """The launch plan of a cache entry (its sweep fields dropped); the
    JSON lists of a plan (its ``grid``) come back as tuples."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in entry.items() if k not in SWEEP_FIELDS}


#: cache key → launches that ran its cached plan since the last clear.
hits: Dict[str, int] = {}
#: (kernel, M, K, N, dtype, pattern) → (key, cached plan or None), valid
#: for ``_memo_of`` = (cache, version)
_memo: Dict[Tuple, Tuple[str, Optional[dict]]] = {}
_memo_of: list = [None, -1]


def lookup(kernel: str, M: int, K: int, N: int, dtype: str,
           pattern: str) -> Tuple[str, Optional[dict]]:
    """``(key, cached plan)`` of a launch on the card, the plan ``None`` on
    a miss; memoized until the cache changes."""
    if _memo_of[0] is not _CACHE or _memo_of[1] != _CACHE.version:
        _memo.clear()
        _memo_of[:] = [_CACHE, _CACHE.version]
    sig = (kernel, M, K, N, dtype, pattern)
    got = _memo.get(sig)
    if got is None:
        k = key(kernel, M, K, N, dtype, pattern)
        entry = _CACHE.get(k)
        got = _memo[sig] = (k, None if entry is None else plan_of(entry))
    return got


def resolve(kernel: str, M: int, K: int, N: int, dtype: str, pattern: str,
            rule: Callable[[], dict], plan: Optional[dict] = None) -> dict:
    """The plan a wrapper launches: ``plan`` when the caller gives one (a
    sweep's candidate), else the cached plan of this key (counted in
    :data:`hits`), else the tiling rule's."""
    if plan is not None:
        return plan
    k, cached = lookup(kernel, M, K, N, dtype, pattern)
    if cached is None:
        return rule()
    hits[k] = hits.get(k, 0) + 1
    return cached
