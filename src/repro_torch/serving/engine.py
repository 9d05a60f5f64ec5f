"""Deprecated v1 serving surface of the port — thin shims over the v2
package, as the JAX package's ``serving/engine.py``.

  * :class:`Server` — delegates every call to an :class:`Engine`; the same
    greedy outputs, stats and plan attributes, the same ``submit() →
    uid`` / ``run() → finished`` contract.
  * the old loop-builder names — wrappers over ``serving.loops`` that pin
    the temperature the v2 builders take per request.
  * ``_device_fetch`` — still the single device→host transfer point:
    while this module is imported the v2 engine resolves its fetch
    through THIS module's attribute, so tests that patch
    ``engine._device_fetch`` count every sync (processes that never
    import the shim use ``state._device_fetch``).

New code uses :class:`repro_torch.serving.Engine` directly.  Importing
this module emits one ``DeprecationWarning`` per process.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, List, Optional

import numpy as np
import torch

warnings.warn(
    "repro_torch.serving.engine is the deprecated v1 serving surface; use "
    "repro_torch.serving.Engine (submit()/step()/run() with streaming "
    "handles).  This import warns once per process.",
    DeprecationWarning, stacklevel=2)

from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import loops  # noqa: E402
from repro_torch.serving.api import Engine  # noqa: E402
from repro_torch.serving.config import ServeConfig  # noqa: E402
from repro_torch.serving.loops import (build_decode_step,  # noqa: E402
                                       build_prefill_step,
                                       build_spec_decode_loop)
from repro_torch.serving.state import (Request, _device_fetch,  # noqa: E402
                                       init_decode_state, sample_token_slots)

__all__ = [
    "Engine", "Request", "ServeConfig", "Server", "_device_fetch",
    "build_decode_loop", "build_decode_step", "build_paged_decode_loop",
    "build_paged_prefill_slot_step", "build_prefill_slot_step",
    "build_prefill_step", "build_prefill_wave_step",
    "build_spec_decode_loop", "init_decode_state", "sample_token_slots",
]


def build_prefill_slot_step(cfg: ModelConfig, scfg: ServeConfig) -> Callable:
    """v1 signature: (params, tokens, cache, state, slot, budget,
    generator) → (cache, state); temperature pinned to
    ``scfg.temperature``."""
    inner = loops.build_prefill_slot_step(cfg, scfg)

    def step(params, tokens, cache, state, slot, budget, generator):
        return inner(params, tokens, cache, state, slot, budget,
                     scfg.temperature, generator)
    return step


def build_paged_prefill_slot_step(cfg: ModelConfig, scfg: ServeConfig,
                                  prompt_rows: int) -> Callable:
    """v1 signature: (params, tokens, cache, state, slot, budget,
    generator, page_row) → (cache, state)."""
    inner = loops.build_prefill_slot_step(cfg, scfg, prompt_rows=prompt_rows,
                                          paged=True)

    def step(params, tokens, cache, state, slot, budget, generator,
             page_row):
        return inner(params, tokens, cache, state, slot, budget,
                     scfg.temperature, generator, page_row)
    return step


def _temps(scfg: ServeConfig, device) -> torch.Tensor:
    return torch.full((scfg.slots,), scfg.temperature, dtype=torch.float32,
                      device=device)


def build_prefill_wave_step(cfg: ModelConfig, scfg: ServeConfig) -> Callable:
    """v1 signature: (params, tokens, cache, state, valid, budgets,
    generator) → (cache, state)."""
    inner = loops.build_prefill_wave_step(cfg, scfg)

    def step(params, tokens, cache, state, valid: np.ndarray,
             budgets: np.ndarray, generator):
        return inner(params, tokens, cache, state, valid, budgets,
                     _temps(scfg, tokens.device), generator)
    return step


def build_decode_loop(cfg: ModelConfig, scfg: ServeConfig) -> Callable:
    """v1 signature: (params, cache, state, generator) → (cache, state,
    tokens, emitted)."""
    inner = loops.build_decode_loop(cfg, scfg)

    def loop(params, cache, state, generator):
        return inner(params, cache, state,
                     _temps(scfg, state["tok"].device), generator)
    return loop


def build_paged_decode_loop(cfg: ModelConfig, scfg: ServeConfig,
                            view_pages: Optional[int] = None) -> Callable:
    """v1 signature: (params, cache, state, generator, ptab) → (cache,
    state, tokens, emitted)."""
    inner = loops.build_decode_loop(cfg, scfg, paged=True,
                                    view_pages=view_pages)

    def loop(params, cache, state, generator, ptab):
        return inner(params, cache, state,
                     _temps(scfg, state["tok"].device), generator, ptab)
    return loop


class Server:
    """Deprecated batch-style front end: ``submit()`` then ``run()``.

    Every call delegates to a v2 :class:`Engine` (``device`` as the
    engine's: the card by default); prefer ``Engine``, which also streams
    tokens, admits mid-run and cancels."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params: Any,
                 draft_params: Any = None, *, device="cuda"):
        # the deprecation warning fires once per process at import
        self.engine = Engine(cfg, scfg, params, draft_params=draft_params,
                             device=device)

    def submit(self, prompt, max_new: Optional[int] = None) -> int:
        return self.engine.submit(prompt, max_new=max_new).uid

    def run(self) -> List[Request]:
        return self.engine.run()

    # --- paged-allocator introspection (tests poke these) -------------

    @property
    def _free_pages(self) -> List[int]:
        return self.engine._backend.free_pages

    @property
    def _ptab(self):
        return self.engine._backend.ptab

    def __getattr__(self, name: str):
        # everything else (scfg, stats, sync_count, plans, queue,
        # finished, reset_stats, acceptance_rate, …) is the engine's
        if name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)
