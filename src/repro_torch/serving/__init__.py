"""Serving package of the port: the streaming :class:`Engine` over the
monolithic or paged KV cache."""

from repro_torch.serving.api import Engine, RequestHandle
from repro_torch.serving.backends import MonoBackend, PagedBackend
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.loops import (build_decode_loop,
                                       build_prefill_slot_step,
                                       build_prefill_wave_step)
from repro_torch.serving.state import (TERMINAL_STATUSES, EngineStats,
                                       Request, RequestStatus, TokenEvent,
                                       init_decode_state, sample_token_slots)

__all__ = [
    "Engine", "RequestHandle", "ServeConfig", "MonoBackend", "PagedBackend",
    "EngineStats", "Request", "RequestStatus", "TokenEvent",
    "TERMINAL_STATUSES", "init_decode_state", "sample_token_slots",
    "build_decode_loop", "build_prefill_slot_step", "build_prefill_wave_step",
]
