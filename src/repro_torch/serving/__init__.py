"""Serving package of the port: the streaming :class:`Engine` over the
monolithic or paged KV cache, with prefix sharing on the paged one,
speculative decoding on both, and the fault layer (priorities,
deadlines, the bounded queue, preemption, the numeric guard, degraded
mode, fetch retry) with its chaos harness and audit, and crash safety:
the write-ahead journal, engine snapshot/restore and the supervisor that
restores a crashed or wedged engine."""

from repro_torch.serving.api import Engine, RequestHandle
from repro_torch.serving.backends import MonoBackend, PagedBackend
from repro_torch.serving.chaos import (AuditError, ChaosConfig,
                                       ChaosCrashError, ChaosMonkey,
                                       audit_engine)
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.journal import (Journal, Recovered, recover_engine,
                                         snapshot_engine)
from repro_torch.serving.loops import (DecodeChunk, build_decode_chunk,
                                       build_decode_loop, build_decode_step,
                                       build_prefill_slot_step,
                                       build_prefill_step,
                                       build_prefill_wave_step,
                                       build_prefix_fill_step,
                                       build_prefix_prefill_slot_step,
                                       build_spec_decode_chunk,
                                       build_spec_decode_loop)
from repro_torch.serving.prefix import PrefixHandle, PrefixIndex
from repro_torch.serving.state import (LEGAL_TRANSITIONS, TERMINAL_STATUSES,
                                       ChunkBuffers, EngineStats, Request,
                                       RequestStatus, TokenEvent,
                                       init_decode_state, sample_token_slots)
from repro_torch.serving.supervisor import Supervisor, SupervisorError

__all__ = [
    "Engine", "RequestHandle", "ServeConfig", "MonoBackend", "PagedBackend",
    "PrefixHandle", "PrefixIndex", "AuditError", "ChaosConfig",
    "ChaosCrashError", "ChaosMonkey", "audit_engine", "Journal",
    "Recovered", "recover_engine", "snapshot_engine", "Supervisor",
    "SupervisorError", "LEGAL_TRANSITIONS",
    "ChunkBuffers", "DecodeChunk", "EngineStats", "Request",
    "RequestStatus", "TokenEvent", "TERMINAL_STATUSES", "init_decode_state",
    "sample_token_slots", "build_decode_chunk",
    "build_decode_loop", "build_decode_step", "build_prefill_step",
    "build_prefill_slot_step", "build_prefill_wave_step",
    "build_prefix_prefill_slot_step", "build_prefix_fill_step",
    "build_spec_decode_chunk", "build_spec_decode_loop",
]
