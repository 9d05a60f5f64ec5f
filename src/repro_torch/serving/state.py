"""Per-request and per-slot serving state, and sampling.

``Request`` is the host-side record of one submission; the device-side
decode state is the 4-tensor dict of :func:`init_decode_state` that the
prefill steps and the decode loop update on the card between host
fetches.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch


class RequestStatus(enum.Enum):
    QUEUED = "queued"               # submitted, not yet in a slot
    RUNNING = "running"             # prefilled into a slot, decoding
    DONE = "done"                   # finished (EOS / budget / capacity)
    CANCELLED = "cancelled"         # cancel() took effect


#: States a request can never leave.
TERMINAL_STATUSES = frozenset({RequestStatus.DONE, RequestStatus.CANCELLED})


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (L,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: RequestStatus = RequestStatus.QUEUED
    temperature: Optional[float] = None   # None → ServeConfig.temperature
    stream: bool = False
    cancel_requested: bool = False
    slot: Optional[int] = None            # slot while RUNNING
    arrival_s: float = dataclasses.field(default_factory=time.perf_counter)
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    rows0: Optional[int] = None           # prompt rows at admission

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token in seconds (queue wait + prefill + the
        first chunk), or ``None`` before any token arrived."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One emitted token, as returned by ``Engine.step()``."""
    uid: int
    token: int
    index: int                      # position in the request's output
    final: bool                     # last token of this request


def fresh_stats() -> Dict[str, Any]:
    return {"chunk_s": [], "chunk_tokens": [], "prefills": 0,
            "peak_pages": 0, "admission_waits": 0}


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Typed snapshot of the engine's serving counters."""
    chunk_s: List[float]            # wall seconds per decode chunk
    chunk_tokens: List[int]         # tokens emitted per decode chunk
    prefills: int                   # prompt prefills dispatched
    peak_pages: int                 # paged: pool high-water mark
    admission_waits: int            # paged: admissions deferred for pages
    sync_count: int                 # device→host transfers
    cache_bytes: int                # allocated KV cache footprint


def init_decode_state(slots: int, device) -> Dict[str, torch.Tensor]:
    """All-free decode state: every slot done, no budget, pos 0."""
    return {"tok": torch.zeros(slots, dtype=torch.int32, device=device),
            "pos": torch.zeros(slots, dtype=torch.int32, device=device),
            "done": torch.ones(slots, dtype=torch.bool, device=device),
            "left": torch.zeros(slots, dtype=torch.int32, device=device)}


def sample_token_slots(logits: torch.Tensor, temps: torch.Tensor,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """``(B, V) → (B,)`` int32 with a per-slot temperature vector.

    Slots with ``temps[i] <= 0`` take the argmax (greedy); the others draw
    from their tempered distribution by the Gumbel-max rule with noise
    from ``generator`` (on the card, no host sync).  ``generator=None``
    means every slot is greedy."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        return greedy
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    t = temps.clamp_min(1e-6)[:, None]
    sampled = torch.argmax(logits.float() / t + gumbel, dim=-1)
    return torch.where(temps > 0, sampled.to(torch.int32), greedy)


class RequestHandle:
    """Caller-side view of one submitted request.  Iterating the handle
    yields its tokens in emission order, calling ``engine.step()``
    whenever the buffered stream runs dry."""

    def __init__(self, engine: Any, req: Request):
        self._engine = engine
        self._req = req

    @property
    def uid(self) -> int:
        return self._req.uid

    @property
    def status(self) -> RequestStatus:
        return self._req.status

    @property
    def done(self) -> bool:
        return self._req.status in TERMINAL_STATUSES

    @property
    def tokens(self) -> List[int]:
        """Tokens emitted so far (a copy)."""
        return list(self._req.out)

    @property
    def ttft_s(self) -> Optional[float]:
        return self._req.ttft_s

    def cancel(self) -> None:
        self._engine.cancel(self)

    def result(self) -> List[int]:
        """Drive the engine until this request finishes; returns its
        full output."""
        for _ in self:
            pass
        return self.tokens

    def __iter__(self) -> Iterator[int]:
        i = 0
        while True:
            out = self._req.out
            while i < len(out):
                yield out[i]
                i += 1
            if self.done:
                return
            if not self._engine.step() and not self._engine.num_live \
                    and self._req.status == RequestStatus.QUEUED:
                raise RuntimeError(
                    f"engine made no progress on request {self.uid} "
                    "(queued, no live slots, empty tick)")

    def __repr__(self) -> str:
        return (f"RequestHandle(uid={self.uid}, "
                f"status={self._req.status.value}, "
                f"tokens={len(self._req.out)})")
