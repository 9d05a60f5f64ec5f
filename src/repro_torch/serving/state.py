"""Per-request and per-slot serving state, and sampling.

``Request`` is the host-side record of one submission (with the fault
layer's fields: priority, deadline, faults, preemptions and the status
history the audit checks against :data:`LEGAL_TRANSITIONS`); the device-side
decode state is the 4-tensor dict of :func:`init_decode_state` that the
prefill steps and the decode loop update on the card between host
fetches.  :class:`ChunkBuffers` holds it with the chunk's other inputs
and outputs at fixed addresses, so a decode chunk captured as a CUDA
graph finds them where it was captured.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


class RequestStatus(enum.Enum):
    QUEUED = "queued"               # submitted, not yet in a slot
    RUNNING = "running"             # prefilled into a slot, decoding
    DONE = "done"                   # finished (EOS / budget / capacity)
    CANCELLED = "cancelled"         # cancel() took effect
    TIMED_OUT = "timed_out"         # deadline_ms elapsed (queued or live)
    PREEMPTED = "preempted"         # evicted from its slot, re-queued
    REJECTED = "rejected"           # the bounded admission queue was full
    FAILED = "failed"               # second numeric/device fault


#: States a request can never leave.  PREEMPTED is not terminal: a
#: preempted request sits back in the queue and re-admits.
TERMINAL_STATUSES = frozenset({
    RequestStatus.DONE, RequestStatus.CANCELLED, RequestStatus.TIMED_OUT,
    RequestStatus.REJECTED, RequestStatus.FAILED,
})

#: The request state machine: ``Engine.audit()`` checks every recorded
#: history against this map.
LEGAL_TRANSITIONS = {
    RequestStatus.QUEUED: {RequestStatus.RUNNING, RequestStatus.CANCELLED,
                           RequestStatus.TIMED_OUT, RequestStatus.REJECTED},
    RequestStatus.PREEMPTED: {RequestStatus.RUNNING,
                              RequestStatus.CANCELLED,
                              RequestStatus.TIMED_OUT},
    RequestStatus.RUNNING: {RequestStatus.DONE, RequestStatus.CANCELLED,
                            RequestStatus.TIMED_OUT,
                            RequestStatus.PREEMPTED, RequestStatus.FAILED},
    RequestStatus.DONE: set(), RequestStatus.CANCELLED: set(),
    RequestStatus.TIMED_OUT: set(), RequestStatus.REJECTED: set(),
    RequestStatus.FAILED: set(),
}

#: Empty ticks with nothing live and the queue blocked that ``Engine.run``
#: and ``RequestHandle.__iter__`` wait out before they call the engine
#: wedged: transient pool pressure, or a slot quarantined with nothing
#: else live, clears within a tick or two.
IDLE_TICKS = 8


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
    rows0: Optional[int] = None           # prompt rows at FIRST admission
    priority: int = 0                     # higher admits first, preempts
    deadline_ms: Optional[float] = None   # wall budget from arrival
    faults: int = 0                       # numeric/device faults charged
    preempts: int = 0                     # times evicted from a slot
    history: List[RequestStatus] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self.history.append(self.status)

    def set_status(self, status: RequestStatus) -> None:
        """Record a state transition (its legality is audited, not
        enforced: the engine never raises mid-tick)."""
        self.status = status
        self.history.append(status)

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token in seconds (queue wait + prefill + the
        first chunk), or ``None`` before any token arrived."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    # --- resumption (preempt / quarantine -> requeue) ------------------

    @property
    def eff_prompt(self) -> np.ndarray:
        """The prompt a re-admission prefills: the original prompt plus
        every token already emitted."""
        if not self.out:
            return self.prompt
        return np.concatenate([self.prompt, np.asarray(self.out, np.int32)])

    @property
    def remaining_new(self) -> int:
        """Token budget left after what was already emitted."""
        return self.max_new - len(self.out)

    @property
    def resume_rows(self) -> Optional[int]:
        """The exact prefill width of a re-admission: the first
        admission's rows plus one per emitted token.  No re-bucketing, so
        the padded layout (and any published prefix pages) line up and
        the greedy continuation stays on the original stream.  ``None``
        until first admitted."""
        if self.rows0 is None:
            return None
        return self.rows0 + len(self.out)

    def past_deadline(self, now: float) -> bool:
        """Past ``deadline_ms``, counted from the original arrival
        (preemption and resumption do not restart the clock)."""
        return (self.deadline_ms is not None
                and (now - self.arrival_s) * 1e3 >= self.deadline_ms)


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One emitted token, as returned by ``Engine.step()``."""
    uid: int
    token: int
    index: int                      # position in the request's output
    final: bool                     # last token of this request


def fresh_stats() -> Dict[str, Any]:
    return {"chunk_s": [], "chunk_tokens": [], "prefills": 0,
            "peak_pages": 0, "admission_waits": 0,
            "drafted": 0, "accepted": 0,
            "prefix_hits": 0, "shared_pages": 0, "cow_copies": 0,
            "timeouts": 0, "rejections": 0, "preemptions": 0,
            "numeric_faults": 0, "kernel_failures": 0, "fetch_errors": 0,
            "degraded_recoveries": 0, "restarts": 0,
            "chunk_runs": [], "graph_captures": []}


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Typed snapshot of the engine's serving counters."""
    chunk_s: List[float]            # wall seconds per decode chunk
    chunk_tokens: List[int]         # tokens emitted per decode chunk
    prefills: int                   # prompt prefills dispatched
    peak_pages: int                 # paged: pool high-water mark
    admission_waits: int            # paged: admissions deferred for pages
    drafted: int                    # spec: tokens drafted
    accepted: int                   # spec: drafted tokens accepted
    prefix_hits: int                # admissions that mapped shared pages
    shared_pages: int               # pages mapped read-only at admission
    cow_copies: int                 # copy-on-write page copies
    sync_count: int                 # device→host transfers
    cache_bytes: int                # allocated KV cache footprint
    acceptance_rate: float          # accepted / drafted (0 if no spec)
    chunk_runs: List[Tuple[Any, str]]   # per chunk: (program key, "eager"
    #                                     | "capture" | "replay" | "plain")
    graph_captures: List[Dict[str, Any]]  # per capture: key, capture_s,
    #                                       instantiate_s
    # --- fault tolerance ------------------------------------------------
    timeouts: int = 0               # requests past deadline_ms
    rejections: int = 0             # bounced off the bounded queue
    preemptions: int = 0            # slots evicted for a higher priority
    numeric_faults: int = 0         # non-finite fetched blocks (per slot)
    kernel_failures: int = 0        # decode chunk raised, plain retry
    fetch_errors: int = 0           # device->host fetch attempts that raised
    degraded: bool = False          # the engine runs the plain versions
    degraded_recoveries: int = 0    # degraded -> kernels again
    restarts: int = 0               # supervised crash/hang restorations


def init_decode_state(slots: int, device) -> Dict[str, torch.Tensor]:
    """All-free decode state: every slot done, no budget, pos 0."""
    return {"tok": torch.zeros(slots, dtype=torch.int32, device=device),
            "pos": torch.zeros(slots, dtype=torch.int32, device=device),
            "done": torch.ones(slots, dtype=torch.bool, device=device),
            "left": torch.zeros(slots, dtype=torch.int32, device=device)}


class ChunkBuffers:
    """The fixed set of device tensors a decode chunk reads and writes.

    ``state`` (the decode state ``tok/pos/done/left``), ``temps (slots,)``,
    the paged layout's ``ptab (slots, max_pages)``, the output blocks
    ``tokens``/``emitted (rows, slots)`` — ``rows`` is
    ``ServeConfig.chunk_tokens``, ``decode_chunk * (spec_k + 1)`` — and
    ``tally (2,)``, the chunk's drafted and accepted tokens (zero without
    speculation).  An engine allocates them once; the prefill steps,
    cancellations and chunks write into them in place, never rebinding a
    tensor.  :meth:`stage` copies the host's temperatures and page table
    in before a chunk — on the card through pinned host buffers, outside
    any captured region; :meth:`fetch` is the chunk's one transfer
    back."""

    def __init__(self, slots: int, rows: int, max_pages: int, device):
        dev = torch.device(device)
        self.state = init_decode_state(slots, dev)
        self.temps = torch.zeros(slots, dtype=torch.float32, device=dev)
        self.tokens = torch.zeros((rows, slots), dtype=torch.int32,
                                  device=dev)
        self.emitted = torch.zeros((rows, slots), dtype=torch.bool,
                                   device=dev)
        self.tally = torch.zeros(2, dtype=torch.int32, device=dev)
        self.ptab = (torch.zeros((slots, max_pages), dtype=torch.int32,
                                 device=dev) if max_pages else None)
        pin = dev.type == "cuda"
        self._host = {name: torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True)
                      for name, t in (("temps", self.temps),
                                      ("ptab", self.ptab))
                      if pin and t is not None}
        self._staged: Optional[torch.cuda.Event] = None

    def stage(self, temps: np.ndarray,
              ptab: Optional[np.ndarray] = None) -> None:
        """Copy ``temps (slots,)`` and ``ptab (slots, max_pages)`` (when
        given) from the host into their buffers, in stream order.  On the
        card the rows go through pinned memory without a wait; the next
        call first waits for this one's copies to have read them."""
        pairs = [("temps", self.temps, temps)]
        if ptab is not None:
            pairs.append(("ptab", self.ptab, ptab))
        if not self._host:
            for _, dst, src in pairs:
                dst.copy_(torch.from_numpy(src))
            return
        if self._staged is not None:
            self._staged.synchronize()
        for name, dst, src in pairs:
            host = self._host[name]
            host.numpy()[...] = src
            dst.copy_(host, non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record()

    def fetch(self, transfer: Optional[Callable[[torch.Tensor],
                                                 np.ndarray]] = None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """The chunk's one device→host transfer: ``(tokens, emitted, done,
        tally)`` as host arrays, moved by ``transfer`` (default
        :func:`_device_fetch`)."""
        rows, slots = self.tokens.shape
        packed = torch.cat([self.tokens.flatten(),
                            self.emitted.flatten().to(torch.int32),
                            self.state["done"].to(torch.int32), self.tally])
        host = (transfer or _device_fetch)(packed)
        n = rows * slots
        return (host[:n].reshape(rows, slots),
                host[n:2 * n].reshape(rows, slots) != 0,
                host[2 * n:2 * n + slots] != 0, host[2 * n + slots:])


def _device_fetch(t: torch.Tensor) -> np.ndarray:
    """The engine's single device→host transfer point: every chunk's
    tokens come back through here (resolved through the deprecated
    ``repro_torch.serving.engine`` module while it is imported, so a
    test that patches ``engine._device_fetch`` counts every sync)."""
    return t.cpu().numpy()


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
    def slot(self) -> Optional[int]:
        """The slot the request was admitted into (``None`` while
        queued)."""
        return self._req.slot

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
        i = stalls = 0
        while True:
            out = self._req.out
            while i < len(out):
                yield out[i]
                i += 1
            if self.done:
                return
            events = self._engine.step()
            if (not events and not self.done
                    and self._req.status in (RequestStatus.QUEUED,
                                             RequestStatus.PREEMPTED)
                    and not self._engine.num_live):
                stalls += 1
                if stalls > IDLE_TICKS:
                    raise RuntimeError(
                        f"engine made no progress on request {self.uid} "
                        "(queued, no live slots, empty tick)")
            else:
                stalls = 0

    def __repr__(self) -> str:
        return (f"RequestHandle(uid={self.uid}, "
                f"status={self._req.status.value}, "
                f"tokens={len(self._req.out)})")
