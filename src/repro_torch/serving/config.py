"""Serving configuration: :class:`ServeConfig` plus its validation.

The JAX package's config, field for field, with the derived quantities
(``chunk_tokens``, ``request_pages``) the scheduler and the backends size
themselves through.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 8                  # concurrent sequences (batch)
    max_len: int = 1024             # cache capacity (logical, per slot)
    prompt_pad: int = 128           # prompts are padded to this length
    max_new_tokens: int = 64
    decode_chunk: int = 16          # on-device decode steps per host sync
    temperature: float = 0.0        # 0 → greedy (per-request overridable)
    eos_token: int = 1
    kv_mode: str = "auto"           # sharding of the KV cache
    seed: int = 0
    # --- paged KV cache (page_size > 0 switches the cache layout) ---
    page_size: int = 0              # KV rows per page; 0 → monolithic
    num_pages: int = 0              # allocatable pool pages; 0 → capacity
    page_view_chunk: int = 8        # decode view granularity in pages;
    #                                 0 → always attend the full table
    prompt_buckets: int = 0         # >0: pad each prompt to a multiple of
    #                                 this (≤ prompt_pad)
    # --- prefix sharing (requires the paged layout) ---
    prefix_cache: bool = False
    prefix_cache_pages: int = 0
    # --- fault tolerance ---
    max_queue: int = 0              # bounded admission FIFO (0 → unbounded)
    degraded_recover_chunks: int = 8
    # --- crash safety ---
    journal_path: str = ""
    # --- speculative decoding (spec_k > 0 switches the decode loop) ---
    spec_k: int = 0
    spec_draft: str = "self"

    @property
    def paged(self) -> bool:
        return self.page_size > 0

    @property
    def spec(self) -> bool:
        return self.spec_k > 0

    @property
    def chunk_tokens(self) -> int:
        """Upper bound on tokens a slot can emit per decode chunk."""
        return self.decode_chunk * (self.spec_k + 1)

    @property
    def max_pages(self) -> int:
        return -(-self.max_len // max(self.page_size, 1))

    @property
    def pool_pages(self) -> int:
        """Allocatable pages (excluding the reserved null page)."""
        if self.num_pages > 0:
            return self.num_pages
        return self.slots * self.max_pages

    def prompt_rows(self, prompt_len: int) -> int:
        """Cache rows a prompt occupies: the uniform ``prompt_pad``, or
        the request's own bucket when ``prompt_buckets`` is set."""
        if not self.prompt_buckets:
            return self.prompt_pad
        b = self.prompt_buckets
        return min(self.prompt_pad, -(-max(prompt_len, 1) // b) * b)

    def request_pages(self, prompt_len: int, max_new: int) -> int:
        """Worst-case pages a request can touch (its admission
        reservation)."""
        return self.rows_pages(self.prompt_rows(prompt_len), max_new)

    def rows_pages(self, rows: int, max_new: int) -> int:
        """``request_pages`` at an exact prefill width."""
        return -(-min(rows + max_new, self.max_len) // self.page_size)

    def validate(self) -> None:
        """Raise ``ValueError`` on configurations the engine cannot
        serve (checked once at engine construction)."""
        if self.slots <= 0:
            raise ValueError(f"slots must be positive, got {self.slots}")
        if self.max_len <= self.prompt_pad:
            raise ValueError(
                f"max_len={self.max_len} leaves no decode room past "
                f"prompt_pad={self.prompt_pad}")
        if self.decode_chunk <= 0:
            raise ValueError(
                f"decode_chunk must be positive, got {self.decode_chunk}")
        if self.prefix_cache and not self.paged:
            raise ValueError(
                "prefix_cache shares KV at page granularity and needs the "
                "paged layout — set page_size > 0")
        if self.prefix_cache_pages < 0:
            raise ValueError(
                f"prefix_cache_pages must be >= 0, got "
                f"{self.prefix_cache_pages}")
        if self.max_queue < 0:
            raise ValueError(
                f"max_queue must be >= 0 (0 = unbounded), got "
                f"{self.max_queue}")
        if self.degraded_recover_chunks < 0:
            raise ValueError(
                f"degraded_recover_chunks must be >= 0, got "
                f"{self.degraded_recover_chunks}")
        if self.spec:
            if self.prompt_pad + self.spec_k + 1 > self.max_len:
                raise ValueError(
                    f"spec_k={self.spec_k} needs max_len ≥ prompt_pad + "
                    f"spec_k + 1 (= {self.prompt_pad + self.spec_k + 1})")
            if self.spec_draft not in ("self", "pack"):
                raise ValueError(
                    f"unknown spec_draft {self.spec_draft!r} "
                    "(expected 'self' or 'pack')")
