"""The Engine parity tests of ``test_torch_engine.py`` on 2:4-packed
projections (every q/k/v/o and MLP weight an NMPack)."""

from test_torch_engine import (served,  # noqa: F401  (fixture)
                               test_cancel_frees_pages_and_emits_nothing_more,
                               test_engine_validates_requests,
                               test_greedy_transcripts_match_jax)

FORMAT = "nm"

__all__ = ["test_cancel_frees_pages_and_emits_nothing_more",
           "test_engine_validates_requests",
           "test_greedy_transcripts_match_jax"]
