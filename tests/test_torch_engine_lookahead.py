"""The Engine parity tests of ``test_torch_engine.py`` on int7
lookahead-encoded packs on every q/k/v/o and MLP projection."""

from test_torch_engine import (served,  # noqa: F401  (fixture)
                               test_cancel_frees_pages_and_emits_nothing_more,
                               test_engine_validates_requests,
                               test_greedy_transcripts_match_jax)

FORMAT = "lookahead"

__all__ = ["test_cancel_frees_pages_and_emits_nothing_more",
           "test_engine_validates_requests",
           "test_greedy_transcripts_match_jax"]
