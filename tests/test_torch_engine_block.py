"""The Engine parity tests of ``test_torch_engine.py`` on block-skip (SSSA)
packs on every q/k/v/o and MLP projection."""

from test_torch_engine import (check_tile_zeroed_parity,
                               served,  # noqa: F401  (fixture)
                               test_cancel_frees_pages_and_emits_nothing_more,
                               test_engine_validates_requests,
                               test_greedy_transcripts_match_jax)

FORMAT = "block"

__all__ = ["test_cancel_frees_pages_and_emits_nothing_more",
           "test_engine_validates_requests",
           "test_greedy_transcripts_match_jax"]


def test_tile_zeroed_transcripts_match_jax():
    check_tile_zeroed_parity(FORMAT)
