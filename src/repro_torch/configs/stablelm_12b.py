"""stablelm-12b [dense] — hf:stabilityai/stablelm-2-12b family.

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352; an untied
output head.  No explicit head_dim, so it is d_model / n_heads = 160.
As the JAX package declares it: RMSNorm and full rotary.
"""

import dataclasses

from repro_torch.core.sparse_linear import SparsityConfig
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        n_layers=40, d_model=5120, vocab_size=100352,
        n_heads=32, n_kv_heads=8, d_ff=13824,
        tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b-smoke",
        n_layers=2, d_model=64, vocab_size=1024,
        n_heads=4, n_kv_heads=2, d_ff=128,
        tie_embeddings=False, remat=False,
    )


def sparse() -> ModelConfig:
    """The repo's sparse-packed stablelm: 2:4 with g = 128 on all seven
    projections."""
    return dataclasses.replace(
        config(),
        mlp_sparsity=SparsityConfig(format="nm", n=2, m=4, block_n=128),
        attn_sparsity=SparsityConfig(format="nm", n=2, m=4, block_n=128))
