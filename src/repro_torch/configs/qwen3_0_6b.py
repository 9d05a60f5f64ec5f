"""qwen3-0.6b [dense] — hf:Qwen/Qwen3 family.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936; qk-norm (the
qwen3 signature), head_dim=128 (explicit — not d_model/n_heads).
"""

import dataclasses

from repro_torch.core.sparse_linear import SparsityConfig
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        n_layers=28, d_model=1024, vocab_size=151936,
        n_heads=16, n_kv_heads=8, head_dim=128, d_ff=3072,
        qk_norm=True, rope_theta=1_000_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b-smoke",
        n_layers=2, d_model=64, vocab_size=1024,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128,
        qk_norm=True, remat=False,
    )


def sparse() -> ModelConfig:
    """The repo's sparse-packed qwen3: 2:4 with g = 128 on all seven
    projections."""
    return dataclasses.replace(
        config(),
        mlp_sparsity=SparsityConfig(format="nm", n=2, m=4, block_n=128),
        attn_sparsity=SparsityConfig(format="nm", n=2, m=4, block_n=128))
