"""gemma3-1b [dense] — hf:google/gemma-3-1b-pt.

26L d_model=1152 4H (MQA kv=1) d_ff=6912 vocab=262144; 5:1 local:global
layer pattern (window 512), head_dim=256, qk-norm, embeds scaled by
√d_model, post-norms (gemma house style).
"""

import dataclasses

from repro_torch.core.sparse_linear import SparsityConfig
from repro_torch.models.config import ModelConfig, interleave_kinds


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        n_layers=26, d_model=1152, vocab_size=262144,
        n_heads=4, n_kv_heads=1, head_dim=256, d_ff=6912,
        layer_kinds=interleave_kinds(26, 5, 1),
        window_size=512, qk_norm=True,
        embed_scale=True, post_norm=True,
        rope_theta=1_000_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b-smoke",
        n_layers=3, d_model=64, vocab_size=1024,
        n_heads=4, n_kv_heads=1, head_dim=32, d_ff=128,
        layer_kinds=interleave_kinds(3, 2, 1),
        window_size=16, qk_norm=True,
        embed_scale=True, post_norm=True, remat=False,
    )


def sparse() -> ModelConfig:
    """The repo's sparse-packed gemma3: 2:4 with g = 128 on the MLP."""
    return dataclasses.replace(
        config(),
        mlp_sparsity=SparsityConfig(format="nm", n=2, m=4, block_n=128))
