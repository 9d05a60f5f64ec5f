"""gemma2-27b [dense] — arXiv:2408.00118.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; 1:1
local:global alternation (window 4096), attention logit softcap 50,
final logit softcap 30, post-norms, scaled embeds, head_dim=128.
"""

import dataclasses

from repro_torch.core.sparse_linear import SparsityConfig
from repro_torch.models.config import ModelConfig, interleave_kinds


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        n_layers=46, d_model=4608, vocab_size=256000,
        n_heads=32, n_kv_heads=16, head_dim=128, d_ff=36864,
        layer_kinds=interleave_kinds(46, 1, 1),
        window_size=4096,
        attn_softcap=50.0, final_softcap=30.0,
        embed_scale=True, post_norm=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b-smoke",
        n_layers=2, d_model=64, vocab_size=1024,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128,
        layer_kinds=interleave_kinds(2, 1, 1),
        window_size=16,
        attn_softcap=50.0, final_softcap=30.0,
        embed_scale=True, post_norm=True, remat=False,
    )


def sparse() -> ModelConfig:
    """The repo's sparse-packed gemma2: 2:4 with g = 128 on the MLP."""
    return dataclasses.replace(
        config(),
        mlp_sparsity=SparsityConfig(format="nm", n=2, m=4, block_n=128))
