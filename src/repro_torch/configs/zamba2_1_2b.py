"""zamba2-1.2b [hybrid] — arXiv:2411.15242.

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64; a
Mamba-2 trunk with the globally *shared* attention block applied before
layers 3, 9, 15, 21, 27 and 33 (``zamba_kinds(38, 6)``; the per-invocation
LoRA deltas omitted, as in the JAX config).  ``sparse()`` packs
``out_proj`` and the shared MLP 2:4 with g = 128; ``in_proj`` (N = 8384)
stays dense.
"""

import dataclasses

from repro_torch.core.sparse_linear import SparsityConfig
from repro_torch.models.config import ModelConfig, zamba_kinds


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        n_layers=38, d_model=2048, vocab_size=32000,
        n_heads=32, n_kv_heads=32, d_ff=8192,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
        layer_kinds=zamba_kinds(38, 6),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke",
        n_layers=6, d_model=64, vocab_size=1024,
        n_heads=4, n_kv_heads=4, d_ff=128,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
        layer_kinds=zamba_kinds(6, 3), remat=False,
    )


def sparse() -> ModelConfig:
    """2:4 with g = 128 on the mamba and shared-MLP projections."""
    return dataclasses.replace(
        config(),
        mlp_sparsity=SparsityConfig(format="nm", n=2, m=4, block_n=128))
