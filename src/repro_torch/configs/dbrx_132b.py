"""dbrx-132b [moe] — hf:databricks/dbrx-base.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352; 16 fine-grained
experts top-4, no shared experts, served through the sorted capacity
dispatch (``moe_impl="sorted"``).  ``sparse()`` packs the expert FFNs
2:4 with g = 128; attention stays dense.
"""

import dataclasses

from repro_torch.core.sparse_linear import SparsityConfig
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        n_layers=40, d_model=6144, vocab_size=100352,
        n_heads=48, n_kv_heads=8, d_ff=10752,
        n_experts=16, top_k=4, d_expert=10752,
        moe_sharding="ep", moe_impl="sorted",
        rope_theta=500_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke",
        n_layers=2, d_model=64, vocab_size=1024,
        n_heads=4, n_kv_heads=2, d_ff=96,
        n_experts=4, top_k=2, d_expert=96,
        moe_sharding="ep", moe_impl="sorted", remat=False,
    )


def sparse() -> ModelConfig:
    """2:4 with g = 128 on the expert FFNs."""
    return dataclasses.replace(
        config(),
        expert_sparsity=SparsityConfig(format="nm", n=2, m=4, block_n=128))
