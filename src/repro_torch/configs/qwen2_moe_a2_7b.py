"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B.

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936; 60 routed experts
top-4 plus 4 shared experts (shared intermediate 4·1408 = 5632, the HF
config's ``shared_expert_intermediate_size``), served through the
sorted capacity dispatch (``moe_impl="sorted"``).  ``sparse()`` packs
the expert and shared FFNs 2:4 with g = 128; attention stays dense.
"""

import dataclasses

from repro_torch.core.sparse_linear import SparsityConfig
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        n_layers=24, d_model=2048, vocab_size=151936,
        n_heads=16, n_kv_heads=16, d_ff=1408,
        n_experts=60, n_shared_experts=4, top_k=4, d_expert=1408,
        moe_sharding="tp", moe_impl="sorted",
        rope_theta=1_000_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke",
        n_layers=2, d_model=64, vocab_size=1024,
        n_heads=4, n_kv_heads=4, d_ff=96,
        n_experts=8, n_shared_experts=2, top_k=2, d_expert=96,
        moe_sharding="tp", moe_impl="sorted", remat=False,
    )


def sparse() -> ModelConfig:
    """2:4 with g = 128 on the routed and the shared experts."""
    return dataclasses.replace(
        config(),
        expert_sparsity=SparsityConfig(format="nm", n=2, m=4, block_n=128),
        mlp_sparsity=SparsityConfig(format="nm", n=2, m=4, block_n=128))
