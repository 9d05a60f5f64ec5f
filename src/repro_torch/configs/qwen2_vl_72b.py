"""qwen2-vl-72b [vlm] — arXiv:2409.12191.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064; M-RoPE with
(temporal, height, width) sections (16, 24, 24) over head_dim=128.  The
vision frontend is a stub: a prefill may take precomputed embeddings
(``input_mode="embeds"``); text-only decode passes identical position
triples, which reduces exactly to standard RoPE.
"""

import dataclasses

from repro_torch.core.sparse_linear import SparsityConfig
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        n_layers=80, d_model=8192, vocab_size=152064,
        n_heads=64, n_kv_heads=8, head_dim=128, d_ff=29568,
        mrope_sections=(16, 24, 24),
        input_mode="embeds",
        rope_theta=1_000_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-smoke",
        n_layers=2, d_model=64, vocab_size=1024,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128,
        mrope_sections=(4, 6, 6),
        input_mode="embeds", remat=False,
    )


def sparse() -> ModelConfig:
    """The repo's sparse-packed qwen2-vl: 2:4 with g = 128 on all seven
    projections."""
    return dataclasses.replace(
        config(),
        mlp_sparsity=SparsityConfig(format="nm", n=2, m=4, block_n=128),
        attn_sparsity=SparsityConfig(format="nm", n=2, m=4, block_n=128))
