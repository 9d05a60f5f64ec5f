"""mamba2-130m [ssm] — arXiv:2405.21060 (SSD, state-space duality).

24L d_model=768 (attention-free) vocab=50280, ssm_state=128; d_inner =
2·768 = 1536, 24 SSD heads of dim 64.  ``sparse()`` packs ``out_proj``
2:4 with g = 128; ``in_proj`` (N = 3352, not a multiple of 128) stays
dense, as the JAX ``pack_params`` leaves it.
"""

import dataclasses

from repro_torch.core.sparse_linear import SparsityConfig
from repro_torch.models.config import LayerKind, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        n_layers=24, d_model=768, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
        layer_kinds=tuple([int(LayerKind.MAMBA)] * 24),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m-smoke",
        n_layers=3, d_model=64, vocab_size=1024,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
        layer_kinds=tuple([int(LayerKind.MAMBA)] * 3), remat=False,
    )


def sparse() -> ModelConfig:
    """2:4 with g = 128 on the in/out projections (what divides)."""
    return dataclasses.replace(
        config(),
        mlp_sparsity=SparsityConfig(format="nm", n=2, m=4, block_n=128))
