"""seamless-m4t-large-v2 [audio] — arXiv:2308.11596.

Enc-dec backbone: 24 encoder + 24 decoder layers, d_model=1024, 16 heads
over 16 kv heads (head_dim 64), an ungated MLP of d_ff=8192,
vocab=256206 (padded to 256512), tied head.  The speech frontend is a
stub: the encoder takes precomputed frame embeddings ``(B, L_src,
d_model)``.  ``sparse()`` packs every encoder and decoder ``w_in`` and
``w_out`` 2:4 with g = 128; the attention projections stay dense.
"""

import dataclasses

from repro_torch.core.sparse_linear import SparsityConfig
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        n_layers=24, d_model=1024, vocab_size=256206,
        n_heads=16, n_kv_heads=16, d_ff=8192,
        is_encoder_decoder=True, n_encoder_layers=24,
        input_mode="embeds", mlp_gated=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-smoke",
        n_layers=2, d_model=64, vocab_size=1024,
        n_heads=4, n_kv_heads=4, d_ff=128,
        is_encoder_decoder=True, n_encoder_layers=2,
        input_mode="embeds", mlp_gated=False, remat=False,
    )


def sparse() -> ModelConfig:
    """2:4 with g = 128 on the MLPs."""
    return dataclasses.replace(
        config(),
        mlp_sparsity=SparsityConfig(format="nm", n=2, m=4, block_n=128))
