"""Model configuration — the JAX package's :class:`ModelConfig`, field for
field, so a config built on either side describes the same model.

The port serves the decoder-only ("lm") family so far; the fields of the
MoE, SSM and encoder-decoder families are carried for parity and
rejected by ``models.init_model`` (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple

from repro_torch.core.sparse_linear import DENSE, SparsityConfig


class LayerKind(enum.IntEnum):
    """What sequence mixer a layer uses."""
    ATTN_GLOBAL = 0      # full causal attention
    ATTN_LOCAL = 1       # sliding-window attention
    MAMBA = 2            # Mamba-2 SSD block
    SHARED_ATTN = 3      # zamba2: shared attention block before this layer


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab_size: int

    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                    # 0 → d_model // n_heads
    qk_norm: bool = False                # qwen3
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    window_size: Optional[int] = None
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None

    # --- mlp ---
    d_ff: int = 0
    mlp_gated: bool = True

    # --- layer pattern ---
    layer_kinds: Tuple[int, ...] = ()    # defaults to all ATTN_GLOBAL

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    moe_sharding: str = "ep"
    moe_impl: str = "grouped"
    capacity_factor: float = 1.25
    moe_group: int = 4096

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- enc-dec ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # --- modality frontend stub ---
    input_mode: str = "tokens"

    # --- norms / embeddings ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False
    post_norm: bool = False

    # --- sparsity (the paper's technique, per layer family) ---
    mlp_sparsity: SparsityConfig = DENSE
    attn_sparsity: SparsityConfig = DENSE
    expert_sparsity: SparsityConfig = DENSE

    # --- numerics / distribution ---
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    scan_layers: bool = True

    def __post_init__(self):
        if not self.layer_kinds:
            object.__setattr__(
                self, "layer_kinds",
                tuple([int(LayerKind.ATTN_GLOBAL)] * self.n_layers))
        if len(self.layer_kinds) != self.n_layers:
            raise ValueError(
                f"layer_kinds has {len(self.layer_kinds)} entries for "
                f"{self.n_layers} layers")
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and not self.d_expert:
            object.__setattr__(self, "d_expert", self.d_ff)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a 512 multiple (the JAX package's padding)."""
        return math.ceil(self.vocab_size / 512) * 512

    @property
    def uses_mamba(self) -> bool:
        return any(k in (LayerKind.MAMBA, LayerKind.SHARED_ATTN)
                   for k in self.layer_kinds)
