"""Model configuration — the JAX package's :class:`ModelConfig`, field for
field, so a config built on either side describes the same model.

The port serves the decoder-only ("lm") family, with a tied or untied
head, M-RoPE (``mrope_sections``), embeds input (``input_mode``) and
routed experts (the MoE fields), the gemma features (``post_norm``,
``embed_scale``, attention and final softcaps, ``ATTN_LOCAL`` layers
with a sliding window, laid out by :func:`interleave_kinds`), the
SSM/hybrid family (the SSM fields, ``MAMBA`` and ``SHARED_ATTN`` layers)
and the encoder-decoder family (``is_encoder_decoder``,
``n_encoder_layers``, an ungated MLP).
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
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or self.d_inner // self.ssm_head_dim

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a 512 multiple (the JAX package's padding)."""
        return math.ceil(self.vocab_size / 512) * 512

    @property
    def uses_mamba(self) -> bool:
        return any(k in (LayerKind.MAMBA, LayerKind.SHARED_ATTN)
                   for k in self.layer_kinds)

    @property
    def sub_quadratic(self) -> bool:
        """True when decoding at 500k context is feasible (the JAX
        config's rule): at most one layer in five, and at least one, is
        global attention; the rest are windowed or attention-free."""
        kinds = [LayerKind(k) for k in self.layer_kinds]
        n_global = sum(k == LayerKind.ATTN_GLOBAL for k in kinds)
        return n_global <= max(1, len(kinds) // 5)

    def param_count(self) -> int:
        """Approximate parameter count N of the matrices (for 6·N·D
        training FLOPs), the JAX config's: the embedding table (once when
        tied: it is also the head), attention, MLP or experts and router,
        mamba projections and conv, the shared block once, the enc-dec
        encoder and cross-attention; norms and biases left out."""
        d, V = self.d_model, self.vocab_size
        n = V * d
        if not self.tie_embeddings:
            n += V * d
        per_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        per_mlp = d * self.d_ff * (3 if self.mlp_gated else 2)
        per_expert = d * self.d_expert * (3 if self.mlp_gated else 2)
        per_moe = self.n_experts * per_expert + d * self.n_experts \
            + self.n_shared_experts * per_expert
        if self.uses_mamba:
            di, N, H = self.d_inner, self.ssm_state, self.n_ssm_heads
            G = self.ssm_groups
            per_mamba = d * (2 * di + 2 * G * N + H) + di * d \
                + self.ssm_conv * (di + 2 * G * N)
        kinds = [LayerKind(k) for k in self.layer_kinds]
        for k in kinds:
            if k in (LayerKind.ATTN_GLOBAL, LayerKind.ATTN_LOCAL):
                n += per_attn + (per_moe if self.n_experts else per_mlp)
            else:                      # MAMBA, SHARED_ATTN: the mixer
                n += per_mamba
        if LayerKind.SHARED_ATTN in kinds:
            n += per_attn + per_mlp
        if self.is_encoder_decoder:
            n += self.n_encoder_layers * (per_attn + per_mlp)
            n += self.n_layers * per_attn          # cross-attention
        return n

    def active_param_count(self) -> int:
        """Active params per token (the JAX config's): with routed experts
        only ``top_k`` of them (and the shared ones) count."""
        if not self.n_experts:
            return self.param_count()
        per_expert = self.d_model * self.d_expert * \
            (3 if self.mlp_gated else 2)
        n_moe = sum(LayerKind(k) in (LayerKind.ATTN_GLOBAL,
                                     LayerKind.ATTN_LOCAL)
                    for k in self.layer_kinds)
        return self.param_count() - n_moe * (self.n_experts - self.top_k) \
            * per_expert


def interleave_kinds(n_layers: int, local: int, global_: int,
                     window_first: bool = True) -> Tuple[int, ...]:
    """gemma-style ``local:global`` repeating pattern (e.g. 5:1)."""
    pat = ([int(LayerKind.ATTN_LOCAL)] * local
           + [int(LayerKind.ATTN_GLOBAL)] * global_)
    if not window_first:
        pat = pat[::-1]
    return tuple((pat * math.ceil(n_layers / len(pat)))[:n_layers])


def zamba_kinds(n_layers: int, shared_every: int = 6) -> Tuple[int, ...]:
    """zamba2: mamba backbone with the shared attention block applied
    every ``shared_every`` layers (starting at the first slot)."""
    return tuple(int(LayerKind.SHARED_ATTN)
                 if i % shared_every == shared_every // 2
                 else int(LayerKind.MAMBA) for i in range(n_layers))
