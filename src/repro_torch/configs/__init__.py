"""Config registry of the port: one module per architecture, each with
``config()`` (full size) and ``reduced()`` (smoke size).

Ported: qwen3-0.6b, stablelm-12b (untied head, head_dim 160),
qwen2-vl-72b (M-RoPE, embeds input), the MoE pair qwen2-moe-a2.7b and
dbrx-132b, the SSM/hybrid pair mamba2-130m and zamba2-1.2b, the
encoder-decoder seamless-m4t-large-v2, and the gemma pair gemma2-27b and
gemma3-1b (sliding windows, softcaps, post-norms, scaled embeds): every
architecture of the JAX package's registry.

The shape cells of the dry run (``launch.dryrun``) are the JAX
package's: ``train_4k``, ``prefill_32k``, ``decode_32k`` and, for
sub-quadratic architectures only (``cells_for``), ``long_500k``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCHS = ["qwen3_0_6b", "stablelm_12b", "qwen2_vl_72b", "qwen2_moe_a2_7b",
         "dbrx_132b", "mamba2_130m", "zamba2_1_2b", "seamless_m4t_large_v2",
         "gemma2_27b", "gemma3_1b"]

ALIASES = {"qwen3-0.6b": "qwen3_0_6b", "stablelm-12b": "stablelm_12b",
           "qwen2-vl-72b": "qwen2_vl_72b",
           "qwen2-moe-a2.7b": "qwen2_moe_a2_7b", "dbrx-132b": "dbrx_132b",
           "mamba2-130m": "mamba2_130m", "zamba2-1.2b": "zamba2_1_2b",
           "seamless-m4t-large-v2": "seamless_m4t_large_v2",
           "gemma2-27b": "gemma2_27b", "gemma3-1b": "gemma3_1b"}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq: int
    batch: int
    microbatches: int = 1    # grad-accumulation factor for train cells


CELLS: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256, microbatches=8),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def _module(arch: str):
    name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if name not in ARCHS:
        raise ValueError(
            f"unknown architecture {arch!r} (ported: {ARCHS})")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def cells_for(cfg: ModelConfig) -> List[ShapeCell]:
    cells = [CELLS["train_4k"], CELLS["prefill_32k"], CELLS["decode_32k"]]
    if cfg.sub_quadratic:
        cells.append(CELLS["long_500k"])
    return cells


def list_archs() -> List[str]:
    return list(ARCHS)
