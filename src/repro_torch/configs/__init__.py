"""Config registry of the port: one module per architecture, each with
``config()`` (full size) and ``reduced()`` (smoke size).

Only qwen3-0.6b is ported; the other architectures of the JAX registry
come with their model families (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ["qwen3_0_6b"]

ALIASES = {"qwen3-0.6b": "qwen3_0_6b"}


def _module(arch: str):
    name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if name not in ARCHS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet (ported: {ARCHS}; "
            "ROADMAP queue 1 item 11)")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()
