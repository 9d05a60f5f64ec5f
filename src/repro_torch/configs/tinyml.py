"""The paper's own TinyML benchmark settings (Section IV-B).

Model/dataset pairs + the (x_us, x_ss) sparsity configurations of Fig. 10
and the CNN input geometries; consumed by ``benchmarks/bench_csa_models``
and ``chip_smoke.py``.  The same values as the JAX package's
``repro/configs/tinyml.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

PAPER_MODELS = {
    "vgg16": {"dataset": "cifar10", "input": (32, 32, 3), "classes": 10},
    "resnet56": {"dataset": "cifar10", "input": (32, 32, 3), "classes": 10},
    "mobilenetv2": {"dataset": "vww", "input": (96, 96, 3), "classes": 2},
    "dscnn": {"dataset": "gsc", "input": (49, 10, 1), "classes": 12},
}

# Fig. 10: "three different configurations of unstructured sparsity (x_us)
# and semi-structured sparsity (x_ss)".  The paper does not list the exact
# values; these spans cover its stated "moderate" regime and reproduce the
# 4–5× band (benchmarks/bench_csa_models.py prints the whole grid).
FIG10_CONFIGS: Tuple[Tuple[float, float], ...] = (
    (0.5, 0.5),    # (x_us, x_ss)
    (0.55, 0.6),
    (0.6, 0.6),
)


@dataclasses.dataclass(frozen=True)
class TinyMLRun:
    model: str
    width: float = 0.25         # reduced width for CPU training
    train_steps: int = 300
    batch: int = 32
    lr: float = 1e-3
