"""LR schedules as step → scale functions (multiply the peak LR).

The step is the optimizer's host-side counter (a Python int), and each
scale is a float32 computed on the host in the JAX package's order, so
the optimizer issues no device work for it."""

from __future__ import annotations

import numpy as np

F32 = np.float32


def constant():
    return lambda step: F32(1.0)


def linear_warmup(warmup_steps: int):
    return lambda step: min(F32(step) / F32(max(warmup_steps, 1)), F32(1.0))


def cosine_warmup(warmup_steps: int, total_steps: int,
                  final_scale: float = 0.1):
    """Linear warmup then cosine decay to ``final_scale``."""

    def fn(step):
        s = F32(step)
        warm = s / F32(max(warmup_steps, 1))
        frac = np.clip((s - F32(warmup_steps))
                       / F32(max(total_steps - warmup_steps, 1)),
                       F32(0.0), F32(1.0))
        # the cosine correctly rounded to float32 (XLA's float32 cos is
        # within 2 ulp of it)
        c = F32(np.cos(np.float64(F32(np.pi) * frac)))
        cos = F32(final_scale) + F32((1 - final_scale) * 0.5) * (
            F32(1.0) + c)
        return warm if s < warmup_steps else F32(cos)

    return fn
