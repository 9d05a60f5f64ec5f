"""Lookahead LSB encoding of sparse DNN weights (paper Algorithms 1 + 2).

The offline pass behind :class:`~repro_torch.core.sparsity.LookaheadPack`:

  1. clamp INT8 weights to the INT7 range [-64, 63], so bit 6 mirrors the
     sign bit;
  2. walk blocks of 4 weights along the reduction axis and count the
     consecutive all-zero blocks that follow each block (Algorithm 1, a
     4-bit counter, 0..15);
  3. put bit ``i`` of that counter into the LSB of weight ``i`` of the
     block (Algorithm 2): the byte becomes ``[sign, b5..b0, skip]``.

The same functions as the JAX package's ``repro.core.encoding``, on torch
tensors: bit manipulation runs in int32 and is cast back, and
:func:`quantize_int7` computes in the weight's own dtype, so packs built
from the same weights are array-equal.  Functions take the *last* axis as
the reduction axis, except the ``*_weight_matrix`` pair, which encode a
``(K, N)`` weight along K.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

BLOCK = 4              # weights per block (four INT8 lanes of one 32-bit reg)
SKIP_CAP = 15          # 4-bit lookahead counter
INT7_MIN, INT7_MAX = -64, 63


def clamp_int7(w: torch.Tensor) -> torch.Tensor:
    """Clamp int8 weights to [-64, 63] so bit 6 mirrors the sign bit."""
    return w.to(torch.int32).clamp(INT7_MIN, INT7_MAX).to(torch.int8)


def quantize_int7(w: torch.Tensor, axis: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel INT7 quantization: ``w ≈ q * scale``.

    ``axis`` is reduced over for the scale (per remaining channel).  The
    arithmetic stays in ``w``'s dtype, as in the JAX package; zero weights
    stay exactly zero.  Returns ``(q int8 in [-64, 63], scale)``.
    """
    absmax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(absmax > 0, absmax / INT7_MAX,
                        torch.ones_like(absmax))
    q = torch.round(w / scale).clamp(INT7_MIN, INT7_MAX).to(torch.int8)
    return q, scale


def quantize_int8(w: torch.Tensor, axis: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel INT8 quantization (the paper's baseline):
    ``scale = absmax / 127`` and ``q = round(w / scale)`` in ``w``'s dtype,
    the JAX package's order of operations.  Returns ``(q int8 in
    [-127, 127], scale)``."""
    absmax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def block_is_zero(w: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., n]`` (``n % 4 == 0``) → bool ``[..., n // 4]``: True
    where a block of 4 consecutive weights is all zero."""
    n = w.shape[-1]
    if n % BLOCK:
        raise ValueError(f"last axis ({n}) must be a multiple of {BLOCK}")
    return (w.reshape(*w.shape[:-1], n // BLOCK, BLOCK) == 0).all(dim=-1)


def skip_counts(zero_blocks: torch.Tensor, cap: int = SKIP_CAP
                ) -> torch.Tensor:
    """Consecutive all-zero blocks following each block (Algorithm 1).

    bool ``[..., nb]`` → uint8 ``[..., nb]`` in [0, cap].  ``run[b]``, the
    zero run starting at ``b``, is the distance to the next non-zero block
    at or after ``b`` (a reversed running minimum); each block's count is
    ``min(run[b + 1], cap)``.
    """
    nb = zero_blocks.shape[-1]
    pos = torch.arange(nb, device=zero_blocks.device).expand_as(zero_blocks)
    nonzero_at = torch.where(zero_blocks, nb, pos)
    nxt_nonzero = nonzero_at.flip(-1).cummin(dim=-1).values.flip(-1)
    run = nxt_nonzero - pos
    nxt = torch.cat([run[..., 1:], torch.zeros_like(run[..., :1])], dim=-1)
    return nxt.clamp(max=cap).to(torch.uint8)


def encode_block_bits(w: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Embed a 4-bit ``skip`` count into blocks of 4 int7 weights.

    ``w`` int8 ``[..., nb, 4]`` (clamped), ``skip`` uint8 ``[..., nb]``;
    bit ``i`` of ``skip`` goes to the LSB of weight ``i``.  Returns int8
    ``[sign, b5..b0, skip_bit]``.
    """
    wi = w.to(torch.int32) & 0xFF                 # two's-complement byte
    sign = (wi >> 7) & 0x1
    bit = torch.arange(BLOCK, dtype=torch.int32, device=w.device)
    skip_bits = (skip.to(torch.int32)[..., None] >> bit) & 0x1
    body = ((wi & 0b10111111) << 1) & 0b01111110  # drop bit 6, shift up
    return _to_int8(body | skip_bits | (sign << 7))


def decode_values(enc: torch.Tensor) -> torch.Tensor:
    """Encoded bytes → the exact INT7 values (int8 in [-64, 63])."""
    e = enc.to(torch.int32) & 0xFF
    sign = (e >> 7) & 0x1
    u = ((e >> 1) & 0x3F) | (sign << 6)           # 7-bit two's complement
    return torch.where(u >= 64, u - 128, u).to(torch.int8)


def decode_skip(enc: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., nb, 4]`` → the uint8 4-bit counter of each block."""
    bits = enc.to(torch.int32) & 0x1
    weights = 1 << torch.arange(BLOCK, dtype=torch.int32, device=enc.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def encode_stream(w: torch.Tensor, cap: int = SKIP_CAP) -> torch.Tensor:
    """Clamp, count and embed along the last axis.  Every block is
    encoded, all-zero ones included: a run longer than ``cap`` lands the
    walker on a zero block whose own counter continues the skip."""
    w7 = clamp_int7(w)
    n = w7.shape[-1]
    blocks = w7.reshape(*w7.shape[:-1], n // BLOCK, BLOCK)
    skips = skip_counts(block_is_zero(w7), cap=cap)
    return encode_block_bits(blocks, skips).reshape(w7.shape)


def decode_stream(enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`encode_stream` → ``(values int8, skips uint8)``."""
    n = enc.shape[-1]
    skips = decode_skip(enc.reshape(*enc.shape[:-1], n // BLOCK, BLOCK))
    return decode_values(enc), skips


def encode_weight_matrix(w: torch.Tensor, cap: int = SKIP_CAP
                         ) -> torch.Tensor:
    """Encode a ``(K, N)`` weight along K, each output column's stream."""
    if w.dim() != 2:
        raise ValueError("encode_weight_matrix expects (K, N)")
    return encode_stream(w.T, cap=cap).T.contiguous()


def decode_weight_matrix(enc: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`encode_weight_matrix` → ``(values (K, N), skips
    (N, K / 4))``."""
    vals, skips = decode_stream(enc.T)
    return vals.T, skips


def simulate_walk(enc_stream, cap: int = SKIP_CAP) -> list[int]:
    """The block indices Listing 2's inner loop visits in one encoded
    stream: from each visited block, jump ``skip + 1`` blocks ahead."""
    enc = np.asarray(enc_stream).reshape(-1, BLOCK)
    visited, b = [], 0
    while b < enc.shape[0]:
        visited.append(b)
        bits = enc[b].astype(np.int32) & 0x1
        b += int((bits * (1 << np.arange(BLOCK))).sum()) + 1
    return visited


def tile_zero_map(w: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """Bool ``(K // bk, N // bn)``: True where the ``(bk, bn)`` tile of
    ``w (K, N)`` is all zero — Algorithm 1's block scan at tile
    granularity."""
    K, N = w.shape
    if K % bk or N % bn:
        raise ValueError(f"weight {tuple(w.shape)} not divisible by tile "
                         f"({bk},{bn})")
    return (w.reshape(K // bk, bk, N // bn, bn) == 0).all(dim=3).all(dim=1)


def tile_skip_counts(w: torch.Tensor, bk: int, bn: int,
                     cap: int = SKIP_CAP) -> torch.Tensor:
    """Lookahead counts over K-tiles, per N-strip: uint8
    ``(N // bn, K // bk)``."""
    return skip_counts(tile_zero_map(w, bk, bn).T, cap=cap)


def _to_int8(x: torch.Tensor) -> torch.Tensor:
    """The low byte of an int32 in [0, 255] as a signed int8."""
    return torch.where(x >= 128, x - 256, x).to(torch.int8)
