"""Packed sparse weights — the port's carriers of the paper's designs.

  * :class:`NMPack` (USSA analogue) keeps ``n`` of every ``m`` weights
    along the reduction axis K, with the kept positions shared across
    groups of ``g`` output columns: ``values (Kc = K·n/m, N)`` and ``idx
    (Kc, N/g)``, the position of each kept row inside its m-group.
    ``nm_spmm`` gathers the matching activation rows and contracts a
    K-axis shrunk by ``n/m``.
  * :class:`BlockSparsePack` (SSSA analogue) cuts the weight into ``(bk,
    bn)`` tiles and keeps, per N-strip, only the non-zero K-tiles: their
    values ``(Nb, max_nnz, bk, bn)``, their K-tile ``indices`` and the
    strip's ``counts``.  ``bsr_matmul`` walks ``counts[j]`` tiles.
  * :class:`CombinedPack` (CSA analogue): the block pack whose surviving
    tiles are n:m-compressed to ``bkc = bk·n/m`` rows, with the kept
    local rows in ``gidx``.  ``csa_matmul`` walks and gathers them.
  * :class:`LookaheadPack`: INT7 weights carrying Algorithm 1+2's skip
    bits in their LSBs plus a per-column scale; ``lookahead_matmul``
    decodes them in registers.

The packers run offline on the host in float32 numpy exactly as the JAX
package's do, so packs built from the same weights are array-equal; each
pack lands on the weight's device in the weight's dtype.  The exception
is :func:`pack_nm`, which runs in torch ops on the weight's device (a
full-width model's weights are tens of GB).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import encoding
from repro_torch.core.encoding import SKIP_CAP


@dataclasses.dataclass
class NMPack:
    """``n``-of-``m`` compressed K axis; positions shared over ``g`` columns."""
    values: torch.Tensor   # (Kc, N)  — kept weights, Kc = K*n//m
    idx: torch.Tensor      # (Kc, N//g) int32 — position within each m-group
    K: int
    N: int
    n: int
    m: int
    g: int

    @property
    def Kc(self) -> int:
        return self.K * self.n // self.m

    def src_rows(self) -> torch.Tensor:
        """Absolute source K-row of each compressed row, per column group:
        ``(Kc, N//g)`` int64."""
        kc = torch.arange(self.Kc, device=self.idx.device)[:, None]
        return (kc // self.n) * self.m + self.idx.long()

    def densify(self) -> torch.Tensor:
        """Reconstruct the dense ``(K, N)`` weight (test oracle)."""
        src = self.src_rows()                                   # (Kc, Ng)
        Ng = self.N // self.g
        dense = torch.zeros((self.K, self.N), dtype=self.values.dtype,
                            device=self.values.device)
        cols = (torch.arange(Ng, device=src.device)[:, None] * self.g
                + torch.arange(self.g, device=src.device)[None, :])
        rows = src[:, :, None].expand(self.Kc, Ng, self.g)
        dense[rows.reshape(-1), cols[None].expand_as(rows).reshape(-1)] = \
            self.values.reshape(-1)
        return dense

    def to(self, device) -> "NMPack":
        return _to(self, device)


def pack_nm(w: torch.Tensor, n: int, m: int, g: int = 1) -> NMPack:
    """Pack a weight already pruned to (group-shared) n:m along K, in
    torch ops on ``w``'s device and in ``w``'s dtype.

    If ``w`` is not exactly n:m it is *projected*: the top-n magnitude
    rows per (m-group × column-group) are kept — so
    ``pack_nm(pruning.n_m(w)…)`` round-trips exactly.  The group sums are
    float32 in the device's order; on a weight pruned to n:m the kept
    rows are the non-zero ones whatever the order.
    """
    K, N = w.shape
    if K % m or N % g:
        raise ValueError(f"{tuple(w.shape)} incompatible with m={m}, g={g}")
    Kg, Ng = K // m, N // g
    wg = w.detach().reshape(Kg, m, Ng, g)
    score = wg.float().abs().sum(dim=3)                 # (Kg, m, Ng)
    order = torch.argsort(-score, dim=1, stable=True)[:, :n, :]
    pos = torch.sort(order, dim=1).values               # keep K-order
    vals = torch.take_along_dim(wg, pos[..., None], dim=1)  # (Kg, n, Ng, g)
    return NMPack(values=vals.reshape(Kg * n, N).contiguous(),
                  idx=pos.reshape(Kg * n, Ng).to(torch.int32).contiguous(),
                  K=K, N=N, n=n, m=m, g=g)


def _to(pack, device):
    """``pack`` with every tensor field moved to ``device``."""
    return dataclasses.replace(pack, **{
        f.name: getattr(pack, f.name).to(device)
        for f in dataclasses.fields(pack)
        if isinstance(getattr(pack, f.name), torch.Tensor)})


def _host(w: torch.Tensor) -> np.ndarray:
    return w.detach().float().cpu().numpy()


def _tile_density(pack) -> float:
    """Non-zero tile fraction of a block or combined pack (reads
    ``counts`` on the host)."""
    return int(pack.counts.sum()) / max(
        (pack.K // pack.bk) * (pack.N // pack.bn), 1)


@dataclasses.dataclass
class BlockSparsePack:
    """Per-N-strip packed non-zero K-tiles of a ``(K, N)`` weight."""
    values: torch.Tensor   # (Nb, max_nnz, bk, bn) — packed non-zero tiles
    indices: torch.Tensor  # (Nb, max_nnz) int32 — K-tile index of each slot
    counts: torch.Tensor   # (Nb,) int32 — valid slots per strip
    K: int
    N: int
    bk: int
    bn: int
    max_nnz: int

    @property
    def density(self) -> float:
        return _tile_density(self)

    def densify(self) -> torch.Tensor:
        """Reconstruct the dense ``(K, N)`` weight (test oracle)."""
        Kb, Nb = self.K // self.bk, self.N // self.bn
        dev = self.values.device
        valid = (torch.arange(self.max_nnz, device=dev)[None, :]
                 < self.counts[:, None])
        vals = torch.where(valid[:, :, None, None], self.values, 0)
        dense = torch.zeros((Nb, Kb, self.bk, self.bn),
                            dtype=self.values.dtype, device=dev)
        strip = torch.arange(Nb, device=dev)[:, None].expand(Nb, self.max_nnz)
        # padded indices are clipped into range; their values are zero
        idx = self.indices.long().clamp(0, Kb - 1)
        dense.index_put_((strip, idx), vals, accumulate=True)
        return dense.permute(1, 2, 0, 3).reshape(self.K, self.N)

    def to(self, device) -> "BlockSparsePack":
        return _to(self, device)


def pack_block_sparse_numpy(w: np.ndarray, bk: int, bn: int,
                            pad_to: Optional[int] = None):
    """The numpy packer behind :func:`pack_block_sparse`: ``(values,
    indices, counts)``, padded to ``pad_to`` slots per strip (default:
    the largest strip count, at least 1)."""
    K, N = w.shape
    if K % bk or N % bn:
        raise ValueError(f"{w.shape} not divisible by tile ({bk},{bn})")
    Kb, Nb = K // bk, N // bn
    wt = w.reshape(Kb, bk, Nb, bn)
    nz = ~np.all(wt == 0, axis=(1, 3))                  # (Kb, Nb)
    counts = nz.sum(axis=0).astype(np.int32)            # (Nb,)
    most = int(counts.max(initial=0))
    max_nnz = int(pad_to if pad_to is not None else max(most, 1))
    if most > max_nnz:
        raise ValueError(f"pad_to={pad_to} < max strip nnz {most}")
    indices = np.zeros((Nb, max_nnz), np.int32)
    values = np.zeros((Nb, max_nnz, bk, bn), w.dtype)
    for j in range(Nb):
        ks = np.nonzero(nz[:, j])[0]
        indices[j, :len(ks)] = ks
        values[j, :len(ks)] = wt[ks, :, j, :]
    return values, indices, counts


def pack_block_sparse(w: torch.Tensor, bk: int, bn: int,
                      pad_to: Optional[int] = None) -> BlockSparsePack:
    """Pack a (pruned) dense ``(K, N)`` weight into its non-zero
    ``(bk, bn)`` tiles, strip by strip."""
    K, N = w.shape
    values, indices, counts = pack_block_sparse_numpy(_host(w), bk, bn,
                                                      pad_to)
    return BlockSparsePack(
        values=torch.from_numpy(values).to(w.device, w.dtype),
        indices=torch.from_numpy(indices).to(w.device),
        counts=torch.from_numpy(counts).to(w.device),
        K=K, N=N, bk=bk, bn=bn, max_nnz=indices.shape[1])


@dataclasses.dataclass
class CombinedPack:
    """Block-skip outer structure; surviving tiles n:m-compressed.

    ``values[j, t]`` is the compressed ``(bkc, bn)`` tile of the ``t``-th
    non-zero K-tile of strip ``j``; ``gidx[j, t]`` its ``bkc`` local rows
    inside the K-tile (shared across the strip's ``bn`` columns)."""
    values: torch.Tensor   # (Nb, max_nnz, bkc, bn)
    gidx: torch.Tensor     # (Nb, max_nnz, bkc) int32
    indices: torch.Tensor  # (Nb, max_nnz) int32 — K-tile index
    counts: torch.Tensor   # (Nb,) int32
    K: int
    N: int
    n: int
    m: int
    bk: int
    bn: int
    max_nnz: int

    @property
    def bkc(self) -> int:
        return self.bk * self.n // self.m

    @property
    def density(self) -> float:
        return _tile_density(self)

    def densify(self) -> torch.Tensor:
        """Reconstruct the dense ``(K, N)`` weight (test oracle)."""
        out = torch.zeros((self.K, self.N), dtype=self.values.dtype,
                          device=self.values.device)
        counts = self.counts.tolist()
        for j in range(self.N // self.bn):
            cols = slice(j * self.bn, (j + 1) * self.bn)
            for t in range(counts[j]):
                rows = int(self.indices[j, t]) * self.bk + self.gidx[j, t]
                out[rows.long(), cols] += self.values[j, t]
        return out

    def to(self, device) -> "CombinedPack":
        return _to(self, device)


def pack_combined(w: torch.Tensor, n: int, m: int, bk: int, bn: int,
                  pad_to: Optional[int] = None) -> CombinedPack:
    """Pack a weight pruned with ``pruning.combined_nm`` (block × n:m).

    The JAX packer runs ``pack_nm(tile, n, m, g=bn)`` on each surviving
    tile; this does the same for all tiles at once (the top-``n`` rows
    by L1 mass of every m-group, kept in K order).  Padding slots keep
    zero values and zero ``gidx``."""
    if bk % m:
        raise ValueError(f"bk={bk} must be a multiple of m={m}")
    K, N = w.shape
    tiles, indices, counts = pack_block_sparse_numpy(_host(w), bk, bn,
                                                     pad_to)
    Nb, max_nnz = indices.shape
    Kg, bkc = bk // m, bk * n // m
    t = tiles.reshape(Nb, max_nnz, Kg, m, bn)
    score = np.abs(t).sum(axis=4)                       # (Nb, T, Kg, m)
    pos = np.sort(np.argsort(-score, axis=3, kind="stable")[..., :n], axis=3)
    values = np.take_along_axis(t, pos[..., None], axis=3)
    gidx = (np.arange(Kg)[:, None] * m + pos).reshape(Nb, max_nnz, bkc)
    valid = np.arange(max_nnz)[None, :] < counts[:, None]
    gidx = np.where(valid[..., None], gidx, 0).astype(np.int32)
    values = np.where(valid[..., None, None],
                      values.reshape(Nb, max_nnz, bkc, bn), 0)
    return CombinedPack(
        values=torch.from_numpy(values).to(w.device, w.dtype),
        gidx=torch.from_numpy(gidx).to(w.device),
        indices=torch.from_numpy(indices).to(w.device),
        counts=torch.from_numpy(counts).to(w.device),
        K=K, N=N, n=n, m=m, bk=bk, bn=bn, max_nnz=max_nnz)


@dataclasses.dataclass
class LookaheadPack:
    """INT7 weights with Algorithm 1+2 metadata in their LSBs: the whole
    sparsity description rides inside the int8 tensor (zero extra
    bytes); ``scale`` dequantizes per output column."""
    enc: torch.Tensor      # (K, N) int8 — [sign, b5..b0, skip_bit]
    scale: torch.Tensor    # (1, N) float32
    K: int
    N: int

    @classmethod
    def from_float(cls, w: torch.Tensor, cap: int = SKIP_CAP
                   ) -> "LookaheadPack":
        q, scale = encoding.quantize_int7(w, axis=0)
        return cls(enc=encoding.encode_weight_matrix(q, cap=cap),
                   scale=scale.float(), K=w.shape[0], N=w.shape[1])

    def decode(self) -> torch.Tensor:
        """The dense float32 weight the encoded tensor represents."""
        vals, _ = encoding.decode_weight_matrix(self.enc)
        return vals.float() * self.scale

    def decode_int(self) -> torch.Tensor:
        return encoding.decode_values(self.enc)

    def to_block_sparse(self, bk: int, bn: int) -> BlockSparsePack:
        """The non-zero tile lists of the decoded weight (what a
        block-skip kernel walks)."""
        return pack_block_sparse(self.decode_int().float() * self.scale,
                                 bk, bn)

    def to(self, device) -> "LookaheadPack":
        return _to(self, device)


def skip_lists_from_encoded(enc) -> list[list[int]]:
    """Walk every column of an encoded ``(K, N)`` int8 matrix through its
    embedded skip bits (Listing 2); the visited block indices per
    column."""
    enc = np.asarray(enc)
    return [encoding.simulate_walk(enc[:, j]) for j in range(enc.shape[1])]


PACK_TYPES = (NMPack, BlockSparsePack, CombinedPack, LookaheadPack)


def metadata_bytes(pack) -> int:
    """Bytes of sparsity metadata a format carries beyond its values."""
    if isinstance(pack, LookaheadPack):
        return 0                      # the metadata lives in the LSBs
    if isinstance(pack, BlockSparsePack):
        return (pack.indices.numel() + pack.counts.numel()) * 4
    if isinstance(pack, NMPack):
        return pack.idx.numel() * 4
    if isinstance(pack, CombinedPack):
        return (pack.indices.numel() + pack.counts.numel()
                + pack.gidx.numel()) * 4
    raise TypeError(type(pack))


def values_bytes(pack) -> int:
    v = pack.enc if isinstance(pack, LookaheadPack) else pack.values
    return v.numel() * v.element_size()
