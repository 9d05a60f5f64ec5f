"""Packed N:M sparse weights — the port's carrier of the paper's USSA idea.

:class:`NMPack` keeps ``n`` of every ``m`` weights along the reduction
axis K, with the kept positions shared across groups of ``g`` output
columns: ``values (Kc = K·n/m, N)`` holds the kept weights densely and
``idx (Kc, N/g)`` the position of each kept row inside its m-group.  The
``nm_spmm`` kernel gathers the matching activation rows and contracts a
K-axis shrunk by ``n/m`` — compute and weight bytes both drop to ``n/m``
of dense.

:func:`pack_nm` is the offline packer; it runs in numpy exactly as the
JAX package's does, so packs built from the same weights are
array-equal.  The other pack formats (block-sparse, combined, lookahead)
are ROADMAP queue 1 item 10.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
        return dataclasses.replace(self, values=self.values.to(device),
                                   idx=self.idx.to(device))


def pack_nm_numpy(w: np.ndarray, n: int, m: int, g: int = 1
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The numpy packer behind :func:`pack_nm`: ``(values, idx)``.

    If ``w`` is not exactly n:m it is *projected*: the top-n magnitude
    rows per (m-group × column-group) are kept — so
    ``pack_nm(pruning.n_m(w)…)`` round-trips exactly.
    """
    K, N = w.shape
    if K % m or N % g:
        raise ValueError(f"{w.shape} incompatible with m={m}, g={g}")
    Kg, Ng = K // m, N // g
    wg = np.asarray(w).reshape(Kg, m, Ng, g)
    score = np.abs(wg).sum(axis=3)                      # (Kg, m, Ng)
    order = np.argsort(-score, axis=1)[:, :n, :]        # top-n positions
    pos = np.sort(order, axis=1)                        # keep K-order
    vals = np.take_along_axis(wg, pos[:, :, :, None], axis=1)  # (Kg,n,Ng,g)
    Kc = Kg * n
    values = vals.reshape(Kc, N)
    idx = pos.reshape(Kc, Ng).astype(np.int32)
    return values, idx


def pack_nm(w: torch.Tensor, n: int, m: int, g: int = 1) -> NMPack:
    """Pack a weight already pruned to (group-shared) n:m along K.

    Runs offline on the host in float32 numpy (exact for bf16 and f32
    weights); the pack lands on ``w``'s device in ``w``'s dtype.
    """
    K, N = w.shape
    values, idx = pack_nm_numpy(w.detach().float().cpu().numpy(), n, m, g)
    return NMPack(values=torch.from_numpy(values).to(w.device, w.dtype),
                  idx=torch.from_numpy(idx).to(w.device),
                  K=K, N=N, n=n, m=m, g=g)


def metadata_bytes(pack) -> int:
    """Bytes of sparsity metadata a format carries beyond its values."""
    if isinstance(pack, NMPack):
        return pack.idx.numel() * 4
    raise NotImplementedError(
        f"metadata_bytes of {type(pack).__name__}: only NMPack is ported "
        "(other formats are ROADMAP queue 1 item 10)")


def values_bytes(pack) -> int:
    if isinstance(pack, NMPack):
        return pack.values.numel() * pack.values.element_size()
    raise NotImplementedError(
        f"values_bytes of {type(pack).__name__}: only NMPack is ported "
        "(other formats are ROADMAP queue 1 item 10)")
