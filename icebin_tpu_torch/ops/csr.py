"""Device pack of a regrid matrix: one destination-sorted CSR per direction.

Port of the packing half of ``icebin_tpu/ops/pallas_bdt.py``
(``pallas_from_weighted``, ``PallasView``, ``pallas_view_pair``).  The TPU
pack's 8x128 tiles, pseudo-blocks, E3 lane order and W8 band exist only to
avoid gathers on the TPU (``icebin_tpu/ops/bdt.py`` docstring); Hopper
gathers natively, so each direction is stored as a plain CSR sorted by
destination: f32 values, int32 column indices, and the f32 inverse
destination weight ``winv = 1/w`` (computed in f64; 0 where w = 0).  Two
copies of the matrix cost twice its bytes but give both applies a fixed,
atomic-free summation order.  Each CSR also holds the list of its live
(non-empty) rows, longest first, which the dest-small kernel launches over;
it is derived from ``rowptr`` whenever a ``Csr`` is made, so a CSR made
from another (``dataclasses.replace``) gets its own.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Csr", "CsrPack", "CsrView", "csr_from_coo", "csr_pack",
           "csr_view_pair"]

_I32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass
class Csr:
    """Destination-sorted CSR of one apply direction (dest x src)."""

    rowptr: torch.Tensor      # (n_dst + 1,) int32
    cols: torch.Tensor        # (nnz,) int32 source indices
    vals: torch.Tensor        # (nnz,) f32 unscaled entries
    winv: torch.Tensor        # (n_dst,) f32 1/w_dst (0 where w_dst == 0)
    n_dst: int
    n_src: int
    # (n_live,) int32: the non-empty rows, longest first (ties by index).
    # Always derived from rowptr when a Csr is made (a value passed in,
    # e.g. copied by dataclasses.replace, is replaced).
    live: torch.Tensor | None = dataclasses.field(default=None, repr=False,
                                                  compare=False)
    n_live: int | None = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        # once per pack, on the rowptr's device; one host sync for n_live
        lens = self.rowptr[1:] - self.rowptr[:-1]
        order = torch.argsort(lens, descending=True, stable=True)
        self.n_live = int((lens > 0).sum())
        self.live = order[:self.n_live].to(torch.int32)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def rows(self) -> torch.Tensor:
        """(nnz,) int64 destination row of every nonzero."""
        counts = (self.rowptr[1:] - self.rowptr[:-1]).to(torch.int64)
        return torch.repeat_interleave(
            torch.arange(self.n_dst, device=self.device), counts)


def csr_from_coo(dst, src, vals, n_dst: int, n_src: int, w_dst, *,
                 device) -> Csr:
    """Pack COO entries (dst, src, vals) sorted by (dst, src)."""
    dst = np.asarray(dst, np.int64)
    src = np.asarray(src, np.int64)
    if len(vals) > _I32_MAX or max(n_dst, n_src) > _I32_MAX:
        raise ValueError("matrix too large for int32 CSR indices")
    order = np.lexsort((src, dst))
    rowptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n_dst), out=rowptr[1:])
    w = np.asarray(w_dst, np.float64)
    winv = np.where(w != 0, 1.0 / np.where(w != 0, w, 1.0), 0.0)

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return Csr(rowptr=put(rowptr, torch.int32),
               cols=put(src[order], torch.int32),
               vals=put(np.asarray(vals, np.float64)[order], torch.float32),
               winv=put(winv, torch.float32),
               n_dst=int(n_dst), n_src=int(n_src))


@dataclasses.dataclass
class CsrPack:
    """Both directions of one matrix in its canonical (small x ice)
    orientation: ``small`` applies with the dest-small kernel (EvI/AvI),
    ``ice`` with the dest-ice kernel (IvE/IvA).  Weights are f64: the
    coupler's mass books read them."""

    small: Csr
    ice: Csr
    wS: torch.Tensor          # (nsmall,) f64
    wI: torch.Tensor          # (nice,) f64
    nv: int                   # field batch width of one kernel call

    @property
    def nsmall(self) -> int:
        return self.small.n_dst

    @property
    def nice(self) -> int:
        return self.ice.n_dst


def csr_pack(M, small_axis: str = "rows", nv: int = 16, *,
             device) -> CsrPack:
    """Pack a ``WeightedMatrix`` for the device (``pallas_from_weighted``'s
    counterpart).  ``small_axis`` names M's few-and-long-rows side."""
    if small_axis == "rows":
        s, i = M.rows, M.cols
        nsmall, nice = M.shape
        wS, wI = M.wM, M.Mw
    elif small_axis == "cols":
        s, i = M.cols, M.rows
        nice, nsmall = M.shape
        wS, wI = M.Mw, M.wM
    else:
        raise ValueError(f"small_axis must be 'rows' or 'cols', "
                         f"got {small_axis!r}")
    return CsrPack(
        small=csr_from_coo(s, i, M.vals, nsmall, nice, wS, device=device),
        ice=csr_from_coo(i, s, M.vals, nice, nsmall, wI, device=device),
        wS=torch.as_tensor(np.asarray(wS, np.float64), device=device),
        wI=torch.as_tensor(np.asarray(wI, np.float64), device=device),
        nv=int(nv))


@dataclasses.dataclass
class CsrView:
    """A logical direction over a pack (``PallasView``'s counterpart):
    ``transposed=False`` is small <- ice (EvI/AvI), ``True`` ice <- small
    (IvE/IvA)."""

    pack: CsrPack
    transposed: bool

    @property
    def wM(self) -> torch.Tensor:
        return self.pack.wI if self.transposed else self.pack.wS

    @property
    def Mw(self) -> torch.Tensor:
        return self.pack.wS if self.transposed else self.pack.wI

    @property
    def logical_shape(self):
        p = self.pack
        return (p.nice, p.nsmall) if self.transposed else (p.nsmall, p.nice)


def csr_view_pair(M, nv: int = 16, small_axis: str = "rows", *, device):
    """(forward_view, reverse_view) over one pack of ``M``: forward applies
    M itself, reverse its transpose."""
    pack = csr_pack(M, small_axis=small_axis, nv=nv, device=device)
    fwd = CsrView(pack, transposed=(small_axis == "cols"))
    return fwd, CsrView(pack, transposed=not fwd.transposed)
