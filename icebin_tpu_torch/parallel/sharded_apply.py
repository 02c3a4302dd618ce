"""Regrid applies decomposed over the ice axis (port of
``icebin_tpu/parallel/pallas_spmv.py``).

The ice axis (the canonical small x ice matrix's columns) is cut into
contiguous cell ranges, one a rank; the small (A/E) space is replicated.
Each rank packs its own ``CsrPack`` over its range (``ShardedCsr``, the
counterpart of ``ShardedPallasBDT`` and ``sharded_pallas_from_weighted``,
``pallas_spmv.py:50,128``) and runs the port's kernels on it:

* dest-small (EvI/AvI, ``make_sharded_apply_small``, ``:339-355,373``): K2
  with ``scale=False`` gives the rank's partial small-space sums, kept in
  f64 (``dtype=torch.float64``: not rounded); the partials are added
  across ranks in f64 in rank order (``IceMesh.sum_ranks``) and then
  scaled by the global ``winv`` and rounded once, so at one rank the
  result is the single-rank apply's bit for bit;
* dest-ice (IvE/IvA, ``make_sharded_apply_ice``, ``:358-370,390``): the
  small field is replicated, so K1 with ``scale=True`` on the rank's rows
  needs no communication.  Each ice row's entries all lie on its rank, so
  the result is the single-rank apply's rows bit for bit.

The reference pads every shard to common static tile geometry
(``:160-200``) so one ``shard_map`` program serves them all; processes
need no common geometry, and the CSR needs no 128-cell blocks.
``ShardedView`` is the one view of both directions, with the surface of
``ops.csr.CsrView`` (``wM``, ``Mw``, ``logical_shape``, ``apply_core``),
so ``ops.apply.apply_view`` applies it as it applies a ``CsrView``; the
reference's argument-passing twin (``ArgShardedView``, ``:490``) existed to
keep a jit trace, which the port does not have.

Weights are the matrix's own, as the single-rank pack takes them: ``wS``
the global small-space weights (a rank's entries hold only part of each),
``wI`` the rank's cells' (zero on pad cells).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from icebin_tpu_torch.ops.apply import apply_ice, apply_small
from icebin_tpu_torch.ops.csr import CsrPack, csr_from_coo

__all__ = ["ShardedCsr", "ShardedView", "sharded_csr_from_weighted",
           "make_sharded_apply_small", "make_sharded_apply_ice",
           "sharded_view_pair"]

_F64 = torch.float64


@dataclasses.dataclass
class ShardedCsr:
    """This rank's pack of a matrix whose ice axis is cut into ranges of
    ``cells_per_shard`` cells: ``pack`` over cells [c0, c0 +
    cells_per_shard) of the ``nice``-cell (possibly row-padded) ice axis,
    with the GLOBAL small-space weights (``pack.wS``, and the f32 ``winv``
    of ``pack.small``)."""

    pack: CsrPack
    c0: int
    cells_per_shard: int
    nice: int

    @property
    def nsmall(self) -> int:
        return self.pack.nsmall


def sharded_csr_from_weighted(mesh, M, small_axis: str = "rows",
                              nv: int = 16,
                              cells_per_shard: Optional[int] = None,
                              nice_pad: Optional[int] = None) -> ShardedCsr:
    """Pack this rank's column range of ``M`` (a ``WeightedMatrix``;
    ``small_axis`` names its small side).  ``cells_per_shard`` defaults to
    ceil(nice / ranks); a RAGGED lattice decomposition passes its rows per
    rank times nx, and ``nice_pad`` the padded lattice's cells (pad cells
    carry no entries and zero weight)."""
    if small_axis == "rows":
        s, i = M.rows, M.cols
        nsmall, nice = M.shape
        wS, wI_all = M.wM, M.Mw
    elif small_axis == "cols":
        s, i = M.cols, M.rows
        nice, nsmall = M.shape
        wS, wI_all = M.Mw, M.wM
    else:
        raise ValueError(f"small_axis must be 'rows' or 'cols', "
                         f"got {small_axis!r}")
    s = np.asarray(s, np.int64)
    i = np.asarray(i, np.int64)
    v = np.asarray(M.vals, np.float64)
    nice_out = nice_pad or nice
    cps = int(cells_per_shard or -(-nice_out // mesh.size))
    c0 = mesh.rank * cps
    sel = (i >= c0) & (i < c0 + cps)
    il = i[sel] - c0
    wS = np.asarray(wS, np.float64)                       # global
    wI = np.zeros(cps)
    mine = np.asarray(wI_all, np.float64)[c0:c0 + cps]
    wI[:len(mine)] = mine
    dev = mesh.device
    pack = CsrPack(
        small=csr_from_coo(s[sel], il, v[sel], nsmall, cps, wS, device=dev),
        ice=csr_from_coo(il, s[sel], v[sel], cps, nsmall, wI, device=dev),
        wS=torch.as_tensor(wS, device=dev),
        wI=torch.as_tensor(wI, device=dev), nv=int(nv))
    return ShardedCsr(pack=pack, c0=c0, cells_per_shard=cps, nice=nice_out)


def make_sharded_apply_small(mesh, sc: ShardedCsr):
    """fn(f (nvar, cells_per_shard) local ice field, scale=True) -> (nvar,
    nsmall) f32 small field, the same on every rank: K2's unscaled f64
    partial on each rank, the partials added in f64 in rank order, times
    the global ``winv`` (with ``scale``), rounded once."""
    winv = sc.pack.small.winv.to(_F64)

    def fn(f, scale=True):
        part = apply_small(sc.pack, f, scale=False, dtype=_F64)
        (tot,) = mesh.sum_ranks(part)
        return (tot * winv if scale else tot).to(torch.float32)

    return fn


def make_sharded_apply_ice(mesh, sc: ShardedCsr):
    """fn(e (nvar, nsmall) replicated, scale=True) -> (nvar,
    cells_per_shard) f32 local ice field through K1; no communication."""
    return lambda e, scale=True: apply_ice(sc.pack, e, scale=scale)


@dataclasses.dataclass
class ShardedView:
    """A logical direction over a ``ShardedCsr`` (``CsrView``'s surface):
    ``transposed=False`` is small <- ice (EvI/AvI; fields in are the rank's
    cells, out replicated), ``True`` ice <- small (IvE/IvA; in replicated,
    out the rank's cells).  Ice-space weights are the rank's cells'."""

    mesh: object
    sc: ShardedCsr
    transposed: bool

    def __post_init__(self):
        self._small = make_sharded_apply_small(self.mesh, self.sc)
        self._ice = make_sharded_apply_ice(self.mesh, self.sc)

    @property
    def pack(self) -> CsrPack:
        return self.sc.pack

    @property
    def wM(self) -> torch.Tensor:
        return self.pack.wI if self.transposed else self.pack.wS

    @property
    def Mw(self) -> torch.Tensor:
        return self.pack.wS if self.transposed else self.pack.wI

    @property
    def logical_shape(self):
        return ((self.sc.nice, self.sc.nsmall) if self.transposed
                else (self.sc.nsmall, self.sc.nice))

    def apply_core(self, f: torch.Tensor, scale: bool = True):
        """(nvar, n) through this direction's sharded apply, before
        ``ops.apply.apply_view``'s fill and unit conversion."""
        return (self._ice if self.transposed else self._small)(f, scale)


def sharded_view_pair(mesh, M, small_axis: str = "rows", nv: int = 16,
                      cells_per_shard: Optional[int] = None,
                      nice_pad: Optional[int] = None):
    """(forward_view, reverse_view) over one ``ShardedCsr`` of ``M``
    (``pallas_spmv.py:519``): forward applies M, reverse its transpose."""
    sc = sharded_csr_from_weighted(mesh, M, small_axis=small_axis, nv=nv,
                                   cells_per_shard=cells_per_shard,
                                   nice_pad=nice_pad)
    fwd = ShardedView(mesh, sc, transposed=(small_axis == "cols"))
    return fwd, ShardedView(mesh, sc, transposed=not fwd.transposed)
