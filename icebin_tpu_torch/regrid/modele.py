"""The port's own copy of ``icebin_tpu/regrid/modele.py`` (numpy over the
port's ``RegridMatrices``); it imports nothing of the reference package.
``gr_ocean`` is the port's ``GCMRegridder``: its sheets' O-level exchange
grids are clipped on its ``device``.

GCMRegridder_ModelE: mismatched atmosphere/ocean-grid regridding.

Reference: ``slib/icebin/modele/GCMRegridder_ModelE.*`` [U] (SURVEY.md
section 2 "GCMRegridder_ModelE (mismatched)").  The ModelE quirk: the
atmosphere runs on grid A, but land/ocean fractions are defined on the finer
ocean grid O (A is an exact coarsening of O), and ModelE uses a ROUNDED 0/1
ocean mask ``foceanOm`` while the ice-sheet data implies a fractional
``foceanOp``.  Ice can therefore sit on cells ModelE considers pure ocean.
The mismatched regridder corrects the I<->A(E) matrices so that mass is
conserved against the *p* (true) measure while fields are expressed against
ModelE's *m* (rounded) land areas.

TPU-native construction (documented rule, tested):

* the exchange grid is built against the OCEAN grid O (finer: better
  geometry), each O cell nests exactly in one A cell;
* per-A land areas:  LAm[a] = sum_{o in a} (1-foceanOm[o]) areaO[o],
                     LAp[a] = sum_{o in a} (1-foceanOp[o]) areaO[o];
* every exchange-cell contribution to A (or E=A x EC) is scaled by
  sAm[a] = LAm[a]/LAp[a] (the reference's ``sAAmvAAp``-style diagonal):
  scaled means are unchanged, but the weight vectors measure ModelE's land
  areas, so ModelE's own area accounting conserves the true ice mass.
  A cells with LAp == 0 (no p-land at all) keep factor 1; an A cell with
  LAm == 0 < LAp gets factor 0: its exchange cells weigh nothing.

The port's additions, so that ``GCMCoupler`` runs over it as over a plain
``GCMRegridder``: ``sheets`` (each sheet's grid; its exchange grid is O's,
``OceanSheet.exchangeO``, and no reader takes it for A's), ``hcdefs``,
``device``, ``nA``/``nE`` of A; ``regrid_matrices`` returns the
retargeted ``RegridMatrices`` itself (the host path: sigma, a mesh rank,
TOPO, E1vE0); ``device_exchange`` moves the O-level exchange cells to A
and scales them once, at upload (span ``regen.retarget``), so the device
regeneration (``regrid.device``) runs unchanged on A-level cells, bit for
bit the host factory.  Counters: ``rescaled`` (A cells with sAm != 1),
``zeroed`` (sAm == 0).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from icebin_tpu_torch.grid.exchange import ExchangeGrid
from icebin_tpu_torch.grid.spec import Grid, GridSpecLonLat
from icebin_tpu_torch.regrid.device import DeviceExchange
from icebin_tpu_torch.regrid.gcmregridder import GCMRegridder
from icebin_tpu_torch.regrid.hntr import hntr_matrix
from icebin_tpu_torch.regrid.matrices import (RegridMatrices,
                                              elevation_class_split)
from icebin_tpu_torch.utils.trace import span

__all__ = ["GCMRegridderModelE", "OceanSheet"]


@dataclasses.dataclass(frozen=True)
class OceanSheet:
    """One ice sheet of a ``GCMRegridderModelE``: its grid, and its
    exchange grid against the ocean grid O (not A: it has no
    ``exchange``)."""

    name: str
    gridI: Grid
    exchangeO: ExchangeGrid

    @property
    def specI(self):
        return self.gridI.spec


class GCMRegridderModelE:
    """Mismatched A/O regridder (reference ``GCMRegridder_ModelE`` [U])."""

    #: the GCM grid the matrices are built over (the ``regen`` span's
    #: ``grid``)
    grid_kind = "modele_ocean"

    def __init__(self, gr_ocean: GCMRegridder, specA: GridSpecLonLat,
                 foceanOp, foceanOm):
        self.grO = gr_ocean
        self.specA = specA
        self.specO = gr_ocean.specA
        self.foceanOp = np.asarray(foceanOp, dtype=np.float64).reshape(-1)
        self.foceanOm = np.asarray(foceanOm, dtype=np.float64).reshape(-1)
        if len(self.foceanOp) != self.specO.ncells:
            raise ValueError("foceanOp size mismatch with ocean grid")
        if not np.isin(np.round(self.foceanOm, 12), [0.0, 1.0]).all():
            raise ValueError("foceanOm must be a rounded 0/1 mask")
        # O -> A nesting via the exact overlap matrix: each O cell must land
        # in exactly one A cell.
        AvO = hntr_matrix(specA, self.specO)
        counts = np.bincount(AvO.cols, minlength=self.specO.ncells)
        if (counts != 1).any():
            raise ValueError("ocean grid does not nest exactly in the "
                             "atmosphere grid")
        self.iA_of_O = np.empty(self.specO.ncells, dtype=np.int64)
        self.iA_of_O[AvO.cols] = AvO.rows
        areaO = self.specO.cell_areas()
        self.LAm = np.bincount(self.iA_of_O,
                               weights=(1.0 - self.foceanOm) * areaO,
                               minlength=specA.ncells)
        self.LAp = np.bincount(self.iA_of_O,
                               weights=(1.0 - self.foceanOp) * areaO,
                               minlength=specA.ncells)
        with np.errstate(divide="ignore", invalid="ignore"):
            self.sAm = np.where(self.LAp > 0, self.LAm / np.where(
                self.LAp > 0, self.LAp, 1.0), 1.0)
        #: A cells whose contributions the mismatch rescales, and zeroes
        self.rescaled = int(np.count_nonzero(self.sAm != 1.0))
        self.zeroed = int(np.count_nonzero(self.sAm == 0.0))

    @property
    def nA(self) -> int:
        return self.specA.ncells

    @property
    def nhc(self) -> int:
        return self.grO.nhc

    @property
    def nE(self) -> int:
        return self.nA * self.nhc

    @property
    def hcdefs(self) -> np.ndarray:
        return self.grO.hcdefs

    @property
    def device(self):
        return self.grO.device

    @property
    def sheets(self) -> Dict[str, OceanSheet]:
        return {n: OceanSheet(n, sh.gridI, sh.exchange)
                for n, sh in self.grO.sheets.items()}

    def _exchangeO(self, sheet_name: str) -> ExchangeGrid:
        xg = self.grO.sheets[sheet_name].exchange
        if int(xg.nA) != self.specO.ncells:
            raise ValueError(f"sheet {sheet_name!r}'s exchange grid is "
                             f"against {xg.nA} cells, not the ocean grid's "
                             f"{self.specO.ncells}")
        return xg

    def areaA_proj(self, sheet_name: str) -> np.ndarray:
        """(nA,) projected-plane area of each A cell under the sheet's
        projection: its O cells' summed (native where none projects)."""
        areaA_nat = self.specA.cell_areas()
        proj = np.bincount(self.iA_of_O,
                           weights=self.grO.sheets[sheet_name].areaA_proj,
                           minlength=self.nA)
        return np.where(proj > 0, proj, areaA_nat)

    def regrid_matrices(self, sheet_name: str, elevmaskI,
                        smooth: bool = True) -> RegridMatrices:
        """The O-level factory's exchange cells retargeted at A, with the
        mismatch factor (reference ``compute_AAmvEAm`` family [U])."""
        self._exchangeO(sheet_name)
        rmO = self.grO.regrid_matrices(sheet_name, elevmaskI, smooth=smooth)
        iA = self.iA_of_O[rmO.iA]            # A parent of each exchange cell
        r = RegridMatrices.__new__(RegridMatrices)
        r.elevmaskI = rmO.elevmaskI
        r.hcdefs = rmO.hcdefs
        r.nA = self.nA
        r.nI = rmO.nI
        r.nhc = rmO.nhc
        r.nE = self.nA * rmO.nhc
        r.xg_index = rmO.xg_index
        r.iA = iA
        r.iI = rmO.iI
        # mismatch diagonal: contributions scaled by LAm/LAp of the A parent
        r.o = rmO.o * self.sAm[iA]
        r.centroid = rmO.centroid
        # correctA at the A level: native/projected area ratios aggregated
        # from the O grid (projection distortion is smooth across an A cell)
        r.areaA_native = self.specA.cell_areas()
        r.areaA_proj = self.areaA_proj(sheet_name)
        r.areaI = rmO.areaI
        r._smoothing_fn = rmO._smoothing_fn
        # EC split against the A-level E space
        elev_x = r.elevmaskI[r.iI]
        k0, k1, w0, w1 = elevation_class_split(elev_x, r.hcdefs)
        r.iE0 = r.iA * r.nhc + k0
        r.iE1 = r.iA * r.nhc + k1
        r.wE0 = w0
        r.wE1 = w1
        return r

    def device_exchange(self, sheet_name: str, device) -> DeviceExchange:
        """The sheet's O-level exchange cells on ``device``, each moved to
        the A cell holding its O cell and its area scaled by that cell's
        sAm (``regrid_matrices``'s product, in f64, once), with the A-level
        correctA factors; its cells over O cells ModelE counts as ocean
        are marked (``DeviceExchange.ocean_iced``)."""
        xg = self._exchangeO(sheet_name)
        iO = np.asarray(xg.iA, np.int64)
        with span("regen.retarget", sheet=sheet_name, cells=len(iO),
                  rescaled=self.rescaled):
            iA = self.iA_of_O[iO]
            area = np.asarray(xg.area, np.float64) * self.sAm[iA]
            proj = self.areaA_proj(sheet_name)
            cA = self.specA.cell_areas() / np.where(proj > 0, proj, 1.0)
            return DeviceExchange.of(iA, xg.iI, area, cA, xg.nI,
                                     self.hcdefs, device,
                                     ocean=self.foceanOm[iO] == 1.0)
