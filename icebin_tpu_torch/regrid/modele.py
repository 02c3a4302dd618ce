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
  A cells with LAp == 0 (no p-land at all) keep factor 1.
"""
from __future__ import annotations

import numpy as np

from icebin_tpu_torch.grid.spec import GridSpecLonLat
from icebin_tpu_torch.regrid.gcmregridder import GCMRegridder
from icebin_tpu_torch.regrid.hntr import hntr_matrix
from icebin_tpu_torch.regrid.matrices import RegridMatrices, RegridParams

__all__ = ["GCMRegridderModelE"]


class GCMRegridderModelE:
    """Mismatched A/O regridder (reference ``GCMRegridder_ModelE`` [U])."""

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

    @property
    def nA(self) -> int:
        return self.specA.ncells

    @property
    def nhc(self) -> int:
        return self.grO.nhc

    @property
    def nE(self) -> int:
        return self.nA * self.nhc

    def regrid_matrices(self, sheet_name: str, elevmaskI) -> "._Factory":
        rmO = self.grO.regrid_matrices(sheet_name, elevmaskI)
        return _MismatchedFactory(self, rmO)


class _MismatchedFactory:
    """Produces AvI/IvA/EvI/IvE/AvE/EvA on the ATMOSPHERE grid with the
    mismatch correction (reference ``compute_AAmvEAm`` family [U])."""

    def __init__(self, parent: GCMRegridderModelE, rmO: RegridMatrices):
        self.p = parent
        # Re-target the O-level factory's exchange cells at the A level.
        iA = parent.iA_of_O[rmO.iA]           # A parent of each exchange cell
        self.rm = RegridMatrices.__new__(RegridMatrices)
        r = self.rm
        r.elevmaskI = rmO.elevmaskI
        r.hcdefs = rmO.hcdefs
        r.nA = parent.nA
        r.nI = rmO.nI
        r.nhc = rmO.nhc
        r.nE = parent.nA * rmO.nhc
        r.xg_index = rmO.xg_index
        r.iA = iA
        r.iI = rmO.iI
        # mismatch diagonal: contributions scaled by LAm/LAp of the A parent
        r.o = rmO.o * parent.sAm[iA]
        r.centroid = rmO.centroid
        # correctA at the A level: native/projected area ratios aggregated
        # from the O grid (projection distortion is smooth across an A cell)
        areaA_nat = parent.specA.cell_areas()
        areaA_proj = np.bincount(parent.iA_of_O, weights=rmO.areaA_proj,
                                 minlength=parent.nA)
        r.areaA_native = areaA_nat
        r.areaA_proj = np.where(areaA_proj > 0, areaA_proj, areaA_nat)
        r.areaI = rmO.areaI
        r._smoothing_fn = rmO._smoothing_fn
        # EC split against the A-level E space
        from icebin_tpu_torch.regrid.matrices import elevation_class_split
        elev_x = r.elevmaskI[r.iI]
        k0, k1, w0, w1 = elevation_class_split(elev_x, r.hcdefs)
        r.iE0 = r.iA * r.nhc + k0
        r.iE1 = r.iA * r.nhc + k1
        r.wE0 = w0
        r.wE1 = w1

    def matrix(self, name: str, params: RegridParams = RegridParams()):
        return self.rm.matrix(name, params)

    def fhc(self):
        return self.rm.fhc()

    def elevE(self):
        return self.rm.elevE()
