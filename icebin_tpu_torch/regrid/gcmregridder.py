"""The port's own copy of ``icebin_tpu/regrid/gcmregridder.py``; it imports
nothing of the reference package.  The one difference: the regridder holds
a ``device``, and ``add_sheet`` builds each sheet's exchange grid through
the port's clip kernels there (the reference's ``engine`` is gone).

GCMRegridder: the top-level container tying A grid, elevation classes,
and per-ice-sheet exchange grids together.

Reference: ``GCMRegridder_Standard`` owns gridA, ``hcdefs``, ``indexingHC``,
and a dict of per-sheet ``IceRegridder``s, and hands out matrix factories via
``regrid_matrices(sheet, elevmaskI)`` (reference: ``slib/icebin/
GCMRegridder.*`` [U]; SURVEY.md sections 2-3).  NetCDF round-trip lives in
``icebin_tpu.io.ncio``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from icebin_tpu_torch.grid.exchange import (ExchangeGrid, make_exchange_grid,
                                            prepare_subject_polygons)
from icebin_tpu_torch.grid.spec import Grid, GridSpecXY
from icebin_tpu_torch.regrid.device import DeviceExchange
from icebin_tpu_torch.regrid.matrices import RegridMatrices
from icebin_tpu_torch.utils.indexing import Indexing

__all__ = ["IceSheet", "GCMRegridder"]


@dataclasses.dataclass
class IceSheet:
    """One ice sheet: its grid, its exchange grid vs gridA, and the projected
    areas of the A cells under this sheet's projection (for correctA)."""

    name: str
    gridI: Grid
    exchange: ExchangeGrid
    areaA_proj: np.ndarray

    @property
    def specI(self) -> GridSpecXY:
        return self.gridI.spec


class GCMRegridder:
    """Reference API parity: ``add_sheet`` <-> grid/exchange ingestion,
    ``regrid_matrices(sheet, elevmaskI)`` -> matrix factory;
    ``device_exchange(sheet, device)`` -> what regeneration on the device
    reads."""

    #: the GCM grid the matrices are built over (the ``regen`` span's
    #: ``grid``): the A grid's own exchange grids
    grid_kind = "lonlat"

    def __init__(self, gridA, hcdefs, *, device,
                 sheets: Optional[Dict[str, IceSheet]] = None):
        """``device`` is where exchange-grid clipping runs."""
        self.device = torch.device(device)
        self.gridA = gridA if isinstance(gridA, Grid) else Grid(gridA)
        self.hcdefs = np.asarray(hcdefs, dtype=np.float64)
        self.sheets: Dict[str, IceSheet] = sheets or {}

    @property
    def specA(self):
        return self.gridA.spec

    @property
    def nA(self) -> int:
        return self.specA.ncells

    @property
    def nhc(self) -> int:
        return len(self.hcdefs)

    @property
    def nE(self) -> int:
        return self.nA * self.nhc

    @property
    def indexingE(self) -> Indexing:
        """E flat index = a * nhc + ihc (a-major; see
        ``regrid.matrices`` docstring).  ModelE's ihc-major (i, j, ihc)
        ordering (reference ``indexingHC`` [U]) is obtained by permutation in
        ``models.modele_adapter``."""
        nlon, nlat = self.specA.shape
        return Indexing.f_order((self.nhc, nlon, nlat),
                                names=("hc", "lon", "lat"))

    def _areaA_proj_for(self, specI: GridSpecXY,
                        subdiv: int = 2) -> np.ndarray:
        """Projected-plane area of each full A cell under the sheet's
        projection (native area where the cell doesn't project sanely, making
        the correctA ratio exactly 1 there).  ``subdiv`` matches the
        exchange build's edge subdivision so the correctA measure and the
        overlap areas share one polygon approximation."""
        polysA, keep = prepare_subject_polygons(self.specA, specI,
                                                subdiv=subdiv)
        x = polysA[:, :, 0]
        y = polysA[:, :, 1]
        a = 0.5 * np.abs(np.sum(x * np.roll(y, -1, axis=1)
                                - np.roll(x, -1, axis=1) * y, axis=1))
        native = self.specA.cell_areas()
        return np.where(keep, a, native)

    def add_sheet(self, name: str, gridI, exchange: Optional[ExchangeGrid] = None,
                  subdiv: int = 2) -> IceSheet:
        gridI = gridI if isinstance(gridI, Grid) else Grid(gridI)
        if exchange is None:
            exchange = make_exchange_grid(self.gridA, gridI, subdiv=subdiv,
                                          device=self.device)
        sheet = IceSheet(name=name, gridI=gridI, exchange=exchange,
                         areaA_proj=self._areaA_proj_for(gridI.spec,
                                                         subdiv=subdiv))
        self.sheets[name] = sheet
        return sheet

    def device_exchange(self, sheet_name: str, device):
        """The sheet's exchange grid and correctA factors uploaded to
        ``device`` (``regrid.device.DeviceExchange``)."""
        return DeviceExchange(self, sheet_name, device)

    def regrid_matrices(self, sheet_name: str, elevmaskI,
                        smooth: bool = True) -> RegridMatrices:
        """elevmaskI: (nI,) surface elevation [m] where ice exists, NaN where
        not (reference elevmaskI semantics [U])."""
        sheet = self.sheets[sheet_name]
        fn = None
        if smooth:
            from icebin_tpu_torch.ops.smoother import smoothing_matrix

            def fn(sigma, _sheet=sheet, _elev=np.asarray(elevmaskI)):
                return smoothing_matrix(_sheet.specI,
                                        np.isfinite(_elev).reshape(-1), sigma,
                                        elev=_elev)
        return RegridMatrices(
            xg=sheet.exchange,
            elevmaskI=elevmaskI,
            hcdefs=self.hcdefs,
            areaA_native=self.specA.cell_areas(),
            areaA_proj=sheet.areaA_proj,
            areaI=sheet.specI.cell_areas(),
            smoothing_matrix_fn=fn,
        )
