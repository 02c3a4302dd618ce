"""GCMRegridder whose sheets build their exchange grids through the port.

The shared ``icebin_tpu.regrid.gcmregridder.GCMRegridder`` holds the A grid,
elevation classes and per-sheet exchange grids and hands out the host-side
matrix factories; its default ``add_sheet`` engine ("auto") would import
JAX.  This subclass builds each sheet's exchange grid with the port's clip
kernel on ``device`` and passes it in as ``exchange=``.
"""
from __future__ import annotations

import torch

from icebin_tpu.grid.spec import Grid
from icebin_tpu.regrid import gcmregridder as _shared

from icebin_tpu_torch.grid.exchange import make_exchange_grid

__all__ = ["GCMRegridder"]


class GCMRegridder(_shared.GCMRegridder):
    """``device`` is where exchange-grid clipping runs."""

    def __init__(self, gridA, hcdefs, *, device, sheets=None):
        super().__init__(gridA, hcdefs, sheets)
        self.device = torch.device(device)

    def add_sheet(self, name: str, gridI, exchange=None,
                  subdiv: int = 2) -> _shared.IceSheet:
        gridI = gridI if isinstance(gridI, Grid) else Grid(gridI)
        if exchange is None:
            exchange = make_exchange_grid(self.gridA, gridI, subdiv=subdiv,
                                          device=self.device)
        return super().add_sheet(name, gridI, exchange=exchange,
                                 subdiv=subdiv)
