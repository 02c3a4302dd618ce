"""Grids and the exchange-grid build through the port's clip kernel.

The grid specs and projections are the reference's host classes (numpy,
no JAX), re-exported here so that a user of the port needs no import from
``icebin_tpu``.
"""
from icebin_tpu.grid.proj import PlateCarree
from icebin_tpu.grid.spec import (Grid, GridSpecLonLat, GridSpecXY,
                                  modele_lonlat_grid)

from icebin_tpu_torch.grid.exchange import (clip_pairs, make_exchange_grid,
                                            make_exchange_grid_host)

__all__ = ["Grid", "GridSpecLonLat", "GridSpecXY", "PlateCarree",
           "clip_pairs", "make_exchange_grid", "make_exchange_grid_host",
           "modele_lonlat_grid"]
