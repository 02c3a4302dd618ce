"""Grids and the exchange-grid build through the port's clip kernel.

The grid specs and projections are the reference's host classes (numpy,
no JAX), re-exported here so that a user of the port needs no import from
``icebin_tpu``.
"""
from icebin_tpu.grid.proj import PlateCarree
from icebin_tpu.grid.spec import (Grid, GridSpecGeneric, GridSpecLonLat,
                                  GridSpecXY, modele_lonlat_grid)

from icebin_tpu_torch.grid.exchange import (assemble_polyclip, clip_pairs,
                                            clip_poly_host,
                                            make_exchange_grid,
                                            make_exchange_grid_host,
                                            make_exchange_grid_polyclip,
                                            polyclip_pairs, polyclip_pieces)

__all__ = ["Grid", "GridSpecGeneric", "GridSpecLonLat", "GridSpecXY",
           "PlateCarree", "assemble_polyclip", "clip_pairs",
           "clip_poly_host", "make_exchange_grid", "make_exchange_grid_host",
           "make_exchange_grid_polyclip", "modele_lonlat_grid",
           "polyclip_pairs", "polyclip_pieces"]
