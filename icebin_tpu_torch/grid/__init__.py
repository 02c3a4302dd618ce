"""Grids and the exchange-grid build through the port's clip kernels.

The grid specs, projections and region predicates are the port's own
copies of the reference's (``proj``, ``spec``, ``gen``), so a user of the
port needs no import from ``icebin_tpu``.
"""
from icebin_tpu_torch.grid.proj import PlateCarree
from icebin_tpu_torch.grid.spec import (Grid, GridSpecGeneric, GridSpecLonLat,
                                        GridSpecXY, modele_lonlat_grid)

from icebin_tpu_torch.grid.gen import (clipped_grid, euclidian_clip_box,
                                       euclidian_clip_circle,
                                       spherical_clip_cap,
                                       spherical_clip_lonlat)
from icebin_tpu_torch.grid.exchange import (ExchangeGrid, assemble_polyclip,
                                            clip_pairs, clip_poly_host,
                                            make_exchange_grid,
                                            make_exchange_grid_host,
                                            polyclip_pairs, polyclip_pieces)

__all__ = ["ExchangeGrid", "Grid", "GridSpecGeneric", "GridSpecLonLat",
           "GridSpecXY", "PlateCarree", "assemble_polyclip", "clip_pairs",
           "clip_poly_host", "clipped_grid", "euclidian_clip_box",
           "euclidian_clip_circle", "make_exchange_grid",
           "make_exchange_grid_host", "modele_lonlat_grid", "polyclip_pairs",
           "polyclip_pieces", "spherical_clip_cap", "spherical_clip_lonlat"]
