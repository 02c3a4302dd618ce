"""The port's own copy of ``icebin_tpu/grid/gen.py``; it imports
nothing of the reference package.

Grid generation helpers: region clipping predicates.

Reference: ``slib/icebin/gridgen/`` materializes grids cell-by-cell,
dropping cells outside a region of interest via clipping predicates
(``SphericalClip``/``EuclidianClip`` [U]; SURVEY.md section 2 "Grid
generators").  Here grids are dense specs with realized-cell masks, so the
predicates become vectorized mask builders over cell centers -- same
capability (bound a grid to Greenland, a lon/lat window, a circle), TPU-era
representation.
"""
from __future__ import annotations

import numpy as np

from icebin_tpu_torch.grid.spec import Grid, GridSpecLonLat, GridSpecXY

__all__ = ["spherical_clip_lonlat", "spherical_clip_cap",
           "euclidian_clip_box", "euclidian_clip_circle", "clipped_grid"]


def spherical_clip_lonlat(spec: GridSpecLonLat, lon0, lon1, lat0, lat1):
    """Mask of cells whose centers fall in the lon/lat window (lon wraps).
    Reference ``SphericalClip::lonlat`` [U]."""
    c = spec.cell_centers()
    lon = (c[:, 0] - lon0) % 360.0
    span = (lon1 - lon0) % 360.0 or 360.0
    return (lon <= span) & (c[:, 1] >= lat0) & (c[:, 1] <= lat1)


def spherical_clip_cap(spec: GridSpecLonLat, lat: float, north: bool = True):
    """Polar-cap mask (e.g. everything south of -60 for Antarctica runs)."""
    c = spec.cell_centers()
    return c[:, 1] >= lat if north else c[:, 1] <= lat


def euclidian_clip_box(spec: GridSpecXY, x0, y0, x1, y1):
    """Reference ``EuclidianClip`` box predicate [U], vectorized."""
    c = spec.cell_centers()
    return ((c[:, 0] >= x0) & (c[:, 0] <= x1)
            & (c[:, 1] >= y0) & (c[:, 1] <= y1))


def euclidian_clip_circle(spec: GridSpecXY, cx, cy, radius):
    c = spec.cell_centers()
    return np.hypot(c[:, 0] - cx, c[:, 1] - cy) <= radius


def clipped_grid(spec, predicate_mask) -> Grid:
    """Grid with only the cells passing the predicate realized (the
    reference's clipped grid generation, as a masked spec)."""
    return Grid(spec, mask=np.asarray(predicate_mask, dtype=bool))
