"""The port's own copy of ``icebin_tpu/io/searise.py``; it imports
nothing of the reference package.

SeaRISE-style ice-sheet NetCDF ingestion (Greenland/Antarctica datasets).

The reference's grid scripts and coupled setups consume SeaRISE NetCDF
datasets (e.g. ``Greenland_5km_dev1.2.nc``): polar-stereographic cell-center
coordinates plus ``thk`` (ice thickness), ``topg`` (bedrock), ``usrf``
(ice surface) fields, with the projection in a CF ``polar_stereographic``
grid-mapping variable (reference: ``grids/searise.py``-style readers,
``sr_g20_*`` grid scripts [U]; SURVEY.md section 2 "Grid/one-off scripts").

This reader is deliberately tolerant of the real datasets' variations:
``x``/``x1`` coordinate names, optional leading ``time`` dimension, km or m
coordinate units.  ``write_synthetic_searise`` emits a file in the SAME
format (mapping variable, time dimension, center coordinates) so the parser
is exercised against the real schema even with no network access.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
from scipy.io import netcdf_file

from icebin_tpu_torch.grid.spec import GridSpecXY

__all__ = ["SeaRiseData", "read_searise", "write_synthetic_searise",
           "searise_elevmask"]


@dataclasses.dataclass
class SeaRiseData:
    """One SeaRISE dataset: grid spec + flat (x-fastest) ice fields."""

    spec: GridSpecXY
    thk: np.ndarray           # ice thickness (m), flat
    topg: np.ndarray          # bedrock elevation (m), flat
    usrf: np.ndarray          # ice upper surface elevation (m), flat

    def elevmask(self, min_thk: float = 1.0) -> np.ndarray:
        """Elevation-where-ice mask: usrf where thk > min_thk, else NaN --
        the ``elevmaskI`` input of ``GCMRegridder.regrid_matrices``."""
        return np.where(self.thk > min_thk, self.usrf, np.nan)


def searise_elevmask(path: str, min_thk: float = 1.0):
    """(spec, elevmask) straight from a SeaRISE file."""
    d = read_searise(path)
    return d.spec, d.elevmask(min_thk)


def _attr(v, name, default=None):
    a = getattr(v, name, default)
    if isinstance(a, bytes):
        return a.decode("ascii", errors="replace")
    return a


def _coord(nc, names):
    for n in names:
        if n in nc.variables:
            v = nc.variables[n]
            vals = np.array(v[:], np.float64)
            units = (_attr(v, "units", "m") or "m").strip().lower()
            if units in ("km", "kilometer", "kilometers"):
                vals = vals * 1000.0
            return n, vals
    raise ValueError(f"no coordinate variable among {names}")


def _centers_to_borders(c: np.ndarray) -> np.ndarray:
    if len(c) < 2:
        raise ValueError("need >= 2 coordinate values")
    mid = 0.5 * (c[:-1] + c[1:])
    first = c[0] - (mid[0] - c[0])
    last = c[-1] + (c[-1] - mid[-1])
    return np.concatenate([[first], mid, [last]])


def _field(nc, name, ny, nx):
    if name not in nc.variables:
        raise ValueError(f"SeaRISE file missing variable {name!r}")
    a = np.array(nc.variables[name][:], np.float64)
    if a.ndim == 3:            # (time, y, x): take the last time slice
        a = a[-1]
    if a.shape != (ny, nx):
        raise ValueError(f"{name} has shape {a.shape}, expected ({ny},{nx})")
    return a.reshape(-1)       # x-fastest == GridSpecXY flat order


def _mapping_projection(nc) -> Optional[str]:
    """CF grid-mapping variable -> proj4-style string."""
    for v in nc.variables.values():
        gmn = _attr(v, "grid_mapping_name")
        if gmn is None:
            continue
        if gmn.strip() != "polar_stereographic":
            raise ValueError(f"unsupported grid mapping {gmn!r}")
        lon0 = float(_attr(v, "straight_vertical_longitude_from_pole", 0.0))
        lat0 = float(_attr(v, "latitude_of_projection_origin", 90.0))
        latts = _attr(v, "standard_parallel", None)
        if latts is None:
            latts = _attr(v, "scale_factor_at_projection_origin", None)
            latts = lat0 if latts is None else lat0  # k0 form: keep pole
        latts = float(np.atleast_1d(latts)[0])
        return (f"+proj=stere +lat_0={lat0:g} +lat_ts={latts:g} "
                f"+lon_0={lon0:g} +ellps=WGS84")
    return None


def read_searise(path: str) -> SeaRiseData:
    """Parse a SeaRISE-style NetCDF ice dataset into (spec, thk/topg/usrf)."""
    with netcdf_file(path, "r", mmap=False) as nc:
        _, x = _coord(nc, ("x", "x1"))
        _, y = _coord(nc, ("y", "y1"))
        proj = _mapping_projection(nc)
        nx, ny = len(x), len(y)
        thk = _field(nc, "thk", ny, nx)
        topg = _field(nc, "topg", ny, nx)
        if "usrf" in nc.variables:
            usrf = _field(nc, "usrf", ny, nx)
        else:                   # some variants carry usurf
            usrf = _field(nc, "usurf", ny, nx)
    spec = GridSpecXY(xb=_centers_to_borders(x), yb=_centers_to_borders(y),
                      projection=proj, name="searise")
    return SeaRiseData(spec=spec, thk=thk, topg=topg, usrf=usrf)


def write_synthetic_searise(path: str, nx: int = 76, ny: int = 141,
                            dx: float = 20e3, seed: int = 0,
                            lon_0: float = -39.0, lat_ts: float = 71.0,
                            km_units: bool = False) -> SeaRiseData:
    """Emit a synthetic Greenland-like dataset in the REAL SeaRISE schema:
    (time, y1, x1) float32 fields, ``mapping`` grid-mapping variable,
    cell-center coordinates.  Returns what a reader should recover."""
    rng = np.random.default_rng(seed)
    x = (np.arange(nx) - (nx - 1) / 2) * dx + 110e3
    y = (np.arange(ny) - (ny - 1) / 2) * dx - 1990e3
    X, Y = np.meshgrid(x, y)                       # (ny, nx)
    r2 = (((X - 110e3) / (nx * dx / 2.4)) ** 2
          + ((Y + 1990e3) / (ny * dx / 2.4)) ** 2)
    topg = 300.0 * rng.standard_normal((ny, nx)) - 100.0
    thk = np.where(r2 < 1.0, 3000.0 * np.sqrt(np.maximum(1.0 - r2, 0.0)),
                   0.0)
    usrf = np.where(thk > 0, np.maximum(topg, 0.0) + thk, np.maximum(topg,
                                                                     0.0))
    with netcdf_file(path, "w") as nc:
        nc.createDimension("time", 1)
        nc.createDimension("x1", nx)
        nc.createDimension("y1", ny)
        scale = 1e-3 if km_units else 1.0
        vx = nc.createVariable("x1", "d", ("x1",))
        vx[:] = x * scale
        vx.units = "km" if km_units else "m"
        vx.standard_name = "projection_x_coordinate"
        vy = nc.createVariable("y1", "d", ("y1",))
        vy[:] = y * scale
        vy.units = "km" if km_units else "m"
        vy.standard_name = "projection_y_coordinate"
        vm = nc.createVariable("mapping", "b", ())
        vm.grid_mapping_name = "polar_stereographic"
        vm.straight_vertical_longitude_from_pole = lon_0
        vm.latitude_of_projection_origin = 90.0
        vm.standard_parallel = lat_ts
        vm.false_easting = 0.0
        vm.false_northing = 0.0
        for name, arr in (("thk", thk), ("topg", topg), ("usrf", usrf)):
            v = nc.createVariable(name, "f", ("time", "y1", "x1"))
            v[:] = arr[None].astype(np.float32)
            v.grid_mapping = "mapping"
            v.units = "m"
    proj = (f"+proj=stere +lat_0=90 +lat_ts={lat_ts:g} +lon_0={lon_0:g} "
            "+ellps=WGS84")
    spec = GridSpecXY(xb=_centers_to_borders(x), yb=_centers_to_borders(y),
                      projection=proj, name="searise")
    return SeaRiseData(spec=spec,
                       thk=thk.astype(np.float32).astype(np.float64)
                       .reshape(-1),
                       topg=topg.astype(np.float32).astype(np.float64)
                       .reshape(-1),
                       usrf=usrf.astype(np.float32).astype(np.float64)
                       .reshape(-1))
