"""The port's own copy of ``icebin_tpu/io/ncio.py``; it imports nothing of
the reference package.

NetCDF round-trip of grids, exchange grids, and regridders.

Reference: every persisted object serializes through ibmisc ``NcIO`` --
``Grid::ncio``, ``GCMRegridder::ncio`` write/read NetCDF files that the
offline pipeline (grid scripts -> overlap -> regridder assembly) passes
between stages (reference: ``ibmisc:slib/ibmisc/netcdf.*``,
``slib/icebin/Grid.cpp``, ``GCMRegridder.cpp`` [U]; SURVEY.md sections 3.1,
5.4).  Matrix construction is expensive, so caching these artifacts is a
first-class feature of the TPU build too.

Implementation: NetCDF-3 classic via ``scipy.io.netcdf_file`` (no netCDF4 in
the image; classic format is all the schema needs).  The schema is
TPU-native (border arrays + masks, not per-cell polygon soup): a grid file
is O(n) border values instead of the reference's O(cells x vertices)
geometry dump, and reconstruction is exact because grids are *specs*.
"""
from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from icebin_tpu_torch.grid.exchange import ExchangeGrid
from icebin_tpu_torch.grid.proj import from_proj4
from icebin_tpu_torch.grid.spec import (Grid, GridSpecGeneric,
                                        GridSpecLonLat, GridSpecXY)
from icebin_tpu_torch.regrid.gcmregridder import GCMRegridder, IceSheet
from icebin_tpu_torch.regrid.sparse import WeightedMatrix

__all__ = ["write_grid", "read_grid", "write_exchange", "read_exchange",
           "write_gcmregridder", "read_gcmregridder",
           "write_matrix", "read_matrix"]


def _put(nc, name, dims, data, dtype=None):
    data = np.asarray(data, dtype=dtype or np.float64)
    for d, n in zip(dims, data.shape):
        if d not in nc.dimensions:
            nc.createDimension(d, n)
    v = nc.createVariable(name, data.dtype, dims)
    v[:] = data
    return v


def _get(nc, name):
    return np.array(nc.variables[name][:])


# -- grids ----------------------------------------------------------------

def write_grid(path: str, grid, name: str = "grid") -> None:
    """Grid or bare spec -> NetCDF (reference ``Grid::ncio('w')`` [U])."""
    spec = grid.spec if isinstance(grid, Grid) else grid
    mask = grid.mask if isinstance(grid, Grid) else None
    with netcdf_file(path, "w") as nc:
        nc.icebin_tpu_schema = 1
        if isinstance(spec, GridSpecLonLat):
            nc.grid_type = "lonlat"
            nc.eq_rad = spec.eq_rad
            nc.pole_cap_south = int(spec.pole_cap_south)
            nc.pole_cap_north = int(spec.pole_cap_north)
            nc.grid_name = spec.name
            _put(nc, f"{name}.lonb", (f"{name}.nlonb",), spec.lonb)
            _put(nc, f"{name}.latb", (f"{name}.nlatb",), spec.latb)
        elif isinstance(spec, GridSpecXY):
            nc.grid_type = "xy"
            nc.grid_name = spec.name
            nc.projection = spec.projection.to_proj4()
            _put(nc, f"{name}.xb", (f"{name}.nxb",), spec.xb)
            _put(nc, f"{name}.yb", (f"{name}.nyb",), spec.yb)
        elif isinstance(spec, GridSpecGeneric):
            nc.grid_type = "generic"
            nc.grid_name = spec.name
            _put(nc, f"{name}.polygons",
                 (f"{name}.ncells", f"{name}.nvert", f"{name}.xy"),
                 spec.polygons)
        else:
            raise TypeError(f"cannot serialize {type(spec)}")
        if mask is not None:
            _put(nc, f"{name}.mask", (f"{name}.ncells",),
                 mask.astype(np.int8), np.int8)


def read_grid(path: str, name: str = "grid") -> Grid:
    with netcdf_file(path, "r", mmap=False) as nc:
        gtype = nc.grid_type.decode() if isinstance(nc.grid_type, bytes) \
            else nc.grid_type
        gname = nc.grid_name.decode() if isinstance(nc.grid_name, bytes) \
            else nc.grid_name
        if gtype == "lonlat":
            spec = GridSpecLonLat(
                lonb=_get(nc, f"{name}.lonb"), latb=_get(nc, f"{name}.latb"),
                eq_rad=float(nc.eq_rad),
                pole_cap_south=bool(nc.pole_cap_south),
                pole_cap_north=bool(nc.pole_cap_north), name=gname)
        elif gtype == "xy":
            proj = nc.projection.decode() if isinstance(nc.projection, bytes) \
                else nc.projection
            spec = GridSpecXY(xb=_get(nc, f"{name}.xb"),
                              yb=_get(nc, f"{name}.yb"),
                              projection=from_proj4(proj), name=gname)
        elif gtype == "generic":
            spec = GridSpecGeneric(polygons=_get(nc, f"{name}.polygons"),
                                   name=gname)
        else:
            raise ValueError(f"unknown grid_type {gtype!r}")
        mask = None
        if f"{name}.mask" in nc.variables:
            mask = _get(nc, f"{name}.mask").astype(bool)
    return Grid(spec, mask=mask)


# -- exchange grids -------------------------------------------------------

def write_exchange(path: str, xg: ExchangeGrid) -> None:
    """reference ``ExchangeGrid::ncio`` / the ``overlap`` CLI output [U]."""
    with netcdf_file(path, "w") as nc:
        nc.icebin_tpu_schema = 1
        nc.nA = xg.nA
        nc.nI = xg.nI
        _put(nc, "exgrid.iA", ("exgrid.ncells",), xg.iA, np.int32)
        _put(nc, "exgrid.iI", ("exgrid.ncells",), xg.iI, np.int32)
        _put(nc, "exgrid.area", ("exgrid.ncells",), xg.area)
        if xg.centroid is not None:
            _put(nc, "exgrid.centroid", ("exgrid.ncells", "two"), xg.centroid)


def read_exchange(path: str) -> ExchangeGrid:
    with netcdf_file(path, "r", mmap=False) as nc:
        cent = (_get(nc, "exgrid.centroid")
                if "exgrid.centroid" in nc.variables else None)
        return ExchangeGrid(iA=_get(nc, "exgrid.iA").astype(np.int64),
                            iI=_get(nc, "exgrid.iI").astype(np.int64),
                            area=_get(nc, "exgrid.area"),
                            centroid=cent, nA=int(nc.nA), nI=int(nc.nI))


# -- GCMRegridder ---------------------------------------------------------

def write_gcmregridder(path: str, gr: GCMRegridder) -> None:
    """Whole-container round trip (reference ``GCMRegridder::ncio`` [U]):
    gridA + hcdefs + each sheet's ice grid, exchange grid, and projected A
    areas, in one file."""
    with netcdf_file(path, "w") as nc:
        nc.icebin_tpu_schema = 1
        nc.sheet_names = ",".join(gr.sheets.keys())
        _put(nc, "hcdefs", ("nhc",), gr.hcdefs)
        # gridA inline
        specA = gr.specA
        nc.gridA_eq_rad = specA.eq_rad
        nc.gridA_pole_south = int(specA.pole_cap_south)
        nc.gridA_pole_north = int(specA.pole_cap_north)
        nc.gridA_name = specA.name
        _put(nc, "gridA.lonb", ("gridA.nlonb",), specA.lonb)
        _put(nc, "gridA.latb", ("gridA.nlatb",), specA.latb)
        if gr.gridA.mask is not None:
            _put(nc, "gridA.mask", ("gridA.ncells",),
                 gr.gridA.mask.astype(np.int8), np.int8)
        for nm, sheet in gr.sheets.items():
            spec = sheet.specI
            setattr(nc, f"{nm}_projection", spec.projection.to_proj4())
            setattr(nc, f"{nm}_name", spec.name)
            _put(nc, f"{nm}.xb", (f"{nm}.nxb",), spec.xb)
            _put(nc, f"{nm}.yb", (f"{nm}.nyb",), spec.yb)
            if sheet.gridI.mask is not None:
                _put(nc, f"{nm}.mask", (f"{nm}.ncells",),
                     sheet.gridI.mask.astype(np.int8), np.int8)
            xg = sheet.exchange
            _put(nc, f"{nm}.exgrid.iA", (f"{nm}.exgrid.ncells",), xg.iA,
                 np.int32)
            _put(nc, f"{nm}.exgrid.iI", (f"{nm}.exgrid.ncells",), xg.iI,
                 np.int32)
            _put(nc, f"{nm}.exgrid.area", (f"{nm}.exgrid.ncells",), xg.area)
            if xg.centroid is not None:
                _put(nc, f"{nm}.exgrid.centroid",
                     (f"{nm}.exgrid.ncells", "two"), xg.centroid)
            _put(nc, f"{nm}.areaA_proj", ("gridA.ncells",), sheet.areaA_proj)


def _attr(nc, name):
    v = getattr(nc, name)
    return v.decode() if isinstance(v, bytes) else v


def read_gcmregridder(path: str, *, device) -> GCMRegridder:
    """The regridder of ``write_gcmregridder``; ``device`` is where it clips
    the exchange grids of sheets added later."""
    with netcdf_file(path, "r", mmap=False) as nc:
        specA = GridSpecLonLat(
            lonb=_get(nc, "gridA.lonb"), latb=_get(nc, "gridA.latb"),
            eq_rad=float(nc.gridA_eq_rad),
            pole_cap_south=bool(nc.gridA_pole_south),
            pole_cap_north=bool(nc.gridA_pole_north),
            name=_attr(nc, "gridA_name"))
        maskA = (_get(nc, "gridA.mask").astype(bool)
                 if "gridA.mask" in nc.variables else None)
        gr = GCMRegridder(Grid(specA, mask=maskA), hcdefs=_get(nc, "hcdefs"),
                          device=device)
        names = [s for s in _attr(nc, "sheet_names").split(",") if s]
        for nm in names:
            spec = GridSpecXY(xb=_get(nc, f"{nm}.xb"),
                              yb=_get(nc, f"{nm}.yb"),
                              projection=from_proj4(_attr(nc, f"{nm}_projection")),
                              name=_attr(nc, f"{nm}_name"))
            mask = (_get(nc, f"{nm}.mask").astype(bool)
                    if f"{nm}.mask" in nc.variables else None)
            cent = (_get(nc, f"{nm}.exgrid.centroid")
                    if f"{nm}.exgrid.centroid" in nc.variables else None)
            xg = ExchangeGrid(iA=_get(nc, f"{nm}.exgrid.iA").astype(np.int64),
                              iI=_get(nc, f"{nm}.exgrid.iI").astype(np.int64),
                              area=_get(nc, f"{nm}.exgrid.area"),
                              centroid=cent,
                              nA=specA.ncells, nI=spec.ncells)
            gr.sheets[nm] = IceSheet(name=nm, gridI=Grid(spec, mask=mask),
                                     exchange=xg,
                                     areaA_proj=_get(nc, f"{nm}.areaA_proj"))
    return gr


# -- weighted matrices ----------------------------------------------------

def write_matrix(path: str, M: WeightedMatrix, name: str = "M",
                 compressed: bool = False) -> None:
    """reference ``linear::Weighted_Eigen``/``Weighted_Compressed`` NetCDF
    forms [U]; ``compressed=True`` uses the zarray RLE+zlib codec
    (``icebin_tpu.io.zarray``) as byte blobs, the reference's ``global_ec``
    storage format."""
    with netcdf_file(path, "w") as nc:
        nc.icebin_tpu_schema = 1
        setattr(nc, f"{name}_nrow", M.shape[0])
        setattr(nc, f"{name}_ncol", M.shape[1])
        setattr(nc, f"{name}_compressed", int(compressed))
        if compressed:
            from icebin_tpu_torch.io.zarray import encode_zarray
            blob = np.frombuffer(
                encode_zarray(M.rows, M.cols, M.vals), dtype=np.int8)
            _put(nc, f"{name}.zarray", (f"{name}.nbytes",), blob, np.int8)
        else:
            _put(nc, f"{name}.rows", (f"{name}.nnz",), M.rows, np.int32)
            _put(nc, f"{name}.cols", (f"{name}.nnz",), M.cols, np.int32)
            _put(nc, f"{name}.vals", (f"{name}.nnz",), M.vals)


def read_matrix(path: str, name: str = "M") -> WeightedMatrix:
    with netcdf_file(path, "r", mmap=False) as nc:
        shape = (int(getattr(nc, f"{name}_nrow")),
                 int(getattr(nc, f"{name}_ncol")))
        if int(getattr(nc, f"{name}_compressed")):
            from icebin_tpu_torch.io.zarray import decode_zarray
            blob = _get(nc, f"{name}.zarray").tobytes()
            rows, cols, vals = decode_zarray(blob)
            return WeightedMatrix(rows=rows, cols=cols, vals=vals, shape=shape)
        return WeightedMatrix(rows=_get(nc, f"{name}.rows").astype(np.int64),
                              cols=_get(nc, f"{name}.cols").astype(np.int64),
                              vals=_get(nc, f"{name}.vals"), shape=shape)
