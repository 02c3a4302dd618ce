"""The port's own host layer (icebin_tpu_torch's copies of the reference's
numpy modules) against the reference's modules, on the same numbers: each
package builds its own grid classes from the same arrays, and every result
must agree bit for bit (the copies change imports only).

Covered: exchange grids (Greenland-like stereographic XY, cross-projection
XY, lat-lon x lat-lon, XY x XY in one plane, generic polygons), the regrid
matrices EvI/IvE/AvI/IvA (with and without the smoother's sigma) and
E1vE0, unit conversions and the coupling contracts, ``Indexing``,
grid/exchange/regridder/matrix files written by either package and read
back by the other, the multivec wire format (``to_dense``, ``from_dense``,
``concatenate``), the TOPO pipeline (``make_topoo``, ``merge_topo``,
``elevation_class_fields``) on tests/test_topo_modele.py's inputs, the
region predicates of ``grid/gen.py`` on tests/test_gridspec.py:79's, and
the SeaRISE and GISS readers and writers (``io/searise.py``,
``io/giss.py``) on tests/test_ingest.py's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from icebin_tpu.coupler import multivec as ref_mv
from icebin_tpu.coupler import units as ref_units
from icebin_tpu.coupler import varset as ref_varset
from icebin_tpu.coupler.e1ve0 import e1ve0_matrix as ref_e1ve0
from icebin_tpu.grid import gen as ref_gen
from icebin_tpu.grid import proj as ref_proj, spec as ref_spec
from icebin_tpu.io import giss as ref_giss, searise as ref_searise
from icebin_tpu.grid.exchange import make_exchange_grid as ref_build
from icebin_tpu.io import ncio as ref_ncio
from icebin_tpu.regrid.gcmregridder import GCMRegridder as RefRegridder
from icebin_tpu.regrid.hntr import hntr_spec as ref_hntr_spec
from icebin_tpu.regrid.matrices import RegridParams as RefParams
from icebin_tpu.regrid.sparse import WeightedMatrix as RefMatrix
from icebin_tpu.topo import topo as ref_topo
from icebin_tpu.utils.indexing import Indexing as RefIndexing

from icebin_tpu_torch.coupler import multivec as port_mv
from icebin_tpu_torch.coupler import units as port_units
from icebin_tpu_torch.coupler import varset as port_varset
from icebin_tpu_torch.coupler.e1ve0 import e1ve0_matrix as port_e1ve0
from icebin_tpu_torch.grid import gen as port_gen
from icebin_tpu_torch.grid import proj as port_proj, spec as port_spec
from icebin_tpu_torch.io import giss as port_giss, searise as port_searise
from icebin_tpu_torch.grid.exchange import \
    make_exchange_grid_host as port_build
from icebin_tpu_torch.io import ncio as port_ncio
from icebin_tpu_torch.regrid.gcmregridder import \
    GCMRegridder as PortRegridder
from icebin_tpu_torch.regrid.hntr import hntr_spec as port_hntr_spec
from icebin_tpu_torch.regrid.matrices import RegridParams as PortParams
from icebin_tpu_torch.regrid.sparse import WeightedMatrix as PortMatrix
from icebin_tpu_torch.topo import topo as port_topo
from icebin_tpu_torch.utils.indexing import Indexing as PortIndexing

from helpers import greenland_patch, toy_elevmask

torch.set_num_threads(1)

CPU = torch.device("cpu")
SEARISE = "+proj=stere +lat_0=90 +lat_ts=71 +lon_0=-39 +ellps=WGS84"


def to_port(spec):
    """The port's own class for a reference spec (or projection), from the
    same numbers."""
    mod = port_proj if isinstance(spec, ref_proj.Projection) else port_spec
    kw = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    if kw.get("projection") is not None:
        kw["projection"] = to_port(kw["projection"])
    return getattr(mod, type(spec).__name__)(**kw)


def hexagons(centres, r):
    ang = np.radians(np.arange(6) * 60.0 + 15.0)
    return np.stack([centres[:, None, 0] + r * np.cos(ang)[None, :],
                     centres[:, None, 1] + r * np.sin(ang)[None, :]], -1)


def case(name):
    """(specA, specI, subdiv) in the reference's classes."""
    S, P = ref_spec, ref_proj
    if name == "greenland_xy":
        specA, specI = greenland_patch(res_km=100.0)
        return specA, specI, 2
    if name == "cross_projection_xy":
        _, specI = greenland_patch(res_km=100.0)
        specA = S.GridSpecXY(xb=np.linspace(-800e3, 900e3, 9),
                             yb=np.linspace(-3400e3, -600e3, 13),
                             projection=P.from_proj4(
                                 "+proj=stere +lat_0=90 +lat_ts=70 "
                                 "+lon_0=-45 +ellps=WGS84"))
        return specA, specI, 2
    if name == "lonlat_x_lonlat":
        return (S.modele_lonlat_grid(36, 24),
                S.GridSpecLonLat(lonb=np.linspace(-60.0, 20.0, 41),
                                 latb=np.linspace(55.0, 85.0, 31)), 2)
    if name == "xy_x_xy":
        pc = P.PlateCarree(scale=25e3)
        return (S.GridSpecXY(xb=np.linspace(0.0, 1e6, 11),
                             yb=np.linspace(7.5e5, 2e6, 14), projection=pc),
                S.GridSpecXY(xb=np.linspace(1e5, 9e5, 33),
                             yb=np.linspace(8e5, 1.9e6, 45), projection=pc),
                2)
    if name == "generic":
        c = np.stack(np.meshgrid(np.arange(13.0, 19.1, 2.0),
                                 np.arange(43.0, 49.1, 2.0)),
                     -1).reshape(-1, 2)
        return (S.GridSpecLonLat(lonb=np.linspace(10.0, 22.0, 7),
                                 latb=np.linspace(40.0, 52.0, 7)),
                S.GridSpecGeneric(polygons=hexagons(c, 0.8),
                                  projection=P.PlateCarree(scale=10e3)), 2)
    raise KeyError(name)


def assert_same_exchange(xp, xr):
    assert (xp.nA, xp.nI) == (xr.nA, xr.nI)
    for k in ("iA", "iI", "area", "centroid"):
        np.testing.assert_array_equal(getattr(xp, k), getattr(xr, k), k)


@pytest.mark.parametrize("name", ["greenland_xy", "cross_projection_xy",
                                  "lonlat_x_lonlat", "xy_x_xy", "generic"])
def test_exchange_grid_bit_identical(name):
    specA, specI, subdiv = case(name)
    xr = ref_build(specA, specI, subdiv=subdiv, engine="numpy")
    xp = port_build(to_port(specA), to_port(specI), subdiv=subdiv)
    assert xr.ncells > 0
    assert_same_exchange(xp, xr)


@pytest.fixture(scope="module")
def regridders():
    """Greenland at 100 km x ModelE 2x2.5 in both packages; the port's
    sheet is added with its own host build of the exchange grid."""
    specA, specI, _ = case("greenland_xy")
    hc = [0.0, 500.0, 1000.0, 2000.0, 3500.0]
    gr_r = RefRegridder(specA, hcdefs=hc)
    gr_r.add_sheet("gis", specI, subdiv=2, engine="numpy")
    gr_p = PortRegridder(to_port(specA), hcdefs=hc, device=CPU)
    pI = to_port(specI)
    gr_p.add_sheet("gis", pI, exchange=port_build(gr_p.gridA, pI, subdiv=2),
                   subdiv=2)
    return gr_r, gr_p, toy_elevmask(specI)


def assert_same_matrix(mp, mr):
    assert tuple(mp.shape) == tuple(mr.shape)
    for k in ("rows", "cols", "vals", "wM", "Mw"):
        np.testing.assert_array_equal(getattr(mp, k), getattr(mr, k), k)


@pytest.mark.parametrize("sigma", [None, (200e3, 200e3)])
@pytest.mark.parametrize("name", ["EvI", "IvE", "AvI", "IvA"])
def test_regrid_matrices_bit_identical(regridders, name, sigma):
    gr_r, gr_p, elev = regridders
    assert_same_exchange(gr_p.sheets["gis"].exchange,
                         gr_r.sheets["gis"].exchange)
    np.testing.assert_array_equal(gr_p.sheets["gis"].areaA_proj,
                                  gr_r.sheets["gis"].areaA_proj)
    mr = gr_r.regrid_matrices("gis", elev).matrix(
        name, RefParams(scale=True, correctA=True, sigma=sigma))
    mp = gr_p.regrid_matrices("gis", elev).matrix(
        name, PortParams(scale=True, correctA=True, sigma=sigma))
    assert mr.nnz > 0
    assert_same_matrix(mp, mr)


def test_e1ve0_bit_identical(regridders):
    gr_r, gr_p, elev = regridders
    elev1 = np.where(np.isfinite(elev), elev + 300.0, np.nan)
    mr = ref_e1ve0(gr_r.regrid_matrices("gis", elev),
                   gr_r.regrid_matrices("gis", elev1))
    mp = port_e1ve0(gr_p.regrid_matrices("gis", elev),
                    gr_p.regrid_matrices("gis", elev1))
    assert mr.nnz > 0
    assert_same_matrix(mp, mr)


def test_units_and_contracts_identical():
    for src, dst in (("kg m-2 s-1", "kg m-2 s-1"), ("degC", "K"),
                     ("W m-2", "J m-2 s-1"), ("m s-1", "m year-1"),
                     ("kg m-2 year-1", "kg m-2 s-1")):
        assert (port_units.convert_factor(src, dst)
                == ref_units.convert_factor(src, dst))
    with pytest.raises(port_units.UnitError):
        port_units.convert_factor("kg", "m")
    for fn in ("modele_ice_input_contract", "ice_native_input_contract",
               "ice_modele_output_contract"):
        vr, vp = getattr(ref_varset, fn)(), getattr(port_varset, fn)()
        assert vp.names == vr.names
        np.testing.assert_array_equal(vp.defaults(3), vr.defaults(3))
    fr, orr = ref_varset.modele_ice_input_contract().conversion_to(
        ref_varset.ice_native_input_contract())
    fp, op = port_varset.modele_ice_input_contract().conversion_to(
        port_varset.ice_native_input_contract())
    np.testing.assert_array_equal(fp, fr)
    np.testing.assert_array_equal(op, orr)


def test_indexing_identical():
    rng = np.random.default_rng(0)
    for make in ("c_order", "f_order"):
        ir = getattr(RefIndexing, make)((5, 144, 90), names=("hc", "i", "j"))
        ip = getattr(PortIndexing, make)((5, 144, 90), names=("hc", "i", "j"))
        assert (ip.size, ip.strides, len(ip)) == (ir.size, ir.strides,
                                                  len(ir))
        flat = rng.integers(0, ir.size, 50)
        for a, b in zip(ip.index_to_tuple(flat), ir.index_to_tuple(flat)):
            np.testing.assert_array_equal(a, b)
        t = ir.index_to_tuple(flat)
        np.testing.assert_array_equal(ip.tuple_to_index(*t),
                                      ir.tuple_to_index(*t))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_files_interchange(tmp_path, regridders, writer):
    """Grids (lat-lon, XY with a mask, generic), exchange grids, a whole
    regridder and matrices (plain and zarray-compressed) written by one
    package read back bit for bit in the other."""
    gr_r, gr_p, elev = regridders
    w, r = (ref_ncio, port_ncio) if writer == "reference" else (port_ncio,
                                                                ref_ncio)
    gw = gr_r if writer == "reference" else gr_p
    specA, specI, _ = case("greenland_xy")
    gen = case("generic")[1]
    mask = np.random.default_rng(1).uniform(size=specI.ncells) > 0.2
    grids = [specA, ref_spec.Grid(specI, mask=mask), gen]
    if writer == "port":
        grids = [to_port(specA), port_spec.Grid(to_port(specI), mask=mask),
                 to_port(gen)]
    for k, g in enumerate(grids):
        path = str(tmp_path / f"g{k}.nc")
        w.write_grid(path, g)
        back = r.read_grid(path)
        spec = g.spec if hasattr(g, "spec") else g
        for f in dataclasses.fields(spec):
            a, b = getattr(back.spec, f.name), getattr(spec, f.name)
            if f.name != "projection":
                np.testing.assert_array_equal(a, b, f.name)
            elif a is not None:     # generic grids' files hold none
                assert a.to_proj4() == b.to_proj4()
        if getattr(g, "mask", None) is not None:
            np.testing.assert_array_equal(back.mask, g.mask)
    xg = gw.sheets["gis"].exchange
    w.write_exchange(str(tmp_path / "x.nc"), xg)
    assert_same_exchange(r.read_exchange(str(tmp_path / "x.nc")), xg)
    w.write_gcmregridder(str(tmp_path / "gr.nc"), gw)
    kw = {"device": CPU} if r is port_ncio else {}
    back = r.read_gcmregridder(str(tmp_path / "gr.nc"), **kw)
    np.testing.assert_array_equal(back.hcdefs, gw.hcdefs)
    assert_same_exchange(back.sheets["gis"].exchange, xg)
    np.testing.assert_array_equal(back.sheets["gis"].areaA_proj,
                                  gw.sheets["gis"].areaA_proj)
    M = gw.regrid_matrices("gis", elev).matrix(
        "EvI", (RefParams if gw is gr_r else PortParams)())
    for compressed in (False, True):
        path = str(tmp_path / f"m{int(compressed)}.nc")
        w.write_matrix(path, M, compressed=compressed)
        Mb = r.read_matrix(path)
        assert isinstance(Mb, PortMatrix if r is port_ncio else RefMatrix)
        assert_same_matrix(Mb, M)


def test_multivec_bit_identical():
    """to_dense (duplicates accumulate, either fill), from_dense (with and
    without a mask) and concatenate on the same arrays."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 40, 30)
    vals = rng.uniform(-1.0, 1.0, (3, 30))
    vals[:, ::7] = 0.0
    mp = port_mv.VectorMultivec(index=idx, vals=vals)
    mr = ref_mv.VectorMultivec(index=idx, vals=vals)
    assert mp.nvar == mr.nvar == 3
    for fill in (0.0, np.nan):
        np.testing.assert_array_equal(mp.to_dense(40, fill),
                                      mr.to_dense(40, fill))
    d = mp.to_dense(40)
    for mask in (None, np.arange(40) % 3 == 0):
        dp = port_mv.VectorMultivec.from_dense(d, mask)
        dr = ref_mv.VectorMultivec.from_dense(d, mask)
        np.testing.assert_array_equal(dp.index, dr.index)
        np.testing.assert_array_equal(dp.vals, dr.vals)
    np.testing.assert_array_equal(
        port_mv.VectorMultivec.from_dense(d).to_dense(40), d)
    cp = port_mv.concatenate([mp, port_mv.VectorMultivec.from_dense(d)])
    cr = ref_mv.concatenate([mr, ref_mv.VectorMultivec.from_dense(d)])
    np.testing.assert_array_equal(cp.index, cr.index)
    np.testing.assert_array_equal(cp.vals, cr.vals)
    assert port_mv.concatenate([]).vals.shape == ref_mv.concatenate(
        []).vals.shape
    for mod in (port_mv, ref_mv):
        with pytest.raises(ValueError):
            mod.concatenate([mod.VectorMultivec(idx, vals),
                             mod.VectorMultivec([1], [[1.0]])])
        with pytest.raises(ValueError):
            mod.VectorMultivec(index=[1, 2], vals=[[1.0]])


def assert_same_topo(tp, tr):
    for k in port_topo.FRACTION_FIELDS + ("zatmo",):
        np.testing.assert_array_equal(getattr(tp, k), getattr(tr, k), k)


def test_make_topoo_bit_identical():
    """tests/test_topo_modele.py's synthetic base (72 x 46) downsampled onto
    its 36 x 24 ocean grid."""
    tr = ref_topo.make_topoo(ref_topo.synthetic_z1qx1n(ref_hntr_spec(72, 46)),
                             ref_hntr_spec(36, 24))
    tp = port_topo.make_topoo(
        port_topo.synthetic_z1qx1n(port_hntr_spec(72, 46)),
        port_hntr_spec(36, 24))
    assert_same_topo(tp, tr)


@pytest.fixture(scope="module")
def topo_regridders():
    """tests/test_topo_modele.py's ``_toy_gr`` (8 x 8 lat-lon x 40 x 40
    plate carree) in both packages, the port's sheet from its own host
    exchange build; and the test's elevmask."""
    scale = 25e3
    specA = ref_spec.GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 9),
                                    latb=np.linspace(30.0, 70.0, 9))
    specI = ref_spec.GridSpecXY(
        xb=np.linspace(5.0 * scale, 35.0 * scale, 41),
        yb=np.linspace(35.0 * scale, 65.0 * scale, 41),
        projection=ref_proj.PlateCarree(scale=scale))
    hc = [0.0, 500.0, 1500.0, 3000.0]
    gr_r = RefRegridder(specA, hcdefs=hc)
    gr_r.add_sheet("s", specI, subdiv=1, engine="numpy")
    gr_p = PortRegridder(to_port(specA), hcdefs=hc, device=CPU)
    pI = to_port(specI)
    gr_p.add_sheet("s", pI, exchange=port_build(gr_p.gridA, pI, subdiv=1),
                   subdiv=1)
    return gr_r, gr_p, toy_elevmask(specI, ice_frac=0.5)


def test_merge_topo_bit_identical(topo_regridders):
    gr_r, gr_p, elev = topo_regridders
    tr = ref_topo.merge_topo(ref_topo.synthetic_z1qx1n(gr_r.specA), gr_r,
                             {"s": elev})
    tp = port_topo.merge_topo(port_topo.synthetic_z1qx1n(gr_p.specA), gr_p,
                              {"s": elev})
    assert_same_topo(tp, tr)


def test_elevation_class_fields_bit_identical(topo_regridders):
    gr_r, gr_p, elev = topo_regridders
    got = port_topo.elevation_class_fields(gr_p, {"s": elev})
    want = ref_topo.elevation_class_fields(gr_r, {"s": elev})
    assert got[0].shape == (gr_p.nhc, gr_p.nA)
    assert (got[2] > 0).any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- grid/gen.py, io/searise.py, io/giss.py -----------------------------------

LONLAT_CLIPS = (("spherical_clip_lonlat", (-60.0, 10.0, 55.0, 85.0)),
                ("spherical_clip_lonlat", (150.0, -150.0, -10.0, 10.0)),
                ("spherical_clip_cap", (-60.0, False)),
                ("spherical_clip_cap", (60.0, True)))
XY_CLIPS = (("euclidian_clip_box", (-50.0, -30.0, 40.0, 60.0)),
            ("euclidian_clip_circle", (10.0, -5.0, 45.0)))


@pytest.mark.parametrize("fn,args", LONLAT_CLIPS + XY_CLIPS)
def test_clip_predicates_and_clipped_grid_bit_identical(fn, args):
    """tests/test_gridspec.py:79's predicates (a Greenland-ish lon/lat
    window, one across the date line, both caps, a box and a circle) on
    its grids, and ``clipped_grid`` of each mask."""
    if fn.startswith("spherical"):
        spec = ref_spec.modele_lonlat_grid(36, 24)
    else:
        spec = ref_spec.GridSpecXY(xb=np.linspace(-100.0, 100.0, 21),
                                   yb=np.linspace(-100.0, 100.0, 21),
                                   projection=ref_proj.PlateCarree())
    mr = getattr(ref_gen, fn)(spec, *args)
    mp = getattr(port_gen, fn)(to_port(spec), *args)
    assert 0 < mr.sum() < spec.ncells
    np.testing.assert_array_equal(mp, mr)
    gp = port_gen.clipped_grid(to_port(spec), mp)
    gr = ref_gen.clipped_grid(spec, mr)
    assert isinstance(gp, port_spec.Grid)
    np.testing.assert_array_equal(gp.realized(), gr.realized())


def assert_same_searise(dp, dr):
    for k in ("thk", "topg", "usrf"):
        np.testing.assert_array_equal(getattr(dp, k), getattr(dr, k), k)
    for k in ("xb", "yb"):
        np.testing.assert_array_equal(getattr(dp.spec, k),
                                      getattr(dr.spec, k), k)
    assert dp.spec.projection.to_proj4() == dr.spec.projection.to_proj4()
    np.testing.assert_array_equal(dp.elevmask(), dr.elevmask())


@pytest.mark.parametrize("km", [False, True])
def test_searise_bit_identical(tmp_path, km):
    """tests/test_ingest.py:136-165's synthetic SeaRISE files, in metre and
    km coordinates: each package's writer gives the same bytes and the
    same truth, and each reader gives the same data from either file."""
    kw = dict(nx=12, ny=16, dx=5e3, km_units=True) if km else dict(
        nx=30, ny=40, dx=20e3)
    pr, pp = str(tmp_path / "r.nc"), str(tmp_path / "p.nc")
    assert_same_searise(port_searise.write_synthetic_searise(pp, **kw),
                        ref_searise.write_synthetic_searise(pr, **kw))
    assert (tmp_path / "r.nc").read_bytes() == (tmp_path / "p.nc").read_bytes()
    dr = ref_searise.read_searise(pr)
    assert_same_searise(port_searise.read_searise(pr), dr)
    assert_same_searise(port_searise.read_searise(pp), dr)
    sp, ep = port_searise.searise_elevmask(pp)
    sr, er = ref_searise.searise_elevmask(pr)
    np.testing.assert_array_equal(ep, er)
    assert isinstance(sp, port_spec.GridSpecXY)


def test_giss_records_bit_identical(tmp_path):
    """tests/test_ingest.py:21-86's GISS records (three 4x5-degree fields;
    a 2x3 field of shape not inferred): each writer gives the same bytes,
    each reader the same titles, names, shapes and bits; a corrupt
    trailer is refused by both."""
    rng = np.random.default_rng(0)
    recs = [(f"F{k}: field {k} (kg m-2)",
             rng.standard_normal((46, 72)).astype(np.float32))
            for k in range(3)]
    recs.append(("FOO: test field (1)",
                 np.arange(6, dtype=np.float32).reshape(2, 3)))
    pr, pp = tmp_path / "r.giss", tmp_path / "p.giss"
    ref_giss.write_giss(str(pr), [ref_giss.GissRecord(a, d) for a, d in recs])
    port_giss.write_giss(str(pp), [port_giss.GissRecord(a, d)
                                   for a, d in recs])
    assert pr.read_bytes() == pp.read_bytes()
    back_r = ref_giss.read_giss(str(pr))
    for back in (port_giss.read_giss(str(pr)),
                 port_giss.read_giss(str(pp), shape=None)):
        assert [(b.title, b.name) for b in back] == [
            (b.title, b.name) for b in back_r]
        for b, c in zip(back, back_r):
            assert b.data.shape == c.data.shape
            np.testing.assert_array_equal(b.data, c.data)
    bad = tmp_path / "bad.giss"
    raw = bytearray(pr.read_bytes())
    raw[4 + 80 + 46 * 72 * 4: 8 + 80 + 46 * 72 * 4] = b"\0\0\0\1"
    bad.write_bytes(bytes(raw))
    for mod in (port_giss, ref_giss):
        with pytest.raises(ValueError, match="marker mismatch"):
            mod.read_giss(str(bad))


def test_z1qx1n_bit_identical(tmp_path):
    """tests/test_ingest.py:86-99: a synthetic 4x5-degree TOPO base written
    as a Z1QX1N GISS file by either package is the same bytes, and either
    reader gives the same renormalised fractions and ZATMO, on the same
    grid, as the reference's."""
    tr = ref_topo.synthetic_z1qx1n(ref_hntr_spec(72, 46), seed=1)
    tp = port_topo.synthetic_z1qx1n(port_hntr_spec(72, 46), seed=1)
    pr, pp = tmp_path / "r.giss", tmp_path / "p.giss"
    ref_giss.write_z1qx1n(str(pr), tr)
    port_giss.write_z1qx1n(str(pp), tp)
    assert pr.read_bytes() == pp.read_bytes()
    back_r = ref_giss.read_z1qx1n(str(pr))
    back_p = port_giss.read_z1qx1n(str(pp))
    assert isinstance(back_p, port_topo.TopoFields)
    assert_same_topo(back_p, back_r)
    for k in ("lonb", "latb"):
        np.testing.assert_array_equal(getattr(back_p.spec, k),
                                      getattr(back_r.spec, k))
