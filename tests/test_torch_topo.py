"""The port's ModelE input toolchain against the reference's, on the same
numbers: the mismatched regridder (``regrid/modele.py``), the
``make_topoo``, ``global_ec`` and ``giss2nc`` CLIs, the roofline
accounting (``utils/profiling.py``), the plots (``utils/plot.py``) and
the coupled Greenland example's twin.

Each side is built from its own package's classes out of the same arrays
(tests/test_torch_host.py:to_port).  Tolerances, with their reasons:
* the mismatched matrices, ``fhc``, ``elevE`` and ``sAm`` over an exchange
  grid that both packages build on the host in f64: bit for bit (the
  module is a numpy copy);
* over the port's own clip (``device=cpu``, the kernel's plain f32
  version): applies and weights within 1e-5 of their scale, the exchange
  tolerance of ``chip_smoke.py``'s phase 3 (f32 rounds a cell's vertices
  at about 1e-6 of its area), and the conservation identity at 1e-12
  (tests/test_topo_modele.py:134-136), which the construction keeps
  whatever the overlaps;
* each CLI's output file: the reference CLI's, byte for byte, and each
  variable and attribute equal (the CLIs are copies over bit-identical
  host modules, and the regridder file carries its exchange grids);
* the example twin against the JAX example at 100 km: the printed ice
  masses within 1e-6 (each builds its own exchange grid, the port in f32)
  and both transport figures below 1e-10;
* each grid script's twin: the reference script's file, byte for byte.
"""
import contextlib
import io
import os
import runpy
import sys

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from icebin_tpu.cli import giss2nc as ref_giss2nc
from icebin_tpu.cli import global_ec as ref_global_ec
from icebin_tpu.cli import make_topoo as ref_make_topoo
from icebin_tpu.grid import proj as ref_proj, spec as ref_spec
from icebin_tpu.io import giss as ref_giss, ncio as ref_ncio
from icebin_tpu.regrid.gcmregridder import GCMRegridder as RefRegridder
from icebin_tpu.regrid.hntr import hntr_spec as ref_hntr_spec
from icebin_tpu.regrid.matrices import RegridParams as RefParams
from icebin_tpu.regrid.modele import GCMRegridderModelE as RefModelE
from icebin_tpu.topo import topo as ref_topo
from icebin_tpu.utils import profiling as ref_prof

from icebin_tpu_torch.cli import giss2nc as port_giss2nc
from icebin_tpu_torch.cli import global_ec as port_global_ec
from icebin_tpu_torch.cli import make_topoo as port_make_topoo
from icebin_tpu_torch.grid import spec as port_spec
from icebin_tpu_torch.grid.exchange import \
    make_exchange_grid_host as port_build
from icebin_tpu_torch.regrid.gcmregridder import \
    GCMRegridder as PortRegridder
from icebin_tpu_torch.regrid.matrices import RegridParams as PortParams
from icebin_tpu_torch.regrid.modele import GCMRegridderModelE as PortModelE
from icebin_tpu_torch.utils import profiling as port_prof

from helpers import toy_elevmask, toy_grids
from tests.test_torch_host import assert_same_matrix, to_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HC = [0.0, 1000.0, 3000.0]
NAMES = ("AvI", "EvI", "IvA", "IvE")
XG_TOL = 1e-5


# -- GCMRegridderModelE -------------------------------------------------------

def ocean_pair(factor=2, n=(8, 8)):
    """tests/test_topo_modele.py:80-86, in the reference's classes, with
    its ice grid (:115-119)."""
    specA = ref_spec.GridSpecLonLat(lonb=np.linspace(0.0, 40.0, n[0] + 1),
                                    latb=np.linspace(30.0, 70.0, n[1] + 1))
    specO = ref_spec.GridSpecLonLat(
        lonb=np.linspace(0.0, 40.0, factor * n[0] + 1),
        latb=np.linspace(30.0, 70.0, factor * n[1] + 1))
    scale = 25e3
    specI = ref_spec.GridSpecXY(xb=np.linspace(5 * scale, 35 * scale, 41),
                                yb=np.linspace(35 * scale, 65 * scale, 41),
                                projection=ref_proj.PlateCarree(scale=scale))
    return specA, specO, specI


def foceans(specO):
    """tests/test_topo_modele.py:122-124: a fractional ocean and its
    rounding (ModelE's mask)."""
    rng = np.random.default_rng(0)
    op = np.clip(rng.uniform(-0.3, 0.6, specO.ncells), 0, 1)
    return op, np.round(op)


@pytest.fixture(scope="module")
def mismatched():
    """The reference's and the port's mismatched regridders over one
    exchange grid built on the host in f64 (the port's sheet added with
    ``exchange=``), and the port's over its own clip on the CPU."""
    specA, specO, specI = ocean_pair()
    op, om = foceans(specO)
    grO_r = RefRegridder(specO, hcdefs=HC)
    grO_r.add_sheet("s", specI, subdiv=1, engine="numpy")
    pO, pI = to_port(specO), to_port(specI)
    grO_p = PortRegridder(pO, hcdefs=HC, device=CPU)
    grO_p.add_sheet("s", pI, exchange=port_build(grO_p.gridA, pI, subdiv=1),
                    subdiv=1)
    grO_c = PortRegridder(pO, hcdefs=HC, device=CPU)
    grO_c.add_sheet("s", pI, subdiv=1)
    elev = toy_elevmask(specI, ice_frac=0.5)
    return (RefModelE(grO_r, specA, op, om),
            PortModelE(grO_p, to_port(specA), op, om),
            PortModelE(grO_c, to_port(specA), op, om), elev)


@pytest.mark.parametrize("correctA", [False, True])
def test_mismatched_bit_identical_on_one_exchange_grid(mismatched, correctA):
    """AvI, EvI, IvA and IvE (rows, cols, vals, wM, Mw), fhc, elevE and the
    mismatch diagonal sAm bit for bit the reference's."""
    mr, mp, _, elev = mismatched
    np.testing.assert_array_equal(mp.sAm, mr.sAm)
    np.testing.assert_array_equal(mp.iA_of_O, mr.iA_of_O)
    assert not np.allclose(mr.sAm, 1.0)
    fr, fp = mr.regrid_matrices("s", elev), mp.regrid_matrices("s", elev)
    for name in NAMES:
        Mr = fr.matrix(name, RefParams(scale=True, correctA=correctA))
        Mp = fp.matrix(name, PortParams(scale=True, correctA=correctA))
        assert Mr.nnz > 0
        assert_same_matrix(Mp, Mr)
    np.testing.assert_array_equal(fp.fhc(), fr.fhc())
    np.testing.assert_array_equal(fp.elevE(), fr.elevE())


def test_mismatched_over_the_port_clip(mismatched):
    """Over the port's own clip (``device=cpu``: the kernel's plain f32
    version): each matrix's weights and the apply of one field within
    XG_TOL of their scale, and the conservation identity at 1e-12."""
    mr, _, mc, elev = mismatched
    fr, fc = mr.regrid_matrices("s", elev), mc.regrid_matrices("s", elev)
    rng = np.random.default_rng(0)
    for name in NAMES:
        Mr = fr.matrix(name, RefParams(scale=True, correctA=False))
        Mc = fc.matrix(name, PortParams(scale=True, correctA=False))
        assert tuple(Mc.shape) == tuple(Mr.shape)
        for k in ("wM", "Mw"):
            a, b = getattr(Mr, k), getattr(Mc, k)
            assert np.abs(a - b).max() <= XG_TOL * np.abs(a).max(), k
        x = rng.uniform(1, 2, Mr.shape[1])
        yr, yc = Mr.apply(x), Mc.apply(x)
        ok = np.isfinite(yr) & np.isfinite(yc)
        assert ok.any()
        assert np.abs(yr[ok] - yc[ok]).max() <= XG_TOL * np.abs(yr[ok]).max()
        lhs = np.sum(np.where(np.isfinite(yc), yc, 0.0) * Mc.wM)
        np.testing.assert_allclose(lhs, np.sum(x * Mc.Mw), rtol=1e-12)


def test_mismatched_rejects_bad_inputs():
    """tests/test_topo_modele.py:146-156 and the size check: an unrounded
    ModelE mask, an ocean grid that does not nest, an ocean fraction of
    the wrong size; each refused by both packages."""
    specA, specO, _ = ocean_pair()
    bad = ref_spec.GridSpecLonLat(lonb=np.linspace(0, 40, 8),
                                  latb=np.linspace(30, 70, 9))
    z = np.zeros(specO.ncells)
    cases = [(specO, z, np.full(specO.ncells, 0.5), "rounded"),
             (bad, np.zeros(bad.ncells), np.zeros(bad.ncells), "nest"),
             (specO, z[:-1], z, "size mismatch")]
    for spec, op, om, why in cases:
        with pytest.raises(ValueError, match=why):
            RefModelE(RefRegridder(spec, hcdefs=HC), specA, op, om)
        with pytest.raises(ValueError, match=why):
            PortModelE(PortRegridder(to_port(spec), hcdefs=HC, device=CPU),
                       to_port(specA), op, om)


# -- the CLIs -----------------------------------------------------------------

def same_file(pp, pr):
    """The port CLI's NetCDF file is the reference CLI's: its global
    attributes, dimensions and every variable's dims, type, attributes and
    values, and then its bytes."""
    with netcdf_file(pp, "r", mmap=False) as a, \
            netcdf_file(pr, "r", mmap=False) as b:
        assert a._attributes == b._attributes
        assert a.dimensions == b.dimensions
        assert list(a.variables) == list(b.variables)
        for k, vb in b.variables.items():
            va = a.variables[k]
            assert va.dimensions == vb.dimensions, k
            assert va.typecode() == vb.typecode(), k
            assert va._attributes == vb._attributes, k
            np.testing.assert_array_equal(np.array(va[:]), np.array(vb[:]))
    with open(pp, "rb") as a, open(pr, "rb") as b:
        assert a.read() == b.read()


def both(tmp_path, ref_main, port_main, args, device=True):
    """Each CLI's ``main`` on the same arguments (the port's with ``--device
    cpu`` where it takes one), ``{out}`` replaced by r.nc or p.nc.
    Returns the port's and the reference's output paths."""
    paths = []
    for tag, main, extra in (("r", ref_main, []),
                             ("p", port_main,
                              ["--device", "cpu"] if device else [])):
        out = str(tmp_path / f"{tag}.nc")
        argv = [a.replace("{out}", out) for a in args] + extra
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv) == 0
        paths.append(out)
    return paths[1], paths[0]


def test_make_topoo_synthetic_file_is_the_reference_file(tmp_path):
    """tests/test_cli.py:39: ``--synthetic 72x46 --om 36x24``."""
    same_file(*both(tmp_path, ref_make_topoo.main, port_make_topoo.main,
                    ["--synthetic", "72x46", "--om", "36x24", "--out",
                     "{out}"]))
    topo = port_make_topoo.read_topo(str(tmp_path / "p.nc"))
    assert isinstance(topo.spec, port_spec.GridSpecLonLat)
    topo.check()


def test_make_topoo_giss_base_file_is_the_reference_file(tmp_path):
    """tests/test_ingest.py:101: a Z1QX1N GISS base onto 36 x 24."""
    base = str(tmp_path / "base.giss")
    ref_giss.write_z1qx1n(base, ref_topo.synthetic_z1qx1n(
        ref_hntr_spec(72, 46), seed=2))
    same_file(*both(tmp_path, ref_make_topoo.main, port_make_topoo.main,
                    ["--base", base, "--om", "36x24", "--out", "{out}"]))


@pytest.fixture()
def regridder_file(tmp_path):
    """tests/test_cli.py:48's toy regridder and elevmask, written by the
    reference."""
    specA, specI = toy_grids((30, 30), (5, 5))
    gr = RefRegridder(specA, hcdefs=[0.0, 1000.0, 3000.0])
    gr.add_sheet("toy", specI, subdiv=1, engine="numpy")
    pgr = str(tmp_path / "gr.nc")
    ref_ncio.write_gcmregridder(pgr, gr)
    pel = str(tmp_path / "elev.npy")
    np.save(pel, toy_elevmask(specI))
    return pgr, pel


@pytest.mark.parametrize("flags", [["--matrices", "AvI,EvI"], [],
                                   ["--uncompressed", "--no-correctA"]])
def test_global_ec_file_is_the_reference_file(tmp_path, regridder_file,
                                              flags):
    """tests/test_cli.py:48 (AvI and EvI), all six matrices, and the
    uncompressed form without correctA: the zarray blobs, the shapes and
    ``icebin_tpu_schema`` as the reference's."""
    pgr, pel = regridder_file
    same_file(*both(tmp_path, ref_global_ec.main, port_global_ec.main,
                    [pgr, "{out}", "--elevmask", f"toy={pel}"] + flags))


def test_make_topoo_merge_file_is_the_reference_file(tmp_path,
                                                     regridder_file):
    """``--merge`` of the toy sheet into a synthetic 5 x 5 TOPO on the
    regridder's own A grid."""
    pgr, pel = regridder_file
    same_file(*both(tmp_path, ref_make_topoo.main, port_make_topoo.main,
                    ["--synthetic", "5x5", "--om", "5x5", "--out", "{out}",
                     "--regridder", pgr, "--elevmask", f"toy={pel}",
                     "--merge"]))


def test_giss2nc_file_is_the_reference_file(tmp_path):
    """tests/test_ingest.py:117: a Z1QX1N base, and a record of a shape
    the reader cannot infer (kept 1-D), with a repeated title."""
    base = str(tmp_path / "base.giss")
    recs = [ref_giss.GissRecord(title=f"{t}: field", data=d)
            for t, d in (("ZATMO", np.arange(6, dtype=np.float32)),
                         ("ZATMO", np.ones(6, np.float32)))]
    topo = ref_topo.synthetic_z1qx1n(ref_hntr_spec(72, 46), seed=3)
    ref_giss.write_z1qx1n(base, topo)
    extra = str(tmp_path / "extra.giss")
    ref_giss.write_giss(extra, recs)
    with open(base, "ab") as f, open(extra, "rb") as g:
        f.write(g.read())
    same_file(*both(tmp_path, ref_giss2nc.main, port_giss2nc.main,
                    [base, "{out}"], device=False))


def test_clis_refuse_a_missing_gpu(tmp_path, regridder_file, capsys):
    """``--device cuda`` (the default) needs a card: no silent fallback
    (where a card is present, the default runs: checked on the card by
    ``chip_smoke.py``)."""
    if torch.cuda.is_available():
        return
    pgr, pel = regridder_file
    for main, args in ((port_make_topoo.main,
                        ["--synthetic", "72x46", "--om", "36x24", "--out",
                         str(tmp_path / "t.nc")]),
                       (port_global_ec.main,
                        [pgr, str(tmp_path / "e.nc"), "--elevmask",
                         f"toy={pel}"])):
        with pytest.raises(SystemExit) as e:
            main(args)
        assert e.value.code == 2
        assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "t.nc").exists()
    assert not (tmp_path / "e.nc").exists()


# -- roofline accounting and plots --------------------------------------------

def test_roofline_report_and_clip_flops_are_the_reference_ones():
    """The same entries give the reference's report at a given roof; the
    default roof is the H100 data sheet's, named as such; the clip's op
    count is the reference's; an apply's bytes are the kernels' bound's."""
    from icebin_tpu_torch.ops.csr import csr_from_coo
    from icebin_tpu_torch.tools.common import PEAK_BYTES_S, spmm_bound
    for v0 in (4, 8, 16):
        assert port_prof.clip_pair_flops(v0) == ref_prof.clip_pair_flops(v0)
    reports = []
    for mod in (port_prof, ref_prof):
        roof = mod.Roofline(hbm_gbps=100.0)
        for name, nbytes in (("EvI", 123_456_789), ("IvE", 5_000)):
            with roof.measure(name, bytes=nbytes, flops=7):
                pass
            roof.entries[name].seconds = 0.0125
        with roof.measure("EvI", bytes=1000):
            pass
        roof.entries["EvI"].seconds = 0.03
        reports.append(roof.report())
    assert reports[0] == reports[1]
    assert "% of roof" in reports[0]
    default = port_prof.Roofline()
    assert default.hbm_gbps == PEAK_BYTES_S / 1e9
    assert "H100 SXM data sheet" in default.report()
    rng = np.random.default_rng(1)
    dst, src = rng.integers(0, 50, 400), rng.integers(0, 300, 400)
    csr = csr_from_coo(dst, src, rng.uniform(size=400), 50, 300,
                       np.ones(50), device=CPU)
    nbytes = port_prof.csr_apply_bytes(csr, 16)
    used = len(np.unique(src))
    assert nbytes == 4 * (51 + 2 * 400 + 50) + 4 * 16 * (used + 50)
    assert spmm_bound(csr, 16) == (1e3 * nbytes / PEAK_BYTES_S, "bytes")


def test_plots_write_pngs_from_port_specs_and_tensors(tmp_path):
    """tests/test_observability.py:46 on the port's specs and exchange grid,
    with the fields as CPU tensors."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from icebin_tpu_torch.grid import make_exchange_grid
    from icebin_tpu_torch.utils.plot import (plot_exchange, plot_fhc,
                                             plot_field)
    specA, specI = (to_port(s) for s in toy_grids((20, 20), (4, 4)))
    paths = []
    for k, (spec, field) in enumerate(((specA, torch.arange(specA.ncells)),
                                       (specI, torch.ones(specI.ncells)))):
        ax = plot_field(spec, field, title="f", units="m")
        paths.append(tmp_path / f"f{k}.png")
        ax.figure.savefig(str(paths[-1]))
    ax = plot_exchange(make_exchange_grid(specA, specI, subdiv=1,
                                          device=CPU))
    paths.append(tmp_path / "x.png")
    ax.figure.savefig(str(paths[-1]))
    fhc = torch.as_tensor(np.random.default_rng(0).uniform(
        0, 1, (2, specA.ncells)))
    axes = plot_fhc(specA, fhc, [0.0, 1000.0])
    assert len(axes) == 2
    paths.append(tmp_path / "fhc.png")
    axes[0].figure.savefig(str(paths[-1]))
    plt.close("all")
    assert all(p.stat().st_size > 0 for p in paths)
    with pytest.raises(TypeError):
        plot_field(object(), np.zeros(3))


# -- the coupled Greenland example --------------------------------------------

def masses(out):
    """(per-step ice masses, final mass, worst transport) printed."""
    steps = [float(l.split("ice mass ")[1].split(" kg")[0])
             for l in out.splitlines() if l.strip().startswith("step ")]
    done = [l for l in out.splitlines() if l.startswith("done:")][0]
    return (steps, float(done.split("ice mass ")[1].split(" kg")[0]),
            float(done.rsplit(" ", 1)[-1]))


def test_example_twin_matches_the_jax_example(tmp_path, monkeypatch):
    """``examples/coupled_greenland_torch.py --res-km 100 --steps 2
    --device cpu --plot`` against ``examples/coupled_greenland.py`` at the
    same flags: the printed ice masses within 1e-6, both transport figures
    < 1e-10, three-step dumps and the plot written."""
    outs = {}
    for tag, name, extra in (("ref", "coupled_greenland.py", []),
                             ("port", "coupled_greenland_torch.py",
                              ["--device", "cpu", "--plot"])):
        argv = [name, "--res-km", "100", "--steps", "2", "--out",
                str(tmp_path / tag)] + extra
        monkeypatch.setattr(sys, "argv", argv)
        monkeypatch.setattr(sys, "path", list(sys.path))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(ROOT, "examples", name),
                           run_name="__main__")
        outs[tag] = masses(buf.getvalue())
    (sr, fr, wr), (sp, fp, wp) = outs["ref"], outs["port"]
    assert len(sp) == len(sr) == 2
    np.testing.assert_allclose(sp + [fp], sr + [fr], rtol=1e-6)
    assert wp < 1e-10 and wr < 1e-10
    assert (tmp_path / "port" / "demo.png").stat().st_size > 0
    assert sorted(os.listdir(tmp_path / "port" / "dumps")) == sorted(
        os.listdir(tmp_path / "ref" / "dumps"))


# -- the grid scripts ---------------------------------------------------------

@pytest.mark.parametrize("script,args", [
    ("modele_ll_g4x5", []), ("modele_ll_g2x2_5", []), ("searise", ["20"]),
    ("antarctica", ["40"])])
def test_grid_script_twins_write_the_reference_files(tmp_path, monkeypatch,
                                                     script, args):
    """tests/test_cli.py:75's grid scripts (and the 2 x 2.5 one): each
    twin under ``grids/`` writes the reference script's file, byte for
    byte, which the port's ``read_grid`` reads back."""
    from icebin_tpu_torch.io import read_grid
    paths = []
    for tag, name in (("r", script), ("p", script + "_torch")):
        out = str(tmp_path / f"{tag}.nc")
        monkeypatch.setattr(sys, "argv", [name] + args + [out])
        with contextlib.redirect_stdout(io.StringIO()):
            runpy.run_path(os.path.join(ROOT, "grids", name + ".py"),
                           run_name="__main__")
        paths.append(out)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert read_grid(paths[1]).spec.ncells > 0
