"""Regeneration on the device (icebin_tpu_torch/regrid/device.py,
ops/csr.py:csr_pack_sorted, ops/segsum.py) against the port's host factory
(regrid/matrices.py's RegridMatrices, regrid/sparse.py's WeightedMatrix,
ops/csr.py:csr_pack, coupler/e1ve0.py:e1ve0_matrix), each factory called
directly on the same exchange grid and elevation mask.

Everything is held bit for bit, with no tolerance: both CSRs of EvI and
AvI (rowptr, cols, vals, winv, the live rows and their count), the pack's
f64 weights, every matrix of the factory, E1vE0 (entries, wM, Mw), the EC
measure, fhc and elevE.  The device path adds the same f64 terms in the
same order as numpy (a stable sort, then a left-to-right sum of each run
of equal keys), so any other result is a fault.  The cases: the config
#3/#5 lattices at 150 km (Greenland, Antarctica), masks where ice retreats,
advances and is unchanged, one elevation class, and a synthetic exchange
grid whose (A, I) pairs repeat, so that matrices have duplicate keys to
merge.  A fused two-sheet run across two regenerations with held state
posts the host oracle's ledger bit for bit; the counters show which path
each coupler took (the sigma-smoothed and the mesh couplers keep the host
factory).

This file imports no JAX.
"""
import numpy as np
import pytest
import torch

import icebin_tpu_torch as port
from icebin_tpu_torch.coupler.coupler import HostRegen, IceSheetCoupler
from icebin_tpu_torch.coupler.e1ve0 import e1ve0_matrix
from icebin_tpu_torch.coupler.ledger import Ledger
from icebin_tpu_torch.grid.exchange import ExchangeGrid
from icebin_tpu_torch.ops.csr import CsrBuffers, csr_pack, csr_pack_sorted
from icebin_tpu_torch.ops.segsum import segment_sum, segment_sum_ref
from icebin_tpu_torch.regrid.device import (DeviceExchange,
                                            DeviceRegridMatrices,
                                            e1ve0_device)
from icebin_tpu_torch.regrid.matrices import RegridMatrices, RegridParams
from icebin_tpu_torch.tools.common import (HCDEFS, antarctica_spec,
                                           greenland_specs, same)
from icebin_tpu_torch.utils import trace

torch.set_num_threads(1)
CPU = torch.device("cpu")
NAMES = ("AvI", "IvA", "EvI", "IvE", "AvE", "EvA")


def bits(a, b, what):
    """``a`` and ``b`` (tensors or arrays) the same dtype and bits."""
    a, b = (torch.as_tensor(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x.cpu() for x in (a, b))
    assert a.dtype == b.dtype and a.shape == b.shape, what
    ok = same(a, b) if a.is_floating_point() else torch.equal(a, b)
    assert ok, what


# -- the segment sum -----------------------------------------------------

@pytest.mark.parametrize("n,nseg,seed", [(0, 5, 0), (1, 1, 1), (5000, 37, 2),
                                         (20000, 3000, 3)])
def test_segment_sum_plain_is_bincount(n, nseg, seed):
    """The plain segment sum of sorted keys is ``np.bincount``'s weighted
    sum bit for bit, on terms whose large parts cancel (any other order
    gives other bits), with empty and long segments."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, nseg, n) ** 2 // max(nseg, 1))
    vals = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 12, n)
            * rng.choice([-1.0, 1.0], n))
    # (np.bincount of no weights gives integer zeros)
    want = np.bincount(keys, weights=vals, minlength=nseg).astype(np.float64)
    ptr = torch.as_tensor(np.searchsorted(keys, np.arange(nseg + 1)))
    for fn in (segment_sum_ref, segment_sum):
        bits(fn(torch.as_tensor(vals), ptr), want, fn.__name__)


def test_segment_sum_refuses_bad_operands():
    v = torch.zeros(4, dtype=torch.float64)
    for bad in ((v.float(), torch.tensor([0, 4])),
                (v, torch.tensor([0, 4], dtype=torch.int32)),
                (v, torch.tensor([], dtype=torch.int64))):
        with pytest.raises(ValueError):
            segment_sum(*bad)


# -- the factories on the 150 km lattices ----------------------------------

def masks(nI, base, seed=0):
    """The elevation masks of the cases: ``base`` (a dome), ice retreated
    from a fifth of it, ice advanced onto bare cells (and the rest of the
    surface raised), and the dome again (unchanged)."""
    rng = np.random.default_rng(seed)
    iced = np.flatnonzero(np.isfinite(base))
    retreat = base.copy()
    retreat[rng.choice(iced, len(iced) // 5, replace=False)] = np.nan
    advance = base + 37.5
    bare = np.flatnonzero(~np.isfinite(base))
    if len(bare):
        advance[rng.choice(bare, max(1, len(bare) // 3),
                           replace=False)] = rng.uniform(-50.0, 4000.0)
    advance[rng.choice(nI, 7, replace=False)] = 0.0     # on a boundary
    return {"dome": base, "retreat": retreat, "advance": advance,
            "unchanged": base.copy()}


def dome(specI):
    """A Vialov-like dome over the lattice's inner disc, NaN outside."""
    x = 0.5 * (specI.xb[1:] + specI.xb[:-1])
    y = 0.5 * (specI.yb[1:] + specI.yb[:-1])
    X, Y = np.meshgrid((x - x.mean()) / np.ptp(x), (y - y.mean()) / np.ptp(y))
    r = np.hypot(X, Y) / 0.45
    return np.where(r < 1.0, 3600.0 * np.sqrt(np.clip(1 - r, 0, 1)) - 40.0,
                    np.nan).reshape(-1)


@pytest.fixture(scope="module")
def sheets():
    """{name: (regridder, masks)}: Greenland and Antarctica at 150 km under
    ModelE 2x2.5 with the 5 classes, and Greenland with one class."""
    specA, specG = greenland_specs(150)
    out = {}
    for name, specI, hc in (("greenland", specG, HCDEFS),
                            ("antarctica", antarctica_spec(150), HCDEFS),
                            ("greenland_nhc1", specG, [0.0])):
        gr = port.GCMRegridder(specA, hc, device=CPU)
        gr.add_sheet(name, specI, subdiv=2)
        out[name] = (gr, masks(specI.ncells, dome(specI)))
    return out


def factories(gr, name, mask):
    return (gr.regrid_matrices(name, mask, smooth=False),
            DeviceRegridMatrices(DeviceExchange(gr, name, CPU),
                                 torch.as_tensor(mask)))


def same_packs(ph, pd, what):
    for side in ("small", "ice"):
        a, b = getattr(ph, side), getattr(pd, side)
        for k in ("rowptr", "cols", "vals", "winv", "live"):
            bits(getattr(a, k), getattr(b, k), f"{what} {side} {k}")
        assert (a.n_live, a.n_dst, a.n_src) == (b.n_live, b.n_dst,
                                                 b.n_src), what
    bits(ph.wS, pd.wS, f"{what} wS")
    bits(ph.wI, pd.wI, f"{what} wI")
    assert ph.nv == pd.nv


SHEETS = ("greenland", "antarctica", "greenland_nhc1")
MASKS = ("dome", "retreat", "advance")


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("sheet", SHEETS)
def test_packs_bit_for_bit(sheets, sheet, mask):
    """EvI's and AvI's packs (both CSRs, the live rows, the f64 weights)
    built on the device from the device factory's entries are the host
    factory's ``csr_pack``."""
    gr, ms = sheets[sheet]
    rh, rd = factories(gr, sheet, ms[mask])
    P = RegridParams()
    for name in ("EvI", "AvI"):
        M = rh.matrix(name, P)
        rows, cols, vals, shape = rd.coo(name, P)
        assert shape == M.shape
        same_packs(csr_pack(M, nv=16, device=CPU),
                   csr_pack_sorted(rows, cols, vals, shape, nv=16), name)


@pytest.mark.parametrize("iced", ["every", "one"])
@pytest.mark.parametrize("sheet", SHEETS)
def test_hot_packs_fit_their_buffers(sheets, sheet, iced):
    """At the extremes of the elevation mask (every ice cell iced, at
    elevations across every class; one cell iced, the one with the most
    exchange cells) EvI's and AvI's entries stay within the exchange
    grid's bound (``DeviceExchange.max_entries``), and a pack loaded into
    buffers of that capacity is the pack bit for bit, at the buffers'
    addresses."""
    gr, _ = sheets[sheet]
    xd = DeviceExchange(gr, sheet, CPU)
    nI = gr.sheets[sheet].specI.ncells
    rng = np.random.default_rng(5)
    if iced == "every":
        mask = rng.uniform(-50.0, 4000.0, nI)
    else:
        mask = np.full(nI, np.nan)
        mask[np.bincount(xd.iI.numpy(), minlength=nI).argmax()] = 750.0
    rd = DeviceRegridMatrices(xd, torch.as_tensor(mask))
    for name in ("EvI", "AvI"):
        rows, cols, vals, shape = rd.coo(name, RegridParams())
        cap = xd.max_entries(name)
        assert 0 < len(vals) <= cap, (name, len(vals), cap)
        if iced == "every" and rd.nhc > 1:      # the bound is nearly met
            assert len(vals) > cap // 2, (name, len(vals), cap)
        pack = csr_pack_sorted(rows, cols, vals, shape, nv=16)
        buf = CsrBuffers(*shape, cap, 16, device=CPU)
        got = buf.load(pack)
        same_packs(got, pack, f"{name} loaded")
        assert got.small.vals.data_ptr() == buf.small["vals"].data_ptr()
        assert got.small.live.data_ptr() == buf.small["live"].data_ptr()
        assert got.ice.cols.data_ptr() == buf.ice["cols"].data_ptr()
        assert got.wI is buf.wI


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("sheet", SHEETS)
def test_every_matrix_and_measure_bit_for_bit(sheets, sheet, mask):
    """Every matrix name of the factory with and without correctA (the
    host ``WeightedMatrix`` the device factory hands out), the kept cells
    and their split, ``ec_weights``, ``fhc`` and ``elevE``."""
    gr, ms = sheets[sheet]
    rh, rd = factories(gr, sheet, ms[mask])
    for k in ("xg_index", "iA", "iI", "o", "iE0", "iE1", "wE0", "wE1"):
        bits(getattr(rh, k), getattr(rd, k), k)
    bits(rh.elevmaskI, rd.elevmask, "elevmaskI")
    for name in NAMES:
        for correct in (True, False):
            P = RegridParams(correctA=correct)
            a, b = rh.matrix(name, P), rd.matrix(name, P)
            assert a.shape == b.shape, name
            for k in ("rows", "cols", "vals", "wM", "Mw"):
                bits(getattr(a, k), getattr(b, k), f"{name} {k}")
    for k in ("ec_weights", "fhc", "elevE"):
        bits(getattr(rh, k)(), getattr(rd, k)(), k)
    assert rd.fhc() is rd.fhc() and rd.elevE() is rd.elevE()


@pytest.mark.parametrize("old,new", [("dome", "retreat"), ("dome", "advance"),
                                     ("dome", "unchanged"),
                                     ("retreat", "advance")])
@pytest.mark.parametrize("sheet", SHEETS)
def test_e1ve0_bit_for_bit(sheets, sheet, old, new):
    """E1vE0 between two generations: entries, wM and Mw."""
    gr, ms = sheets[sheet]
    h0, d0 = factories(gr, sheet, ms[old])
    xd = d0.xd
    h1 = gr.regrid_matrices(sheet, ms[new], smooth=False)
    d1 = DeviceRegridMatrices(xd, torch.as_tensor(ms[new]))
    a, b = e1ve0_matrix(h0, h1), e1ve0_device(d0, d1)
    assert a.shape == b.shape and a.nnz == b.nnz > 0
    for k in ("rows", "cols", "vals", "wM", "Mw"):
        bits(getattr(a, k), getattr(b, k), k)


def test_e1ve0_refuses_another_exchange_grid(sheets):
    gr, ms = sheets["greenland"]
    d0 = factories(gr, "greenland", ms["dome"])[1]
    d1 = factories(gr, "greenland", ms["dome"])[1]
    with pytest.raises(ValueError):
        e1ve0_device(d0, d1)            # another upload: another grid
    with pytest.raises(ValueError):
        d0.coo("EvI", RegridParams(sigma=(1e5, 1e5)))
    with pytest.raises(ValueError):
        d0.coo("GvI")                   # the G-space matrices are the host's


# -- a synthetic exchange grid with duplicate keys -----------------------

def test_duplicate_keys_merge_bit_for_bit():
    """Exchange cells whose (A, I) pairs repeat, in shuffled order: AvI and
    EvI have duplicate keys to merge, and the sums of each run are the
    host factory's."""
    from icebin_tpu_torch.grid import GridSpecLonLat, GridSpecXY, PlateCarree
    rng = np.random.default_rng(11)
    specA = GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 9),
                           latb=np.linspace(30.0, 80.0, 7))
    specI = GridSpecXY(xb=np.linspace(0.0, 1e6, 31),
                       yb=np.linspace(0.0, 8e5, 21),
                       projection=PlateCarree(scale=25e3))
    nA, nI = specA.ncells, specI.ncells
    pairs = np.stack([rng.integers(0, nA, 900), rng.integers(0, nI, 900)], 1)
    pairs = pairs[rng.integers(0, len(pairs), 4000)]     # repeats
    xg = ExchangeGrid(iA=pairs[:, 0].astype(np.int32), iI=pairs[:, 1],
                      area=rng.uniform(0.0, 5e8, len(pairs))
                      * 10.0 ** rng.integers(-6, 1, len(pairs)),
                      centroid=None, nA=nA, nI=nI)
    gr = port.GCMRegridder(specA, HCDEFS, device=CPU)
    gr.add_sheet("dup", specI, exchange=xg, subdiv=2)
    ms = masks(nI, rng.uniform(-100.0, 4000.0, nI), seed=3)
    ms["dome"][rng.choice(nI, nI // 4, replace=False)] = np.nan
    xd = DeviceExchange(gr, "dup", CPU)
    hs = {k: gr.regrid_matrices("dup", m, smooth=False) for k, m in
          ms.items()}
    ds = {k: DeviceRegridMatrices(xd, torch.as_tensor(m))
          for k, m in ms.items()}
    P = RegridParams()
    for k in ms:
        for name in ("EvI", "AvI", "AvE"):
            M = hs[k].matrix(name, P)
            assert M.nnz < 2 * xg.ncells
            same_packs(csr_pack(M, nv=16, device=CPU),
                       csr_pack_sorted(*ds[k].coo(name, P), nv=16),
                       f"{k} {name}")
        for f in ("ec_weights", "fhc", "elevE"):
            bits(getattr(hs[k], f)(), getattr(ds[k], f)(), f"{k} {f}")
    for old, new in (("dome", "retreat"), ("retreat", "advance")):
        a, b = e1ve0_matrix(hs[old], hs[new]), e1ve0_device(ds[old],
                                                            ds[new])
        for k in ("rows", "cols", "vals", "wM", "Mw"):
            bits(getattr(a, k), getattr(b, k), f"{old}->{new} {k}")


# -- the coupler: which path, and the same books -------------------------

class HostCoupler(IceSheetCoupler):
    """The same sheet with its matrices from the host factory: the
    oracle of the device path."""

    def _regen_on_device(self) -> bool:
        return False


def two_sheets():
    specA, specG = greenland_specs(150)
    gr = port.GCMRegridder(specA, HCDEFS, device=CPU)
    gr.add_sheet("greenland", specG, subdiv=2)
    gr.add_sheet("antarctica", antarctica_spec(150), subdiv=2)
    return gr


def coupled(gr, sheet_cls, regen_every=3):
    cfg = port.CouplerConfig(regen_every=regen_every)
    cp = port.GCMCoupler(gr, cfg, device=CPU, sheets={
        name: sheet_cls(gr, name, cfg, device=CPU) for name in gr.sheets})
    held = np.random.default_rng(9).uniform(0.5, 2.0, (2, gr.nE))
    for sc in cp.sheets.values():
        sc.set_held_state(held)
    return cp


def year_forcing(nE):
    """Melt on half the E cells, accumulation on the rest: the margins
    retreat and the interior thickens, so the masks change."""
    rng = np.random.default_rng(4)
    f = np.zeros((8, nE), np.float32)
    f[0] = np.where(rng.uniform(size=nE) < 0.5, -3e-3, 2e-4)
    f[1] = 5.0
    f[4] = -10.0
    return torch.as_tensor(f)


def test_fused_run_posts_the_host_oracles_ledger():
    """Two sheets, a fused run of 6 steps regenerating every 3 (two
    regenerations, each remapping the held state through E1vE0): the
    device path's ledger (held_mass, _dropped, _gained and every step's
    row), held state, ice state, E1vE0 and TOPO are the host factory's
    bit for bit; each coupler counts its own path."""
    gr = two_sheets()
    runs = {}
    for cls in (IceSheetCoupler, HostCoupler):
        cp = coupled(gr, cls)
        f = year_forcing(gr.nE)
        res = cp.run_transient(lambda t, s: f, 6, fused=True)
        runs[cls] = cp, res
    (d, rd), (h, rh) = runs[IceSheetCoupler], runs[HostCoupler]
    rows_d, rows_h = d.ledger.to_rows(), h.ledger.to_rows()
    assert rows_d == rows_h
    held = [k for row in rows_d for k in row if ".held_mass" in k]
    assert len(held) == 2 * 3 * 2                 # 2 regens x 3 x 2 sheets
    assert any(row[k] != 0.0 for row in rows_d for k in row
               if k.endswith("held_mass_dropped"))
    for name in gr.sheets:
        sd, sh = d.sheets[name], h.sheets[name]
        assert (sd.regens_device, sd.regens_host) == (3, 0)
        assert (sh.regens_device, sh.regens_host) == (0, 3)
        assert isinstance(sd.rm, DeviceRegridMatrices)
        assert isinstance(sh.rm, RegridMatrices)
        bits(sd.held_E, sh.held_E, f"{name} held_E")
        for k in ("H", "enth", "bed", "t"):
            bits(getattr(sd.state, k), getattr(sh.state, k), f"{name} {k}")
        bits(sd.regen_elevmask, sh.regen_elevmask, f"{name} elevmask")
        for k in ("fhc", "elevE", "fI", "fE_out", "fA_out"):
            bits(rd[name][k], rh[name][k], f"{name} {k}")
        a, b = rh[name]["E1vE0"], rd[name]["E1vE0"]
        for k in ("rows", "cols", "vals"):
            bits(getattr(a, k), getattr(b, k), f"{name} E1vE0 {k}")
        assert sd.held_mass() == sh.held_mass()
        for m in ("AvE", "EvA"):                     # built lazily
            assert sd.mat(m).logical_shape == sh.mat(m).logical_shape
            same_packs(sh.mat(m).pack, sd.mat(m).pack, f"{name} {m}")


def test_resume_and_span_on_the_device_path(tmp_path):
    """A checkpoint's elevation mask rebuilds on the device path (its
    matrices the host factory's bit for bit), and a regeneration's span
    says which path it took."""
    from icebin_tpu_torch.coupler.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    gr = two_sheets()
    cp = coupled(gr, IceSheetCoupler, regen_every=2)
    f = year_forcing(gr.nE)
    with trace.recording():
        cp.run_transient(lambda t, s: f, 2, fused=True)
    spans = trace.drain()
    regen = [s for s in spans if s.name == "regen"]
    assert [s.attrs for s in regen] == [
        {"sheet": n, "path": "device", "grid": "lonlat"} for n in gr.sheets]
    assert "regen.upload" not in {s.name for s in spans}
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, cp)
    again = coupled(gr, HostCoupler, regen_every=2)
    load_checkpoint(path, again)
    for name, sc in cp.sheets.items():
        ho = again.sheets[name]
        assert sc.regen_elevmask.dtype == ho.regen_elevmask.dtype
        bits(sc.regen_elevmask, ho.regen_elevmask, name)
        for m in ("EvI", "AvI"):
            same_packs(ho.mat(m).pack, sc.mat(m).pack, f"{name} {m}")


def test_sigma_coupler_keeps_the_host_factory():
    """With sigma smoothing the matrices are the host factory's (a scipy
    composition), every regeneration on the host path, its upload inside
    the regeneration."""
    gr = two_sheets()
    cfg = port.CouplerConfig(regen_every=1, params=RegridParams(
        sigma=(2e5, 2e5)))
    sc = IceSheetCoupler(gr, "greenland", cfg, device=CPU)
    assert isinstance(sc.rm, RegridMatrices)
    assert isinstance(sc.regen, HostRegen)
    with trace.recording():
        sc.steps_since_regen = 1
        sc._regen_if_due(Ledger())
    spans = trace.drain()
    assert spans[0].name == "regen"
    assert spans[0].attrs == {"sheet": "greenland", "path": "host",
                              "grid": "lonlat"}
    assert {"regen.upload", "regen.pack"} <= {s.name for s in spans}
    assert (sc.regens_device, sc.regens_host) == (0, 2)


def mesh_paths(mesh):
    """Rank program: a mesh coupler's path counters and factory."""
    import icebin_tpu_torch as p
    from icebin_tpu_torch.tools.common import HCDEFS as hc
    from icebin_tpu_torch.tools.common import greenland_specs as gs
    specA, specG = gs(150)
    gr = p.GCMRegridder(specA, hc, device=mesh.device)
    gr.add_sheet("greenland", specG, subdiv=2)
    cp = p.GCMCoupler(gr, p.CouplerConfig(regen_every=1), mesh=mesh)
    sc = cp.sheets["greenland"]
    sc.steps_since_regen = 1
    sc._regen_if_due(cp.ledger)
    return type(sc.rm).__name__, sc.regens_device, sc.regens_host


def test_mesh_coupler_keeps_the_host_factory():
    """A mesh rank cuts its blocks from the host factory's matrices."""
    from icebin_tpu_torch.parallel.distributed import launch
    (out,) = launch(mesh_paths, 1, backend="gloo", device="cpu",
                    timeout=300, nice=10)
    assert out == ("RegridMatrices", 0, 2)
