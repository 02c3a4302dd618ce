"""ModelE's mismatched regridder (icebin_tpu_torch/regrid/modele.py) under
the port's coupler: the device exchange grid it hands the device
regeneration (its O-level exchange cells moved to A and scaled by
sAm = LAm / LAp, once) against its host factory (the O-level factory's
cells retargeted at A), and ``GCMCoupler`` over it on both paths.

The toy is tests/test_torch_topo.py's ``ocean_pair`` (an 8 x 8 A grid, the
16 x 16 ocean grid O nested in it, a 40 x 40 ice lattice) with its
fractional ocean ``foceans``, and, for the rule's edge cases, the same
ocean with one iced A cell all ocean (LAp == 0: factor 1) and one whose O
cells ModelE rounds to ocean while the true fraction leaves land
(LAm == 0 < LAp: factor 0).

Everything is held bit for bit, with no tolerance: the device path adds
the same f64 terms in the same order as the host factory (as
tests/test_torch_regen_device.py holds it for a plain regridder), and a
mesh coupler at one rank is the single-device coupler.  The transport
identity, which the configurations state, is held below 1e-10 every step.

This file imports no JAX at its top (its mesh case's rank program is
imported by the ranks); the toy's specs come from the JAX package's
classes through tests/test_torch_topo.py, inside the fixture.
"""
import numpy as np
import pytest
import torch

import icebin_tpu_torch as port
from icebin_tpu_torch.coupler.coupler import IceSheetCoupler
from icebin_tpu_torch.coupler.e1ve0 import e1ve0_matrix
from icebin_tpu_torch.ops.csr import csr_pack, csr_pack_sorted
from icebin_tpu_torch.regrid.device import (DeviceExchange,
                                            DeviceRegridMatrices,
                                            e1ve0_device)
from icebin_tpu_torch.regrid.matrices import RegridMatrices, RegridParams
from icebin_tpu_torch.regrid.modele import GCMRegridderModelE
from tests.test_torch_regen_device import (HostCoupler, bits, coupled,
                                           masks, same_packs, year_forcing)

torch.set_num_threads(1)
CPU = torch.device("cpu")
HC = [0.0, 1000.0, 3000.0]
NAMES = ("AvI", "IvA", "EvI", "IvE", "AvE", "EvA")
STEPS, REGEN = 6, 3


@pytest.fixture(scope="module")
def toy():
    """(specA, specO, specI, {case: (foceanOp, foceanOm)}) in the port's
    classes; the cases "random" (test_torch_topo.py's) and "edges"."""
    from tests.test_torch_host import to_port
    from tests.test_torch_topo import foceans, ocean_pair
    specA, specO, specI = (to_port(s) for s in ocean_pair())
    op, om = foceans(ocean_pair()[1])
    gr = regridder(specA, specO, specI, op, om)
    # the two A cells holding most iced exchange area of the dome
    iA = gr.iA_of_O[gr.grO.sheets["s"].exchange.iA]
    heavy = np.argsort(-np.bincount(iA, minlength=gr.nA))[:2]
    ep = op.copy()
    ep[gr.iA_of_O == heavy[0]] = 1.0        # all ocean: LAp == 0
    ep[gr.iA_of_O == heavy[1]] = 0.6        # rounded to ocean: LAm == 0
    return specA, specO, specI, {"random": (op, om),
                                 "edges": (ep, np.round(ep))}


def regridder(specA, specO, specI, op, om, device=CPU):
    grO = port.GCMRegridder(specO, HC, device=device)
    grO.add_sheet("s", specI, subdiv=1)
    return GCMRegridderModelE(grO, specA, op, om)


def toy_gr(toy, case):
    specA, specO, specI, oceans = toy
    return regridder(specA, specO, specI, *oceans[case])


def dome(specI):
    c = specI.cell_centers()
    r = np.hypot(*((c - c.mean(0)) / np.ptp(c, 0)).T) / 0.4
    return np.where(r < 1.0, 3500.0 * np.sqrt(np.clip(1 - r, 0, 1)),
                    np.nan)


CASES = ("random", "edges")


@pytest.mark.parametrize("case", CASES)
def test_the_mismatch_factor_follows_the_documented_rule(toy, case):
    """sAm = LAm / LAp; 1 where LAp == 0; 0 where LAm == 0 < LAp; the
    counters count the A cells rescaled and zeroed."""
    gr = toy_gr(toy, case)
    areaO = gr.specO.cell_areas()
    for a in range(gr.nA):
        o = gr.iA_of_O == a
        lam = np.sum((1.0 - gr.foceanOm[o]) * areaO[o])
        lap = np.sum((1.0 - gr.foceanOp[o]) * areaO[o])
        want = 1.0 if lap == 0 else (0.0 if lam == 0 else gr.sAm[a])
        assert gr.sAm[a] == want
        assert abs(gr.sAm[a] * lap - lam) <= 1e-12 * max(lam, 1.0)
    assert gr.rescaled == np.count_nonzero(gr.sAm != 1.0) > 0
    assert gr.zeroed == np.count_nonzero(gr.sAm == 0.0)
    if case == "edges":
        assert gr.zeroed >= 1
        assert np.any((gr.LAp == 0) & (gr.sAm == 1.0))


@pytest.mark.parametrize("case", CASES)
def test_device_exchange_is_the_host_factory(toy, case):
    """Over the device exchange grid: the kept cells and their split,
    every matrix with and without correctA, EvI's and AvI's packs,
    ``ec_weights``, fhc and elevE, each mask's; E1vE0 where ice retreats,
    advances and stays; all the host factory's bit for bit."""
    gr = toy_gr(toy, case)
    nI = gr.sheets["s"].specI.ncells
    ms = masks(nI, dome(gr.sheets["s"].specI))
    xd = gr.device_exchange("s", CPU)
    assert (xd.nA, xd.nI) == (gr.nA, nI)
    hs = {k: gr.regrid_matrices("s", m, smooth=False)
          for k, m in ms.items()}
    ds = {k: DeviceRegridMatrices(xd, torch.as_tensor(m))
          for k, m in ms.items()}
    for k in ms:
        rh, rd = hs[k], ds[k]
        assert isinstance(rh, RegridMatrices) and rh.nA == gr.nA
        for a in ("xg_index", "iA", "iI", "o", "iE0", "iE1", "wE0", "wE1"):
            bits(getattr(rh, a), getattr(rd, a), f"{k} {a}")
        for name in NAMES:
            for correct in (True, False):
                P = RegridParams(correctA=correct)
                a, b = rh.matrix(name, P), rd.matrix(name, P)
                assert a.shape == b.shape, name
                for f in ("rows", "cols", "vals", "wM", "Mw"):
                    bits(getattr(a, f), getattr(b, f), f"{k} {name} {f}")
        for name in ("EvI", "AvI"):
            P = RegridParams()
            same_packs(csr_pack(rh.matrix(name, P), nv=16, device=CPU),
                       csr_pack_sorted(*rd.coo(name, P), nv=16),
                       f"{k} {name}")
        for f in ("ec_weights", "fhc", "elevE"):
            bits(getattr(rh, f)(), getattr(rd, f)(), f"{k} {f}")
    for old, new in (("dome", "retreat"), ("dome", "advance"),
                     ("dome", "unchanged")):
        a, b = e1ve0_matrix(hs[old], hs[new]), e1ve0_device(ds[old],
                                                            ds[new])
        assert a.nnz == b.nnz > 0
        for f in ("rows", "cols", "vals", "wM", "Mw"):
            bits(getattr(a, f), getattr(b, f), f"{old}->{new} {f}")


def test_an_ocean_level_exchange_grid_is_not_read_as_the_a_grids(toy):
    """The ``nA`` check: a plain regridder over A given the O-level
    exchange grid refuses it, and the ModelE regridder's sheets carry no
    A-level ``exchange`` to take."""
    specA, _, _, _ = toy
    gr = toy_gr(toy, "random")
    sh = gr.sheets["s"]
    plain = port.GCMRegridder(specA, HC, device=CPU)
    plain.add_sheet("s", sh.gridI, exchange=sh.exchangeO, subdiv=1)
    with pytest.raises(ValueError, match="not read"):
        plain.device_exchange("s", CPU)
    with pytest.raises(ValueError, match="not read"):
        DeviceExchange(plain, "s", CPU)
    assert not hasattr(sh, "exchange")
    with pytest.raises(AttributeError):
        DeviceExchange(gr, "s", CPU)


def transport(rows, sheets):
    worst = 0.0
    for row in rows:
        for s in sheets:
            for book in ("mass", "energy"):
                a = row[f"{s}.{book}_in_E"]
                b = row[f"{s}.{book}_delivered_I"]
                worst = max(worst, abs(a - b) / abs(a))
    return worst


@pytest.mark.parametrize("case", CASES)
def test_fused_coupler_device_path_is_the_host_path(toy, case):
    """``GCMCoupler.run_transient(..., fused=True)`` over the mismatched
    regridder, two regenerations with held state: every matrix build on
    the device path, and its ledger rows, held state, ice state, E1vE0,
    TOPO and packs those of the host factory's coupler bit for bit; the
    transport identity below 1e-10 every step, zeroed A cells too."""
    gr = toy_gr(toy, case)
    runs = {}
    for cls in (IceSheetCoupler, HostCoupler):
        cp = coupled(gr, cls, regen_every=REGEN)
        f = year_forcing(gr.nE)
        runs[cls] = cp, cp.run_transient(lambda t, s: f, STEPS, fused=True)
    (d, rd), (h, rh) = runs[IceSheetCoupler], runs[HostCoupler]
    rows = d.ledger.to_rows()
    assert rows == h.ledger.to_rows()
    assert len(rows) == STEPS
    assert transport(rows, ["s"]) < 1e-10
    assert any(row[k] != 0.0 for row in rows for k in row
               if k.endswith("held_mass_dropped"))
    sd, sh = d.sheets["s"], h.sheets["s"]
    n = 1 + STEPS // REGEN
    assert (sd.regens_device, sd.regens_host) == (n, 0)
    assert (sh.regens_device, sh.regens_host) == (0, n)
    bits(sd.held_E, sh.held_E, "held_E")
    for k in ("H", "enth", "bed", "t"):
        bits(getattr(sd.state, k), getattr(sh.state, k), k)
    for k in ("fhc", "elevE", "fI", "fE_out", "fA_out"):
        bits(rd["s"][k], rh["s"][k], k)
    assert rd["s"]["fhc"].shape == (len(HC), gr.nA)
    for k in ("rows", "cols", "vals"):
        bits(getattr(rh["s"]["E1vE0"], k), getattr(rd["s"]["E1vE0"], k),
             f"E1vE0 {k}")
    for m in ("EvI", "AvI", "AvE"):
        same_packs(sh.mat(m).pack, sd.mat(m).pack, m)
    assert sd.regen.xd.ocean_iced > 0
    if case == "edges":
        # the zeroed A cell holds ice, and its E cells weigh nothing
        z = np.flatnonzero(gr.sAm == 0.0)
        iA = gr.iA_of_O[gr.sheets["s"].exchangeO.iA]
        iI = gr.sheets["s"].exchangeO.iI
        assert np.isfinite(sd.regen_elevmask[iI[np.isin(iA, z)]]).any()
        w = sd.rm.ec_weights().reshape(gr.nA, -1)
        assert np.all(w[z] == 0.0)


def ocean_iced_direct(gr, elevmask):
    xg = gr.sheets["s"].exchangeO
    return int(np.sum((gr.foceanOm[xg.iA] == 1.0)
                      & np.isfinite(elevmask)[xg.iI]))


def test_ocean_iced_counts_the_quirk(toy):
    """``ocean_iced``: the exchange cells over O cells ModelE counts as
    ocean whose ice cell holds ice at set-up."""
    gr = toy_gr(toy, "random")
    sc = IceSheetCoupler(gr, "s", port.CouplerConfig(), device=CPU)
    want = ocean_iced_direct(gr, sc.elevmask().numpy())
    assert sc.regen.xd.ocean_iced == want > 0
    plain = port.GCMRegridder(gr.specO, HC, device=CPU)
    plain.add_sheet("s", gr.sheets["s"].gridI,
                    exchange=gr.sheets["s"].exchangeO, subdiv=1)
    assert IceSheetCoupler(plain, "s", port.CouplerConfig(),
                           device=CPU).regen.xd.ocean_iced == 0


# -- the mesh coupler at one rank ------------------------------------------

def mesh_run(mesh, specA, specO, specI, op, om):
    """Rank program: the fused run over the mismatched regridder on a
    mesh; (ledger rows, the whole lattice's H, held state, path
    counters)."""
    gr = regridder(specA, specO, specI, op, om, device=mesh.device)
    cfg = port.CouplerConfig(regen_every=REGEN)
    cp = port.GCMCoupler(gr, cfg, mesh=mesh)
    return run_held(cp, gr)


def run_held(cp, gr):
    held = np.random.default_rng(9).uniform(0.5, 2.0, (2, gr.nE))
    for sc in cp.sheets.values():
        sc.set_held_state(held)
    f = year_forcing(gr.nE)
    cp.run_transient(lambda t, s: f, STEPS, fused=True)
    sc = cp.sheets["s"]
    return (cp.ledger.to_rows(), sc.gathered_state().H.cpu().numpy(),
            sc.held_E, (sc.regens_device, sc.regens_host))


def test_mesh_coupler_at_one_rank_is_the_single_device_coupler(toy):
    """A mesh rank builds its blocks from the retargeted host factory: at
    one rank its ledger rows, ice state and held state are the
    single-device (device-path) coupler's bit for bit."""
    from icebin_tpu_torch.parallel.distributed import launch
    specA, specO, specI, oceans = toy
    args = (specA, specO, specI, *oceans["edges"])
    (got,) = launch(mesh_run, 1, backend="gloo", device="cpu", args=args,
                    timeout=300, nice=10)
    gr = regridder(*args)
    cfg = port.CouplerConfig(regen_every=REGEN)
    want = run_held(port.GCMCoupler(gr, cfg, device=CPU), gr)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    n = 1 + STEPS // REGEN
    assert (got[3], want[3]) == ((0, n), (n, 0))
