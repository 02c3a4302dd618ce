"""BASELINE config #5 at tests/test_multisheet.py's sizes, the port against
the reference: Greenland and Antarctica stereographic lattices (100 and
150 km) under one ModelE 72 x 45 regridder.

* Each sheet's AvI conserves (rtol 1e-12) and the two sheets touch disjoint
  A cells (the port's own exchange grids, through its clip's plain
  version on the CPU).
* A 4-step transient of the port's two-sheet ``GCMCoupler`` (regen_every
  3, so one regeneration of each sheet) against the reference's on the
  same forcing, generated once with numpy for every (step, sheet) and
  handed to both.  Tolerances are tests/test_torch_coupler.py's, for its
  reasons: fields and ice state 1e-5 of each row's scale, ledger rows 1e-6
  of the row (residual and clamp rows 1e-6 of their book's store).
* The port's transport identity < 1e-10 for each sheet and step.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icebin_tpu.coupler import coupler as ref_coupler
from icebin_tpu.grid import spec as ref_spec
from icebin_tpu.regrid.gcmregridder import GCMRegridder as RefRegridder

import icebin_tpu_torch as port
from icebin_tpu_torch.grid import spec as port_spec
from icebin_tpu_torch.regrid.matrices import RegridParams

from test_torch_coupler import _DERIVED, FIELD_TOL, LEDGER_TOL, close

torch.set_num_threads(1)

CPU = torch.device("cpu")
GREENLAND = "+proj=stere +lat_0=90 +lat_ts=71 +lon_0=-39 +ellps=WGS84"
ANTARCTICA = "+proj=stere +lat_0=-90 +lat_ts=-71 +lon_0=0 +ellps=WGS84"
HCDEFS = [0.0, 500.0, 1500.0, 3000.0]
SHEETS = ("greenland", "antarctica")
DT = 86400.0 * 30
N_STEPS = 4
REGEN = 3


def sheet_specs(spec, res_km):
    """tests/test_multisheet.py's lattices, in ``spec``'s package."""
    step = res_km * 1e3
    return {
        "greenland": spec.GridSpecXY(
            xb=np.arange(-650e3, 850e3 + 1, step),
            yb=np.arange(-3350e3, -650e3 + 1, step),
            projection=GREENLAND, name="greenland"),
        "antarctica": spec.GridSpecXY(
            xb=np.arange(-2800e3, 2800e3 + 1, step),
            yb=np.arange(-2800e3, 2800e3 + 1, step),
            projection=ANTARCTICA, name="antarctica")}


def port_regridder(res_km):
    gr = port.GCMRegridder(port_spec.modele_lonlat_grid(72, 45), HCDEFS,
                           device=CPU)
    for name, specI in sheet_specs(port_spec, res_km).items():
        gr.add_sheet(name, specI, subdiv=2)
    return gr


def ref_regridder(res_km):
    gr = RefRegridder(ref_spec.modele_lonlat_grid(72, 45), hcdefs=HCDEFS)
    for name, specI in sheet_specs(ref_spec, res_km).items():
        gr.add_sheet(name, specI, subdiv=2, engine="numpy")
    return gr


def dome(specI):
    """tests/test_multisheet.py's elliptical 3000 m dome mask."""
    c = specI.cell_centers()
    r2 = (((c[:, 0] - c[:, 0].mean()) / (np.ptp(c[:, 0]) / 2.2)) ** 2
          + ((c[:, 1] - c[:, 1].mean()) / (np.ptp(c[:, 1]) / 2.2)) ** 2)
    return np.where(r2 < 1, 3000.0 * (1 - r2), np.nan)


def test_two_sheets_share_one_A_grid():
    gr = port_regridder(100.0)
    P = RegridParams(scale=True, correctA=True)
    rng = np.random.default_rng(0)
    touched = {}
    for name in SHEETS:
        M = gr.regrid_matrices(name, dome(gr.sheets[name].specI)).matrix(
            "AvI", P)
        x = rng.uniform(1, 2, M.shape[1])
        out = M.apply(x)
        lhs = np.sum(np.where(np.isfinite(out), out, 0.0) * M.wM)
        np.testing.assert_allclose(lhs, np.sum(x * M.Mw), rtol=1e-12)
        touched[name] = M.wM > 0
    assert not (touched["greenland"] & touched["antarctica"]).any()
    assert touched["greenland"].any() and touched["antarctica"].any()


def forcing_seq(nE, seed=1):
    """(step, sheet) -> (8, nE) f32 forcing: tests/test_multisheet.py's
    fields (smb, tsurf -12 degC), drawn once for both packages."""
    rng = np.random.default_rng(seed)
    seq = {}
    for k in range(N_STEPS):
        for name in SHEETS:
            f = np.zeros((8, nE), np.float32)
            f[0] = 1e-5 * rng.uniform(0.5, 1.0, nE)
            f[4] = -12.0
            seq[k, name] = f
    return seq


@pytest.fixture(scope="module")
def runs():
    """Both packages' two-sheet couplers driven stepwise through the same
    4 steps."""
    cj = ref_coupler.GCMCoupler(ref_regridder(150.0),
                                ref_coupler.CouplerConfig(dt=DT,
                                                          regen_every=REGEN))
    ct = port.GCMCoupler(port_regridder(150.0),
                         port.CouplerConfig(dt=DT, regen_every=REGEN),
                         device=CPU)
    assert cj.gr.nE == ct.gr.nE
    seq = forcing_seq(ct.gr.nE)
    steps = []
    for k in range(N_STEPS):
        oj = cj.couple({n: jnp.asarray(seq[k, n]) for n in SHEETS})
        ot = ct.couple({n: torch.as_tensor(seq[k, n]) for n in SHEETS})
        steps.append((oj, ot))
    return cj, ct, steps


@pytest.mark.parametrize("sheet", SHEETS)
def test_outputs_and_state_match_reference(runs, sheet):
    cj, ct, steps = runs
    for k, (oj, ot) in enumerate(steps):
        for key in ("fI", "fE_out", "fA_out"):
            close(ot[sheet][key].numpy(), oj[sheet][key], FIELD_TOL,
                  f"{sheet} {key} step {k}")
        assert (ot[sheet]["E1vE0"] is None) == (oj[sheet]["E1vE0"] is None)
    assert steps[REGEN - 1][1][sheet]["E1vE0"] is not None
    sj, st = cj.sheets[sheet].state, ct.sheets[sheet].state
    close(st.H.numpy().ravel(), np.ravel(sj.H), FIELD_TOL, f"{sheet} H")
    close(st.enth.numpy().ravel(), np.ravel(sj.enth), FIELD_TOL,
          f"{sheet} enth")


@pytest.mark.parametrize("key", port.IceSheetCoupler.STAT_KEYS)
def test_ledger_rows_match_reference(runs, key):
    cj, ct, _ = runs
    rj, rt = cj.ledger.to_rows(), ct.ledger.to_rows()
    assert len(rj) == len(rt) == N_STEPS
    for k, (a, b) in enumerate(zip(rt, rj)):
        assert a["t"] == b["t"]
        for sheet in SHEETS:
            got, want = a[f"{sheet}.{key}"], b[f"{sheet}.{key}"]
            scale = abs(want)
            if key in _DERIVED:
                scale = abs(b[f"{sheet}.{_DERIVED[key]}"])
            assert abs(got - want) <= LEDGER_TOL * scale, (sheet, k, got,
                                                           want)


def test_port_transport_identity_per_sheet(runs):
    _, ct, _ = runs
    rows = ct.ledger.to_rows()
    assert len(rows) == N_STEPS
    for r in rows:
        for sheet in SHEETS:
            for book in ("mass", "energy"):
                a = r[f"{sheet}.{book}_in_E"]
                b = r[f"{sheet}.{book}_delivered_I"]
                if book == "mass":
                    assert abs(a) > 0
                assert abs(a - b) <= 1e-10 * abs(a), (sheet, book, a, b)
