"""The port's coupled slice as a whole (icebin_tpu_torch.GCMCoupler) vs the
reference (icebin_tpu.coupler.coupler.GCMCoupler) on the toy of
tests/test_coupler.py: the same grids, the same seeded forcing, 6 steps with
a regeneration every 3 (so one E1vE0 remap of GCM-held state happens).

Tolerances, with their reasons:
* fields (fI, fE_out, fA_out) and the ice state (H, enth): 1e-5 of each
  row's scale.  The port's exchange grid comes from its f32 clip (the
  reference's toy uses the f64 host clip), its applies sum in f64 over f32
  values where the reference's XLA engine sums f64 matrices, and the f32
  ice model amplifies single-ulp differences over its CFL substeps.
* ledger rows: 1e-6 relative to the row.  The residual and clamp rows are
  differences of f32 state sums: their size is the f32 quantum of the
  store, so they are held to 1e-6 of their book's store (ice_mass,
  energy_storage_I) instead.
* the port's own transport identity |mass_in_E - mass_delivered_I|:
  < 1e-10 relative, the north-star bound.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icebin_tpu.coupler import coupler as ref_coupler
from icebin_tpu.grid import proj as ref_proj, spec as ref_spec
from icebin_tpu.models.ice_sheet import IceSheetState as RefState
from icebin_tpu.regrid.gcmregridder import GCMRegridder as RefRegridder

import icebin_tpu_torch as port
from icebin_tpu_torch.grid import proj as port_proj, spec as port_spec
from icebin_tpu_torch.convert import state_from_reference, state_to_arrays

# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch from contending with the other workers for the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
FIELD_TOL = 1e-5
LEDGER_TOL = 1e-6
HCDEFS = [0.0, 500.0, 1000.0, 2000.0, 3000.0]
SCALE = 25e3
N_STEPS = 6
REGEN = 3


def toy_specs(spec=port_spec, proj=port_proj, n_ice=40):
    """tests/test_coupler.py make_coupler's metric toy: PlateCarree scaled
    to ~25 km/deg so the ice plane, the matrix measure and the SIA model
    share one metre-based geometry.  ``spec``/``proj`` are the grid modules
    of the package that gets the grids (each side builds its own classes
    from the same numbers)."""
    specA = spec.GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                                latb=np.linspace(30.0, 80.0, 7))
    specI = spec.GridSpecXY(
        xb=np.linspace(0.0, 40.0 * SCALE, n_ice + 1),
        yb=np.linspace(30.0 * SCALE, 80.0 * SCALE, n_ice + 1),
        projection=proj.PlateCarree(scale=SCALE))
    return specA, specI


def make_ref(regen_every=REGEN):
    specA, specI = toy_specs(ref_spec, ref_proj)
    gr = RefRegridder(specA, hcdefs=HCDEFS)
    gr.add_sheet("toy", specI, subdiv=1, engine="numpy")
    cfg = ref_coupler.CouplerConfig(dt=86400.0 * 30, regen_every=regen_every)
    return ref_coupler.GCMCoupler(gr, cfg)


def make_port(regen_every=REGEN, **kw):
    specA, specI = toy_specs()
    gr = port.GCMRegridder(specA, hcdefs=HCDEFS, device=CPU)
    gr.add_sheet("toy", specI, subdiv=1)
    cfg = port.CouplerConfig(dt=86400.0 * 30, regen_every=regen_every, **kw)
    return port.GCMCoupler(gr, cfg, device=CPU)


def forcing_np(t, nE):
    """tests/test_coupler.py's forcing (GCM units: tsurf in degC), f32."""
    rng = np.random.default_rng(int(t) % 100003)
    f = np.zeros((8, nE))
    f[0] = 1e-5 * rng.uniform(0.5, 1.0, nE)      # smb kg m-2 s-1
    f[1] = 5.0
    f[3] = 2.0
    f[4] = -10.0                                  # degC
    f[6] = 2e-6 * rng.uniform(0.0, 1.0, nE)      # rain kg m-2 s-1
    return f.astype(np.float32)


def close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    ok = np.isfinite(want)
    if got.ndim == 2:                  # per-row scale: rows carry units
        scale = np.max(np.where(ok, np.abs(want), 0.0), axis=1,
                       keepdims=True)
    else:
        scale = np.max(np.abs(want[ok]), initial=0.0)
    scale = np.broadcast_to(np.maximum(scale, 1e-300), want.shape)
    err = np.max(np.abs(got - want)[ok] / scale[ok], initial=0.0)
    assert err < tol, f"{what}: {err:.3e} >= {tol:.0e}"


@pytest.fixture(scope="module")
def runs():
    """Both packages driven stepwise through the same 6 steps, with held
    GCM state remapped at the regeneration."""
    cj, ct = make_ref(), make_port()
    held = np.random.default_rng(7).uniform(0.5, 2.0, (2, cj.gr.nE))
    cj.sheets["toy"].set_held_state(held)
    ct.sheets["toy"].set_held_state(held)
    steps = []
    for _ in range(N_STEPS):
        f = forcing_np(cj.time, cj.gr.nE)
        oj = cj.couple({"toy": jnp.asarray(f)})["toy"]
        ot = ct.couple({"toy": torch.as_tensor(f)})["toy"]
        steps.append((oj, ot))
    return cj, ct, steps


def test_outputs_match_reference(runs):
    _, _, steps = runs
    for k, (oj, ot) in enumerate(steps):
        for key in ("fI", "fE_out", "fA_out"):
            close(ot[key].numpy(), oj[key], FIELD_TOL, f"{key} step {k}")
        assert (ot["E1vE0"] is None) == (oj["E1vE0"] is None)
    assert steps[REGEN - 1][1]["E1vE0"] is not None


def test_state_matches_reference(runs):
    cj, ct, _ = runs
    sj, st = cj.sheets["toy"].state, ct.sheets["toy"].state
    # one scale per lattice field (flattened), not per lattice row
    close(st.H.numpy().ravel(), np.ravel(sj.H), FIELD_TOL, "H")
    close(st.enth.numpy().ravel(), np.ravel(sj.enth), FIELD_TOL, "enth")
    assert float(st.t) == float(sj.t) == N_STEPS * 86400.0 * 30
    # held GCM state after the E1vE0 remap
    close(ct.sheets["toy"].held_E, cj.sheets["toy"].held_E, FIELD_TOL,
          "held_E")


#: ledger rows that are differences of f32 state sums, held to the scale
#: of their book's store instead of to themselves
_DERIVED = {"mass_residual": "ice_mass", "mass_clamp_I": "ice_mass",
            "energy_residual": "energy_storage_I",
            "energy_clamp_I": "energy_storage_I"}


@pytest.mark.parametrize("key", port.IceSheetCoupler.STAT_KEYS)
def test_ledger_rows_match_reference(runs, key):
    cj, ct, _ = runs
    rj, rt = cj.ledger.to_rows(), ct.ledger.to_rows()
    assert len(rj) == len(rt) == N_STEPS
    for k, (a, b) in enumerate(zip(rt, rj)):
        assert a["t"] == b["t"]
        got, want = a[f"toy.{key}"], b[f"toy.{key}"]
        scale = abs(want)
        if key in _DERIVED:
            scale = abs(b[f"toy.{_DERIVED[key]}"])
        assert abs(got - want) <= LEDGER_TOL * scale, (k, got, want)
    # the regeneration's held-state rows
    for name in ("held_mass", "held_mass_dropped", "held_mass_gained"):
        got = rt[REGEN - 1][f"toy.{name}"]
        want = rj[REGEN - 1][f"toy.{name}"]
        assert abs(got - want) <= LEDGER_TOL * rj[REGEN - 1]["toy.held_mass"]


def test_port_transport_identity(runs):
    _, ct, _ = runs
    for r in ct.ledger.to_rows():
        m_in, m_del = r["toy.mass_in_E"], r["toy.mass_delivered_I"]
        assert abs(m_in - m_del) < 1e-10 * abs(m_in)
        e_in, e_del = r["toy.energy_in_E"], r["toy.energy_delivered_I"]
        assert abs(e_in - e_del) < 1e-10 * abs(e_in)


def test_fused_matches_stepwise():
    """run_transient(fused=True) runs each regeneration window through
    couple_window; the books, the state and the last outputs are the same
    as the stepwise loop's (same operations, same order: bit-identical)."""
    a, b = make_port(), make_port()
    nE = a.gr.nE

    def fn(t, sheet):
        return torch.as_tensor(forcing_np(t, nE))

    oa = a.run_transient(fn, N_STEPS + 1)["toy"]
    ob = b.run_transient(fn, N_STEPS + 1, fused=True)["toy"]
    ra, rb = a.ledger.to_rows(), b.ledger.to_rows()
    assert ra == rb
    assert torch.equal(a.sheets["toy"].state.H, b.sheets["toy"].state.H)
    assert torch.equal(a.sheets["toy"].state.enth,
                       b.sheets["toy"].state.enth)
    for key in ("fI", "fE_out", "fA_out"):
        assert torch.equal(oa[key].nan_to_num(), ob[key].nan_to_num())
    assert a.sheets["toy"].steps_since_regen == 1
    assert b.sheets["toy"].steps_since_regen == 1


def test_convert_round_trip(runs):
    """Port state -> reference arrays -> reference state -> port state is
    exact, and a converted state steps like the reference's."""
    cj, ct, _ = runs
    st = ct.sheets["toy"].state
    ref_state = RefState(**{k: jnp.asarray(v)
                            for k, v in state_to_arrays(st).items()})
    back = state_from_reference(ref_state, device=CPU)
    for k in ("H", "bed", "t", "enth"):
        assert torch.equal(getattr(back, k), getattr(st, k)), k
    assert back.t.dtype == torch.float64
    # the reference's evolved state, carried into the port
    moved = state_from_reference(cj.sheets["toy"].state, device=CPU)
    np.testing.assert_array_equal(moved.H.numpy(),
                                  np.asarray(cj.sheets["toy"].state.H))
