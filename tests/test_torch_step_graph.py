"""The compiled coupling step on the CPU: the SIA at a fixed substep budget
(``advance(..., substeps=s)``) against the early-exit loop, and the
coupler's budget loop (``IceSheetCoupler`` on a fusible sheet: the code
that replays CUDA graphs on the card runs the budgeted step eagerly here)
against the eager early-exit coupler and against the JAX reference.

Tolerances, with their reasons:
* budget against early exit, on the SIA and on the coupler: bit for bit
  (``torch.equal``; ledger rows ``==``).  A substep the budget runs past the
  early exit's last is gated out by ``torch.where(active, new, old)``,
  which is ``old`` bit for bit, and the substeps that do run are the same
  operations in the same order.
* budget loop against the JAX reference coupler: the parity tolerances
  of tests/test_torch_coupler.py (fields and state 1e-5 of each row's
  scale, ledger rows 1e-6 of the row or of their book's store).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebin_tpu_torch as port
from icebin_tpu_torch.models import ice_sheet as sia
from icebin_tpu_torch.ops.apply import small_geometry

from test_torch_coupler import (_DERIVED, CPU, FIELD_TOL, HCDEFS,
                                LEDGER_TOL, close, forcing_np, make_ref,
                                toy_specs)

# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch from contending with the other workers for the cores
torch.set_num_threads(1)

YEAR = 365.2425 * 86400.0
DAY = 86400.0


# -- section 1: the SIA at a fixed budget -----------------------------------

def sia_case(name):
    """(cfg, state, smb, tsurf, enth_flux, dt) of one SIA case, seeded."""
    calv = 400.0 if name == "tsurf_calving" else 0.0
    if name == "cfl_bound":
        # 10 km cells: the dome's CFL step is 2-3 months, well under a
        # year, and dt_max is lifted so the CFL alone sets the substeps
        cfg = sia.IceSheetConfig(nx=40, ny=40, dx=10e3, dy=10e3,
                                 dt_max=1e9, calv_thk=400.0)
        dt = YEAR
    else:
        cfg = sia.IceSheetConfig(nx=48, ny=48, dx=20e3, dy=20e3,
                                 calv_thk=calv)
        dt = 30.0 * DAY
    st = sia.init_state(cfg, device=CPU, dome_height=2500.0)
    rng = np.random.default_rng(3)
    n = cfg.nx * cfg.ny
    y, x = np.meshgrid(np.arange(cfg.ny), np.arange(cfg.nx), indexing="ij")
    r = (np.hypot(x - (cfg.nx - 1) / 2, y - (cfg.ny - 1) / 2)
         / (cfg.nx / 2)).reshape(-1)
    smb = ((0.3 - 0.6 * r) / YEAR * sia.RHO_ICE
           + 1e-6 * rng.uniform(-1, 1, n))
    tsurf = 262.0 + 16.0 * r + rng.uniform(-1, 1, n)
    enth = 0.06 + 2.0 * rng.uniform(0, 1, n)
    if name == "no_forcing":
        smb, tsurf, enth = np.zeros(n), None, None
    elif name == "tsurf_calving":
        enth = None
    elif name == "enth_flux":
        tsurf = None

    def t(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.float32)

    return cfg, st, t(smb), t(tsurf), t(enth), dt


def same_step(a, b, what):
    (sa, fa), (sb, fb) = a, b
    for k in ("H", "enth", "t"):
        assert torch.equal(getattr(sa, k), getattr(sb, k)), f"{what}: {k}"
    for k in sia.IceFluxes._fields:
        assert torch.equal(getattr(fa, k), getattr(fb, k)), f"{what}: {k}"


def substeps_needed(cfg, st, smb, ts, ef, dt):
    """The early exit's substep count: the budget's active count at
    ``n_substeps_max`` when that budget is not short."""
    *_, short, n = sia.advance(cfg, st, smb, ts, dt, ef,
                               substeps=cfg.n_substeps_max)
    assert not bool(short)
    return int(n)


SIA_CASES = ("no_forcing", "tsurf_calving", "enth_flux", "cfl_bound")


@pytest.mark.parametrize("budget", ["needed", "needed+3", "max"])
@pytest.mark.parametrize("case", SIA_CASES)
def test_budgeted_advance_is_the_early_exit(case, budget):
    cfg, st, smb, ts, ef, dt = sia_case(case)
    n = substeps_needed(cfg, st, smb, ts, ef, dt)
    if case == "cfl_bound":
        assert n >= 4, n            # the CFL binds: several substeps
    s = {"needed": n, "needed+3": n + 3, "max": cfg.n_substeps_max}[budget]
    want = sia.advance(cfg, st, smb, ts, dt, ef)
    st1, fx, short, active = sia.advance(cfg, st, smb, ts, dt, ef,
                                         substeps=s)
    same_step((st1, fx), want, f"{case} at {s} substeps")
    assert short.dtype == torch.bool and not bool(short)
    assert active.dtype == torch.int32 and int(active) == n


@pytest.mark.parametrize("case", SIA_CASES)
def test_short_budget_flags_and_stops_where_the_cap_would(case):
    """A budget below the count needed: short, every substep active, and
    bit for bit the early exit capped at that many substeps."""
    cfg, st, smb, ts, ef, dt = sia_case(case)
    n = substeps_needed(cfg, st, smb, ts, ef, dt)
    if n == 1:                  # one substep covers dt: no short budget
        cfg = dataclasses.replace(cfg, dt_max=dt / 3)
        n = substeps_needed(cfg, st, smb, ts, ef, dt)
    s = n - 1
    capped = dataclasses.replace(cfg, n_substeps_max=s)
    st1, fx, short, active = sia.advance(capped, st, smb, ts, dt, ef,
                                         substeps=s)
    same_step((st1, fx), sia.advance(capped, st, smb, ts, dt, ef),
              f"{case} short at {s}")
    assert bool(short) and int(active) == s
    with pytest.raises(ValueError):
        sia.advance(cfg, st, smb, ts, dt, ef,
                    substeps=cfg.n_substeps_max + 1)


# -- section 2: the coupler's budget loop ---------------------------------

#: the CFL-bound coupler toy: 25 km cells, whose dome's CFL step is ~860
#: days, under a 5-year coupling step with dt_max lifted: 3 substeps
CFL_DT = 5.0 * YEAR
CFL_DT_MAX = 10.0 * YEAR
N_STEPS = 7
REGEN = 3


def cfl_port(dt=CFL_DT, sheet_cls=port.IceSheetCoupler, **kw):
    specA, specI = toy_specs()
    gr = port.GCMRegridder(specA, hcdefs=HCDEFS, device=CPU)
    gr.add_sheet("toy", specI, subdiv=1)
    cfg = port.CouplerConfig(dt=dt, regen_every=REGEN, **kw)
    cp = port.GCMCoupler(gr, cfg, device=CPU,
                         sheets={"toy": sheet_cls(gr, "toy", cfg,
                                                  device=CPU)})
    sc = cp.sheets["toy"]
    sc.ice_cfg = dataclasses.replace(sc.ice_cfg, dt_max=CFL_DT_MAX)
    sc.set_held_state(np.random.default_rng(7).uniform(0.5, 2.0,
                                                       (2, gr.nE)))
    return cp


def early_exit(cp):
    """``cp`` on the eager step: a plain wrapper of the SIA step is not
    fusible, so ``couple`` runs ``_couple_core`` with the early exit."""
    def ice(*a):
        return sia.step_coupled(*a)
    cp.sheets["toy"].ice_step = ice
    return cp


def forcing(cp):
    return lambda t, sheet: torch.as_tensor(forcing_np(t, cp.gr.nE))


def same_outputs(a, b, what):
    for key in ("fI", "fE_out", "fA_out"):
        assert torch.equal(a[key].nan_to_num(), b[key].nan_to_num()), \
            f"{what}: {key}"
        assert torch.equal(a[key].isnan(), b[key].isnan()), f"{what}: {key}"


def same_state(a, b):
    for k in ("H", "enth", "t"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_budget_loop_is_the_early_exit_coupler(fused):
    """From a budget of 1 the loop reruns (1 -> 2 -> 4, then starts at 3,
    the count seen) and is bit for bit the eager early-exit coupler: every
    step's outputs (stepwise) or each window's last (fused), the state and
    every ledger row, across two regenerations."""
    a = cfl_port()
    b = early_exit(cfl_port())
    sc = a.sheets["toy"]
    assert sc._fusible() and not b.sheets["toy"]._fusible()
    assert sc.budget == 1
    if fused:
        oa = a.run_transient(forcing(a), N_STEPS, fused=True)["toy"]
        ob = b.run_transient(forcing(b), N_STEPS)["toy"]
        same_outputs(oa, ob, "last step")
    else:
        for k in range(N_STEPS):
            f = torch.as_tensor(forcing_np(a.time, a.gr.nE))
            oa = a.couple({"toy": f})["toy"]
            ob = b.couple({"toy": f})["toy"]
            same_outputs(oa, ob, f"step {k}")
    assert sc.reruns >= 2 and sc.budget == 3
    assert sc.replays == 0              # no card here: the eager form ran
    same_state(sc.state, b.sheets["toy"].state)
    rows = a.ledger.to_rows()
    assert len(rows) == N_STEPS and rows == b.ledger.to_rows()
    assert sum("toy.held_mass" in r for r in rows) == N_STEPS // REGEN


#: the reference parity runs a 3-year step (2 substeps, so one rerun from
#: a budget of 1): at 5 years the harvested column specific enthalpy (the
#: last output row, U / (rho H)) of the two f32 models parts by more than
#: the parity tolerance after 4-5 steps, in the eager port as in the
#: compiled one (they are the same bits)
REF_DT = 3.0 * YEAR


def test_budget_loop_matches_the_reference():
    """The budget loop on the CFL-bound toy, stepwise over 6 steps with a
    regeneration every 3, against the JAX reference coupler with the same
    ice config: the parity tolerances of test_torch_coupler.py."""
    cj, ct = make_ref(), cfl_port(dt=REF_DT)
    cj.cfg = dataclasses.replace(cj.cfg, dt=REF_DT)
    for sc in cj.sheets.values():
        sc.cfg = cj.cfg
        sc.ice_cfg = dataclasses.replace(sc.ice_cfg, dt_max=CFL_DT_MAX)
        sc.set_held_state(ct.sheets["toy"].held_E.copy())
    for k in range(6):
        f = forcing_np(cj.time, cj.gr.nE)
        oj = cj.couple({"toy": jnp.asarray(f)})["toy"]
        ot = ct.couple({"toy": torch.as_tensor(f)})["toy"]
        for key in ("fI", "fE_out", "fA_out"):
            close(ot[key].numpy(), oj[key], FIELD_TOL, f"{key} step {k}")
    assert ct.sheets["toy"].reruns >= 1
    sj, st = cj.sheets["toy"].state, ct.sheets["toy"].state
    close(st.H.numpy().ravel(), np.ravel(sj.H), FIELD_TOL, "H")
    close(st.enth.numpy().ravel(), np.ravel(sj.enth), FIELD_TOL, "enth")
    for a, b in zip(ct.ledger.to_rows(), cj.ledger.to_rows()):
        assert a["t"] == b["t"]
        for key in port.IceSheetCoupler.STAT_KEYS:
            got, want = a[f"toy.{key}"], b[f"toy.{key}"]
            scale = abs(b[f"toy.{_DERIVED.get(key, key)}"])
            assert abs(got - want) <= LEDGER_TOL * scale, (key, got, want)


def test_outputs_survive_the_next_step():
    """What step k returned (fields, state) and the ledger row it booked
    are unchanged by step k+1: nothing a caller keeps aliases the step's
    static buffers, which the next run overwrites."""
    cp = cfl_port()
    sc = cp.sheets["toy"]
    f = [torch.as_tensor(forcing_np(k * CFL_DT, cp.gr.nE)) for k in range(2)]
    cp.couple({"toy": f[0]})                 # settles the budget
    out = cp.couple({"toy": f[1]})["toy"]
    kept = {k: out[k].clone() for k in ("fI", "fE_out", "fA_out")}
    state = sc.state
    held = {k: getattr(state, k).clone() for k in ("H", "bed", "t", "enth")}
    row = cp.ledger.to_rows()[-1]
    row0 = dict(row)
    cp.couple({"toy": f[0]})
    for k, v in kept.items():
        assert torch.equal(out[k].nan_to_num(), v.nan_to_num()), k
    for k, v in held.items():
        assert torch.equal(getattr(state, k), v), k
    assert row == row0 and cp.ledger.to_rows()[-2] == row0
    assert not torch.equal(sc.state.H, state.H)   # the step did move on


# -- section 3: the graphs kept across regenerations -----------------------

class FreshGraphs(port.IceSheetCoupler):
    """A sheet whose every regeneration leaves its graphs to be captured
    again, as each generation was before the graphs were kept: the oracle
    of the kept graphs."""

    def _rebind_graphs(self):
        self._stale.update(self._graphs)


def counted_captures(sc):
    """Count ``sc``'s captures (on the CPU ``capture_ms`` stays empty: no
    graph is captured there) in ``sc.captures``."""
    capture = sc._capture
    sc.captures = 0

    def counted(*a):
        sc.captures += 1
        return capture(*a)

    sc._capture = counted
    return sc


def kept_and_fresh(dt=CFL_DT):
    """Two CFL-bound toys, one with kept graphs, one recapturing at every
    regeneration (``FreshGraphs``), each counting its captures."""
    out = []
    for cls in (port.IceSheetCoupler, FreshGraphs):
        cp = cfl_port(dt=dt, sheet_cls=cls)
        counted_captures(cp.sheets["toy"])
        out.append(cp)
    return out


def scaled_smb(cp, scale):
    """The toy's forcing with its smb row ``scale`` times its size: > 0
    grows the ice (the dome thickens and flows out), < 0 thins it off its
    margins."""
    def fn(t, sheet):
        f = forcing_np(t, cp.gr.nE)
        f[0] = scale * np.abs(f[0])
        return torch.as_tensor(f)
    return fn


#: the smb scale of each window: 3 growing the ice, 4 shrinking it
GROW_SHRINK = (20.0, 20.0, 20.0, -12.0, -12.0, -12.0, -12.0)


def test_kept_graph_is_a_fresh_capture():
    """A fused run of 7 windows, each ending in a regeneration, whose ice
    grows and then shrinks (the hot matrices' live rows and entries move
    both ways, AvI's dest-small warps with them): the sheet that keeps its
    graphs across regenerations is bit for bit the one that captures them
    again every generation (every window's outputs, the state, every
    ledger row); each of its regenerations but the first build rebinds,
    and it captures once a budget."""
    a, b = kept_and_fresh()
    sa, sb = a.sheets["toy"], b.sheets["toy"]
    seen = []
    for scale in GROW_SHRINK:
        oa = a.run_transient(scaled_smb(a, scale), REGEN, fused=True)
        ob = b.run_transient(scaled_smb(b, scale), REGEN, fused=True)
        same_outputs(oa["toy"], ob["toy"], f"smb x {scale}")
        same_state(sa.state, sb.state)
        seen.append(tuple((sa.mat(n).pack.small.n_live,
                           sa.mat(n).pack.small.vals.numel(),
                           small_geometry(sa.mat(n).pack.small, 10)[0])
                          for n in ("EvI", "AvI")))
    assert a.ledger.to_rows() == b.ledger.to_rows()
    assert np.array_equal(sa.held_E, sb.held_E)
    for i in range(2):                 # live rows and entries: up, then down
        for j in range(2):
            track = [s[i][j] for s in seen]
            assert max(track) > track[0] and track[-1] < max(track), track
    assert len({s[1][2] for s in seen}) > 1, seen     # AvI's warps moved
    regens = len(GROW_SHRINK)
    assert sa.regens_device == sb.regens_device == regens + 1
    assert sa.rebinds == regens and sb.rebinds == 0
    assert sa.captures == len(sa._graphs) and not sa._stale
    assert sb.captures > sa.captures and sa.budget == sb.budget > 1


def test_kept_graph_recaptures_when_live_rows_vanish():
    """A generation with no ice (no live row in EvI or AvI: the dest-small
    apply launches nothing) and the next, with ice again, change what the
    step launches, so each captures the graph again; the generations
    between rebind.  Bit for bit the sheet that recaptures every
    generation."""
    a, b = kept_and_fresh(dt=30.0 * DAY)
    sa, sb = a.sheets["toy"], b.sheets["toy"]
    bare = np.full(sa.gr.sheets["toy"].specI.ncells, np.nan)
    for k in range(6):
        for cp in (a, b):
            out = cp.run_transient(forcing(cp), REGEN, fused=True)["toy"]
            if k == 2:
                cp.sheets["toy"].regen_matrices(elevmask=bare)
            cp.last = out
        same_outputs(a.last, b.last, f"window {k}")
        same_state(sa.state, sb.state)
    assert a.ledger.to_rows() == b.ledger.to_rows()
    assert sa.budget == 1
    # captures: the first, the bare generation's, the one after it
    assert sa.captures == 3 and sb.captures == 6
    assert sa.regens_device == 8 and sa.rebinds == 8 - 1 - 2
