"""How ``correct`` is decided: every sampled period of the window run again
by the plain reference (``bench_torch/reference``) from the program's own
start state of that period, on the same forcing and held state, and the
program's results held against the reference's, number by number, each
against the cell's limit (``bench_torch/limits/<cell>.json``).  The window's
first period is always sampled, and its start state and held state are
also held against the reference's own, carried from the cell's initial
state through the warm-up: a state or held state lost, reset or left stale
at a period boundary, or at a regeneration, shows there.

The numbers (each the largest over the sampled periods, steps and sheets):

* ``transport``: the program's own transport identity over every ledger
  row of the window, max |in_E - delivered_I| / |in_E|, mass and energy
  (the configurations state < 1e-10).
* ``ledger``: every ledger entry of the sampled steps but the two residual
  rows, |program - reference| / max(|reference|, |reference in_E| of its
  book); the held-state rows against the held mass.
* ``forcing``: fI, the IvE transport after its repair; ``harvest``: fE_out
  and fA_out (in ModelE's layout in the ABI cell); ``state``: H and the
  column enthalpy after the period; ``held``: the held state after E1vE0;
  the start state and held state of the window's first period against
  the reference's carried ones count in ``state`` and ``held`` too;
  ``topo``: fhc, elevE and underice (the ABI cell's buffers, or each
  sheet's after a regeneration).  Each a weighted relative L1 gap per
  field row, sum w |p - r| / sum w |r|, w the reference's destination
  weights (cells outside the matrices weigh nothing; NaN against a number
  where w > 0 is an infinite gap).

Two of those denominators fall toward 0 when a sheet's last cold ice
reaches the melting point while the ice stays: the sum of the enthalpy U
after the period, and the harvest's column specific enthalpy row; the f32
rounding both sides carry stays the size of what the period moved.  As
``ledger`` takes max(|r|, |in_E|), they are floored by quantities of the
reference alone: ``state``'s sums of H and U by the mass and the energy
the period put in (over the cell area), the specific enthalpy row by one
step's energy input over the ice's mass (``harvest_floor``).  Where the
sums hold their size, the floors lie far below them and change nothing.

The two residual rows are defined to absorb the f32 rounding of the state
update (they hold the books exactly); two sound runs whose states differ
by a rounding differ there as much as the control does, so they are not
compared: the sums they are made of are.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from reference import coupler as rc
from reference import grid as rg
from reference import ice as ri
from reference.prec import REFERENCE

from . import common, drivers, gcm, system

RESIDUALS = ("mass_residual", "energy_residual")
HELD_KEYS = ("held_mass", "held_mass_dropped", "held_mass_gained")


def reference_sheets(cfg, grid: gcm.Grid, device, prec,
                     res_km=None) -> List[rc.Sheet]:
    out = []
    for s in cfg["sheets"]:
        nx, ny, _ = system.lattice_shape(s, res_km)
        xb = np.linspace(s["x0"], s["x1"], nx + 1)
        yb = np.linspace(s["y0"], s["y1"], ny + 1)
        lat = rg.Lattice(torch.tensor(xb, device=device),
                         torch.tensor(yb, device=device),
                         rg.parse_proj(s["proj"]))
        xg = grid.exchange(s, lat, device, prec)
        dx, dy = float(np.diff(xb).mean()), float(np.diff(yb).mean())
        out.append(rc.Sheet(s["name"], xg, ri.IceParams(dx=dx, dy=dy), nx,
                            ny, dx * dy))
    return out


def initial_state(sh: rc.Sheet, device) -> rc.SheetState:
    H = ri.vialov(sh.nx, sh.ny, device)
    return rc.SheetState(H, ri.cold_enthalpy(H), torch.zeros_like(H))


def wgap(p, r, w, floor=0.0) -> float:
    """max over rows of sum w |p - r| / max(sum w |r|, floor) (module
    docstring); ``floor`` a number or one a row."""
    p = torch.as_tensor(p).to(torch.float64)
    r = torch.as_tensor(r, device=p.device).to(torch.float64)
    w = torch.as_tensor(w, device=p.device).to(torch.float64)
    if p.dim() == 1:
        p, r = p[None], r[None]
    nan_p, nan_r = torch.isnan(p), torch.isnan(r)
    d = torch.where(nan_p & nan_r, 0.0,
                    torch.where(nan_p | nan_r, torch.inf, (p - r).abs()))
    use = (w > 0)[None, :].expand_as(d)
    num = torch.where(use, d * w, 0.0).sum(-1)
    den = torch.where(use & ~nan_r, r.abs() * w, 0.0).sum(-1)
    den = torch.maximum(den, torch.as_tensor(floor, dtype=torch.float64,
                                             device=p.device))
    g = torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                    torch.where(num > 0, torch.inf, 0.0))
    return float(g.max())


def transport(rows, sheets) -> float:
    worst = 0.0
    for r in rows:
        for s in sheets:
            for book in ("mass", "energy"):
                a, b = r[f"{s}.{book}_in_E"], r[f"{s}.{book}_delivered_I"]
                worst = max(worst, abs(a - b) / abs(a) if a else np.inf)
    return worst


def harvest_floor(ind, W):
    """(10,) floors of a harvest's rows (``reference.coupler.step``'s
    layout).  The column specific enthalpy (row 9) falls to 0 as the last
    cold ice reaches the melting point while the ice stays, and is floored
    by what one step's energy input (``ind``, the reference's ledger
    entries of the step) makes of it spread over the ice's mass, times the
    matrix's total weight ``W``.  No other row falls so: runoff and rain
    stay while rain falls, the rest read 0 on both sides or hold their
    size."""
    f = [0.0] * 10
    if ind["ice_mass"] > 0:
        f[9] = abs(ind["energy_in_E"]) * W / ind["ice_mass"]
    return f


def numbers(rec, out: rc.PeriodOut, sheets: List[rc.Sheet], nA, nhc, abi):
    """The gaps of one sampled period ``rec`` (the program's, or the
    control's as a record) against the reference's ``out``, and the
    ledger entry that sets its gap."""
    g = dict(ledger=0.0, forcing=0.0, harvest=0.0, state=0.0)
    worst = ""
    K = len(out.stats)
    names = [s.name for s in sheets]
    ind = [{s: dict(zip(rc.STAT_KEYS, out.stats[i][s].double().cpu()
                        .tolist())) for s in names} for i in range(K)]
    for i in range(K):
        for s in names:
            for k, r in ind[i][s].items():
                if k in RESIDUALS:
                    continue
                book = ind[i][s]["mass_in_E" if k.startswith("mass")
                                 else "energy_in_E"]
                p = rec.rows[i][f"{s}.{k}"]
                gap = abs(p - r) / max(abs(r), abs(book), 1e-300)
                if gap > g["ledger"]:
                    g["ledger"], worst = gap, f"{s}.{k} at step {i}"
    for s, (f1, hm, dr, ga) in out.held.items():
        ref = dict(zip(HELD_KEYS, (float(hm), float(dr), float(ga))))
        for k, r in ref.items():
            p = rec.rows[-1][f"{s}.{k}"]
            gap = abs(p - r) / max(abs(ref["held_mass"]), 1e-300)
            if gap > g["ledger"]:
                g["ledger"], worst = gap, f"{s}.{k}"
    steps = range(K) if len(rec.fields) == K else [K - 1]
    for j, i in enumerate(steps):
        for s in names:
            m = out.ref_mats[s]
            fI, fE, fA = out.fields[i][s]
            pf = rec.fields[j][s]
            g["forcing"] = max(g["forcing"], wgap(pf["fI"], fI, m.EvI.Mw))
            g["harvest"] = max(
                g["harvest"],
                wgap(pf["fE_out"], fE, m.EvI.wM,
                     harvest_floor(ind[i][s], float(m.EvI.wM.sum()))),
                wgap(pf["fA_out"], fA, m.AvI.wM,
                     harvest_floor(ind[i][s], float(m.AvI.wM.sum()))))
    dev = out.states[names[0]].H.device
    for sh in sheets:
        s = sh.name
        H, U = (x.to(dev).reshape(-1) for x in rec.after[s][:2])
        S = out.states[s]
        ones = torch.ones(S.H.numel(), device=dev)
        # the floors of the module docstring
        fH = sum(abs(x[s]["mass_in_E"]) for x in ind) / (ri.RHO
                                                        * sh.cell_area)
        fU = sum(abs(x[s]["energy_in_E"]) for x in ind) / sh.cell_area
        g["state"] = max(g["state"], wgap(H, S.H.reshape(-1), ones, fH),
                         wgap(U, S.U.reshape(-1), ones, fU))
    if out.held:
        g["held"] = max(wgap(rec.held1[s], out.held[s][0],
                             out.mats[s].ec_w) for s in out.held)
    if abi:
        g["topo"] = max(topo_gap(rec.topo[i], out.topo[i], nA, nhc)
                        for i in range(K))
    elif rec.fhc:
        g["topo"] = max(
            max(wgap(flat(rec.fhc[s][0]), flat(out.mats[s].fhc),
                     torch.ones(nA * nhc, device=dev)),
                wgap(flat(rec.fhc[s][1]), flat(out.mats[s].elevE),
                     flat(out.mats[s].fhc)))
            for s in rec.fhc)
    return g, worst


def flat(x):
    return torch.as_tensor(x).reshape(-1)


def topo_gap(bufs, ref, nA, nhc) -> float:
    """The TOPO buffers a GCM gets ((nhc nA,) each, ModelE layout, elevE 0
    where no class) against the reference's (fhc, elevE, underice)."""
    fhc_r, elev_r, under_r = ref
    dev = fhc_r.device
    fhc, elev, under = (torch.as_tensor(b, device=dev).reshape(nhc, nA)
                        for b in bufs)
    w = fhc_r.reshape(-1)
    ones = torch.ones_like(w)
    mism = (under.reshape(-1) != under_r.reshape(-1)).to(torch.float64)
    return max(wgap(fhc.reshape(-1), fhc_r.reshape(-1), ones),
               wgap(elev.reshape(-1),
                    torch.nan_to_num(elev_r, nan=0.0).reshape(-1), w),
               float((w * mism).sum() / w.sum().clamp(min=1e-300)))


@dataclasses.dataclass
class Inputs:
    """What a period of a cell needs besides its start state."""

    sheets: List[rc.Sheet]
    F: List[torch.Tensor]
    hcdefs: torch.Tensor
    dt: float
    K: int
    regen_every: int


def inputs(cfg, traffic, seed, device, prec, grid: gcm.Grid,
           res_km=None) -> Inputs:
    sheets = reference_sheets(cfg, grid, device, prec, res_km)
    nE = sheets[0].xg.nA * len(cfg["hcdefs"])
    F = [torch.as_tensor(f, device=device) for f in
         common.year_of_forcing(nE, seed, int(traffic["months"]))]
    return Inputs(sheets, F, torch.tensor(cfg["hcdefs"], dtype=torch.float64,
                                          device=device),
                  float(cfg["dt_seconds"]), int(traffic["period_steps"]),
                  system.regen_every(traffic))


def run_period(inp: Inputs, start, held0, month0, step0, prec, abi,
               min_thickness):
    states = {s.name: rc.SheetState(*(x.to(inp.F[0].device)
                                      for x in start[s.name][:3]))
              for s in inp.sheets}
    held = ({n: torch.as_tensor(v, device=inp.F[0].device)
             for n, v in held0.items()} if held0 else None)
    M = len(inp.F)
    # the matrices in use: those of the last regeneration, which is the
    # period's start, or (none yet) the initial state's
    if step0 % inp.regen_every == 0 and step0 > 0:
        masks = states
    elif step0 < inp.regen_every:
        masks = {s.name: initial_state(s, inp.F[0].device)
                 for s in inp.sheets}
    else:
        raise ValueError(f"a period starting at step {step0} does not "
                         f"start at a regeneration (every "
                         f"{inp.regen_every})")
    return rc.period(inp.sheets, states, inp.hcdefs,
                     [inp.F[(month0 + i) % M] for i in range(inp.K)],
                     inp.dt, prec,
                     regen=(step0 + inp.K) % inp.regen_every == 0,
                     held=held,
                     keep_fields="all" if abi else "last", keep_topo=abi,
                     min_thickness=min_thickness, mask_states=masks)


def as_record(out: rc.PeriodOut, start, held0, month0, step0, nA, nhc, abi):
    """A period of the reference (the control) in the program's shape."""
    rec = drivers.Record(index=0, month0=month0, step0=step0, start=start,
                         held0=held0)
    for i, st in enumerate(out.stats):
        row = {}
        for s, v in st.items():
            row.update({f"{s}.{k}": x for k, x in
                        zip(rc.STAT_KEYS, v.double().cpu().tolist())})
        rec.rows.append(row)
    for s, (f1, hm, dr, ga) in out.held.items():
        rec.rows[-1].update({f"{s}.{k}": float(x) for k, x in
                             zip(HELD_KEYS, (hm, dr, ga))})
        rec.held1[s] = f1
    rec.fields = [{s: dict(zip(("fI", "fE_out", "fA_out"), v))
                   for s, v in f.items()} for f in out.fields if f]
    rec.after = {s: (st.H, st.U) for s, st in out.states.items()}
    if abi:
        rec.topo = [(fhc.reshape(-1), torch.nan_to_num(elev, nan=0.0)
                     .reshape(-1), under.reshape(-1).to(torch.int32))
                    for fhc, elev, under in out.topo]
    elif any(out.mats[s] is not out.ref_mats[s] for s in out.mats):
        rec.fhc = {s: (m.fhc, m.elevE) for s, m in out.mats.items()}
    return rec


def initial(inp: Inputs, traffic, seed, device):
    """The cell's initial state ({sheet: (H, U, bed)}) and held state
    ({sheet: (n, nE)}, empty without held fields), as the program's set-up
    makes them."""
    start = {}
    for s in inp.sheets:
        st = initial_state(s, device)
        start[s.name] = (st.H, st.U, st.bed)
    n = int(traffic["held_fields"])
    nE = inp.sheets[0].xg.nA * inp.hcdefs.numel()
    held = ({s.name: torch.as_tensor(common.held_fields(nE, seed, n),
                                     device=device) for s in inp.sheets}
            if n else {})
    return start, held


def advance(inp: Inputs, start, held, p, prec, abi, min_thickness):
    """Period ``p`` of the reference's own run from ``start`` and ``held``:
    (its output, the next period's start, the next period's held state)."""
    out = run_period(inp, start, held, (p * inp.K) % len(inp.F), p * inp.K,
                     prec, abi, min_thickness)
    nxt = {n: (st.H, st.U, st.bed) for n, st in out.states.items()}
    return out, nxt, ({s: h[0] for s, h in out.held.items()} if out.held
                      else held)


def start_gaps(rec, start, held, mats):
    """The program's start state and held state of the window's first
    period against the reference's own, carried from the cell's initial
    state through the warm-up."""
    g = {"state": 0.0}
    for s, (H, U, _) in start.items():
        ones = torch.ones(H.numel(), device=H.device)
        pH, pU = (x.to(H.device).reshape(-1) for x in rec.start[s][:2])
        g["state"] = max(g["state"], wgap(pH, H.reshape(-1), ones),
                         wgap(pU, U.reshape(-1), ones))
    if held and mats:
        g["held"] = max(wgap(rec.held0[s], held[s], mats[s].ec_w)
                        for s in held)
    return g


def check(cfg, traffic, run, seed, device, limits, grid: gcm.Grid,
          res_km=None):
    """(correct, {number: (value, limit)}, the ledger entry that sets its
    number) of a finished run."""
    abi = traffic["driver"] == "abi"
    inp = inputs(cfg, traffic, seed, device, REFERENCE, grid, res_km)
    nA = inp.sheets[0].xg.nA
    nhc = inp.hcdefs.numel()
    names = [s.name for s in inp.sheets]
    mt = float(cfg["min_thickness"])
    vals = {"transport": transport(run.rows, names)}
    where = ""
    if run.records and run.records[0].index == 0:
        start, held = initial(inp, traffic, seed, device)
        out = None
        for p in range(int(traffic["warmup_periods"])):
            out, start, held = advance(inp, start, held, p, REFERENCE, abi,
                                       mt)
        for k, v in start_gaps(run.records[0], start, held,
                               out.mats if out else {}).items():
            vals[k] = max(vals.get(k, 0.0), v)
        del out, start, held
    for rec in run.records:
        out = run_period(inp, rec.start, rec.held0, rec.month0, rec.step0,
                         REFERENCE, abi, mt)
        g, w = numbers(rec, out, inp.sheets, nA, nhc, abi)
        if g["ledger"] > vals.get("ledger", 0.0):
            where = w
        for k, v in g.items():
            vals[k] = max(vals.get(k, 0.0), v)
    table = {k: (v, limits.get(k)) for k, v in vals.items()}
    ok = (bool(run.records) and run.records[0].index == 0
          and run.failed == 0
          and all(lim is not None and np.isfinite(v) and v <= lim
                  for v, lim in table.values()))
    return ok, table, where
