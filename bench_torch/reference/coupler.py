"""The plain reference of one coupled period: what the program's coupling
step, regeneration, E1vE0 remap and ModelE TOPO fields compute, written as
straightforward PyTorch from their definitions, with nothing of the
program under test.

Matrices (per sheet, from the exchange grid and an elevation mask): an
exchange cell x over an iced ice cell splits between the bracketing
elevation classes k, k + 1 of its ice cell's surface, weights (1 - t, t);
E index a * nhc + k.  Entries are overlap area x split weight, times
native / projected area of the A cell (correctA).  An apply of matrix M to
field f is (sum_s M[d, s] f[s]) / wM[d], wM the row sums, NaN where wM = 0,
sums in f64 and the result f32; non-finite sources count as 0.

One step of one sheet, with forcing fE (8, nE) in ModelE's units:
  fI = IvE fE, tsurf + 273.15 K; the seven extensive rows repaired in f64
  so that sum(fI wM) = sum(fE Mw) (one additive correction per row);
  the ice model on fI scaled by wM / cell area; the harvest (10 rows: surface,
  thickness, mask, runoff + rain, basal melt, calving, their enthalpies,
  column specific enthalpy) through EvI and AvI, each repaired against
  its ice-side total; a 15-entry f64 ledger row.
A regeneration rebuilds the matrices from the surface where H > 1 m and
remaps the GCM's held EC state through E1vE0 (the exchange cells kept in
both masks, M[e1, e0] = sum_x o_x h1(x, e1) h0(x, e0)).

These matrices are those of the regrid parameters scale and correctA with
no smoothing (sigma): ``check_params`` refuses any others.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from . import ice
from .grid import Exchange

F32 = torch.float32
TSURF_OFFSET = 273.15            # degC -> K
REPAIR_ROWS = (0, 1, 2, 3, 5, 6, 7)   # every forcing row but tsurf
ENERGY_ROWS = (1, 2, 3, 5)       # smb_enth, deltah, heat_flux, geothermal
SMB, TSURF, RAIN, RAIN_ENTH = 0, 4, 6, 7
PARAMS = {"scale": True, "correctA": True, "sigma": None}
STAT_KEYS = ("mass_in_E", "mass_delivered_I", "ice_mass",
             "mass_returned_I", "mass_clamp_I", "mass_residual",
             "energy_in_E", "energy_delivered_I", "energy_pdd_implied",
             "energy_storage_I", "energy_returned_I", "energy_clamp_I",
             "energy_residual", "mass_rain_through", "energy_rain_through")


def check_params(params: dict) -> None:
    """A ``ValueError`` unless ``params`` (scale, correctA, sigma) are the
    ones this module computes: scale and correctA, no sigma."""
    if dict(params) != PARAMS:
        raise ValueError(f"reference/coupler.py computes the matrices of "
                         f"{PARAMS}, not of {dict(params)}")


@dataclasses.dataclass
class Matrix:
    """One direction's COO entries (dest, src, vals) and both weights."""

    dst: torch.Tensor
    src: torch.Tensor
    vals: torch.Tensor
    n_dst: int
    n_src: int
    wM: torch.Tensor          # row sums
    Mw: torch.Tensor          # column sums

    @classmethod
    def of(cls, dst, src, vals, n_dst, n_src):
        wM = torch.zeros(n_dst, dtype=vals.dtype, device=vals.device)
        Mw = torch.zeros(n_src, dtype=vals.dtype, device=vals.device)
        return cls(dst, src, vals, n_dst, n_src, wM.index_add_(0, dst, vals),
                   Mw.index_add_(0, src, vals))

    def t(self):
        return Matrix(self.src, self.dst, self.vals, self.n_src, self.n_dst,
                      self.Mw, self.wM)

    def apply(self, f, prec):
        """f (nvar, n_src) -> (nvar, n_dst) f32, NaN where wM = 0."""
        x = torch.where(torch.isfinite(f), f, 0.0)
        x = prec.field(x).to(prec.acc)
        v = prec.field(self.vals).to(prec.acc)
        out = torch.zeros((x.shape[0], self.n_dst), dtype=prec.acc,
                          device=x.device)
        out.index_add_(1, self.dst, v[None, :] * x[:, self.src])
        w = self.wM.to(prec.acc)
        out = torch.where(w > 0, out / torch.where(w > 0, w, 1.0), torch.nan)
        return out.to(F32)


@dataclasses.dataclass
class Mats:
    """The matrices of one elevation mask."""

    EvI: Matrix
    AvI: Matrix
    ec_w: torch.Tensor        # (nE,) overlap x split weight per E (no cA)
    kept: torch.Tensor        # (nX,) bool: exchange cells over ice
    h: tuple                  # (iE0, iE1, w0, w1) of the kept cells
    fhc: torch.Tensor         # (nhc, nA)
    elevE: torch.Tensor       # (nhc, nA), NaN where no ice
    wA: torch.Tensor          # (nA,) iced overlap per A cell


def ec_split(elev, hcdefs):
    nhc = hcdefs.numel()
    k = (torch.searchsorted(hcdefs, elev, right=True) - 1).clamp(0, nhc - 2)
    t = ((elev - hcdefs[k]) / (hcdefs[k + 1] - hcdefs[k])).clamp(0.0, 1.0)
    return k, 1.0 - t, t


def matrices(xg: Exchange, elevmask, hcdefs, prec) -> Mats:
    """The matrices of ``elevmask`` ((nI,) surface where iced, NaN not)."""
    B = prec.books
    nhc, nA = hcdefs.numel(), xg.nA
    nE = nA * nhc
    kept = torch.isfinite(elevmask)[xg.iI]
    iA, iI = xg.iA[kept], xg.iI[kept]
    o = xg.area[kept].to(B)
    k, w0, w1 = ec_split(elevmask[iI].to(torch.float64), hcdefs)
    w0, w1 = w0.to(B), w1.to(B)
    e0, e1 = iA * nhc + k, iA * nhc + k + 1
    c = xg.cA.to(B)[iA]
    EvI = Matrix.of(torch.cat([e0, e1]), torch.cat([iI, iI]),
                    torch.cat([o * w0 * c, o * w1 * c]), nE, xg.nI)
    AvI = Matrix.of(iA, iI, o * c, nA, xg.nI)
    ec_w = torch.zeros(nE, dtype=B, device=o.device)
    ec_w.index_add_(0, e0, o * w0).index_add_(0, e1, o * w1)
    elev = elevmask[iI].to(B)
    we = torch.zeros(nE, dtype=B, device=o.device)
    we.index_add_(0, e0, o * w0 * elev).index_add_(0, e1, o * w1 * elev)
    wA = torch.zeros(nA, dtype=B, device=o.device).index_add_(0, iA, o)
    fhc = torch.where(wA[None, :] > 0,
                      ec_w.reshape(nA, nhc).T / torch.where(wA > 0, wA, 1.0),
                      0.0)
    elevE = torch.where(ec_w > 0, we / torch.where(ec_w > 0, ec_w, 1.0),
                        torch.nan).reshape(nA, nhc).T
    return Mats(EvI, AvI, ec_w, kept, (e0, e1, w0, w1), fhc, elevE, wA)


def wsum(f, w, B):
    """sum(f w) over the last axis in ``B``, non-finite f as 0."""
    return (torch.where(torch.isfinite(f), f, 0.0).to(B) * w.to(B)).sum(-1)


def repair(out, wM, m_src, B):
    """``out`` (nvar, n) plus one correction a row so sum(out wM) = m_src;
    only finite cells of positive weight move.  Returns ``B``."""
    o = out.to(B)
    w = wM.to(B)
    corr = (m_src.to(B) - wsum(o, w, B)) / torch.where(w.sum() > 0, w.sum(),
                                                       1.0)
    return torch.where((w > 0)[None, :] & torch.isfinite(o), o + corr[:, None],
                       o)


@dataclasses.dataclass
class SheetState:
    H: torch.Tensor
    U: torch.Tensor
    bed: torch.Tensor


@dataclasses.dataclass
class Sheet:
    """One sheet of a configuration on the reference's side."""

    name: str
    xg: Exchange
    ip: ice.IceParams
    nx: int
    ny: int
    cell_area: float


def elevmask(st: SheetState, min_thickness):
    return torch.where(st.H > min_thickness, st.bed + st.H,
                       torch.nan).reshape(-1)


def step(sh: Sheet, m: Mats, st: SheetState, fE, dt, prec):
    """One coupling step of one sheet; returns (state, fI, fE_out, fA_out,
    stats (15,))."""
    B = prec.books
    IvE = m.EvI.t()
    fI = IvE.apply(fE, prec)
    fI[TSURF] = fI[TSURF] + TSURF_OFFSET
    rows = list(REPAIR_ROWS)
    m_src = wsum(fE[rows], IvE.Mw, B)
    fI64 = repair(torch.where(torch.isfinite(fI[rows]), fI[rows], 0.0),
                  IvE.wM, m_src, B)
    fI[rows] = torch.where(torch.isfinite(fI[rows]), fI64.to(F32), fI[rows])

    def row(r):
        v = fI64[rows.index(r)] if r in rows else fI[r]
        return torch.where(torch.isfinite(v), v, 0.0)

    wMi = IvE.wM.to(B)
    mfac = wMi / sh.cell_area
    smbI = row(SMB) * mfac
    rainI = row(RAIN) * mfac
    rain_enthI = row(RAIN_ENTH) * mfac
    enthI = sum(row(r) for r in ENERGY_ROWS) * mfac

    def e_src(r):
        return wsum(fE[r], IvE.Mw, B) * dt

    def dl(r):
        return wsum(fI64[rows.index(r)], IvE.wM, B) * dt

    def tot(x):
        return x.reshape(-1).to(B).sum()

    m_in = e_src(SMB) + e_src(RAIN)
    e_in = sum(e_src(r) for r in ENERGY_ROWS) + e_src(RAIN_ENTH)
    mass0 = tot(st.H) * sh.cell_area * ice.RHO
    e0 = tot(st.U) * sh.cell_area
    s_smb, s_rain, s_enth = tot(smbI), tot(rainI), tot(enthI)
    m_del = dl(SMB) + dl(RAIN)
    m_rain, e_rain = dl(RAIN), dl(RAIN_ENTH)
    e_del = sum(dl(r) for r in ENERGY_ROWS) + e_rain

    H, U, fx = ice.advance(sh.ip, st.H, st.U, st.bed, smbI, row(TSURF), dt,
                           enthI)
    new = SheetState(H, U, st.bed)
    ad = sh.cell_area * dt
    mass1 = tot(H) * sh.cell_area * ice.RHO
    e1 = tot(U) * sh.cell_area
    m_shed = tot(fx["runoff"] + fx["basal_melt"] + fx["calving"])
    e_shed = tot(fx["enth_runoff"] + fx["enth_basal"] + fx["enth_calving"])
    m_ret = m_shed * ad + m_rain
    m_clamp = fx["mass_clamp"].to(B) * ad
    e_ret = e_shed * ad + e_rain
    e_clamp = fx["enth_clamp"].to(B) * ad
    e_pdd = tot(fx["latent_pdd"]) * ad
    m_f32 = (s_smb + s_rain) * ad
    e_f32 = s_enth * ad
    m_res = (mass1 - mass0 - m_f32 + m_ret - m_clamp) + (m_f32 - m_del)
    e_res = ((e1 - e0 - e_f32 + (e_ret - e_rain) + e_clamp)
             + (e_f32 + e_rain - e_del))
    stats = torch.stack([m_in, m_del, mass1, m_ret, m_clamp, m_res, e_in,
                         e_del, e_pdd, e1, e_ret, e_clamp, e_res, m_rain,
                         e_rain])

    # the harvest, flux rows back to the matrix measure
    inv = torch.where(wMi > 0, sh.cell_area / torch.where(wMi > 0, wMi, 1.0),
                      0.0).to(F32)
    icy = H.reshape(-1) > 1.0
    ent = torch.where(H > 0, U / (ice.RHO * torch.clamp(H, min=1e-30)), 0.0)

    def r(x):
        return x.reshape(-1).to(F32) * inv

    outI = torch.stack([
        torch.where(icy, (st.bed + H).reshape(-1), torch.nan),
        torch.where(icy, H.reshape(-1), torch.nan), icy.to(F32),
        r(fx["runoff"]) + r(rainI), r(fx["basal_melt"]), r(fx["calving"]),
        r(fx["enth_runoff"]) + r(rain_enthI), r(fx["enth_basal"]),
        r(fx["enth_calving"]), torch.where(icy, ent.reshape(-1), torch.nan)])
    harvest = []
    for M in (m.EvI, m.AvI):
        out = M.apply(outI, prec)
        out = torch.where(torch.isfinite(out), out, 0.0)
        harvest.append(repair(out, M.wM, wsum(outI, M.Mw, B), B))
    return new, fI, harvest[0], harvest[1], stats


def e1ve0(old: Mats, new: Mats, xg: Exchange, held, default, prec):
    """Held EC state (n, nE) remapped from ``old``'s classes to ``new``'s;
    returns (held, held_mass, dropped, gained)."""
    B = prec.books
    nE = old.ec_w.numel()
    both = old.kept & new.kept
    pos_old = torch.cumsum(old.kept.to(torch.int64), 0) - 1
    pos_new = torch.cumsum(new.kept.to(torch.int64), 0) - 1
    io, inew = pos_old[both], pos_new[both]
    o = xg.area[both].to(B)
    rows, cols, vals = [], [], []
    for e1, w1 in ((new.h[0][inew], new.h[2][inew]),
                   (new.h[1][inew], new.h[3][inew])):
        for e0, w0 in ((old.h[0][io], old.h[2][io]),
                       (old.h[1][io], old.h[3][io])):
            rows.append(e1)
            cols.append(e0)
            vals.append(o * w1.to(B) * w0.to(B))
    M = Matrix.of(torch.cat(rows), torch.cat(cols), torch.cat(vals), nE, nE)
    f0 = held.to(B)
    num = torch.zeros((f0.shape[0], nE), dtype=B, device=f0.device)
    num.index_add_(1, M.dst, M.vals[None, :] * f0[:, M.src])
    f1 = torch.where(M.wM > 0, num / torch.where(M.wM > 0, M.wM, 1.0),
                     torch.tensor(default, dtype=B, device=f0.device))
    dropped = (f0 * (old.ec_w - M.Mw)[None, :]).sum()
    gained = (f1 * (new.ec_w - M.wM)[None, :]).sum()
    return f1, (f1 * new.ec_w[None, :]).sum(), dropped, gained


def topo(mats: List[Mats], nhc, nA):
    """ModelE's (fhc, elevE, underice), each (nhc, nA), over the sheets."""
    w = 0.0
    we = 0.0
    under = []
    for m in mats:
        ws = m.fhc * m.wA[None, :]
        w = w + ws
        we = we + torch.where(torch.isfinite(m.elevE), m.elevE, 0.0) * ws
        under.append(ws)
    tot = w.sum(0, keepdim=True)
    fhc = torch.where(tot > 0, w / torch.where(tot > 0, tot, 1.0), 0.0)
    elevE = torch.where(w > 0, we / torch.where(w > 0, w, 1.0), torch.nan)
    underice = torch.where(w > 0, torch.stack(under).argmax(0) + 1, 0)
    return fhc, elevE, underice


@dataclasses.dataclass
class PeriodOut:
    """What one period of the reference produced."""

    stats: List[Dict[str, torch.Tensor]]          # a step: sheet -> (15,)
    fields: List[Dict[str, tuple]]                # a step: sheet -> (fI,
    #                                               fE_out, fA_out) or None
    topo: List[tuple]                             # a step's (fhc, elevE,
    #                                               underice), when asked
    states: Dict[str, SheetState]                 # after the period
    held: Dict[str, tuple]                        # after E1vE0, when held
    mats: Dict[str, Mats]                         # after the regeneration
    ref_mats: Dict[str, Mats]                     # the period's own


def period(sheets: List[Sheet], states: Dict[str, SheetState], hcdefs,
           forcings, dt, prec, *, params: dict, regen: bool,
           held: Optional[Dict] = None,
           held_default=0.0, keep_fields="last", keep_topo=False,
           min_thickness=1.0, mask_states=None) -> PeriodOut:
    """``len(forcings)`` coupling steps of every sheet from ``states`` with
    the matrices of their masks; with ``regen`` the period closes with a
    regeneration (and E1vE0 of ``held``).  ``keep_fields``: "all" or "last"
    steps' fields; ``keep_topo``: each step's TOPO as ModelE reads it after
    the step.  The matrices are those of ``mask_states`` (the states at the
    last regeneration; by default ``states``), under the regrid parameters
    ``params`` (``check_params``)."""
    check_params(params)
    nhc = hcdefs.numel()
    masks = states if mask_states is None else mask_states
    mats = {s.name: matrices(s.xg, elevmask(masks[s.name], min_thickness),
                             hcdefs, prec) for s in sheets}
    first = dict(mats)
    nA = sheets[0].xg.nA
    out = PeriodOut([], [], [], {}, {}, {}, first)
    cur = dict(states)
    K = len(forcings)
    for i, fE in enumerate(forcings):
        st, fl = {}, {}
        for s in sheets:
            cur[s.name], fI, fEo, fAo, stats = step(s, mats[s.name],
                                                    cur[s.name], fE, dt, prec)
            st[s.name] = stats
            if keep_fields == "all" or i == K - 1:
                fl[s.name] = (fI, fEo, fAo)
        if regen and i == K - 1:
            for s in sheets:
                new = matrices(s.xg, elevmask(cur[s.name], min_thickness),
                               hcdefs, prec)
                if held is not None:
                    out.held[s.name] = e1ve0(mats[s.name], new, s.xg,
                                             held[s.name], held_default, prec)
                mats[s.name] = new
        out.stats.append(st)
        out.fields.append(fl)
        if keep_topo:
            out.topo.append(topo([mats[s.name] for s in sheets], nhc, nA))
    out.states = cur
    out.mats = mats
    return out
