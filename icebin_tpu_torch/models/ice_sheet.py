"""SIA ice-sheet model with an enthalpy column (port of
``icebin_tpu/models/ice_sheet.py``; see its docstring for the physics).

Two conserved columns per lattice cell: thickness H under flux-form SIA
dynamics, and column internal energy U advected donor-cell with the mass
flux.  Ablation: PDD surface melt (whose latent heat is drawn from the
column's temperate excess first, the rest booked as the implied
atmospheric share ``latent_pdd``), margin calving, and basal melt of any
positive column energy.  Every removal is accumulated exactly as applied,
so the coupler's mass and energy books close by construction.

Differences from the reference, none of which changes a result:

* The CFL substep loop (``lax.while_loop`` at ``ice_sheet.py:458-462``)
  has two forms.  By default ``advance`` is a Python loop that reads the
  device scalar ``t_done < dt`` after every substep (one host sync per
  substep), so it runs exactly the reference's substeps and stops as
  early; the mesh step runs it.  ``advance(..., substeps=s)`` runs exactly
  ``s`` substeps and reads nothing on the host: each substep is gated on
  the device by ``t_done < dt``, so the substeps that run give the early
  exit's bits, and the flag that the budget fell short comes back as a
  device tensor (the coupler's compiled step runs this form).
* ``state.t`` is always f64.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

__all__ = ["IceSheetConfig", "IceSheetState", "IceFluxes", "init_state",
           "default_enthalpy", "step", "step_coupled", "advance",
           "ablation_ghosted",
           "sia_flux_div_ghosted", "sia_flux_div_energy_ghosted",
           "apply_ablation_energy", "RHO_ICE", "GRAVITY", "L_FUSION",
           "C_ICE", "T_MELT"]

RHO_ICE = 910.0        # kg m-3
GRAVITY = 9.81         # m s-2
L_FUSION = 3.34e5      # J kg-1 latent heat of fusion
C_ICE = 2009.0         # J kg-1 K-1 specific heat of ice
T_MELT = 273.15        # K
GLEN_N = 3.0
_A_GLEN = 1e-16 / (365.2425 * 86400.0)   # Pa-3 s-1
GAMMA = 2.0 * _A_GLEN * (RHO_ICE * GRAVITY) ** GLEN_N / (GLEN_N + 2.0)


@dataclasses.dataclass(frozen=True)
class IceSheetConfig:
    """Same fields and defaults as the reference's ``IceSheetConfig``."""

    nx: int
    ny: int
    dx: float                 # m
    dy: float                 # m
    dt_max: float = 0.1 * 365.2425 * 86400.0   # max internal substep [s]
    n_substeps_max: int = 64  # hard bound on CFL substeps per step
    ddf: float = 8.0 / 86400.0                 # PDD factor [kg m-2 s-1 K-1]
    melt_t0: float = T_MELT   # K
    calv_thk: float = 0.0     # m; 0 disables margin calving
    calv_tau: float = 86400.0 * 10.0
    t_init: float = 263.15    # K, default column temperature
    dtype: str = "float32"    # lattice state dtype: "float32" or "float64"

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "float64": torch.float64}[self.dtype]


class IceFluxes(NamedTuple):
    """Per-cell (ny, nx) interval-mean fluxes of one coupling step; mass
    rows [kg m-2 s-1, leaving positive], energy rows [W m-2].
    ``mass_clamp`` and ``enth_clamp`` are scalar totals (ledger-only)."""

    runoff: torch.Tensor
    basal_melt: torch.Tensor
    calving: torch.Tensor
    mass_clamp: torch.Tensor
    enth_runoff: torch.Tensor
    enth_basal: torch.Tensor
    enth_calving: torch.Tensor
    enth_clamp: torch.Tensor
    latent_pdd: torch.Tensor


def default_enthalpy(H: torch.Tensor, t_init: float = 263.15):
    """Cold column at uniform ``t_init`` [K]: U = rho H c_i (t_init - Tm)."""
    return (RHO_ICE * C_ICE * (t_init - T_MELT) * H).to(H.dtype)


@dataclasses.dataclass
class IceSheetState:
    """(ny, nx) lattice tensors; thickness H in m ice equivalent."""

    H: torch.Tensor           # ice thickness [m]
    bed: torch.Tensor         # bedrock elevation [m]
    t: torch.Tensor           # model time [s], f64 scalar
    enth: Optional[torch.Tensor] = None   # column energy [J m-2] vs T_MELT

    def __post_init__(self):
        if self.enth is None:
            self.enth = default_enthalpy(self.H)

    @property
    def surface(self) -> torch.Tensor:
        return self.bed + self.H

    def specific_enthalpy(self) -> torch.Tensor:
        """h = U / (rho H) [J kg-1]; 0 where ice-free."""
        return torch.where(self.H > 0, self.enth / (
            RHO_ICE * torch.clamp(self.H, min=1e-30)), 0.0)

    def elevmask(self, min_thickness: float = 1.0) -> torch.Tensor:
        """Flat (nI,) surface elevation where iced, NaN elsewhere."""
        icy = self.H > min_thickness
        return torch.where(icy, self.surface, torch.nan).reshape(-1)

    def mass(self, cell_area: float) -> torch.Tensor:
        return self.H.sum() * cell_area * RHO_ICE


def init_state(cfg: IceSheetConfig, bed=None, H0=None, *, device,
               dome_height: float = 3000.0,
               dome_radius_frac: float = 0.7) -> IceSheetState:
    """Default: Vialov-style parabolic dome centred on the lattice."""
    dt_ = cfg.torch_dtype
    shape = (cfg.ny, cfg.nx)
    if bed is None:
        bed = torch.zeros(shape, dtype=dt_, device=device)
    else:
        bed = torch.as_tensor(bed, device=device).to(dt_).reshape(shape)
    if H0 is None:
        y, x = torch.meshgrid(
            torch.arange(cfg.ny, dtype=torch.float64, device=device),
            torch.arange(cfg.nx, dtype=torch.float64, device=device),
            indexing="ij")
        rx = (x - (cfg.nx - 1) / 2) / (cfg.nx * dome_radius_frac / 2)
        ry = (y - (cfg.ny - 1) / 2) / (cfg.ny * dome_radius_frac / 2)
        r = torch.sqrt(rx ** 2 + ry ** 2)
        H0 = (dome_height * torch.clamp(1.0 - r ** 1.5, min=0.0)
              ** (3.0 / 8.0)).to(dt_)
    else:
        H0 = torch.as_tensor(H0, device=device).to(dt_).reshape(shape)
    return IceSheetState(H=H0, bed=bed,
                         t=torch.zeros((), dtype=torch.float64,
                                       device=device),
                         enth=default_enthalpy(H0, cfg.t_init))


def _face_fluxes(Hg, sg, dx, dy):
    """SIA face fluxes on ghosted arrays: qe (ny+2, nx+1) east faces, qn
    (ny+1, nx+2) north faces, positive toward the LOWER index, plus the CFL
    diffusivity max (ghost rows of De / ghost columns of Dn excluded)."""
    He = 0.5 * (Hg[:, 1:] + Hg[:, :-1])
    dsx = (sg[:, 1:] - sg[:, :-1]) / dx
    # torch.gradient's default edge_order=1 is numpy's (and jnp's):
    # central differences inside, one-sided first differences at the edges
    sy = torch.gradient(sg, dim=0)[0] / dy
    sye = 0.5 * (sy[:, 1:] + sy[:, :-1])
    De = GAMMA * He ** (GLEN_N + 2) * (dsx ** 2 + sye ** 2) ** (
        (GLEN_N - 1) / 2)
    qe = De * dsx

    Hn = 0.5 * (Hg[1:, :] + Hg[:-1, :])
    dsy = (sg[1:, :] - sg[:-1, :]) / dy
    sx = torch.gradient(sg, dim=1)[0] / dx
    sxn = 0.5 * (sx[1:, :] + sx[:-1, :])
    Dn = GAMMA * Hn ** (GLEN_N + 2) * (dsy ** 2 + sxn ** 2) ** (
        (GLEN_N - 1) / 2)
    qn = Dn * dsy
    Dmax = torch.maximum(De[1:-1, :].max(), Dn[:, 1:-1].max())
    return qe, qn, Dmax


def _divergence(qe, qn, dx, dy, shape):
    # the reference's four scatter-adds, in its order (same f32 rounding)
    div = torch.zeros(shape, dtype=qe.dtype, device=qe.device)
    div[:, :-1] += qe / dx
    div[:, 1:] += -qe / dx
    div[:-1, :] += qn / dy
    div[1:, :] += -qn / dy
    return div[1:-1, 1:-1]


def sia_flux_div_ghosted(Hg, sg, dx, dy):
    """Flux-form SIA divergence on arrays with one edge-replicated ghost
    layer; returns (interior divergence, CFL diffusivity max)."""
    qe, qn, Dmax = _face_fluxes(Hg, sg, dx, dy)
    return _divergence(qe, qn, dx, dy, Hg.shape), Dmax


def sia_flux_div_energy_ghosted(Hg, sg, Ug, dx, dy):
    """``sia_flux_div_ghosted`` plus donor-cell enthalpy advection.
    Returns (div [m s-1], divE [W m-2], Dmax)."""
    qe, qn, Dmax = _face_fluxes(Hg, sg, dx, dy)
    hg = torch.where(Hg > 0, Ug / (RHO_ICE * torch.clamp(Hg, min=1e-30)),
                     0.0)
    # positive qe feeds the lower-index cell: the donor is the higher side
    he = torch.where(qe > 0, hg[:, 1:], hg[:, :-1])
    hn = torch.where(qn > 0, hg[1:, :], hg[:-1, :])
    div = _divergence(qe, qn, dx, dy, Hg.shape)
    divE = _divergence(RHO_ICE * qe * he, RHO_ICE * qn * hn, dx, dy,
                       Hg.shape)
    return div, divE, Dmax


def ablation_ghosted(Hg_pre, H_post, tsurf, cfg: IceSheetConfig, dt_sub):
    """One substep of PDD surface melt + margin calving [m ice removed];
    returns (H_new, melt_act, calv_act), each removal clamped at the
    available thickness."""
    melt_req = (cfg.ddf / RHO_ICE) * torch.clamp(
        tsurf - cfg.melt_t0, min=0.0).to(H_post.dtype) * dt_sub
    melt_act = torch.minimum(melt_req, H_post)
    H1 = H_post - melt_act
    if cfg.calv_thk > 0.0:
        nb_min = torch.minimum(
            torch.minimum(Hg_pre[:-2, 1:-1], Hg_pre[2:, 1:-1]),
            torch.minimum(Hg_pre[1:-1, :-2], Hg_pre[1:-1, 2:]))
        front = (H1 > 0.0) & (nb_min <= 0.0) & (H1 < cfg.calv_thk)
        frac = -torch.expm1(-dt_sub / cfg.calv_tau).to(H1.dtype)
        calv_act = torch.where(front, H1 * frac, 0.0)
        H1 = H1 - calv_act
    else:
        calv_act = torch.zeros_like(H1)
    return H1, melt_act, calv_act


def apply_ablation_energy(H1, U, melt_act, calv_act):
    """Book the enthalpy riding shed mass, draw surface melt's latent heat
    from the column's temperate excess, drain the remaining positive energy
    as basal melt, and clamp ice-free cells.  Returns (H_out, U_out,
    basal_act, eU_run, eU_calv, e_clamp, e_lat), each energy term exactly
    what was deducted from U."""
    safe1 = torch.clamp(H1, min=1e-30)
    eU_run = torch.where(H1 > 0, U * (melt_act / safe1), 0.0)
    U = U - eU_run
    H2 = H1 - melt_act
    e_lat = torch.minimum(torch.clamp(U, min=0.0),
                          RHO_ICE * L_FUSION * melt_act)
    U = U - e_lat
    eU_run = eU_run + e_lat
    safe2 = torch.clamp(H2, min=1e-30)
    eU_calv = torch.where(H2 > 0, U * (calv_act / safe2), 0.0)
    U = U - eU_calv
    H3 = H2 - calv_act
    basal_act = torch.minimum(torch.clamp(U, min=0.0)
                              / (RHO_ICE * L_FUSION), H3)
    U = U - RHO_ICE * L_FUSION * basal_act
    H4 = H3 - basal_act
    e_clamp = torch.where(H4 > 0, 0.0, U)
    U = torch.where(H4 > 0, U, 0.0)
    return H4, U, basal_act, eU_run, eU_calv, e_clamp, e_lat


def step(cfg: IceSheetConfig, state: IceSheetState, smb_flux,
         dt: float) -> IceSheetState:
    """Advance one coupling interval ``dt`` [s] under SMB [kg m-2 s-1]."""
    new_state, _ = step_coupled(cfg, state, smb_flux, None, dt)
    return new_state


def _pad(a):
    """One edge-replicated ghost layer on every side."""
    a = torch.cat([a[:1], a, a[-1:]], dim=0)
    return torch.cat([a[:, :1], a, a[:, -1:]], dim=1)


def step_coupled(cfg: IceSheetConfig, state: IceSheetState, smb_flux,
                 tsurf, dt: float, enth_flux=None):
    """``step`` plus both halves of the coupled budget.

    smb_flux: (nI,) or (ny, nx) [kg m-2 s-1]; tsurf: [K] driving PDD melt,
    or None to skip ablation; enth_flux: net column energy input [W m-2],
    or None.  Returns (state, IceFluxes) whose mass and energy totals
    exactly match the state change net of dynamics."""
    return advance(cfg, state, smb_flux, tsurf, dt, enth_flux)


def advance(cfg: IceSheetConfig, state: IceSheetState, smb_flux, tsurf,
            dt: float, enth_flux=None, *, ghost=_pad, global_max=None,
            rows_real=None, substeps: Optional[int] = None):
    """``step_coupled`` on a lattice block: the CFL substep loop with its
    ghost layer from ``ghost`` (default: edge-replicated, the whole
    lattice), the CFL diffusivity max reduced by ``global_max`` (default:
    none) and, when ``rows_real`` is given, only the block's first
    ``rows_real`` rows physical: the trailing pad rows are re-copied from
    the last real row after every substep (zero flux across the real/pad
    face) and kept out of the books.  The mesh step
    (``parallel.coupled.make_sharded_ice_step``) passes a halo exchange, a
    max over ranks and its ragged rows; the block's shape is the state's.

    By default the loop reads ``t_done < dt`` on the host after every
    substep and stops when it is false or after ``cfg.n_substeps_max``
    substeps.  With ``substeps`` = s (1 <= s <= ``cfg.n_substeps_max``) it
    runs exactly s substeps and reads nothing on the host: a substep is
    active while ``t_done < dt`` (a 0-d bool on the device), and every
    carried value (H, U, ``t_done``, the six removal sums and the two clamp
    sums) takes the substep's result only where active
    (``torch.where(active, new, old)``, which is ``new`` bit for bit).  So
    when s covers the substeps the early exit takes, the result is the
    early exit's bit for bit, whatever an inactive substep computes (basal
    melt does not scale with ``dt_sub``, so a zero-dt substep is not a
    no-op here).  Returns (state, IceFluxes, short, active): ``short`` the
    0-d bool ``t_done < dt`` after the budget, ``active`` the int32 count
    of substeps that were active, both on the device."""
    dt_ = state.H.dtype
    shape = tuple(state.H.shape)
    smb = (smb_flux.reshape(shape) / RHO_ICE).to(dt_)   # m/s ice equivalent
    ts = None if tsurf is None else tsurf.reshape(shape).to(dt_)
    ef = None if enth_flux is None else enth_flux.reshape(shape).to(dt_)
    bedg = ghost(state.bed)
    h_min = min(cfg.dx, cfg.dy)
    live = None
    if rows_real is not None and rows_real < shape[0]:
        live = (torch.arange(shape[0], device=state.H.device)[:, None]
                < rows_real).expand(shape)
        last = max(rows_real - 1, 0)

        def fix_pad(a):
            return torch.where(live, a, a[last][None, :])

    def real(a):
        return a if live is None else torch.where(live, a, 0.0)

    def substep(H, U, t_done, cums, clamp_s, eclamp_s):
        Hg = ghost(H)
        sg = bedg + Hg
        div, divE, Dmax = sia_flux_div_energy_ghosted(Hg, sg, ghost(U),
                                                      cfg.dx, cfg.dy)
        if global_max is not None:
            Dmax = global_max(Dmax)
        # diffusive CFL: dt < min(dx,dy)^2 / (4 Dmax)
        cfl = torch.where(Dmax > 0, 0.25 * h_min ** 2 / (Dmax + 1e-30),
                          cfg.dt_max)
        dt_sub = torch.clamp(torch.minimum(torch.clamp(cfl, max=cfg.dt_max),
                                           dt - t_done), min=0.0)
        # SMB per substep; the >= 0 clamp's fabricated mass is booked
        H_dyn = H + (div + smb) * dt_sub
        H_new = torch.clamp(H_dyn, min=0.0)
        clamp_s = clamp_s + real(H_new - H_dyn).sum()
        U_new = U + divE * dt_sub
        if ef is not None:
            U_new = U_new + ef * dt_sub
        if ts is not None:
            H_new, melt, calv = ablation_ghosted(Hg, H_new, ts, cfg, dt_sub)
            H_pre = H_new + melt + calv
            (H_new, U_new, basal, eU_run, eU_calv,
             e_clamp, e_lat) = apply_ablation_energy(H_pre, U_new, melt,
                                                     calv)
            cums = [c + real(d) for c, d in zip(cums, (
                melt, basal, calv, eU_run, eU_calv, e_lat))]
        else:
            e_clamp = torch.where(H_new > 0, 0.0, U_new)
            U_new = torch.where(H_new > 0, U_new, 0.0)
        eclamp_s = eclamp_s + real(e_clamp).sum()
        if live is not None:
            H_new, U_new = fix_pad(H_new), fix_pad(U_new)
        return H_new, U_new, t_done + dt_sub, cums, clamp_s, eclamp_s

    dev = state.H.device
    carry = (state.H, state.enth, torch.zeros((), dtype=dt_, device=dev),
             [torch.zeros_like(state.H)] * 6,
             torch.zeros((), dtype=dt_, device=dev),
             torch.zeros((), dtype=dt_, device=dev))
    if substeps is None:
        it = 0
        while it < cfg.n_substeps_max and bool(carry[2] < dt):
            carry = substep(*carry)
            it += 1
    else:
        if not 1 <= substeps <= cfg.n_substeps_max:
            raise ValueError(f"substeps={substeps} outside [1, "
                             f"n_substeps_max={cfg.n_substeps_max}]")
        def gate(active, a, b):
            # a value the substep left as it was (the removal sums without
            # ablation) needs no select
            return b if a is b else torch.where(active, a, b)

        n_active = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(substeps):
            active = carry[2] < dt
            new = substep(*carry)
            carry = (*(gate(active, a, b) for a, b in zip(new[:3], carry[:3])),
                     [gate(active, a, b) for a, b in zip(new[3], carry[3])],
                     *(gate(active, a, b) for a, b in zip(new[4:], carry[4:])))
            n_active = n_active + active
    H, U, t_done, cums, clamp_s, eclamp_s = carry

    new_state = IceSheetState(H=H, bed=state.bed, t=state.t + dt, enth=U)
    melt_c, basal_c, calv_c, er_c, ec_c, elat_c = cums
    fluxes = IceFluxes(
        runoff=melt_c * (RHO_ICE / dt),
        basal_melt=basal_c * (RHO_ICE / dt),
        calving=calv_c * (RHO_ICE / dt),
        mass_clamp=clamp_s * (RHO_ICE / dt),
        enth_runoff=er_c / dt,
        enth_basal=basal_c * (RHO_ICE * L_FUSION / dt),
        enth_calving=ec_c / dt,
        enth_clamp=eclamp_s / dt,
        latent_pdd=(melt_c * (RHO_ICE * L_FUSION) - elat_c) / dt)
    if substeps is None:
        return new_state, fluxes
    return new_state, fluxes, t_done < dt, n_active
