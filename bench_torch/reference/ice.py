"""The ice model of the plain reference: the shallow-ice approximation with
an enthalpy column, written from its equations (plain PyTorch, one CFL
substep after another until the coupling interval is covered).

Per substep, on a lattice with one edge-replicated ghost layer:
  face thickness and surface slope; SIA diffusivity
  D = GAMMA H^(n+2) |grad s|^(n-1), GAMMA = 2 A (rho g)^n / (n + 2);
  face flux q = D ds (positive toward the lower index), its divergence;
  enthalpy advected donor-cell with the mass flux;
  dt_sub = min(0.25 min(dx, dy)^2 / Dmax, dt_max, dt - t_done);
  H += (div + smb) dt_sub, clamped at 0 (the clamp booked);
  U += (divE + enth_flux) dt_sub;
  PDD melt ddf (T - T_melt)+ dt_sub / rho (at most H), calving off;
  the energy riding the melt, the melt's latent heat drawn from the
  column's positive energy, positive energy left melts the base, and
  ice-free cells drop their energy (booked).
Every removal is summed as applied, so the coupled books close.
"""
from __future__ import annotations

import dataclasses

import torch

RHO = 910.0
G = 9.81
L_FUS = 3.34e5
C_ICE = 2009.0
T_MELT = 273.15
N_GLEN = 3.0
A_GLEN = 1e-16 / (365.2425 * 86400.0)
GAMMA = 2.0 * A_GLEN * (RHO * G) ** N_GLEN / (N_GLEN + 2.0)


@dataclasses.dataclass(frozen=True)
class IceParams:
    dx: float
    dy: float
    dt_max: float = 0.1 * 365.2425 * 86400.0
    n_max: int = 64
    ddf: float = 8.0 / 86400.0
    t_init: float = 263.15


def vialov(nx, ny, device, height=3000.0, radius_frac=0.7):
    """The dome the cells start from: H = h0 (1 - r^1.5)^(3/8) over an
    ellipse of 0.7 of the lattice, bed 0, columns at ``t_init``."""
    y, x = torch.meshgrid(torch.arange(ny, dtype=torch.float64, device=device),
                          torch.arange(nx, dtype=torch.float64, device=device),
                          indexing="ij")
    rx = (x - (nx - 1) / 2) / (nx * radius_frac / 2)
    ry = (y - (ny - 1) / 2) / (ny * radius_frac / 2)
    r = torch.sqrt(rx ** 2 + ry ** 2)
    return (height * torch.clamp(1.0 - r ** 1.5, min=0.0) ** 0.375).float()


def cold_enthalpy(H, t_init=263.15):
    return (RHO * C_ICE * (t_init - T_MELT) * H).to(H.dtype)


def _ghost(a):
    a = torch.cat([a[:1], a, a[-1:]], 0)
    return torch.cat([a[:, :1], a, a[:, -1:]], 1)


def _grad_edge(s, dim):
    """Central differences inside, one-sided at the two edges."""
    g = torch.empty_like(s)
    if dim == 0:
        g[1:-1] = (s[2:] - s[:-2]) / 2
        g[0], g[-1] = s[1] - s[0], s[-1] - s[-2]
    else:
        g[:, 1:-1] = (s[:, 2:] - s[:, :-2]) / 2
        g[:, 0], g[:, -1] = s[:, 1] - s[:, 0], s[:, -1] - s[:, -2]
    return g


def _div(qe, qn, dx, dy, shape):
    d = torch.zeros(shape, dtype=qe.dtype, device=qe.device)
    d[:, :-1] += qe / dx
    d[:, 1:] -= qe / dx
    d[:-1, :] += qn / dy
    d[1:, :] -= qn / dy
    return d[1:-1, 1:-1]


def _substep(p: IceParams, bed_g, H, U, smb, ts, ef, dt, t_done):
    n = N_GLEN
    Hg, Ug = _ghost(H), _ghost(U)
    sg = bed_g + Hg
    He = 0.5 * (Hg[:, 1:] + Hg[:, :-1])
    dsx = (sg[:, 1:] - sg[:, :-1]) / p.dx
    sy = _grad_edge(sg, 0) / p.dy
    De = GAMMA * He ** (n + 2) * (dsx ** 2 + (0.5 * (sy[:, 1:] + sy[:, :-1]))
                                  ** 2) ** ((n - 1) / 2)
    qe = De * dsx
    Hn = 0.5 * (Hg[1:] + Hg[:-1])
    dsy = (sg[1:] - sg[:-1]) / p.dy
    sx = _grad_edge(sg, 1) / p.dx
    Dn = GAMMA * Hn ** (n + 2) * (dsy ** 2 + (0.5 * (sx[1:] + sx[:-1]))
                                  ** 2) ** ((n - 1) / 2)
    qn = Dn * dsy
    dmax = torch.maximum(De[1:-1, :].max(), Dn[:, 1:-1].max())
    hg = torch.where(Hg > 0, Ug / (RHO * torch.clamp(Hg, min=1e-30)), 0.0)
    he = torch.where(qe > 0, hg[:, 1:], hg[:, :-1])
    hn = torch.where(qn > 0, hg[1:], hg[:-1])
    div = _div(qe, qn, p.dx, p.dy, Hg.shape)
    divE = _div(RHO * qe * he, RHO * qn * hn, p.dx, p.dy, Hg.shape)

    cfl = torch.where(dmax > 0, 0.25 * min(p.dx, p.dy) ** 2 / (dmax + 1e-30),
                      p.dt_max)
    dts = torch.clamp(torch.minimum(torch.clamp(cfl, max=p.dt_max),
                                    dt - t_done), min=0.0)
    H_dyn = H + (div + smb) * dts
    H1 = torch.clamp(H_dyn, min=0.0)
    clamp = (H1 - H_dyn).sum()
    U1 = U + divE * dts + ef * dts
    melt = torch.minimum((p.ddf / RHO) * torch.clamp(ts - T_MELT, min=0.0)
                         .to(H1.dtype) * dts, H1)
    calv = torch.zeros_like(H1)
    H2 = H1 - melt
    Hpre = H2 + melt + calv
    # the energy of what leaves, the latent heat of melt, basal melt
    e_run = torch.where(Hpre > 0, U1 * (melt / torch.clamp(Hpre, min=1e-30)),
                        0.0)
    U2 = U1 - e_run
    Hm = Hpre - melt
    e_lat = torch.minimum(torch.clamp(U2, min=0.0), RHO * L_FUS * melt)
    U2 = U2 - e_lat
    e_run = e_run + e_lat
    e_calv = torch.where(Hm > 0, U2 * (calv / torch.clamp(Hm, min=1e-30)), 0.0)
    U2 = U2 - e_calv
    Hc = Hm - calv
    basal = torch.minimum(torch.clamp(U2, min=0.0) / (RHO * L_FUS), Hc)
    U2 = U2 - RHO * L_FUS * basal
    H3 = Hc - basal
    e_clamp = torch.where(H3 > 0, 0.0, U2)
    U3 = torch.where(H3 > 0, U2, 0.0)
    sums = (melt, basal, calv, e_run, e_calv, e_lat)
    return H3, U3, t_done + dts, sums, clamp, e_clamp.sum()


def advance(p: IceParams, H, U, bed, smb_flux, tsurf, dt, enth_flux):
    """One coupling interval ``dt``: returns (H, U, fluxes dict) with every
    flux an interval mean (mass kg m-2 s-1, energy W m-2; ``mass_clamp``,
    ``enth_clamp`` totals)."""
    shape = H.shape
    smb = (smb_flux.reshape(shape) / RHO).to(H.dtype)
    ts = tsurf.reshape(shape).to(H.dtype)
    ef = enth_flux.reshape(shape).to(H.dtype)
    bed_g = _ghost(bed)
    t_done = torch.zeros((), dtype=H.dtype, device=H.device)
    cums = [torch.zeros_like(H) for _ in range(6)]
    clamp = torch.zeros((), dtype=H.dtype, device=H.device)
    eclamp = torch.zeros_like(clamp)
    k = 0
    while k < p.n_max and bool(t_done < dt):
        H, U, t_done, sums, c, ec = _substep(p, bed_g, H, U, smb, ts, ef, dt,
                                             t_done)
        cums = [a + b for a, b in zip(cums, sums)]
        clamp, eclamp = clamp + c, eclamp + ec
        k += 1
    melt, basal, calv, e_run, e_calv, e_lat = cums
    fx = dict(runoff=melt * (RHO / dt), basal_melt=basal * (RHO / dt),
              calving=calv * (RHO / dt), mass_clamp=clamp * (RHO / dt),
              enth_runoff=e_run / dt, enth_basal=basal * (RHO * L_FUS / dt),
              enth_calving=e_calv / dt, enth_clamp=eclamp / dt,
              latent_pdd=(melt * (RHO * L_FUS) - e_lat) / dt)
    return H, U, fx
