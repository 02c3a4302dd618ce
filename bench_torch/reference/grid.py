"""Geometry of the plain reference: ModelE lat-lon cells, the polar
stereographic projection and the exchange grid of an A grid against a
rectangular ice lattice.

Written from the published definitions, in plain PyTorch, with nothing of
the program under test:

* ModelE's 2 x 2.5 degree grid: longitude borders every 2.5 degrees from
  -181.25, latitude rows 2 degrees tall with 1-degree rows at the poles.
* Polar stereographic, ellipsoidal, true scale at ``lat_ts`` (Snyder 1987,
  "Map Projections -- A Working Manual", eqs. 15-9, 21-33, 21-34).
* Exchange cells: every A cell's ring (``subdiv`` points an edge) projected
  into the ice plane and clipped against every ice cell whose box its box
  meets (Sutherland-Hodgman, one half-plane at a time); overlaps smaller
  than 1e-13 of their ice cell are dropped, and an ice cell covered to
  within 1e-3 has its overlaps rescaled to its exact area.

``prec.geom`` is the coordinate type (float64) and ``prec.rnd`` a rounding
of coordinates (none); the control lowers both (``reference.prec``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
EQ_RAD = 6.371e6
MIN_AREA_FRAC = 1e-13
COVERAGE_TOL = 1e-3
CHUNK = 1 << 20


def modele_bounds(im: int, jm: int):
    """(lonb, latb) in degrees of ModelE's im x jm grid."""
    dlon, dlat = 360.0 / im, 180.0 / jm
    lonb = [-180.0 - dlon / 2 + dlon * i for i in range(im + 1)]
    latb = ([-90.0] + [-90.0 + dlat / 2 + dlat * j for j in range(jm - 1)]
            + [90.0])
    return lonb, latb


@dataclasses.dataclass(frozen=True)
class PolarStereo:
    """``+proj=stere +lat_0=+-90 +lat_ts=... +lon_0=... +ellps=WGS84``."""

    lon_0: float
    lat_ts: float
    south: bool

    def forward(self, lon, lat):
        """(x, y) in metres of lon/lat in degrees (f64 tensors)."""
        e = math.sqrt(WGS84_F * (2.0 - WGS84_F))
        sgn = -1.0 if self.south else 1.0

        def t_of(phi):
            s = torch.sin(phi) if torch.is_tensor(phi) else math.sin(phi)
            tan = (torch.tan(math.pi / 4 - phi / 2) if torch.is_tensor(phi)
                   else math.tan(math.pi / 4 - phi / 2))
            return tan / ((1 - e * s) / (1 + e * s)) ** (e / 2)

        phi_ts = math.radians(abs(self.lat_ts))
        m_ts = math.cos(phi_ts) / math.sqrt(1 - (e * math.sin(phi_ts)) ** 2)
        rho = WGS84_A * m_ts / t_of(phi_ts) * t_of(torch.deg2rad(sgn * lat))
        lam = torch.deg2rad(sgn * (lon - self.lon_0))
        return sgn * rho * torch.sin(lam), -sgn * rho * torch.cos(lam)


def parse_proj(s: str) -> PolarStereo:
    kv = dict(tok.lstrip("+").split("=", 1) for tok in s.split()
              if "=" in tok)
    if kv.get("proj") != "stere" or abs(float(kv["lat_0"])) != 90.0:
        raise ValueError(f"the reference projects polar stereographic only: "
                         f"{s!r}")
    return PolarStereo(lon_0=float(kv.get("lon_0", 0.0)),
                       lat_ts=float(kv["lat_ts"]),
                       south=float(kv["lat_0"]) < 0)


@dataclasses.dataclass
class Lattice:
    """A rectangular ice lattice: borders ``xb`` (nx + 1) and ``yb``
    (ny + 1) in metres, cells flat in row-major (y, x) order."""

    xb: torch.Tensor
    yb: torch.Tensor
    proj: PolarStereo

    @property
    def nx(self):
        return self.xb.numel() - 1

    @property
    def ny(self):
        return self.yb.numel() - 1

    @property
    def n(self):
        return self.nx * self.ny

    def cell_areas(self):
        dx, dy = torch.diff(self.xb), torch.diff(self.yb)
        return (dy[:, None] * dx[None, :]).reshape(-1)


@dataclasses.dataclass
class Exchange:
    """Exchange cells of one sheet: A cell, ice cell, plane area; and each
    A cell's spherical over projected area (the correctA factor)."""

    iA: torch.Tensor
    iI: torch.Tensor
    area: torch.Tensor
    cA: torch.Tensor
    nA: int
    nI: int


def a_rings(lonb, latb, subdiv, device):
    """(nA, 4 subdiv, 2) lon/lat rings, counter-clockwise in lon/lat, cells
    in (lat, lon) row-major order."""
    lonb = torch.tensor(lonb, dtype=torch.float64, device=device)
    latb = torch.tensor(latb, dtype=torch.float64, device=device)
    lat0, lon0 = torch.meshgrid(latb[:-1], lonb[:-1], indexing="ij")
    lat1, lon1 = torch.meshgrid(latb[1:], lonb[1:], indexing="ij")
    f = torch.arange(subdiv, dtype=torch.float64, device=device) / subdiv
    f = f[None, None, :]
    lo0, lo1, la0, la1 = (v[..., None] for v in (lon0, lon1, lat0, lat1))
    pts = [(lo0 + (lo1 - lo0) * f, la0.expand_as(lo0 + f)),
           (lo1.expand_as(lo1 + f), la0 + (la1 - la0) * f),
           (lo1 + (lo0 - lo1) * f, la1.expand_as(lo1 + f)),
           (lo0.expand_as(lo0 + f), la1 + (la0 - la1) * f)]
    lon = torch.cat([p[0] for p in pts], dim=-1).reshape(-1, 4 * subdiv)
    lat = torch.cat([p[1] for p in pts], dim=-1).reshape(-1, 4 * subdiv)
    return lon, lat


def native_areas(lonb, latb, device, R=EQ_RAD):
    """(nA,) spherical cell areas: R^2 (sin lat1 - sin lat0) dlon."""
    lonb = torch.tensor(lonb, dtype=torch.float64, device=device)
    latb = torch.tensor(latb, dtype=torch.float64, device=device)
    ds = torch.diff(torch.sin(torch.deg2rad(latb)))
    dl = torch.deg2rad(torch.diff(lonb))
    return (R * R * ds[:, None] * dl[None, :]).reshape(-1)


def shoelace(x, y, n=None):
    """Signed areas of rings (B, V); with ``n`` (B,) only the first n[b]
    vertices of ring b count."""
    if n is None:
        return 0.5 * (x * torch.roll(y, -1, 1) - torch.roll(x, -1, 1) * y
                      ).sum(1)
    V = x.shape[1]
    k = torch.arange(V, device=x.device)[None, :]
    nxt = torch.where(k + 1 < n[:, None], k + 1, 0).expand(x.shape[0], V)
    x1, y1 = torch.gather(x, 1, nxt), torch.gather(y, 1, nxt)
    term = torch.where(k < n[:, None], x * y1 - x1 * y, 0.0)
    return 0.5 * term.sum(1)


def _clip_half(px, py, n, axis, bound, keep_ge):
    """One Sutherland-Hodgman pass: rings (B, V) with n (B,) vertices
    against ``coordinate >= bound`` (``keep_ge``) or ``<= bound``."""
    B, V = px.shape
    k = torch.arange(V, device=px.device)[None, :]
    valid = k < n[:, None]
    nxt = torch.where(k + 1 < n[:, None], k + 1, 0).expand(B, V)
    qx, qy = torch.gather(px, 1, nxt), torch.gather(py, 1, nxt)
    c, d = (px, qx) if axis == 0 else (py, qy)
    s = 1.0 if keep_ge else -1.0
    in_c = s * (c - bound) >= 0
    in_d = s * (d - bound) >= 0
    den = torch.where(d != c, d - c, 1.0)
    t = (bound - c) / den
    ix, iy = px + t * (qx - px), py + t * (qy - py)
    if axis == 0:
        ix = bound.expand(B, V).clone()
    else:
        iy = bound.expand(B, V).clone()
    emit_c = valid & in_c
    emit_i = valid & (in_c != in_d)
    ox = torch.stack([px, ix], dim=2).reshape(B, 2 * V)
    oy = torch.stack([py, iy], dim=2).reshape(B, 2 * V)
    em = torch.stack([emit_c, emit_i], dim=2).reshape(B, 2 * V)
    pos = torch.cumsum(em.to(torch.int64), 1) - 1
    n_out = em.sum(1)
    W = max(int(n_out.max()) if B else 0, 1)
    pos = torch.where(em, pos, W)                  # a dump column
    rx = torch.zeros((B, W + 1), dtype=px.dtype, device=px.device)
    ry = torch.zeros_like(rx)
    rx.scatter_(1, pos, ox)
    ry.scatter_(1, pos, oy)
    return rx[:, :W], ry[:, :W], n_out


def clip_areas(px, py, rects, rnd):
    """|area| of each ring (B, V) clipped to its rectangle (B, 4) =
    (x0, y0, x1, y1); both recentred on the rectangle first."""
    cx = 0.5 * (rects[:, 0] + rects[:, 2])
    cy = 0.5 * (rects[:, 1] + rects[:, 3])
    px, py = rnd(px - cx[:, None]), rnd(py - cy[:, None])
    r = rnd(rects - torch.stack([cx, cy, cx, cy], dim=1))
    n = torch.full((px.shape[0],), px.shape[1], dtype=torch.int64,
                   device=px.device)
    for axis, col, ge in ((0, 0, True), (0, 2, False), (1, 1, True),
                          (1, 3, False)):
        # the bound is per ring: clip with a (B, 1) column
        px, py, n = _clip_half(px, py, n, axis, r[:, col:col + 1], ge)
    return shoelace(px, py, n).abs()


def exchange_grid(lonb, latb, lat: Lattice, prec, subdiv=2) -> Exchange:
    """The exchange grid of the A grid (lonb, latb) against ``lat``."""
    dev = lat.xb.device
    g = prec.geom
    lon, latd = a_rings(lonb, latb, subdiv, dev)
    x, y = lat.proj.forward(lon, latd)
    finite = torch.isfinite(x).all(1) & torch.isfinite(y).all(1)
    x = torch.where(finite[:, None], x, 0.0)
    y = torch.where(finite[:, None], y, 0.0)
    flip = shoelace(x, y) < 0
    x = torch.where(flip[:, None], x.flip(1), x)
    y = torch.where(flip[:, None], y.flip(1), y)
    xb, yb = lat.xb, lat.yb
    diag = math.hypot(float(xb[-1] - xb[0]), float(yb[-1] - yb[0]))
    mx, my = 0.5 * float(xb[0] + xb[-1]), 0.5 * float(yb[0] + yb[-1])
    far = torch.hypot(x - mx, y - my).amax(1)
    bx0, bx1, by0, by1 = x.amin(1), x.amax(1), y.amin(1), y.amax(1)
    keep = (finite & (far < 50.0 * diag) & (bx1 > xb[0]) & (bx0 < xb[-1])
            & (by1 > yb[0]) & (by0 < yb[-1]))
    native = native_areas(lonb, latb, dev)
    proj_area = torch.where(keep, shoelace(x, y).abs(), native)
    cA = native / torch.where(proj_area > 0, proj_area, 1.0)

    # candidate pairs: each kept A cell's box as a window of the lattice
    idx = torch.nonzero(keep).reshape(-1)
    ix0 = (torch.searchsorted(xb, bx0[idx], right=True) - 1).clamp(
        0, lat.nx - 1)
    ix1 = torch.searchsorted(xb, bx1[idx]).clamp(1, lat.nx)
    iy0 = (torch.searchsorted(yb, by0[idx], right=True) - 1).clamp(
        0, lat.ny - 1)
    iy1 = torch.searchsorted(yb, by1[idx]).clamp(1, lat.ny)
    wx, wy = ix1 - ix0, iy1 - iy0
    cnt = wx * wy
    pa = torch.repeat_interleave(idx, cnt)
    start = torch.cumsum(cnt, 0) - cnt
    loc = torch.arange(int(cnt.sum()), device=dev) - torch.repeat_interleave(
        start, cnt)
    wxr = torch.repeat_interleave(wx, cnt)
    pi = ((torch.repeat_interleave(iy0, cnt) + loc // wxr) * lat.nx
          + torch.repeat_interleave(ix0, cnt) + loc % wxr)

    areas = torch.empty(pa.numel(), dtype=torch.float64, device=dev)
    jy, jx = pi // lat.nx, pi % lat.nx
    for s in range(0, pa.numel(), CHUNK):
        e = min(s + CHUNK, pa.numel())
        a, j, i = pa[s:e], jy[s:e], jx[s:e]
        rects = torch.stack([xb[i], yb[j], xb[i + 1], yb[j + 1]], dim=1)
        areas[s:e] = clip_areas(x[a].to(g), y[a].to(g), rects.to(g),
                                prec.rnd).to(torch.float64)

    cell = lat.cell_areas()
    ok = areas > MIN_AREA_FRAC * cell[pi]
    pa, pi, areas = pa[ok], pi[ok], areas[ok]
    col = torch.zeros(lat.n, dtype=torch.float64, device=dev).index_add_(
        0, pi, areas)
    rel = (col - cell).abs() / cell
    scale = torch.where((col > 0) & (rel < COVERAGE_TOL),
                        cell / torch.where(col > 0, col, 1.0), 1.0)
    return Exchange(iA=pa, iI=pi, area=areas * scale[pi], cA=cA,
                    nA=len(native), nI=lat.n)
