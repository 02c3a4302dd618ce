"""The port's own copy of ``icebin_tpu/grid/proj.py``; it imports nothing of
the reference package.

Map projections, implemented from scratch (no PROJ dependency).

The reference delegates projection to the PROJ C library via proj strings such
as ``"+proj=stere +lat_0=90 +lat_ts=71 +lon_0=-39 +ellps=WGS84"`` stored in
``GridSpec_XY`` (reference: ``slib/icebin/GridSpec.*`` [U], SURVEY.md section 2
"Grid / GridSpec").  The polar stereographic forward/inverse (Snyder 1987,
"Map Projections -- A Working Manual", eqs. 21-33..21-41) is implemented
directly over numpy arrays (f64); the reference's copy also takes JAX arrays,
this one numpy only.

Supported:
  * ``Stereographic`` -- polar aspect (lat_0 = +-90), spherical or ellipsoidal,
    with ``lat_ts`` or ``k0`` scaling.  Covers SeaRISE Greenland
    (lat_0=90 lat_ts=71 lon_0=-39), EPSG:3413, EPSG:3031 (Antarctica).
  * ``PlateCarree`` -- linear lon/lat <-> x/y used for toy Cartesian configs.
Proj-string parsing (`from_proj4`) keeps grid scripts source-compatible in
spirit with the reference's proj strings.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Projection", "Stereographic", "PlateCarree", "from_proj4",
           "EQ_RAD", "WGS84_A", "WGS84_F"]

#: Default spherical Earth radius [m] used by lat-lon grid cell areas.
EQ_RAD = 6.371e6
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563


class Projection:
    """Protocol: forward ``ll2xy(lon_deg, lat_deg)`` / inverse ``xy2ll``."""

    def ll2xy(self, lon, lat):
        raise NotImplementedError

    def xy2ll(self, x, y):
        raise NotImplementedError

    def to_proj4(self) -> str:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PlateCarree(Projection):
    """x = (lon - lon_0) * scale, y = lat * scale.  For toy/test grids only --
    overlap areas computed under this projection are 'plane areas' in degree
    units unless scale converts to metres."""

    scale: float = 1.0
    lon_0: float = 0.0

    def ll2xy(self, lon, lat):
        return (lon - self.lon_0) * self.scale, lat * self.scale

    def xy2ll(self, x, y):
        return x / self.scale + self.lon_0, y / self.scale

    def to_proj4(self) -> str:
        return f"+proj=latlong +lon_0={self.lon_0} +scale={self.scale}"


@dataclasses.dataclass(frozen=True)
class Stereographic(Projection):
    """Polar stereographic projection (Snyder 1987 sections 21).

    Parameters follow proj4 naming.  ``lat_0`` must be +90 or -90 (polar
    aspect).  If ``lat_ts`` is given, the scale is true at that latitude;
    otherwise ``k0`` applies at the pole.  ``f=0`` gives the spherical case
    (all series terms vanish identically), so one code path serves both.
    """

    lon_0: float = 0.0
    lat_0: float = 90.0
    lat_ts: float = None
    k0: float = 1.0
    a: float = WGS84_A
    f: float = WGS84_F
    x_0: float = 0.0
    y_0: float = 0.0

    def __post_init__(self):
        if abs(self.lat_0) != 90.0:
            raise ValueError("only polar aspect (lat_0=+-90) is supported")

    @property
    def south(self) -> bool:
        return self.lat_0 < 0

    @property
    def e(self) -> float:
        return math.sqrt(self.f * (2.0 - self.f))

    def _t(self, lat_rad, xp):
        """Snyder eq. 15-9: isometric colatitude function t(phi)."""
        e = self.e
        sinp = xp.sin(lat_rad)
        t = xp.tan(math.pi / 4.0 - lat_rad / 2.0)
        if e > 0.0:
            t = t / ((1.0 - e * sinp) / (1.0 + e * sinp)) ** (e / 2.0)
        return t

    def _rho_scale(self) -> float:
        """rho = _rho_scale * t(phi).  Precomputed scalar (eqs. 21-33/34)."""
        e = self.e
        if self.lat_ts is None or abs(self.lat_ts) == 90.0:
            return (2.0 * self.a * self.k0
                    / math.sqrt((1.0 + e) ** (1.0 + e) * (1.0 - e) ** (1.0 - e)))
        phi_ts = math.radians(abs(self.lat_ts))
        sin_ts = math.sin(phi_ts)
        m_ts = math.cos(phi_ts) / math.sqrt(1.0 - (e * sin_ts) ** 2)
        t_ts = math.tan(math.pi / 4.0 - phi_ts / 2.0)
        if e > 0.0:
            t_ts /= ((1.0 - e * sin_ts) / (1.0 + e * sin_ts)) ** (e / 2.0)
        return self.a * m_ts / t_ts

    def ll2xy(self, lon, lat):
        xp = np
        lon = xp.asarray(lon)
        lat = xp.asarray(lat)
        sgn = -1.0 if self.south else 1.0
        lam = xp.radians(sgn * (lon - self.lon_0))
        phi = xp.radians(sgn * lat)
        rho = self._rho_scale() * self._t(phi, xp)
        x = rho * xp.sin(lam)
        y = -rho * xp.cos(lam)
        return sgn * x + self.x_0, sgn * y + self.y_0

    def xy2ll(self, x, y):
        xp = np
        sgn = -1.0 if self.south else 1.0
        x = sgn * (xp.asarray(x) - self.x_0)
        y = sgn * (xp.asarray(y) - self.y_0)
        rho = xp.sqrt(x * x + y * y)
        t = rho / self._rho_scale()
        # Conformal latitude chi, then series inverse (Snyder eq. 3-5).
        chi = math.pi / 2.0 - 2.0 * xp.arctan(t)
        e2 = self.e ** 2
        A = e2 / 2.0 + 5.0 * e2**2 / 24.0 + e2**3 / 12.0 + 13.0 * e2**4 / 360.0
        B = 7.0 * e2**2 / 48.0 + 29.0 * e2**3 / 240.0 + 811.0 * e2**4 / 11520.0
        C = 7.0 * e2**3 / 120.0 + 81.0 * e2**4 / 1120.0
        D = 4279.0 * e2**4 / 161280.0
        phi = (chi + A * xp.sin(2.0 * chi) + B * xp.sin(4.0 * chi)
               + C * xp.sin(6.0 * chi) + D * xp.sin(8.0 * chi))
        lam = xp.arctan2(x, -y)
        lon = sgn * xp.degrees(lam) + self.lon_0
        lat = sgn * xp.degrees(phi)
        # Normalize lon into (-180, 180].
        lon = lon - 360.0 * xp.floor((lon + 180.0) / 360.0)
        return lon, lat

    def scale_factor(self, lon, lat):
        """Local linear scale factor k (Snyder eq. 21-32): area distortion of
        the projection is k**2.  Used by `correctA` native/projected ratios."""
        xp = np
        sgn = -1.0 if self.south else 1.0
        phi = xp.radians(sgn * xp.asarray(lat))
        e = self.e
        sinp = xp.sin(phi)
        m = xp.cos(phi) / xp.sqrt(1.0 - (e * sinp) ** 2)
        rho = self._rho_scale() * self._t(phi, xp)
        # k = rho / (a m); at the pole m->0, rho->0: limit handled by caller.
        return rho / (self.a * xp.where(m == 0.0, 1e-300, m))

    def to_proj4(self) -> str:
        s = f"+proj=stere +lat_0={self.lat_0} +lon_0={self.lon_0}"
        if self.lat_ts is not None:
            s += f" +lat_ts={self.lat_ts}"
        if self.k0 != 1.0:
            s += f" +k_0={self.k0}"
        if self.f == 0.0:
            s += f" +R={self.a}"
        elif (self.a, self.f) == (WGS84_A, WGS84_F):
            s += " +ellps=WGS84"
        else:
            s += f" +a={self.a} +f={self.f}"
        if self.x_0 or self.y_0:
            s += f" +x_0={self.x_0} +y_0={self.y_0}"
        return s


def from_proj4(s: str) -> Projection:
    """Parse the subset of proj4 strings the reference's grids use."""
    kv = {}
    for tok in s.split():
        tok = tok.lstrip("+")
        if "=" in tok:
            k, v = tok.split("=", 1)
            kv[k] = v
        else:
            kv[tok] = True
    proj = kv.get("proj")
    if proj in ("latlong", "longlat", "lonlat"):
        return PlateCarree(scale=float(kv.get("scale", 1.0)),
                           lon_0=float(kv.get("lon_0", 0.0)))
    if proj != "stere":
        raise ValueError(f"unsupported projection {proj!r} in {s!r}")
    a, f = WGS84_A, WGS84_F
    if kv.get("ellps") == "WGS84":
        pass
    elif "R" in kv:
        a, f = float(kv["R"]), 0.0
    else:
        if "a" in kv:
            a = float(kv["a"])
        if "f" in kv:
            f = float(kv["f"])
        elif "b" in kv:
            f = 1.0 - float(kv["b"]) / a
        elif "a" in kv:
            f = 0.0  # sphere of given radius
    return Stereographic(
        lon_0=float(kv.get("lon_0", 0.0)),
        lat_0=float(kv.get("lat_0", 90.0)),
        lat_ts=float(kv["lat_ts"]) if "lat_ts" in kv else None,
        k0=float(kv.get("k_0", kv.get("k", 1.0))),
        a=a, f=f,
        x_0=float(kv.get("x_0", 0.0)),
        y_0=float(kv.get("y_0", 0.0)),
    )
