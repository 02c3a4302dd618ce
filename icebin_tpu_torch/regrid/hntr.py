"""The port's own copy of ``icebin_tpu/regrid/hntr.py``; it imports nothing of
the reference package.

Hntr: exact conservative lat-lon <-> lat-lon regridding (ModelE HNTR).

Reference: ``slib/icebin/modele/hntr.*`` [U] ports Gary Russell's HNTR4/
HNTR8 Fortran: conservative regridding between offset regular lat-lon grids,
used throughout the TOPO pipeline and for ModelE atmosphere<->ocean (A<->O)
grid conversion (SURVEY.md section 2 "Hntr").

TPU-native re-design: a lat-lon x lat-lon overlap is SEPARABLE -- the
overlap area of cells (i1,j1) x (i2,j2) is R^2 * lonoverlap(i1,i2) *
sinlat_overlap(j1,j2) exactly.  So instead of porting HNTR's sequential
Fortran index walk, we build two 1-D interval-overlap sparse factors (lon is
periodic; lat works in sin-latitude, where spherical measure is exact) and
emit their outer product as a ``WeightedMatrix``.  This is strictly more
general than HNTR (arbitrary non-uniform border arrays, not just uniform
spacings) and the matrix form composes with everything else in
``regrid`` -- including the device BDT apply.

``Hntr`` (class) keeps the reference's calling convention: regrid B <- A
with optional per-cell source weights WTA (HNTR's masked/weighted mean).
"""
from __future__ import annotations

import numpy as np

from icebin_tpu_torch.grid.spec import GridSpecLonLat
from icebin_tpu_torch.regrid.sparse import WeightedMatrix

__all__ = ["overlap_1d", "hntr_matrix", "Hntr", "hntr_spec"]


def overlap_1d(borders1, borders2, period=None, return_mid=False):
    """Sparse interval overlaps: rows (n1), cols (n2), overlap lengths.

    period: if given (e.g. 360 for lon), intervals wrap; borders must each
    span exactly one period.  ``return_mid``: also return each overlap
    interval's midpoint IN BORDERS1 COORDINATES (exchange-grid centroids).

    O(n1 log n2 + nnz) sorted-merge (searchsorted window per interval), so
    1-minute global base grids (n ~ 21600) cost ~nnz, not a dense n1 x n2
    broadcast -- the TOPO pipeline's ``z1qx1n``-class inputs stay cheap.
    """
    b1 = np.asarray(borders1, dtype=np.float64)
    b2 = np.asarray(borders2, dtype=np.float64)
    shifts = [0.0]
    if period is not None:
        if not (np.isclose(b1[-1] - b1[0], period)
                and np.isclose(b2[-1] - b2[0], period)):
            raise ValueError("periodic axis must span exactly one period")
        shifts = [-period, 0.0, period]
    tol = 1e-14 * max(abs(b1[-1] - b1[0]), 1.0)
    n1, n2 = len(b1) - 1, len(b2) - 1
    idx1 = np.arange(n1)
    rows, cols, vals, mids = [], [], [], []
    for sh in shifts:
        s2 = b2 + sh
        # candidate col window for row i: all j with s2[j] < b1[i+1] and
        # s2[j+1] > b1[i]  (half-open [lo, hi) in j)
        lo = np.maximum(np.searchsorted(s2, b1[:-1], side="right") - 1, 0)
        hi = np.minimum(np.searchsorted(s2, b1[1:], side="left"), n2)
        cnt = np.maximum(hi - lo, 0)
        r = np.repeat(idx1, cnt)
        starts = np.concatenate(([0], np.cumsum(cnt)[:-1]))
        c = (np.arange(cnt.sum()) - np.repeat(starts, cnt)
             + np.repeat(lo, cnt))
        a = np.maximum(b1[r], s2[c])
        b = np.minimum(b1[r + 1], s2[c + 1])
        ov = b - a
        keep = ov > tol
        rows.append(r[keep])
        cols.append(c[keep])
        vals.append(ov[keep])
        if return_mid:
            mids.append(0.5 * (a[keep] + b[keep]))
    out = (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals))
    if return_mid:
        return out + (np.concatenate(mids),)
    return out


def hntr_matrix(specB: GridSpecLonLat, specA: GridSpecLonLat) -> WeightedMatrix:
    """Exact conservative overlap matrix B <- A (unscaled, spherical areas).

    wM = B-cell covered areas, Mw = A-cell covered areas; scaled apply gives
    area-weighted means, reproducing HNTR's output exactly for its grids.
    """
    if not np.isclose(specB.eq_rad, specA.eq_rad):
        raise ValueError("grids must share eq_rad")
    R = specB.eq_rad
    # periodic lon only for global grids; regional lat-lon windows overlap
    # as plain intervals
    is_global = (np.isclose(specB.lonb[-1] - specB.lonb[0], 360.0)
                 and np.isclose(specA.lonb[-1] - specA.lonb[0], 360.0))
    lr, lc, lv = overlap_1d(specB.lonb, specA.lonb,
                            period=360.0 if is_global else None)
    yr, yc, yv = overlap_1d(np.sin(np.radians(specB.latb)),
                            np.sin(np.radians(specA.latb)))
    nlonB = specB.nlon
    nlonA = specA.nlon
    # outer product of the two sparse factors
    nl = len(lv)
    ny = len(yv)
    rows = (np.repeat(yr, nl) * nlonB + np.tile(lr, ny))
    cols = (np.repeat(yc, nl) * nlonA + np.tile(lc, ny))
    vals = (np.repeat(yv, nl) * np.tile(np.radians(lv), ny)) * R * R
    return WeightedMatrix(rows=rows, cols=cols, vals=vals,
                          shape=(specB.ncells, specA.ncells))


class Hntr:
    """Reference-style driver: ``Hntr(specB, specA).regrid(WTA, A)``
    (reference ``Hntr::regrid`` with source weights WTA [U])."""

    def __init__(self, specB: GridSpecLonLat, specA: GridSpecLonLat):
        self.specB = specB
        self.specA = specA
        self.M = hntr_matrix(specB, specA)

    def regrid(self, A, WTA=None, fill=np.nan):
        """Area (and WTA-) weighted conservative mean of A onto grid B.

        A: (..., nA) field; WTA: optional (nA,) source weights (e.g. land
        fraction) -- HNTR's weighted-mean semantics: out = M(w*A)/M(w).
        """
        A = np.asarray(A, dtype=np.float64)
        flat = A.reshape(-1, self.specA.ncells)
        if WTA is None:
            out = self.M.apply(flat, scale=True, fill=fill)
        else:
            w = np.asarray(WTA, dtype=np.float64)
            num = self.M.apply(flat * w[None, :], scale=False)
            den = self.M.apply(np.broadcast_to(w[None, :], flat.shape),
                               scale=False)
            with np.errstate(invalid="ignore", divide="ignore"):
                out = np.where(den != 0, num / np.where(den != 0, den, 1.0),
                               fill)
        return out.reshape(A.shape[:-1] + (self.specB.ncells,))


def hntr_spec(im: int, jm: int, offi_min: float = 0.0,
              dlat_min: float = None, eq_rad=None,
              name: str = None) -> GridSpecLonLat:
    """HNTR-style grid spec (reference ``HntrSpec{im, jm, offi, dlat}`` [U]).

    im/jm: grid size; offi_min: western edge offset east of the date line in
    minutes; dlat_min: latitude spacing in minutes.  When jm*dlat exceeds
    180 deg the outermost borders clip to the poles, producing ModelE's
    half-height polar rows (e.g. im=144, jm=90, dlat=150' would not; ModelE
    2x2.5 uses jm=90 with 2-deg rows offset half a row: dlat=120', centered,
    giving borders -91, -89, ... clipped to -90).
    """
    from icebin_tpu_torch.grid.proj import EQ_RAD
    dlon = 360.0 / im
    lonb = -180.0 + offi_min / 60.0 + dlon * np.arange(im + 1)
    dlat = (dlat_min / 60.0) if dlat_min is not None else 180.0 / jm
    half = dlat * jm / 2.0
    latb = np.clip(-half + dlat * np.arange(jm + 1), -90.0, 90.0)
    # drop duplicate clipped borders is NOT allowed (jm fixed); require
    # at most the outermost rows clip partially
    if (np.diff(latb) <= 0).any():
        raise ValueError("dlat*jm clips more than the polar rows")
    # Clipped polar rows need no special 'cap' treatment: the band-area
    # formula R^2 dlon (sin l2 - sin l1) is already exact for them.
    return GridSpecLonLat(lonb=lonb, latb=latb,
                          eq_rad=eq_rad or EQ_RAD,
                          name=name or f"hntr_{im}x{jm}")
