"""The port's own copy of ``icebin_tpu/regrid/matrices.py``; it imports
nothing of the reference package.

RegridMatrices: the factory composing exchange-grid overlaps into the
user-facing A/E/I regrid matrices.

Reference: ``RegridMatrices::matrix(name, params)`` composes elementary
per-exchange-cell matrices (GvI, GvAp, GvEp from ``IceRegridder_L0``) with
diagonal weight inversions into "AvI", "IvA", "EvI", "IvE", "AvE", "EvA"
(reference: ``slib/icebin/RegridMatrices.cpp``, ``IceRegridder_L0.cpp`` [U];
SURVEY.md sections 2-3).  TPU-native re-design: because every exchange cell
has exactly one A parent and one I parent, all six compositions collapse to
*direct vectorized maps over the exchange-cell list* -- no general sparse
GEMM is needed (the only true composition is the optional conservative
smoother).  The build is host-side f64 numpy (exact, cached); the hot apply
path runs on TPU via ``icebin_tpu.ops.spmv``.

Mathematical semantics (documented invariants, enforced by tests):

* Exchange cell x = (a(x), i(x)) with plane overlap area o_x.
* Elevation classes: ice cell i with elevation eps_i splits linearly between
  the bracketing class boundaries ``hcdefs[k] <= eps_i < hcdefs[k+1]``:
  weights (1-t, t) on E cells (a, k), (a, k+1); clamped outside the range.
  E flat index = a * nhc + ihc (a-major: an A cell's elevation classes are
  ADJACENT, which is what gives the BDT apply its small-window locality;
  ModelE's (i,j,ihc) ihc-major layout is a fixed permutation applied at the
  ModelE adapter boundary -- ``models.modele_adapter``).
* Unscaled M entries are overlap areas (times EC split weights); ``correctA``
  multiplies the A-side factor by c_a = native_area_a / projected_area_a so
  weights measure true spherical area instead of plane area.
* ``wM`` = row sums, ``Mw`` = column sums, always; ``scale=True`` divides by
  ``wM`` (dest means).  Conservation identities then hold exactly for every
  matrix by construction.
* Masking: exchange cells whose ice cell has no ice (NaN in ``elevmaskI``)
  are excluded from every matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from icebin_tpu_torch.grid.exchange import ExchangeGrid
from icebin_tpu_torch.regrid.sparse import WeightedMatrix

__all__ = ["RegridParams", "RegridMatrices", "elevation_class_split"]

_NAMES = ("AvI", "IvA", "EvI", "IvE", "AvE", "EvA", "AvG", "GvA", "IvG", "GvI")


@dataclasses.dataclass(frozen=True)
class RegridParams:
    """Reference: ``RegridParams{scale, correctA, sigma[3]}`` [U]."""

    scale: bool = True
    correctA: bool = True
    #: (sigma_x, sigma_y[, sigma_z]) -- plane metres for x/y, metres of
    #: ELEVATION for z (the reference's full sigma[3]; see ops.smoother)
    sigma: Optional[Tuple[float, ...]] = None


def elevation_class_split(elev, hcdefs):
    """Linear-in-elevation split of each ice point between bracketing classes.

    Returns (k0, k1, w0, w1): class indices and weights, vectorized.
    Reference: the GvEp elevation interpolation in ``IceRegridder_L0`` [U].
    """
    elev = np.asarray(elev, dtype=np.float64)
    hcdefs = np.asarray(hcdefs, dtype=np.float64)
    nhc = len(hcdefs)
    if nhc == 1:
        z = np.zeros(elev.shape, dtype=np.int64)
        return z, z, np.ones_like(elev), np.zeros_like(elev)
    k = np.clip(np.searchsorted(hcdefs, elev, side="right") - 1, 0, nhc - 2)
    denom = hcdefs[k + 1] - hcdefs[k]
    t = np.clip((elev - hcdefs[k]) / denom, 0.0, 1.0)
    return k, k + 1, 1.0 - t, t


class RegridMatrices:
    """Per-ice-sheet matrix factory bound to an elevation mask.

    Reference: ``RegridMatrices_Dynamic`` created by
    ``GCMRegridder::regrid_matrices(sheet, elevmaskI)`` [U].
    """

    def __init__(self, xg: ExchangeGrid, elevmaskI, hcdefs,
                 areaA_native, areaA_proj, areaI=None,
                 smoothing_matrix_fn=None):
        """
        xg: exchange grid (A x I overlaps, plane areas, f64).
        elevmaskI: (nI,) ice-surface elevation where ice exists, NaN elsewhere.
        hcdefs: (nhc,) elevation-class boundaries [m].
        areaA_native / areaA_proj: (nA,) spherical / projected-plane full-cell
            areas of the A grid (for correctA).
        areaI: (nI,) native (plane) ice cell areas (for the smoother and
            diagnostics).
        smoothing_matrix_fn: callable(sigma) -> scipy-like sparse (nI, nI)
            conservative smoother over the ice grid (see ops.smoother).
        """
        self.elevmaskI = np.asarray(elevmaskI, dtype=np.float64).reshape(-1)
        self.hcdefs = np.asarray(hcdefs, dtype=np.float64)
        self.nA = xg.nA
        self.nI = xg.nI
        self.nhc = len(self.hcdefs)
        self.nE = self.nA * self.nhc
        self.areaA_native = np.asarray(areaA_native, dtype=np.float64)
        self.areaA_proj = np.asarray(areaA_proj, dtype=np.float64)
        self.areaI = areaI
        self._smoothing_fn = smoothing_matrix_fn

        # Mask: keep exchange cells over iced cells only.
        icy = np.isfinite(self.elevmaskI)
        keep = icy[xg.iI]
        #: indices into the (unmasked) exchange grid of the kept cells --
        #: the correspondence E1vE0 uses to match old/new EC splits.
        self.xg_index = np.nonzero(keep)[0]
        self.iA = xg.iA[keep]
        self.iI = xg.iI[keep]
        self.o = xg.area[keep]
        if xg.centroid is not None:
            self.centroid = xg.centroid[keep]
        else:
            self.centroid = None

        # Elevation-class split per (kept) exchange cell.
        elev_x = self.elevmaskI[self.iI]
        k0, k1, w0, w1 = elevation_class_split(elev_x, self.hcdefs)
        self.iE0 = self.iA * self.nhc + k0
        self.iE1 = self.iA * self.nhc + k1
        self.wE0 = w0
        self.wE1 = w1

    # -- factory -----------------------------------------------------------

    def matrix(self, spec_name: str,
               params: RegridParams = RegridParams()) -> WeightedMatrix:
        """Build one of AvI, IvA, EvI, IvE, AvE, EvA (+ G-space variants).

        Returned matrix is UNSCALED (integral form) -- pair it with
        ``.apply(f, scale=params.scale)`` or the TPU apply op.  ``params`` is
        captured into entry values (correctA, sigma); ``scale`` is applied at
        apply time exactly as the reference separates M from wM.
        """
        if spec_name not in _NAMES:
            raise ValueError(f"unknown regrid matrix {spec_name!r}; "
                             f"expected one of {_NAMES}")
        dest, src = spec_name[0], spec_name[2]
        cA = self.areaA_native / np.where(self.areaA_proj > 0,
                                          self.areaA_proj, 1.0)

        o = self.o
        if src == "E" or dest == "E":
            # Two entries per exchange cell (EC split).
            rows_ice = np.concatenate([self.iI, self.iI])
            ecols = np.concatenate([self.iE0, self.iE1])
            vals = np.concatenate([o * self.wE0, o * self.wE1])
            arows = np.concatenate([self.iA, self.iA])
        else:
            rows_ice = self.iI
            ecols = None
            vals = o.copy()
            arows = self.iA

        def side_index(space):
            if space == "I" or space == "G":
                return rows_ice, self.nI
            if space == "A":
                return arows, self.nA
            if space == "E":
                return ecols, self.nE
            raise AssertionError(space)

        didx, nd = side_index(dest)
        sidx, ns = side_index(src)
        if dest == "G" or src == "G":
            # Exchange-grid-space matrices (elementary GvI, GvA, ...):
            # G rows are the exchange cells themselves.
            g = np.arange(len(self.o), dtype=np.int64)
            if src == "E" or dest == "E":
                g = np.concatenate([g, g])
            if dest == "G":
                didx, nd = g, len(self.o)
            else:
                sidx, ns = g, len(self.o)

        if params.correctA:
            # Scale the A-side factor by native/projected ratio.
            if dest == "A" or dest == "E":
                vals = vals * cA[arows]
            elif src == "A" or src == "E":
                vals = vals * cA[arows]

        M = WeightedMatrix(rows=didx, cols=sidx, vals=vals, shape=(nd, ns))

        if params.sigma is not None:
            if self._smoothing_fn is None:
                raise ValueError("sigma requested but no smoothing_matrix_fn")
            S = self._smoothing_fn(params.sigma)  # scipy sparse (nI, nI)
            # Compose the ice-side smoother conservatively on whichever side
            # is the ice grid: dest-I matrices smooth the regridded OUTPUT
            # (S M); ice-SOURCE matrices (AvI/EvI/GvI) smooth the input ice
            # field first (M S).  Matrices with no ice side (AvE/EvA) cannot
            # take sigma -- same constraint as the reference [U].
            if dest == "I":
                M = WeightedMatrix.from_scipy(S @ M.to_scipy())
            elif src == "I":
                M = WeightedMatrix.from_scipy(M.to_scipy() @ S)
            else:
                raise ValueError(
                    f"sigma smoothing needs an ice side; {spec_name} has "
                    f"none")
        return M

    # -- diagnostics -------------------------------------------------------

    def ec_weights(self) -> np.ndarray:
        """(nE,) f64 EC measure: plane overlap area per E cell (no
        correctA) -- the measure fhc, elevE, and the coupler's E1vE0
        held-state ledger all share."""
        w = np.zeros(self.nE)
        np.add.at(w, self.iE0, self.o * self.wE0)
        np.add.at(w, self.iE1, self.o * self.wE1)
        return w

    def fhc(self) -> np.ndarray:
        """(nhc, nA) fraction of each A cell's (projected) area in each EC --
        the ModelE ``fhc`` field (SURVEY.md section 2 TOPO pipeline).
        Memoized: the factory's exchange data is immutable, and the
        stepwise coupler returns fhc EVERY step (it only changes at
        matrix regeneration -- ~20 ms of host scatters otherwise)."""
        if getattr(self, "_fhc_cache", None) is None:
            w = self.ec_weights()
            wA = np.zeros(self.nA)
            np.add.at(wA, self.iA, self.o)
            with np.errstate(invalid="ignore", divide="ignore"):
                f = (w.reshape(self.nA, self.nhc).T
                     / np.where(wA > 0, wA, 1.0))
            self._fhc_cache = np.where(wA[None, :] > 0, f, 0.0)
        return self._fhc_cache

    def elevE(self) -> np.ndarray:
        """(nhc, nA) mean ice elevation of each realized EC (ModelE elevE).
        Memoized like ``fhc``."""
        if getattr(self, "_elevE_cache", None) is None:
            w = np.zeros(self.nE)
            we = np.zeros(self.nE)
            elev_x = self.elevmaskI[self.iI]
            np.add.at(w, self.iE0, self.o * self.wE0)
            np.add.at(w, self.iE1, self.o * self.wE1)
            np.add.at(we, self.iE0, self.o * self.wE0 * elev_x)
            np.add.at(we, self.iE1, self.o * self.wE1 * elev_x)
            with np.errstate(invalid="ignore", divide="ignore"):
                e = we / np.where(w > 0, w, 1.0)
            self._elevE_cache = np.where(w > 0, e,
                                         np.nan).reshape(self.nA,
                                                         self.nhc).T
        return self._elevE_cache
