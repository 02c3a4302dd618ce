"""Exchange-grid construction: the port's own copy of the host stages of
``icebin_tpu/grid/exchange.py`` (numpy, bit-identical), and the builds
through the port's clip kernels.

Reference: ``GridGen_Exchange`` / the ``overlap`` CLI build the exchange grid
by exact CGAL polygon intersection (``slib/icebin/gridgen/GridGen_Exchange.*``
[U]; SURVEY.md section 3.1).  Here, as in the reference package:

* XY clip side: ``prepare_subject_polygons`` -> ``candidate_pairs`` -> the
  rectangle clip -> ``assemble_exchange_grid`` (degenerate-overlap cut,
  f64 conservation repair, A ordering);
* generic-polygon clip side: ``decompose_concave`` (concave cells become
  convex pieces) and ``_polys_to_plane`` -> the bucket-grid pairing
  (``polyclip_pairs``) -> the convex clip -> the piece aggregation ->
  ``assemble_exchange_grid``;
* lat-lon x lat-lon and XY x XY in one plane: the exact separable builders,
  no clip.

``make_exchange_grid`` clips on ``device`` through the port's kernels (the
plain PyTorch versions on the CPU); ``make_exchange_grid_host`` is the f64
numpy build with the oracle clip (the reference's ``engine="numpy"``),
which the kernel build is checked against.  The reference's other engines
(XLA, Pallas, the C++ host engine) have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from icebin_tpu_torch.grid.decompose import (convexity_defect,
                                             decompose_concave)
from icebin_tpu_torch.grid.spec import (Grid, GridSpecGeneric,
                                        GridSpecLonLat, GridSpecXY)
from icebin_tpu_torch.oracle import clip as _oracle
from icebin_tpu_torch.ops.clip import make_clip_engine, make_polyclip_engine

__all__ = ["ExchangeGrid", "assemble_exchange_grid", "assemble_polyclip",
           "candidate_pairs", "clip_pairs", "clip_poly_host",
           "clip_rect_host", "make_exchange_grid", "make_exchange_grid_host",
           "make_exchange_grid_lonlat", "make_exchange_grid_xy",
           "polyclip_pairs", "polyclip_pieces", "prepare_subject_polygons"]


@dataclasses.dataclass
class ExchangeGrid:
    """Sparse overlap list: exchange cell k = A cell iA[k] x I cell iI[k].

    Areas are in the ice projection plane ('projected' areas in reference
    terms).  Reference equivalent: ``ExchangeGrid`` / ``AbbrGrid`` [U].
    """

    iA: np.ndarray        # (nX,) int32/int64 flat A-cell index
    iI: np.ndarray        # (nX,) flat I-cell index
    area: np.ndarray      # (nX,) f64 overlap area in projection plane
    centroid: np.ndarray  # (nX, 2) f64 overlap centroid in plane (or None)
    nA: int
    nI: int

    @property
    def ncells(self) -> int:
        return len(self.area)

    def area_sums_A(self) -> np.ndarray:
        """Per-A-cell projected area covered by ice cells."""
        return np.bincount(self.iA, weights=self.area, minlength=self.nA)

    def area_sums_I(self) -> np.ndarray:
        """Per-I-cell area covered by A cells (== cell area if A covers it)."""
        return np.bincount(self.iI, weights=self.area, minlength=self.nI)

    def sort_by(self, key: str) -> "ExchangeGrid":
        """Stable sort of exchange cells by parent index ('A' or 'I').
        Deterministic ordering is what makes scatter-adds bit-reproducible
        (SURVEY.md section 5.2)."""
        k = self.iA if key == "A" else self.iI
        order = np.argsort(k, kind="stable")
        return ExchangeGrid(
            iA=self.iA[order], iI=self.iI[order], area=self.area[order],
            centroid=None if self.centroid is None else self.centroid[order],
            nA=self.nA, nI=self.nI)


def _polys_to_plane(specA, projI, subdiv: int):
    """A-cell polygons in the TARGET plane ``projI``.

    Lat-lon / generic subjects project directly; an XY subject in a
    DIFFERENT projection round-trips its plane rings through lon/lat
    (cross-projection exchange, VERDICT r3 missing #3 -- the reference
    reprojects via PROJ [U GridGen_Exchange])."""
    polys_src = specA.cell_polygons(subdiv=subdiv)
    if isinstance(specA, GridSpecXY):
        projA = specA.projection
        if ((projA is None) == (projI is None)
                and (projA is None
                     or projA.to_proj4() == projI.to_proj4())):
            return polys_src                     # already in the plane
        if projA is None or projI is None:
            raise ValueError(
                "cross-projection XY x XY exchange needs a projection on "
                "BOTH grids (one side has projection=None); give the "
                "plane-coordinate grid its projection, or put both grids "
                "in the same plane")
        lon, lat = projA.xy2ll(polys_src[:, :, 0], polys_src[:, :, 1])
        x, y = projI.ll2xy(np.asarray(lon), np.asarray(lat))
    else:
        x, y = projI.ll2xy(polys_src[:, :, 0], polys_src[:, :, 1])
    return np.stack([np.asarray(x), np.asarray(y)], axis=-1)


def prepare_subject_polygons(specA, specI: GridSpecXY, subdiv: int = 2):
    """Project A-cell polygons into the ice plane; return (polys, keep).

    polys: (nA, 4*subdiv, 2) f64 plane coordinates, CCW-oriented.
    keep:  (nA,) bool -- cells with finite projection whose bbox can
           intersect the ice domain (others, e.g. the far hemisphere under a
           polar stereographic projection, are dropped before pairing).
    """
    polys = _polys_to_plane(specA, specI.projection, subdiv)

    finite = np.isfinite(polys).all(axis=(1, 2))
    polys = np.where(finite[:, None, None], polys, 0.0)

    # Enforce CCW orientation in the plane (projection may flip handedness).
    x_ = polys[:, :, 0]
    y_ = polys[:, :, 1]
    sgn = np.sum(x_ * np.roll(y_, -1, axis=1) - np.roll(x_, -1, axis=1) * y_,
                 axis=1)
    polys = np.where((sgn < 0)[:, None, None], polys[:, ::-1, :], polys)

    # Sanity radius: anything projecting absurdly far from the ice domain is
    # a near-antipodal cell whose polygon approximation is meaningless.
    diag = float(np.hypot(specI.xb[-1] - specI.xb[0], specI.yb[-1] - specI.yb[0]))
    cx = 0.5 * float(specI.xb[0] + specI.xb[-1])
    cy = 0.5 * float(specI.yb[0] + specI.yb[-1])
    r = np.hypot(polys[:, :, 0] - cx, polys[:, :, 1] - cy).max(axis=1)
    sane = finite & (r < 50.0 * max(diag, 1e-30))

    bx0 = polys[:, :, 0].min(axis=1)
    bx1 = polys[:, :, 0].max(axis=1)
    by0 = polys[:, :, 1].min(axis=1)
    by1 = polys[:, :, 1].max(axis=1)
    keep = (sane & (bx1 > specI.xb[0]) & (bx0 < specI.xb[-1])
            & (by1 > specI.yb[0]) & (by0 < specI.yb[-1]))
    return polys, keep


def candidate_pairs(specA, specI: GridSpecXY, polysA: np.ndarray,
                    keepA: np.ndarray, maskI: Optional[np.ndarray] = None):
    """All (iA, iI) pairs whose bounding boxes overlap.

    Returns (pairA, pairI) int64 arrays.  Vectorized: each surviving A cell's
    bbox becomes an (ix0:ix1) x (iy0:iy1) window on the ice lattice
    (searchsorted on the border arrays), then the windows are flattened with
    repeat/arange arithmetic -- the whole pairing is O(npairs) numpy, no tree.
    """
    nxI = specI.nx
    idxA = np.nonzero(keepA)[0]
    if len(idxA) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    P = polysA[idxA]
    bx0 = P[:, :, 0].min(axis=1)
    bx1 = P[:, :, 0].max(axis=1)
    by0 = P[:, :, 1].min(axis=1)
    by1 = P[:, :, 1].max(axis=1)
    ix0 = np.clip(np.searchsorted(specI.xb, bx0, side="right") - 1, 0, nxI - 1)
    ix1 = np.clip(np.searchsorted(specI.xb, bx1, side="left"), 1, nxI)
    iy0 = np.clip(np.searchsorted(specI.yb, by0, side="right") - 1, 0,
                  specI.ny - 1)
    iy1 = np.clip(np.searchsorted(specI.yb, by1, side="left"), 1, specI.ny)
    nx = ix1 - ix0
    ny = iy1 - iy0
    counts = nx * ny
    total = int(counts.sum())
    pairA = np.repeat(idxA, counts)
    # Within each A window enumerate (dy, dx) row-major.
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    local = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
    nx_r = np.repeat(nx, counts)
    dx = local % nx_r
    dy = local // nx_r
    pairI = ((np.repeat(iy0, counts) + dy) * nxI
             + np.repeat(ix0, counts) + dx)
    if maskI is not None:
        m = np.asarray(maskI, dtype=bool).reshape(-1)
        sel = m[pairI]
        pairA, pairI = pairA[sel], pairI[sel]
    return pairA, pairI


def _compose_separable(rx, cx, wx, mx, ry, cy, wy, my, n1x, n2x,
                       unit_scale: float = 1.0):
    """Outer-product two 1-D overlap lists into exchange cells.

    Axis-1 = the A side, axis-2 = the I side; flat index = iy*nx + ix on
    both grids.  Returns (iA, iI, area, centroid) with EXACT (product of
    exact 1-D overlaps) areas -- the separable twin of the polygon clipper,
    conservative by construction (reference: the HNTR overlap matrices,
    Gary Russell's Fortran [U modele/hntr]).
    """
    nx_nnz, ny_nnz = len(rx), len(ry)
    iA = (np.repeat(ry, nx_nnz) * n1x + np.tile(rx, ny_nnz)).astype(np.int64)
    iI = (np.repeat(cy, nx_nnz) * n2x + np.tile(cx, ny_nnz)).astype(np.int64)
    area = np.repeat(wy, nx_nnz) * np.tile(wx, ny_nnz) * unit_scale
    cent = np.stack([np.tile(mx, ny_nnz), np.repeat(my, nx_nnz)], axis=-1)
    return iA, iI, area, cent


def _apply_masks(iA, iI, area, cent, maskA, maskI):
    sel = np.ones(len(iA), dtype=bool)
    if maskA is not None:
        sel &= np.asarray(maskA, dtype=bool).reshape(-1)[iA]
    if maskI is not None:
        sel &= np.asarray(maskI, dtype=bool).reshape(-1)[iI]
    if sel.all():
        return iA, iI, area, cent
    return iA[sel], iI[sel], area[sel], cent[sel]


def make_exchange_grid_lonlat(specA: GridSpecLonLat, specI: GridSpecLonLat,
                              repair: bool = True,
                              min_area_frac: float = 1e-13,
                              coverage_tol: float = 1e-3,
                              maskA=None, maskI=None) -> ExchangeGrid:
    """EXACT exchange grid between two lat-lon grids (separable sphere
    measure: lon overlaps x sin-lat overlaps x eq_rad^2 -- no polygon
    clipping, no repair needed for interior cells).  Areas are spherical
    [m^2], matching ``GridSpecLonLat.cell_areas`` (reference: the
    ``overlap`` CLI accepts two lat-lon grids [U GridGen_Exchange]; the
    separable path is the Hntr overlap in exchange-grid form)."""
    from icebin_tpu_torch.regrid.hntr import overlap_1d
    if abs(specA.eq_rad - specI.eq_rad) > 1e-6 * specI.eq_rad:
        raise ValueError("lat-lon grids with different eq_rad")
    fullA = np.isclose(specA.lonb[-1] - specA.lonb[0], 360.0)
    fullI = np.isclose(specI.lonb[-1] - specI.lonb[0], 360.0)
    if fullA and fullI:
        rx, cx, wx, mx = overlap_1d(specA.lonb, specI.lonb, period=360.0,
                                    return_mid=True)
    else:
        # regional: bring I's longitudes into A's branch of the circle
        midA = 0.5 * (specA.lonb[0] + specA.lonb[-1])
        midI = 0.5 * (specI.lonb[0] + specI.lonb[-1])
        sh = 360.0 * np.round((midA - midI) / 360.0)
        rx, cx, wx, mx = overlap_1d(specA.lonb, specI.lonb + sh,
                                    return_mid=True)
    sA = np.sin(np.radians(specA.latb))
    sI = np.sin(np.radians(specI.latb))
    ry, cy, wy, my = overlap_1d(sA, sI, return_mid=True)
    iA, iI, area, cent = _compose_separable(
        rx, cx, np.radians(wx), mx, ry, cy, wy, my,
        specA.nlon, specI.nlon, unit_scale=specI.eq_rad ** 2)
    cent[:, 1] = np.degrees(np.arcsin(np.clip(cent[:, 1], -1.0, 1.0)))
    iA, iI, area, cent = _apply_masks(iA, iI, area, cent, maskA, maskI)
    return assemble_exchange_grid(iA, iI, area, cent, specA, specI,
                                  specI.cell_areas(), repair=repair,
                                  min_area_frac=min_area_frac,
                                  coverage_tol=coverage_tol)


def make_exchange_grid_xy(specA: GridSpecXY, specI: GridSpecXY,
                          repair: bool = True,
                          min_area_frac: float = 1e-13,
                          coverage_tol: float = 1e-3,
                          maskA=None, maskI=None) -> ExchangeGrid:
    """EXACT exchange grid between two Cartesian grids in the SAME
    projection plane (ice-to-ice regridding, e.g. PISM 20 km <-> 5 km):
    separable rectangle overlaps, conservative by construction
    (reference: ``overlap`` on two XY grids [U GridGen_Exchange])."""
    from icebin_tpu_torch.regrid.hntr import overlap_1d
    pA, pI = specA.projection, specI.projection
    if (pA is None) != (pI is None) or (
            pA is not None and pA.to_proj4() != pI.to_proj4()):
        raise ValueError(
            "XY x XY exchange needs both grids in the SAME projection "
            f"plane (got {pA and pA.to_proj4()!r} vs "
            f"{pI and pI.to_proj4()!r}); reproject one grid first")
    rx, cx, wx, mx = overlap_1d(specA.xb, specI.xb, return_mid=True)
    ry, cy, wy, my = overlap_1d(specA.yb, specI.yb, return_mid=True)
    iA, iI, area, cent = _compose_separable(rx, cx, wx, mx, ry, cy, wy, my,
                                            specA.nx, specI.nx)
    iA, iI, area, cent = _apply_masks(iA, iI, area, cent, maskA, maskI)
    return assemble_exchange_grid(iA, iI, area, cent, specA, specI,
                                  specI.cell_areas(), repair=repair,
                                  min_area_frac=min_area_frac,
                                  coverage_tol=coverage_tol)


def clip_pairs(specA, specI, subdiv: int = 2, maskA=None, maskI=None):
    """The pairs the clip sees for an A grid against an XY ice grid:
    (pairA, pairI, subject rings (P, V0, 2) f64, ice cell rectangles
    (P, 4) f64), both in the ice grid's plane."""
    polysA, keepA = prepare_subject_polygons(specA, specI, subdiv=subdiv)
    if maskA is not None:
        keepA = keepA & maskA
    pairA, pairI = candidate_pairs(specA, specI, polysA, keepA, maskI=maskI)
    return pairA, pairI, polysA[pairA], specI.cell_rects()[pairI]


def _chunked(clip_fn, subj, other, chunk):
    """``clip_fn`` over ``chunk`` pairs at a time (bounds the oracle's ring
    buffers as the reference's chunked dispatch does)."""
    areas = np.empty(len(subj), np.float64)
    cents = np.empty((len(subj), 2), np.float64)
    for s in range(0, len(subj), chunk):
        e = min(s + chunk, len(subj))
        areas[s:e], cents[s:e] = clip_fn(subj[s:e], other[s:e])
    return areas, cents


def clip_rect_host(subj: np.ndarray, rect: np.ndarray,
                   chunk: int = 1 << 18):
    """The f64 numpy rectangle clip (``oracle.clip``) of world-coordinate
    pairs, recentred in f64 on the rectangle as the builder recentres them
    (``icebin_tpu/grid/exchange.py:553-565``): (|areas| (B,), centroids
    (B, 2))."""
    def fn(s, r):
        c = 0.5 * (r[:, 0:2] + r[:, 2:4])
        rings = _oracle.clip_polys_rects(s - c[:, None, :],
                                         r - np.concatenate([c, c], axis=1))
        return (np.abs(_oracle.polygon_areas(rings)),
                _oracle.polygon_centroids(rings) + c)
    return _chunked(fn, np.asarray(subj, np.float64),
                    np.asarray(rect, np.float64), chunk)


def clip_poly_host(subj: np.ndarray, clip: np.ndarray,
                   chunk: int = 1 << 18):
    """The f64 numpy convex clip (``oracle.clip``) of world-coordinate
    pairs, recentred in f64 on the clip ring as the builder recentres them
    (``icebin_tpu/grid/exchange.py:416-424``): (|areas| (B,), centroids
    (B, 2)).  What the convex-clip kernel is checked against."""
    def fn(s, q):
        c = q.mean(axis=1)[:, None, :]
        rings = _oracle.clip_polys_polys(s - c, q - c)
        return (np.abs(_oracle.polygon_areas(rings)),
                _oracle.polygon_centroids(rings) + c[:, 0, :])
    return _chunked(fn, np.asarray(subj, np.float64),
                    np.asarray(clip, np.float64), chunk)


def _build(gridA, gridI, subdiv, rect_fn, poly_fn, *, repair,
           min_area_frac, coverage_tol) -> ExchangeGrid:
    """The reference's dispatch (``icebin_tpu/grid/exchange.py:451-570``)
    with the clips given: ``rect_fn(subj, rect)`` for an XY clip side,
    ``poly_fn(subj, clip)`` for a generic one, each returning world
    (|areas|, centroids)."""
    specA = gridA.spec if isinstance(gridA, Grid) else gridA
    specI = gridI.spec if isinstance(gridI, Grid) else gridI
    maskI = gridI.mask if isinstance(gridI, Grid) else None
    maskA = gridA.mask if isinstance(gridA, Grid) else None
    kw = dict(repair=repair, min_area_frac=min_area_frac,
              coverage_tol=coverage_tol)
    if isinstance(specI, GridSpecLonLat) and isinstance(specA,
                                                        GridSpecLonLat):
        return make_exchange_grid_lonlat(specA, specI, maskA=maskA,
                                         maskI=maskI, **kw)
    if isinstance(specI, GridSpecXY) and isinstance(specA, GridSpecXY):
        pA, pI = specA.projection, specI.projection
        if (pA is None) == (pI is None) and (
                pA is None or pA.to_proj4() == pI.to_proj4()):
            return make_exchange_grid_xy(specA, specI, maskA=maskA,
                                         maskI=maskI, **kw)
        # different planes: A's rings reproject into I's and clip below
    if isinstance(specI, GridSpecGeneric):
        pairA, pairI, subj, clip, piece2cell = polyclip_pairs(
            specA, specI, subdiv, maskA, maskI)
        areas, cents = poly_fn(subj, clip)
        return assemble_polyclip(pairA, pairI, areas, cents, piece2cell,
                                 specA, specI, **kw)
    if not isinstance(specI, GridSpecXY):
        raise TypeError("gridI must be an XY (projected Cartesian), "
                        "lat-lon, or generic-polygon grid")
    pairA, pairI, subj, rect = clip_pairs(specA, specI, subdiv, maskA, maskI)
    areas, cents = rect_fn(subj, rect)
    return assemble_exchange_grid(pairA, pairI, areas, cents, specA, specI,
                                  specI.cell_areas(), **kw)


def make_exchange_grid_host(gridA, gridI, subdiv: int = 2, *,
                            repair: bool = True, chunk: int = 1 << 18,
                            min_area_frac: float = 1e-13,
                            coverage_tol: float = 1e-3) -> ExchangeGrid:
    """The f64 numpy build on the host, no kernel (the reference's
    ``make_exchange_grid(..., engine="numpy")``, bit for bit): what the
    kernel build is checked against."""
    return _build(gridA, gridI, subdiv,
                  lambda s, r: clip_rect_host(s, r, chunk),
                  lambda s, q: clip_poly_host(s, q, chunk), repair=repair,
                  min_area_frac=min_area_frac, coverage_tol=coverage_tol)


def make_exchange_grid(gridA, gridI, subdiv: int = 2, *, device,
                       repair: bool = True, chunk: int = 1 << 18,
                       min_area_frac: float = 1e-13,
                       coverage_tol: float = 1e-3) -> ExchangeGrid:
    """Build the exchange grid between ``gridA`` and ``gridI`` (specs or
    ``Grid``s with masks); the clip runs on ``device``, through the
    rectangle kernel for an XY ice grid and the convex-clip kernel for a
    generic one (at most 16 subject and 8 clip vertices).  ``repair``
    rescales each ice cell's overlaps so they sum exactly to the cell area
    whenever the raw sum is within ``coverage_tol`` of full coverage."""
    return _build(gridA, gridI, subdiv,
                  make_clip_engine(device=device, chunk=chunk),
                  make_polyclip_engine(device=device, chunk=chunk),
                  repair=repair, min_area_frac=min_area_frac,
                  coverage_tol=coverage_tol)


# -- generic-polygon clip side ----------------------------------------------

def polyclip_pieces(specI):
    """The clip side of a generic-polygon exchange, as
    ``icebin_tpu/grid/exchange.py:309-319`` makes it: the cells of ``specI``
    in its own plane, CCW, with every concave cell ear-clipped into convex
    triangles.  Returns (pieces (m, Vc, 2) f64, piece2cell (m,)); raises if
    a piece is not convex (a self-intersecting ring)."""
    cells = specI.plane_polygons()
    areasI = specI.plane_areas()
    clips, piece2cell = decompose_concave(cells, areasI)
    bad_p = convexity_defect(clips, np.abs(areasI)[piece2cell])
    if bad_p.any():
        bad = int(piece2cell[np.nonzero(bad_p)[0][0]])
        raise ValueError(f"generic clip cell {bad} is not convex after "
                         "decomposition (self-intersecting ring?)")
    return clips, piece2cell


def polyclip_pairs(specA, specI, subdiv: int = 2, maskA=None, maskI=None):
    """The pairs the convex clip sees for any A grid against a generic
    ``specI`` (the twin of ``clip_pairs``): ``specA``'s cells projected into
    ``specI``'s plane (CCW, non-finite rings zeroed and skipped), paired
    with the clip pieces whose bounding boxes overlap theirs through a
    uniform bucket grid over the pieces (``icebin_tpu/grid/exchange.py:
    321-395``).  Returns (pairA, pairI into the pieces, subject rings
    (P, V0, 2) f64, clip pieces (P, Vc, 2) f64, piece2cell (m,))."""
    clips, piece2cell = polyclip_pieces(specI)
    polysA = _polys_to_plane(specA, specI.projection, subdiv)
    finite = np.isfinite(polysA).all(axis=(1, 2))
    polysA = np.where(finite[:, None, None], polysA, 0.0)
    sgn = np.sum(polysA[:, :, 0] * np.roll(polysA[:, :, 1], -1, axis=1)
                 - np.roll(polysA[:, :, 0], -1, axis=1) * polysA[:, :, 1],
                 axis=1)
    polysA = np.where((sgn < 0)[:, None, None], polysA[:, ::-1, :], polysA)

    # bucket grid over the pieces' bounding boxes, step = their median size
    cb0 = clips.min(axis=1)
    cb1 = clips.max(axis=1)
    dom0 = cb0.min(axis=0)
    dom1 = cb1.max(axis=0)
    step = max(float(np.median(np.max(cb1 - cb0, axis=1))), 1e-30)
    nb = np.maximum(1, np.ceil((dom1 - dom0) / step).astype(np.int64))
    nbx = int(nb[0])

    def bucket_range(lo, hi):
        return (np.clip(((lo - dom0) / step).astype(np.int64), 0, nb - 1),
                np.clip(((hi - dom0) / step).astype(np.int64), 0, nb - 1))

    # pieces -> every bucket they span, sorted by bucket (y-major)
    ci0, ci1 = bucket_range(cb0, cb1)
    span = ci1 - ci0 + 1
    counts = span[:, 0] * span[:, 1]
    rep = np.repeat(np.arange(len(clips)), counts)
    loc = np.arange(int(counts.sum())) - np.repeat(np.cumsum(counts)
                                                   - counts, counts)
    nxs = np.repeat(span[:, 0], counts)
    bkey = ((np.repeat(ci0[:, 1], counts) + loc // nxs) * nbx
            + np.repeat(ci0[:, 0], counts) + loc % nxs)
    order = np.argsort(bkey, kind="stable")
    bkey_s, rep_s = bkey[order], rep[order]

    # subject cells -> the pieces in their bucket window; one bucket row
    # of the window is one contiguous run of the sorted keys
    finA = finite
    if maskA is not None:
        finA = finA & np.asarray(maskA, bool).reshape(-1)
    sb0 = polysA.min(axis=1)
    sb1 = polysA.max(axis=1)
    inside = (finA & (sb1[:, 0] > dom0[0]) & (sb0[:, 0] < dom1[0])
              & (sb1[:, 1] > dom0[1]) & (sb0[:, 1] < dom1[1]))
    idxA = np.nonzero(inside)[0]
    si0, si1 = bucket_range(sb0[idxA], sb1[idxA])
    pa_list, pi_list = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for k, ia in enumerate(idxA):
        rows = np.arange(si0[k, 1], si1[k, 1] + 1) * nbx
        lo = np.searchsorted(bkey_s, rows + si0[k, 0])
        hi = np.searchsorted(bkey_s, rows + si1[k, 0], side="right")
        cc = np.unique(np.concatenate([rep_s[a:b] for a, b in zip(lo, hi)]))
        cc = cc[(cb1[cc, 0] > sb0[ia, 0]) & (cb0[cc, 0] < sb1[ia, 0])
                & (cb1[cc, 1] > sb0[ia, 1]) & (cb0[cc, 1] < sb1[ia, 1])]
        pa_list.append(np.full(len(cc), ia, np.int64))
        pi_list.append(cc.astype(np.int64))
    pairA = np.concatenate(pa_list)
    pairI = np.concatenate(pi_list)
    if maskI is not None:
        sel = np.asarray(maskI, bool).reshape(-1)[piece2cell[pairI]]
        pairA, pairI = pairA[sel], pairI[sel]
    return pairA, pairI, polysA[pairA], clips[pairI], piece2cell


def assemble_polyclip(pairA, pairI, areas, cents, piece2cell, specA, specI,
                      *, repair: bool = True, min_area_frac: float = 1e-13,
                      coverage_tol: float = 1e-3) -> ExchangeGrid:
    """Sum the pieces of each decomposed cell back to it (areas add, as the
    pieces partition the cell; centroids combine area-weighted: reference
    ``exchange.py:426-444``), then ``assemble_exchange_grid``
    against the cells' plane areas."""
    nI = specI.ncells
    cellI = piece2cell[pairI]
    if len(piece2cell) != nI and len(pairA):
        key = pairA * np.int64(nI) + cellI
        uk, first, inv = np.unique(key, return_index=True,
                                   return_inverse=True)
        agg = np.bincount(inv, weights=areas, minlength=len(uk))
        cx = np.bincount(inv, weights=areas * cents[:, 0],
                         minlength=len(uk))
        cy = np.bincount(inv, weights=areas * cents[:, 1],
                         minlength=len(uk))
        safe = np.where(agg > 0, agg, 1.0)
        new_c = np.stack([cx / safe, cy / safe], axis=-1)
        cents = np.where((agg > 0)[:, None], new_c, cents[first])
        areas = agg
        pairA = uk // nI
        cellI = uk % nI
    return assemble_exchange_grid(
        pairA, cellI, areas, cents, specA, specI, specI.plane_areas(),
        repair=repair, min_area_frac=min_area_frac,
        coverage_tol=coverage_tol)


# -- the reference's shared tail ---------------------------------------------

def assemble_exchange_grid(pairA, pairI, areas, cents, specA, specI, areasI,
                           repair: bool = True, min_area_frac: float = 1e-13,
                           coverage_tol: float = 1e-3) -> ExchangeGrid:
    """Shared tail of the host and mesh-sharded builds: degenerate-overlap
    filtering, f64 conservation repair, deterministic A-ordering.  Feeding
    both builds through the same f64 assembly is what makes the sharded
    build bit-identical to the host build (tests/test_sharded_build.py)."""
    # Drop degenerate overlaps (relative to their ice cell's area).
    keep = areas > min_area_frac * areasI[pairI]
    pairA, pairI, areas, cents = pairA[keep], pairI[keep], areas[keep], cents[keep]

    xg = ExchangeGrid(iA=pairA, iI=pairI, area=areas, centroid=cents,
                      nA=specA.ncells, nI=specI.ncells)

    if repair:
        colsum = xg.area_sums_I()
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.abs(colsum - areasI) / areasI
        scale = np.where((colsum > 0) & (rel < coverage_tol),
                         areasI / np.where(colsum > 0, colsum, 1.0), 1.0)
        xg.area = xg.area * scale[xg.iI]

    return xg.sort_by("A")
