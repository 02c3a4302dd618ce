"""Exchange-grid construction through the port's clip kernels.

Port of ``icebin_tpu/grid/exchange.py:make_exchange_grid`` and
``:make_exchange_grid_polyclip``.  The host stages are shared with the
reference and imported from it (they import no JAX):

* XY clip side: ``prepare_subject_polygons`` -> ``candidate_pairs`` -> the
  rectangle clip -> ``assemble_exchange_grid`` (degenerate-overlap cut,
  f64 conservation repair, A ordering);
* generic-polygon clip side: ``decompose_concave`` (concave cells become
  convex pieces) and ``_polys_to_plane`` -> the bucket-grid pairing, which
  the reference does inline and the port carries in ``polyclip_pairs`` ->
  the convex clip -> the piece aggregation -> ``assemble_exchange_grid``.

Only the clip runs here, on ``device``.  Grid pairs with an exact separable
path (lat-lon x lat-lon, XY x XY in one plane) delegate to the reference's
exact builders.
"""
from __future__ import annotations

import numpy as np

from icebin_tpu.grid import exchange as _shared
from icebin_tpu.grid.decompose import convexity_defect, decompose_concave
from icebin_tpu.grid.spec import Grid, GridSpecGeneric, GridSpecLonLat, \
    GridSpecXY
from icebin_tpu.oracle import clip as _oracle

from icebin_tpu_torch.ops.clip import make_clip_engine, make_polyclip_engine

__all__ = ["assemble_polyclip", "clip_pairs", "clip_poly_host",
           "make_exchange_grid", "make_exchange_grid_host",
           "make_exchange_grid_polyclip", "polyclip_pieces",
           "polyclip_pairs"]


def clip_pairs(specA, specI, subdiv: int = 2, maskA=None, maskI=None):
    """The pairs the clip sees for an A grid against an XY ice grid:
    (pairA, pairI, subject rings (P, V0, 2) f64, ice cell rectangles
    (P, 4) f64), both in the ice grid's plane."""
    polysA, keepA = _shared.prepare_subject_polygons(specA, specI,
                                                     subdiv=subdiv)
    if maskA is not None:
        keepA = keepA & maskA
    pairA, pairI = _shared.candidate_pairs(specA, specI, polysA, keepA,
                                           maskI=maskI)
    return pairA, pairI, polysA[pairA], specI.cell_rects()[pairI]


def make_exchange_grid_host(gridA, gridI, subdiv: int = 2,
                            **kw) -> _shared.ExchangeGrid:
    """The reference's f64 numpy build on the host (no kernel): what the
    clip build is checked against."""
    return _shared.make_exchange_grid(gridA, gridI, subdiv=subdiv,
                                      engine="numpy", **kw)


def make_exchange_grid(gridA, gridI, subdiv: int = 2, *, device,
                       repair: bool = True, chunk: int = 1 << 18,
                       min_area_frac: float = 1e-13,
                       coverage_tol: float = 1e-3) -> _shared.ExchangeGrid:
    """Build the exchange grid between ``gridA`` and ``gridI`` (specs or
    ``Grid``s with masks); the clip runs on ``device``."""
    specA = gridA.spec if isinstance(gridA, Grid) else gridA
    specI = gridI.spec if isinstance(gridI, Grid) else gridI
    maskI = gridI.mask if isinstance(gridI, Grid) else None
    maskA = gridA.mask if isinstance(gridA, Grid) else None
    exact_ll = (isinstance(specA, GridSpecLonLat)
                and isinstance(specI, GridSpecLonLat))
    exact_xy = (isinstance(specA, GridSpecXY) and isinstance(specI, GridSpecXY)
                and (specA.projection is None) == (specI.projection is None)
                and (specA.projection is None
                     or specA.projection.to_proj4()
                     == specI.projection.to_proj4()))
    if exact_ll or exact_xy:
        # separable exact paths: no clip, the engine is never consulted
        return make_exchange_grid_host(
            gridA, gridI, subdiv=subdiv, repair=repair,
            min_area_frac=min_area_frac, coverage_tol=coverage_tol)
    if isinstance(specI, GridSpecGeneric):
        return make_exchange_grid_polyclip(
            specA, specI, subdiv=subdiv, device=device, repair=repair,
            chunk=chunk, min_area_frac=min_area_frac,
            coverage_tol=coverage_tol, maskA=maskA, maskI=maskI)
    if not isinstance(specI, GridSpecXY):
        raise TypeError("gridI must be an XY (projected Cartesian), "
                        "lat-lon, or generic-polygon grid")

    pairA, pairI, subj, rect = clip_pairs(specA, specI, subdiv, maskA, maskI)
    areas, cents = make_clip_engine(device=device, chunk=chunk)(subj, rect)
    return _shared.assemble_exchange_grid(
        pairA, pairI, areas, cents, specA, specI, specI.cell_areas(),
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
    polysA = _shared._polys_to_plane(specA, specI.projection, subdiv)
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


def clip_poly_host(subj: np.ndarray, clip: np.ndarray):
    """The reference's f64 numpy convex clip (``icebin_tpu.oracle.clip``)
    of world-coordinate pairs, recentred in f64 on the clip ring as the
    builder recentres them: (|areas| (B,), centroids (B, 2)).  What the
    convex-clip kernel is checked against."""
    c = np.asarray(clip, np.float64).mean(axis=1)[:, None, :]
    rings = _oracle.clip_polys_polys(np.asarray(subj, np.float64) - c,
                                     np.asarray(clip, np.float64) - c)
    return (np.abs(_oracle.polygon_areas(rings)),
            _oracle.polygon_centroids(rings) + c[:, 0, :])


def assemble_polyclip(pairA, pairI, areas, cents, piece2cell, specA, specI,
                      *, repair: bool = True, min_area_frac: float = 1e-13,
                      coverage_tol: float = 1e-3) -> _shared.ExchangeGrid:
    """Sum the pieces of each decomposed cell back to it (areas add, as the
    pieces partition the cell; centroids combine area-weighted: reference
    ``exchange.py:426-444``), then the shared ``assemble_exchange_grid``
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
    return _shared.assemble_exchange_grid(
        pairA, cellI, areas, cents, specA, specI, specI.plane_areas(),
        repair=repair, min_area_frac=min_area_frac,
        coverage_tol=coverage_tol)


def make_exchange_grid_polyclip(specA, specI, subdiv: int = 2, *, device,
                                repair: bool = True, chunk: int = 1 << 18,
                                min_area_frac: float = 1e-13,
                                coverage_tol: float = 1e-3, maskA=None,
                                maskI=None) -> _shared.ExchangeGrid:
    """Exchange grid with a generic-polygon grid as the clip side (any A
    grid x ``GridSpecGeneric`` with a ``projection``, the measurement
    plane): ``polyclip_pairs``, the convex clip on ``device`` (at most 16
    subject and 8 clip vertices), ``assemble_polyclip``."""
    pairA, pairI, subj, clip, piece2cell = polyclip_pairs(
        specA, specI, subdiv, maskA, maskI)
    areas, cents = make_polyclip_engine(device=device, chunk=chunk)(subj,
                                                                    clip)
    return assemble_polyclip(pairA, pairI, areas, cents, piece2cell, specA,
                             specI, repair=repair,
                             min_area_frac=min_area_frac,
                             coverage_tol=coverage_tol)
