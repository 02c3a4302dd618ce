"""Exchange-grid construction through the port's clip kernel.

Port of ``icebin_tpu/grid/exchange.py:make_exchange_grid``.  The host
stages are shared with the reference and imported from it (they import no
JAX): ``prepare_subject_polygons`` -> ``candidate_pairs`` -> the clip ->
``assemble_exchange_grid`` (degenerate-overlap cut, f64 conservation
repair, A ordering).  Only the clip runs here, on ``device``.  Grid pairs
with an exact separable path (lat-lon x lat-lon, XY x XY in one plane)
delegate to the reference's exact builders.
"""
from __future__ import annotations

from icebin_tpu.grid import exchange as _shared
from icebin_tpu.grid.spec import Grid, GridSpecGeneric, GridSpecLonLat, \
    GridSpecXY

from icebin_tpu_torch.ops.clip import make_clip_engine

__all__ = ["clip_pairs", "make_exchange_grid", "make_exchange_grid_host"]


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
        raise NotImplementedError(
            "generic-polygon ice grids need the convex-clip kernel "
            "(_polyclip_kernel), not yet ported: see ROADMAP.md Queue 2")
    if not isinstance(specI, GridSpecXY):
        raise TypeError("gridI must be an XY (projected Cartesian), "
                        "lat-lon, or generic-polygon grid")

    pairA, pairI, subj, rect = clip_pairs(specA, specI, subdiv, maskA, maskI)
    areas, cents = make_clip_engine(device=device, chunk=chunk)(subj, rect)
    return _shared.assemble_exchange_grid(
        pairA, pairI, areas, cents, specA, specI, specI.cell_areas(),
        repair=repair, min_area_frac=min_area_frac,
        coverage_tol=coverage_tol)
