"""Exchange-grid build decomposed over ranks (port of
``icebin_tpu/parallel/build.py``).

As in the reference (``build.py:56-192``):

* every candidate pair is owned by the rank that owns its ice cell's row
  (the ice lattice's y axis cut into ceil(ny / ranks)-row blocks), so each
  rank clips only its own pairs;
* every A-cell polygon lives in one HOME block, that of the first rank its
  candidate window touches; the home blocks rotate round a send/recv ring
  (``:151-172``): at ring step s rank d holds block (d - s) mod n and clips
  the pairs whose A cell lives there, the NEXT block's transfer issued
  before this step's clip so the two overlap;
* the clip is the port's rectangle kernel K3 through
  ``ops.clip.make_clip_engine`` (each pair recentred in f64 on its
  rectangle, as the single-rank build does), so each pair's area and
  centroid are the single-rank build's bits;
* the pieces are gathered to every rank, put back in the original pair
  order (``:176-192``) and go through the shared
  ``assemble_exchange_grid``: the result is the single-rank build's
  (``grid.exchange.make_exchange_grid``) bit for bit, on every rank.

Only XY ice grids (rectangle clips), as in the reference (``:70-71``).
"""
from __future__ import annotations

import numpy as np
import torch

from icebin_tpu_torch.grid.exchange import (ExchangeGrid,
                                            assemble_exchange_grid,
                                            candidate_pairs,
                                            prepare_subject_polygons)
from icebin_tpu_torch.grid.spec import Grid, GridSpecXY
from icebin_tpu_torch.ops.clip import make_clip_engine

__all__ = ["sharded_exchange_grid"]


def sharded_exchange_grid(mesh, gridA, gridI, subdiv: int = 2, *,
                          repair: bool = True, chunk: int = 1 << 18,
                          min_area_frac: float = 1e-13,
                          coverage_tol: float = 1e-3) -> ExchangeGrid:
    """Distributed twin of ``grid.exchange.make_exchange_grid`` for an XY
    ice grid: the same arguments (a 1-D ``mesh`` first) and the same result
    on every rank; each rank clips on its mesh device."""
    specA = gridA.spec if isinstance(gridA, Grid) else gridA
    specI = gridI.spec if isinstance(gridI, Grid) else gridI
    maskI = gridI.mask if isinstance(gridI, Grid) else None
    maskA = gridA.mask if isinstance(gridA, Grid) else None
    if not isinstance(specI, GridSpecXY):
        raise TypeError("gridI must be an XY (projected Cartesian) grid")
    n, d = mesh.size, mesh.rank
    kw = dict(repair=repair, min_area_frac=min_area_frac,
              coverage_tol=coverage_tol)

    # -- host index arithmetic, the same on every rank ----------------------
    polysA, keepA = prepare_subject_polygons(specA, specI, subdiv=subdiv)
    if maskA is not None:
        keepA = keepA & maskA
    pairA, pairI = candidate_pairs(specA, specI, polysA, keepA, maskI=maskI)
    rectsI = specI.cell_rects()
    areasI = specI.cell_areas()
    npairs = len(pairA)
    if npairs == 0:
        return assemble_exchange_grid(pairA, pairI, np.zeros(0),
                                      np.zeros((0, 2)), specA, specI,
                                      areasI, **kw)
    V0 = polysA.shape[1]
    ny_l = -(-specI.ny // n)
    owner = (pairI // specI.nx) // ny_l           # rank of the ice row
    home = np.full(specA.ncells, n, dtype=np.int64)
    np.minimum.at(home, pairA, owner)
    shift = owner - home[pairA]                   # ring distance, [0, n)
    n_shift = int(shift.max()) + 1
    # home blocks (n, maxA, V0, 2); loc[a] = slot of cell a in its block
    haspair = home < n
    cells = np.argsort(home, kind="stable")
    cells = cells[haspair[cells]]
    counts = np.bincount(home[haspair], minlength=n)
    maxA = max(int(counts.max(initial=1)), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    loc = np.zeros(specA.ncells, dtype=np.int64)
    loc[cells] = np.arange(len(cells)) - np.repeat(starts, counts)

    # -- this rank's ring: its home block travels d -> d + 1 ----------------
    comm = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    block = np.zeros((maxA, V0, 2))
    mine = cells[home[cells] == d]
    block[loc[mine]] = polysA[mine]
    cur = torch.as_tensor(block, device=comm)
    mine_p = np.nonzero(owner == d)[0]            # my pairs, in pair order
    clip = make_clip_engine(device=mesh.device, chunk=chunk)
    areas = np.zeros(len(mine_p))
    cents = np.zeros((len(mine_p), 2))
    nxt, prv = (d + 1) % n, (d - 1) % n
    for s in range(n_shift):
        pending = (mesh.exchange([(cur, nxt)], [(cur, prv)], wait=False)
                   if s + 1 < n_shift else None)
        at = mine_p[shift[mine_p] == s]           # pairs whose A cell I hold
        if len(at):
            subj = cur.cpu().numpy()[loc[pairA[at]]]
            k = np.searchsorted(mine_p, at)
            areas[k], cents[k] = clip(subj, rectsI[pairI[at]])
        if pending is not None:
            cur = pending()[0].to(comm)

    # -- every rank's pieces, back in pair order ----------------------------
    P = max(int(np.bincount(owner, minlength=n).max()), 1)
    mine_t = torch.zeros((P, 3), dtype=torch.float64)
    mine_t[:len(mine_p), 0] = torch.as_tensor(areas)
    mine_t[:len(mine_p), 1:] = torch.as_tensor(cents)
    got = mesh.all_gather(mine_t.to(comm)).cpu().numpy()
    a_all = np.empty(npairs)
    c_all = np.empty((npairs, 2))
    for r in range(n):
        idx = np.nonzero(owner == r)[0]
        a_all[idx] = got[r, :len(idx), 0]
        c_all[idx] = got[r, :len(idx), 1:]
    return assemble_exchange_grid(pairA, pairI, a_all, c_all, specA, specI,
                                  areasI, **kw)
