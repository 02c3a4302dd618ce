"""GCM grid kind ``modele_lonlat``, the reference's half: ModelE's lat-lon
grid of ``gcm_grid.im`` x ``gcm_grid.jm`` cells (``reference.grid``'s
``modele_bounds``) against a sheet's lattice."""
from __future__ import annotations

from reference import grid as rg


def exchange(cfg: dict, sheet: dict, lattice: rg.Lattice, device, prec,
             data=None) -> rg.Exchange:
    g = cfg["gcm_grid"]
    lonb, latb = rg.modele_bounds(g["im"], g["jm"])
    return rg.exchange_grid(lonb, latb, lattice, prec, subdiv=cfg["subdiv"])
