"""The system under test, built from a configuration file: the program's
grids, regridder (exchange grids through the clip kernel on the card) and
coupler settings.  Everything that touches ``icebin_tpu_torch`` in set-up
is here."""
from __future__ import annotations

import numpy as np


def lattice_shape(sheet: dict, res_km=None):
    """(nx, ny, res_m) of a sheet's lattice; ``res_km`` overrides the
    configured cell size (the CPU tests' toy lattices)."""
    res = 1e3 * res_km if res_km else float(sheet["res_m"])
    nx = int(round((sheet["x1"] - sheet["x0"]) / res))
    ny = int(round((sheet["y1"] - sheet["y0"]) / res))
    return nx, ny, res


def program_specs(cfg: dict, res_km=None):
    """(specA, {sheet: specI}) as the program's grid specs."""
    from icebin_tpu_torch.grid import GridSpecXY, modele_lonlat_grid
    g = cfg["gcm_grid"]
    specA = modele_lonlat_grid(g["im"], g["jm"])
    sheets = {}
    for s in cfg["sheets"]:
        nx, ny, _ = lattice_shape(s, res_km)
        sheets[s["name"]] = GridSpecXY(
            xb=np.linspace(s["x0"], s["x1"], nx + 1),
            yb=np.linspace(s["y0"], s["y1"], ny + 1),
            projection=s["proj"], name=s["name"])
    return specA, sheets


def regridder(cfg: dict, device, res_km=None):
    """The program's GCMRegridder with every sheet's exchange grid built
    on ``device`` (the clip kernel on the card)."""
    from icebin_tpu_torch import GCMRegridder
    specA, sheets = program_specs(cfg, res_km)
    gr = GCMRegridder(specA, cfg["hcdefs"], device=device)
    for name, specI in sheets.items():
        gr.add_sheet(name, specI, subdiv=cfg["subdiv"])
    return gr


def regen_every(traffic: dict) -> int:
    """The traffic's regeneration period; none is 2**30 steps (bench.py's
    one-way setting)."""
    r = traffic["regen_every"]
    return 1 << 30 if r is None else int(r)


def coupler_config(cfg: dict, traffic: dict):
    from icebin_tpu_torch import CouplerConfig
    return CouplerConfig(dt=float(cfg["dt_seconds"]),
                         regen_every=regen_every(traffic),
                         min_thickness=float(cfg["min_thickness"]),
                         nv=int(cfg["nv"]),
                         defer_ledger=bool(cfg["defer_ledger"]))
