"""The system under test, built from a configuration file: the program's
ice lattices and coupler settings.  The GCM grid and the regridder over it
are the kind's (``harness/gcm.py``, ``gcm/<kind>.py``)."""
from __future__ import annotations

import numpy as np


def lattice_shape(sheet: dict, res_km=None):
    """(nx, ny, res_m) of a sheet's lattice; ``res_km`` overrides the
    configured cell size (the CPU tests' toy lattices)."""
    res = 1e3 * res_km if res_km else float(sheet["res_m"])
    nx = int(round((sheet["x1"] - sheet["x0"]) / res))
    ny = int(round((sheet["y1"] - sheet["y0"]) / res))
    return nx, ny, res


def sheet_specs(cfg: dict, res_km=None):
    """{sheet: the program's GridSpecXY of its lattice}."""
    from icebin_tpu_torch.grid import GridSpecXY
    specs = {}
    for s in cfg["sheets"]:
        nx, ny, _ = lattice_shape(s, res_km)
        specs[s["name"]] = GridSpecXY(
            xb=np.linspace(s["x0"], s["x1"], nx + 1),
            yb=np.linspace(s["y0"], s["y1"], ny + 1),
            projection=s["proj"], name=s["name"])
    return specs


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
