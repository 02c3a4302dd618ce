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


#: the program's default regrid parameters (``CouplerConfig.params``),
#: which a configuration without ``params`` runs
DEFAULT_PARAMS = {"scale": True, "correctA": True, "sigma": None}


class ParamsError(ValueError):
    """A configuration's ``params`` are malformed, or its traffic's driver
    cannot hand them to the program."""


def regrid_params(cfg: dict) -> dict:
    """The configuration's regrid parameters as plain values: its
    ``params`` over ``DEFAULT_PARAMS``; ``sigma`` None or a tuple of 2 or 3
    floats (plane metres in x and y, metres of elevation in z)."""
    given = cfg.get("params", {})
    unknown = sorted(set(given) - set(DEFAULT_PARAMS))
    if unknown:
        raise ParamsError(f"configuration {cfg['name']!r}: params has "
                          f"{unknown}; it takes {sorted(DEFAULT_PARAMS)}")
    p = {**DEFAULT_PARAMS, **given}
    if p["sigma"] is not None:
        p["sigma"] = tuple(float(s) for s in p["sigma"])
        if len(p["sigma"]) not in (2, 3):
            raise ParamsError(f"configuration {cfg['name']!r}: params.sigma "
                              f"{list(p['sigma'])} has not 2 or 3 values")
    return p


def coupler_config(cfg: dict, traffic: dict):
    from icebin_tpu_torch import CouplerConfig
    from icebin_tpu_torch.regrid.matrices import RegridParams
    return CouplerConfig(dt=float(cfg["dt_seconds"]),
                         regen_every=regen_every(traffic),
                         min_thickness=float(cfg["min_thickness"]),
                         nv=int(cfg["nv"]),
                         params=RegridParams(**regrid_params(cfg)))
