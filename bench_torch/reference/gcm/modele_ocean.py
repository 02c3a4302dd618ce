"""GCM grid kind ``modele_ocean``, the reference's half: ModelE's lat-lon
atmosphere grid A (``gcm_grid.im`` x ``gcm_grid.jm``, ``reference.grid``'s
``modele_bounds``) over its finer ocean grid O (``imo`` x ``jmo``), where
ModelE keeps its land fractions, coupled as IceBin's
``GCMRegridder_ModelE`` couples it (Fischer et al. 2014, GMD 7, 883).
Written from the documented rule, in plain PyTorch and numpy, with nothing
of the program:

* O's borders: longitude every 360 / imo degrees from -180, latitude rows
  180 / jmo degrees tall from -90 (1 x 1.25 degrees at 288 x 180; no
  half-height polar rows).  Each O cell lies in one A cell: the A cell
  holding its centre (longitudes taken modulo 360 into A's span).
* The exchange grid is built against O (``reference.grid.exchange_grid``).
  Each exchange cell is moved to the A cell holding its O cell, and its
  area scaled by sAm[a] = LAm[a] / LAp[a]: A cell a's land area under
  ModelE's rounded ocean mask foceanOm over its land area under the true
  fraction foceanOp, each the sum over its O cells of (1 - focean) x the
  O cell's native area; 1 where LAp == 0 (so 0 where LAm == 0 < LAp).
* The correctA factor at A: A's native area over the summed projected
  areas of its O cells (native where an O cell does not project sanely,
  which ``exchange_grid`` measures so).

Departures from a fresh construction, each one rounding: the O cells'
projected areas are recovered from ``exchange_grid``'s correctA factor as
native / cA rather than measured again; LAm, LAp and the projected sums
are ``index_add_`` sums, whose order on the card is not fixed.

``inputs`` makes the ocean fractions, the same for every seed: foceanOp[o]
= 1 - the share of O cell o under the cell's initial ice (the Vialov dome
where H > ``min_thickness``: ``reference.ice.vialov``), the share being
the iced exchange cells' area x O's correctA factor over o's native area,
at most 1 (the true ice fraction of a merged TOPO), summed over the
sheets; all other land is taken as ocean, so O cells off the lattices are
1; foceanOm = ``numpy.round(foceanOp)``.  They are made on the CPU in f64
at the reference's precision, once for each lattice size the run asks for
(the configured one, or the CPU tests' toy): ``inputs`` hands both halves
an ``Oceans`` that computes them at first call.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from reference import grid as rg
from reference import ice as ri
from reference.prec import REFERENCE


def ocean_bounds(imo: int, jmo: int):
    """(lonb, latb) in degrees of the ocean grid O."""
    dlon, dlat = 360.0 / imo, 180.0 / jmo
    return ([-180.0 + dlon * i for i in range(imo + 1)],
            [-90.0 + dlat * j for j in range(jmo + 1)])


def parents(cfg: dict, device) -> torch.Tensor:
    """(nO,) int64: the A cell holding each O cell's centre; cells of both
    grids flat in (lat, lon) row-major order."""
    g = cfg["gcm_grid"]
    lonbA, latbA = rg.modele_bounds(g["im"], g["jm"])
    lonbO, latbO = ocean_bounds(g["imo"], g["jmo"])
    lonc = 0.5 * (np.asarray(lonbO[:-1]) + np.asarray(lonbO[1:]))
    latc = 0.5 * (np.asarray(latbO[:-1]) + np.asarray(latbO[1:]))
    lonc = lonbA[0] + np.mod(lonc - lonbA[0], 360.0)
    i = np.searchsorted(lonbA, lonc, side="right") - 1
    j = np.searchsorted(latbA, latc, side="right") - 1
    a = j[:, None] * g["im"] + i[None, :]
    return torch.as_tensor(a.reshape(-1), dtype=torch.int64, device=device)


def lattice(sheet: dict, res_km, device) -> rg.Lattice:
    """A sheet's lattice as the harness builds it (``res_km`` its cell
    size override, None for the configured one)."""
    res = 1e3 * res_km if res_km else float(sheet["res_m"])
    nx = int(round((sheet["x1"] - sheet["x0"]) / res))
    ny = int(round((sheet["y1"] - sheet["y0"]) / res))
    return rg.Lattice(
        torch.tensor(np.linspace(sheet["x0"], sheet["x1"], nx + 1),
                     device=device),
        torch.tensor(np.linspace(sheet["y0"], sheet["y1"], ny + 1),
                     device=device),
        rg.parse_proj(sheet["proj"]))


def res_km_of(sheet: dict, lat: rg.Lattice) -> Optional[float]:
    """The ``res_km`` a lattice of ``sheet`` was built with (None: the
    configured size)."""
    if lat.nx == int(round((sheet["x1"] - sheet["x0"]) / sheet["res_m"])):
        return None
    return float(lat.xb[1] - lat.xb[0]) / 1e3


class Oceans:
    """The ocean fractions of one configuration (module docstring):
    ``oceans(res_km)`` -> (foceanOp, foceanOm), (nO,) f64 numpy arrays,
    computed at the first call for each lattice size."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self._at: Dict[Optional[float], Tuple[np.ndarray, np.ndarray]] = {}

    def __call__(self, res_km=None):
        if res_km not in self._at:
            self._at[res_km] = self._fractions(res_km)
        return self._at[res_km]

    def _fractions(self, res_km):
        cfg, cpu = self.cfg, torch.device("cpu")
        g = cfg["gcm_grid"]
        lonbO, latbO = ocean_bounds(g["imo"], g["jmo"])
        nativeO = rg.native_areas(lonbO, latbO, cpu)
        share = torch.zeros_like(nativeO)
        for s in cfg["sheets"]:
            lat = lattice(s, res_km, cpu)
            xo = rg.exchange_grid(lonbO, latbO, lat, REFERENCE,
                                  subdiv=cfg["subdiv"])
            H = ri.vialov(lat.nx, lat.ny, cpu).reshape(-1)
            iced = (H > float(cfg["min_thickness"]))[xo.iI]
            iO = xo.iA[iced]
            share.index_add_(0, iO, xo.area[iced] * xo.cA[iO])
        op = 1.0 - torch.clamp(share / nativeO, max=1.0)
        op = op.numpy()
        return op, np.round(op)


def inputs(cfg: dict, seed: int) -> dict:
    """The data both halves take: ``oceans``, an ``Oceans`` (the
    fractions are the same for every seed)."""
    return {"oceans": Oceans(cfg)}


def exchange(cfg: dict, sheet: dict, lattice: rg.Lattice, device, prec,
             data=None) -> rg.Exchange:
    g = cfg["gcm_grid"]
    lonbA, latbA = rg.modele_bounds(g["im"], g["jm"])
    lonbO, latbO = ocean_bounds(g["imo"], g["jmo"])
    nA = g["im"] * g["jm"]
    xo = rg.exchange_grid(lonbO, latbO, lattice, prec, subdiv=cfg["subdiv"])
    op, om = (torch.as_tensor(f, device=device)
              for f in data["oceans"](res_km_of(sheet, lattice)))
    a_of_o = parents(cfg, device)
    nativeO = rg.native_areas(lonbO, latbO, device)
    z = torch.zeros(nA, dtype=torch.float64, device=device)
    LAm = z.clone().index_add_(0, a_of_o, (1.0 - om) * nativeO)
    LAp = z.clone().index_add_(0, a_of_o, (1.0 - op) * nativeO)
    sAm = torch.where(LAp > 0, LAm / torch.where(LAp > 0, LAp, 1.0), 1.0)
    iA = a_of_o[xo.iA]
    projA = z.clone().index_add_(0, a_of_o, nativeO / xo.cA)
    nativeA = rg.native_areas(lonbA, latbA, device)
    projA = torch.where(projA > 0, projA, nativeA)
    if not math.isclose(float(nativeA.sum()), float(nativeO.sum()),
                        rel_tol=1e-12):
        raise ValueError("the ocean grid does not cover the atmosphere "
                         "grid")
    return rg.Exchange(iA=iA, iI=xo.iI, area=xo.area * sAm[iA],
                       cA=nativeA / projA, nA=nA, nI=xo.nI)
