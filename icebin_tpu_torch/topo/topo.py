"""The port's own copy of ``icebin_tpu/topo/topo.py`` (numpy); it imports
nothing of the reference package.  ``GCMRegridder`` is the port's, so
its exchange grids are built through the port's clip kernels.

TOPO pipeline: ModelE boundary-condition files with elevation classes.

Reference: ``slib/icebin/modele/topo*.cpp``, ``make_topoo``,
``make_merged_topoo``, ``global_ec`` [U] (SURVEY.md section 2 "TOPO
pipeline", section 3.4).  The pipeline:

1. **make_topoo** -- Hntr-downsample a fine base topography dataset
   (Z1QX1N-style: per-cell FOCEAN/FLAKE/FGRND/FGICE fractions + ZATMO
   elevation) onto the ModelE ocean grid O, preserving fraction sums.
2. **merge_topo** -- stitch per-ice-sheet state (from the coupled ice model
   or SeaRISE data) into the base: inside each sheet's footprint FGICE/ZATMO
   come from the ice sheet via AvI regridding, and the four surface
   fractions are renormalized to sum to 1.
3. **elevation_class_fields** -- fhc (EC area fractions), elevE (EC mean
   elevations), underice flags for ModelE's LISnow/elevation-class code.
4. **global_ec** (the reference's ``icebin_tpu.cli.global_ec``) -- persist
   the global EC matrix set compressed (zarray).

All regridding goes through the exact Hntr/ exchange-grid matrices, so every
fraction field conserves area exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from icebin_tpu_torch.grid.spec import GridSpecLonLat
from icebin_tpu_torch.regrid.gcmregridder import GCMRegridder
from icebin_tpu_torch.regrid.hntr import Hntr
from icebin_tpu_torch.regrid.matrices import RegridParams

__all__ = ["TopoFields", "synthetic_z1qx1n", "make_topoo", "merge_topo",
           "elevation_class_fields"]

FRACTION_FIELDS = ("focean", "flake", "fgrnd", "fgice")


@dataclasses.dataclass
class TopoFields:
    """Surface-type fractions + elevation on one lat-lon grid (flat order).
    Reference field names FOCEAN/FLAKE/FGRND/FGICE/ZATMO [U]."""

    spec: GridSpecLonLat
    focean: np.ndarray
    flake: np.ndarray
    fgrnd: np.ndarray
    fgice: np.ndarray
    zatmo: np.ndarray

    def check(self, atol=1e-9):
        s = self.focean + self.flake + self.fgrnd + self.fgice
        if not np.allclose(s, 1.0, atol=atol):
            raise ValueError(f"surface fractions do not sum to 1 "
                             f"(max dev {np.abs(s - 1).max():.2e})")
        return self

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {k: getattr(self, k) for k in FRACTION_FIELDS + ("zatmo",)}


def synthetic_z1qx1n(spec: GridSpecLonLat, seed: int = 0) -> TopoFields:
    """Synthetic Z1QX1N-style base dataset (the real 10-minute file is an
    external download in the reference too): continents from a low-order
    spherical harmonic pattern, ice caps poleward of 75 deg on land."""
    rng = np.random.default_rng(seed)
    c = spec.cell_centers()
    lon = np.radians(c[:, 0])
    lat = np.radians(c[:, 1])
    h = (np.sin(2 * lon) * np.cos(3 * lat) + 0.6 * np.cos(lon + 1.0)
         * np.sin(lat) + 0.3 * np.sin(5 * lat))
    land = h > 0.15
    focean = np.where(land, 0.0, 1.0)
    ice = land & (np.abs(np.degrees(lat)) > 75.0)
    fgice = np.where(ice, 0.9, 0.0)
    flake = np.where(land & (h > 0.5) & ~ice, 0.05, 0.0)
    fgrnd = 1.0 - focean - fgice - flake
    zatmo = np.where(land, 800.0 * np.maximum(h, 0.0)
                     + np.where(ice, 1500.0, 0.0), 0.0)
    return TopoFields(spec=spec, focean=focean, flake=flake, fgrnd=fgrnd,
                      fgice=fgice, zatmo=zatmo).check()


def make_topoo(base: TopoFields, specO: GridSpecLonLat) -> TopoFields:
    """Hntr-downsample base topo onto the ocean grid O (reference
    ``make_topoo`` [U]).  Fractions regrid as plain area means (sum stays
    exactly 1); ZATMO regrids land-area-weighted."""
    h = Hntr(specO, base.spec)
    fr = {k: h.regrid(getattr(base, k)) for k in FRACTION_FIELDS}
    land_w = 1.0 - base.focean
    zatmo = h.regrid(base.zatmo, WTA=land_w, fill=0.0)
    zatmo = np.where(np.isfinite(zatmo), zatmo, 0.0)
    return TopoFields(spec=specO, zatmo=zatmo, **fr).check()


def merge_topo(topoo: TopoFields, gr: GCMRegridder,
               elevmasks: Dict[str, np.ndarray],
               params: RegridParams = RegridParams()) -> TopoFields:
    """Stitch ice-sheet state into the base TOPO (reference
    ``make_merged_topoo`` [U]): within each sheet's A-grid footprint, FGICE
    is replaced by the true per-cell ice area fraction (from the exchange
    grid + elevmask) and ZATMO by the AvI-regridded ice surface elevation;
    FGRND absorbs the fraction change, and all fractions renormalize.

    ``gr`` must be built over the SAME grid as ``topoo.spec``.
    """
    if gr.specA.ncells != topoo.spec.ncells:
        raise ValueError("GCMRegridder grid does not match TOPO grid")
    focean = topoo.focean.copy()
    flake = topoo.flake.copy()
    fgrnd = topoo.fgrnd.copy()
    fgice = topoo.fgice.copy()
    zatmo = topoo.zatmo.copy()
    areaA = gr.specA.cell_areas()

    for name, elevmask in elevmasks.items():
        rm = gr.regrid_matrices(name, elevmask)
        AvI = rm.matrix("AvI", params)
        # per-A ice fraction from true covered areas (native measure)
        fice_sheet = np.minimum(AvI.wM / areaA, 1.0)
        touched = AvI.wM > 0
        elevA = AvI.apply(np.where(np.isfinite(elevmask), elevmask, 0.0),
                          scale=True)
        fgice[touched] = fice_sheet[touched]
        zatmo[touched] = np.where(np.isfinite(elevA[touched]),
                                  elevA[touched], zatmo[touched])
        # ground absorbs the change; lake/ocean trimmed if needed
        resid = 1.0 - (focean + flake + fgice)
        fgrnd = np.where(touched, np.maximum(resid, 0.0), fgrnd)
        # if ice+ocean+lake exceed 1, trim lake then ocean
        over = (focean + flake + fgrnd + fgice) - 1.0
        take_lake = np.minimum(flake, np.maximum(over, 0.0))
        flake = flake - np.where(touched, take_lake, 0.0)
        over = over - take_lake
        focean = focean - np.where(touched, np.maximum(over, 0.0), 0.0)
    out = TopoFields(spec=topoo.spec, focean=focean, flake=flake,
                     fgrnd=fgrnd, fgice=fgice, zatmo=zatmo)
    return out.check(atol=1e-6)


def elevation_class_fields(gr: GCMRegridder,
                           elevmasks: Dict[str, np.ndarray],
                           params: RegridParams = RegridParams()):
    """(fhc, elevE, underice): ModelE's elevation-class boundary fields
    (reference TOPO EC extension: ``fhc``, ``elevE``, ``underice`` [U]).

    fhc: (nhc, nA) EC area fractions of each A cell's ICED part, summed over
    sheets; elevE: (nhc, nA) mean surface elevation per EC; underice:
    (nhc, nA) int -- sheet id + 1 contributing most area, 0 where none.
    """
    nhc, nA = gr.nhc, gr.nA
    w = np.zeros((nhc, nA))
    we = np.zeros((nhc, nA))
    under = np.zeros((len(elevmasks), nhc, nA))
    for si, (name, elevmask) in enumerate(elevmasks.items()):
        rm = gr.regrid_matrices(name, elevmask)
        fhc_s = rm.fhc()
        wA = np.zeros(nA)
        np.add.at(wA, rm.iA, rm.o)
        w_s = fhc_s * wA[None, :]
        w += w_s
        elevE_s = rm.elevE()
        we += np.where(np.isfinite(elevE_s), elevE_s, 0.0) * w_s
        under[si] = w_s
    tot = w.sum(axis=0, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        fhc = np.where(tot > 0, w / np.where(tot > 0, tot, 1.0), 0.0)
        elevE = np.where(w > 0, we / np.where(w > 0, w, 1.0), np.nan)
    underice = np.where(w > 0, np.argmax(under, axis=0) + 1, 0)
    return fhc, elevE, underice
