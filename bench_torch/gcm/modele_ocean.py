"""GCM grid kind ``modele_ocean``, the program's half: ModelE's lat-lon
atmosphere grid (``gcm_grid.im`` x ``gcm_grid.jm``) over its ocean grid O
(``imo`` x ``jmo``, ``hntr_spec``), through the program's
``GCMRegridderModelE``: every sheet's exchange grid clipped against O on
the device, the land fractions (``foceanOp`` and ModelE's rounded
``foceanOm``) from the reference half's ``inputs``.  It drives the fused
traffic only (the C ABI over O is not built)."""
from __future__ import annotations

from harness import system

DRIVERS = ("fused",)


def regridder(cfg: dict, device, res_km=None, data=None):
    from icebin_tpu_torch import GCMRegridder
    from icebin_tpu_torch.grid import modele_lonlat_grid
    from icebin_tpu_torch.regrid.hntr import hntr_spec
    from icebin_tpu_torch.regrid.modele import GCMRegridderModelE
    if not hasattr(GCMRegridderModelE, "device_exchange"):
        raise RuntimeError("the program's GCMRegridderModelE hands "
                           "GCMCoupler no exchange grid "
                           "(device_exchange): it cannot couple over the "
                           "ocean grid")
    g = cfg["gcm_grid"]
    foceanOp, foceanOm = data["oceans"](res_km)
    grO = GCMRegridder(hntr_spec(g["imo"], g["jmo"]), cfg["hcdefs"],
                       device=device)
    for name, specI in system.sheet_specs(cfg, res_km).items():
        grO.add_sheet(name, specI, subdiv=cfg["subdiv"])
    return GCMRegridderModelE(grO, modele_lonlat_grid(g["im"], g["jm"]),
                              foceanOp, foceanOm)
