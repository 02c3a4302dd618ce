"""GCM grid kind ``modele_lonlat``, the program's half: ModelE's lat-lon
grid of ``gcm_grid.im`` x ``gcm_grid.jm`` cells (half-height polar rows)
under one plain ``GCMRegridder``, every sheet's exchange grid clipped on
the device."""
from __future__ import annotations

from harness import system

DRIVERS = ("fused", "abi")


def regridder(cfg: dict, device, res_km=None, data=None):
    from icebin_tpu_torch import GCMRegridder
    from icebin_tpu_torch.grid import modele_lonlat_grid
    g = cfg["gcm_grid"]
    gr = GCMRegridder(modele_lonlat_grid(g["im"], g["jm"]), cfg["hcdefs"],
                      device=device)
    for name, specI in system.sheet_specs(cfg, res_km).items():
        gr.add_sheet(name, specI, subdiv=cfg["subdiv"])
    return gr
