"""DISMAL: the do-nothing 'writer' ice model (port of
``icebin_tpu/models/dismal.py``).

Reference: besides PISM, IceBin ships a second ice-coupler family, DISMAL
(Demo Ice Sheet Model and Landice), which performs no dynamics -- it
records the forcing fields it receives each coupling step and reports an
unchanged surface (reference: the DISMAL ``IceCoupler`` variant [U];
SURVEY.md section 2 coupling runtime).

A drop-in for the SIA model in ``IceSheetCoupler``: the same ``step()``
signature, static thickness, zero shed fluxes on the state's device, and
optional per-step npz dumps of the received forcings (pulled to the host).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional

import numpy as np
import torch

from icebin_tpu_torch.models.ice_sheet import (IceFluxes, IceSheetConfig,
                                               IceSheetState)

__all__ = ["DismalModel"]


def _lattice(x, cfg: IceSheetConfig) -> np.ndarray:
    if x is None:
        return np.zeros((cfg.ny, cfg.nx))
    return torch.as_tensor(x).detach().cpu().numpy().reshape(cfg.ny, cfg.nx)


@dataclasses.dataclass
class DismalModel:
    """State-preserving stand-in with forcing capture.

    Use: ``sc = IceSheetCoupler(...); sc.ice_step = DismalModel(dir).step``
    or call ``step(cfg, state, smb, tsurf, dt, enth_flux)`` anywhere the
    coupled ice-step protocol fits (returns all-zero shed fluxes).
    """

    out_dir: Optional[str] = None
    _count: int = 0

    def step(self, cfg: IceSheetConfig, state: IceSheetState, smb_flux,
             tsurf, dt: float, enth_flux=None):
        if self.out_dir is not None:
            d = pathlib.Path(self.out_dir)
            d.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(
                d / f"dismal_{self._count:06d}.npz",
                smb_flux=_lattice(smb_flux, cfg),
                tsurf=_lattice(tsurf, cfg),
                enth_flux=_lattice(enth_flux, cfg),
                t=float(state.t), dt=float(dt))
        self._count += 1
        z = torch.zeros_like(state.H)
        return (IceSheetState(H=state.H, bed=state.bed, t=state.t + dt,
                              enth=state.enth),
                IceFluxes(z, z, z, z, z, z, z, z, z))
