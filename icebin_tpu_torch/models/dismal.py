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
On a rank of a mesh-decomposed sheet (``coupler.sharded``) ``step_for``
gives the step to install: each rank holds its own block, and rank 0
writes the single-device run's files from the forcings gathered from
every rank.
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
            if state.H.shape[0] != cfg.ny:
                raise ValueError("the state is a rank's block of a mesh "
                                 "sheet: install step_for(sheet) there")
            self._dump(cfg, state.t, dt, smb_flux, tsurf, enth_flux)
        self._count += 1
        return _hold(state, dt)

    def step_for(self, sheet):
        """The step to install as ``sheet.ice_step``: ``step`` on a
        single-device ``IceSheetCoupler``.  On this rank of a
        ``MeshIceSheetCoupler`` the step holds the rank's block as ``step``
        does; with ``out_dir``, every rank sends its real rows of the
        forcings (``sheet.gather_ice``, a collective) and rank 0 alone
        writes them: the whole real lattice, the single-device run's
        files."""
        mesh = getattr(sheet, "mesh", None)
        if mesh is None:
            return self.step
        real = dataclasses.replace(sheet.ice_cfg, ny=sheet.ny_real)

        def gathered(x):
            return None if x is None else sheet.gather_ice(
                torch.as_tensor(x).reshape(-1))

        def step(cfg, state, smb_flux, tsurf, dt, enth_flux=None):
            if self.out_dir is not None:
                fields = [gathered(x) for x in (smb_flux, tsurf, enth_flux)]
                if mesh.rank == 0:
                    self._dump(real, state.t, dt, *fields)
            self._count += 1
            return _hold(state, dt)

        return step

    def _dump(self, cfg, t, dt, smb_flux, tsurf, enth_flux):
        d = pathlib.Path(self.out_dir)
        d.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            d / f"dismal_{self._count:06d}.npz",
            smb_flux=_lattice(smb_flux, cfg),
            tsurf=_lattice(tsurf, cfg),
            enth_flux=_lattice(enth_flux, cfg),
            t=float(t), dt=float(dt))


def _hold(state: IceSheetState, dt: float):
    """The unchanged state a step of ``dt`` later, and zero fluxes."""
    z = torch.zeros_like(state.H)
    return (IceSheetState(H=state.H, bed=state.bed, t=state.t + dt,
                          enth=state.enth),
            IceFluxes(z, z, z, z, z, z, z, z, z))
