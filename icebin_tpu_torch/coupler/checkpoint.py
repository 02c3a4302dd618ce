"""Coupling-loop checkpoint/resume (port of
``icebin_tpu/coupler/checkpoint.py``).

The coupler's full resumable state -- model time, per-sheet ice state, the
regeneration's elevmask and cadence, and the f64 ledger -- saves to one
``.npz`` under the reference's keys, so a checkpoint written by either
package loads into the other.  Matrices are not stored: they rebuild
deterministically from the restored elevmask, so a resumed run is bit
for bit the run that was not interrupted (the applies use no float
atomics).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from icebin_tpu_torch.coupler.ledger import Ledger
from icebin_tpu_torch.models.ice_sheet import IceSheetState, default_enthalpy

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path: str, coupler) -> None:
    """Write ``coupler``'s state to ``path``, with every ledger row booked
    so far.  A mesh coupler saves the gathered whole-lattice state (every
    rank calls this; rank 0 writes, and the others wait until the file is
    there), so its checkpoint is a single-device one."""
    arrs = {"time": np.asarray(coupler.time),
            "ledger": np.frombuffer(
                json.dumps(coupler.ledger.to_rows()).encode(), dtype=np.uint8)}
    for name, sc in coupler.sheets.items():
        state = sc.gathered_state()
        for k in ("H", "bed", "t", "enth"):
            arrs[f"{name}.{k}"] = getattr(state, k).detach().cpu().numpy()
        arrs[f"{name}.steps_since_regen"] = np.asarray(sc.steps_since_regen)
        arrs[f"{name}.regen_elevmask"] = np.asarray(sc.regen_elevmask)
    mesh = getattr(coupler, "mesh", None)
    if mesh is None or mesh.rank == 0:
        np.savez_compressed(path, **arrs)
    if mesh is not None:
        mesh.barrier()


def load_checkpoint(path: str, coupler) -> None:
    """Restore state into an already-constructed coupler (same config) on its
    device (a mesh coupler's rank takes its block); matrices regenerate from
    the restored elevmask.  The lattice
    takes the sheet's dtype and the time f64, as the port's state holds
    them; a checkpoint without ``enth`` (written before the energy column
    existed) starts from the cold column at the sheet's ``t_init``."""
    z = np.load(path)
    coupler.time = float(z["time"])
    coupler.ledger = Ledger(steps=json.loads(bytes(z["ledger"].tobytes())
                                             .decode()))
    for name, sc in coupler.sheets.items():
        dt_ = sc.ice_cfg.torch_dtype

        def get(k, dtype=dt_):
            return torch.as_tensor(z[f"{name}.{k}"], device=sc.device
                                   ).to(dtype)

        H = get("H")
        sc.place_state(IceSheetState(
            H=H, bed=get("bed"), t=get("t", torch.float64),
            enth=(get("enth") if f"{name}.enth" in z
                  else default_enthalpy(H, sc.ice_cfg.t_init))))
        sc.regen_matrices(elevmask=z[f"{name}.regen_elevmask"])
        sc.steps_since_regen = int(z[f"{name}.steps_since_regen"])
