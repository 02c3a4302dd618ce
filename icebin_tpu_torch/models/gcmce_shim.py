"""Python side of the port's gcmce_* C ABI (``icebin_tpu_torch/native/
gcmce.cc``; port of ``icebin_tpu/models/gcmce_shim.py``).

The C layer (callable from a Fortran GCM exactly like the reference's
``gcmce_*`` functions [U]) stays minimal: it forwards raw pointers as
memoryviews plus an integer handle; this module owns the handle table and
does the real work through the port's ``ModelEAdapter``.

``gcmce_new`` runs the coupler on ``device``, the card by default (the C
ABI passes no device).  Without a GPU it raises rather than run on the CPU;
the C layer then returns a negative handle.  ``device="cpu"`` runs the
kernels' plain versions, for a caller that asks for it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from icebin_tpu_torch.models.modele_adapter import ModelEAdapter

_handles: Dict[int, ModelEAdapter] = {}
_next = [1]


def gcmce_new(config_path: str, device="cuda") -> int:
    """Create an adapter from a RunConfig JSON (reference gcmce_new reads
    the icebin.nc config [U])."""
    from icebin_tpu_torch.coupler.coupler import CouplerConfig
    from icebin_tpu_torch.io.ncio import read_exchange, read_grid
    from icebin_tpu_torch.regrid.gcmregridder import GCMRegridder
    from icebin_tpu_torch.utils.config import RunConfig

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("gcmce_new: no CUDA device; the coupler runs on "
                           "the card (gcmce_shim.gcmce_new(path, "
                           "device='cpu') runs the plain versions)")
    cfg = RunConfig.from_json(config_path)
    gridA = read_grid(cfg.gridA_file)
    gr = GCMRegridder(gridA, hcdefs=cfg.hcdefs, device=device)
    for s in cfg.sheets:
        gridI = read_grid(s.grid_file)
        xg = read_exchange(s.exchange_file) if s.exchange_file else None
        gr.add_sheet(s.name, gridI, exchange=xg, subdiv=s.subdiv)
    ccfg = CouplerConfig(dt=cfg.dt_seconds, regen_every=cfg.regen_every,
                         min_thickness=cfg.min_thickness,
                         params=cfg.regrid_params())
    h = _next[0]
    _next[0] += 1
    _handles[h] = ModelEAdapter(gr, ccfg, device=device)
    return h


def gcmce_delete(h: int) -> None:
    _handles.pop(h, None)


def gcmce_dims(h: int):
    ad = _handles[h]
    im, jm = ad.gr.specA.shape
    return im, jm, ad.nhc


def gcmce_set_start_time(h: int, t0: float) -> None:
    _handles[h].set_start_time(t0)


def gcmce_add_gcm_outpute(h: int, idx_mv, vals_mv, n: int, nvar: int) -> None:
    """Copies the caller's buffers: a GCM may reuse them once the call
    returns (the reference keeps views of them until ``couple_native``)."""
    idx = np.frombuffer(idx_mv, dtype=np.int64, count=n).copy()
    vals = np.frombuffer(vals_mv, dtype=np.float64,
                         count=n * nvar).reshape(nvar, n).copy()
    _handles[h].add_rank_output(idx, vals)


def gcmce_couple_native(h: int, itime: float, fhc_mv, elevE_mv,
                        underice_mv) -> int:
    ad = _handles[h]
    ad.couple_native(itime)
    fhc, elevE, underice = ad.topo()
    np.frombuffer(fhc_mv, dtype=np.float64)[:] = fhc.reshape(-1)
    np.frombuffer(elevE_mv, dtype=np.float64)[:] = elevE.reshape(-1)
    np.frombuffer(underice_mv, dtype=np.int32)[:] = \
        underice.reshape(-1).astype(np.int32)
    return 0
