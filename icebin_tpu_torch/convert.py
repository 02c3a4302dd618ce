"""Carry ice-sheet state between the reference and the port.

The reference's ``IceSheetState`` holds ``H``, ``bed``, ``t`` and ``enth``;
any object with those attributes (a reference state, or a namespace of
numpy arrays) converts to the port's state, and the port's state converts
back to a dict of numpy arrays that the reference's constructor takes
(``IceSheetState(**d)``).  Regrid matrices need no conversion: both
packages use the same host ``WeightedMatrix`` objects.
"""
from __future__ import annotations

import numpy as np
import torch

from icebin_tpu_torch.models.ice_sheet import IceSheetState

__all__ = ["state_from_reference", "state_to_arrays"]


def state_from_reference(src, *, device) -> IceSheetState:
    """Port state from ``src.H``, ``src.bed``, ``src.t``, ``src.enth``
    (array-likes; H's dtype is kept, t becomes f64)."""
    H = torch.as_tensor(np.array(src.H), device=device)

    def like_H(a):
        return torch.as_tensor(np.array(a), device=device).to(H.dtype)

    return IceSheetState(
        H=H, bed=like_H(src.bed),
        t=torch.as_tensor(np.array(src.t, np.float64), device=device),
        enth=like_H(src.enth))


def state_to_arrays(state: IceSheetState) -> dict:
    """{"H", "bed", "t", "enth"} as numpy arrays."""
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in ("H", "bed", "t", "enth")}
