"""Per-step conservation ledger and mass repair (port of
``icebin_tpu/coupler/ledger.py``).

The books are f64 unconditionally: the reference falls to f32 when JAX's
x64 mode is off (``ledger.py:33,53``); here every weighted sum, repair and
ledger value is f64 whatever the field dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

__all__ = ["weighted_mass", "repair_mass", "Ledger"]

_F64 = torch.float64


def weighted_mass(f: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f64 sum of f*w over the last axis, non-finite f counted as 0."""
    fv = torch.where(torch.isfinite(f), f, 0.0).to(_F64)
    return (fv * w.to(_F64)).sum(dim=-1)


def repair_mass(out: torch.Tensor, wM: torch.Tensor,
                m_src: torch.Tensor) -> torch.Tensor:
    """Additively correct ``out`` ((nvar, nrow) destination means) so that
    sum(out * wM) == m_src ((nvar,)) in f64.  The correction is uniform per
    unit weight; zero-weight and non-finite cells are untouched.  Returns
    f64: the ledger must be fed from this array, not from a downcast."""
    out64 = out.to(_F64)
    w64 = wM.to(_F64)
    m_dst = weighted_mass(out64, w64)
    wtot = w64.sum()
    corr = (m_src.to(_F64) - m_dst) / torch.where(wtot > 0, wtot, 1.0)
    fixed = out64 + corr[:, None]
    return torch.where((w64 > 0)[None, :] & torch.isfinite(out64), fixed,
                       out64)


@dataclasses.dataclass
class Ledger:
    """Host-side f64 account book, one row per coupling step.

    ``post`` reads its value at once (a device sync for a device tensor);
    ``post_deferred`` keeps the device tensor and ``flush`` -- which every
    reader calls -- fetches the whole backlog in one copy."""

    steps: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    _pending: List[tuple] = dataclasses.field(default_factory=list)

    def open_step(self, t: float) -> Dict[str, float]:
        row = {"t": float(t)}
        self.steps.append(row)
        return row

    def post(self, key: str, value) -> None:
        self.steps[-1][key] = float(value)

    def post_deferred(self, keys, values: torch.Tensor) -> None:
        """Book ``keys[i] = values[i]`` into the CURRENT row without
        fetching: ``values`` stays a device tensor until ``flush``."""
        self._pending.append((self.steps[-1], tuple(keys), values))

    def flush(self) -> None:
        pending, self._pending = self._pending, []
        if not pending:
            return
        flat = torch.cat([v.reshape(-1).to(_F64) for _, _, v in pending])
        flat = flat.cpu().tolist()
        off = 0
        for row, keys, _ in pending:
            for i, k in enumerate(keys):
                row[k] = flat[off + i]
            off += len(keys)

    def closure_error(self, inflow_keys, outflow_keys, store_key,
                      step: int = -1) -> float:
        """Relative closure of: store_new - store_old == in - out."""
        self.flush()
        row = self.steps[step]
        prev = (self.steps[step - 1] if len(self.steps) > 1 and step != 0
                else None)
        store_old = prev[store_key] if prev and store_key in prev else 0.0
        inflow = sum(row.get(k, 0.0) for k in inflow_keys)
        outflow = sum(row.get(k, 0.0) for k in outflow_keys)
        lhs = row[store_key] - store_old
        rhs = inflow - outflow
        scale = max(abs(row[store_key]), abs(inflow), abs(outflow), 1e-300)
        return abs(lhs - rhs) / scale

    def to_rows(self):
        self.flush()
        return list(self.steps)
