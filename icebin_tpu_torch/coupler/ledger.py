"""Per-step conservation ledger and mass repair (port of
``icebin_tpu/coupler/ledger.py``).

The books are f64 unconditionally: the reference falls to f32 when JAX's
x64 mode is off (``ledger.py:33,53``); here every weighted sum, repair and
ledger value is f64 whatever the field dtype.  The coupling step takes its
books through ``ops.books`` (a kernel a stage on the card), whose plain
version is the torch code of ``weighted_mass`` (defined there) and of
``repair_mass``'s two halves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from icebin_tpu_torch.ops.books import weighted_mass

__all__ = ["weighted_mass", "repair_mass", "Ledger"]

_F64 = torch.float64


def repair_mass(out: torch.Tensor, wM: torch.Tensor,
                m_src: torch.Tensor, totals=None) -> torch.Tensor:
    """Additively correct ``out`` ((nvar, nrow) destination means) so that
    sum(out * wM) == m_src ((nvar,)) in f64.  The correction is uniform per
    unit weight; zero-weight and non-finite cells are untouched.  Returns
    f64: the ledger must be fed from this array, not from a downcast.

    ``totals``, where the destination rows are one rank's part of a
    decomposed space, maps this rank's partial sums (m_dst, wtot) to the
    whole space's (``IceMesh.sum_ranks``)."""
    out64 = out.to(_F64)
    w64 = wM.to(_F64)
    m_dst = weighted_mass(out64, w64)
    wtot = w64.sum()
    if totals is not None:
        m_dst, wtot = totals(m_dst, wtot)
    corr = (m_src.to(_F64) - m_dst) / torch.where(wtot > 0, wtot, 1.0)
    fixed = out64 + corr[:, None]
    return torch.where((w64 > 0)[None, :] & torch.isfinite(out64), fixed,
                       out64)


@dataclasses.dataclass
class Ledger:
    """Host-side f64 account book, one row per coupling step; ``post``
    books a host value into the current row (a coupler posts the rows of
    a window from the window's one fetch)."""

    steps: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    def open_step(self, t: float) -> Dict[str, float]:
        row = {"t": float(t)}
        self.steps.append(row)
        return row

    def post(self, key: str, value) -> None:
        self.steps[-1][key] = float(value)

    def closure_error(self, inflow_keys, outflow_keys, store_key,
                      step: int = -1) -> float:
        """Relative closure of: store_new - store_old == in - out."""
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
        return list(self.steps)
