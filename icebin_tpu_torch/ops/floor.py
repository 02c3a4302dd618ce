"""Stream-only floors of the regrid kernels (the port of the Pallas TPU
instruments ``tools/probe_floor.py:59`` / ``:84`` and
``tools/probe_ant_nv.py:144``): ``stock - floor`` is the compute the
dest-small and dest-ice kernels do not hide behind their memory traffic.

* ``spmm_floor_small`` / ``spmm_floor_ice`` wrap the hand-written CUDA
  kernels (``csrc/floor.cu``), which keep the thread mapping and the loads
  of ``spmm_dest_small`` / ``spmm_dest_ice``: given CUDA tensors they
  launch the kernel (counting each launch in ``.launches``) or raise;
  given CPU tensors they run the plain version.
* ``spmm_floor_small_ref`` / ``spmm_floor_ice_ref`` are those plain
  versions.  Both compute, in f32,
  ``out[r, v] = winv[r] + sum_{k in row r} (vals[k] + x[cols[k], v])``
  in the kernel's fixed order, so kernel and plain version agree bit for
  bit:

  - dest-small: term ``p`` of a row (``p = k - rowptr[r]``) goes to lane
    ``p % 32``, each lane summing its terms in order from 0; the lanes then
    fold as the kernel's shuffle tree does (lanes ``[0, off)`` add lanes
    ``[off, 2 off)`` for ``off`` = 16, 8, 4, 2, 1), and ``winv[r]`` is
    added to lane 0's total;
  - dest-ice: the terms of a row summed in order from 0, then ``winv[r]``.
"""
from __future__ import annotations

import torch

from icebin_tpu_torch.ops.apply import _check_operands, _launch, on_cpu
from icebin_tpu_torch.ops.csr import Csr

__all__ = ["spmm_floor_small", "spmm_floor_ice", "spmm_floor_small_ref",
           "spmm_floor_ice_ref"]

WARP = 32


def _terms(csr: Csr, x: torch.Tensor):
    """(row, position in the row, f32 term) of every nonzero."""
    rows = csr.rows()
    pos = (torch.arange(csr.vals.numel(), device=x.device)
           - csr.rowptr.to(torch.int64)[rows])
    return rows, pos, csr.vals[:, None] + x[csr.cols.long()]


def _fold(acc, rows, slot, step, terms):
    """acc[rows, slot] += terms, one step of every row's sequence at a
    time, in order (each (row, slot) appears at most once per step)."""
    n = int(step.max()) + 1 if step.numel() else 0
    for s in range(n):
        sel = step == s
        r, c = rows[sel], slot[sel]
        acc[r, c] = acc[r, c] + terms[sel]
    return acc


def spmm_floor_small_ref(csr: Csr, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``spmm_floor_small``: x (n_src, nv) f32 ->
    (n_dst, nv) f32 (module docstring)."""
    rows, pos, terms = _terms(csr, x)
    acc = torch.zeros((csr.n_dst, WARP, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    acc = _fold(acc, rows, pos % WARP, pos // WARP, terms)
    off = WARP // 2
    while off:
        acc[:, :off] = acc[:, :off] + acc[:, off:2 * off]
        off //= 2
    return acc[:, 0] + csr.winv[:, None]


def spmm_floor_ice_ref(csr: Csr, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``spmm_floor_ice``: x (n_src, nv) f32 ->
    (n_dst, nv) f32 (module docstring)."""
    rows, pos, terms = _terms(csr, x)
    acc = torch.zeros((csr.n_dst, 1, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    acc = _fold(acc, rows, torch.zeros_like(pos), pos, terms)
    return acc[:, 0] + csr.winv[:, None]


def spmm_floor_small(csr: Csr, x: torch.Tensor) -> torch.Tensor:
    """Stream floor of ``spmm_dest_small``: one warp per destination row."""
    _check_operands(csr, x)
    if on_cpu(x, "spmm_floor_small"):
        return spmm_floor_small_ref(csr, x)
    out = _launch("spmm_floor_small", csr, x)
    spmm_floor_small.launches += 1
    return out


def spmm_floor_ice(csr: Csr, x: torch.Tensor) -> torch.Tensor:
    """Stream floor of ``spmm_dest_ice``: one thread per (row, field)."""
    _check_operands(csr, x)
    if on_cpu(x, "spmm_floor_ice"):
        return spmm_floor_ice_ref(csr, x)
    out = _launch("spmm_floor_ice", csr, x)
    spmm_floor_ice.launches += 1
    return out


spmm_floor_small.launches = 0
spmm_floor_ice.launches = 0
