"""Variants of the dest-small regrid kernel ``spmm_dest_small`` (K2): the
port of the Pallas TPU instruments ``tools/probe_slots.py:106``,
``tools/probe_group.py:111``, ``tools/probe_batch.py:136`` with
``tools/probe_batch2.py:118``, and ``tools/probe_ablate.py:261``.  Each
changes one mechanism of K2, to be timed beside it; none is on the
coupler's path (``apply_small`` launches K2).

* ``spmm_small_slots(csr, x, nslot)``, ``spmm_small_group(csr, x, g)``,
  ``spmm_small_batch(csr, x, fb)`` and ``spmm_small_ablate(csr, x, mode)``
  wrap the hand-written CUDA kernels (``csrc/k2probe.cu``): given CUDA
  tensors they launch the kernel (counting each launch in ``.launches``) or
  raise; given CPU tensors they run the plain version.
* ``*_ref`` are those plain versions.  Each reproduces its kernel's
  summation order, so kernel and plain version agree bit for bit.

All compute, with scale, ``out[r, v] = winv[r] * sum_k vals[k] *
clean(x[cols[k], v])`` (K2's function; ``clean`` maps non-finite sources to
0), each product exact in f64, summed in f64 and rounded to f32 once, except
``mode="f32"``.  Term ``p`` of a row is its ``p``-th nonzero.  The orders:

- ``slots(nslot)``: term ``p`` to lane ``p % 32`` and slot ``(p // 32) %
  nslot``, each (lane, slot) summing its terms in order from 0; each lane
  adds its slots in slot order; then K2's shuffle tree (lanes ``[0, off)``
  add lanes ``[off, 2 off)`` for ``off`` = 16, 8, 4, 2, 1); then the
  scale.  ``nslot = 1`` is K2's order.
- ``group(g)``: term ``p`` to warp ``(p // 32) % g`` and lane ``p % 32``,
  each (warp, lane) summing in order; each warp's shuffle tree; the warp
  totals added in warp order; then the scale.  ``g = 1`` is K2's order.
- ``batch(fb)``: the terms of a row summed serially in order, for every
  field and every ``fb``.
- ``ablate("f32")``: K2's order, every product, sum and the scale in f32.
- ``ablate("smem")``: K2's f64 lane sums, added in lane order 0..31 (no
  shuffle tree), then the scale.
"""
from __future__ import annotations

import torch

from icebin_tpu_torch.ops._probe import variant
from icebin_tpu_torch.ops.apply import _fold
from icebin_tpu_torch.ops.csr import Csr

__all__ = ["SLOTS", "GROUPS", "BATCH", "MODES", "spmm_small_slots",
           "spmm_small_group", "spmm_small_batch", "spmm_small_ablate",
           "spmm_small_slots_ref", "spmm_small_group_ref",
           "spmm_small_batch_ref", "spmm_small_ablate_ref"]

WARP = 32
#: the parameters each kernel has an instance for
SLOTS = (1, 2, 4, 8)
GROUPS = (1, 2, 4, 8)
BATCH = (16, 32, 64)
MODES = ("f32", "smem")


def _partials(csr: Csr, x: torch.Tensor, lanes: int, nslot: int,
              dtype=torch.float64):
    """(live rows, acc (n_live, nslot, lanes, nv)): acc[i, q, l] sums, in
    order from 0, the terms p of live row i with p % lanes == l and
    (p // lanes) % nslot == q; terms are exact f64 products, or f32
    products for ``dtype=torch.float32``."""
    rows = csr.rows()
    pos = (torch.arange(csr.vals.numel(), device=x.device)
           - csr.rowptr.to(torch.int64)[rows])
    xc = torch.where(torch.isfinite(x), x, 0.0).to(dtype)
    terms = csr.vals.to(dtype)[:, None] * xc[csr.cols.long()]
    live, idx = torch.unique(rows, return_inverse=True)
    acc = torch.zeros((live.numel(), nslot * lanes, x.shape[1]), dtype=dtype,
                      device=x.device)
    slot = (pos // lanes % nslot) * lanes + pos % lanes
    acc = _fold(acc, idx, slot, pos // (lanes * nslot), terms)
    return live, acc.view(live.numel(), nslot, lanes, x.shape[1])


def _tree(a: torch.Tensor) -> torch.Tensor:
    """K2's shuffle tree over dim -2 (32 lanes): lane 0's total."""
    a = a.clone()
    off = WARP // 2
    while off:
        a[..., :off, :] = a[..., :off, :] + a[..., off:2 * off, :]
        off //= 2
    return a[..., 0, :]


def _in_order(a: torch.Tensor) -> torch.Tensor:
    """((a[:, 0] + a[:, 1]) + a[:, 2]) + ...: dim 1 summed in order."""
    t = a[:, 0]
    for q in range(1, a.shape[1]):
        t = t + a[:, q]
    return t


def _scaled(csr: Csr, live: torch.Tensor, total: torch.Tensor,
            nv: int) -> torch.Tensor:
    """(n_dst, nv) f32: winv[r] * total on the live rows (in total's
    precision, rounded to f32 once), 0 on the empty ones."""
    out = torch.zeros((csr.n_dst, nv), dtype=torch.float32,
                      device=total.device)
    out[live] = (total * csr.winv.to(total.dtype)[live, None]).to(
        torch.float32)
    return out


def spmm_small_slots_ref(csr: Csr, x: torch.Tensor,
                         nslot: int) -> torch.Tensor:
    """Plain version of ``spmm_small_slots`` (module docstring)."""
    live, acc = _partials(csr, x, WARP, nslot)
    return _scaled(csr, live, _tree(_in_order(acc)), x.shape[1])


def spmm_small_group_ref(csr: Csr, x: torch.Tensor, g: int) -> torch.Tensor:
    """Plain version of ``spmm_small_group`` (module docstring)."""
    live, acc = _partials(csr, x, WARP, g)
    return _scaled(csr, live, _in_order(_tree(acc)), x.shape[1])


def spmm_small_batch_ref(csr: Csr, x: torch.Tensor, fb: int) -> torch.Tensor:
    """Plain version of ``spmm_small_batch``: the order is serial in k for
    every ``fb`` (module docstring)."""
    live, acc = _partials(csr, x, 1, 1)
    return _scaled(csr, live, acc[:, 0, 0], x.shape[1])


def spmm_small_ablate_ref(csr: Csr, x: torch.Tensor,
                          mode: str) -> torch.Tensor:
    """Plain version of ``spmm_small_ablate`` (module docstring)."""
    if mode == "f32":
        live, acc = _partials(csr, x, WARP, 1, torch.float32)
        return _scaled(csr, live, _tree(acc[:, 0]), x.shape[1])
    live, acc = _partials(csr, x, WARP, 1)
    return _scaled(csr, live, _in_order(acc[:, 0]), x.shape[1])


def spmm_small_slots(csr: Csr, x: torch.Tensor, nslot: int) -> torch.Tensor:
    """K2 with ``nslot`` accumulator chains per lane."""
    return variant(spmm_small_slots, spmm_small_slots_ref, csr, x, nslot,
                   SLOTS, nslot)


def spmm_small_group(csr: Csr, x: torch.Tensor, g: int) -> torch.Tensor:
    """K2 with ``g`` warps per row and a fixed second pass."""
    return variant(spmm_small_group, spmm_small_group_ref, csr, x, g, GROUPS,
                   g)


def spmm_small_batch(csr: Csr, x: torch.Tensor, fb: int) -> torch.Tensor:
    """K2 gathering 32 source rows' ``fb`` fields into shared memory, then
    contracting."""
    return variant(spmm_small_batch, spmm_small_batch_ref, csr, x, fb, BATCH,
                   fb)


def spmm_small_ablate(csr: Csr, x: torch.Tensor, mode: str) -> torch.Tensor:
    """K2 with its sums in f32 (``"f32"``) or without its shuffle tree
    (``"smem"``)."""
    return variant(spmm_small_ablate, spmm_small_ablate_ref, csr, x, mode,
                   MODES, MODES.index(mode) if mode in MODES else -1)


spmm_small_slots.launches = 0
spmm_small_group.launches = 0
spmm_small_batch.launches = 0
spmm_small_ablate.launches = 0
