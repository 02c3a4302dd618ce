"""Variants of the dest-ice regrid kernel ``spmm_dest_ice`` (K1): the port
of the Pallas TPU instruments ``tools/probe_slots.py:161``,
``tools/probe_batch.py:207`` with ``tools/probe_batch2.py:184``,
``tools/probe_ablate.py:182`` with ``tools/probe_manual6.py:149``,
``tools/probe_ice_bisect.py:119``, and ``tools/probe_donate.py:71`` with
``tools/probe_rmw.py:105``.  Each changes one mechanism of K1, to be timed
beside it; none is on the coupler's path (``apply_ice`` launches K1).

* ``spmm_ice_slots(csr, x, nslot)``, ``spmm_ice_batch(csr, x, rb)``,
  ``spmm_ice_ablate(csr, x, mode)``, ``spmm_ice_stage(csr, x, level)`` and
  ``spmm_ice_store(csr, x, mode, out=None)`` wrap the hand-written CUDA
  kernels (``csrc/k1probe.cu``; ``store("into")`` launches K1's own,
  ``csrc/spmm.cu``): given CUDA tensors they launch the kernel
  (counting each launch in ``.launches``) or raise; given CPU tensors they
  run the plain version.
* ``*_ref`` are those plain versions.  Each reproduces its kernel's
  summation order, so kernel and plain version agree bit for bit.

K1's function, with scale, is ``out[r, v] = winv[r] * sum_k vals[k] *
clean(x[cols[k], v])`` (``clean`` maps non-finite sources to 0); K1's order
starts an f64 sum at 0.0, adds the exact f64 products in k order, multiplies
by ``winv[r]`` in f64 and rounds to f32 once.  Term ``p`` of a row is its
``p``-th nonzero.  The orders:

- ``slots(nslot)``: term ``p`` to accumulator ``p % nslot``, each summing its
  terms in order from 0.0; the accumulators added in slot order; then the
  scale.  ``nslot = 1`` is K1's order.
- ``batch(rb)``: K1's order for every ``rb`` (rows per block, the staging
  geometry).
- ``ablate("f32")``: K1's order with every product, sum and the scale in
  f32.  ``ablate("row")``: K1's order (one thread walks a row for 16 fields).
- ``stage(level)``: f64 sums in k order, rounded once, of ``x[cols[k], v]``
  (``"gather"``: non-finite sources propagate), ``clean(x)`` (``"clean"``)
  and ``vals[k] * clean(x)`` (``"weights"``).  The level above, the scale,
  is K1 itself.
- ``store("into")``: K1's own kernel (``spmm_dest_ice``) writing into the
  caller's ``out`` instead of a new tensor.  ``store("rmw")``: the
  f64 sum starts at the value read from ``out`` (zeros when no ``out`` is
  given) instead of 0.0, ``out = winv * (out + sum_k ...)``; on a zeroed
  ``out`` that is K1's order and K1's bits, signed zero included.
  ``store("fields")``: x is (nv, n_src), the result (nv, n_dst): K1's order,
  K1's bits transposed.
"""
from __future__ import annotations

import torch

from icebin_tpu_torch.ops._probe import variant
from icebin_tpu_torch.ops.apply import (_check_operands, _fold, _ice,
                                        _launch, ice_geometry, on_cpu)
from icebin_tpu_torch.ops.csr import Csr

__all__ = ["SLOTS", "BATCH", "MODES", "LEVELS", "STORES", "spmm_ice_slots",
           "spmm_ice_batch", "spmm_ice_ablate", "spmm_ice_stage",
           "spmm_ice_store", "spmm_ice_slots_ref", "spmm_ice_batch_ref",
           "spmm_ice_ablate_ref", "spmm_ice_stage_ref", "spmm_ice_store_ref"]

#: the parameters each kernel has an instance for
SLOTS = (1, 2, 4)
BATCH = (8, 32, 128)
MODES = ("f32", "row")
LEVELS = ("gather", "clean", "weights")
STORES = ("into", "rmw", "fields")


def _chains(csr: Csr, x: torch.Tensor, nslot: int = 1,
            dtype=torch.float64, level: str = "weights",
            init: torch.Tensor | None = None) -> torch.Tensor:
    """acc (n_dst, nslot, nv): acc[r, q] sums, in order, the terms p of row r
    with p % nslot == q, from 0 (slot 0 from ``init``, if given).  A term is
    the ``level``'s (module docstring), in ``dtype``: products of f32 values,
    exact in f64."""
    rows = csr.rows()
    pos = (torch.arange(csr.vals.numel(), device=x.device)
           - csr.rowptr.to(torch.int64)[rows])
    xs = x if level == "gather" else torch.where(torch.isfinite(x), x, 0.0)
    terms = xs.to(dtype)[csr.cols.long()]
    if level == "weights":
        terms = csr.vals.to(dtype)[:, None] * terms
    acc = torch.zeros((csr.n_dst, nslot, x.shape[1]), dtype=dtype,
                      device=x.device)
    if init is not None:
        acc[:, 0] = init.to(dtype)
    return _fold(acc, rows, pos % nslot, pos // nslot, terms)


def _scaled(csr: Csr, total: torch.Tensor) -> torch.Tensor:
    """winv[r] * total in total's precision, rounded to f32 once."""
    return (total * csr.winv.to(total.dtype)[:, None]).to(torch.float32)


def _k1(csr: Csr, x: torch.Tensor, init=None) -> torch.Tensor:
    """K1's order (from ``init`` instead of 0.0 where given)."""
    return _scaled(csr, _chains(csr, x, init=init)[:, 0])


def spmm_ice_slots_ref(csr: Csr, x: torch.Tensor, nslot: int) -> torch.Tensor:
    """Plain version of ``spmm_ice_slots`` (module docstring)."""
    acc = _chains(csr, x, nslot)
    total = acc[:, 0]
    for q in range(1, nslot):
        total = total + acc[:, q]
    return _scaled(csr, total)


def spmm_ice_batch_ref(csr: Csr, x: torch.Tensor, rb: int) -> torch.Tensor:
    """Plain version of ``spmm_ice_batch``: K1's order for every ``rb``."""
    return _k1(csr, x)


def spmm_ice_ablate_ref(csr: Csr, x: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version of ``spmm_ice_ablate`` (module docstring)."""
    if mode == "f32":
        return _scaled(csr, _chains(csr, x, dtype=torch.float32)[:, 0])
    return _k1(csr, x)


def spmm_ice_stage_ref(csr: Csr, x: torch.Tensor, level: str) -> torch.Tensor:
    """Plain version of ``spmm_ice_stage`` (module docstring)."""
    return _chains(csr, x, level=level)[:, 0].to(torch.float32)


def spmm_ice_store_ref(csr: Csr, x: torch.Tensor, mode: str,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``spmm_ice_store`` (module docstring): the result,
    written into ``out`` when one is given."""
    if mode == "fields":
        res = _k1(csr, x.t()).t()
    elif mode == "rmw":
        res = _k1(csr, x, init=out)
    else:
        res = _k1(csr, x)
    return res.contiguous() if out is None else out.copy_(res)


def spmm_ice_slots(csr: Csr, x: torch.Tensor, nslot: int) -> torch.Tensor:
    """K1 with ``nslot`` accumulator chains per thread."""
    return variant(spmm_ice_slots, spmm_ice_slots_ref, csr, x, nslot, SLOTS,
                   nslot)


def spmm_ice_batch(csr: Csr, x: torch.Tensor, rb: int) -> torch.Tensor:
    """K1 staging ``rb`` rows' nonzeros and source rows in shared memory,
    then contracting."""
    return variant(spmm_ice_batch, spmm_ice_batch_ref, csr, x, rb, BATCH, rb)


def spmm_ice_ablate(csr: Csr, x: torch.Tensor, mode: str) -> torch.Tensor:
    """K1 with its arithmetic in f32 (``"f32"``) or one thread per row
    (``"row"``)."""
    return variant(spmm_ice_ablate, spmm_ice_ablate_ref, csr, x, mode, MODES,
                   MODES.index(mode) if mode in MODES else -1)


def spmm_ice_stage(csr: Csr, x: torch.Tensor, level: str) -> torch.Tensor:
    """K1 built up to ``level``: gather, clean, weights (the scale is
    K1)."""
    return variant(spmm_ice_stage, spmm_ice_stage_ref, csr, x, level, LEVELS,
                   LEVELS.index(level) if level in LEVELS else -1)


def spmm_ice_store(csr: Csr, x: torch.Tensor, mode: str,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """K1 storing into the caller's ``out`` (``"into"``: K1's own kernel),
    reading it first (``"rmw"``; a new zeroed buffer by default) or in the
    (nv, n) layout (``"fields"``: x is (nv, n_src), the result (nv,
    n_dst)).  Returns the result, ``out`` itself when one is given."""
    if mode not in STORES:
        raise ValueError(f"spmm_ice_store: no kernel instance for {mode!r} "
                         f"(one of {STORES})")
    fields = mode == "fields"
    _check_operands(csr, x, src_axis=1 if fields else 0)
    nv = x.shape[0] if fields else x.shape[1]
    shape = (nv, csr.n_dst) if fields else (csr.n_dst, nv)
    if out is not None and (out.dtype != torch.float32 or not
                            out.is_contiguous() or tuple(out.shape) != shape
                            or out.device != x.device):
        raise ValueError(f"spmm_ice_store: out must be a contiguous f32 "
                         f"{shape} tensor on {x.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    if on_cpu(x, "spmm_ice_store"):
        return spmm_ice_store_ref(csr, x, mode, out)
    if out is None:
        out = (torch.zeros if mode == "rmw" else torch.empty)(
            shape, dtype=torch.float32, device=x.device)
    if mode == "into":
        _ice(csr, x, True, False, *ice_geometry(nv, False), out=out)
    else:
        _launch("spmm_ice_store", csr, x, STORES.index(mode), csr.n_src,
                out=out, nv=nv)
    spmm_ice_store.launches += 1
    return out


spmm_ice_slots.launches = 0
spmm_ice_batch.launches = 0
spmm_ice_ablate.launches = 0
spmm_ice_stage.launches = 0
spmm_ice_store.launches = 0
