"""Regrid applies: the port of ``icebin_tpu/ops/pallas_bdt.py``'s public
apply surface (``apply_small``, ``apply_ice``, ``apply_view``), which also
takes over ``icebin_tpu/ops/bdt.py``'s role as the engine without kernels.

Public functions take and return the reference's layout, ``(nv, n)`` or
``(n,)``.  ``apply_ice`` hands that layout to the dest-ice kernel as it is;
``apply_small`` transposes fields to ``[n, nv]`` for the dest-small kernel,
whose lanes read a source row's fields together.

Two paths per direction:

* ``spmm_dest_small`` / ``spmm_dest_ice`` wrap the hand-written CUDA
  kernels (``csrc/spmm.cu``).  Given CUDA tensors they launch the kernel
  (counting each launch in ``.launches``) or raise; given CPU tensors they
  run the plain version ``spmm_ref``.
* ``spmm_ref`` is that plain version: an ``index_add_`` over the same CSR,
  summing in f64 and rounding to f32 once, like the kernels: in the
  dest-ice kernel's order, so bit for bit its results, and within one f32
  ulp of the dest-small kernel's.  ``spmm_dest_small_ref`` follows the
  dest-small kernel's own order (live-row slices, lane groups, the fixed
  combine), so it is bit for bit that kernel's result; the card's tests
  and ``chip_smoke.py`` hold the kernel to it.

The launch geometry is one rule of the pack's shape and the field count
(``small_geometry``, ``ice_geometry``), settled on the H100 (PERF.md).

Semantics kept from the reference: non-finite sources count as 0
(``pallas_bdt.py:262,275``); zero-weight destinations get ``fill``
(``:1304``); ``var_factor`` then ``var_offset`` apply after the scale
(``:1305-1308``); inputs wider than the pack's ``nv`` run in ``nv``-wide
groups (``:1323``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from icebin_tpu_torch.ops import _build
from icebin_tpu_torch.ops.csr import Csr, CsrPack, CsrView

__all__ = ["spmm_dest_small", "spmm_dest_ice", "spmm_ref",
           "spmm_dest_small_ref", "small_geometry", "small_slices",
           "rebind_dest_small",
           "ice_geometry", "apply_small", "apply_ice", "apply_small_ref",
           "apply_ice_ref", "apply_view"]

WARP = 32


def spmm_ref(csr: Csr, x: torch.Tensor, scale: bool = True,
             fields: bool = False,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of both kernels: x (n_src, nv) f32 -> (n_dst, nv) f32,
    ``out[r] = winv[r] * sum_k vals[k] * clean(x[cols[k]])``; with
    ``fields`` x is (nv, n_src) and the result (nv, n_dst); ``dtype``
    float64 keeps the f64 sums unrounded (``spmm_dest_small``'s)."""
    if fields:
        return spmm_ref(csr, x.t(), scale, dtype=dtype).t()
    x64 = torch.where(torch.isfinite(x), x, 0.0).to(torch.float64)
    contrib = csr.vals.to(torch.float64)[:, None] * x64[csr.cols.long()]
    out = torch.zeros((csr.n_dst, x.shape[1]), dtype=torch.float64,
                      device=x.device).index_add_(0, csr.rows(), contrib)
    if scale:
        out = out * csr.winv.to(torch.float64)[:, None]
    return out.to(dtype)


def _fold(acc, rows, slot, step, terms):
    """acc[rows, slot] += terms, one step of every row's sequence at a
    time, in order (each (row, slot) appears at most once per step)."""
    n = int(step.max()) + 1 if step.numel() else 0
    for s in range(n):
        sel = step == s
        r, c = rows[sel], slot[sel]
        acc[r, c] = acc[r, c] + terms[sel]
    return acc


#: warps the H100 keeps resident: 132 SMs x 64
CARD_WARPS = 132 * 64
#: source loads a dest-small lane keeps in flight
SMALL_UNROLL = 4


def small_geometry(csr: Csr, nv: int) -> tuple[int, int]:
    """(warps, unroll) of a dest-small launch: ``unroll`` source loads a
    lane keeps in flight, and the warps of a live row's block (one slice
    of the row each), the largest power of two up to 32 for which every
    live row's block is resident at once (n_live * warps <= CARD_WARPS)
    and a warp's slice of an average live row still holds one round of
    loads of every lane group.  Settled on the H100 (PERF.md,
    ``tools/sweep_spmm.py``)."""
    ng = _lanes(nv)[0][2] if nv > 0 else 1
    n = max(csr.n_live, 1)
    mean = csr.vals.numel() / n
    w = 1
    while (w < 32 and 2 * w * n <= CARD_WARPS
           and 2 * w * ng * SMALL_UNROLL <= mean):
        w *= 2
    return w, SMALL_UNROLL


def ice_geometry(nv: int, fields: bool) -> tuple[int, int]:
    """(chunk, min_blocks) of a dest-ice launch: the fields a thread holds
    in registers (4, 8, 16, 32 or 64) and the blocks of 256 threads the
    compiler must fit on an SM (1, or 8: at most 32 registers a thread).
    In the (nv, n) layout four fields a thread, held to 32 registers above
    16 fields (16 or more chunks a row block); in the (n, nv) layout eight,
    two 16-byte loads and stores.  Settled on the H100 (PERF.md,
    ``tools/sweep_spmm.py``)."""
    if fields:
        return 4, (1 if nv <= 16 else 8)
    return 8, 1


def small_slices(csr: Csr, warps: int) -> torch.Tensor:
    """(n_live, warps + 1) int64: the nonzero offsets of each live row's
    slices, in ``csr.live``'s order; slice s of a row of ``len`` nonzeros
    starting at k0 is [k0 + len*s // warps, k0 + len*(s+1) // warps)."""
    rp = csr.rowptr.to(torch.int64)
    live = csr.live.long()
    k0, n = rp[live], rp[live + 1] - rp[live]
    s = torch.arange(warps + 1, device=rp.device)
    return k0[:, None] + n[:, None] * s // warps


def _lanes(nv: int):
    """The dest-small kernel's passes over the fields: (first field,
    fields, lane groups) each; a lane reads 4, 2 or 1 fields (as nv
    divides), 32 lanes cover a pass, and a nonzero's fields take the
    smallest power-of-two group of lanes that holds them."""
    vw = 4 if nv % 4 == 0 else 2 if nv % 2 == 0 else 1
    out = []
    for f0 in range(0, nv, WARP * vw):
        pw = min(WARP * vw, nv - f0)
        g = 1
        while g < pw // vw:
            g *= 2
        out.append((f0, pw, WARP // g))
    return out


def spmm_dest_small_ref(csr: Csr, x: torch.Tensor, scale: bool = True,
                        warps: int | None = None,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of ``spmm_dest_small`` in its own summation order, bit
    for bit the kernel's result (``csrc/spmm.cu``'s header): each live row
    of ``csr.live`` cut into ``warps`` slices (``small_slices``; by default
    ``small_geometry``'s count), lane group g of a slice summing its
    nonzeros g, g + ng, ... from 0.0 in f64 (``_lanes``' ng), the groups
    added in order, then the slices in order, times winv (f64), rounded
    once (not at all for ``dtype`` float64); +0.0 on the empty rows."""
    nv = x.shape[1]
    if warps is None:
        warps = small_geometry(csr, nv)[0]
    bounds = small_slices(csr, warps)
    live = csr.live.long()
    at = torch.empty(csr.n_dst, dtype=torch.int64, device=x.device)
    at[live] = torch.arange(csr.n_live, device=x.device)
    idx = at[csr.rows()]                       # each nonzero's live row
    k = torch.arange(idx.numel(), device=x.device)
    sl = (bounds[idx, 1:warps] <= k[:, None]).sum(1)   # its slice
    off = k - bounds[idx, sl]                  # its place in the slice
    xc = torch.where(torch.isfinite(x), x, 0.0).to(torch.float64)
    terms = csr.vals.to(torch.float64)[:, None] * xc[csr.cols.long()]
    total = torch.empty((csr.n_live, nv), dtype=torch.float64,
                        device=x.device)
    for f0, pw, ng in _lanes(nv):
        acc = torch.zeros((csr.n_live, warps * ng, pw), dtype=torch.float64,
                          device=x.device)
        acc = _fold(acc, idx, sl * ng + off % ng, off // ng,
                    terms[:, f0:f0 + pw]).view(csr.n_live, warps, ng, pw)
        per_slice = acc[:, :, 0]
        for g in range(1, ng):
            per_slice = per_slice + acc[:, :, g]
        t = per_slice[:, 0]
        for w in range(1, warps):
            t = t + per_slice[:, w]
        total[:, f0:f0 + pw] = t
    if scale:
        total = total * csr.winv.to(torch.float64)[live, None]
    out = torch.zeros((csr.n_dst, nv), dtype=dtype, device=x.device)
    out[live] = total.to(dtype)
    return out


def _check_operands(csr: Csr, x: torch.Tensor, src_axis: int = 0) -> None:
    """A contiguous f32 field on the matrix's device with n_src along
    ``src_axis``: (n_src, nv), or (nv, n_src) for ``src_axis=1``."""
    if (x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous()
            or x.shape[src_axis] != csr.n_src):
        want = "(n_src, nv)" if src_axis == 0 else "(nv, n_src)"
        raise ValueError(f"spmm needs a contiguous f32 {want} field with "
                         f"n_src={csr.n_src}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device != csr.device:
        raise ValueError(f"field on {x.device}, matrix on {csr.device}")


def _launch(name: str, csr: Csr, x: torch.Tensor, *flags: int,
            out: torch.Tensor | None = None,
            nv: int | None = None) -> torch.Tensor:
    """Launch the CSR kernel ``name`` on x's stream into ``out`` (a new
    (n_dst, nv) f32 tensor by default); ``nv`` defaults to x's width and
    ``flags`` are the arguments after it (ints, and device pointers as
    ints: the regrid kernels' ``scale``, live list and geometry)."""
    nv = x.shape[1] if nv is None else nv
    if out is None:
        out = torch.empty((csr.n_dst, nv), dtype=torch.float32,
                          device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = getattr(lib, name)(
            csr.rowptr.data_ptr(), csr.cols.data_ptr(), csr.vals.data_ptr(),
            csr.winv.data_ptr(), x.data_ptr(), out.data_ptr(), csr.n_dst,
            nv, *flags, stream)
    _build.check(status, name)
    return out


def on_cpu(x: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (run the plain version), False for a CUDA one
    (launch the kernel); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type == "cpu"


def _small(csr: Csr, x: torch.Tensor, scale: bool, warps: int,
           unroll: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the dest-small kernel at the given geometry (uncounted), with
    f32 outputs or, for ``dtype`` float64, the unrounded f64 sums."""
    if csr.n_dst * x.shape[1] >= 2 ** 31:
        raise ValueError(f"spmm_dest_small: {csr.n_dst} x {x.shape[1]} "
                         f"outputs need 64-bit indexing")
    f64 = _out_dtype(dtype) == torch.float64
    out = torch.empty((csr.n_dst, x.shape[1]), dtype=dtype, device=x.device)
    return _launch("spmm_dest_small_f64" if f64 else "spmm_dest_small", csr,
                   x, int(scale), csr.live.data_ptr(), csr.n_live, warps,
                   unroll, out=out)


def _ice(csr: Csr, x: torch.Tensor, scale: bool, fields: bool, chunk: int,
         min_blocks: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the dest-ice kernel at geometry (``chunk``, ``min_blocks``),
    on x (n_src, nv) into (n_dst, nv), or with ``fields`` on (nv, n_src)
    into (nv, n_dst); into ``out`` where given (uncounted)."""
    nv = x.shape[0] if fields else x.shape[1]
    if out is None:
        out = torch.empty((nv, csr.n_dst) if fields else (csr.n_dst, nv),
                          dtype=torch.float32, device=x.device)
    return _launch("spmm_dest_ice", csr, x, int(scale), csr.n_src,
                   int(fields), chunk, min_blocks, out=out, nv=nv)


def _out_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"spmm_dest_small writes float32 or float64, not "
                         f"{dtype}")
    return dtype


def spmm_dest_small(csr: Csr, x: torch.Tensor, scale: bool = True,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dest-small kernel (EvI/AvI): x (n_src, nv) -> (n_dst, nv); a block
    of warps per live row, one slice of its nonzeros a warp.  ``dtype``
    float64 returns the f64 sums unrounded (a mesh rank's partials, rounded
    once after the cross-rank sum).  A matrix with no live row (a mesh
    rank whose cells are all masked) gives zeros without a launch: there
    is no row for a block to sum."""
    _check_operands(csr, x)
    _out_dtype(dtype)
    if on_cpu(x, "spmm_dest_small"):
        return spmm_ref(csr, x, scale, dtype=dtype)
    if csr.n_live == 0:
        return torch.zeros((csr.n_dst, x.shape[1]), dtype=dtype,
                           device=x.device)
    out = _small(csr, x, scale, *small_geometry(csr, x.shape[1]), dtype)
    spmm_dest_small.launches += 1
    return out


def spmm_dest_ice(csr: Csr, x: torch.Tensor, scale: bool = True,
                  fields: bool = False) -> torch.Tensor:
    """dest-ice kernel (IvE/IvA): one thread per row and chunk of fields;
    x (n_src, nv) -> (n_dst, nv), or with ``fields`` the (nv, n) layout,
    x (nv, n_src) -> (nv, n_dst), which ``apply_ice`` runs."""
    _check_operands(csr, x, src_axis=1 if fields else 0)
    if on_cpu(x, "spmm_dest_ice"):
        ref = spmm_ref(csr, x, scale, fields)
        return ref.contiguous() if fields else ref
    out = _ice(csr, x, scale, fields,
               *ice_geometry(x.shape[0] if fields else x.shape[1], fields))
    spmm_dest_ice.launches += 1
    return out


spmm_dest_small.launches = 0
spmm_dest_ice.launches = 0


def rebind_dest_small(graph, csr: Csr, nv: int, found: dict,
                      cap: int) -> int:
    """Give the dest-small launches over ``csr`` in a captured CUDA graph
    (``torch.cuda.CUDAGraph(keep_graph=True)``, instantiated) the launch
    ``spmm_dest_small`` makes for ``csr`` as it is now: the caller has
    loaded a new pack into the buffers the graph was captured over, so only
    the live-row count and ``small_geometry``'s warps of each launch's
    field count (at most ``nv``) change.  ``found``, a dict the caller
    keeps for ``graph``, holds each CSR's launches (at most ``cap``) once
    the first call has walked the graph for them.  Returns the launches
    updated."""
    warps = (ctypes.c_int * (nv + 1))(
        1, *(small_geometry(csr, k)[0] for k in range(1, nv + 1)))
    key = csr.rowptr.data_ptr()
    if key not in found:
        found[key] = ((ctypes.c_void_p * max(cap, 1))(), ctypes.c_int(-1))
    nodes, count = found[key]
    status = _build.library().spmm_dest_small_rebind(
        graph.raw_cuda_graph(), graph.raw_cuda_graph_exec(), key,
        csr.n_live, warps, nv + 1, nodes, len(nodes), ctypes.byref(count))
    _build.check(status, "spmm_dest_small_rebind")
    return count.value


def _apply(csr: Csr, f: torch.Tensor, nv: int, scale: bool, spmm,
           fields: bool = False):
    """(nvar, n_src) or (n_src,) through ``spmm`` in ``nv``-wide groups:
    handed over as (nv, n) with ``fields``, else transposed to (n, nv)
    and back."""
    single = f.dim() == 1
    fv = f[None, :] if single else f
    parts = []
    for k in range(0, fv.shape[0], nv):
        g = fv[k:k + nv].to(torch.float32)
        parts.append(spmm(csr, g.contiguous(), scale, fields=True) if fields
                     else spmm(csr, g.t().contiguous(), scale).t())
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    return out[0] if single else out


def apply_small(pack: CsrPack, f: torch.Tensor, scale: bool = True,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(nv, nice) or (nice,) -> (nv, nsmall) through the dest-small kernel,
    f32 or (``dtype`` float64) the unrounded sums."""
    return _apply(pack.small, f, pack.nv, scale,
                  functools.partial(spmm_dest_small, dtype=dtype))


def apply_ice(pack: CsrPack, f: torch.Tensor,
              scale: bool = True) -> torch.Tensor:
    """(nv, nsmall) or (nsmall,) -> (nv, nice) through the dest-ice kernel,
    in the (nv, n) layout: no transposes."""
    return _apply(pack.ice, f, pack.nv, scale, spmm_dest_ice, fields=True)


def apply_small_ref(pack: CsrPack, f: torch.Tensor,
                    scale: bool = True) -> torch.Tensor:
    """Plain version of ``apply_small`` (on any device)."""
    return _apply(pack.small, f, pack.nv, scale, spmm_ref)


def apply_ice_ref(pack: CsrPack, f: torch.Tensor,
                  scale: bool = True) -> torch.Tensor:
    """Plain version of ``apply_ice`` (on any device)."""
    return _apply(pack.ice, f, pack.nv, scale, spmm_ref, fields=True)


def apply_view(vw: CsrView, f: torch.Tensor, scale: bool = True,
               var_factor=None, var_offset=None,
               fill: float = math.nan) -> torch.Tensor:
    """Apply a view to ``f`` ((n,) or (nvar, n)); returns f32.  The view
    supplies the kernel apply (``apply_core``: a ``CsrView``'s pack here,
    a mesh rank's ``parallel.sharded_apply.ShardedView`` its K2 partials
    summed across ranks, or K1 on its rows).

    ``fill`` lands on zero-weight destinations when scaling; ``var_factor``
    / ``var_offset`` ((nvar,) each) are per-field affine unit conversions
    applied after the scale."""
    single = f.dim() == 1
    out = vw.apply_core(f[None, :] if single else f, scale=scale)
    if scale:
        out = torch.where(vw.wM[None, :] != 0, out, fill)
    if var_factor is not None:
        out = out * torch.as_tensor(var_factor, dtype=out.dtype,
                                    device=out.device)[:, None]
    if var_offset is not None:
        out = out + torch.as_tensor(var_offset, dtype=out.dtype,
                                    device=out.device)[:, None]
    return out[0] if single else out
