"""Regrid applies: the port of ``icebin_tpu/ops/pallas_bdt.py``'s public
apply surface (``apply_small``, ``apply_ice``, ``apply_view``), which also
takes over ``icebin_tpu/ops/bdt.py``'s role as the engine without kernels.

Public functions take and return the reference's layout, ``(nv, n)`` or
``(n,)``; inside, fields are transposed to ``[n, nv]`` for the kernels.

Two paths per direction:

* ``spmm_dest_small`` / ``spmm_dest_ice`` wrap the hand-written CUDA
  kernels (``csrc/spmm.cu``).  Given CUDA tensors they launch the kernel
  (counting each launch in ``.launches``) or raise; given CPU tensors they
  run the plain version.
* ``spmm_ref`` is that plain version: an ``index_add_`` over the same CSR,
  summing in f64 and rounding to f32 once, like the kernels.  The CPU tests
  and ``chip_smoke.py`` compare the kernels against it.

Semantics kept from the reference: non-finite sources count as 0
(``pallas_bdt.py:262,275``); zero-weight destinations get ``fill``
(``:1304``); ``var_factor`` then ``var_offset`` apply after the scale
(``:1305-1308``); inputs wider than the pack's ``nv`` run in ``nv``-wide
groups (``:1323``).
"""
from __future__ import annotations

import math

import torch

from icebin_tpu_torch.ops import _build
from icebin_tpu_torch.ops.csr import Csr, CsrPack, CsrView

__all__ = ["spmm_dest_small", "spmm_dest_ice", "spmm_ref", "apply_small",
           "apply_ice", "apply_small_ref", "apply_ice_ref", "apply_view"]


def spmm_ref(csr: Csr, x: torch.Tensor, scale: bool = True) -> torch.Tensor:
    """Plain version of both kernels: x (n_src, nv) f32 -> (n_dst, nv) f32,
    ``out[r] = winv[r] * sum_k vals[k] * clean(x[cols[k]])``."""
    x64 = torch.where(torch.isfinite(x), x, 0.0).to(torch.float64)
    contrib = csr.vals.to(torch.float64)[:, None] * x64[csr.cols.long()]
    out = torch.zeros((csr.n_dst, x.shape[1]), dtype=torch.float64,
                      device=x.device).index_add_(0, csr.rows(), contrib)
    if scale:
        out = out * csr.winv.to(torch.float64)[:, None]
    return out.to(torch.float32)


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
    ``flags`` are the int arguments after it (the regrid kernels'
    ``scale``)."""
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


def spmm_dest_small(csr: Csr, x: torch.Tensor,
                    scale: bool = True) -> torch.Tensor:
    """dest-small kernel (EvI/AvI): one warp per destination row."""
    _check_operands(csr, x)
    if on_cpu(x, "spmm_dest_small"):
        return spmm_ref(csr, x, scale)
    out = _launch("spmm_dest_small", csr, x, int(scale))
    spmm_dest_small.launches += 1
    return out


def spmm_dest_ice(csr: Csr, x: torch.Tensor,
                  scale: bool = True) -> torch.Tensor:
    """dest-ice kernel (IvE/IvA): one thread per (row, field)."""
    _check_operands(csr, x)
    if on_cpu(x, "spmm_dest_ice"):
        return spmm_ref(csr, x, scale)
    out = _launch("spmm_dest_ice", csr, x, int(scale))
    spmm_dest_ice.launches += 1
    return out


spmm_dest_small.launches = 0
spmm_dest_ice.launches = 0


def _apply(csr: Csr, f: torch.Tensor, nv: int, scale: bool, spmm):
    single = f.dim() == 1
    fv = f[None, :] if single else f
    parts = [spmm(csr, fv[k:k + nv].to(torch.float32).t().contiguous(),
                  scale).t()
             for k in range(0, fv.shape[0], nv)]
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    return out[0] if single else out


def apply_small(pack: CsrPack, f: torch.Tensor,
                scale: bool = True) -> torch.Tensor:
    """(nv, nice) or (nice,) -> (nv, nsmall) through the dest-small kernel."""
    return _apply(pack.small, f, pack.nv, scale, spmm_dest_small)


def apply_ice(pack: CsrPack, f: torch.Tensor,
              scale: bool = True) -> torch.Tensor:
    """(nv, nsmall) or (nsmall,) -> (nv, nice) through the dest-ice kernel."""
    return _apply(pack.ice, f, pack.nv, scale, spmm_dest_ice)


def apply_small_ref(pack: CsrPack, f: torch.Tensor,
                    scale: bool = True) -> torch.Tensor:
    """Plain version of ``apply_small`` (on any device)."""
    return _apply(pack.small, f, pack.nv, scale, spmm_ref)


def apply_ice_ref(pack: CsrPack, f: torch.Tensor,
                  scale: bool = True) -> torch.Tensor:
    """Plain version of ``apply_ice`` (on any device)."""
    return _apply(pack.ice, f, pack.nv, scale, spmm_ref)


def apply_view(vw: CsrView, f: torch.Tensor, scale: bool = True,
               var_factor=None, var_offset=None,
               fill: float = math.nan) -> torch.Tensor:
    """Apply a view to ``f`` ((n,) or (nvar, n)); returns f32.

    ``fill`` lands on zero-weight destinations when scaling; ``var_factor``
    / ``var_offset`` ((nvar,) each) are per-field affine unit conversions
    applied after the scale."""
    apply = apply_ice if vw.transposed else apply_small
    single = f.dim() == 1
    out = apply(vw.pack, f[None, :] if single else f, scale=scale)
    if scale:
        out = torch.where(vw.wM[None, :] != 0, out, fill)
    if var_factor is not None:
        out = out * torch.as_tensor(var_factor, dtype=out.dtype,
                                    device=out.device)[:, None]
    if var_offset is not None:
        out = out + torch.as_tensor(var_offset, dtype=out.dtype,
                                    device=out.device)[:, None]
    return out[0] if single else out
