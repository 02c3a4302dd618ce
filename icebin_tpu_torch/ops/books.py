"""The books of a coupling step: ordered f64 sums over many rows at once,
the f64 mass repair's write, and the ledger row from the sums.

* ``books_sum`` and ``books_repair`` wrap ``books_reduce_kernel<double>``
  (``csrc/books.cu``), ``books_stats`` ``books_stats_kernel``: given CUDA
  tensors each launches its kernel once (counting the launch in
  ``.launches``) or raises; given CPU tensors each runs its plain version.
* The plain versions (``books_sum_ref``, ``books_repair_ref``,
  ``books_stats_ref``) are the coupler's torch code of the weighted sums
  (``weighted_mass``), the repair (``repair_mass``'s two halves), the
  lattice sums and the ledger row's arithmetic, moved as it was, so the
  CPU's results are that code's bit for bit: each sum is taken over the
  same shape (a row, a block of rows, a flattened field) as before.

The kernel adds a row's terms in an order fixed by the row's length alone
(a block a slice of 2,048 values, a fixed tree in the block, the block
partials added by the row's last block, found by an integer ticket): not
the plain version's order, so its sums are within a few ulps of sum
|f w| of the plain version's; two launches give the same bits.  The
ledger row is the plain arithmetic's bit for bit from the same sums.

A stage names its rows as ``Rows`` groups:

* with a weight ``w``, weighted sums (``weighted_mass``: non-finite
  values count as 0, f64 products with w), one a row of x: x's rows, or
  those in ``rows``; ``split`` marks rows the plain version sums one by one
  (as 1-D tensors), where the coupler summed them so;
* without one, the sum of all of x in f64 (plus ``extra`` fields, added
  in x's type first; pad cells where ``mask`` is False count as 0);
* ``scale``: x's rows multiplied by ``scale[row]`` first (x's type).

The ticket counters are one int32 buffer a device, zero between launches;
launches on one device are ordered (one stream, as the coupler runs them).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from icebin_tpu_torch.ops import _build
from icebin_tpu_torch.ops.apply import on_cpu

__all__ = ["Rows", "weighted_mass", "books_sum", "books_sum_ref",
           "books_repair", "books_repair_ref", "books_stats",
           "books_stats_ref", "THREADS", "PER_THREAD", "SLICE"]

_F64 = torch.float64
THREADS = 256
#: values a thread sums in a block's slice
PER_THREAD = 8
#: values a block sums
SLICE = THREADS * PER_THREAD
_MAX_GROUPS = 20
_MAX_ROWS = 16
_MAX_SUMS = 127
_XF64, _WF64, _RWF64, _FINITE = 1, 2, 4, 8


def weighted_mass(f: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f64 sum of f*w over the last axis, non-finite f counted as 0."""
    fv = torch.where(torch.isfinite(f), f, 0.0).to(_F64)
    return (fv * w.to(_F64)).sum(dim=-1)


@dataclasses.dataclass
class Rows:
    """One group of a stage's sums (module docstring)."""

    x: torch.Tensor
    rows: Optional[Sequence[int]] = None
    w: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    extra: Tuple[torch.Tensor, ...] = ()
    scale: Optional[torch.Tensor] = None
    split: bool = False

    def count(self) -> int:
        """The sums this group gives."""
        if self.w is None:
            return 1
        if self.rows is not None:
            return len(self.rows)
        return 1 if self.x.dim() == 1 else self.x.shape[0]


# -- plain versions ----------------------------------------------------------

def _index(x: torch.Tensor, rows):
    return torch.as_tensor(list(rows), device=x.device)


def books_sum_ref(*groups: Rows,
                  weighted_mass: Callable = weighted_mass) -> torch.Tensor:
    """Plain version of ``books_sum``: the groups' sums, in order, as one
    (n,) f64 tensor; ``weighted_mass`` is the weighted sum it takes."""
    out = []
    for g in groups:
        if g.w is None:
            x = g.x
            for e in g.extra:
                x = x + e
            x = x.reshape(-1)
            if g.mask is not None:
                x = torch.where(g.mask.reshape(-1), x, 0.0)
            out.append(x.to(_F64).sum().reshape(1))
        elif g.split:
            out.append(torch.stack([weighted_mass(
                g.x[k] if g.scale is None else g.x[k] * g.scale[k], g.w)
                for k in g.rows]))
        else:
            x = g.x
            if g.rows is not None:
                idx = _index(x, g.rows)
                x = (x[idx] if g.scale is None
                     else x[idx] * g.scale[idx, None])
            out.append(weighted_mass(x, g.w).reshape(-1))
    return torch.cat(out)


def books_repair_ref(x: torch.Tensor, w: torch.Tensor, m_src, m_dst, wtot,
                     rows=None, into: bool = False, sums=None,
                     weighted_mass: Callable = weighted_mass):
    """Plain version of ``books_repair`` (``repair_mass`` after its sums)."""
    idx = None if rows is None else _index(x, rows)
    xs = x if idx is None else x[idx]
    out64 = torch.where(torch.isfinite(xs), xs, 0.0).to(_F64)
    w64 = w.to(_F64)
    corr = (m_src.to(_F64) - m_dst) / torch.where(wtot > 0, wtot, 1.0)
    fixed = out64 + corr[:, None]
    out = torch.where((w64 > 0)[None, :] & torch.isfinite(out64), fixed,
                      out64)
    if into:
        x[idx] = torch.where(torch.isfinite(x[idx]), out.to(x.dtype), x[idx])
    if sums is None:
        return out, None
    return out, torch.stack([weighted_mass(out[k], w) for k in sums])


def books_stats_ref(pre, dl, post, es, *, cell_area: float, rho: float,
                    dt: float) -> torch.Tensor:
    """Plain version of ``books_stats``: the coupler's ledger arithmetic on
    0-d tensors (see ``books_stats``)."""
    mass0, e_store0, s_smb, s_rain, s_enth = pre
    e_src = [v * dt for v in es]
    dls = [v * dt for v in dl]
    m_in = e_src[0] + e_src[1]
    e_in = sum(e_src[3:]) + e_src[2]
    mass0 = mass0 * cell_area * rho
    e_store0 = e_store0 * cell_area
    m_delivered = dls[0] + dls[1]
    m_rain = dls[1]
    e_rain = dls[2]
    e_delivered = sum(dls[3:]) + e_rain
    ad = cell_area * dt
    mass1, e_store1, m_shed, m_clamp, e_shed, e_clamp, e_pdd = post
    mass1 = mass1 * cell_area * rho
    e_store1 = e_store1 * cell_area
    m_returned = m_shed * ad + m_rain
    m_clamp = m_clamp * ad
    e_returned = e_shed * ad + e_rain
    e_clamp = e_clamp * ad
    e_pdd = e_pdd * ad
    # residual rows: defined so the ledger identities hold exactly
    m_del_f32 = (s_smb + s_rain) * ad
    e_del_f32 = s_enth * ad
    m_residual = ((mass1 - mass0 - m_del_f32 + m_returned - m_clamp)
                  + (m_del_f32 - m_delivered))
    e_residual = ((e_store1 - e_store0 - e_del_f32
                   + (e_returned - e_rain) + e_clamp)
                  + (e_del_f32 + e_rain - e_delivered))
    return torch.stack([
        m_in, m_delivered, mass1, m_returned, m_clamp, m_residual,
        e_in, e_delivered, e_pdd,
        e_store1, e_returned, e_clamp, e_residual,
        m_rain, e_rain])


# -- the kernels ---------------------------------------------------------------

class _Group(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in (
        "x", "y", "z", "scale", "w", "rw", "mask", "msrc", "mdst", "wtot",
        "out64", "dst")] + [
        ("stride", ctypes.c_longlong), ("n", ctypes.c_int),
        ("nrows", ctypes.c_int), ("flags", ctypes.c_int),
        ("nslices", ctypes.c_int), ("cstride", ctypes.c_int),
        ("sum", ctypes.c_byte * _MAX_ROWS),
        ("row", ctypes.c_ubyte * _MAX_ROWS)]


class _Books(ctypes.Structure):
    _fields_ = [("g", _Group * _MAX_GROUPS),
                ("first", ctypes.c_int * (_MAX_GROUPS + 1)),
                ("ngroups", ctypes.c_int), ("partial", ctypes.c_void_p),
                ("ticket", ctypes.c_void_p), ("out", ctypes.c_void_p)]


#: by device index, the ticket counters (zero between launches)
_tickets: Dict[int, torch.Tensor] = {}


def _library():
    lib = _build.library()
    if not getattr(lib, "_books_checked", False):
        size = lib.books_struct_size()
        if size != ctypes.sizeof(_Books):
            raise RuntimeError(f"books: the kernel's launch parameter is "
                               f"{size} bytes, the wrapper's "
                               f"{ctypes.sizeof(_Books)}")
        lib._books_checked = True
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _flat(t: torch.Tensor, dtype=None) -> torch.Tensor:
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"books: {tuple(t.shape)} {t.dtype}, want {dtype}")
    if t.dtype not in (torch.float32, torch.float64, torch.bool):
        raise ValueError(f"books: unsupported dtype {t.dtype}")
    return t if t.is_contiguous() else t.contiguous()


def _group(g: _Group, x, n, rows, strides, sums, *, w=None, extra=(),
           scale=None, mask=None, finite=False):
    """Fill ``g`` for ``rows`` (row indices of x) of length ``n``, x's
    (row, value) ``strides``, row r's sum landing at ``sums[r]`` (-1:
    none)."""
    top = x.shape[0] if x.dim() == 2 else 1
    if scale is not None:
        top = min(top, scale.numel())
    if len(rows) > _MAX_ROWS or not all(0 <= k < min(top, 256)
                                        for k in rows):
        raise ValueError(f"books: rows {list(rows)} of {top}: at most "
                         f"{_MAX_ROWS}, each below 256")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"books: x of dtype {x.dtype}")
    for t in (*extra, scale):
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"books: {t.dtype} beside x's {x.dtype}")
    for t in (w, mask, *extra):
        if t is not None and t.numel() != (n if t is w or t is mask
                                           else x.numel()):
            raise ValueError(f"books: {tuple(t.shape)} beside rows of {n}")
    g.x = x.data_ptr()
    g.y = _ptr(extra[0]) if len(extra) > 0 else None
    g.z = _ptr(extra[1]) if len(extra) > 1 else None
    if len(extra) > 2:
        raise ValueError("books: at most two extra fields")
    g.scale, g.w, g.mask = _ptr(scale), _ptr(w), _ptr(mask)
    (g.stride, g.cstride), g.n, g.nrows = strides, n, len(rows)
    g.flags = ((_XF64 if x.dtype == _F64 else 0)
               | (_WF64 if w is not None and w.dtype == _F64 else 0)
               | (_FINITE if finite else 0))
    g.nslices = max(1, -(-n // SLICE))
    for r, (k, s) in enumerate(zip(rows, sums)):
        g.row[r], g.sum[r] = k, s


def _launch(b: _Books, ngroups: int, device) -> None:
    """Number the blocks of ``b``'s groups, give it its scratch and launch
    it on the current stream (a tensor freed after the launch is reused
    only by work ordered after it on the stream)."""
    first = 0
    for i in range(ngroups):
        b.first[i] = first
        first += b.g[i].nrows * b.g[i].nslices
    b.first[ngroups] = first
    b.ngroups = ngroups
    if first >= 2 ** 31:
        raise ValueError(f"books: {first} blocks")
    lib = _library()
    idx = (torch.cuda.current_device() if device.index is None
           else device.index)
    if idx not in _tickets:
        _tickets[idx] = torch.zeros(_MAX_SUMS, dtype=torch.int32,
                                    device=device)
    partial = torch.empty(first, dtype=_F64, device=device)
    b.partial, b.ticket = partial.data_ptr(), _tickets[idx].data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.books_reduce(ctypes.byref(b), first, stream)
    _build.check(status, "books_reduce")


def books_sum(*groups: Rows,
              weighted_mass: Callable = weighted_mass) -> torch.Tensor:
    """The groups' f64 sums, in order, as one (n,) tensor: on the card one
    launch of ``books_reduce_kernel<double>`` (at most 20 groups of at
    most 16 rows each, 127 sums); on the CPU ``books_sum_ref`` (which
    takes ``weighted_mass``)."""
    x0 = groups[0].x
    if on_cpu(x0, "books_sum"):
        return books_sum_ref(*groups, weighted_mass=weighted_mass)
    if len(groups) > _MAX_GROUPS:
        raise ValueError(f"books_sum: {len(groups)} groups, at most "
                         f"{_MAX_GROUPS}")
    nsums = sum(g.count() for g in groups)
    if nsums > _MAX_SUMS:
        raise ValueError(f"books_sum: {nsums} sums, at most {_MAX_SUMS}")
    out = torch.empty(nsums, dtype=_F64, device=x0.device)
    b, at = _Books(), 0
    for i, g in enumerate(groups):
        if g.x.device != x0.device:
            raise ValueError("books_sum: groups on more than one device")
        if g.w is None:
            x = _flat(g.x)
            n = x.numel()
            mask = None if g.mask is None else _flat(g.mask.reshape(-1),
                                                     torch.bool)
            _group(b.g[i], x, n, [0], (0, 1), [at],
                   extra=tuple(_flat(e) for e in g.extra), mask=mask)
        else:
            x2 = g.x if g.x.dim() == 2 else _flat(g.x).reshape(1, -1)
            rows = list(range(len(x2))) if g.rows is None else list(g.rows)
            scale = None if g.scale is None else _flat(g.scale)
            _group(b.g[i], x2, x2.shape[1], rows, x2.stride(),
                   range(at, at + len(rows)), w=_flat(g.w), scale=scale,
                   finite=True)
        at += g.count()
    b.out = out.data_ptr()
    _launch(b, len(groups), x0.device)
    books_sum.launches += 1
    return out


def books_repair(x: torch.Tensor, w: torch.Tensor, m_src, m_dst, wtot,
                 rows=None, into: bool = False, sums=None,
                 weighted_mass: Callable = weighted_mass):
    """The mass repair's write: (out (r, n) f64, sums or None).  ``x``
    ((nv, n), its rows ``rows``, default all) are destination means; each
    row r gets ``corr[r] = (m_src[r] - m_dst[r]) / wtot`` (1 for wtot <= 0)
    added where ``w`` > 0, non-finite values 0.  ``into``: the repaired
    rows are also written into x's rows in x's type where x is finite.
    ``sums``: for each index in it, the weighted sum of that repaired row
    with ``w``, returned as an f64 tensor in its order.  On the card one
    launch of ``books_reduce_kernel<double>``; on the CPU
    ``books_repair_ref``."""
    if on_cpu(x, "books_repair"):
        return books_repair_ref(x, w, m_src, m_dst, wtot, rows=rows,
                                into=into, sums=sums,
                                weighted_mass=weighted_mass)
    if x.dim() != 2:
        raise ValueError(f"books_repair: x {tuple(x.shape)}, want (nv, n)")
    rows = list(range(len(x))) if rows is None else list(rows)
    n = x.shape[1]
    m_src, m_dst, wtot = (_flat(t, _F64) for t in (m_src, m_dst, wtot))
    out = torch.empty((len(rows), n), dtype=_F64, device=x.device)
    sums = [] if sums is None else list(sums)
    sid = [sums.index(r) if r in sums else -1 for r in range(len(rows))]
    dsum = torch.empty(len(sums), dtype=_F64, device=x.device)
    w = _flat(w)
    if w.numel() != n:
        raise ValueError(f"books_repair: weights {tuple(w.shape)} beside "
                         f"rows of {n}")
    b = _Books()
    g = b.g[0]
    _group(g, x, n, rows, x.stride(), sid, w=w if sums else None,
           finite=True)
    g.rw = w.data_ptr()
    g.flags |= _RWF64 if w.dtype == _F64 else 0
    g.msrc, g.mdst, g.wtot = m_src.data_ptr(), m_dst.data_ptr(), \
        wtot.data_ptr()
    g.out64 = out.data_ptr()
    g.dst = x.data_ptr() if into else None
    b.out = dsum.data_ptr()
    _launch(b, 1, x.device)
    books_repair.launches += 1
    return out, (dsum if sums else None)


def books_stats(pre, dl, post, es, *, cell_area: float, rho: float,
                dt: float) -> torch.Tensor:
    """The 15-entry ledger row (``IceSheetCoupler.STAT_KEYS``) from a
    step's sums, f64 tensors: ``pre`` (5: H, enth, smb, rain, energy input
    over the lattice before the step), ``dl`` and ``es`` (7 each: the
    delivered and E-side weighted sums of smb_mass, rain_mass, rain_enth,
    smb_enth, deltah, heat_flux, geothermal_flux), ``post`` (7: H, enth,
    shed, mass clamp, enthalpy shed, enthalpy clamp, latent heat).  On the
    card one launch of ``books_stats_kernel``, the plain arithmetic's row
    bit for bit; on the CPU ``books_stats_ref``."""
    if on_cpu(pre, "books_stats"):
        return books_stats_ref(pre, dl, post, es, cell_area=cell_area,
                               rho=rho, dt=dt)
    ins = [_flat(t, _F64) for t in (pre, dl, post, es)]
    if [t.numel() for t in ins] != [5, 7, 7, 7]:
        raise ValueError(f"books_stats: sums of {[t.numel() for t in ins]}")
    st = torch.empty(15, dtype=_F64, device=pre.device)
    lib = _library()
    with torch.cuda.device(pre.device):
        stream = torch.cuda.current_stream(pre.device).cuda_stream
        status = lib.books_stats(*(t.data_ptr() for t in ins), st.data_ptr(),
                                 cell_area, rho, dt, cell_area * dt, stream)
    _build.check(status, "books_stats")
    books_stats.launches += 1
    return st


books_sum.launches = 0
books_repair.launches = 0
books_stats.launches = 0
