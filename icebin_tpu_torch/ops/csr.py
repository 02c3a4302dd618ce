"""Device pack of a regrid matrix: one destination-sorted CSR per direction.

Port of the packing half of ``icebin_tpu/ops/pallas_bdt.py``
(``pallas_from_weighted``, ``PallasView``, ``pallas_view_pair``).  The TPU
pack's 8x128 tiles, pseudo-blocks, E3 lane order and W8 band exist only to
avoid gathers on the TPU (``icebin_tpu/ops/bdt.py`` docstring); Hopper
gathers natively, so each direction is stored as a plain CSR sorted by
destination: f32 values, int32 column indices, and the f32 inverse
destination weight ``winv = 1/w`` (computed in f64; 0 where w = 0).  Two
copies of the matrix cost twice its bytes but give both applies a fixed,
atomic-free summation order.  Each CSR also holds the list of its live
(non-empty) rows, longest first, which the dest-small kernel launches over;
it is derived from ``rowptr`` whenever a ``Csr`` is made, so a CSR made
from another (``dataclasses.replace``) gets its own.

Two ways in: ``csr_pack`` packs a host ``WeightedMatrix`` (host arrays,
then copies), and ``csr_pack_sorted`` packs a deduplicated COO already
on the device, sorted by (row, col), without leaving it: the same CSRs
and weights bit for bit, the weights summed by ``ops.segsum`` in the
order ``np.bincount`` sums them.  ``CsrBuffers`` holds one matrix's packs,
generation after generation, at fixed device addresses (a captured CUDA
graph reads them there).
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from icebin_tpu_torch.utils.trace import span

__all__ = ["Csr", "CsrPack", "CsrView", "CsrBuffers", "csr_from_coo",
           "csr_pack", "csr_pack_sorted", "csr_view_pair"]

_I32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass
class Csr:
    """Destination-sorted CSR of one apply direction (dest x src)."""

    rowptr: torch.Tensor      # (n_dst + 1,) int32
    cols: torch.Tensor        # (nnz,) int32 source indices
    vals: torch.Tensor        # (nnz,) f32 unscaled entries
    winv: torch.Tensor        # (n_dst,) f32 1/w_dst (0 where w_dst == 0)
    n_dst: int
    n_src: int
    # (n_live,) int32: the non-empty rows, longest first (ties by index).
    # Always derived from rowptr when a Csr is made (a value passed in,
    # e.g. copied by dataclasses.replace, is replaced).
    live: torch.Tensor | None = dataclasses.field(default=None, repr=False,
                                                  compare=False)
    n_live: int | None = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        # once per pack, on the rowptr's device; one host sync for n_live
        lens = self.rowptr[1:] - self.rowptr[:-1]
        order = torch.argsort(lens, descending=True, stable=True)
        self.n_live = int((lens > 0).sum())
        self.live = order[:self.n_live].to(torch.int32)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def rows(self) -> torch.Tensor:
        """(nnz,) int64 destination row of every nonzero."""
        counts = (self.rowptr[1:] - self.rowptr[:-1]).to(torch.int64)
        return torch.repeat_interleave(
            torch.arange(self.n_dst, device=self.device), counts)


def csr_from_coo(dst, src, vals, n_dst: int, n_src: int, w_dst, *,
                 device) -> Csr:
    """Pack COO entries (dst, src, vals) sorted by (dst, src): the host
    arrays first (span ``regen.pack``), then their copies to ``device`` and
    the live rows derived there (``regen.upload``)."""
    with span("regen.pack"):
        dst = np.asarray(dst, np.int64)
        src = np.asarray(src, np.int64)
        if len(vals) > _I32_MAX or max(n_dst, n_src) > _I32_MAX:
            raise ValueError("matrix too large for int32 CSR indices")
        order = np.lexsort((src, dst))
        rowptr = np.zeros(n_dst + 1, np.int64)
        np.cumsum(np.bincount(dst, minlength=n_dst), out=rowptr[1:])
        w = np.asarray(w_dst, np.float64)
        winv = np.where(w != 0, 1.0 / np.where(w != 0, w, 1.0), 0.0)
        host = (rowptr.astype(np.int32), src[order].astype(np.int32),
                np.asarray(vals, np.float64)[order].astype(np.float32),
                winv.astype(np.float32))
    with span("regen.upload"):
        rowptr, cols, vals, winv = (torch.from_numpy(a).to(device)
                                    for a in host)
        return Csr(rowptr=rowptr, cols=cols, vals=vals, winv=winv,
                   n_dst=int(n_dst), n_src=int(n_src))


@dataclasses.dataclass
class CsrPack:
    """Both directions of one matrix in its canonical (small x ice)
    orientation: ``small`` applies with the dest-small kernel (EvI/AvI),
    ``ice`` with the dest-ice kernel (IvE/IvA).  Weights are f64: the
    coupler's mass books read them."""

    small: Csr
    ice: Csr
    wS: torch.Tensor          # (nsmall,) f64
    wI: torch.Tensor          # (nice,) f64
    nv: int                   # field batch width of one kernel call

    @property
    def nsmall(self) -> int:
        return self.small.n_dst

    @property
    def nice(self) -> int:
        return self.ice.n_dst


def csr_pack(M, small_axis: str = "rows", nv: int = 16, *,
             device) -> CsrPack:
    """Pack a ``WeightedMatrix`` for the device (``pallas_from_weighted``'s
    counterpart).  ``small_axis`` names M's few-and-long-rows side."""
    if small_axis == "rows":
        s, i = M.rows, M.cols
        nsmall, nice = M.shape
        wS, wI = M.wM, M.Mw
    elif small_axis == "cols":
        s, i = M.cols, M.rows
        nice, nsmall = M.shape
        wS, wI = M.Mw, M.wM
    else:
        raise ValueError(f"small_axis must be 'rows' or 'cols', "
                         f"got {small_axis!r}")
    small = csr_from_coo(s, i, M.vals, nsmall, nice, wS, device=device)
    ice = csr_from_coo(i, s, M.vals, nice, nsmall, wI, device=device)
    with span("regen.upload"):
        return CsrPack(
            small=small, ice=ice,
            wS=torch.as_tensor(np.asarray(wS, np.float64), device=device),
            wI=torch.as_tensor(np.asarray(wI, np.float64), device=device),
            nv=int(nv))


def _winv(w: torch.Tensor) -> torch.Tensor:
    """f32 ``1/w`` computed in f64, 0 where w = 0 (``csr_from_coo``'s)."""
    nz = w != 0
    return torch.where(nz, 1.0 / torch.where(nz, w, 1.0), 0.0).to(
        torch.float32)


def csr_pack_sorted(rows: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor, shape, nv: int = 16) -> CsrPack:
    """``csr_pack(M)`` (rows the small side) of the matrix whose entries
    are the deduplicated int64 ``rows``, ``cols`` and f64 ``vals``, sorted
    by (row, col), built where they lie (span ``regen.pack``).  The small
    CSR is the entries as they are; the ice CSR is a stable sort by
    column, which leaves each column's rows ascending, as ``np.lexsort``
    orders them; ``wS`` and ``wI`` sum each row's and column's values in
    the order ``np.bincount`` does."""
    from icebin_tpu_torch.ops.segsum import segment_sum
    nsmall, nice = (int(n) for n in shape)
    if len(vals) > _I32_MAX or max(nsmall, nice) > _I32_MAX:
        raise ValueError("matrix too large for int32 CSR indices")
    with span("regen.pack"):
        dev = vals.device
        ptr_s = torch.searchsorted(rows, torch.arange(nsmall + 1,
                                                      device=dev))
        wS = segment_sum(vals, ptr_s)
        order = torch.sort(cols.to(torch.int32), stable=True).indices
        cols_sorted = cols[order]
        ptr_i = torch.searchsorted(cols_sorted, torch.arange(nice + 1,
                                                             device=dev))
        vals_i = vals[order]
        wI = segment_sum(vals_i, ptr_i)
        small = Csr(rowptr=ptr_s.to(torch.int32),
                    cols=cols.to(torch.int32),
                    vals=vals.to(torch.float32), winv=_winv(wS),
                    n_dst=nsmall, n_src=nice)
        ice = Csr(rowptr=ptr_i.to(torch.int32),
                  cols=rows[order].to(torch.int32),
                  vals=vals_i.to(torch.float32), winv=_winv(wI),
                  n_dst=nice, n_src=nsmall)
        return CsrPack(small=small, ice=ice, wS=wS, wI=wI, nv=int(nv))


class CsrBuffers:
    """Device buffers one matrix's packs are loaded into, generation after
    generation, so that each pack's tensors lie at the same addresses: the
    rowptr, winv and weights of both CSRs, the small CSR's live rows, and
    both CSRs' columns and values at ``capacity`` entries.  A CUDA graph
    captured over one loaded pack reads every later one (the dest-small
    launches' geometry aside, ``ops.apply.rebind_dest_small``)."""

    def __init__(self, nsmall: int, nice: int, capacity: int, nv: int, *,
                 device):
        def empty(n, dtype):
            return torch.empty(n, dtype=dtype, device=device)

        i32, f32 = torch.int32, torch.float32
        self.capacity = int(capacity)
        self.nv = int(nv)
        self.small = {"rowptr": empty(nsmall + 1, i32),
                      "cols": empty(capacity, i32),
                      "vals": empty(capacity, f32),
                      "winv": empty(nsmall, f32), "live": empty(nsmall, i32)}
        self.ice = {"rowptr": empty(nice + 1, i32),
                    "cols": empty(capacity, i32),
                    "vals": empty(capacity, f32), "winv": empty(nice, f32)}
        self.wS = empty(nsmall, torch.float64)
        self.wI = empty(nice, torch.float64)

    def load(self, pack: CsrPack) -> CsrPack:
        """Copy ``pack`` into the buffers (on the current stream, so after
        whatever was enqueued to read the last pack) and return it as a
        pack of exact-length slices of them."""
        nnz = pack.small.vals.numel()
        if nnz > self.capacity:
            raise ValueError(f"a pack of {nnz} entries overflows buffers of "
                             f"{self.capacity}")
        if ((pack.nsmall, pack.nice, pack.nv)
                != (len(self.wS), len(self.wI), self.nv)):
            raise ValueError("the pack's shape is not the buffers'")

        def into(buf, csr):
            out = copy.copy(csr)          # keeps the live rows csr derived
            for k, t in buf.items():
                src = getattr(csr, k)
                setattr(out, k, t[:src.numel()])
                getattr(out, k).copy_(src)
            return out

        self.wS.copy_(pack.wS)
        self.wI.copy_(pack.wI)
        return CsrPack(small=into(self.small, pack.small),
                       ice=into(self.ice, pack.ice), wS=self.wS, wI=self.wI,
                       nv=pack.nv)


@dataclasses.dataclass
class CsrView:
    """A logical direction over a pack (``PallasView``'s counterpart):
    ``transposed=False`` is small <- ice (EvI/AvI), ``True`` ice <- small
    (IvE/IvA)."""

    pack: CsrPack
    transposed: bool

    @property
    def wM(self) -> torch.Tensor:
        return self.pack.wI if self.transposed else self.pack.wS

    @property
    def Mw(self) -> torch.Tensor:
        return self.pack.wS if self.transposed else self.pack.wI

    @property
    def logical_shape(self):
        p = self.pack
        return (p.nice, p.nsmall) if self.transposed else (p.nsmall, p.nice)

    def apply_core(self, f: torch.Tensor, scale: bool = True) -> torch.Tensor:
        """(nvar, n) through this direction's kernel (``ops.apply``'s
        ``apply_ice`` or ``apply_small``), before ``apply_view``'s fill and
        unit conversion."""
        from icebin_tpu_torch.ops.apply import apply_ice, apply_small
        return (apply_ice if self.transposed else apply_small)(
            self.pack, f, scale=scale)


def csr_view_pair(M, nv: int = 16, small_axis: str = "rows", *, device):
    """(forward_view, reverse_view) over one pack of ``M``: forward applies
    M itself, reverse its transpose."""
    pack = csr_pack(M, small_axis=small_axis, nv=nv, device=device)
    fwd = CsrView(pack, transposed=(small_axis == "cols"))
    return fwd, CsrView(pack, transposed=not fwd.transposed)
