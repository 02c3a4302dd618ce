"""Regeneration on the device: the matrix factory, E1vE0 and the
elevation-class measures assembled from a device-resident exchange grid.

The host factory (``regrid.matrices.RegridMatrices``, ``WeightedMatrix``,
``coupler.e1ve0.e1ve0_matrix``, ``ops.csr.csr_pack``) sorts and scatters
millions of exchange cells in numpy at every regeneration.  Here the same
work runs where the ice state already lies:

* ``DeviceExchange``: a sheet's exchange grid (``iA``, ``iI``, ``area``;
  not the centroids, which no matrix reads) and the A grid's correctA
  factors, uploaded once.  A regridder hands its coupler one
  (``device_exchange``): a plain ``GCMRegridder`` its A-level exchange
  grid, ModelE's (``regrid.modele``) its O-level cells moved to A and
  scaled, so everything below reads A-level cells either way.
* ``DeviceRegridMatrices``: ``RegridMatrices``'s kept cells and
  elevation-class split from a device elevation mask (``nonzero`` keeps
  the kept cells ascending, as ``np.nonzero`` does; the split is
  ``elevation_class_split``'s operations in f64); ``coo(name)`` forms a
  matrix's entries in the order ``RegridMatrices.matrix`` concatenates
  them, with its products and correctA factor, and deduplicates them
  (``coo_dedup_device``); ``ec_weights``, ``fhc`` and ``elevE`` are the
  same segment sums keyed by E (and A) cell.
* ``e1ve0_device``: E1vE0 over the exchange cells kept in both
  generations (``keep_old & keep_new``, ascending: ``intersect1d``'s
  order), its four product blocks in ``e1ve0_matrix``'s order.

Every sum is a stable sort by key followed by ``ops.segsum.segment_sum``,
which adds each run of equal keys left to right: the terms ``coo_dedup``
(``np.add.at``), ``np.bincount`` and ``np.add.at`` add, in their order.
So every matrix, weight and measure is the host factory's bit for bit.
On CPU tensors the same code runs the plain segment sum.

``matrix(name)`` (the six user matrices) hands the tools a host
``WeightedMatrix`` of the device's entries (``WeightedMatrix.from_sorted``).
Sigma smoothing (a scipy product) and the G-space matrices are the host
factory's alone.
"""
from __future__ import annotations

import numpy as np
import torch

from icebin_tpu_torch.ops.segsum import segment_sum
from icebin_tpu_torch.regrid.matrices import RegridParams
from icebin_tpu_torch.regrid.sparse import WeightedMatrix

__all__ = ["DeviceExchange", "DeviceRegridMatrices", "coo_dedup_device",
           "e1ve0_device", "elevation_class_split_torch"]

_F64 = torch.float64
_I64 = torch.int64
#: the user matrices (``RegridMatrices.matrix``'s, less the G-space ones)
_NAMES = ("AvI", "IvA", "EvI", "IvE", "AvE", "EvA")


def elevation_class_split_torch(elev: torch.Tensor, hcdefs: torch.Tensor):
    """``regrid.matrices.elevation_class_split`` on f64 tensors, the same
    operations in the same order: (k0, k1, w0, w1)."""
    nhc = len(hcdefs)
    if nhc == 1:
        z = torch.zeros(elev.shape, dtype=_I64, device=elev.device)
        return z, z, torch.ones_like(elev), torch.zeros_like(elev)
    k = torch.clamp(torch.searchsorted(hcdefs, elev, right=True) - 1, 0,
                    nhc - 2)
    denom = hcdefs[k + 1] - hcdefs[k]
    t = torch.clamp((elev - hcdefs[k]) / denom, 0.0, 1.0)
    return k, k + 1, 1.0 - t, t


def _ptr(sorted_keys: torch.Tensor, n: int) -> torch.Tensor:
    """(n + 1,) int64 segment offsets of the keys 0..n-1 in ascending
    ``sorted_keys``."""
    return torch.searchsorted(sorted_keys,
                              torch.arange(n + 1, device=sorted_keys.device))


def _keyed_sums(keys: torch.Tensor, n: int, *vals: torch.Tensor):
    """Per key 0..n-1, the sum of each of ``vals`` over the entries with
    that key, in entry order (``np.add.at`` into zeros)."""
    skeys, perm = torch.sort(keys.to(torch.int32), stable=True)
    ptr = _ptr(skeys, n)
    return tuple(segment_sum(v[perm], ptr) for v in vals)


def coo_dedup_device(rows, cols, vals, shape):
    """``regrid.sparse.coo_dedup`` on int64/f64 tensors: the distinct
    (row, col) entries sorted by row, then column, each the sum of its
    duplicates in entry order."""
    ncols = int(shape[1])
    key = rows * ncols + cols
    skey, perm = torch.sort(key, stable=True)
    head = torch.ones(len(skey), dtype=torch.bool, device=skey.device)
    head[1:] = skey[1:] != skey[:-1]
    starts = torch.nonzero(head).flatten()
    ptr = torch.cat([starts, starts.new_tensor([len(skey)])])
    out = segment_sum(vals[perm], ptr)
    ukey = skey[starts]
    return ukey // ncols, ukey % ncols, out


class DeviceExchange:
    """One sheet's exchange grid and its regridder's A-grid constants on
    ``device``: what every regeneration of the sheet reads, uploaded
    once.  ``DeviceExchange(gr, sheet, device)`` takes a plain
    ``GCMRegridder``'s sheet, whose exchange grid must be against ``gr``'s
    A grid (``nA``); ``of`` takes exchange cells already placed on A (the
    ModelE regridder's, ``regrid.modele``)."""

    #: exchange cells whose O cell ModelE counts as ocean and that hold ice
    #: at set-up (``count_ocean_iced``); 0 where no cell is marked
    ocean_iced = 0

    def __init__(self, gr, sheet: str, device):
        sh = gr.sheets[sheet]
        xg = sh.exchange
        if int(xg.nA) != int(gr.nA):
            raise ValueError(
                f"sheet {sheet!r}'s exchange grid is against {xg.nA} GCM "
                f"cells, the regridder's A grid has {gr.nA}: an exchange "
                f"grid of another grid (a ModelE ocean grid O) is not read "
                f"as A's")
        # RegridMatrices.matrix's correctA factor
        native = np.asarray(gr.specA.cell_areas(), np.float64)
        proj = np.asarray(sh.areaA_proj, np.float64)
        self._upload(xg.iA, xg.iI, xg.area,
                     native / np.where(proj > 0, proj, 1.0), xg.nI,
                     gr.hcdefs, device, None)

    @classmethod
    def of(cls, iA, iI, area, cA, nI: int, hcdefs, device,
           ocean=None) -> "DeviceExchange":
        """Exchange cells (A cell, ice cell, area) with the A grid's
        correctA factors ``cA`` ((nA,): ``nA`` is its length); ``ocean``
        marks the cells ``count_ocean_iced`` counts."""
        xd = cls.__new__(cls)
        xd._upload(iA, iI, area, cA, nI, hcdefs, device, ocean)
        return xd

    def _upload(self, iA, iI, area, cA, nI, hcdefs, device, ocean):
        dev = torch.device(device)
        self.device = dev
        self.nA, self.nI = len(cA), int(nI)
        self.hcdefs = torch.as_tensor(np.asarray(hcdefs, np.float64),
                                      device=dev)
        self.iA = torch.as_tensor(np.asarray(iA, np.int64), device=dev)
        self.iI = torch.as_tensor(np.asarray(iI, np.int64), device=dev)
        self.area = torch.as_tensor(np.asarray(area, np.float64),
                                    device=dev)
        self.cA = torch.as_tensor(np.asarray(cA, np.float64), device=dev)
        self.ocean = (None if ocean is None else
                      torch.as_tensor(np.asarray(ocean, bool), device=dev))

    def max_entries(self, name: str) -> int:
        """The most entries user matrix ``name`` can have, whatever the
        elevation mask: an exchange cell gives one entry, or one for each
        of its two elevation classes where E is a side of the matrix,
        before duplicates merge (``DeviceRegridMatrices.coo``)."""
        return (2 if "E" in name else 1) * self.iA.numel()

    def count_ocean_iced(self, elevmaskI) -> int:
        """Set and return ``ocean_iced``: the marked cells whose ice cell
        holds ice in ``elevmaskI`` (one read on the host)."""
        if self.ocean is not None:
            mask = torch.as_tensor(elevmaskI).reshape(-1).to(self.device)
            self.ocean_iced = int((self.ocean
                                   & torch.isfinite(mask)[self.iI]).sum())
        return self.ocean_iced


class DeviceRegridMatrices:
    """``RegridMatrices`` of one elevation mask, on the exchange grid's
    device (module docstring)."""

    def __init__(self, xd: DeviceExchange, elevmaskI: torch.Tensor):
        self.xd = xd
        dev = xd.device
        self.elevmask = torch.as_tensor(elevmaskI).reshape(-1).to(
            device=dev, dtype=_F64)
        self.nA, self.nI = xd.nA, xd.nI
        self.nhc = len(xd.hcdefs)
        self.nE = self.nA * self.nhc
        #: exchange cells over iced cells, and their indices (ascending)
        self.keep = torch.isfinite(self.elevmask)[xd.iI]
        self.xg_index = torch.nonzero(self.keep).flatten()
        self.iA = xd.iA[self.xg_index]
        self.iI = xd.iI[self.xg_index]
        self.o = xd.area[self.xg_index]
        k0, k1, self.wE0, self.wE1 = elevation_class_split_torch(
            self.elevmask[self.iI], xd.hcdefs)
        self.iE0 = self.iA * self.nhc + k0
        self.iE1 = self.iA * self.nhc + k1
        self._ec = None
        self._host = {}

    def _fetched(self, key, x):
        if key not in self._host:
            self._host[key] = x.cpu().numpy()
        return self._host[key]

    # -- matrices ------------------------------------------------------------

    def coo(self, spec_name: str, params: RegridParams = RegridParams()):
        """Matrix ``spec_name`` (``RegridMatrices.matrix``, unsmoothed) as
        deduplicated device COO sorted by (row, col): (rows, cols, vals,
        shape)."""
        if spec_name not in _NAMES:
            raise ValueError(f"unknown regrid matrix {spec_name!r}; "
                             f"expected one of {_NAMES}")
        if params.sigma is not None:
            raise ValueError("the device factory does not smooth: sigma is "
                             "the host factory's (RegridMatrices)")
        dest, src = spec_name[0], spec_name[2]
        o = self.o
        if src == "E" or dest == "E":
            rows_ice = torch.cat([self.iI, self.iI])
            ecols = torch.cat([self.iE0, self.iE1])
            vals = torch.cat([o * self.wE0, o * self.wE1])
            arows = torch.cat([self.iA, self.iA])
        else:
            rows_ice, ecols, vals, arows = self.iI, None, o, self.iA
        space = {"I": (rows_ice, self.nI), "A": (arows, self.nA),
                 "E": (ecols, self.nE)}
        (didx, nd), (sidx, ns) = space[dest], space[src]
        if params.correctA:           # every user matrix has an A or E side
            vals = vals * self.xd.cA[arows]
        return (*coo_dedup_device(didx, sidx, vals, (nd, ns)), (nd, ns))

    def matrix(self, spec_name: str,
               params: RegridParams = RegridParams()) -> WeightedMatrix:
        """``RegridMatrices.matrix`` (unsmoothed) as a host
        ``WeightedMatrix`` of the device's entries."""
        rows, cols, vals, shape = self.coo(spec_name, params)
        return WeightedMatrix.from_sorted(rows.cpu().numpy(),
                                          cols.cpu().numpy(),
                                          vals.cpu().numpy(), shape)

    # -- elevation-class measures ------------------------------------------

    def _ec_sums(self, *terms):
        """Per E cell, each of ``terms`` (an (iE0-block, iE1-block) pair)
        summed in ``np.add.at``'s order: the iE0 block, then the iE1
        block, each in exchange order."""
        keys = torch.cat([self.iE0, self.iE1])
        return _keyed_sums(keys, self.nE,
                           *(torch.cat([a, b]) for a, b in terms))

    def ec_weights_device(self) -> torch.Tensor:
        """(nE,) f64 EC measure (``RegridMatrices.ec_weights``)."""
        if self._ec is None:
            (self._ec,) = self._ec_sums((self.o * self.wE0,
                                         self.o * self.wE1))
        return self._ec

    def ec_weights(self) -> np.ndarray:
        return self._fetched("ec_weights", self.ec_weights_device())

    def fhc(self) -> np.ndarray:
        """(nhc, nA) ``RegridMatrices.fhc``; memoized."""
        if "fhc" not in self._host:
            w = self.ec_weights_device()
            (wA,) = _keyed_sums(self.iA, self.nA, self.o)
            f = w.reshape(self.nA, self.nhc).T / torch.where(wA > 0, wA,
                                                             1.0)
            self._fetched("fhc", torch.where(wA[None, :] > 0, f, 0.0))
        return self._host["fhc"]

    def elevE(self) -> np.ndarray:
        """(nhc, nA) ``RegridMatrices.elevE``; memoized."""
        if "elevE" not in self._host:
            w = self.ec_weights_device()
            elev_x = self.elevmask[self.iI]
            (we,) = self._ec_sums((self.o * self.wE0 * elev_x,
                                   self.o * self.wE1 * elev_x))
            e = we / torch.where(w > 0, w, 1.0)
            self._host["elevE"] = torch.where(
                w > 0, e, torch.nan).reshape(self.nA,
                                             self.nhc).cpu().numpy().T
        return self._host["elevE"]


def e1ve0_device(rm_old: DeviceRegridMatrices,
                 rm_new: DeviceRegridMatrices) -> WeightedMatrix:
    """``coupler.e1ve0.e1ve0_matrix`` of two device factories over one
    exchange grid, fetched once as a host ``WeightedMatrix``."""
    if rm_old.xd is not rm_new.xd or rm_old.nE != rm_new.nE:
        raise ValueError("E1vE0 requires factories over the same grids")
    common = torch.nonzero(rm_old.keep & rm_new.keep).flatten()
    # each generation's kept index of the shared cells
    i_old = (torch.cumsum(rm_old.keep, 0) - 1)[common]
    i_new = (torch.cumsum(rm_new.keep, 0) - 1)[common]
    o = rm_old.o[i_old]
    rows, cols, vals = [], [], []
    for e1, w1 in ((rm_new.iE0[i_new], rm_new.wE0[i_new]),
                   (rm_new.iE1[i_new], rm_new.wE1[i_new])):
        for e0, w0 in ((rm_old.iE0[i_old], rm_old.wE0[i_old]),
                       (rm_old.iE1[i_old], rm_old.wE1[i_old])):
            rows.append(e1)
            cols.append(e0)
            vals.append(o * w1 * w0)
    shape = (rm_new.nE, rm_old.nE)
    r, c, v = coo_dedup_device(torch.cat(rows), torch.cat(cols),
                               torch.cat(vals), shape)
    return WeightedMatrix.from_sorted(r.cpu().numpy(), c.cpu().numpy(),
                                      v.cpu().numpy(), shape)
