"""The production coupler decomposed over ranks (port of
``icebin_tpu/coupler/sharded.py``).

``MeshIceSheetCoupler`` is an ``IceSheetCoupler`` whose

* EvI/IvE and AvI/IvA are ``parallel.sharded_apply.ShardedView`` pairs
  over the rank's cells (K2's partials added across ranks, K1 on the
  rank's rows), and
* ice model is the halo-exchanged SIA step on the rank's y-block
  (``parallel.coupled.make_sharded_ice_step``),

while the f64 ledger, per-apply repair, regeneration cadence, E1vE0 of
GCM-held state, the writer, checkpoint/resume and the fused window are the
base class's: each rank runs them on its block, and every sum over the ice
lattice adds the ranks' partials in rank order (``_across``), so every rank
books the same ledger row, bit for bit, and two runs at one world size
agree bit for bit.

The lattice's y axis is cut into ceil(ny / ranks)-row blocks.  A RAGGED
(ny, ranks) pair pads the lattice to ny_pad = ranks * ceil(ny / ranks)
rows: pad rows replicate the last real row (zero boundary flux: the
trajectory is the single-rank run's), the active mask keeps them out of
the books and the harvest, and each rank's cells are its block's
(``sharded.py:70-80,98-104,110-125``).  Only a mesh that leaves some rank
no real row is rejected (``:74-77``).  Every rank regenerates the same
matrices from the gathered elevmask and packs its own cells; over ModelE's
mismatched regridder (``regrid.modele``) it cuts them from the retargeted
host factory, whose cells are A's as a plain regridder's are.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from icebin_tpu_torch.coupler.coupler import CouplerConfig, IceSheetCoupler
from icebin_tpu_torch.models.ice_sheet import (IceSheetConfig, IceSheetState,
                                               init_state)
from icebin_tpu_torch.parallel.coupled import make_sharded_ice_step, rows_of
from icebin_tpu_torch.parallel.sharded_apply import sharded_view_pair
from icebin_tpu_torch.utils.indexing import Domain

__all__ = ["MeshIceSheetCoupler"]


class MeshIceSheetCoupler(IceSheetCoupler):
    """One ice sheet's coupling state on this rank of a 1-D ``mesh``
    (``parallel.mesh.IceMesh``): ``state`` is the rank's (ny_l, nx) block
    of the row-padded lattice, ``ice_cfg`` the padded lattice's config,
    and ``ice_state`` (when given) the whole real lattice's state."""

    def __init__(self, gr, sheet: str, cfg: CouplerConfig, mesh,
                 ice_cfg: Optional[IceSheetConfig] = None,
                 ice_state: Optional[IceSheetState] = None, **kw):
        n = mesh.size
        specI = gr.sheets[sheet].specI
        self.mesh = mesh
        self.ny_real = specI.ny
        self.row0, self.ny_l, self.rows_real = rows_of(mesh, specI.ny)
        self.ny_pad = self.ny_l * n
        if (n - 1) * self.ny_l >= specI.ny:
            raise ValueError(
                f"{n} ranks leave some rank with no real rows of "
                f"ny={specI.ny} (ny_l={self.ny_l}); use fewer ranks")
        self.cells_per_shard = self.ny_l * specI.nx
        self.nice_pad = self.ny_pad * specI.nx
        if ice_cfg is None:
            ice_cfg = IceSheetConfig(nx=specI.nx, ny=specI.ny,
                                     dx=float(np.diff(specI.xb).mean()),
                                     dy=float(np.diff(specI.yb).mean()))
        if ice_cfg.ny not in (specI.ny, self.ny_pad):
            raise ValueError(f"ice_cfg.ny={ice_cfg.ny} != grid ny")
        real_cfg = dataclasses.replace(ice_cfg, ny=self.ny_real)
        if ice_state is None:          # the single-rank run's first state
            ice_state = init_state(real_cfg, device=mesh.device)
        super().__init__(gr, sheet, cfg, device=mesh.device,
                         ice_cfg=dataclasses.replace(ice_cfg,
                                                     ny=self.ny_pad),
                         ice_state=self._block(ice_state), **kw)
        if self.rows_real < self.ny_l:
            rows = torch.arange(self.ny_l, device=mesh.device)[:, None]
            self._active_mask = (rows < self.rows_real).expand(
                self.ny_l, specI.nx).contiguous()
        self.ice_step = make_sharded_ice_step(mesh, ny_real=self.ny_real)

    # -- the rank's block of the lattice ------------------------------------

    def _block(self, state: IceSheetState) -> IceSheetState:
        """The rank's rows of a whole-lattice state (real rows, or already
        padded), pad rows replicating the last real row."""
        def blk(a):
            a = torch.as_tensor(a, device=self.mesh.device)
            a = a.reshape(-1, a.shape[-1])[:self.ny_real]
            out = a[self.row0:self.row0 + self.rows_real]
            pad = self.ny_l - self.rows_real
            return torch.cat([out] + [a[-1:]] * pad) if pad else out
        return IceSheetState(H=blk(state.H), bed=blk(state.bed),
                             t=state.t.to(self.mesh.device),
                             enth=blk(state.enth))

    def place_state(self, state: IceSheetState) -> None:
        self.state = self._block(state)

    def gather_ice(self, f: torch.Tensor) -> torch.Tensor:
        """(..., cells of the block) -> (..., ny_real * nx), every rank's
        real cells in lattice order."""
        g = self.mesh.all_gather(f)                  # (n, ..., cps)
        g = g.movedim(0, -2).reshape(*f.shape[:-1], -1)
        return g[..., :self.ny_real * self.ice_cfg.nx]

    def gathered_state(self) -> IceSheetState:
        nx = self.ice_cfg.nx
        H, bed, enth = (self.gather_ice(a.reshape(-1)).reshape(-1, nx)
                        for a in (self.state.H, self.state.bed,
                                  self.state.enth))
        return IceSheetState(H=H, bed=bed, t=self.state.t, enth=enth)

    @property
    def local_domains(self):
        """Each rank's (y, x) block of the real lattice (``sharded.py:127``;
        the reference's per-rank ``ibmisc::Domain``)."""
        nx = self.ice_cfg.nx
        return [Domain(low=(d * self.ny_l, 0),
                       high=(min((d + 1) * self.ny_l, self.ny_real), nx))
                for d in range(self.mesh.size)]

    def elevmask(self) -> torch.Tensor:
        """The whole real lattice's elevmask, gathered (``:139-152``):
        every rank regenerates the same matrices from it."""
        return self.gather_ice(self.state.elevmask(self.cfg.min_thickness))

    def _across(self, *partials):
        return self.mesh.sum_ranks(*partials)

    # -- matrices -------------------------------------------------------------

    def _regen_on_device(self) -> bool:
        """A rank cuts its blocks from the host factory's ``rm.matrix``:
        its matrices are built on the host (``HostRegen``)."""
        return False

    def _build_mats(self) -> None:
        """EvI/IvE and AvI/IvA as sharded view pairs over the rank's cells
        (``sharded.py:164``); with sigma smoothing the reverse direction is
        packed from its own canonical matrix.  AvE/EvA map between the
        replicated A and E spaces: the base class's whole pack serves them
        on every rank (``:188``)."""
        share = self.cfg.params.sigma is None
        kw = dict(nv=self.cfg.nv, cells_per_shard=self.cells_per_shard,
                  nice_pad=self.nice_pad)
        for name in ("EvI", "AvI"):
            rev_name = "Iv" + name[0]
            fwd, rev = sharded_view_pair(
                self.mesh, self.rm.matrix(name, self.cfg.params), **kw)
            self._mats[name] = fwd
            if not share:
                rev = sharded_view_pair(
                    self.mesh, self.rm.matrix(rev_name, self.cfg.params),
                    small_axis="cols", **kw)[0]
            self._mats[rev_name] = rev
