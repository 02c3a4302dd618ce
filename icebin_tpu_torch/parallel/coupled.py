"""Ice-domain-decomposed coupled steps (port of
``icebin_tpu/parallel/coupled.py``).

The ice lattice's y axis is cut into blocks of ceil(ny / ranks) rows, one
a rank (the 2-D decomposition cuts x as well); A/E fields are replicated.
Per step, on each rank:

1. IvE transport: K1 on the rank's rows, no communication;
2. SIA ice dynamics: ``models.ice_sheet.advance`` on the rank's block, its
   ghost layer a halo exchange of one row (and column) per substep for H
   and for the energy column U (``parallel.halo``), the CFL diffusivity
   max reduced over the ranks (``all_reduce(MAX)``) before the substep
   loop reads ``t_done < dt`` -- so every rank takes the same substeps;
3. EvI harvest: K2's partial E sums, added across the ranks in rank order.

``make_sharded_ice_step`` is the production coupler's ice model
(``coupler.sharded``); ``shard_coupled_setup``/``make_sharded_step`` and
their 2-D twins are the reference's demonstration steps.  The reference's
TPU layout rules (``nx % 128``, ``:17-19``, ``:130-133``) do not apply:
any ny, nx splits, the last block padded (ragged).
"""
from __future__ import annotations

import numpy as np
import torch

from icebin_tpu_torch.models.ice_sheet import (RHO_ICE, IceSheetConfig,
                                               IceSheetState, advance)
from icebin_tpu_torch.parallel.halo import (halo_exchange_cols,
                                            halo_exchange_rows)
from icebin_tpu_torch.parallel.mesh import (ICE_AXIS, ICE_X, ICE_Y,
                                            make_mesh_2d)
from icebin_tpu_torch.ops.apply import apply_view
from icebin_tpu_torch.ops.csr import csr_pack
from icebin_tpu_torch.parallel.sharded_apply import (ShardedCsr, ShardedView,
                                                     sharded_csr_from_weighted)
from icebin_tpu_torch.regrid.sparse import WeightedMatrix

__all__ = ["make_sharded_ice_step", "shard_coupled_setup",
           "make_sharded_step", "make_mesh_2d", "shard_coupled_setup_2d",
           "make_sharded_step_2d", "rows_of"]


def rows_of(mesh, ny: int, axis: str = ICE_AXIS):
    """(first row, rows per rank, this rank's physical rows) of an ny-row
    lattice cut along ``axis`` into ceil(ny / ranks)-row blocks."""
    ax = mesh.axis(axis)
    ny_l = -(-ny // ax.size)
    r0 = ax.index * ny_l
    return r0, ny_l, min(max(ny - r0, 0), ny_l)


def _padx(a):
    """Edge-replicated ghost columns (x is not cut in the 1-D mesh)."""
    return torch.cat([a[:, :1], a, a[:, -1:]], dim=1)


def make_sharded_ice_step(mesh, ny_real=None):
    """``models.ice_sheet.step_coupled`` on this rank's y-block
    (``coupled.py:41-121``): fn(cfg, state, smb_flux, tsurf, dt,
    enth_flux=None) -> (state, IceFluxes), state and fields the rank's
    (ny_l, nx) block, the scalar clamp books the rank's partials (the
    coupler adds them across ranks).

    ``ny_real``: the lattice's physical rows when its last block is padded
    (RAGGED decomposition): the pad rows hold copies of the last real row,
    re-copied after every substep, so the flux across the real/pad face is
    exactly zero and the physical rows are the single-rank step's bit for
    bit; pad-row fluxes stay out of the books (``:161-256``)."""
    def ghost(a):
        return _padx(halo_exchange_rows(a, 1, mesh))

    def step_like(cfg, state, smb_flux, tsurf, dt, enth_flux=None):
        rows = None
        if ny_real is not None:
            rows = rows_of(mesh, ny_real)[2]
        return advance(cfg, state, smb_flux, tsurf, dt, enth_flux,
                       ghost=ghost, global_max=mesh.max, rows_real=rows)

    # the reference's fusibility flag (coupler.run_transient reads it)
    step_like.jittable = True
    return step_like


def _local_cells(ny, nx, r0, r1, x0, x1):
    """Flat global indices of lattice block [r0, r1) x [x0, x1), in the
    block's own row-major order."""
    rr, cc = np.meshgrid(np.arange(r0, r1), np.arange(x0, x1),
                         indexing="ij")
    return (rr * nx + cc).reshape(-1)


def _block_matrix(M, cells):
    """(small x ice) ``M`` restricted to the ice cells ``cells``
    (renumbered 0..k-1 in that order), with the global small weights and
    those cells' own."""
    where = np.full(M.shape[1], -1)
    where[cells] = np.arange(len(cells))
    sel = where[M.cols] >= 0
    B = WeightedMatrix(rows=M.rows[sel], cols=where[M.cols[sel]],
                       vals=np.asarray(M.vals)[sel],
                       shape=(M.shape[0], len(cells)))
    B._wM = np.asarray(M.wM, np.float64)
    B._Mw = np.asarray(M.Mw, np.float64)[cells]
    return B


def shard_coupled_setup(mesh, ive, evi, state: IceSheetState,
                        ice_cfg: IceSheetConfig, nv: int = 16):
    """This rank's operands for ``make_sharded_step`` (``coupled.py:124``):
    ``ive``/``evi`` are the global IvE and EvI ``WeightedMatrix``es, state
    the global lattice state; returns a dict of the rank's IvE and EvI
    views and its (ny_l, nx) H and bed blocks (the last block padded by
    replicating the last real row)."""
    r0, ny_l, rows = rows_of(mesh, ice_cfg.ny)
    cps = ny_l * ice_cfg.nx
    nice_pad = ny_l * mesh.size * ice_cfg.nx
    kw = dict(nv=nv, cells_per_shard=cps, nice_pad=nice_pad)
    ops = {"ive": ShardedView(mesh, sharded_csr_from_weighted(
               mesh, ive, small_axis="cols", **kw), transposed=True),
           "evi": ShardedView(mesh, sharded_csr_from_weighted(
               mesh, evi, small_axis="rows", **kw), transposed=False)}
    for k in ("H", "bed"):
        a = getattr(state, k)
        blk = a[r0:r0 + rows]
        if rows < ny_l:
            blk = torch.cat([blk] + [a[ice_cfg.ny - 1:]] * (ny_l - rows))
        ops[k] = blk.to(mesh.device)
    return ops


def _harvest(H1, bed):
    """(3, n) elevation, thickness and mask of the icy cells (0 elsewhere),
    the demonstration steps' harvest."""
    icy = H1.reshape(-1) > 1.0
    return torch.stack([torch.where(icy, (H1 + bed).reshape(-1), 0.0),
                        torch.where(icy, H1.reshape(-1), 0.0),
                        icy.to(H1.dtype)])


def _transport(ive, fE_in, fac, off):
    """IvE of the finite-cleaned forcing, scaled, 0 off the matrix, then
    ``fac``/``off`` on the covered cells (``coupled.py:281-287``)."""
    fs = torch.where(torch.isfinite(fE_in), fE_in, 0.0)
    fI = apply_view(ive, fs, fill=0.0)
    cov = (ive.wM != 0).to(fI.dtype)
    return fI * fac[:, None] + off[:, None] * cov[None, :]


def make_sharded_step(mesh, ice_cfg: IceSheetConfig, nsmall_E: int,
                      dt: float, rho_ice: float = RHO_ICE):
    """The demonstration coupled step (``coupled.py:257``):
    fn(ops, fE_in, fac, off) -> (H1 block, fI (nvar, cells of the block),
    fE_out (3, nE) replicated).  Mass-only SIA (no energy column, no
    ablation) on the rank's rows; ragged lattices pad their last block."""
    _, ny_l, rows = rows_of(mesh, ice_cfg.ny)
    ice_step = make_sharded_ice_step(mesh, ny_real=ice_cfg.ny)

    def fn(ops, fE_in, fac, off):
        fI = _transport(ops["ive"], fE_in, fac, off)
        smb = fI[0].reshape(ny_l, ice_cfg.nx)
        st = IceSheetState(H=ops["H"], bed=ops["bed"],
                           t=torch.zeros((), dtype=torch.float64,
                                         device=ops["H"].device),
                           enth=torch.zeros_like(ops["H"]))
        st1, _ = ice_step(ice_cfg, st, smb * (RHO_ICE / rho_ice), None, dt)
        H1 = st1.H
        fE_out = apply_view(ops["evi"], _harvest(H1, ops["bed"]))
        return H1, fI, fE_out

    return fn


def shard_coupled_setup_2d(mesh, evi, state: IceSheetState,
                           ice_cfg: IceSheetConfig, nv: int = 16):
    """This rank's operands of the 2-D step (``coupled.py:324``): ONE pack
    of the global EvI over the rank's (ny_l, nx_l) lattice block (IvE is
    its transpose) and the block's H and bed.  ny and nx must split evenly
    over the mesh."""
    ny_dev, nx_dev = mesh.shape
    if ice_cfg.ny % ny_dev or ice_cfg.nx % nx_dev:
        raise ValueError("grid does not tile the 2-D mesh")
    ny_l, nx_l = ice_cfg.ny // ny_dev, ice_cfg.nx // nx_dev
    iy, ix = mesh.axis(ICE_Y).index, mesh.axis(ICE_X).index
    r0, x0 = iy * ny_l, ix * nx_l
    cells = _local_cells(ice_cfg.ny, ice_cfg.nx, r0, r0 + ny_l, x0,
                         x0 + nx_l)
    sc = ShardedCsr(pack=csr_pack(_block_matrix(evi, cells), nv=nv,
                                  device=mesh.device),
                    c0=0, cells_per_shard=len(cells), nice=len(cells))
    return {"evi": ShardedView(mesh, sc, transposed=False),
            "ive": ShardedView(mesh, sc, transposed=True),
            "H": state.H[r0:r0 + ny_l, x0:x0 + nx_l].to(mesh.device),
            "bed": state.bed[r0:r0 + ny_l, x0:x0 + nx_l].to(mesh.device)}


def make_sharded_step_2d(mesh, ice_cfg: IceSheetConfig, nsmall_E: int,
                         dt: float, rho_ice: float = RHO_ICE):
    """2-D (icey, icex) demonstration step (``coupled.py:352``): one pack
    applied both ways, halos on both axes, the CFL max and the E partial
    sums over the whole mesh.  fn(ops, fE_in, fac, off) -> (H1 block, fI
    (nvar, cells of the block), fE_out replicated)."""
    ny_dev, nx_dev = mesh.shape
    ny_l, nx_l = ice_cfg.ny // ny_dev, ice_cfg.nx // nx_dev

    def ghost(a):
        return halo_exchange_cols(halo_exchange_rows(a, 1, mesh, ICE_Y), 1,
                                  mesh, ICE_X)

    def fn(ops, fE_in, fac, off):
        ive = ops["ive"]
        fs = torch.where(torch.isfinite(fE_in), fE_in, 0.0)
        fs = torch.where(ive.Mw[None, :] != 0, fs, 0.0)
        fI = _transport(ive, fs, fac, off)
        smb = fI[0].reshape(ny_l, nx_l)
        st = IceSheetState(H=ops["H"], bed=ops["bed"],
                           t=torch.zeros((), dtype=torch.float64,
                                         device=ops["H"].device),
                           enth=torch.zeros_like(ops["H"]))
        st1, _ = advance(ice_cfg, st, smb * (RHO_ICE / rho_ice), None, dt,
                         ghost=ghost, global_max=mesh.max)
        fE_out = apply_view(ops["evi"], _harvest(st1.H, ops["bed"]))
        return st1.H, fI, fE_out

    return fn
