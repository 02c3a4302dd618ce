"""Halo exchange between neighbouring ranks (port of
``icebin_tpu/parallel/halo.py``).

The reference shifts ghost rows round a ``ppermute`` ring inside
``shard_map``; here each rank sends its edge rows (columns) to its
neighbours along a mesh axis with one ``batch_isend_irecv``.  A rank at a
global edge replicates its own edge row (column) instead, the
zero-gradient boundary condition (``halo.py:33-38``): gathered, the padded
blocks are the single-rank lattice's ``_pad``
(``models/ice_sheet.py``) bit for bit.
"""
from __future__ import annotations

import torch

from icebin_tpu_torch.parallel.mesh import ICE_AXIS

__all__ = ["halo_exchange_rows", "halo_exchange_cols"]


def _halo(x, width: int, mesh, axis: str, dim: int):
    ax = mesh.axis(axis)
    n = x.shape[dim]
    lo_edge = x.narrow(dim, 0, width).contiguous()
    hi_edge = x.narrow(dim, n - width, width).contiguous()
    prev, nxt = ax.neighbour(-1), ax.neighbour(+1)
    sends, recvs = [], []
    if prev is not None:       # my low edge is prev's high ghost
        sends.append((lo_edge, prev))
        recvs.append((lo_edge, prev))
    if nxt is not None:
        sends.append((hi_edge, nxt))
        recvs.append((hi_edge, nxt))
    got = mesh.exchange(sends, recvs, key="halo")
    rep = [width if d == dim else -1 for d in range(x.dim())]
    ghost_lo = (got.pop(0) if prev is not None
                else x.narrow(dim, 0, 1).expand(*rep))
    ghost_hi = (got.pop(0) if nxt is not None
                else x.narrow(dim, n - 1, 1).expand(*rep))
    return torch.cat([ghost_lo, x, ghost_hi], dim=dim)


def halo_exchange_rows(x: torch.Tensor, width: int, mesh,
                       axis: str = ICE_AXIS) -> torch.Tensor:
    """x (ny_local, nx), this rank's y-block, padded with ``width`` ghost
    rows at both ends from its neighbours along ``axis`` (edge-replicated at
    the global ends)."""
    return _halo(x, width, mesh, axis, 0)


def halo_exchange_cols(x: torch.Tensor, width: int, mesh,
                       axis: str) -> torch.Tensor:
    """x-axis twin of ``halo_exchange_rows`` for the 2-D decomposition:
    ``width`` ghost columns from the neighbours along ``axis``."""
    return _halo(x, width, mesh, axis, 1)
