"""The port's own copy of ``icebin_tpu/coupler/e1ve0.py``; it imports
nothing of the reference package.

E1vE0: remap elevation-class state when the EC structure changes.

Reference: when ice topography evolves, the elevation-class weights of every
A cell change; extensive state the GCM holds per EC (snow, firn, energy)
must be remapped from the old E0 basis to the new E1 basis so mass/energy
survive matrix regeneration (reference: ``update_topo`` / E1vE0 construction
inside ``GCMCoupler_ModelE.cpp`` [U]; SURVEY.md section 2 "E1vE0").

TPU-native construction: both bases split the SAME exchange cells, so E1vE0
is a direct map over the intersection of the old and new kept-cell sets:

    M[e1, e0] = sum_x o_x * h1(x, e1) * h0(x, e0)

(up to 4 entries per shared exchange cell).  Mass on exchange cells that
exist only in the old mask (ice retreated) is *dropped here* and must be
booked by the caller's ledger; cells only in the new mask (ice advanced)
receive nothing from E0 and start at the contract default.
"""
from __future__ import annotations

import numpy as np

from icebin_tpu_torch.regrid.matrices import RegridMatrices
from icebin_tpu_torch.regrid.sparse import WeightedMatrix

__all__ = ["e1ve0_matrix"]


def e1ve0_matrix(rm_old: RegridMatrices, rm_new: RegridMatrices) -> WeightedMatrix:
    """(nE, nE) matrix remapping old-basis EC means to the new basis.

    Both factories must be built from the same exchange grid (identical
    geometry; only ``elevmaskI`` differs).
    """
    if rm_old.nE != rm_new.nE or len(rm_old.elevmaskI) != len(rm_new.elevmaskI):
        raise ValueError("E1vE0 requires factories over the same grids")
    common, i_old, i_new = np.intersect1d(rm_old.xg_index, rm_new.xg_index,
                                          return_indices=True)
    o = rm_old.o[i_old]
    rows, cols, vals = [], [], []
    for e1, w1 in ((rm_new.iE0[i_new], rm_new.wE0[i_new]),
                   (rm_new.iE1[i_new], rm_new.wE1[i_new])):
        for e0, w0 in ((rm_old.iE0[i_old], rm_old.wE0[i_old]),
                       (rm_old.iE1[i_old], rm_old.wE1[i_old])):
            rows.append(e1)
            cols.append(e0)
            vals.append(o * w1 * w0)
    return WeightedMatrix(rows=np.concatenate(rows),
                          cols=np.concatenate(cols),
                          vals=np.concatenate(vals),
                          shape=(rm_new.nE, rm_old.nE))
