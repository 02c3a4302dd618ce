"""The port's own copy of ``icebin_tpu/ops/smoother.py``; it imports nothing of
the reference package.

Conservative Gaussian smoothing matrix over an ice grid.

Reference: ``smoother.cpp`` builds a sigma-truncated Gaussian matrix over ice
cells that is composed into regrid matrices so smoothed fields remain mass
conservative; its sigma has THREE components -- two spatial and one in
ELEVATION, so smoothing never mixes cells across steep ice margins
(reference: ``slib/icebin/smoother.*``, ``RegridParams::sigma[3]`` [U];
SURVEY.md section 2 "Smoother").  TPU-native re-design: on a regular ice
lattice the Gaussian support is a bounded stencil window, so the matrix is
assembled from per-offset diagonals in vectorized numpy -- O(window *
ncells), no neighbor search.  Non-uniform border spacings are handled by
using TRUE center-to-center distances per cell pair (the window bound comes
from the smallest spacing).

Conservation construction: with cell areas a and raw kernel weights
g_ij = exp(-0.5 (dx/sx)^2 - 0.5 (dy/sy)^2 - 0.5 (dz/sz)^2) over icy cells,

    S[i, j] = g_ij * a_j / n_j,    n_j = sum_i a_i g_ij

so that sum_i a_i (S f)_i == sum_j a_j f_j for every field f (mass exactly
preserved, column-by-column).
"""
from __future__ import annotations

import numpy as np
from scipy import sparse

from icebin_tpu_torch.grid.spec import GridSpecXY

__all__ = ["smoothing_matrix"]


def smoothing_matrix(specI: GridSpecXY, mask, sigma, truncate: float = 3.0,
                     elev=None):
    """Build the (nI, nI) conservative Gaussian smoother as scipy CSR.

    specI: XY ice grid (uniform OR non-uniform border spacing).
    mask: (nI,) bool, True = icy cell (others get identity rows so
    composition leaves them untouched).
    sigma: (sigma_x, sigma_y) or (sigma_x, sigma_y, sigma_z) -- plane metres
    for x/y, metres of ELEVATION for z (reference ``sigma[3]``); a z
    component needs ``elev`` ((nI,) surface elevation, NaN off-ice).
    """
    sigma = tuple(float(s) for s in np.atleast_1d(sigma))
    if len(sigma) == 2:
        sx, sy, sz = sigma[0], sigma[1], 0.0
    elif len(sigma) == 3:
        sx, sy, sz = sigma
    else:
        raise ValueError(f"sigma must have 2 or 3 components, got {sigma}")
    if sz > 0 and elev is None:
        raise ValueError("sigma[2] (elevation) requires the elev array")

    dx = np.diff(specI.xb)
    dy = np.diff(specI.yb)
    cx = 0.5 * (specI.xb[1:] + specI.xb[:-1])        # per-axis centers
    cy = 0.5 * (specI.yb[1:] + specI.yb[:-1])
    nx, ny = specI.nx, specI.ny
    n = specI.ncells
    mask = np.asarray(mask, dtype=bool).reshape(-1)
    areas = specI.cell_areas()
    if elev is not None:
        elev = np.asarray(elev, dtype=np.float64).reshape(-1)

    # stencil window bound: the smallest spacing limits how many offsets a
    # truncate*sigma radius can span (non-uniform spacings reduce the true
    # reach per offset, never extend it)
    rx = int(np.ceil(truncate * sx / dx.min())) if sx > 0 else 0
    ry = int(np.ceil(truncate * sy / dy.min())) if sy > 0 else 0

    ii = np.arange(n, dtype=np.int64)
    gx = ii % nx
    gy = ii // nx

    rows_all, cols_all, g_all = [], [], []
    for oy in range(-ry, ry + 1):
        for ox in range(-rx, rx + 1):
            nxg = gx + ox
            nyg = gy + oy
            ok = (nxg >= 0) & (nxg < nx) & (nyg >= 0) & (nyg < ny)
            j = ii[ok]                      # source cell
            i = nyg[ok] * nx + nxg[ok]      # dest cell
            both = mask[i] & mask[j]
            i, j = i[both], j[both]
            # TRUE center distances (exact on non-uniform lattices)
            ddx = cx[i % nx] - cx[j % nx]
            ddy = cy[i // nx] - cy[j // nx]
            arg = np.zeros(len(i))
            if sx > 0:
                arg += 0.5 * (ddx / sx) ** 2
            if sy > 0:
                arg += 0.5 * (ddy / sy) ** 2
            if sz > 0:
                arg += 0.5 * ((elev[i] - elev[j]) / sz) ** 2
            w = np.exp(-arg)
            keep = w > np.exp(-0.5 * truncate ** 2) * 1e-3
            rows_all.append(i[keep])
            cols_all.append(j[keep])
            g_all.append(w[keep])
    rows = np.concatenate(rows_all)
    cols = np.concatenate(cols_all)
    g = np.concatenate(g_all)

    # Column normalization with area weights: S[i,j] = g a_j / n_j.
    nj = np.zeros(n)
    np.add.at(nj, cols, areas[rows] * g)
    vals = g * areas[cols] / nj[cols]

    # Identity rows for non-icy cells (composition pass-through).
    off = ii[~mask]
    rows = np.concatenate([rows, off])
    cols = np.concatenate([cols, off])
    vals = np.concatenate([vals, np.ones(len(off))])
    return sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))
