"""Grid/field plotting (the port of ``icebin_tpu/utils/plot.py``; reference
``ibplotter``/``plotutil`` parity [U]).

The same views over the port's grid specs and exchange grids.  Fields may
be numpy arrays or tensors on any device: each comes in through
``torch.as_tensor(x).cpu()``.

The reference draws per-cell polygon patches from the Grid's vertex soup;
here grids are specs, so lat-lon and XY lattice fields render as
``pcolormesh`` over the border arrays (exact cell geometry, far faster),
and exchange grids render as centroid scatters.  Matplotlib only -- import
is deferred so headless/runtime paths never pay for it.
"""
from __future__ import annotations

import numpy as np
import torch

from icebin_tpu_torch.grid.spec import Grid, GridSpecLonLat, GridSpecXY

__all__ = ["plot_field", "plot_exchange", "plot_fhc"]


def _spec(g):
    return g.spec if isinstance(g, Grid) else g


def _host(x):
    """A field as a host array (a device tensor copied to the CPU)."""
    return torch.as_tensor(x).detach().cpu().numpy()


def plot_field(grid, field, ax=None, title=None, units=None, **kw):
    """Plot a flat per-cell field on its grid (lat-lon or XY)."""
    import matplotlib.pyplot as plt

    spec = _spec(grid)
    f = np.asarray(_host(field), dtype=float).reshape(-1)
    if ax is None:
        _, ax = plt.subplots(figsize=(7, 5))
    if isinstance(spec, GridSpecLonLat):
        z = f.reshape(spec.nlat, spec.nlon)
        m = ax.pcolormesh(spec.lonb, spec.latb, z, **kw)
        ax.set_xlabel("lon [deg]")
        ax.set_ylabel("lat [deg]")
    elif isinstance(spec, GridSpecXY):
        z = f.reshape(spec.ny, spec.nx)
        m = ax.pcolormesh(spec.xb / 1e3, spec.yb / 1e3, z, **kw)
        ax.set_xlabel("x [km]")
        ax.set_ylabel("y [km]")
        ax.set_aspect("equal")
    else:
        raise TypeError(f"cannot plot on {type(spec)}")
    cb = ax.figure.colorbar(m, ax=ax)
    if units:
        cb.set_label(units)
    if title:
        ax.set_title(title)
    return ax


def plot_exchange(xg, ax=None, max_points: int = 100_000, **kw):
    """Exchange-grid overlap centroids colored by area (reference exchange
    grid plots)."""
    import matplotlib.pyplot as plt

    if xg.centroid is None:
        raise ValueError("exchange grid has no centroids")
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    n = xg.ncells
    sel = (np.random.default_rng(0).choice(n, max_points, replace=False)
           if n > max_points else slice(None))
    c = xg.centroid[sel]
    m = ax.scatter(c[:, 0] / 1e3, c[:, 1] / 1e3, c=xg.area[sel], s=2, **kw)
    ax.figure.colorbar(m, ax=ax, label="overlap area")
    ax.set_aspect("equal")
    ax.set_xlabel("x [km]")
    ax.set_ylabel("y [km]")
    return ax


def plot_fhc(specA: GridSpecLonLat, fhc, hcdefs, axes=None):
    """One panel per elevation class of the fhc field (TOPO diagnostics)."""
    import matplotlib.pyplot as plt

    fhc = _host(fhc)
    nhc = fhc.shape[0]
    if axes is None:
        _, axes = plt.subplots(1, nhc, figsize=(4 * nhc, 3.2))
    axes = np.atleast_1d(axes)
    for k in range(nhc):
        plot_field(specA, fhc[k], ax=axes[k],
                   title=f"fhc class {k} (z0={hcdefs[k]:g} m)",
                   vmin=0, vmax=1)
    return axes
