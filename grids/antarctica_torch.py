#!/usr/bin/env python
"""The port's twin of ``grids/antarctica.py``: the same grid and
file, through the port's classes (it imports nothing of the JAX
package).

Antarctica ice grid on the standard south polar stereographic projection
(EPSG:3031-style: lat_ts=-71, lon_0=0, WGS84), 6000x6000 km domain centered
on the pole (reference Antarctica grid scripts [U]).

    python grids/antarctica_torch.py 5 [out.nc]   # 5 km (config #5 scale)
"""
import sys

import numpy as np

from icebin_tpu_torch.grid.spec import GridSpecXY
from icebin_tpu_torch.io.ncio import write_grid

PROJ = "+proj=stere +lat_0=-90 +lat_ts=-71 +lon_0=0 +ellps=WGS84"
HALF = 3040e3


def antarctica_grid(res_km: float) -> GridSpecXY:
    step = res_km * 1e3
    n = int(round(2 * HALF / step))
    return GridSpecXY(xb=-HALF + step * np.arange(n + 1),
                      yb=-HALF + step * np.arange(n + 1),
                      projection=PROJ, name=f"ant_g{res_km:g}")


if __name__ == "__main__":
    res = float(sys.argv[1]) if len(sys.argv) > 1 else 20.0
    out = sys.argv[2] if len(sys.argv) > 2 else f"ant_g{res:g}.nc"
    spec = antarctica_grid(res)
    write_grid(out, spec)
    print(f"wrote {out}: {spec.name} ({spec.nx}x{spec.ny}, {res:g} km)")
