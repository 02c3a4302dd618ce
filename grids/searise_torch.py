#!/usr/bin/env python
"""The port's twin of ``grids/searise.py``: the same grid and
file, through the port's classes (it imports nothing of the JAX
package).

SeaRISE Greenland grids (reference ``sr_g20_*`` / ``searise.py`` grid
scripts [U]): polar stereographic lat_ts=71, lon_0=-39 (WGS84), the SeaRISE
dataset's standard projection and extent.

    python grids/searise_torch.py 20 [out.nc]     # 20 km grid (sr_g20)
    python grids/searise_torch.py 5  [out.nc]     # 5 km grid  (sr_g5)
"""
import sys

import numpy as np

from icebin_tpu_torch.grid.spec import GridSpecXY
from icebin_tpu_torch.io.ncio import write_grid

#: SeaRISE Greenland projection (dataset standard).
PROJ = "+proj=stere +lat_0=90 +lat_ts=71 +lon_0=-39 +ellps=WGS84"
#: SeaRISE domain corners in the projection plane [m] (lower-left at
#: lon/lat (-133.84, 49.34)-ish; 301 x 561 nodes at 5 km).
X0, Y0 = -800e3, -3400e3
NX5, NY5 = 301, 561


def searise_grid(res_km: float) -> GridSpecXY:
    step = res_km * 1e3
    nx = int(round((NX5 - 1) * 5.0 / res_km))
    ny = int(round((NY5 - 1) * 5.0 / res_km))
    return GridSpecXY(xb=X0 + step * np.arange(nx + 1),
                      yb=Y0 + step * np.arange(ny + 1),
                      projection=PROJ, name=f"sr_g{res_km:g}")


if __name__ == "__main__":
    res = float(sys.argv[1]) if len(sys.argv) > 1 else 20.0
    out = sys.argv[2] if len(sys.argv) > 2 else f"sr_g{res:g}.nc"
    spec = searise_grid(res)
    write_grid(out, spec)
    print(f"wrote {out}: {spec.name} ({spec.nx}x{spec.ny}, {res:g} km)")
