#!/usr/bin/env python
"""The port's twin of ``grids/modele_ll_g4x5.py``: the same grid and
file, through the port's classes (it imports nothing of the JAX
package).

ModelE 4 x 5 degree atmosphere grid (reference 4x5 grid script [U]).

    python grids/modele_ll_g4x5_torch.py [out.nc]
"""
import sys

from icebin_tpu_torch.grid.spec import modele_lonlat_grid
from icebin_tpu_torch.io.ncio import write_grid

if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "modele_ll_g4x5.nc"
    spec = modele_lonlat_grid(72, 45)
    write_grid(out, spec)
    print(f"wrote {out}: {spec.name} ({spec.nlon}x{spec.nlat})")
