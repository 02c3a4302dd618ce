#!/usr/bin/env python
"""The port's twin of ``grids/modele_ll_g2x2_5.py``: the same grid and
file, through the port's classes (it imports nothing of the JAX
package).

ModelE 2 x 2.5 degree atmosphere grid (reference grid script
``modele_ll_g2x2_5.py`` [U]; SURVEY.md section 3.1).

    python grids/modele_ll_g2x2_5_torch.py [out.nc]
"""
import sys

from icebin_tpu_torch.grid.spec import modele_lonlat_grid
from icebin_tpu_torch.io.ncio import write_grid

if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "modele_ll_g2x2_5.nc"
    spec = modele_lonlat_grid(144, 90)
    write_grid(out, spec)
    print(f"wrote {out}: {spec.name} ({spec.nlon}x{spec.nlat})")
