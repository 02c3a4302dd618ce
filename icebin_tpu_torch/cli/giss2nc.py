"""`giss2nc`: convert GISS-format Fortran sequential binaries to NetCDF
(the port of ``icebin_tpu/cli/giss2nc.py``; reference ``giss2nc``
converter [U]; SURVEY.md section 2 "CLI executables").

    python -m icebin_tpu_torch.cli.giss2nc input.giss output.nc \
        [--shape JMxIM]

The same flags, output line and file as the reference's; it touches no
device.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
from scipy.io import netcdf_file

from icebin_tpu_torch.io.giss import read_giss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="giss2nc", description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--shape", help="JMxIM reshape override")
    args = ap.parse_args(argv)

    shape = None
    if args.shape:
        jm, im = (int(s) for s in args.shape.lower().split("x"))
        shape = (jm, im)
    recs = read_giss(args.input, shape=shape)
    with netcdf_file(args.output, "w") as nc:
        nc.history = f"giss2nc {args.input}"
        used = set()
        for r in recs:
            name = r.name or "field"
            k, base = 1, name
            while name in used:
                k += 1
                name = f"{base}_{k}"
            used.add(name)
            if r.data.ndim == 2:
                jm, im = r.data.shape
                dims = (f"jm{jm}", f"im{im}")
                for d, n in zip(dims, (jm, im)):
                    if d not in nc.dimensions:
                        nc.createDimension(d, n)
            else:
                d = f"n{r.data.size}"
                if d not in nc.dimensions:
                    nc.createDimension(d, r.data.size)
                dims = (d,)
            v = nc.createVariable(name, "f", dims)
            v[:] = np.asarray(r.data, np.float32)
            v.title = r.title
    print(f"giss2nc: {len(recs)} records -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
