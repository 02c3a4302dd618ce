"""`make_topoo`: generate ModelE TOPO boundary files (the port of
``icebin_tpu/cli/make_topoo.py``; reference ``make_topoo`` /
``make_merged_topoo`` CLIs [U]; SURVEY.md section 3.4).

    python -m icebin_tpu_torch.cli.make_topoo --base base.nc --out topoo.nc \
        --om 144x90 [--regridder gr.nc --elevmask sheet=elev.npy --merge] \
        [--device cuda|cpu]
    python -m icebin_tpu_torch.cli.make_topoo --synthetic 360x180 \
        --out topoo.nc --om 144x90 [--device cuda|cpu]

The same flags, output line and file (variables and attributes) as the
reference's.  ``--device`` (default cuda, and then a GPU is required) is
the regridder's device: where it clips the exchange grid of a sheet added
to it; the TOPO arithmetic is the host's numpy either way.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
from scipy.io import netcdf_file

FIELDS = ("focean", "flake", "fgrnd", "fgice", "zatmo")


def write_topo(path, topo):
    with netcdf_file(path, "w") as nc:
        nc.icebin_tpu_schema = 1
        nc.createDimension("nlonb", len(topo.spec.lonb))
        nc.createDimension("nlatb", len(topo.spec.latb))
        nc.createDimension("ncells", topo.spec.ncells)
        for nm, arr in (("lonb", topo.spec.lonb), ("latb", topo.spec.latb)):
            v = nc.createVariable(nm, "d", (f"n{nm}",))
            v[:] = arr
        for f in FIELDS:
            v = nc.createVariable(f.upper(), "d", ("ncells",))
            v[:] = getattr(topo, f)


def read_topo(path):
    from icebin_tpu_torch.grid.spec import GridSpecLonLat
    from icebin_tpu_torch.topo.topo import TopoFields
    with netcdf_file(path, "r", mmap=False) as nc:
        spec = GridSpecLonLat(lonb=np.array(nc.variables["lonb"][:]),
                              latb=np.array(nc.variables["latb"][:]))
        kw = {f: np.array(nc.variables[f.upper()][:]) for f in FIELDS}
    return TopoFields(spec=spec, **kw)


def _parse_grid(s):
    from icebin_tpu_torch.regrid.hntr import hntr_spec
    im, jm = (int(x) for x in s.lower().split("x"))
    return hntr_spec(im, jm)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="make_topoo", description=__doc__)
    ap.add_argument("--base", help="input base topo NetCDF (fine grid)")
    ap.add_argument("--synthetic", help="generate synthetic base at IMxJM")
    ap.add_argument("--om", required=True, help="ocean grid IMxJM")
    ap.add_argument("--out", required=True)
    ap.add_argument("--regridder", help="GCMRegridder nc for --merge")
    ap.add_argument("--elevmask", action="append", default=[],
                    help="sheet=path.npy flat elevmask arrays")
    ap.add_argument("--merge", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run the plain "
                 "versions on the CPU")

    from icebin_tpu_torch.topo.topo import (make_topoo, merge_topo,
                                            synthetic_z1qx1n)

    if args.synthetic:
        base = synthetic_z1qx1n(_parse_grid(args.synthetic))
    elif args.base:
        if args.base.lower().endswith((".giss", ".bs1", ".bin")):
            from icebin_tpu_torch.io.giss import read_z1qx1n
            base = read_z1qx1n(args.base)
        else:
            base = read_topo(args.base)
    else:
        ap.error("need --base or --synthetic")
    topoo = make_topoo(base, _parse_grid(args.om))

    if args.merge:
        from icebin_tpu_torch.io.ncio import read_gcmregridder
        gr = read_gcmregridder(args.regridder, device=device)
        masks = {}
        for kv in args.elevmask:
            name, path = kv.split("=", 1)
            masks[name] = np.load(path)
        topoo = merge_topo(topoo, gr, masks)
    write_topo(args.out, topoo)
    print(f"make_topoo: wrote {args.out} ({topoo.spec.ncells} cells"
          f"{', merged ' + str(len(args.elevmask)) + ' sheets' if args.merge else ''})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
