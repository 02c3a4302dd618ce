"""`global_ec`: build + store global elevation-class matrices, compressed
(the port of ``icebin_tpu/cli/global_ec.py``).

Reference: ``global_ec`` writes the global AvE/EvA/AvI... matrix set as
RLE-compressed NetCDF for ModelE input (reference ``modele/global_ec.cpp``,
ibmisc zarray [U]; SURVEY.md section 3.4).

    python -m icebin_tpu_torch.cli.global_ec gr.nc out.nc \
        --elevmask sheet=elev.npy [--matrices AvI,EvI,IvE] [--uncompressed] \
        [--device cuda|cpu]

The same flags, output line and file (variables, attributes and zarray
blobs) as the reference's.  ``--device`` (default cuda, and then a GPU is
required) is the regridder's device: where it clips the exchange grid of a
sheet added to it; the matrices are the host's f64 numpy either way.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="global_ec", description=__doc__)
    ap.add_argument("regridder")
    ap.add_argument("out")
    ap.add_argument("--elevmask", action="append", required=True,
                    help="sheet=path.npy")
    ap.add_argument("--matrices", default="AvI,IvA,EvI,IvE,AvE,EvA")
    ap.add_argument("--uncompressed", action="store_true")
    ap.add_argument("--no-correctA", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from scipy.io import netcdf_file

    from icebin_tpu_torch.io.ncio import read_gcmregridder
    from icebin_tpu_torch.io.zarray import encode_zarray
    from icebin_tpu_torch.regrid.matrices import RegridParams

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run the plain "
                 "versions on the CPU")
    gr = read_gcmregridder(args.regridder, device=device)
    params = RegridParams(scale=True, correctA=not args.no_correctA)
    names = [s for s in args.matrices.split(",") if s]

    with netcdf_file(args.out, "w") as nc:
        nc.icebin_tpu_schema = 1
        nc.nhc = gr.nhc
        total_raw = total_z = 0
        for kv in args.elevmask:
            sheet, path = kv.split("=", 1)
            elevmask = np.load(path)
            rm = gr.regrid_matrices(sheet, elevmask)
            for name in names:
                M = rm.matrix(name, params)
                key = f"{sheet}.{name}"
                setattr(nc, f"{key}_nrow", M.shape[0])
                setattr(nc, f"{key}_ncol", M.shape[1])
                if args.uncompressed:
                    nc.createDimension(f"{key}.nnz", M.nnz)
                    for part, arr, typ in (("rows", M.rows, "i"),
                                           ("cols", M.cols, "i"),
                                           ("vals", M.vals, "d")):
                        v = nc.createVariable(f"{key}.{part}", typ,
                                              (f"{key}.nnz",))
                        v[:] = arr
                else:
                    blob = np.frombuffer(
                        encode_zarray(M.rows, M.cols, M.vals), dtype=np.int8)
                    nc.createDimension(f"{key}.nbytes", len(blob))
                    v = nc.createVariable(f"{key}.zarray", "b",
                                          (f"{key}.nbytes",))
                    v[:] = blob
                    total_raw += M.nnz * 24
                    total_z += len(blob)
    ratio = f", compressed {total_z}/{total_raw} bytes" if total_z else ""
    print(f"global_ec: wrote {args.out} ({len(args.elevmask)} sheets, "
          f"{len(names)} matrices each{ratio})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
