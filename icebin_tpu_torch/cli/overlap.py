"""`overlap`: offline exchange-grid construction through the port's clip
kernels (the port of ``icebin_tpu/cli/overlap.py``).

    python -m icebin_tpu_torch.cli.overlap gridA.nc gridI.nc exgrid.nc \
        [--subdiv 2] [--no-repair] [--device cuda|cpu]

Grids are read and the exchange grid written in the reference's NetCDF
schema.  An XY ice grid clips through the rectangle kernel; a generic grid
as gridI would clip through the convex-clip kernel, but the schema does not
store a generic grid's projection (``icebin_tpu/io/ncio.py``), so such a
file cannot be the clip side, here as in the reference's CLI: build it
through ``icebin_tpu_torch.grid.make_exchange_grid`` instead.  The clip
runs on ``--device`` (default cuda, and then a GPU is required; cpu runs
the kernels' plain versions).
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="overlap", description=__doc__)
    ap.add_argument("gridA")
    ap.add_argument("gridI")
    ap.add_argument("out")
    ap.add_argument("--subdiv", type=int, default=2)
    ap.add_argument("--no-repair", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from icebin_tpu_torch.grid import make_exchange_grid
    from icebin_tpu_torch.io import read_grid, write_exchange

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run the plain "
                 "versions on the CPU")
    gA = read_grid(args.gridA)
    gI = read_grid(args.gridI)
    t0 = time.time()
    xg = make_exchange_grid(gA, gI, subdiv=args.subdiv, device=device,
                            repair=not args.no_repair)
    dt = time.time() - t0
    write_exchange(args.out, xg)
    print(f"overlap: {xg.ncells} exchange cells in {dt:.1f}s "
          f"({gI.spec.ncells / max(dt, 1e-9):.0f} ice cells/s, "
          f"device={device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
