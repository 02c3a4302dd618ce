#!/usr/bin/env python
"""End-to-end demo on the PyTorch + CUDA port: a coupled Greenland run
(BASELINE config #4 shape), the twin of ``examples/coupled_greenland.py``.

Builds the SeaRISE Greenland grid at ``--res-km`` vs ModelE 2x2.5 with 5
elevation classes (the exchange grid clipped on the card), couples a
synthetic-SMB atmosphere to the SIA ice model for N steps with per-step
conservation accounting, dumps fields, and (optionally) renders plots.
The same system, forcing and printed lines as the JAX example.

    python examples/coupled_greenland_torch.py [--steps 12] [--out DIR]
           [--res-km 20] [--plot] [--device cuda|cpu]

``--device`` defaults to cuda and then needs a GPU (exit 2 without one);
cpu runs the kernels' plain versions.
"""
import argparse
import os
import pathlib
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

HCDEFS = [0.0, 500.0, 1000.0, 2000.0, 3500.0]


def main(argv=None):
    """Run the demo; returns the ledger rows."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(),
                                         "icebin_demo"))
    ap.add_argument("--res-km", type=float, default=20.0)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run the plain "
                 "versions on the CPU")
    from icebin_tpu_torch import GCMRegridder
    from icebin_tpu_torch.coupler.coupler import (CouplerConfig, GCMCoupler,
                                                  IceSheetCoupler)
    from icebin_tpu_torch.coupler.writer import CouplerWriter
    from icebin_tpu_torch.grid import modele_lonlat_grid
    from icebin_tpu_torch.models.ice_sheet import IceSheetConfig

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "grids"))
    from searise_torch import searise_grid

    print(f"building grids + exchange ({args.res_km:g} km Greenland)...")
    specA = modele_lonlat_grid(144, 90)
    specI = searise_grid(args.res_km)
    gr = GCMRegridder(specA, hcdefs=HCDEFS, device=device)
    gr.add_sheet("greenland", specI, subdiv=2)

    out = pathlib.Path(args.out)
    cfg = CouplerConfig(dt=86400.0 * 30, regen_every=6)
    ice_cfg = IceSheetConfig(nx=specI.nx, ny=specI.ny,
                             dx=float(np.diff(specI.xb)[0]),
                             dy=float(np.diff(specI.yb)[0]),
                             n_substeps_max=8)
    cp = GCMCoupler(gr, cfg, device=device,
                    sheets={"greenland": IceSheetCoupler(
                        gr, "greenland", cfg, device=device,
                        ice_cfg=ice_cfg)},
                    writer=CouplerWriter(str(out / "dumps"), every=3))

    cA = specA.cell_centers()

    def forcing(t, sheet):
        # seasonal SMB: accumulation at high lat, seasonal melt pulse
        season = np.cos(2 * np.pi * t / (86400.0 * 365.2425))
        smbA = 1e-5 * np.clip((np.abs(cA[:, 1]) - 55.0) / 35.0, 0, 1) \
            - 4e-6 * max(season, 0.0)
        f = np.zeros((8, gr.nE))
        f[0] = np.repeat(smbA, gr.nhc)          # a-major E broadcast
        f[4] = -15.0 + 10.0 * season
        return torch.as_tensor(f.astype(np.float32), device=device)

    print(f"running {args.steps} coupling steps...", flush=True)
    for k in range(args.steps):
        cp.couple({"greenland": forcing(cp.time, "greenland")})
        r = cp.ledger.to_rows()[-1]
        print(f"  step {k}: ice mass {r['greenland.ice_mass']:.4e} kg",
              flush=True)

    rows = cp.ledger.to_rows()
    worst = max(abs(r["greenland.mass_in_E"]
                    - r["greenland.mass_delivered_I"])
                / max(abs(r["greenland.mass_in_E"]), 1e-300) for r in rows)
    final_mass = rows[-1]["greenland.ice_mass"]
    print(f"done: {len(rows)} steps, ice mass {final_mass:.4e} kg, "
          f"worst per-step transport conservation error {worst:.2e}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from icebin_tpu_torch.utils.plot import plot_field
        out.mkdir(parents=True, exist_ok=True)
        sc = cp.sheets["greenland"]
        fig, axes = plt.subplots(1, 2, figsize=(11, 5))
        plot_field(specI, sc.state.H.reshape(-1), ax=axes[0],
                   title="ice thickness [m]")
        fhc = sc.rm.fhc()
        plot_field(specA, fhc.sum(axis=0), ax=axes[1],
                   title="iced fraction of A cells")
        fig.savefig(str(out / "demo.png"), dpi=110)
        plt.close(fig)
        print(f"wrote {out}/demo.png and dumps in {out}/dumps/")
    return rows


if __name__ == "__main__":
    main()
