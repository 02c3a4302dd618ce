"""Multi-rank dry run of the decomposed coupled step (port of
``__graft_entry__.py:76`` ``dryrun_multichip``).

``run_dryrun(mesh)`` runs, on this rank of an n-rank mesh and on small
shapes: the demonstration coupled step (the 2-D (icey, icex) decomposition
for even n >= 4 -- halos on both axes, one pack applied both ways, sums
over the whole mesh -- otherwise the 1-D one), the sharded applies (K2's
partials added across ranks, K1 on the rank's rows), and the production
mesh coupler: one step with a regeneration, then a window of 3 steps.  It
checks finiteness and the per-step transport identity (< 1e-10) and
returns a summary.  ``dryrun_multichip(n, backend=..., device=...)``
starts n ranks and runs it in each:

    python -m icebin_tpu_torch.parallel.dryrun N [--backend gloo|nccl]
        [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

__all__ = ["run_dryrun", "dryrun_multichip"]

DT = 86400.0 * 30


def _setup(nx, ny, na=6, nhc=3, n_substeps=4, *, device):
    """``__graft_entry__._build_setup``: a lon-lat A grid over a
    PlateCarree ice lattice, its dome state and EvI/IvE."""
    from icebin_tpu_torch.grid import GridSpecLonLat, GridSpecXY, PlateCarree
    from icebin_tpu_torch.models.ice_sheet import IceSheetConfig, init_state
    from icebin_tpu_torch.regrid.gcmregridder import GCMRegridder
    from icebin_tpu_torch.regrid.matrices import RegridParams
    scale = 10e3
    specA = GridSpecLonLat(lonb=np.linspace(0.0, 40.0, na + 1),
                           latb=np.linspace(30.0, 70.0, na + 1))
    specI = GridSpecXY(xb=np.linspace(0.0, 40.0 * scale, nx + 1),
                       yb=np.linspace(30.0 * scale, 70.0 * scale, ny + 1),
                       projection=PlateCarree(scale=scale))
    gr = GCMRegridder(specA, hcdefs=np.linspace(0.0, 3000.0, nhc),
                      device=device)
    gr.add_sheet("s", specI, subdiv=1)
    ice_cfg = IceSheetConfig(nx=nx, ny=ny, dx=float(np.diff(specI.xb)[0]),
                             dy=float(np.diff(specI.yb)[0]),
                             n_substeps_max=n_substeps)
    state = init_state(ice_cfg, device=device, dome_height=2000.0)
    rm = gr.regrid_matrices("s", state.elevmask().cpu().numpy())
    P = RegridParams(scale=True, correctA=True)
    return gr, ice_cfg, state, rm.matrix("IvE", P), rm.matrix("EvI", P)


def run_dryrun(mesh) -> dict:
    """The dry run on this rank of ``mesh`` (a 1-D mesh of n ranks)."""
    from icebin_tpu_torch.coupler.coupler import (CouplerConfig, GCMCoupler,
                                                  IceSheetCoupler)
    from icebin_tpu_torch.grid import GridSpecLonLat, GridSpecXY, PlateCarree
    from icebin_tpu_torch.parallel import coupled
    from icebin_tpu_torch.parallel.sharded_apply import (
        make_sharded_apply_ice, make_sharded_apply_small,
        sharded_csr_from_weighted)
    from icebin_tpu_torch.regrid.gcmregridder import GCMRegridder
    from icebin_tpu_torch.regrid.matrices import RegridParams
    n, dev = mesh.size, mesh.device
    rng = np.random.default_rng(0)
    fac = torch.ones(2, device=dev)
    off = torch.zeros(2, device=dev)

    def forcing_2(nE):
        return torch.as_tensor(np.stack([
            1e-5 * rng.uniform(0.5, 1.0, nE), np.full(nE, 263.0)]),
            dtype=torch.float32, device=dev)

    if n >= 4 and n % 2 == 0:
        m2 = coupled.make_mesh_2d((n // 2, 2), backend=mesh.backend,
                                  device=dev)
        gr, ice_cfg, state, ive, evi = _setup(256, 4 * (n // 2),
                                              device=dev)
        ops = coupled.shard_coupled_setup_2d(m2, evi, state, ice_cfg)
        fn = coupled.make_sharded_step_2d(m2, ice_cfg, gr.nE, DT)
        path = "2-D"
    else:
        gr, ice_cfg, state, ive, evi = _setup(128, 4 * n, device=dev)
        ops = coupled.shard_coupled_setup(mesh, ive, evi, state, ice_cfg)
        fn = coupled.make_sharded_step(mesh, ice_cfg, gr.nE, DT)
        path = "1-D"
    H1, fI, fE_out = fn(ops, forcing_2(gr.nE), fac, off)
    assert bool(torch.isfinite(H1).all()) and bool(torch.isfinite(fI).all())
    assert bool(torch.isfinite(fE_out).any())

    # the sharded applies: K2's partials summed across ranks, K1 local
    gr2, _, state2, _, _ = _setup(128, 8 * n, device=dev)
    rm2 = gr2.regrid_matrices("s", state2.elevmask().cpu().numpy())
    Me = rm2.matrix("EvI", RegridParams(scale=True, correctA=True))
    sc = sharded_csr_from_weighted(mesh, Me, small_axis="rows", nv=8)
    c0, c1 = sc.c0, sc.c0 + sc.cells_per_shard
    f = np.random.default_rng(1).uniform(0.5, 1.5, (8, Me.shape[1]))
    f_loc = torch.as_tensor(f[:, c0:c1], dtype=torch.float32, device=dev)
    e = make_sharded_apply_small(mesh, sc)(f_loc)
    out = make_sharded_apply_ice(mesh, sc)(e)
    assert bool(torch.isfinite(out).all())

    # the production mesh coupler: a step with a regeneration, then a
    # window of 3
    scale = 25e3
    nx, ny = 32, 4 * n
    specA = GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                           latb=np.linspace(30.0, 80.0, 7))
    specI = GridSpecXY(xb=np.linspace(0.0, 16.0 * scale, nx + 1),
                       yb=np.linspace(40.0 * scale, 72.0 * scale, ny + 1),
                       projection=PlateCarree(scale=scale))
    gr3 = GCMRegridder(specA, hcdefs=[0.0, 500.0, 1000.0, 2000.0, 3000.0],
                       device=dev)
    gr3.add_sheet("s", specI, subdiv=1)
    cp = GCMCoupler(gr3, CouplerConfig(dt=DT, regen_every=1), mesh=mesh)
    fE = np.zeros((8, gr3.nE), np.float32)
    fE[0] = 1e-5 * np.random.default_rng(2).uniform(0.5, 1.0, gr3.nE)
    fE[4] = -10.0
    fE = torch.as_tensor(fE, device=dev)
    res = cp.couple({"s": fE})["s"]
    row = cp.ledger.to_rows()[-1]
    rel = abs(row["s.mass_in_E"] - row["s.mass_delivered_I"]) / abs(
        row["s.mass_in_E"])
    assert rel < 1e-10, f"mesh coupler conservation {rel}"
    assert bool(torch.isfinite(res["fA_out"]).any())
    stats, outs = cp.sheets["s"].couple_window(torch.stack([fE] * 3))
    assert stats.shape == (3, len(IceSheetCoupler.STAT_KEYS))
    rel2 = abs(stats[:, 0] - stats[:, 1]).max() / abs(stats[:, 0]).max()
    assert rel2 < 1e-10, f"mesh window conservation {rel2}"
    assert bool(torch.isfinite(outs["fA_out"]).any())
    return {"rank": mesh.rank, "ranks": n, "backend": mesh.backend,
            "step": path, "transport": max(rel, float(rel2))}


def dryrun_multichip(n: int, *, backend: str, device,
                     timeout: float = 600.0) -> list:
    """``run_dryrun`` on n new ranks; their summaries in rank order."""
    from icebin_tpu_torch.parallel.distributed import launch
    return launch(run_dryrun, n, backend=backend, device=device,
                  timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="icebin-dryrun", description=__doc__)
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=["nccl", "gloo"])
    args = ap.parse_args(argv)
    backend = args.backend or ("nccl" if args.device.startswith("cuda")
                               else "gloo")
    if args.device.startswith("cuda"):
        from icebin_tpu_torch.ops import _build
        _build.library()
    for r in dryrun_multichip(args.n, backend=backend, device=args.device):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
