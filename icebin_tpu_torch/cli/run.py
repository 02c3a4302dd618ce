"""`run`: standalone coupled-run driver from a RunConfig JSON (the port of
``icebin_tpu/cli/run.py``).

Build or load the regridder, run N coupling steps of the SIA (or DISMAL)
ice model under synthetic or zero forcing, dump per-step fields,
checkpoint, and report the conservation ledger: the reference's flags,
output lines, checkpoint files and forcing (``default_rng(0)``).

    python -m icebin_tpu_torch.cli.run run.json [--forcing synthetic|zero]
        [--ice sia|dismal] [--resume ck.npz] [--fused]
        [--mesh N [--backend nccl|gloo]] [--device cuda|cpu]
        [--spans PATH]

Everything runs on ``--device`` (default cuda, and then a GPU is required;
cpu runs the kernels' plain versions), exchange grids that the config does
not cache included.  ``--mesh N`` decomposes every ice sheet over N ranks
(``GCMCoupler(..., mesh=...)``; the SIA model's step is halo-exchanged,
DISMAL's holds each rank's block): the command starts N
rank processes (``parallel.distributed.launch``) and prints rank 0's
report, or, started by torchrun, runs as one of its ranks.  The backend
defaults to nccl on cuda (a card a rank) and gloo on the CPU; gloo on cuda
lets ranks share a card.

``--spans PATH`` records the run's host spans (``utils.trace``: each
fused window and its forcing, launches and fetches, each regeneration's
factory, pack, upload and E1vE0, TOPO, graph captures), set-up included,
and writes them at exit to PATH as Chrome trace-event JSON (complete
events, µs, the ice sheet under ``args.sheet``), which Perfetto and
``chrome://tracing`` open; with ``--mesh``, rank 0's.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys

import numpy as np


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="icebin-run", description=__doc__)
    ap.add_argument("config")
    ap.add_argument("--forcing", default="synthetic",
                    choices=["synthetic", "zero"])
    ap.add_argument("--ice", default="sia", choices=["sia", "dismal"])
    ap.add_argument("--resume", help="checkpoint to resume from")
    ap.add_argument("--smb", type=float, default=1e-5,
                    help="synthetic SMB magnitude [kg m-2 s-1]")
    ap.add_argument("--fused", action="store_true",
                    help="run each regeneration window between host syncs "
                         "(checkpoint cadence then follows regen windows; "
                         "DISMAL runs stepwise, as in the reference)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="decompose each ice sheet over N ranks (sharded "
                         "applies + halo-exchanged ice step)")
    ap.add_argument("--backend", choices=["nccl", "gloo"],
                    help="process-group backend of --mesh (default nccl on "
                         "cuda, gloo on cpu)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spans", metavar="PATH",
                    help="write the run's host spans to PATH as Chrome "
                         "trace-event JSON")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run the plain "
                 "versions on the CPU")
    if not args.mesh:
        return _run(args, None)
    import torch.distributed as dist

    from icebin_tpu_torch.parallel.distributed import init_multihost, launch
    from icebin_tpu_torch.parallel.mesh import make_mesh, rank_device
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    try:
        rank_device(backend, device, args.mesh, 0)
    except ValueError as e:
        ap.error(f"--mesh {args.mesh}: {e}")
    if "RANK" in os.environ or dist.is_initialized():   # torchrun's rank
        if not dist.is_initialized():
            init_multihost(backend=backend)
        mesh = make_mesh(args.mesh, backend=backend, device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = _run(args, mesh)
        if mesh.rank == 0:            # every rank books the same report
            sys.stdout.write(out.getvalue())
        return rc
    if device.type == "cuda":
        from icebin_tpu_torch.ops import _build
        _build.library()          # once here, not in every rank
    outs = launch(_rank, args.mesh, backend=backend, device=device,
                  args=(argv if argv is not None else sys.argv[1:],),
                  timeout=None)
    sys.stdout.write(outs[0])
    return 0


def _rank(mesh, argv) -> str:
    """One rank of ``run --mesh``: the run on ``mesh``; returns what it
    printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _run(_parser().parse_args(argv), mesh)
    if rc:
        raise SystemExit(rc)
    return buf.getvalue()


def _run(args, mesh) -> int:
    """The run itself, on one device or on this rank of ``mesh``; with
    ``--spans``, recorded (rank 0's, on a mesh)."""
    if not args.spans or (mesh is not None and mesh.rank != 0):
        return _run_coupled(args, mesh)
    import json

    from icebin_tpu_torch.utils import trace
    with trace.recording():
        try:
            return _run_coupled(args, mesh)
        finally:
            with open(args.spans, "w") as f:
                json.dump(trace.chrome_trace(trace.drain()), f)


def _run_coupled(args, mesh) -> int:
    """The coupled run of ``_run``."""
    import torch

    from icebin_tpu_torch.coupler.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    from icebin_tpu_torch.coupler.coupler import CouplerConfig, GCMCoupler
    from icebin_tpu_torch.coupler.writer import CouplerWriter
    from icebin_tpu_torch.io.ncio import read_exchange, read_grid
    from icebin_tpu_torch.regrid.gcmregridder import GCMRegridder
    from icebin_tpu_torch.utils.config import RunConfig

    device = mesh.device if mesh is not None else torch.device(args.device)
    cfg = RunConfig.from_json(args.config)
    gr = GCMRegridder(read_grid(cfg.gridA_file), hcdefs=cfg.hcdefs,
                      device=device)
    for s in cfg.sheets:
        xg = read_exchange(s.exchange_file) if s.exchange_file else None
        gr.add_sheet(s.name, read_grid(s.grid_file), exchange=xg,
                     subdiv=s.subdiv)
    writer = (CouplerWriter(cfg.dump_dir) if cfg.dump_dir else None)
    cp = GCMCoupler(gr, CouplerConfig(
        dt=cfg.dt_seconds, regen_every=cfg.regen_every,
        min_thickness=cfg.min_thickness, params=cfg.regrid_params()),
        device=device, writer=writer, mesh=mesh)
    if args.ice == "dismal":
        from icebin_tpu_torch.models.dismal import DismalModel
        for sc in cp.sheets.values():
            sc.ice_step = DismalModel().step_for(sc)
    if args.resume:
        load_checkpoint(args.resume, cp)
        print(f"resumed at t={cp.time:.6g}s "
              f"({len(cp.ledger.to_rows())} steps done)")

    rng = np.random.default_rng(0)

    def forcing(t, sheet):
        f = np.zeros((8, gr.nE))
        if args.forcing == "synthetic":
            f[0] = args.smb * rng.uniform(0.5, 1.0, gr.nE)
            f[4] = -10.0
        return torch.as_tensor(f.astype(np.float32), device=device)

    if args.fused:
        done = 0
        while done < cfg.n_steps:
            k = min(cfg.checkpoint_every or cfg.n_steps, cfg.n_steps - done)
            cp.run_transient(forcing, k, fused=True)
            done += k
            if cfg.checkpoint_every:
                save_checkpoint(
                    f"checkpoint_{len(cp.ledger.to_rows()):06d}.npz", cp)
    else:
        for k in range(cfg.n_steps):
            cp.couple({name: forcing(cp.time, name) for name in cp.sheets})
            if cfg.checkpoint_every and (k + 1) % cfg.checkpoint_every == 0:
                save_checkpoint(
                    f"checkpoint_{len(cp.ledger.to_rows()):06d}.npz", cp)
    rows = cp.ledger.to_rows()
    for name in cp.sheets:
        worst = max(abs(r[f"{name}.mass_in_E"] - r[f"{name}.mass_delivered_I"])
                    / max(abs(r[f"{name}.mass_in_E"]), 1e-300) for r in rows)
        print(f"{name}: {cfg.n_steps} steps, ice mass "
              f"{rows[-1][f'{name}.ice_mass']:.6e} kg, worst per-step "
              f"transport conservation {worst:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
