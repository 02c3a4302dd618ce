"""What the port's instruments and ``chip_smoke.py`` share: the config #3
and #5 lattices of bench.py, the card's name, device timing with CUDA
events, and each kernel's least time on the card (its bound)."""
from __future__ import annotations

import subprocess

import numpy as np
import torch

__all__ = ["HCDEFS", "PEAK_BYTES_S", "PEAK_F32_FLOP_S", "bound",
           "spmm_bound", "time_once", "time_ms", "card_name",
           "greenland_specs", "antarctica_spec"]

HCDEFS = [0.0, 500.0, 1000.0, 2000.0, 3500.0]   # bench.py's 5 classes
SEARISE = "+proj=stere +lat_0=90 +lat_ts=71 +lon_0=-39 +ellps=WGS84"
ANTARCTICA = "+proj=stere +lat_0=-90 +lat_ts=-71 +lon_0=0 +ellps=WGS84"
ANT_R = 2800e3            # bench.py:101-113's half-width: 1120 x 1120 at 5 km
# H100 SXM data sheet at 700 W: HBM rate and f32 rate outside the tensor
# cores, for each kernel's least time (bound)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
SLEEP_CYCLES = 200_000_000   # ~0.1 s of the card's clock: longer than the
                             # host takes to enqueue a timed run


def time_once(fn):
    """(fn(), device ms of that call): CUDA events around it.  A sleep
    kernel queued first keeps the card busy while the host enqueues the
    work, so a kernel shorter than its launch is timed on the device, not
    at the host's launch rate."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def time_ms(fn, reps):
    """Device time of one call of ``fn``: ``time_once`` over ``reps``
    calls after a warm-up."""
    def run():
        for _ in range(reps):
            fn()

    fn()
    return time_once(run)[1] / reps


def bound(nbytes, nops):
    """(least ms, what bounds it): bytes over the HBM rate or f32
    operations over the f32 rate, whichever is larger."""
    b, o = 1e3 * nbytes / PEAK_BYTES_S, 1e3 * nops / PEAK_F32_FLOP_S
    return (b, "bytes") if b >= o else (o, "operations")


def spmm_bound(csr, nv):
    """Least time of one apply of ``csr`` to nv fields: rowptr, cols, vals,
    winv, the source rows the matrix reads and the whole output, each once;
    two operations per nonzero and field."""
    nnz = csr.vals.numel()
    used = torch.unique(csr.cols).numel()
    return bound(4 * (csr.n_dst + 1 + 2 * nnz + csr.n_dst)
                 + 4 * nv * (used + csr.n_dst), 2 * nnz * nv)


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


def greenland_specs(res_km=5.0):
    """bench.py's config #3 lattice: ModelE 2x2.5 and 304 x 544 cells at
    5 km."""
    from icebin_tpu_torch.grid import GridSpecXY, modele_lonlat_grid
    nx, ny = int(round(1520 / res_km)), int(round(2720 / res_km))
    specI = GridSpecXY(xb=np.linspace(-650e3, 870e3, nx + 1),
                       yb=np.linspace(-3350e3, -630e3, ny + 1),
                       projection=SEARISE, name=f"greenland_{res_km:g}km")
    return modele_lonlat_grid(144, 90), specI


def antarctica_spec(res_km=5.0):
    """bench.py:101-113's config #5 lattice: 1120 x 1120 cells of 5 km over
    [-2800, 2800] km in the south polar stereographic plane."""
    from icebin_tpu_torch.grid import GridSpecXY
    n = int(round(2 * ANT_R / (res_km * 1e3)))
    b = np.linspace(-ANT_R, ANT_R, n + 1)
    return GridSpecXY(xb=b, yb=b, projection=ANTARCTICA,
                      name=f"antarctica_{res_km:g}km")
