"""What the port's instruments and ``chip_smoke.py`` share: the config #3
and #5 lattices of bench.py, the card's name, device timing with CUDA
events, each kernel's least time on the card (its bound), bitwise
comparison of results, and the one PyTorch call (cuSPARSE) that computes a
regrid kernel's function."""
from __future__ import annotations

import subprocess
import warnings

import numpy as np
import torch

__all__ = ["HCDEFS", "HEX_R", "PEAK_BYTES_S", "PEAK_F32_FLOP_S",
           "bound", "spmm_bound", "clip_bound", "time_once", "time_ms",
           "card_name", "same", "max_diff", "library_spmm",
           "greenland_specs", "antarctica_spec", "hex_mesh"]

HCDEFS = [0.0, 500.0, 1000.0, 2000.0, 3500.0]   # bench.py's 5 classes
SEARISE = "+proj=stere +lat_0=90 +lat_ts=71 +lon_0=-39 +ellps=WGS84"
ANTARCTICA = "+proj=stere +lat_0=-90 +lat_ts=-71 +lon_0=0 +ellps=WGS84"
HEX_R = 3102.0            # hexagon circumradius, m: 25.0 km2 a cell
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


def spmm_bound(csr, nv, vals=True, winv=True, reads_out=False):
    """Least time of one apply of ``csr`` to nv fields: rowptr, cols, vals,
    winv, the source rows the matrix reads and the whole output, each once;
    two operations per nonzero and field.  A function that does not read
    ``vals`` (one operation per nonzero and field then) or ``winv`` leaves
    them out; one that reads its output first (``reads_out``) moves it
    twice."""
    nnz = csr.vals.numel()
    used = torch.unique(csr.cols).numel()
    return bound(4 * (csr.n_dst + 1 + (2 if vals else 1) * nnz
                      + (csr.n_dst if winv else 0))
                 + 4 * nv * (used + (2 if reads_out else 1) * csr.n_dst),
                 (2 if vals else 1) * nnz * nv)


def clip_bound(polys, other):
    """Least time of a clip kernel: its inputs read once, areas and
    centroids written once; operations counted low (one distance per input
    vertex and clip edge, and the shoelace's 6 per vertex), since the
    bytes bound either way."""
    B, v0 = polys.shape[0], polys.shape[1]
    edges = 4 if other.dim() == 2 else other.shape[1]
    return bound(4 * (polys[0].numel() + other[0].numel() + 3) * B,
                 (edges + 6) * v0 * B)


def same(a, b):
    """Bit for bit (f32 or f64, one type), signed zeros told apart; a NaN
    equals any NaN (a function that propagates NaN sources need not keep
    their payloads)."""
    if a.dtype != b.dtype:
        return False
    ints = torch.int64 if a.element_size() == 8 else torch.int32
    bits = a.contiguous().view(ints) == b.contiguous().view(ints)
    return bool((bits | (torch.isnan(a) & torch.isnan(b))).all())


def max_diff(a, b):
    """max |a - b|, 0 where both are equal or both NaN."""
    d = (a - b).abs()
    d[(a == b) | (torch.isnan(a) & torch.isnan(b))] = 0.0
    return float(d.max()) if d.numel() else 0.0


def library_spmm(csr, x, vals=True, winv=True, clean=True):
    """A function of no argument computing, with ``torch.sparse.mm``
    (cuSPARSE on the card), what a regrid kernel computes from ``csr`` and
    the (n_src, nv) field ``x``: ``winv`` folded into the values, the
    non-finite sources cleaned first.  The lower stages of that function
    leave out the weights (``vals=False``: every value 1), the scale
    (``winv=False``) or the cleaning (``clean=False``)."""
    per_row = (csr.rowptr[1:] - csr.rowptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(csr.n_dst, device=x.device),
                                   per_row)
    w = csr.vals if vals else torch.ones_like(csr.vals)
    with warnings.catch_warnings():      # PyTorch's beta notice for CSR
        warnings.simplefilter("ignore")
        S = torch.sparse_csr_tensor(csr.rowptr.long(), csr.cols.long(),
                                    w * csr.winv[rows] if winv else w,
                                    size=(csr.n_dst, csr.n_src))
    xc = torch.where(torch.isfinite(x), x, 0.0) if clean else x
    return lambda: torch.sparse.mm(S, xc)


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


def hex_mesh(specI, r):
    """Greenland as pointy-top regular hexagons of circumradius ``r`` (m;
    3,102 m gives 25.0 km2, the area of the main path's 5 km cells) in
    ``specI``'s plane: centres sqrt(3) r apart in x and 1.5 r in y, odd
    rows offset by half, inside ``specI``'s box; vertices inverse-projected
    to lon/lat."""
    from icebin_tpu_torch.grid import GridSpecGeneric
    dx, dy = np.sqrt(3.0) * r, 1.5 * r
    x0, x1, y0, y1 = specI.xb[0], specI.xb[-1], specI.yb[0], specI.yb[-1]
    ys = np.arange(y0, y1, dy)
    xs = (np.arange(x0, x1, dx), np.arange(x0 + dx / 2, x1, dx))
    cx = np.concatenate([xs[j % 2] for j in range(len(ys))])
    cy = np.concatenate([np.full(len(xs[j % 2]), y) for j, y in enumerate(ys)])
    ang = np.radians(30.0 + 60.0 * np.arange(6))
    vx = cx[:, None] + r * np.cos(ang)[None, :]
    vy = cy[:, None] + r * np.sin(ang)[None, :]
    lon, lat = specI.projection.xy2ll(vx, vy)
    return GridSpecGeneric(polygons=np.stack([lon, lat], axis=-1),
                           projection=specI.projection,
                           name="greenland_hex_25km2")
