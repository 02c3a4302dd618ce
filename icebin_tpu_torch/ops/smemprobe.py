"""On-chip capacity probe (the port of the Pallas TPU instrument
``tools/probe_vmem.py:32``, body ``k`` :27): ``o = x * 2.0`` for an (n,
128) f32 array held whole in shared memory, and the bisect of the largest
n that fits.

* ``smem_copy`` wraps the two hand-written CUDA kernels
  (``csrc/smemprobe.cu``): ``scope="block"`` holds x and o in one block's
  dynamic shared memory; ``scope="cluster"`` spreads them over a
  thread-block cluster of ``cluster`` = 2, 4, 8 or 16 blocks, each reading
  its neighbour's slice through distributed shared memory.  Given a CUDA
  tensor it launches the kernel (counting each launch in
  ``smem_copy.launches``) or raises; ``Refused`` when the card refuses the
  launch configuration.  Given a CPU tensor it runs the plain version.
* ``smem_copy_ref`` is that plain version, ``x * 2.0`` (exact in f32, so
  kernel and plain version agree bit for bit).
* ``largest_rows`` bisects n as ``probe_vmem.py``'s ``try_mb`` loop bisects
  megabytes.  A size fits only when the launch is accepted and its result
  is bit for bit ``x * 2.0``; only a launch-configuration refusal
  (``REFUSALS``, or a cluster occupancy of 0) means it does not fit, and
  any other status, or a fault at the synchronisation after the launch,
  raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from icebin_tpu_torch.ops import _build
from icebin_tpu_torch.ops.apply import on_cpu

__all__ = ["COLS", "CLUSTERS", "OK", "NO_CLUSTER", "REFUSALS", "Refused",
           "smem_copy", "smem_copy_ref", "rows_data", "attempt",
           "largest_rows"]

COLS = 128                   # f32 per row: one row pair (in + out) is 1 KB
CLUSTERS = (2, 4, 8, 16)     # 16 is a non-portable cluster size
OK = "cudaSuccess"
#: the status of a cluster launch that cudaOccupancyMaxActiveClusters
#: answered with 0 (the kernel was not launched)
NO_CLUSTER = "cudaOccupancyMaxActiveClusters: 0"
#: the statuses that mean "this size does not fit"
REFUSALS = ("cudaErrorInvalidValue", "cudaErrorInvalidConfiguration",
            "cudaErrorInvalidClusterSize", NO_CLUSTER)


class Refused(RuntimeError):
    """The card refused the launch configuration: the size does not fit.
    ``status`` is the status's name (one of ``REFUSALS``), ``occupancy``
    the clusters the occupancy API reported (None for one block, or when
    the refusal came before the query)."""

    def __init__(self, what, status, occupancy):
        super().__init__(f"{what}: refused ({status}, occupancy "
                         f"{occupancy})")
        self.status, self.occupancy = status, occupancy


def smem_copy_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x * 2.0``."""
    return x * 2.0


def _launch(x, out, scope, cluster):
    """Launch the kernel of ``scope`` from x into out: (status name,
    cluster occupancy, or None for one block or a refusal before the
    occupancy query); counts the launch if one was made."""
    lib = _build.library()
    occ = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if scope == "block":
            status = lib.smem_copy_block(x.data_ptr(), out.data_ptr(),
                                         x.shape[0], stream)
        else:
            status = lib.smem_copy_cluster(x.data_ptr(), out.data_ptr(),
                                           x.shape[0], cluster,
                                           ctypes.byref(occ), stream)
    occupancy = None if scope == "block" or occ.value < 0 else occ.value
    if status == 0 and occupancy == 0:
        return NO_CLUSTER, 0
    if status == 0:
        smem_copy.launches += 1
    return lib.icebin_cuda_error_name(status).decode(), occupancy


def _check(x, scope, cluster):
    if scope not in ("block", "cluster"):
        raise ValueError(f"smem_copy: scope 'block' or 'cluster', got "
                         f"{scope!r}")
    if (scope == "block") != (cluster == 1) or (
            scope == "cluster" and cluster not in CLUSTERS):
        raise ValueError(f"smem_copy: cluster 1 for a block, one of "
                         f"{CLUSTERS} for a cluster, got {scope} {cluster}")
    if (x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != COLS
            or x.shape[0] < 1 or not x.is_contiguous()):
        raise ValueError(f"smem_copy needs a contiguous f32 (n >= 1, {COLS}) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")


def smem_copy(x: torch.Tensor, scope: str = "block",
              cluster: int = 1) -> torch.Tensor:
    """``x * 2.0`` with the (n, 128) f32 ``x`` and the result held whole in
    one block's shared memory (``scope="block"``, ``cluster=1``) or a
    cluster's (``scope="cluster"``, ``cluster`` in ``CLUSTERS``).  Raises
    ``Refused`` if the card refuses the size, RuntimeError on any other
    status."""
    _check(x, scope, cluster)
    if on_cpu(x, "smem_copy"):
        return smem_copy_ref(x)
    if x.data_ptr() % 16:
        raise ValueError("smem_copy: x must be 16-byte aligned")
    out = torch.empty_like(x)
    status, occupancy = _launch(x, out, scope, cluster)
    what = f"smem_copy {scope} {cluster} at {x.shape[0]} rows"
    if status in REFUSALS:
        raise Refused(what, status, occupancy)
    if status != OK:
        raise RuntimeError(f"{what}: {status}")
    return out


def rows_data(n: int, device) -> torch.Tensor:
    """The (n, 128) f32 input of the bisect's attempt at n rows: uniform in
    [-1, 1) from seed n."""
    x = np.random.default_rng(n).uniform(-1.0, 1.0, (n, COLS))
    return torch.as_tensor(x.astype(np.float32), device=device)


def attempt(scope: str, cluster: int, device):
    """The bisect's attempt at n rows on ``device``'s card: a function of n
    giving (status name, occupancy).  An accepted launch is synchronised
    and its result held bit for bit to ``x * 2.0``; a difference or a
    fault raises."""
    def run(n):
        x = rows_data(n, device)
        _check(x, scope, cluster)
        out = torch.empty_like(x)
        status, occupancy = _launch(x, out, scope, cluster)
        if status == OK:
            torch.cuda.synchronize(device)
            want = smem_copy_ref(x)
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise RuntimeError(f"smem_copy {scope} {cluster} at {n} "
                                   f"rows differs from x * 2.0")
        return status, occupancy
    return run


def largest_rows(scope: str = "block", cluster: int = 1, device=None,
                 attempt_fn=None) -> dict:
    """The largest n whose (n, 128) f32 in and out buffers fit ``scope``
    (with ``cluster`` blocks), bisected as ``probe_vmem.py`` bisects
    megabytes: from 8 rows down until one fits, up from 256 by doubling
    until one does not, then halving the interval, here to one row.
    ``attempt_fn(n)`` gives (status name, occupancy); by default
    ``attempt(scope, cluster, device)``.  Returns {"rows", "occupancy" (at
    those rows), "refused_rows" (the smallest size seen refused),
    "refusal" (its status), "refusal_occupancy", "attempts"}."""
    run = attempt_fn or attempt(scope, cluster, device)
    seen = {}

    def fits(n):
        status, occupancy = seen[n] = run(n)
        if status == OK:
            return True
        if status in REFUSALS:
            return False
        raise RuntimeError(f"smem_copy {scope} {cluster} at {n} rows: "
                           f"{status} is not a launch-configuration refusal")

    lo, hi = 8, 256
    while not fits(lo):
        lo //= 2
        if lo < 1:
            raise RuntimeError(f"smem_copy {scope} {cluster}: even 1 row is "
                               f"refused")
    while fits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return {"rows": lo, "occupancy": seen[lo][1], "refused_rows": hi,
            "refusal": seen[hi][0], "refusal_occupancy": seen[hi][1],
            "attempts": len(seen)}


smem_copy.launches = 0
