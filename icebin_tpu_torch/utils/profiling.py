"""Roofline accounting: byte/FLOP bookkeeping for the hot kernels (the port
of ``icebin_tpu/utils/profiling.py``).

Reference: none -- the reference has ad-hoc timing prints only (SURVEY.md
section 5.1), and the survey mandates building bandwidth accounting in from
day one ('bytes moved per SpMV vs HBM roof is literally the north-star
metric').  This module computes the LOGICAL traffic of each apply/clip from
matrix metadata, accumulates measured wall times, and reports achieved
vs roofline fractions.

``Roofline`` and ``clip_pair_flops`` are the reference's.  The roof is the
H100 SXM data sheet's HBM rate (``tools.common.PEAK_BYTES_S``) unless the
caller gives one: the reference's table of TPU rates keyed by the JAX
device kind has no counterpart.  The apply's bytes are those of the port's
destination-sorted CSR (``csr_apply_bytes``; the reference's
``bdt_apply_bytes`` counted the TPU pack), the one count that the kernels'
bounds (``tools.common.spmm_bound``) use too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import torch

__all__ = ["csr_apply_bytes", "clip_pair_flops", "Roofline"]


def csr_apply_bytes(csr, nv: int, vals: bool = True, winv: bool = True,
                    reads_out: bool = False) -> int:
    """Logical bytes of one apply of ``csr`` (``ops.csr.Csr``) to nv f32
    fields: rowptr, cols, vals and winv, the source rows the matrix reads
    and the whole output, each once.  A function that does not read
    ``vals`` or ``winv`` leaves them out; one that reads its output first
    (``reads_out``) moves it twice."""
    nnz = csr.vals.numel()
    used = torch.unique(csr.cols).numel()
    return (4 * (csr.n_dst + 1 + (2 if vals else 1) * nnz
                 + (csr.n_dst if winv else 0))
            + 4 * nv * (used + (2 if reads_out else 1) * csr.n_dst))


def clip_pair_flops(v0: int = 8) -> int:
    """Rough VPU op count of one pair through the 4-pass clipper."""
    ops = 0
    v = v0
    for _ in range(4):
        ops += 14 * v          # pass arithmetic
        ops += 10 * 2 * v * 5  # ffill log-steps on the doubled ring
        v *= 2
    ops += 10 * v              # shoelace + centroid
    return ops


@dataclasses.dataclass
class _Entry:
    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0
    flops: int = 0


class Roofline:
    """Accumulates measured times against logical traffic.

    with roof.measure('EvI_apply', bytes=csr_apply_bytes(csr, 16)):
        out = apply_small(csr, f); torch.cuda.synchronize()
    print(roof.report())
    """

    def __init__(self, hbm_gbps: Optional[float] = None):
        self.entries: Dict[str, _Entry] = {}
        self.roof = "HBM"
        if hbm_gbps is None:
            from icebin_tpu_torch.tools.common import PEAK_BYTES_S
            hbm_gbps = PEAK_BYTES_S / 1e9
            self.roof = "H100 SXM data sheet HBM"
        self.hbm_gbps = hbm_gbps

    @contextlib.contextmanager
    def measure(self, name: str, bytes: int = 0, flops: int = 0):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        e = self.entries.setdefault(name, _Entry())
        e.calls += 1
        e.seconds += dt
        e.bytes += bytes
        e.flops += flops

    def report(self) -> str:
        lines = [f"roofline ({self.roof} {self.hbm_gbps:.0f} GB/s "
                 "nominal):"]
        for name, e in sorted(self.entries.items()):
            gbps = e.bytes / e.seconds / 1e9 if e.seconds > 0 else 0.0
            frac = gbps / self.hbm_gbps
            lines.append(
                f"  {name:24s} {e.calls:5d} calls {e.seconds*1e3:9.2f} ms "
                f"{e.bytes/1e6:9.1f} MB -> {gbps:7.1f} GB/s "
                f"({100*frac:5.1f}% of roof)")
        return "\n".join(lines)
