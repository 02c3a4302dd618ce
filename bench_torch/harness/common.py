"""What every cell of the benchmark shares: inputs from the seed, the rate
and tail arithmetic, the card's name and power limit, the least time of a
regrid apply, and the reduction of a profiler trace to busy time, idle
gaps and kernel time by name.

The forcing is ``chip_smoke.py:forcing``'s draw (copied here, so the
yardstick does not move with the program): an (8, nE) f32 ModelE-contract
forcing, tsurf in degC.  The apply's bytes are
``icebin_tpu_torch/utils/profiling.py:csr_apply_bytes``'s and its bound
``icebin_tpu_torch/tools/common.py:bound``'s, copied.
"""
from __future__ import annotations

import subprocess
from typing import Dict, List, Tuple

import numpy as np

# H100 SXM data sheet: HBM rate and f32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


def forcing(nE: int, rng) -> np.ndarray:
    """(8, nE) f32 forcing: smb, smb enthalpy, deltah, heat flux, tsurf,
    geothermal, rain, rain enthalpy."""
    f = np.zeros((8, nE), np.float32)
    f[0] = 1e-5 * rng.uniform(0.5, 1.0, nE)      # smb kg m-2 s-1
    f[1] = 5.0                                    # smb enthalpy W m-2
    f[3] = 2.0                                    # heat flux W m-2
    f[4] = -10.0                                  # degC
    f[6] = 2e-6 * rng.uniform(0.0, 1.0, nE)      # rain kg m-2 s-1
    return f


def year_of_forcing(nE: int, seed: int, months: int) -> List[np.ndarray]:
    """``months`` forcings, month m drawn from the seed sequence (seed, m):
    the same seed gives the same year, any seed the same sizes."""
    return [forcing(nE, np.random.default_rng([seed, 1, m]))
            for m in range(months)]


def held_fields(nE: int, seed: int, n: int) -> np.ndarray:
    """(n, nE) f64 GCM-held EC state, U(0.5, 2) per E cell."""
    return np.random.default_rng([seed, 2]).uniform(0.5, 2.0, (n, nE))


def p95(values) -> float:
    """The 95th percentile (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def card() -> str:
    """'name, power limit' as nvidia-smi gives them ('' without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0].strip() if out.stdout else ""


def apply_bytes(rowptr_n: int, nnz: int, used: int, nv: int) -> int:
    """Bytes of one apply of a destination-sorted CSR with ``rowptr_n``
    destinations and ``nnz`` entries reading ``used`` distinct sources, to
    nv f32 fields: rowptr, cols, vals, winv, the sources read and the
    output, each once."""
    return 4 * (rowptr_n + 1 + 2 * nnz + rowptr_n) + 4 * nv * (used + rowptr_n)


def bound_s(nbytes: int, nops: int) -> float:
    """Least seconds: bytes over the HBM rate or f32 operations over the
    f32 rate, whichever is larger."""
    return max(nbytes / PEAK_BYTES_S, nops / PEAK_F32_FLOP_S)


def csr_bound_s(csr, nv: int) -> float:
    """Least seconds of one apply of ``csr`` (an object with ``rowptr``,
    ``cols``, ``vals``, ``n_dst``) to nv fields; two operations per
    nonzero and field."""
    import torch
    nnz = csr.vals.numel()
    used = torch.unique(csr.cols).numel()
    return bound_s(apply_bytes(csr.n_dst, nnz, used, nv), 2 * nnz * nv)


# -- the profiler's trace ---------------------------------------------------

def union_s(intervals: List[Tuple[float, float]]) -> float:
    """Length (in the intervals' unit) of the union of (start, end)."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, t0, t1):
    """The idle (start, end) gaps of [t0, t1] outside the intervals."""
    out, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1))
    return out


class Trace:
    """A profiled segment reduced: device intervals and kernel time by name
    (µs), the host's annotations, and the segment's wall length."""

    PREFIX = "bench."

    def __init__(self, events, window_s: float, steps: int):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        self.dev, self.marks = [], []
        for e in events:
            tr = e.time_range
            if e.name.startswith(self.PREFIX):
                if e.device_type != cuda:       # not their device copies
                    self.marks.append((e.name[len(self.PREFIX):], tr.start,
                                       tr.end))
            elif e.device_type == cuda:
                self.dev.append((e.name, tr.start, tr.end))
        self.window_s = window_s
        self.steps = steps

    @property
    def busy_s(self) -> float:
        return 1e-6 * union_s([(s, e) for _, s, e in self.dev])

    def kernel_s(self, *parts) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        every string of ``parts``."""
        sel = [(s, e) for n, s, e in self.dev if all(p in n for p in parts)]
        return 1e-6 * sum(e - s for s, e in sel), len(sel)

    def device_ops(self, k=10):
        by: Dict[str, float] = {}
        for n, s, e in self.dev:
            by[n] = by.get(n, 0.0) + 1e-6 * (e - s)
        return sorted(([n[:200], v] for n, v in by.items()),
                      key=lambda nv: -nv[1])[:k]

    def idle_gaps(self, k=10):
        """Idle time of the device in the segment, summed by the innermost
        host annotation open at each gap's middle ('host' if none)."""
        if not self.dev:
            return []
        t0 = min(m[1] for m in self.marks) if self.marks else min(
            s for _, s, _ in self.dev)
        t1 = max(m[2] for m in self.marks) if self.marks else max(
            e for _, _, e in self.dev)
        by: Dict[str, float] = {}
        for s, e in gaps([(s, e) for _, s, e in self.dev], t0, t1):
            mid = 0.5 * (s + e)
            open_ = [m for m in self.marks if m[1] <= mid <= m[2]]
            name = (min(open_, key=lambda m: m[2] - m[1])[0] if open_
                    else "host")
            by[name] = by.get(name, 0.0) + 1e-6 * (e - s)
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda nv: -nv[1])[:k]


# -- the device metrics, shared by the readers of each group of cells -------

def busy_ms_per_step(run):
    """The union of the device operations' intervals in the profiled
    segment, over its coupling steps."""
    tr = run.trace
    if tr is None or not tr.dev:
        return None
    return 1e3 * tr.busy_s / tr.steps


def idle_pct(run):
    """The device's idle share of the measured window, untraced: 100 x (1 -
    the traced busy time a step x the window's steps over its wall time).
    The profiled segment's own wall time carries the profiler's host
    overhead (PERF.md), so it is not the denominator."""
    busy = busy_ms_per_step(run)
    if busy is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - 1e-3 * busy * run.steps / run.window_s)


def reduce_us_per_step(run):
    """Device us a step in PyTorch's reduce kernels over double (the f64
    ledger sums and repair), by name in the profiled segment."""
    tr = run.trace
    if tr is None:
        return None
    s, n = tr.kernel_s("reduce_kernel", "double")
    if n == 0:
        return None
    return 1e6 * s / tr.steps


def spmm_roofline_pct(run):
    """The regrid kernels' share of their roofline: the least time of the
    IvE (8 fields), EvI and AvI (10 fields) applies from each operator's
    CSR, for every launch of dest_ice_kernel (K1, once a step and sheet)
    in the profiled segment, over the device time of dest_ice_kernel and
    dest_small_kernel (K2, twice a step and sheet)."""
    tr = run.trace
    if tr is None or run.spmm_bound_s is None:
        return None
    t1, n1 = tr.kernel_s("dest_ice_kernel")
    t2, n2 = tr.kernel_s("dest_small_kernel")
    if n1 == 0 or t1 + t2 <= 0:
        return None
    return 100.0 * run.spmm_bound_s * (n1 / run.n_sheets) / (t1 + t2)
