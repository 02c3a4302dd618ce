"""The two ways a cell drives the program, selected by a traffic file's
``driver``, and the window loop they share.

* ``abi``: ModelE in a closed loop through the program's ``gcmce_*`` C ABI,
  opened with ctypes.  Each month the forcing goes in through
  ``gcmce_add_gcm_outpute`` in ``rank_pieces`` pieces of ModelE's
  ihc-major E layout, then ``gcmce_couple_native`` fills the fhc, elevE
  and underice buffers.  A step's time runs from the first
  ``gcmce_add_gcm_outpute`` to the return of ``gcmce_couple_native``.
* ``fused``: a standalone run: ``GCMCoupler.run_transient(forcing,
  period_steps, fused=True)`` once per period, the forcing already on the
  card.

Both build the program's regridder through the configuration's GCM grid
kind (``harness/gcm.py``), which names the drivers it supports.

A period is ``period_steps`` coupling steps; every sheet advances one dt a
step.  The window starts at a period boundary, after ``warmup_periods``,
and closes at the first period boundary after ``--seconds``.  The first
period and a seeded reservoir of the rest keep ``sample_periods`` of the
window's periods: their start
state, held state, ledger rows, fields and TOPO, for the comparison with
the reference once the window has closed.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import common, system


@dataclasses.dataclass
class Record:
    """One sampled period of the program."""

    index: int
    month0: int
    step0: int                        # global step of the period's first
    start: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    held0: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    rows: list = dataclasses.field(default_factory=list)
    fields: list = dataclasses.field(default_factory=list)   # a step: sheet
    #                                    -> {"fI", "fE_out", "fA_out"}
    topo: list = dataclasses.field(default_factory=list)     # a step's
    #                                    (fhc, elevE, underice) buffers
    after: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    held1: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    fhc: Dict[str, tuple] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Run:
    """What a run measured and kept; the metric readers read this."""

    steps: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    step_s: List[float] = dataclasses.field(default_factory=list)
    period_s: List[float] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    topo_s: List[float] = dataclasses.field(default_factory=list)
    regen_s: List[float] = dataclasses.field(default_factory=list)
    capture_ms: List[float] = dataclasses.field(default_factory=list)
    trace: Optional[common.Trace] = None
    spmm_bound_s: Optional[float] = None   # least s of a step's applies
    n_sheets: int = 1
    records: List[Record] = dataclasses.field(default_factory=list)
    rows: list = dataclasses.field(default_factory=list)   # window's rows
    memory_peak_bytes: int = 0
    card: str = ""


class Sampler:
    """``k`` periods of a stream of unknown length: the first, and a uniform
    sample of ``k - 1`` of the rest (reservoir sampling), drawn from the
    seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 3])
        self.kept: List[Optional[Record]] = []

    def slot(self, j: int) -> Optional[int]:
        if j < self.k:
            self.kept.append(None)
            return j
        r = int(self.rng.integers(0, j))
        return r + 1 if r < self.k - 1 else None


def _mark(name, on):
    return (torch.profiler.record_function(common.Trace.PREFIX + name) if on
            else contextlib.nullcontext())


class Driver:
    """Shared by both drivers: the forcing, the held state, the sheets'
    timers and the kept periods."""

    def __init__(self, cfg, traffic, seed, device, grid, res_km=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.grid = grid
        self.device = torch.device(device)
        self.res_km = res_km
        self.K = int(traffic["period_steps"])
        self.dt = float(cfg["dt_seconds"])
        self.months = int(traffic["months"])
        self.step = 0                 # global coupling steps so far
        self.marks = [False]          # profiler marks on (traced segment)
        self.timing = [False]         # host timers on (a --trace 1 window)
        self.topo_s: List[float] = []
        self.regen_s: List[float] = []

    def forcing_host(self, nE):
        return common.year_of_forcing(nE, self.seed, self.months)

    def held(self, nE):
        n = int(self.traffic["held_fields"])
        return common.held_fields(nE, self.seed, n) if n else None

    def time_regen(self, sc):
        """Time the calls of ``sc._regen_if_due`` that regenerate."""
        inner = sc._regen_if_due

        def wrapped(ledger):
            if not (self.timing[0] or self.marks[0]) or \
                    sc.steps_since_regen < sc.cfg.regen_every:
                return inner(ledger)
            with _mark("regen", self.marks[0]):
                t = time.perf_counter()
                out = inner(ledger)
                if self.timing[0]:
                    self.regen_s.append(time.perf_counter() - t)
            return out
        sc._regen_if_due = wrapped

    def kept_period(self, index: int, step_s: list):
        """A period kept for the comparison with the reference: (its
        ``Record``, its failed steps)."""
        rec = Record(index=index, month0=self.step % self.months,
                     step0=self.step)
        for name, sc in self.sheets.items():
            st = sc.state
            rec.start[name] = (st.H.clone(), st.enth.clone(), st.bed.clone())
            if sc.held_E is not None:
                rec.held0[name] = sc.held_E.copy()
        fails = self.period(rec, step_s)
        rec.rows = list(self.rows()[-self.K:])
        rec.after = {n: (sc.state.H.clone(), sc.state.enth.clone())
                     for n, sc in self.sheets.items()}
        rec.held1 = {n: sc.held_E.copy() for n, sc in self.sheets.items()
                     if sc.held_E is not None}
        return rec, fails

    def spmm_bound(self, sheets) -> float:
        """Least seconds of one step's IvE, EvI and AvI applies over every
        sheet, from the packs in use: the 8-field forcing through IvE
        and the 10-field harvest through EvI and AvI."""
        total = 0.0
        for sc in sheets.values():
            total += common.csr_bound_s(sc.mat("IvE").pack.ice, 8)
            total += common.csr_bound_s(sc.mat("EvI").pack.small, 10)
            total += common.csr_bound_s(sc.mat("AvI").pack.small, 10)
        return total


class AbiDriver(Driver):
    """ModelE through the C ABI (module docstring)."""

    def setup(self):
        from icebin_tpu_torch.io import write_exchange, write_grid
        from icebin_tpu_torch.models import gcmce_shim
        from icebin_tpu_torch.ops._build_gcmce import gcmce_library
        from icebin_tpu_torch.utils.config import RunConfig, SheetConfig

        lib = ctypes.CDLL(str(gcmce_library()))
        P, I64 = ctypes.c_void_p, ctypes.c_int64
        lib.gcmce_new.argtypes, lib.gcmce_new.restype = [ctypes.c_char_p], \
            ctypes.c_int
        lib.gcmce_set_start_time.argtypes = [ctypes.c_int, ctypes.c_double]
        lib.gcmce_set_start_time.restype = None
        lib.gcmce_add_gcm_outpute.argtypes = [ctypes.c_int, P, P, I64,
                                              ctypes.c_int]
        lib.gcmce_add_gcm_outpute.restype = None
        lib.gcmce_couple_native.argtypes = [ctypes.c_int, ctypes.c_double,
                                            P, P, P, I64]
        lib.gcmce_couple_native.restype = ctypes.c_int
        lib.gcmce_delete.argtypes = [ctypes.c_int]
        lib.gcmce_delete.restype = None
        self.lib = lib
        gr = self.grid.regridder(self.device, self.res_km)
        with tempfile.TemporaryDirectory() as d:
            a = os.path.join(d, "a.nc")
            write_grid(a, gr.specA)
            sheets = []
            for name, sh in gr.sheets.items():
                i, x = (os.path.join(d, f"{name}_{f}.nc")
                        for f in ("grid", "x"))
                write_grid(i, sh.gridI)
                write_exchange(x, sh.exchange)
                sheets.append(SheetConfig(name=name, grid_file=i,
                                          exchange_file=x,
                                          subdiv=self.cfg["subdiv"]))
            rc = RunConfig(gridA_file=a, hcdefs=list(self.cfg["hcdefs"]),
                           sheets=sheets, dt_seconds=self.dt,
                           regen_every=system.regen_every(self.traffic),
                           min_thickness=float(self.cfg["min_thickness"]))
            path = os.path.join(d, "run.json")
            rc.to_json(path)
            del gr
            self.h = lib.gcmce_new(path.encode())
        if self.h <= 0:
            raise RuntimeError(f"gcmce_new returned {self.h}")
        self.ad = ad = gcmce_shim._handles[self.h]
        nA, nhc, nE = ad.nA, ad.nhc, ad.gr.nE
        self.nA, self.nhc, self.nE = nA, nhc, nE
        self.sheets = ad.coupler.sheets
        held = self.held(nE)
        if held is not None:
            for name in self.sheets:
                ad.set_held_state(name, to_modele(held, nA, nhc))
        lib.gcmce_set_start_time(self.h, 0.0)
        # each month's rank pieces, ModelE layout, f64, contiguous
        self.pieces = []
        n = int(self.traffic["rank_pieces"])
        cuts = np.linspace(0, nE, n + 1).astype(np.int64)
        self.forcing = self.forcing_host(nE)
        for f in self.forcing:
            fm = to_modele(f.astype(np.float64), nA, nhc)
            self.pieces.append([
                (np.arange(lo, hi, dtype=np.int64),
                 np.ascontiguousarray(fm[:, lo:hi]))
                for lo, hi in zip(cuts[:-1], cuts[1:])])
        self.bufs = (np.zeros(nE), np.zeros(nE), np.zeros(nE, np.int32))
        # what the harness keeps of a sampled period, and the timers
        self.rec: Optional[Record] = None
        inner_couple = ad.coupler.couple
        inner_native = ad.couple_native

        def couple(fE):
            out = inner_couple(fE)
            if self.rec is not None:
                self.rec.fields.append({n_: {"fI": r["fI"]}
                                        for n_, r in out.items()})
            return out

        def couple_native(itime):
            out = inner_native(itime)
            if self.rec is not None:
                for n_, r in out.items():
                    self.rec.fields[-1][n_].update(
                        fE_out=from_modele(r["fE_out_modele"], nA, nhc),
                        fA_out=r["fA_out"])
            return out
        ad.coupler.couple = couple
        ad.couple_native = couple_native
        topo = ad.topo

        def timed_topo():
            if not (self.timing[0] or self.marks[0]):
                return topo()
            with _mark("topo", self.marks[0]):
                t = time.perf_counter()
                out = topo()
                if self.timing[0]:
                    self.topo_s.append(time.perf_counter() - t)
            return out
        ad.topo = timed_topo
        for sc in self.sheets.values():
            self.time_regen(sc)

    def rows(self):
        return self.ad.coupler.ledger.steps

    def period(self, rec: Optional[Record], step_s: list):
        lib, h = self.lib, self.h
        self.rec = rec
        fails = 0
        for _ in range(self.K):
            month = self.step % self.months
            with _mark("step", self.marks[0]):
                t = time.perf_counter()
                with _mark("add_gcm_outpute", self.marks[0]):
                    for idx, vals in self.pieces[month]:
                        lib.gcmce_add_gcm_outpute(h, idx.ctypes.data,
                                                  vals.ctypes.data, len(idx),
                                                  vals.shape[0])
                with _mark("couple_native", self.marks[0]):
                    rc = lib.gcmce_couple_native(
                        h, self.step * self.dt,
                        *(b.ctypes.data for b in self.bufs), self.nE)
                step_s.append(time.perf_counter() - t)
            fails += rc != 0
            if rec is not None:
                rec.topo.append(tuple(b.copy() for b in self.bufs))
            self.step += 1
        self.rec = None
        return fails

    def free(self):
        self.lib.gcmce_delete(self.h)
        self.ad = self.sheets = None


class FusedDriver(Driver):
    """A standalone run through ``run_transient(..., fused=True)``."""

    def setup(self):
        from icebin_tpu_torch import GCMCoupler
        gr = self.grid.regridder(self.device, self.res_km)
        self.cp = GCMCoupler(gr, system.coupler_config(self.cfg,
                                                       self.traffic),
                             device=self.device)
        self.sheets = self.cp.sheets
        held = self.held(gr.nE)
        if held is not None:
            for sc in self.sheets.values():
                sc.set_held_state(held)
        self.F = [torch.as_tensor(f, device=self.device)
                  for f in self.forcing_host(gr.nE)]
        for sc in self.sheets.values():
            self.time_regen(sc)

    def rows(self):
        return self.cp.ledger.steps

    def period(self, rec: Optional[Record], step_s: list):
        F, dt, months = self.F, self.dt, self.months
        with _mark("run_transient", self.marks[0]):
            res = self.cp.run_transient(
                lambda t, name: F[int(round(t / dt)) % months], self.K,
                fused=True)
        if rec is not None:
            rec.fields.append({n: {k: r[k] for k in ("fI", "fE_out",
                                                     "fA_out")}
                               for n, r in res.items()})
            rec.fhc = {n: (r["fhc"], r["elevE"]) for n, r in res.items()
                       if r.get("E1vE0") is not None}
        self.step += self.K
        return 0

    def free(self):
        self.cp = self.sheets = None


DRIVERS = {"abi": AbiDriver, "fused": FusedDriver}


def to_modele(f, nA, nhc):
    """a-major E (e = a nhc + k) to ModelE's ihc-major (e = k nA + a)."""
    f = np.asarray(f)
    return np.ascontiguousarray(np.swapaxes(
        f.reshape(f.shape[:-1] + (nA, nhc)), -1, -2).reshape(f.shape))


def from_modele(f, nA, nhc):
    f = np.asarray(f)
    return np.ascontiguousarray(np.swapaxes(
        f.reshape(f.shape[:-1] + (nhc, nA)), -1, -2).reshape(f.shape))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cfg, traffic, seed, seconds, device, grid, *, trace=False,
             res_km=None, t_start=None) -> Run:
    """Set up, warm up, run the window, and (``trace``) a profiled segment
    after it; ``grid`` is the configuration's GCM grid (``harness.gcm``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    drv = DRIVERS[traffic["driver"]](cfg, traffic, seed, device, grid,
                                     res_km)
    run = Run()
    drv.setup()
    run.n_sheets = len(drv.sheets)
    for _ in range(int(traffic["warmup_periods"])):
        drv.period(None, [])
    sync(drv.device)
    caps0 = {n: len(sc.capture_ms) for n, sc in drv.sheets.items()}
    row0 = len(drv.rows())
    sampler = Sampler(int(traffic["sample_periods"]), seed)
    drv.timing[0] = trace
    run.setup_s = time.perf_counter() - t_start
    t0 = t_prev = time.perf_counter()
    j = 0
    while True:
        slot = sampler.slot(j)
        if slot is None:
            run.failed += drv.period(None, run.step_s)
        else:
            sampler.kept[slot], fails = drv.kept_period(j, run.step_s)
            run.failed += fails
        j += 1
        t = time.perf_counter()
        run.period_s.append(t - t_prev)
        t_prev = t
        if t - t0 >= seconds:
            break
    sync(drv.device)
    run.window_s = time.perf_counter() - t0
    run.steps = j * drv.K
    run.attempted = run.steps
    drv.timing[0] = False
    run.rows = drv.rows()[row0:row0 + run.steps]
    run.capture_ms = [ms for n, sc in drv.sheets.items()
                      for ms in sc.capture_ms[caps0[n]:]]
    run.topo_s, run.regen_s = list(drv.topo_s), list(drv.regen_s)
    run.records = sorted((r for r in sampler.kept if r is not None),
                         key=lambda r: r.index)
    if trace:
        run.trace, run.spmm_bound_s = traced(drv, int(traffic["trace_periods"]))
    if drv.device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
            drv.device))
    drv.free()
    return run


def traced(drv: Driver, periods: int):
    """``periods`` more periods under torch.profiler, each annotated."""
    from torch.profiler import ProfilerActivity, profile
    bound = drv.spmm_bound(drv.sheets)
    acts = [ProfilerActivity.CPU]
    if drv.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(drv.device)
    drv.marks[0] = True
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(periods):
            drv.period(None, [])
        sync(drv.device)
        wall = time.perf_counter() - t
    drv.marks[0] = False
    return common.Trace(prof.events(), wall, periods * drv.K), bound
