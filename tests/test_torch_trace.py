"""The port's span recorder (``icebin_tpu_torch.utils.trace``), on the CPU:
the recorder itself, its ranges in a torch.profiler trace, the spans a
fused run of the CFL-bound toy coupler opens (tests/test_torch_step_graph.py),
and the ``run`` CLI's ``--spans`` file.

Tolerances, with their reasons:
* recorder on against off: bit for bit (ledger rows ``==``, state and held
  state equal).  The spans read the host clock and nothing else.
* the CSR pack against its direct construction: bit for bit.  The host
  arrays are cast to the pack's dtypes before the copy instead of by it,
  which rounds f64 to f32 the same way.
"""
import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from icebin_tpu_torch.cli.run import main as run_main
from icebin_tpu_torch.io import write_grid
from icebin_tpu_torch.ops.csr import csr_from_coo
from icebin_tpu_torch.utils import trace
from icebin_tpu_torch.utils.config import RunConfig, SheetConfig

from test_torch_coupler import toy_specs
from test_torch_step_graph import N_STEPS, REGEN, cfl_port, forcing

torch.set_num_threads(1)

# a regeneration's stages on the device path; its exchange grid's upload
# (``regen.upload``) is made once, at set-up
REGEN_STAGES = ("regen.factory", "regen.pack", "regen.e1ve0")


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the program's recorder off and
    empty."""
    assert not trace.RECORDER.on
    trace.drain()
    yield
    trace.RECORDER.on = False
    trace.drain()


def children(spans, i, name=None):
    return [s for s in spans
            if s.parent == i and (name is None or s.name == name)]


# -- the recorder -----------------------------------------------------------

def test_off_records_nothing():
    rec = trace.Recorder()
    with rec.span("a", sheet="s") as got:
        with rec.span("b"):
            pass
    assert got is None and rec.drain() == []
    assert rec.span("a") is rec.span("b")       # one shared no-op context


def test_nesting_parents_and_attributes():
    rec = trace.Recorder()
    with trace.recording(rec):
        with rec.span("a"):
            with rec.span("a.b", sheet="greenland"):
                pass
            with rec.span("a.c", sheet="antarctica"):
                with rec.span("a.c.d"):
                    pass
        with rec.span("e"):
            pass
    assert not rec.on
    spans = rec.drain()
    assert [s.name for s in spans] == ["a", "a.b", "a.c", "a.c.d", "e"]
    assert [s.parent for s in spans] == [None, 0, 0, 2, None]
    assert [s.attrs.get("sheet") for s in spans] == [
        None, "greenland", "antarctica", None, None]
    for s in spans:
        assert s.start <= s.end
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
    assert spans[1].end <= spans[2].start and spans[0].end <= spans[4].start
    assert rec.drain() == []


def test_drain_refuses_an_open_span_and_an_error_closes_it():
    rec = trace.Recorder()
    with trace.recording(rec):
        with rec.span("a"):
            with pytest.raises(RuntimeError, match="'a'"):
                rec.drain()
        with pytest.raises(ValueError):
            with rec.span("b"):
                raise ValueError
        (a, b) = rec.drain()
    assert a.end is not None and b.end is not None and b.parent is None


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_profiler_ranges_only_while_recording(on):
    """A CPU torch.profiler trace holds ``icebin.<name>`` ranges, nested as
    the spans are, only while the recorder is on."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording() if on else contextlib.nullcontext():
            with trace.span("regen", sheet="toy"):
                with trace.span("regen.pack"):
                    torch.ones(8).sum()
    spans = trace.drain()
    got = {e.name: e.time_range for e in prof.events()
           if e.name.startswith(trace.PREFIX)}
    if not on:
        assert got == {} and spans == []
        return
    assert set(got) == {"icebin.regen", "icebin.regen.pack"}
    outer, inner = got["icebin.regen"], got["icebin.regen.pack"]
    assert outer.start <= inner.start and inner.end <= outer.end
    assert [s.name for s in spans] == ["regen", "regen.pack"]


def test_chrome_trace_events():
    rec = trace.Recorder()
    with trace.recording(rec):
        with rec.span("window"):
            with rec.span("window.fetch", sheet="toy"):
                pass
    ev = json.loads(json.dumps(trace.chrome_trace(rec.drain())))
    (w, f) = ev["traceEvents"]
    assert (w["name"], f["name"]) == ("window", "window.fetch")
    assert w["ph"] == f["ph"] == "X" and w["ts"] == 0.0
    assert w["ts"] <= f["ts"] and f["ts"] + f["dur"] <= w["ts"] + w["dur"]
    assert f["args"] == {"sheet": "toy", "index": 1, "parent": 0}


# -- the CSR pack split into host arrays and upload -------------------------

def test_csr_pack_is_its_direct_construction():
    rng = np.random.default_rng(5)
    n_dst, n_src, nnz = 37, 53, 400
    dst, src = rng.integers(0, n_dst, nnz), rng.integers(0, n_src, nnz)
    vals = rng.uniform(1e-9, 1e3, nnz)
    w = np.where(rng.uniform(size=n_dst) < 0.2, 0.0,
                 rng.uniform(0.1, 9.0, n_dst))
    got = csr_from_coo(dst, src, vals, n_dst, n_src, w, device="cpu")
    order = np.lexsort((src, dst))
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(dst,
                                                        minlength=n_dst))])
    winv = np.where(w != 0, 1.0 / np.where(w != 0, w, 1.0), 0.0)
    want = dict(rowptr=torch.as_tensor(rowptr, dtype=torch.int32),
                cols=torch.as_tensor(src[order], dtype=torch.int32),
                vals=torch.as_tensor(vals[order], dtype=torch.float32),
                winv=torch.as_tensor(winv, dtype=torch.float32))
    for k, v in want.items():
        g = getattr(got, k)
        assert g.dtype == v.dtype and torch.equal(g, v), k
    assert (got.n_dst, got.n_src) == (n_dst, n_src)
    lens = np.diff(rowptr)
    assert got.n_live == int((lens > 0).sum())


# -- the fused run of the toy coupler --------------------------------------

def fused_run(on):
    """The CFL-bound toy (held state, a regeneration every REGEN steps, a
    budget that reruns) through ``run_transient(..., fused=True)``, the
    recorder ``on`` or off; returns (coupler, spans)."""
    cp = cfl_port()
    with trace.recording() if on else contextlib.nullcontext():
        cp.run_transient(forcing(cp), N_STEPS, fused=True)
    return cp, trace.drain()


def test_fused_run_spans():
    cp, spans = fused_run(True)
    sc = cp.sheets["toy"]
    names = [s.name for s in spans]
    assert set(names) == {"window", "window.forcing", "window.launch",
                          "window.fetch", "regen", *REGEN_STAGES,
                          "regen.topo"}
    windows = [i for i, s in enumerate(spans) if s.name == "window"]
    assert len(windows) == -(-N_STEPS // REGEN)          # 3, 3 and 1 steps
    assert all(spans[i].parent is None for i in windows)
    assert sc.reruns >= 2                    # the budget 1 -> 2 -> 4 reruns
    launches = 0
    for i in windows:
        kids = children(spans, i)
        assert {s.name for s in kids} <= {"window.forcing", "window.launch",
                                          "window.fetch", "regen",
                                          "regen.topo"}
        assert len(children(spans, i, "window.forcing")) == 1
        n = len(children(spans, i, "window.launch"))
        assert len(children(spans, i, "window.fetch")) == n >= 1
        launches += n
        for s in kids:
            assert s.name == "regen" or s.attrs == {"sheet": "toy"}
    assert launches == len(windows) + sc.reruns
    regens = [i for i, s in enumerate(spans) if s.name == "regen"]
    assert len(regens) == N_STEPS // REGEN
    for i in regens:
        assert spans[spans[i].parent].name == "window"
        assert spans[i].attrs == {"sheet": "toy", "path": "device",
                                  "grid": "lonlat"}
        kids = children(spans, i)
        assert {s.name for s in kids} == set(REGEN_STAGES)
        assert all(s.attrs in ({}, {"sheet": "toy"}) for s in kids)
        assert sum(s.ns for s in kids) <= spans[i].ns
    # one regen.topo a generation: the two regenerations' (the first
    # generation's fields are never asked for in a fused run)
    topo = [s for s in spans if s.name == "regen.topo"]
    assert len(topo) == N_STEPS // REGEN
    assert all(spans[s.parent].name == "window" for s in topo)
    with trace.recording():
        fhc, elevE = sc.topo_fields()               # cached: no span
    assert trace.drain() == []
    assert fhc is sc.rm.fhc() and elevE is sc.rm.elevE()


def test_fused_run_is_the_same_with_the_recorder_on():
    a, spans_a = fused_run(True)
    b, spans_b = fused_run(False)
    assert spans_a and spans_b == []
    assert a.ledger.to_rows() == b.ledger.to_rows()
    sa, sb = a.sheets["toy"], b.sheets["toy"]
    for k in ("H", "bed", "enth", "t"):
        assert torch.equal(getattr(sa.state, k), getattr(sb.state, k)), k
    assert np.array_equal(sa.held_E, sb.held_E)
    assert (sa.budget, sa.reruns) == (sb.budget, sb.reruns)


def test_stepwise_couple_opens_regen_and_topo_only():
    """Each stepwise ``couple`` is a window of one: one top-level
    ``window`` a step, holding its ``window.launch`` and ``window.fetch``
    (one more of each a budget rerun) and no ``window.forcing`` (the
    caller gives the forcing); each regeneration's ``regen``, with its
    stages, and one ``regen.topo`` a generation (the first step's asks
    for the first generation's fields) sit under the window of the step
    that brought them."""
    cp = cfl_port()
    sc = cp.sheets["toy"]
    with trace.recording():
        for _ in range(REGEN + 1):
            cp.couple({"toy": forcing(cp)(cp.time, "toy")})
    spans = trace.drain()
    windows = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in windows] == ["window"] * (REGEN + 1)
    launches = 0
    for i in windows:
        kids = children(spans, i)
        assert {s.name for s in kids} <= {"window.launch", "window.fetch",
                                          "regen", "regen.topo"}
        n = len(children(spans, i, "window.launch"))
        assert len(children(spans, i, "window.fetch")) == n >= 1
        launches += n
    assert launches == REGEN + 1 + sc.reruns
    assert [(spans[s.parent].name, s.name) for s in spans
            if s.name in ("regen", "regen.topo")] == [
        ("window", "regen.topo"), ("window", "regen"),
        ("window", "regen.topo")]
    (i,) = [i for i, s in enumerate(spans) if s.name == "regen"]
    assert spans[i].parent == windows[REGEN - 1]
    assert {s.name for s in children(spans, i)} == set(REGEN_STAGES)


def modele_ocean_coupler():
    """A fused-ready coupler over ModelE's mismatched regridder: two sheets
    on an 8 x 8 A grid, the 16 x 16 ocean grid O nested in it, a random
    ocean fraction and its rounding."""
    import icebin_tpu_torch as port
    from icebin_tpu_torch.grid import GridSpecLonLat, GridSpecXY, PlateCarree
    from icebin_tpu_torch.regrid.modele import GCMRegridderModelE
    specA, specO = (GridSpecLonLat(lonb=np.linspace(0.0, 40.0, n + 1),
                                   latb=np.linspace(30.0, 70.0, n + 1))
                    for n in (8, 16))
    grO = port.GCMRegridder(specO, [0.0, 1000.0, 3000.0], device="cpu")
    for name, x0 in (("west", 5), ("east", 22)):
        grO.add_sheet(name, GridSpecXY(
            xb=np.linspace(x0 * 25e3, (x0 + 13) * 25e3, 21),
            yb=np.linspace(35 * 25e3, 65 * 25e3, 31),
            projection=PlateCarree(scale=25e3)), subdiv=1)
    op = np.clip(np.random.default_rng(0).uniform(-0.3, 0.6, specO.ncells),
                 0, 1)
    gr = GCMRegridderModelE(grO, specA, op, np.round(op))
    cfg = port.CouplerConfig(regen_every=2)
    with trace.recording():
        cp = port.GCMCoupler(gr, cfg, device="cpu")
    return gr, cp, trace.drain()


def test_fused_run_over_the_ocean_grid_spans():
    """Over ModelE's mismatched regridder: set-up's ``regen.upload`` holds
    one ``regen.retarget`` a sheet (the cells moved, the A cells
    rescaled), and each ``regen`` of a fused run says its grid."""
    gr, cp, setup = modele_ocean_coupler()
    ups = [i for i, s in enumerate(setup) if s.name == "regen.upload"]
    assert [setup[i].attrs["sheet"] for i in ups] == list(gr.sheets)
    for i in ups:
        (kid,) = children(setup, i)
        s = setup[i].attrs["sheet"]
        assert kid.name == "regen.retarget"
        assert kid.attrs == {"sheet": s, "rescaled": gr.rescaled,
                             "cells": len(gr.sheets[s].exchangeO.iA)}
        assert kid.ns <= setup[i].ns
    assert [s.name for s in setup].count("regen.retarget") == len(gr.sheets)
    f = torch.zeros(8, gr.nE)
    f[4] = -10.0
    with trace.recording():
        cp.run_transient(lambda t, s: f, 4, fused=True)
    spans = trace.drain()
    regen = [s for s in spans if s.name == "regen"]
    assert [s.attrs for s in regen] == 2 * [
        {"sheet": n, "path": "device", "grid": "modele_ocean"}
        for n in gr.sheets]
    assert "regen.retarget" not in {s.name for s in spans}


# -- the run CLI's --spans --------------------------------------------------

def run_dir(d):
    specA, specI = toy_specs(n_ice=24)
    a, i = str(d / "a.nc"), str(d / "i.nc")
    write_grid(a, specA)
    write_grid(i, specI)
    cfg = str(d / "run.json")
    RunConfig(gridA_file=a, hcdefs=[0.0, 800.0, 2500.0], n_steps=4,
              sheets=[SheetConfig(name="s", grid_file=i, subdiv=1)],
              regen_every=2).to_json(cfg)
    return cfg


def test_run_cli_writes_spans(tmp_path, capsys, monkeypatch):
    """``--spans`` writes Chrome trace events holding each window and
    regeneration (set-up's matrices too) and leaves the report as it is."""
    out = {}
    for name, extra in (("plain", []),
                        ("spans", ["--spans", str(tmp_path / "s.json")])):
        d = tmp_path / name
        d.mkdir()
        cfg = run_dir(d)
        monkeypatch.chdir(d)
        assert run_main([cfg, "--device", "cpu", "--fused", *extra]) == 0
        out[name] = capsys.readouterr().out
    assert out["spans"] == out["plain"] and "4 steps" in out["plain"]
    assert not trace.RECORDER.on and trace.drain() == []
    ev = json.loads((tmp_path / "s.json").read_text())["traceEvents"]
    names = [e["name"] for e in ev]
    assert names.count("window") == 2 and names.count("regen") == 2
    assert {"regen.factory", "regen.pack", "regen.upload", "regen.e1ve0",
            "regen.topo", "window.launch", "window.fetch"} <= set(names)
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in ev)
    assert {e["args"]["sheet"] for e in ev if e["name"] == "regen"} == {"s"}
    # set-up uploads the exchange grid and builds the first matrices
    # outside any window or regeneration
    assert [e["name"] for e in ev[:2]] == ["regen.upload", "regen.factory"]
    assert ev[0]["args"]["parent"] is ev[1]["args"]["parent"] is None
    assert names.count("regen.upload") == 1
