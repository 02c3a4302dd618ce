"""GCM grid kinds at toy lattices on the CPU: ``modele_lonlat`` builds the
arrays it built before it was a kind, a new kind comes in as new files
alone, and an unknown kind or an unsupported traffic stops a run before
its set-up.  And ``correct``'s floors: a period in which a sheet's last
cold ice reaches the melting point reads under the limits, and a planted
fault in it still does not."""
import dataclasses
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import run as bench
from harness import check, gcm
from reference import coupler as rc
from reference.prec import REFERENCE

BENCH = bench.HERE
RES_KM = 150.0
SEED = 2 ** 31 + 4242
CPU = torch.device("cpu")
GREENLAND = "greenland5km_modele2x2.5"
BOTH = "greenland_antarctica5km_modele2x2.5"

# the harness before the kinds (exchange grids at RES_KM): entries,
# sums of the indices, sums of the areas and of area x iA
PROGRAM = {
    "greenland": dict(nX=1048, iA=12412093, iI=118600, nI=190,
                      area=4200000000000.0, area_iA=4.901659334450729e+16,
                      areaA_proj=510139009599546.8),
    "antarctica": dict(nX=8524, iA=10359072, iI=5830416, nI=1369,
                       area=31360000000000.0,
                       area_iA=4.619991106966839e+16,
                       areaA_proj=510876503960164.6),
}
REFERENCE_XG = {
    "greenland": dict(nX=1049, iA=12423968, iI=118729, nI=190, nA=12960,
                      area=4200000000000.0, area_iA=4.901659334521857e+16,
                      cA=12961.328300434032),
    "antarctica": dict(nX=8524, iA=10359072, iI=5830416, nI=1369, nA=12960,
                       area=31359999999999.992,
                       area_iA=4.619991107368153e+16,
                       cA=12967.100536675765),
}
SPEC_A = dict(nA=12960, area=510064471909788.25)


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def close(a, b):
    return abs(a - b) <= 1e-15 * abs(b)


@pytest.mark.parametrize("name", [GREENLAND, BOTH])
def test_modele_lonlat_builds_the_arrays_it_built_before(name):
    cfg = config(name)
    grid = gcm.load(cfg, "fused", SEED)
    gr = grid.regridder(CPU, RES_KM)
    assert gr.specA.ncells == SPEC_A["nA"]
    assert close(float(np.sum(gr.specA.cell_areas())), SPEC_A["area"])
    assert list(gr.sheets) == [s["name"] for s in cfg["sheets"]]
    for s, sh in gr.sheets.items():
        x, want = sh.exchange, PROGRAM[s]
        assert (len(x.iA), int(np.sum(x.iA, dtype=np.int64)),
                int(np.sum(x.iI, dtype=np.int64)), x.nI) == \
            (want["nX"], want["iA"], want["iI"], want["nI"])
        assert close(float(np.sum(x.area)), want["area"])
        assert close(float(np.sum(x.area * x.iA)), want["area_iA"])
        assert close(float(np.sum(sh.areaA_proj)), want["areaA_proj"])
    for sh in check.reference_sheets(cfg, grid, CPU, REFERENCE, RES_KM):
        x, want = sh.xg, REFERENCE_XG[sh.name]
        assert (x.iA.numel(), int(x.iA.sum()), int(x.iI.sum()), x.nI,
                x.nA) == (want["nX"], want["iA"], want["iI"], want["nI"],
                          want["nA"])
        assert close(float(x.area.sum()), want["area"])
        assert close(float((x.area * x.iA).sum()), want["area_iA"])
        assert close(float(x.cA.sum()), want["cA"])


KIND = "modele_lonlat_fused_only"


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark with one more kind (``modele_lonlat`` again,
    driving ``fused`` only), a configuration of that kind and one of a kind
    with no files, and their cells: new files and entries only."""
    root = tmp_path_factory.mktemp("checkout")
    b = root / "bench_torch"
    shutil.copytree(BENCH, b, ignore=shutil.ignore_patterns("__pycache__",
                                                             "tests"))
    src = (b / "gcm" / "modele_lonlat.py").read_text()
    new = src.replace('DRIVERS = ("fused", "abi")', 'DRIVERS = ("fused",)')
    assert new != src
    (b / "gcm" / f"{KIND}.py").write_text(new)
    shutil.copy(b / "reference" / "gcm" / "modele_lonlat.py",
                b / "reference" / "gcm" / f"{KIND}.py")
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for name, kind in (("greenland_new_kind", KIND),
                       ("greenland_no_kind", "no_such_kind")):
        cfg = config(GREENLAND)
        cfg["name"] = name
        cfg["gcm_grid"]["kind"] = kind
        (b / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "a test",
                                "file": f"bench_torch/configs/{name}.json",
                                "reduced": [], "why": "a test"})
        for traffic, lim in (("fused_oneway", "greenland.fused_oneway"),
                             ("abi_monthly", "greenland.abi_monthly")):
            cell = f"{name}.{traffic}"
            spec["workloads"].append({"name": cell, "config": name,
                                      "traffic": traffic, "chips": 1,
                                      "why": "a test"})
            shutil.copy(b / "limits" / f"{lim}.json",
                        b / "limits" / f"{cell}.json")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for f in [*(b / "harness").glob("*.py"), b / "run.py", b / "control.py"]:
        assert KIND not in f.read_text(), f
    return root


def python(root, *args):
    return subprocess.run([sys.executable, *args], cwd=root,
                          capture_output=True, text=True, timeout=600)


def test_a_new_kind_needs_only_new_files(checkout):
    code = f"""
import json, sys
sys.path[:0] = ["bench_torch", ".", {str(BENCH.parent)!r}]
import torch
import run
from harness import gcm
cell = "greenland_new_kind.fused_oneway"
r, _, _ = run.measure(cell, {SEED}, 0.5, False, torch.device("cpu"),
                      res_km={RES_KM})
halves = gcm.find(run.load_cell(cell)[1], "fused")
print(json.dumps({{"correct": r["correct"], "compared": r["compared"],
                  "kind": [h.__file__ for h in halves]}}))
"""
    out = python(checkout, "-c", code)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert r["correct"] is True, r["compared"]
    assert r["kind"] == [str(checkout / "bench_torch" / d / f"{KIND}.py")
                         for d in ("gcm", "reference/gcm")]


@pytest.mark.parametrize("cell,said", [
    ("greenland_new_kind.abi_monthly",
     [f"bench_torch/gcm/{KIND}.py", "('fused',)", "'abi'"]),
    ("greenland_no_kind.fused_oneway",
     ["bench_torch/gcm/no_such_kind.py",
      "bench_torch/reference/gcm/no_such_kind.py"])])
def test_a_kind_that_cannot_run_the_cell_stops_before_set_up(checkout, cell,
                                                              said):
    out = python(checkout, "bench_torch/run.py", "--workload", cell,
                 "--seed", str(SEED), "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout == ""
    assert all(s in out.stderr for s in said), out.stderr
    assert "Traceback" not in out.stderr


@dataclasses.dataclass
class Melting:
    """A period of the two-sheet toy in which each sheet's last cold ice
    reaches the melting point: the reference's sum |U| and column specific
    enthalpy fall 1e6-fold, from a start whose cold content is what the
    period's energy input would warm; the program one f32 ulp of the start's
    values away, in the coldest cell and in the heaviest E and A cells."""

    rec: object
    out: rc.PeriodOut
    inp: check.Inputs

    @property
    def sheets(self):
        return self.inp.sheets


def f32_ulp(x):
    x = torch.as_tensor(x, dtype=torch.float32)
    return (torch.nextafter(x.abs(), torch.tensor(np.inf)) - x.abs()).double()


@pytest.fixture(scope="module")
def melting():
    cfg = config(BOTH)
    traffic = json.loads((BENCH / "traffic" / "fused_oneway.json")
                         .read_text())
    grid = gcm.load(cfg, "fused", SEED)
    inp = check.inputs(cfg, traffic, SEED, CPU, REFERENCE, grid, RES_KM)
    start, _ = check.initial(inp, traffic, SEED, CPU)
    out = check.run_period(inp, start, {}, 0, 0, REFERENCE, False,
                           float(cfg["min_thickness"]))
    rec = check.as_record(inp, out, start, {}, 0, 0, False)
    for sh in inp.sheets:
        s = sh.name
        e_in = sum(float(st[s][rc.STAT_KEYS.index("energy_in_E")])
                   for st in out.stats)
        U = out.states[s].U.double()
        U0 = U * (e_in / sh.cell_area / float(U.abs().sum()))
        c = int(U0.abs().argmax())
        out.states[s] = dataclasses.replace(out.states[s],
                                            U=(U0 * 1e-6).float())
        pU = out.states[s].U.double().reshape(-1).clone()
        pU[c] += f32_ulp(U0.reshape(-1)[c])
        rec.after[s] = (rec.after[s][0], pU)
        fI, fE, fA = out.fields[-1][s]
        fE, fA = fE.clone(), fA.clone()
        pf = rec.fields[-1][s] = dict(rec.fields[-1][s])
        for k, f, w in (("fE_out", fE, out.ref_mats[s].EvI.wM),
                        ("fA_out", fA, out.ref_mats[s].AvI.wM)):
            r9 = f[9] * (e_in / sh.cell_area / float(U.abs().sum()))
            f[9] = r9 * 1e-6
            p = f.clone()
            j = int(torch.argmax(w))
            p[9, j] += f32_ulp(r9[j])
            pf[k] = p
        out.fields[-1][s] = (fI, fE, fA)
    return Melting(rec, out, inp)


def limits():
    return json.loads((BENCH / "limits" / "two_sheets.fused_oneway.json")
                      .read_text())


def test_a_sheet_reaching_the_melting_point_reads_under_the_limits(
        melting, monkeypatch):
    m = melting
    g, _ = check.numbers(m.rec, m.out, m.inp, False)
    lim = limits()
    assert g["state"] <= lim["state"] and g["harvest"] <= lim["harvest"], g
    # without the floors (the numbers as they were) the same period fails
    whole = check.wgap
    monkeypatch.setattr(check, "wgap", lambda p, r, w, floor=0.0:
                        whole(p, r, w))
    g0, _ = check.numbers(m.rec, m.out, m.inp, False)
    assert g0["state"] > lim["state"] and g0["harvest"] > lim["harvest"], g0


def test_an_altered_answer_in_that_period_is_not_correct(melting):
    """``test_an_altered_answer_is_not_correct``'s fault: one E cell's
    runoff doubled."""
    m = melting
    rec = dataclasses.replace(m.rec, fields=[dict(f) for f in m.rec.fields])
    s = m.sheets[0].name
    p = dict(rec.fields[-1][s])
    fE = p["fE_out"].clone()
    fE[3, int(torch.argmax(m.out.ref_mats[s].EvI.wM))] *= 2.0
    p["fE_out"] = fE
    rec.fields[-1][s] = p
    g, _ = check.numbers(rec, m.out, m.inp, False)
    assert g["harvest"] > limits()["harvest"], g


@pytest.mark.parametrize("fault", [False, True])
def test_a_scan_holds_each_period_against_the_reference(fault,
                                                        monkeypatch):
    """``scan.py`` over periods 1 and 3 of the yearly toy; with the books'
    sums taken over every other cell and doubled, both are over."""
    import scan
    if fault:
        from icebin_tpu_torch.coupler import coupler as cmod
        whole = cmod.weighted_mass
        monkeypatch.setattr(cmod, "weighted_mass",
                            lambda f, w: 2.0 * whole(f[..., ::2], w[::2]))
    got = list(scan.scan("two_sheets.fused_yearly", SEED, 1, 3, 2, CPU,
                         RES_KM))
    assert [p for p, _, _ in got] == [1, 3]
    assert set(got[0][1]) == set(limits()) | {"held", "topo"}
    assert all(bool(over) == fault for _, _, over in got), got
