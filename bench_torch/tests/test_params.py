"""A configuration's regrid parameters (``params``) and the reference module
that judges it (``reference``), at toy lattices on the CPU: without
``params`` the program runs its default; ``params.sigma`` reaches the
coupler; ``check``, the control and the scan run the module a
configuration names; and a configuration that names no module, or one
whose params the plain reference or the ``abi`` driver cannot take, stops
with an error that names it."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

import run as bench
from harness import check, drivers, gcm, system
from reference import coupler as rc
from reference.prec import REFERENCE

BENCH = bench.HERE
RES_KM = 150.0
SEED = 2 ** 31 + 5151
CPU = torch.device("cpu")
GREENLAND = "greenland5km_modele2x2.5"
CONFIGS = (GREENLAND, "greenland_antarctica5km_modele2x2.5",
           "greenland5km_modele2x2.5_ocean1x1.25")
SIGMA = [200e3, 200e3]


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def smoothed(sigma=SIGMA, **params):
    cfg = config(GREENLAND)
    cfg["name"] = "greenland_smoothed"
    cfg["params"] = {"scale": True, "correctA": True, "sigma": sigma,
                     **params}
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
def test_a_configuration_without_params_runs_the_default(name):
    from icebin_tpu_torch import CouplerConfig
    from icebin_tpu_torch.regrid.matrices import RegridParams
    cfg = config(name)
    assert "params" not in cfg
    got = system.coupler_config(cfg, traffic("fused_yearly")).params
    assert got == RegridParams(scale=True, correctA=True)
    assert got == CouplerConfig().params
    assert check.reference(cfg) is rc


@pytest.mark.parametrize("sigma", [SIGMA, [200e3, 200e3, 250.0]])
def test_sigma_reaches_the_coupler(sigma):
    from icebin_tpu_torch import GCMCoupler
    cfg = smoothed(sigma)
    grid = gcm.load(cfg, "fused", SEED)
    cp = GCMCoupler(grid.regridder(CPU, RES_KM),
                    system.coupler_config(cfg, traffic("fused_yearly")),
                    device=CPU)
    assert cp.cfg.params.sigma == tuple(sigma)
    for sc in cp.sheets.values():
        assert sc.cfg.params.sigma == tuple(sigma)
        assert sc.regen.path == "host"
        assert sc.regens_host == 1 and sc.regens_device == 0


@pytest.mark.parametrize("params", [{"sigma": [1.0]},
                                    {"sigma": [1.0, 2.0, 3.0, 4.0]},
                                    {"smooth": True}])
def test_malformed_params_are_refused(params):
    cfg = config(GREENLAND)
    cfg["params"] = params
    with pytest.raises(system.ParamsError, match=GREENLAND):
        system.regrid_params(cfg)


@pytest.mark.parametrize("params", [{}, {"scale": False, "sigma": None},
                                    {"correctA": False, "sigma": None}])
def test_the_plain_reference_refuses_other_params(params):
    cfg = smoothed(**params)
    p = system.regrid_params(cfg)
    with pytest.raises(check.ModuleError, match="greenland_smoothed") as e:
        check.reference(cfg)
    assert "reference/coupler.py" in str(e.value)
    with pytest.raises(ValueError, match="reference/coupler.py"):
        rc.check_params(p)
    # the period itself, whoever calls it, refuses before any step
    with pytest.raises(ValueError, match="reference/coupler.py"):
        rc.period([], {}, torch.zeros(5, dtype=torch.float64), [], 1.0,
                  REFERENCE, params=p, regen=False)


@pytest.mark.parametrize("path", ["bench_torch/reference/no_such_module.py",
                                  "bench_torch/harness/check.py",
                                  "bench_torch/reference/grid.py", None])
def test_a_reference_that_is_no_module_of_the_contract_is_refused(path):
    cfg = config(GREENLAND)
    cfg["reference"] = path
    if path is None:
        del cfg["reference"]
    with pytest.raises(check.ModuleError, match=GREENLAND) as e:
        check.reference(cfg)
    assert str(path) in str(e.value)


def test_the_abi_driver_refuses_params_it_cannot_pass():
    grid = gcm.load(config(GREENLAND), "abi", SEED)
    with pytest.raises(system.ParamsError, match="greenland_smoothed") as e:
        drivers.AbiDriver(smoothed(), traffic("abi_monthly"), SEED, CPU,
                          grid, RES_KM)
    assert "abi" in str(e.value)
    drivers.AbiDriver(config(GREENLAND), traffic("abi_monthly"), SEED, CPU,
                      grid, RES_KM)
    drivers.FusedDriver(smoothed(), traffic("fused_yearly"), SEED, CPU,
                        grid, RES_KM)


SPY = '''"""The plain reference, keeping the params of every period it runs."""
from reference import coupler as _plain
from reference.coupler import (STAT_KEYS, PeriodOut, Sheet,  # noqa: F401
                               SheetState, check_params)

CALLS = []


def period(*a, **kw):
    CALLS.append(kw["params"])
    return _plain.period(*a, **kw)
'''


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark with one more reference module (the plain
    one, counting its periods) and configurations that name it, a missing
    module, and smoothing, with their cells: new files and entries only."""
    root = tmp_path_factory.mktemp("checkout")
    b = root / "bench_torch"
    shutil.copytree(BENCH, b, ignore=shutil.ignore_patterns("__pycache__",
                                                             "tests"))
    (b / "reference" / "coupler_spy.py").write_text(SPY)
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for cfg, ref, cells in (
            (config(GREENLAND), "coupler_spy.py", ("fused_oneway",)),
            (config(GREENLAND), "no_such_module.py", ("fused_oneway",)),
            (smoothed(), "coupler.py", ("fused_yearly", "abi_monthly"))):
        name = {"coupler_spy.py": "greenland_spy",
                "no_such_module.py": "greenland_missing"}.get(ref,
                                                              cfg["name"])
        cfg["name"] = name
        cfg["reference"] = f"bench_torch/reference/{ref}"
        (b / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "a test",
                                "file": f"bench_torch/configs/{name}.json",
                                "reduced": [], "why": "a test"})
        for t in cells:
            cell = f"{name}.{t}"
            spec["workloads"].append({"name": cell, "config": name,
                                      "traffic": t, "chips": 1,
                                      "why": "a test"})
            shutil.copy(b / "limits" / f"greenland.{t}.json",
                        b / "limits" / f"{cell}.json")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for f in [*(b / "harness").glob("*.py"), b / "run.py", b / "control.py",
              b / "scan.py"]:
        assert "coupler_spy" not in f.read_text(), f
    return root


def python(root, *args):
    return subprocess.run([sys.executable, *args], cwd=root,
                          capture_output=True, text=True, timeout=600)


def test_check_control_and_scan_run_the_module_a_configuration_names(
        checkout):
    code = f"""
import json, sys
sys.path[:0] = ["bench_torch", ".", {str(BENCH.parent)!r}]
import torch
import control, run, scan
cpu, cell = torch.device("cpu"), "greenland_spy.fused_oneway"
r, _, _ = run.measure(cell, {SEED}, 0.5, False, cpu, res_km={RES_KM})
spy = sys.modules["reference.coupler_spy"]
n = [len(spy.CALLS)]
control.readings(cell, {SEED}, cpu, {RES_KM})
n.append(len(spy.CALLS))
list(scan.scan(cell, {SEED}, 1, 1, 1, cpu, {RES_KM}))
n.append(len(spy.CALLS))
print(json.dumps({{"correct": r["correct"], "compared": r["compared"],
                  "calls": n, "params": spy.CALLS[0],
                  "file": spy.__file__}}))
"""
    out = python(checkout, "-c", code)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert r["correct"] is True, r["compared"]
    assert r["file"] == str(checkout / "bench_torch" / "reference"
                            / "coupler_spy.py")
    # run: the warm-up and the sampled periods; control: each of the
    # window's periods twice (reference and control); scan: one
    assert 0 < r["calls"][0] < r["calls"][1] < r["calls"][2], r["calls"]
    assert r["calls"][2] - r["calls"][1] == 1
    assert r["params"] == system.DEFAULT_PARAMS


@pytest.mark.parametrize("cell,said", [
    ("greenland_missing.fused_oneway",
     ["greenland_missing", "bench_torch/reference/no_such_module.py"]),
    ("greenland_smoothed.fused_yearly",
     ["greenland_smoothed", "bench_torch/reference/coupler.py", "sigma"]),
    ("greenland_smoothed.abi_monthly",
     ["greenland_smoothed", "abi", "sigma"])])
def test_a_configuration_its_reference_or_driver_cannot_take_stops(
        checkout, cell, said):
    out = python(checkout, "bench_torch/run.py", "--workload", cell,
                 "--seed", str(SEED), "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout == ""
    assert all(s in out.stderr for s in said), out.stderr
    assert "Traceback" not in out.stderr
