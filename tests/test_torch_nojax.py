"""The port runs without JAX and without the reference package: no module
of icebin_tpu_torch imports icebin_tpu, and neither is loaded after the toy
coupler, the overlap CLI, the run CLI, ``ModelEAdapter.couple_native`` and
a gcmce shim round trip, nor after the entry points of the dest-small,
dest-ice, fold and capacity probes and the regrid and clip kernels' geometry
sweeps, nor in the ranks of a 2-rank gloo mesh coupler;
chip_smoke.py imports only the port and refuses to run without a GPU.

Each check runs in a fresh interpreter (a subprocess), since this test
process has JAX loaded by the suite's conftest.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TOY_RUN = """
import sys
import numpy as np
import torch
import icebin_tpu_torch as port
from icebin_tpu_torch.grid import GridSpecLonLat, GridSpecXY, PlateCarree

s = 25e3
specA = GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                       latb=np.linspace(30.0, 80.0, 7))
specI = GridSpecXY(xb=np.linspace(0.0, 40.0 * s, 25),
                   yb=np.linspace(30.0 * s, 80.0 * s, 25),
                   projection=PlateCarree(scale=s))
cpu = torch.device("cpu")
gr = port.GCMRegridder(specA, [0.0, 1000.0, 3000.0], device=cpu)
gr.add_sheet("toy", specI, subdiv=1)
cp = port.GCMCoupler(gr, port.CouplerConfig(regen_every=1), device=cpu)
f = np.zeros((8, gr.nE), np.float32)
f[0] = 1e-5
f[4] = -10.0
for _ in range(2):
    cp.couple({"toy": torch.as_tensor(f)})
rows = cp.ledger.to_rows()
m = [abs(r["toy.mass_in_E"] - r["toy.mass_delivered_I"])
     / abs(r["toy.mass_in_E"]) for r in rows]
# the generic-polygon build (convex clip) and the overlap CLI
import contextlib, io, os, tempfile
from icebin_tpu_torch.cli.overlap import main as overlap
from icebin_tpu_torch.grid import GridSpecGeneric, make_exchange_grid
from icebin_tpu_torch.io import read_exchange, write_grid
hexes = GridSpecGeneric(polygons=[[[10.0 + 4 * np.cos(a), 50.0 + 4 * np.sin(a)]
                                   for a in np.radians(np.arange(6) * 60.0)]],
                        projection=PlateCarree(scale=s))
xg = make_exchange_grid(specA, hexes, device=cpu)
assert abs(xg.area_sums_I()[0] / hexes.plane_areas()[0] - 1) < 1e-12
with tempfile.TemporaryDirectory() as d:
    a, i, x = (os.path.join(d, f) for f in ("a.nc", "i.nc", "x.nc"))
    write_grid(a, specA)
    write_grid(i, specI)
    with contextlib.redirect_stdout(io.StringIO()):
        assert overlap([a, i, x, "--device", "cpu"]) == 0
    assert read_exchange(x).ncells > 0
    # the run CLI: stepwise with checkpoints, then resumed, fused
    from icebin_tpu_torch.cli.run import main as run
    from icebin_tpu_torch.utils.config import RunConfig, SheetConfig
    cfg = os.path.join(d, "run.json")
    RunConfig(gridA_file=a, hcdefs=[0.0, 1000.0], n_steps=2,
              sheets=[SheetConfig(name="toy", grid_file=i, exchange_file=x)],
              regen_every=1, checkpoint_every=1,
              dump_dir=os.path.join(d, "dumps")).to_json(cfg)
    os.chdir(d)
    with contextlib.redirect_stdout(io.StringIO()):
        assert run([cfg, "--device", "cpu"]) == 0
        assert run([cfg, "--device", "cpu", "--fused",
                    "--resume", "checkpoint_000001.npz"]) == 0
    assert len(os.listdir(os.path.join(d, "dumps"))) == 2
    # the ModelE boundary: the adapter's couple_native, then a shim round
    # trip with the buffers as the C ABI passes them
    from icebin_tpu_torch.models import gcmce_shim
    from icebin_tpu_torch.models.modele_adapter import (ModelEAdapter,
                                                        to_modele_E)
    fm = to_modele_E(f.astype(np.float64), gr.nA, gr.nhc)
    ad = ModelEAdapter(gr, port.CouplerConfig(regen_every=1), device=cpu)
    ad.add_rank_output(np.arange(gr.nE), fm)
    assert ad.couple_native(0.0)["toy"]["fE_out_modele"].shape == (10, gr.nE)
    assert ad.topo()[0].shape == (gr.nhc, 6, 6)
    cfg = os.path.join(d, "modele.json")
    RunConfig(gridA_file=a, hcdefs=[0.0, 1000.0, 3000.0],
              sheets=[SheetConfig(name="toy", grid_file=i)]).to_json(cfg)
    h = gcmce_shim.gcmce_new(cfg, device="cpu")
    idx = np.arange(gr.nE, dtype=np.int64)
    gcmce_shim.gcmce_add_gcm_outpute(h, memoryview(idx),
                                     memoryview(np.ascontiguousarray(fm)),
                                     gr.nE, 8)
    bufs = (np.zeros(gr.nE), np.zeros(gr.nE), np.zeros(gr.nE, np.int32))
    assert gcmce_shim.gcmce_couple_native(h, 0.0,
                                          *map(memoryview, bufs)) == 0
    assert bufs[0].sum() > 0
    gcmce_shim.gcmce_delete(h)
    os.chdir(os.path.dirname(d))
print(len(rows), max(m), "jax" in sys.modules,
      sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "icebin_tpu")))
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_port_imports_no_jax():
    """A toy coupler, a generic-polygon exchange build, the overlap CLI, the
    run CLI, the ModelE adapter and the gcmce shim run in an interpreter
    that never imports JAX nor the reference package."""
    out = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    n, worst, has_jax, mods = out.stdout.split(maxsplit=3)
    assert n == "2"
    assert float(worst) < 1e-10
    assert has_jax == "False", mods
    assert mods.strip() == "[]", mods


def _imports(path):
    """Every module a Python file imports (absolute names; a relative
    import counts as the port's own)."""
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def test_port_source_imports_nothing_of_the_reference():
    """No file of icebin_tpu_torch imports icebin_tpu or JAX, at any level
    of the file (top, function, conditional)."""
    files = sorted((ROOT / "icebin_tpu_torch").rglob("*.py"))
    assert len(files) > 30
    names = {str(f.relative_to(ROOT / "icebin_tpu_torch")) for f in files}
    assert {"coupler/multivec.py", "topo/topo.py", "models/modele_adapter.py",
            "models/gcmce_shim.py", "ops/_build_gcmce.py", "ops/floor.py",
            "ops/prods.py", "ops/k2probe.py", "ops/k1probe.py",
            "ops/_probe.py", "tools/__init__.py", "tools/common.py", "tools/probe_k2.py",
            "tools/probe_k1.py", "ops/foldprobe.py", "ops/smemprobe.py",
            "tools/probe_fold_ops.py", "tools/probe_vmem.py",
            "tools/sweep_clip.py", "parallel/mesh.py",
            "parallel/distributed.py", "parallel/halo.py",
            "parallel/sharded_apply.py", "parallel/build.py",
            "parallel/coupled.py", "parallel/dryrun.py",
            "coupler/sharded.py"} <= names
    bad = {str(f.relative_to(ROOT)): sorted(m for m in _imports(f)
                                            if m.split(".")[0] in
                                            ("icebin_tpu", "jax", "jaxlib"))
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


PROBE_RUN = """
import contextlib, io, json, sys
from icebin_tpu_torch.tools.{probe} import main
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert main({args}) == 0
lines = [json.loads(s) for s in buf.getvalue().splitlines()]
print(len(lines), sorted(k for k in sys.modules
                         if k.split(".")[0] in ("jax", "icebin_tpu")))
"""


def _probe_run(probe, args=("--config", "synth", "--device", "cpu", "--nv",
                             "16")):
    """(JSON lines, modules of JAX or the reference loaded) of ``probe``'s
    entry point on the CPU with ``args`` in a fresh interpreter."""
    code = PROBE_RUN.replace("{probe}", probe).replace("{args}",
                                                       repr(list(args)))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    n, mods = out.stdout.split(maxsplit=1)
    return int(n), mods.strip()


def test_probe_k2_imports_no_jax():
    """The dest-small probe's entry point on the CPU, in an interpreter that
    never imports JAX nor the reference package."""
    n, mods = _probe_run("probe_k2")
    assert n == 17
    assert mods == "[]", mods


def test_probe_k1_imports_no_jax():
    """The dest-ice probe's entry point (ops/k1probe.py, tools/probe_k1.py)
    on the CPU, in an interpreter that never imports JAX nor the reference
    package."""
    n, mods = _probe_run("probe_k1")
    assert n == 21
    assert mods == "[]", mods


def test_sweep_spmm_imports_no_jax():
    """The regrid kernels' geometry sweep (tools/sweep_spmm.py) on the CPU,
    in an interpreter that never imports JAX nor the reference package."""
    n, mods = _probe_run("sweep_spmm")
    assert n == 43
    assert mods == "[]", mods


def test_sweep_clip_imports_no_jax():
    """The clip kernels' geometry sweep (tools/sweep_clip.py) on the CPU:
    12 geometries, the rule, stage 1 and the divergence count for each kind
    of clip, in an interpreter that never imports JAX nor the reference
    package."""
    n, mods = _probe_run("sweep_clip", ("--config", "synth", "--device",
                                        "cpu"))
    assert n == 2 * (12 + 1 + 1 + 1)
    assert mods == "[]", mods


def test_probe_fold_ops_imports_no_jax():
    """The fold probe's entry point (ops/foldprobe.py,
    tools/probe_fold_ops.py) on the CPU: one line per fold, route, type and
    B, then the three semantic checks, in an interpreter that never imports
    JAX nor the reference package."""
    n, mods = _probe_run("probe_fold_ops",
                         ("--device", "cpu", "--blocks", "1", "64"))
    assert n == 2 * 2 * 4 * 2 + 3
    assert mods == "[]", mods


def test_probe_vmem_imports_no_jax():
    """The capacity probe's entry point (ops/smemprobe.py,
    tools/probe_vmem.py) on the CPU: the plain version at n = 224, in an
    interpreter that never imports JAX nor the reference package."""
    n, mods = _probe_run("probe_vmem", ("--device", "cpu"))
    assert n == 1
    assert mods == "[]", mods


def mesh_rank(mesh):
    """Two steps of a toy coupler decomposed over ``mesh`` (a rank of
    ``launch``); returns the worst transport identity and the modules of
    JAX or the reference loaded in the rank."""
    import numpy as np
    import torch
    import icebin_tpu_torch as port
    from icebin_tpu_torch.grid import GridSpecLonLat, GridSpecXY, PlateCarree
    s = 25e3
    specA = GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                           latb=np.linspace(30.0, 80.0, 7))
    specI = GridSpecXY(xb=np.linspace(0.0, 40.0 * s, 25),
                       yb=np.linspace(30.0 * s, 80.0 * s, 25),
                       projection=PlateCarree(scale=s))
    gr = port.GCMRegridder(specA, [0.0, 1000.0, 3000.0], device=mesh.device)
    gr.add_sheet("toy", specI, subdiv=1)
    cp = port.GCMCoupler(gr, port.CouplerConfig(regen_every=1), mesh=mesh)
    f = np.zeros((8, gr.nE), np.float32)
    f[0] = 1e-5
    f[4] = -10.0
    for _ in range(2):
        cp.couple({"toy": torch.as_tensor(f)})
    worst = max(abs(r["toy.mass_in_E"] - r["toy.mass_delivered_I"])
                / abs(r["toy.mass_in_E"]) for r in cp.ledger.to_rows())
    return worst, sorted(k for k in sys.modules
                         if k.split(".")[0] in ("jax", "icebin_tpu"))


def test_mesh_ranks_import_no_jax():
    """A 2-rank gloo mesh coupler (icebin_tpu_torch.parallel,
    coupler/sharded.py) runs in rank processes that never import JAX nor
    the reference package."""
    from icebin_tpu_torch.parallel.distributed import launch
    for worst, mods in launch(mesh_rank, 2, backend="gloo", device="cpu",
                              timeout=240.0, nice=10):
        assert worst < 1e-10
        assert mods == [], mods


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the system only through icebin_tpu_torch: it
    imports neither JAX nor the reference package."""
    mods = _imports(ROOT / "chip_smoke.py")
    tops = {m.split(".")[0] for m in mods}
    assert "icebin_tpu_torch" in tops
    assert not tops & {"icebin_tpu", "jax", "jaxlib"}, sorted(mods)


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """No CUDA device here: chip_smoke.py exits non-zero and prints no
    result; so it does alone in a directory without the package."""
    import torch
    if torch.cuda.is_available():
        return                  # the card is there: nothing to refuse
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        env = _env()
        if cwd != ROOT:
            del env["PYTHONPATH"]
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        for line in out.stdout.splitlines():
            try:
                assert "ok" not in json.loads(line)
            except ValueError:
                pass
