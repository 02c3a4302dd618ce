"""The port runs without JAX; chip_smoke.py imports only the port and refuses
to run without a GPU.

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
print(len(rows), max(m), "jax" in sys.modules,
      sorted(k for k in sys.modules if k.split(".")[0] == "jax"))
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    n, worst, has_jax, mods = out.stdout.split(maxsplit=3)
    assert n == "2"
    assert float(worst) < 1e-10
    assert has_jax == "False", mods


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the system only through icebin_tpu_torch: it
    imports neither JAX nor the reference package."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
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
