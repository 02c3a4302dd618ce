"""The configuration ``greenland5km_modele2x2.5_ocean1x1.25`` (GCM grid kind
``modele_ocean``: ModelE's 2 x 2.5 atmosphere over its 1 x 1.25 ocean
grid, through the program's ``GCMRegridderModelE``) and its twin cell
over A alone, at toy lattices on the CPU: both cells' runs are correct,
the mismatch left out (sAm forced to 1) is not, the kind's reference half
is plain, and the kind came in as new files: the harness is the one the
kinds were added with."""
import ast
import hashlib
import math

import numpy as np
import pytest
import torch

import run as bench
from harness import gcm

RES_KM = 150.0
SEED = 2 ** 31 + 7171
OCEAN = "greenland_ocean.fused_yearly"
TWIN = "greenland.fused_yearly"
BENCH = bench.HERE

# the harness, run.py and control.py as the GCM grid kinds left them
HARNESS = {
    "harness/__init__.py":
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "harness/check.py":
        "543431f322873249eb7b19fd9246b4eadb6bf390cef3cb9b1b80babfd5d7fd0d",
    "harness/common.py":
        "3b236e7d21e5ad57af2e77518ccac41315c481f74d95f71e4be66cd31e60ed70",
    "harness/drivers.py":
        "82d45e2ca0bf6769cd10989dd3e1b153028e6570f5b8975dad31746f29625f86",
    "harness/gcm.py":
        "a19df319c83c209633376b0d1964aa593b882d96386edc2c5b1baf97dfc9c38a",
    "harness/system.py":
        "8c0e77d48e5ca1853217264e9c639276d03ad8497027a0e1ea6144f669a35eff",
    "run.py":
        "8af14668e0fac95c9c596906c46a1d3a7b901a2edbdb08dd975d313c48429c3f",
    "control.py":
        "035d6972dd56e5157656ae276ce0121bb11e1ba0fc521299a96c868388b73396",
}


def measure(cell):
    result, _, _ = bench.measure(cell, SEED, 0.5, False, torch.device("cpu"),
                                 res_km=RES_KM)
    return result


def over(result):
    return {k for k, v in result["compared"].items()
            if not (math.isfinite(v["value"]) and v["value"] <= v["limit"])}


@pytest.mark.parametrize("cell", [OCEAN, TWIN])
def test_both_cells_are_correct(cell):
    r = measure(cell)
    assert r["correct"] is True, r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {"held", "topo"} <= set(r["compared"])


def test_the_ocean_grid_changes_what_is_compared():
    """The kind's data: an ocean fraction from the initial ice with some
    iced O cells ModelE rounds to ocean, A cells the mismatch rescales and
    zeroes; and the reference's A-level exchange grid is not the twin's."""
    from harness import check
    from reference.prec import REFERENCE
    cfg = bench.load_cell(OCEAN)[1]
    grid = gcm.load(cfg, "fused", SEED)
    op, om = grid.data["oceans"](RES_KM)
    assert op.shape == (288 * 180,) and np.array_equal(om, np.round(op))
    assert np.any((op > 0.5) & (op < 1.0)) and np.any(op < 0.5)
    gr = grid.regridder(torch.device("cpu"), RES_KM)
    assert gr.rescaled > 0 and gr.zeroed > 0
    (sh,) = check.reference_sheets(cfg, grid, torch.device("cpu"), REFERENCE,
                                   RES_KM)
    twin = bench.load_cell(TWIN)[1]
    (tw,) = check.reference_sheets(twin, gcm.load(twin, "fused", SEED),
                                   torch.device("cpu"), REFERENCE, RES_KM)
    assert sh.xg.nA == tw.xg.nA == 144 * 90
    assert sh.xg.iA.numel() > tw.xg.iA.numel()
    assert float((sh.xg.area == 0).sum()) > 0       # zeroed A cells


def test_the_mismatch_left_out_is_not_correct(monkeypatch):
    """The program's sAm forced to 1 (ModelE's rounded land measure
    ignored; the cells still moved to A): not correct."""
    from icebin_tpu_torch.regrid import modele
    init = modele.GCMRegridderModelE.__init__

    def unscaled(self, *a, **kw):
        init(self, *a, **kw)
        self.sAm = np.ones_like(self.sAm)
    monkeypatch.setattr(modele.GCMRegridderModelE, "__init__", unscaled)
    r = measure(OCEAN)
    assert r["correct"] is False
    assert over(r) & {"ledger", "forcing", "harvest"}, r["compared"]


def test_the_reference_half_is_plain():
    """It imports numpy, torch and the reference alone."""
    src = (BENCH / "reference" / "gcm" / "modele_ocean.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "math", "typing", "numpy", "torch",
                     "reference"}, names


def test_the_harness_is_the_one_the_kinds_came_with():
    got = {f: hashlib.sha256((BENCH / f).read_bytes()).hexdigest()
           for f in HARNESS}
    assert got == HARNESS
