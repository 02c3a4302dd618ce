"""``correct`` on the CPU at toy lattices (the chip's look skipped, the
kernels' plain versions run): the timed path broken underneath, in each
way a cell can be broken, comes out not correct; so does the control in
the program's place.  A one-card cell exchanges nothing between chips, so
that fault has no test here."""
import dataclasses
import json
import math

import pytest
import torch

import control
import run as bench

RES_KM = 150.0
SEED = 2 ** 31 + 4242


# kept for a later cell: its driver, traffic and limits are under
# bench_torch/, BENCHMARK.json does not list it (PERF.md, Open questions)
ABI = {"name": "greenland.abi_monthly", "config": "greenland5km_modele2x2.5",
       "traffic": "abi_monthly", "chips": 1}
CELLS = (ABI["name"], "two_sheets.fused_yearly",
         "greenland.fused_oneway", "two_sheets.fused_oneway")


@pytest.fixture(autouse=True)
def kept_cell(monkeypatch):
    """The ABI cell, looked up as BENCHMARK.json would list it."""
    inner = bench.load_cell

    def load(name):
        if name != ABI["name"]:
            return inner(name)
        _, cfg, _, _, b = inner("greenland.fused_oneway")
        files = [bench.HERE / "traffic" / f"{ABI['traffic']}.json",
                 bench.HERE / "limits" / f"{ABI['name']}.json"]
        return (ABI, cfg, *(json.loads(f.read_text()) for f in files), b)
    monkeypatch.setattr(bench, "load_cell", load)


@pytest.fixture(autouse=True)
def cpu_abi(monkeypatch):
    """The C ABI's gcmce_new on the CPU (it asks for the card)."""
    from icebin_tpu_torch.models import gcmce_shim
    monkeypatch.setattr(gcmce_shim.gcmce_new, "__defaults__", ("cpu",))


def measure(cell):
    result, _, _ = bench.measure(cell, SEED, 0.5, False, torch.device("cpu"),
                                 res_km=RES_KM)
    return result


def over(result):
    return {k for k, v in result["compared"].items()
            if not (math.isfinite(v["value"]) and v["value"] <= v["limit"])}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = measure(cell)
    assert r["correct"] is True, r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged_is_not_correct(cell, monkeypatch):
    from icebin_tpu_torch.coupler import coupler as cmod
    from icebin_tpu_torch.models.ice_sheet import IceFluxes

    def advance(cfg, state, smb, tsurf, dt, enth_flux=None, **kw):
        z = torch.zeros_like(state.H)
        s = torch.zeros((), dtype=state.H.dtype, device=z.device)
        fx = IceFluxes(z, z, z, s, z, z, z, s, z)
        st = cmod.IceSheetState(H=state.H.clone(), bed=state.bed,
                                t=state.t + dt, enth=state.enth.clone())
        return (st, fx, torch.zeros((), dtype=torch.bool, device=z.device),
                torch.ones((), dtype=torch.int32, device=z.device))
    monkeypatch.setattr(cmod, "advance", advance)
    r = measure(cell)
    assert r["correct"] is False
    assert {"state", "ledger"} & over(r)


@pytest.mark.parametrize("cell", CELLS)
def test_state_reset_at_a_period_boundary_is_not_correct(cell, monkeypatch):
    """Every sheet's ice state put back to where it started once the first
    period (the warm-up) has run: the period after it runs soundly from
    the stale state, so only the carried comparison can see it."""
    from icebin_tpu_torch.coupler import coupler as cmod

    def stale(name):
        inner = getattr(cmod.GCMCoupler, name)

        def wrapped(self, *a, **kw):
            if not hasattr(self, "_first"):
                self._first = {n: dataclasses.replace(
                    sc.state, H=sc.state.H.clone(),
                    enth=sc.state.enth.clone())
                    for n, sc in self.sheets.items()}
                self._n = 0
            out = inner(self, *a, **kw)
            self._n += a[1] if name == "run_transient" else 1
            if self._n == 12:
                for n, sc in self.sheets.items():
                    sc.state = self._first[n]
            return out
        monkeypatch.setattr(cmod.GCMCoupler, name, wrapped)
    stale("couple")
    stale("run_transient")
    r = measure(cell)
    assert r["correct"] is False
    assert "state" in over(r)


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_is_not_correct(cell, monkeypatch):
    """The books' weighted sums over every other cell, doubled."""
    from icebin_tpu_torch.coupler import coupler as cmod
    whole = cmod.weighted_mass
    monkeypatch.setattr(cmod, "weighted_mass",
                        lambda f, w: 2.0 * whole(f[..., ::2], w[::2]))
    r = measure(cell)
    assert r["correct"] is False
    assert {"ledger", "forcing", "harvest"} & over(r)


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_is_not_correct(cell, monkeypatch):
    """One E cell's runoff doubled where the harvest is produced."""
    from icebin_tpu_torch.coupler import coupler as cmod
    inner = cmod.IceSheetCoupler._apply_mat

    def apply_mat(self, bm, f, *a, **kw):
        out = inner(self, bm, f, *a, **kw)
        if out.dim() == 2 and out.shape[0] == 10 and \
                out.shape[1] == self.gr.nE:
            out = out.clone()
            # no read to the host: the card captures this into a graph
            j = torch.argmax(bm.wM).reshape(1)
            out[3].index_put_((j,), out[3].index_select(0, j) * 2.0)
        return out
    monkeypatch.setattr(cmod.IceSheetCoupler, "_apply_mat", apply_mat)
    r = measure(cell)
    assert r["correct"] is False
    assert "harvest" in over(r)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    vals, limits = control.readings(cell, SEED, torch.device("cpu"), RES_KM)
    bad = {k for k, v in vals.items() if not v <= limits[k]}
    assert bad, vals
