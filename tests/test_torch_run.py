"""The port's standalone run (icebin_tpu_torch.cli.run, RunConfig, the
writer, checkpoints, DISMAL) against the reference's (icebin_tpu.cli.run)
on one run.json at the toy size of tests/test_cli.py.

Tolerances, with their reasons:
* ice mass: 1e-6 relative.  Each CLI builds its exchange grid itself, the
  port through its f32 clip and the reference through its f64 host clip;
  after the f64 repair the books close alike, and the difference left is
  the f32 noise of the overlaps spread over the dome's mass.
* per-step transport conservation: < 1e-10, the north-star bound.
* a resumed run: bit for bit the run that was not interrupted.
* a reference checkpoint continued by the port: ``FIELD_TOL`` (1e-5 of the
  field's scale), as tests/test_torch_coupler.py holds the two couplers.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icebin_tpu.cli.run import main as ref_run
from icebin_tpu.coupler import checkpoint as ref_ck
from icebin_tpu.coupler import coupler as ref_coupler
from icebin_tpu.grid import proj as ref_proj, spec as ref_spec
from icebin_tpu.io.ncio import write_grid
from icebin_tpu.regrid.gcmregridder import GCMRegridder as RefRegridder
from icebin_tpu.utils.config import RunConfig as RefRunConfig

import icebin_tpu_torch as port
from icebin_tpu_torch.cli.run import main as port_run
from icebin_tpu_torch.coupler import checkpoint as port_ck
from icebin_tpu_torch.coupler.writer import CouplerWriter
from icebin_tpu_torch.grid import proj as port_proj, spec as port_spec
from icebin_tpu_torch.models.dismal import DismalModel
from icebin_tpu_torch.models.ice_sheet import (IceSheetConfig,
                                               default_enthalpy, init_state)
from icebin_tpu_torch.utils.config import RunConfig, SheetConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
FIELD_TOL = 1e-5
SCALE = 25e3
HCDEFS = [0.0, 500.0, 1000.0, 2000.0, 3000.0]
MODES = {"stepwise": [], "fused": ["--fused"], "dismal": ["--ice", "dismal"]}


def toy_specs(spec, proj, n_ice=32):
    """tests/test_cli.py's run toy in one package's classes."""
    specA = spec.GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                                latb=np.linspace(30.0, 80.0, 7))
    specI = spec.GridSpecXY(
        xb=np.linspace(0.0, 40.0 * SCALE, n_ice + 1),
        yb=np.linspace(30.0 * SCALE, 80.0 * SCALE, n_ice + 1),
        projection=proj.PlateCarree(scale=SCALE))
    return specA, specI


def write_config(d, **kw):
    """Grid files and a run.json in ``d`` (the reference writes the grid
    files; the port reads them)."""
    specA, specI = toy_specs(ref_spec, ref_proj)
    pa, pi = str(d / "a.nc"), str(d / "i.nc")
    write_grid(pa, specA)
    write_grid(pi, specI)
    cfg = dict(gridA_file=pa, hcdefs=[0.0, 800.0, 2500.0],
               sheets=[SheetConfig(name="s", grid_file=pi, subdiv=1)],
               n_steps=4, regen_every=2, checkpoint_every=2,
               dump_dir=str(d / "dumps"))
    cfg.update(kw)
    path = str(d / "run.json")
    RunConfig(**cfg).to_json(path)
    return path


def run_cli(main, cfg, flags, capsys, monkeypatch, d):
    monkeypatch.chdir(d)
    assert main([cfg, *flags]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    mass = float(line.split("ice mass ")[1].split(" kg")[0])
    worst = float(line.rsplit(" ", 1)[-1])
    files = sorted(os.listdir(d)) + sorted(os.listdir(d / "dumps"))
    return mass, worst, files


@pytest.mark.parametrize("mode", MODES)
def test_run_cli_matches_reference(tmp_path, capsys, monkeypatch, mode):
    """The same run.json through both CLIs: the same checkpoint and dump
    files (stepwise and DISMAL dump every step, a fused run each window's
    last step, as the reference falls back to stepwise for DISMAL), ice
    mass within 1e-6, conservation < 1e-10 on both."""
    out = {}
    for name, main, flags in (("ref", ref_run, MODES[mode]),
                              ("port", port_run,
                               MODES[mode] + ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        cfg = write_config(d)
        out[name] = run_cli(main, cfg, flags, capsys, monkeypatch, d)
    (m_r, w_r, f_r), (m_p, w_p, f_p) = out["ref"], out["port"]
    assert f_p == f_r
    n_dumps = 2 if mode == "fused" else 4
    assert sum(f.startswith("step_") for f in f_p) == n_dumps
    assert {"checkpoint_000002.npz", "checkpoint_000004.npz"} <= set(f_p)
    assert abs(m_p - m_r) <= 1e-6 * abs(m_r)
    assert w_p < 1e-10 and w_r < 1e-10


def test_dumps_hold_the_reference_fields(tmp_path, capsys, monkeypatch):
    """A port dump has the reference dump's variables, shapes and attributes,
    its fields to FIELD_TOL of each field's scale and its ledger values to
    1e-6 of the row or, for the residual and clamp rows (differences of f32
    state sums), of their book's store."""
    dumps = {}
    for name, main, flags in (("ref", ref_run, []),
                              ("port", port_run, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        run_cli(main, write_config(d, n_steps=1), flags, capsys,
                monkeypatch, d)
        dumps[name] = CouplerWriter.read(str(d / "dumps/step_000000.nc"))
    r, p = dumps["ref"], dumps["port"]
    assert sorted(p) == sorted(r)
    assert p["_attrs"] == r["_attrs"]
    for k in r:
        if k == "_attrs":
            continue
        assert p[k].shape == r[k].shape, k
        np.testing.assert_array_equal(np.isnan(p[k]), np.isnan(r[k]))
        ok = np.isfinite(r[k])
        scale = max(np.abs(r[k][ok]).max(initial=0.0), 1e-300)
        tol = FIELD_TOL
        if k.startswith("ledger_"):
            store = ("ledger_s_ice_mass" if "mass" in k
                     else "ledger_s_energy_storage_I")
            scale, tol = max(scale, abs(r[store][0])), 1e-6
        assert np.abs(p[k][ok] - r[k][ok]).max(initial=0.0) <= tol * scale, k


def test_run_config_round_trip(tmp_path):
    """RunConfig keeps the reference's JSON keys: the port's round trip is
    exact, and a JSON written by either package loads in the other."""
    cfg = RunConfig(gridA_file="a.nc", hcdefs=[0.0, 1000.0],
                    sheets=[SheetConfig(name="s", grid_file="i.nc",
                                        exchange_file="x.nc", subdiv=1,
                                        engine="numpy")],
                    sigma=(5e4, 5e4), n_steps=7, checkpoint_every=3,
                    dump_dir="d", mesh_shape=[4])
    assert RunConfig.from_json(cfg.to_json()) == cfg
    path = str(tmp_path / "run.json")
    cfg.to_json(path)
    ref = RefRunConfig.from_json(path)
    assert dataclasses.asdict(ref) == dataclasses.asdict(cfg)
    assert RunConfig.from_json(ref.to_json()) == cfg
    assert json.loads(ref.to_json()) == json.loads(cfg.to_json())
    p = cfg.regrid_params()
    assert (p.scale, p.correctA, p.sigma) == (True, True, (5e4, 5e4))


def make_port(**kw):
    specA, specI = toy_specs(port_spec, port_proj, n_ice=40)
    gr = port.GCMRegridder(specA, hcdefs=HCDEFS, device=CPU)
    gr.add_sheet("toy", specI, subdiv=1)
    return port.GCMCoupler(
        gr, port.CouplerConfig(dt=86400.0 * 30, regen_every=2, **kw),
        device=CPU)


def make_ref():
    specA, specI = toy_specs(ref_spec, ref_proj, n_ice=40)
    gr = RefRegridder(specA, hcdefs=HCDEFS)
    gr.add_sheet("toy", specI, subdiv=1, engine="numpy")
    return ref_coupler.GCMCoupler(gr, ref_coupler.CouplerConfig(
        dt=86400.0 * 30, regen_every=2))


def forcing_np(t, nE):
    """Forcing fixed by the model time (tests/test_coupler.py's), f32."""
    rng = np.random.default_rng(int(t) % 100003)
    f = np.zeros((8, nE))
    f[0] = 1e-5 * rng.uniform(0.5, 1.0, nE)
    f[1] = 5.0
    f[4] = -10.0
    f[6] = 2e-6 * rng.uniform(0.0, 1.0, nE)
    return f.astype(np.float32)


def port_forcing(cp):
    return lambda t, sheet: torch.as_tensor(forcing_np(t, cp.gr.nE))


@pytest.mark.parametrize("fused", [False, True])
def test_resume_is_bit_identical(tmp_path, fused):
    """3 steps, a checkpoint (the regeneration at step 2 inside), 3 more;
    the checkpoint loaded into a fresh coupler runs the same 3 steps to the
    same state and ledger bit for bit."""
    a = make_port()
    fa = port_forcing(a)
    a.run_transient(fa, 3, fused=fused)
    ck = str(tmp_path / "ck.npz")
    port_ck.save_checkpoint(ck, a)
    a.run_transient(fa, 3, fused=fused)
    b = make_port()
    port_ck.load_checkpoint(ck, b)
    assert b.time == 3 * 86400.0 * 30
    assert b.sheets["toy"].steps_since_regen == 1
    b.run_transient(port_forcing(b), 3, fused=fused)
    sa, sb = a.sheets["toy"].state, b.sheets["toy"].state
    for k in ("H", "bed", "t", "enth"):
        assert torch.equal(getattr(sa, k), getattr(sb, k)), k
    assert sb.t.dtype == torch.float64
    assert a.ledger.to_rows() == b.ledger.to_rows()


def test_checkpoint_flushes_the_deferred_ledger(tmp_path):
    """save_checkpoint reads the ledger through to_rows(), so rows a
    deferred ledger still holds on the device are in the file."""
    a = make_port(defer_ledger=True)
    a.run_transient(port_forcing(a), 2)
    assert a.ledger._pending
    ck = str(tmp_path / "ck.npz")
    port_ck.save_checkpoint(ck, a)
    rows = json.loads(bytes(np.load(ck)["ledger"].tobytes()).decode())
    assert len(rows) == 2 and "toy.mass_in_E" in rows[-1]


def close(got, want, what):
    got, want = np.ravel(got).astype(np.float64), np.ravel(want)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= FIELD_TOL * scale, what


def test_reference_checkpoint_continues_in_the_port(tmp_path):
    """A checkpoint the reference wrote loads into the port (state on the
    port's device, f64 time, matrices rebuilt from the saved elevmask) and
    continues as the reference does, within FIELD_TOL; one without the
    energy column starts from the cold column at the sheet's t_init; the
    port's own checkpoint loads into the reference."""
    r = make_ref()
    nE = r.gr.nE
    rf = lambda t, s: jnp.asarray(forcing_np(t, nE))       # noqa: E731
    r.run_transient(rf, 3)
    ck = str(tmp_path / "ref.npz")
    ref_ck.save_checkpoint(ck, r)
    p = make_port()
    port_ck.load_checkpoint(ck, p)
    sp = p.sheets["toy"]
    assert sp.state.t.dtype == torch.float64
    np.testing.assert_array_equal(sp.regen_elevmask,
                                  r.sheets["toy"].regen_elevmask)
    r.run_transient(rf, 3)
    p.run_transient(port_forcing(p), 3)
    for k in ("H", "enth"):
        close(getattr(sp.state, k).numpy(),
              np.asarray(getattr(r.sheets["toy"].state, k)), k)
    assert float(sp.state.t) == float(r.sheets["toy"].state.t)
    for a, b in zip(p.ledger.to_rows(), r.ledger.to_rows()):
        assert a["t"] == b["t"]
        assert abs(a["toy.ice_mass"] - b["toy.ice_mass"]) <= (
            1e-6 * abs(b["toy.ice_mass"]))

    z = dict(np.load(ck))
    del z["toy.enth"]
    old = str(tmp_path / "old.npz")
    np.savez(old, **z)
    q = make_port()
    port_ck.load_checkpoint(old, q)
    sq = q.sheets["toy"].state
    cold = default_enthalpy(sq.H, q.sheets["toy"].ice_cfg.t_init)
    assert torch.equal(sq.enth, cold)

    mine = str(tmp_path / "port.npz")
    port_ck.save_checkpoint(mine, p)
    r2 = make_ref()
    ref_ck.load_checkpoint(mine, r2)
    np.testing.assert_array_equal(np.asarray(r2.sheets["toy"].state.H),
                                  sp.state.H.numpy())
    assert r2.ledger.to_rows() == p.ledger.to_rows()


def test_dismal_dumps_from_device_tensors(tmp_path):
    """DISMAL keeps the state, returns zero fluxes on the state's device
    and dumps the forcing it received to the host."""
    cfg = IceSheetConfig(nx=5, ny=4, dx=1e3, dy=1e3)
    st = init_state(cfg, device=CPU)
    m = DismalModel(out_dir=str(tmp_path))
    smb = torch.arange(20, dtype=torch.float64)
    new, fx = m.step(cfg, st, smb, None, 10.0, enth_flux=2 * smb)
    assert new.H is st.H and float(new.t) == 10.0
    assert all(float(f.abs().sum()) == 0.0 for f in fx)
    z = np.load(tmp_path / "dismal_000000.npz")
    np.testing.assert_array_equal(z["smb_flux"], smb.numpy().reshape(4, 5))
    np.testing.assert_array_equal(z["tsurf"], np.zeros((4, 5)))
    np.testing.assert_array_equal(z["enth_flux"], 2 * z["smb_flux"])


def test_run_cli_refuses_mesh_and_a_missing_gpu(tmp_path, capsys,
                                                monkeypatch):
    """--mesh is refused where it cannot run as asked (no fallback to one
    device or another backend): with NCCL on the CPU; and the default
    --device cuda needs a card.  (``--mesh`` with DISMAL runs:
    tests/test_torch_mesh_coupler.py holds it to the reference's run.)"""
    cfg = write_config(tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        port_run([cfg, "--mesh", "4", "--device", "cpu", "--backend",
                  "nccl"])
    assert e.value.code == 2
    assert "nccl runs on CUDA" in capsys.readouterr().err
    assert not (tmp_path / "checkpoint_000002.npz").exists()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            port_run([cfg])
        assert e.value.code == 2
