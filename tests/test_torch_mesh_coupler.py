"""The port's production coupler decomposed over torch.distributed ranks
(GCMCoupler(..., mesh=...), icebin_tpu_torch.coupler.sharded) vs the JAX
package's mesh coupler on the suite's 8 virtual CPU devices and vs the
port's single-device coupler, on tests/test_mesh_coupler.py's toy
(make_gr) and forcing.

The port's ranks run as gloo processes on CPU tensors: one spawn per world
size (1, 2, 3, 5 and 8), shared by the whole test run
(tests/test_torch_parallel.py:shared_spawn), runs every case of that size
and returns the results.  Every spawn has its own timeout.

Tolerances, with their reasons:
* H and fE_out against the JAX mesh coupler and the port's single-device
  coupler: the JAX package's own mesh tolerances
  (tests/test_mesh_coupler.py:111-116), rtol 2e-5 / atol 2e-4 on H and
  rtol 5e-4 / atol 5e-3 on fE_out;
* ragged meshes (33 rows over 3 and 5 ranks) against the single-device
  run: tests/test_ragged_mesh.py:121's book tolerances (ice_mass 1e-9,
  mass_delivered_I 1e-6, mass_in_E 1e-7);
* the ledger: transport identity < 1e-10 and store closure < 1e-12 every
  step, as tests/test_mesh_coupler.py:check_ledger_closure;
* one rank against the single-device coupler, fused windows, a resumed
  run and a second run at one world size: bit for bit (every sum over
  ranks is added in rank order, and a fused window runs the stepwise
  step's operations);
* two sheets on one mesh (tests/test_mesh_coupler.py:117), the retreat
  and the f64 energy closure (tests/test_mass_loss.py:304, :329): each
  rank's ledger closes as the reference's tests ask, and the books agree
  with the port's single-device run within those tests' tolerances
  (ice_mass 1e-7, mass_returned_I and the energy books 1e-6); sigma IvE
  (tests/test_mesh_coupler.py:225): rtol 2e-5 from the canonical matrix;
* ``run --mesh 2 --ice dismal``: the reference's printed ice mass, to the
  digit, and its transport bound (< 1e-10; the figure itself is f64
  round-off, which the two packages sum in other orders); DISMAL's dumps
  on a mesh are the single-device run's files, their forcings within
  FIELD_TOL (1e-5) of each field's scale (the f64 repair's totals are
  added in rank order).
"""
import os

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import shared_spawn

torch.set_num_threads(1)
CPU = torch.device("cpu")
DT = 86400.0 * 30
HCDEFS = [0.0, 500.0, 1000.0, 2000.0, 3000.0]


# -- the port's side: rank programs ------------------------------------------

def port_gr(n_ice=32, scale=25e3, ny=None):
    """tests/test_mesh_coupler.py:21's make_gr (or, with ``ny``,
    tests/test_ragged_mesh.py's ny-row lattice) in the port's classes."""
    import icebin_tpu_torch as port
    from icebin_tpu_torch.grid import GridSpecLonLat, GridSpecXY, PlateCarree
    specA = GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                           latb=np.linspace(30.0, 80.0, 7))
    gr = port.GCMRegridder(specA, HCDEFS, device=CPU)
    ny = ny or n_ice
    specI = GridSpecXY(xb=np.linspace(2.0 * scale, 18.0 * scale, n_ice + 1),
                       yb=np.linspace(40.0 * scale, 72.0 * scale, ny + 1),
                       projection=PlateCarree(scale=scale))
    gr.add_sheet("toy", specI, subdiv=1)
    return gr


def forcing_np(t, nE, cold=False, seed_extra=0):
    """tests/test_mesh_coupler.py's forcing (tests/test_ragged_mesh.py's
    cold_forcing with ``cold``), f32."""
    rng = np.random.default_rng((int(t) + seed_extra) % 100003)
    f = np.zeros((8, nE))
    f[0] = 1e-5 * rng.uniform(0.5, 1.0, nE)
    if not cold:
        f[1] = 5.0
        f[3] = 2.0
    f[4] = -10.0
    return f.astype(np.float32)


def _coupler(mesh, regen, gr=None, **kw):
    import icebin_tpu_torch as port
    return port.GCMCoupler(gr or port_gr(), port.CouplerConfig(
        dt=DT, regen_every=regen, **kw), mesh=mesh)


def _stepwise(cp, n, cold=False):
    out = None
    for k in range(n):
        out = cp.couple({"toy": torch.as_tensor(
            forcing_np(float(k), cp.gr.nE, cold))})["toy"]
    return out


def _summary(cp, out):
    sc = cp.sheets["toy"]
    return {"H": sc.gathered_state().H.numpy(),
            "fE_out": out["fE_out"].numpy(),
            "fI": sc.gather_ice(out["fI"]).numpy(),
            "rows": cp.ledger.to_rows()}


def _match(mesh):
    """5 steps, a regeneration after 4 (tests/test_mesh_coupler.py:89),
    held state remapped; then the same again in a second coupler."""
    runs = []
    for _ in range(2):
        cp = _coupler(mesh, 4)
        cp.sheets["toy"].set_held_state(
            np.random.default_rng(7).uniform(0.5, 2.0, (2, cp.gr.nE)))
        runs.append(_summary(cp, _stepwise(cp, 5)))
    sc = cp.sheets["toy"]
    fE = torch.as_tensor(np.random.default_rng(5).uniform(1.0, 2.0,
                                                          (2, cp.gr.nE)))
    fA = sc.apply("AvE", fE).double()
    ave = sc.mat("AvE")
    ave_rel = float(((torch.nan_to_num(fA) * ave.wM).sum(1)
                     - (fE * ave.Mw).sum(1)).abs().max()
                    / (fE * ave.Mw).sum(1).abs().max())
    return {"runs": runs, "ave_rel": ave_rel,
            "domains": [(d.low, d.high) for d in sc.local_domains]}


def _fused(mesh):
    """9 steps stepwise and fused (regen every 4,
    tests/test_mesh_coupler.py:186)."""
    f = lambda t, s: torch.as_tensor(forcing_np(t, cp1.gr.nE))
    cp1, cp2 = _coupler(mesh, 4), _coupler(mesh, 4)
    cp1.run_transient(f, 9)
    cp2.run_transient(f, 9, fused=True)
    return {"stepwise": cp1.ledger.to_rows(), "fused": cp2.ledger.to_rows(),
            "H1": cp1.sheets["toy"].gathered_state().H.numpy(),
            "H2": cp2.sheets["toy"].gathered_state().H.numpy()}


def _checkpoint(mesh, path):
    """4 steps (regen every 3), a checkpoint, one more step; a new coupler
    resumed from the checkpoint takes the same step
    (tests/test_mesh_coupler.py:131)."""
    from icebin_tpu_torch.coupler.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    cp = _coupler(mesh, 3)
    _stepwise(cp, 4)
    save_checkpoint(path, cp)
    f99 = torch.as_tensor(forcing_np(99.0, cp.gr.nE))
    ref = cp.couple({"toy": f99})["toy"]
    cp2 = _coupler(mesh, 3)
    load_checkpoint(path, cp2)
    out = cp2.couple({"toy": f99})["toy"]
    s1, s2 = cp.sheets["toy"], cp2.sheets["toy"]
    return {"H": (s1.state.H.numpy(), s2.state.H.numpy()),
            "enth": (s1.state.enth.numpy(), s2.state.enth.numpy()),
            "fE_out": (ref["fE_out"].numpy(), out["fE_out"].numpy()),
            "rows": (cp.ledger.to_rows(), cp2.ledger.to_rows())}


def _ragged(mesh):
    """tests/test_ragged_mesh.py:121: a 33-row lattice, 6 cold steps,
    regen every 3."""
    cp = _coupler(mesh, 3, gr=port_gr(n_ice=32, ny=33))
    out = _stepwise(cp, 6, cold=True)
    sc = cp.sheets["toy"]
    return dict(_summary(cp, out), ny_pad=sc.ny_pad,
                rows_real=sc.rows_real)


def warm_np(t, nE, tdegc=5.0, heat=2.0):
    """tests/test_mass_loss.py's warm_forcing, f32."""
    rng = np.random.default_rng(int(t) % 100003)
    f = np.zeros((8, nE))
    f[0] = 2e-6 * rng.uniform(0.5, 1.0, nE)
    f[1] = 5.0
    f[2] = 1.0
    f[3] = heat
    f[4] = tdegc
    f[5] = 0.06
    f[6] = 1e-7 * rng.uniform(0.2, 1.0, nE)
    f[7] = 0.2
    return f.astype(np.float32)


def melt_cfg(gr, **kw):
    """tests/test_mass_loss.py's melt_cfg in the port's classes."""
    from icebin_tpu_torch.models.ice_sheet import IceSheetConfig
    specI = gr.sheets["toy"].specI
    return IceSheetConfig(nx=specI.nx, ny=specI.ny,
                          dx=float(np.diff(specI.xb).mean()),
                          dy=float(np.diff(specI.yb).mean()),
                          calv_thk=700.0, calv_tau=86400.0 * 5, **kw)


def two_sheet_gr():
    """tests/test_mesh_coupler.py:make_gr(sheets=("greenland",
    "antarctica")) in the port's classes."""
    import icebin_tpu_torch as port
    from icebin_tpu_torch.grid import GridSpecLonLat, GridSpecXY, PlateCarree
    scale = 25e3
    gr = port.GCMRegridder(GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                                          latb=np.linspace(30.0, 80.0, 7)),
                           HCDEFS, device=CPU)
    for k, name in enumerate(SHEETS):
        x0 = 2.0 + 18.0 * k
        gr.add_sheet(name, GridSpecXY(
            xb=np.linspace(x0 * scale, (x0 + 16.0) * scale, 33),
            yb=np.linspace(40.0 * scale, 72.0 * scale, 33),
            projection=PlateCarree(scale=scale)), subdiv=1)
    return gr


# the reference seeds each sheet's forcing with hash(name), which differs
# between processes; the port's ranks need one seed per sheet
SHEETS = {"greenland": 0, "antarctica": 1}
SIGMA = (60e3, 60e3)


def _two_sheets(mesh=None):
    """tests/test_mesh_coupler.py:117: two sheets on one mesh, 12 steps,
    a regeneration every 5 (on the CPU without ``mesh``)."""
    import icebin_tpu_torch as port
    gr = two_sheet_gr()
    cp = port.GCMCoupler(gr, port.CouplerConfig(dt=DT, regen_every=5),
                         device=None if mesh else CPU, mesh=mesh)

    cp.run_transient(lambda t, s: torch.as_tensor(
        forcing_np(t, gr.nE, seed_extra=SHEETS[s])), 12)
    return {"rows": cp.ledger.to_rows(),
            "H": {s: cp.sheets[s].gathered_state().H.numpy()
                  for s in SHEETS}}


def _sigma(mesh):
    """tests/test_mesh_coupler.py:225: IvE of a smoothed config on the
    mesh, and the canonical matrix's apply of the same field."""
    import icebin_tpu_torch as port
    from icebin_tpu_torch.regrid.matrices import RegridParams
    P = RegridParams(scale=True, correctA=True, sigma=SIGMA)
    cp = port.GCMCoupler(port_gr(), port.CouplerConfig(
        dt=DT, regen_every=1 << 30, params=P), mesh=mesh)
    sc = cp.sheets["toy"]
    fE = np.random.default_rng(13).uniform(1.0, 2.0, cp.gr.nE)
    got = sc.gather_ice(sc.apply("IvE", torch.as_tensor(
        fE, dtype=torch.float32)))
    ref = sc.rm.matrix("IvE", P).apply(fE, scale=True, fill=np.nan)
    return {"got": got.double().numpy(), "ref": ref}


def _retreat(mesh=None, n=13, f64=False):
    """tests/test_mass_loss.py:304 (the retreat, 13 steps, a regeneration
    every 6) or, with ``f64``, :329 (an f64 state at 273.1 K under a cold
    surface and strong heating, 6 steps, no regeneration), on ``mesh`` or
    on the CPU; the ledger rows and the basal melt harvested."""
    import icebin_tpu_torch as port
    from icebin_tpu_torch.coupler.sharded import MeshIceSheetCoupler
    from icebin_tpu_torch.coupler.varset import ice_modele_output_contract
    gr = port_gr()
    cfg = port.CouplerConfig(dt=DT, regen_every=(1 << 30) if f64 else 6)
    ice = (melt_cfg(gr, dtype="float64", t_init=273.1) if f64
           else melt_cfg(gr))
    sc = (MeshIceSheetCoupler(gr, "toy", cfg, mesh, ice_cfg=ice) if mesh
          else port.IceSheetCoupler(gr, "toy", cfg, device=CPU, ice_cfg=ice))
    cp = port.GCMCoupler(gr, cfg, device=None if mesh else CPU,
                         sheets={"toy": sc}, mesh=mesh)
    kb = ice_modele_output_contract().index("basal_melt")
    basal = 0.0
    for _ in range(6 if f64 else n):
        fE = (warm_np(cp.time, gr.nE, tdegc=-5.0, heat=40.0) if f64
              else warm_np(cp.time, gr.nE))
        out = cp.couple({"toy": torch.as_tensor(fE)})["toy"]["fE_out"]
        basal += float(torch.nan_to_num(out[kb].double()).abs().sum())
    return {"rows": cp.ledger.to_rows(), "basal": basal}


def _dismal_cli(mesh, cfg, workdir):
    """``run CFG --mesh N --ice dismal --device cpu`` as this rank of it
    (``cli.run._rank``), in ``workdir``: the report rank 0 prints and the
    files left there."""
    from icebin_tpu_torch.cli.run import _rank
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        out = _rank(mesh, [cfg, "--mesh", str(mesh.size), "--ice",
                           "dismal", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    return {"out": out}


def dismal_dumps(out_dir, mesh=None, n=2):
    """``DismalModel(out_dir)`` as the ice model of the toy coupler for n
    steps (``step_for`` the mesh sheet on a mesh): the dumps' contents."""
    import icebin_tpu_torch as port
    from icebin_tpu_torch.models.dismal import DismalModel
    cp = port.GCMCoupler(port_gr(), port.CouplerConfig(dt=DT, regen_every=4),
                         device=None if mesh else CPU, mesh=mesh)
    sc = cp.sheets["toy"]
    sc.ice_step = DismalModel(out_dir=out_dir).step_for(sc)
    _stepwise(cp, n)
    if mesh is not None:
        mesh.barrier()
        if mesh.rank:
            return None
    return {f: dict(np.load(os.path.join(out_dir, f)))
            for f in sorted(os.listdir(out_dir))}


def _layout(mesh):
    """tests/test_mesh_coupler.py:156-166 at 8 ranks: 30 rows pad to 32;
    7 rows leave a rank none."""
    import icebin_tpu_torch as port
    from icebin_tpu_torch.coupler.sharded import MeshIceSheetCoupler
    sc = MeshIceSheetCoupler(port_gr(n_ice=30), "toy", port.CouplerConfig(),
                             mesh)
    try:
        MeshIceSheetCoupler(port_gr(n_ice=7), "toy", port.CouplerConfig(),
                            mesh)
        err = None
    except ValueError as e:
        err = str(e)
    return {"ny_pad": sc.ny_pad, "ny_real": sc.ny_real, "error": err}


def rank_program(mesh, cases):
    out = {}
    if "match" in cases:
        out["match"] = _match(mesh)
    if "fused" in cases:
        out["fused"] = _fused(mesh)
    if "checkpoint" in cases:
        out["checkpoint"] = _checkpoint(mesh, cases["checkpoint"])
    if "ragged" in cases:
        out["ragged"] = _ragged(mesh)
    if "layout" in cases:
        out["layout"] = _layout(mesh)
    if "two_sheets" in cases:
        out["two_sheets"] = _two_sheets(mesh)
    if "sigma" in cases:
        out["sigma"] = _sigma(mesh)
    if "retreat" in cases:
        out["retreat"] = _retreat(mesh)
        out["f64"] = _retreat(mesh, f64=True)
    if "dismal" in cases:
        cfg, workdir, dumps = cases["dismal"]
        out["dismal"] = _dismal_cli(mesh, cfg, workdir)
        out["dismal"]["dumps"] = dismal_dumps(dumps, mesh)
    return out


# -- spawns, references ----------------------------------------------------------

@pytest.fixture(scope="module")
def ranks1(tmp_path_factory):
    return shared_spawn(tmp_path_factory, "mesh1", rank_program, 1,
                        {"match": True})


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("mesh_ck") / "ck.npz")
    d = tmp_path_factory.mktemp("mesh_dismal")
    cfg = dismal_config(d, "mesh")
    (d / "dumps").mkdir()
    return shared_spawn(tmp_path_factory, "mesh2", rank_program, 2,
                        {"match": True, "fused": True, "checkpoint": ck,
                         "two_sheets": True, "sigma": True, "retreat": True,
                         "dismal": (cfg, str(d / "mesh"),
                                    str(d / "dumps"))})


def dismal_config(d, tag):
    """tests/test_torch_run.py's run.json (4 steps, a regeneration every 2,
    a checkpoint every 2, no dumps) in ``d``, with the exchange grid the
    reference builds, written to a file both CLIs read; ``d / tag`` is the
    run's working directory."""
    from icebin_tpu.grid import proj as ref_proj, spec as ref_spec
    from icebin_tpu.io.ncio import write_exchange, write_grid
    from icebin_tpu.regrid.gcmregridder import GCMRegridder
    from icebin_tpu.utils.config import RunConfig, SheetConfig
    scale = 25e3
    specA = ref_spec.GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                                    latb=np.linspace(30.0, 80.0, 7))
    specI = ref_spec.GridSpecXY(
        xb=np.linspace(0.0, 40.0 * scale, 33),
        yb=np.linspace(30.0 * scale, 80.0 * scale, 33),
        projection=ref_proj.PlateCarree(scale=scale))
    gr = GCMRegridder(specA, hcdefs=[0.0, 800.0, 2500.0])
    gr.add_sheet("s", specI, subdiv=1, engine="numpy")
    a, i, x = (str(d / f) for f in ("a.nc", "i.nc", "x.nc"))
    write_grid(a, specA)
    write_grid(i, specI)
    write_exchange(x, gr.sheets["s"].exchange)
    (d / tag).mkdir()
    path = str(d / "run.json")
    RunConfig(gridA_file=a, hcdefs=[0.0, 800.0, 2500.0], n_steps=4,
              sheets=[SheetConfig(name="s", grid_file=i, exchange_file=x,
                                  subdiv=1)],
              regen_every=2, checkpoint_every=2).to_json(path)
    return path


@pytest.fixture(scope="module")
def ranks3(tmp_path_factory):
    return shared_spawn(tmp_path_factory, "mesh3", rank_program, 3,
                        {"ragged": True})


@pytest.fixture(scope="module")
def ranks5(tmp_path_factory):
    return shared_spawn(tmp_path_factory, "mesh5", rank_program, 5,
                        {"ragged": True})


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    return shared_spawn(tmp_path_factory, "mesh8", rank_program, 8,
                        {"match": True, "layout": True})


@pytest.fixture(scope="module")
def single():
    """The port's single-device coupler through the same 5 steps."""
    import icebin_tpu_torch as port
    cp = port.GCMCoupler(port_gr(), port.CouplerConfig(dt=DT, regen_every=4),
                         device=CPU)
    cp.sheets["toy"].set_held_state(
        np.random.default_rng(7).uniform(0.5, 2.0, (2, cp.gr.nE)))
    return _summary(cp, _stepwise(cp, 5))


@pytest.fixture(scope="module")
def jax_mesh():
    """The JAX package's mesh coupler on 8 devices through the same 5
    steps (tests/test_mesh_coupler.py:89), on the same f32 forcing."""
    import jax.numpy as jnp
    from icebin_tpu.coupler.coupler import CouplerConfig, GCMCoupler
    from icebin_tpu.parallel.mesh import make_mesh
    from tests.test_mesh_coupler import make_gr
    cp = GCMCoupler(make_gr(), CouplerConfig(dt=DT, regen_every=4),
                    mesh=make_mesh(8))
    out = None
    for k in range(5):
        out = cp.couple({"toy": jnp.asarray(
            forcing_np(float(k), cp.gr.nE))})["toy"]
    return {"H": np.asarray(cp.sheets["toy"].state.H),
            "fE_out": np.asarray(out["fE_out"])}


def check_closure(rows, sheet="toy"):
    """tests/test_mesh_coupler.py:check_ledger_closure."""
    prev = None
    for r in rows:
        m_in = r[f"{sheet}.mass_in_E"]
        m_del = r[f"{sheet}.mass_delivered_I"]
        assert abs(m_in - m_del) / abs(m_in) < 1e-10
        if prev is not None:
            lhs = r[f"{sheet}.ice_mass"] - prev
            rhs = (m_del - r[f"{sheet}.mass_returned_I"]
                   + r[f"{sheet}.mass_residual"])
            scale = max(abs(r[f"{sheet}.ice_mass"]), abs(m_del))
            assert abs(lhs - rhs) / scale < 1e-12
        prev = r[f"{sheet}.ice_mass"]


def close_H_fE(got, want):
    np.testing.assert_allclose(got["H"], want["H"], rtol=2e-5, atol=2e-4)
    e1, e2 = want["fE_out"], got["fE_out"]
    np.testing.assert_array_equal(np.isfinite(e1), np.isfinite(e2))
    ok = np.isfinite(e1)
    np.testing.assert_allclose(e2[ok], e1[ok], rtol=5e-4, atol=5e-3)


# -- tests ------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 8])
def test_mesh_matches_single_device_and_jax_mesh(request, n, single,
                                                 jax_mesh):
    """5 steps with a regeneration: every rank's H and fE_out within the
    JAX package's mesh tolerances of the port's single-device coupler and
    of the JAX mesh coupler on 8 devices; every rank books the same ledger,
    closing every step; each rank's block is its local domain."""
    res = request.getfixturevalue(f"ranks{n}")
    for r in res:
        got = r["match"]["runs"][0]
        close_H_fE(got, single)
        close_H_fE(got, jax_mesh)
        assert got["fI"].shape == single["fI"].shape
        assert got["rows"] == res[0]["match"]["runs"][0]["rows"]
        check_closure(got["rows"])
        assert "toy.held_mass" in got["rows"][3]
    doms = res[0]["match"]["domains"]
    assert len(doms) == n and doms[0][0] == (0, 0)
    assert doms[-1][1] == (32, 32)


def test_mesh_world1_bit_for_bit_single_device(ranks1, single):
    """At one rank the mesh coupler is the single-device coupler bit for
    bit: H, fI, fE_out and every ledger row (K2's partials stay f64 until
    the rank sum, which rounds once, as the single-rank K2 does)."""
    got = ranks1[0]["match"]["runs"][0]
    for k in ("H", "fI", "fE_out"):
        np.testing.assert_array_equal(got[k], single[k])
    assert got["rows"] == single["rows"]


@pytest.mark.parametrize("n", [2, 8])
def test_mesh_two_runs_bit_for_bit(request, n):
    """Two runs at one world size: ledger rows, H, fI and fE_out bit for
    bit (cross-rank sums are added in rank order)."""
    a, b = request.getfixturevalue(f"ranks{n}")[0]["match"]["runs"]
    assert a["rows"] == b["rows"]
    for k in ("H", "fI", "fE_out"):
        np.testing.assert_array_equal(a[k], b[k])


def test_mesh_ave_eva_runtime(ranks2):
    """The lazy AvE pair on a mesh coupler (A and E are replicated: the
    whole pack on every rank) conserves mass through its repair."""
    for r in ranks2:
        assert r["match"]["ave_rel"] < 1e-10


@pytest.mark.parametrize("n", [3, 5])
def test_ragged_mesh_matches_single_device(request, n):
    """33 rows over 3 and 5 ranks (padded to 33 -> 33 and 35): books
    within tests/test_ragged_mesh.py:121's tolerances of the single-device
    run through a regeneration, closure every step, H within the mesh
    tolerance; pad rows stay out of the books."""
    import icebin_tpu_torch as port
    res = request.getfixturevalue(f"ranks{n}")
    cp = port.GCMCoupler(port_gr(n_ice=32, ny=33),
                         port.CouplerConfig(dt=DT, regen_every=3),
                         device=CPU)
    one = _summary(cp, _stepwise(cp, 6, cold=True))
    r = res[0]["ragged"]
    assert r["ny_pad"] == n * -(-33 // n)
    for key, rtol in (("ice_mass", 1e-9), ("mass_delivered_I", 1e-6),
                      ("mass_in_E", 1e-7)):
        a = np.array([x[f"toy.{key}"] for x in one["rows"]])
        b = np.array([x[f"toy.{key}"] for x in r["rows"]])
        np.testing.assert_allclose(b, a, rtol=rtol)
    check_closure(r["rows"])
    np.testing.assert_allclose(r["H"], one["H"], rtol=2e-5, atol=2e-4)
    assert r["H"].shape == one["H"].shape


def test_mesh_fused_equals_stepwise(ranks2):
    """Fused windows over the mesh reproduce the stepwise mesh coupler's
    ledger and state bit for bit (tests/test_mesh_coupler.py:186)."""
    for r in ranks2:
        f = r["fused"]
        assert len(f["stepwise"]) == len(f["fused"]) == 9
        assert f["stepwise"] == f["fused"]
        np.testing.assert_array_equal(f["H1"], f["H2"])
        check_closure(f["fused"])


def test_mesh_checkpoint_roundtrip(ranks2):
    """A checkpoint of the gathered state resumes a mesh run bit for bit:
    every rank's block, fE_out and ledger rows."""
    for r in ranks2:
        c = r["checkpoint"]
        for k in ("H", "enth", "fE_out"):
            np.testing.assert_array_equal(*c[k])
        assert c["rows"][0] == c["rows"][1]


def test_mesh_layout_contract(ranks8):
    """Ragged layouts are taken (30 rows over 8 ranks pad to 32); a mesh
    that leaves some rank no real row is refused (7 rows over 8)."""
    for r in ranks8:
        lay = r["layout"]
        assert (lay["ny_pad"], lay["ny_real"]) == (32, 30)
        assert lay["error"] is not None and "no real rows" in lay["error"]


def test_run_cli_mesh(tmp_path):
    """`run --mesh 2 --backend gloo --device cpu`: two ranks run the
    stepwise coupled run with checkpoints and dumps from rank 0; its report
    and checkpoint are the single-device run's within the mesh tolerance,
    and the checkpoint holds the whole lattice."""
    import contextlib
    import io
    from icebin_tpu_torch.cli.run import main as run
    from icebin_tpu_torch.io import write_exchange, write_grid
    from icebin_tpu_torch.utils.config import RunConfig, SheetConfig
    gr = port_gr()
    a, i, x = (str(tmp_path / f) for f in ("a.nc", "i.nc", "x.nc"))
    write_grid(a, gr.gridA)
    write_grid(i, gr.sheets["toy"].specI)
    write_exchange(x, gr.sheets["toy"].exchange)
    cfg = str(tmp_path / "run.json")
    outs = {}
    for tag, flags in (("one", []),
                       ("mesh", ["--mesh", "2", "--backend", "gloo"])):
        d = tmp_path / tag
        d.mkdir()
        RunConfig(gridA_file=a, hcdefs=HCDEFS, n_steps=3,
                  sheets=[SheetConfig(name="toy", grid_file=i,
                                      exchange_file=x)],
                  regen_every=2, checkpoint_every=3,
                  dump_dir=str(d / "dumps")).to_json(cfg)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert run([cfg, "--device", "cpu"] + flags) == 0
        finally:
            os.chdir(cwd)
        outs[tag] = (buf.getvalue(),
                     np.load(d / "checkpoint_000003.npz"),
                     sorted(os.listdir(d / "dumps")))
    one, mesh = outs["one"], outs["mesh"]
    assert "toy: 3 steps" in mesh[0]
    assert mesh[2] == one[2] and len(one[2]) == 3
    np.testing.assert_allclose(mesh[1]["toy.H"], one[1]["toy.H"],
                               rtol=2e-5, atol=2e-4)
    assert mesh[1]["toy.H"].shape == (32, 32)


def test_two_sheets_on_one_mesh(ranks2):
    """tests/test_mesh_coupler.py:117 at two ranks: both sheets close every
    step through two regenerations, every rank books the same rows, and
    each sheet's H is the single-device run's within the mesh tolerance."""
    one = _two_sheets()
    for r in ranks2:
        got = r["two_sheets"]
        assert len(got["rows"]) == 12
        assert got["rows"] == ranks2[0]["two_sheets"]["rows"]
        for s in SHEETS:
            check_closure(got["rows"], s)
            np.testing.assert_allclose(got["H"][s], one["H"][s],
                                       rtol=2e-5, atol=2e-4)


def test_mesh_sigma_ive_canonical(ranks2):
    """tests/test_mesh_coupler.py:225: a smoothed config's IvE on the mesh
    is its canonical matrix's (no transpose-sharing of the asymmetric
    smoother), gathered over the ranks."""
    for r in ranks2:
        got, ref = r["sigma"]["got"], r["sigma"]["ref"]
        m = np.isfinite(ref)
        assert m.any()
        np.testing.assert_allclose(np.where(m, got, 0.0),
                                   np.where(m, ref, 0.0), rtol=2e-5,
                                   atol=1e-8 * np.abs(ref[m]).max())


def retreat_closure(rows, sheet="toy"):
    """tests/test_mass_loss.py:_closure: the mass and energy identities."""
    prev_m = prev_e = None
    for r in rows:
        m1, e1 = r[f"{sheet}.ice_mass"], r[f"{sheet}.energy_storage_I"]
        if prev_m is not None:
            rhs = (r[f"{sheet}.mass_delivered_I"]
                   - r[f"{sheet}.mass_returned_I"]
                   + r[f"{sheet}.mass_clamp_I"] + r[f"{sheet}.mass_residual"])
            scale = max(abs(m1), abs(r[f"{sheet}.mass_delivered_I"]))
            assert abs(m1 - prev_m - rhs) / scale < 1e-12
            rhsE = (r[f"{sheet}.energy_delivered_I"]
                    - r[f"{sheet}.energy_returned_I"]
                    - r[f"{sheet}.energy_clamp_I"]
                    + r[f"{sheet}.energy_residual"])
            scaleE = max(abs(e1), abs(r[f"{sheet}.energy_delivered_I"]))
            assert abs(e1 - prev_e - rhsE) / scaleE < 1e-12
        prev_m, prev_e = m1, e1


def test_retreat_on_a_mesh_matches_single_device(ranks2):
    """tests/test_mass_loss.py:304: the melt and calving retreat on two
    ranks closes its mass and energy books every step, returns mass every
    step, and its books are the single-device run's within the reference
    test's tolerances."""
    one = _retreat()["rows"]
    for r in ranks2:
        rows = r["retreat"]["rows"]
        retreat_closure(rows)
        for key, tol in (("mass_returned_I", 1e-6), ("ice_mass", 1e-7),
                         ("energy_storage_I", 1e-6),
                         ("energy_returned_I", 1e-6)):
            a = np.array([x[f"toy.{key}"] for x in one])
            b = np.array([x[f"toy.{key}"] for x in rows])
            np.testing.assert_allclose(b, a, rtol=tol)
        assert all(x["toy.mass_returned_I"] > 0 for x in rows)


def test_energy_closure_f64_on_a_mesh(ranks2):
    """tests/test_mass_loss.py:329: with an f64 state the coupler's energy
    account closes < 1e-10 every step on two ranks, basal melt live from
    the energy path, and the books agree with the single-device run."""
    one = _retreat(f64=True)
    for res in (one, *(r["f64"] for r in ranks2)):
        assert res["basal"] > 0
        retreat_closure(res["rows"])
        for r in res["rows"]:
            e_in, e_del = r["toy.energy_in_E"], r["toy.energy_delivered_I"]
            assert e_in != 0.0
            assert abs(e_in - e_del) / abs(e_in) < 1e-10
            scale = max(abs(r["toy.energy_delivered_I"]),
                        abs(r["toy.energy_returned_I"]),
                        abs(r["toy.energy_storage_I"]))
            assert abs(r["toy.energy_residual"]) / scale < 1e-10
            assert abs(r["toy.mass_residual"]) / max(
                abs(r["toy.mass_delivered_I"]),
                abs(r["toy.mass_returned_I"])) < 1e-10
    for r in ranks2:
        for key in ("energy_storage_I", "energy_returned_I", "ice_mass"):
            a = np.array([x[f"toy.{key}"] for x in one["rows"]])
            b = np.array([x[f"toy.{key}"] for x in r["f64"]["rows"]])
            np.testing.assert_allclose(b, a, rtol=1e-6)


def report(out):
    """(ice mass, worst transport) of a run report's last line."""
    line = out.strip().splitlines()[-1]
    return (line.split("ice mass ")[1].split(" kg")[0],
            float(line.rsplit(" ", 1)[-1]))


def test_run_cli_mesh_dismal_matches_reference(ranks2, tmp_path):
    """`run --mesh 2 --ice dismal --device cpu` (gloo) prints the
    reference's `run --mesh 2 --ice dismal` ice mass, to the digit, on the
    same run.json, and both transport figures are < 1e-10; rank 0 alone
    writes the checkpoints."""
    import contextlib
    import io
    from icebin_tpu.cli.run import main as ref_run
    cfg = dismal_config(tmp_path, "ref")
    os.chdir(tmp_path / "ref")
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert ref_run([cfg, "--mesh", "2", "--ice", "dismal"]) == 0
    finally:
        os.chdir(tmp_path)
    want = report(buf.getvalue())
    got = report(ranks2[0]["dismal"]["out"])
    assert got[0] == want[0]
    assert got[1] < 1e-10 and want[1] < 1e-10
    assert "s: 4 steps" in ranks2[0]["dismal"]["out"]


def test_dismal_dumps_on_a_mesh_are_the_single_device_files(ranks2,
                                                            tmp_path):
    """``DismalModel(out_dir).step_for(sheet)`` on two ranks writes the
    single-device run's files: one per step, the whole real lattice each,
    written by rank 0 from the gathered forcings."""
    one = dismal_dumps(str(tmp_path))
    got = ranks2[0]["dismal"]["dumps"]
    assert ranks2[1]["dismal"]["dumps"] is None
    assert sorted(got) == sorted(one) == ["dismal_000000.npz",
                                          "dismal_000001.npz"]
    for f in one:
        assert sorted(got[f]) == sorted(one[f])
        for k, a in one[f].items():
            b = got[f][k]
            assert b.shape == a.shape, k
            scale = max(np.abs(a).max(), 1e-300)
            assert np.abs(b - a).max() <= 1e-5 * scale, k
