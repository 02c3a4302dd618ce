"""The port's decomposition over torch.distributed ranks
(icebin_tpu_torch.parallel) vs the JAX package's shard_map twins
(icebin_tpu.parallel) on the suite's 8 virtual CPU devices, on the same
seeded numpy inputs.

The port's ranks run as gloo processes on CPU tensors: one spawn per world
size (2, 3, 4 and 8), from a module-scoped fixture, runs every case of that
size in its ranks and returns the results; each test reads them.  Every
spawn has its own timeout.  The rank programs live at module level and the
module imports the JAX package only inside the tests, so a rank process
never imports JAX.

Tolerances, with their reasons:
* halo exchange, the sharded SIA step and the sharded exchange build are
  held bit for bit: they only move values between ranks (the SIA's CFL max
  is exact; every cell's arithmetic is the single-rank step's), and the
  build clips each pair with the single-rank build's inputs;
* the sharded applies: < 5e-7 relative to the f64 oracle (the port's K2
  partials are rounded once each before the f64 cross-rank sum), and
  within the reference's own 2e-5 (tests/test_parallel_pallas.py) of the
  JAX package's sharded Pallas applies; a round trip with the f64 repair
  conserves mass to 1e-10;
* the sharded build against the JAX package's sharded build (its f64 XLA
  clip): the same pairs, areas within 1e-6 of their ice cell (the port's
  f32 recentred clip, tests/test_torch_clip.py's bound);
* the 2-D step against the single-device JAX step at
  tests/test_parallel.py:135's tolerances, with 5e-7 relative added on fI
  and fE_out: K1 and K2 sum in f64 and round once where the JAX step's
  XLA applies sum in f32, so rows of 300 K or 1,300 m differ by an f32 ulp
  (~3e-5 and ~1.2e-4 absolute), which the JAX package's own test,
  comparing two f32 applies, does not see.
"""
import dataclasses

import numpy as np
import pytest
import torch

from icebin_tpu_torch.parallel.distributed import launch

torch.set_num_threads(1)
CPU = torch.device("cpu")
SPAWN_TIMEOUT = 240.0
HALO_SHAPE = (24, 10)
SIA_NY, SIA_NX = 25, 12          # ragged over 2 and 3 ranks


# -- the port's side: rank programs ------------------------------------------

def port_spec(kind, kw):
    """A port grid spec from ``spec_numbers`` (the packages' classes are
    distinct)."""
    from icebin_tpu_torch.grid import proj, spec
    kw = dict(kw)
    p = kw.pop("projection", None)
    if p is not None:
        kw["projection"] = getattr(proj, p[0])(**p[1])
    return getattr(spec, kind)(**kw)


def spec_numbers(s):
    """(class name, fields) of a grid spec of either package."""
    kw = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    p = kw.get("projection")
    if p is not None:
        kw["projection"] = (type(p).__name__,
                            {f.name: getattr(p, f.name)
                             for f in dataclasses.fields(p)})
    return type(s).__name__, kw


def _halo(mesh, x, axis_dim):
    from icebin_tpu_torch.parallel.halo import (halo_exchange_cols,
                                                halo_exchange_rows)
    n = x.shape[axis_dim] // mesh.size
    blk = torch.as_tensor(x).narrow(axis_dim, mesh.rank * n, n)
    fn = halo_exchange_rows if axis_dim == 0 else halo_exchange_cols
    return {w: fn(blk, w, mesh, "ice").numpy() for w in (1, 2)}


def _applies(mesh, M_arrays, ny, nx, f, g):
    """Both sharded applies of one matrix, and a repaired round trip."""
    from icebin_tpu_torch.coupler.ledger import repair_mass, weighted_mass
    from icebin_tpu_torch.ops.apply import apply_view
    from icebin_tpu_torch.parallel.sharded_apply import (
        make_sharded_apply_ice, make_sharded_apply_small,
        sharded_csr_from_weighted, sharded_view_pair)
    from icebin_tpu_torch.regrid.sparse import WeightedMatrix
    M = WeightedMatrix(*M_arrays)
    ny_l = -(-ny // mesh.size)
    cps = ny_l * nx
    kw = dict(nv=8, cells_per_shard=cps, nice_pad=cps * mesh.size)
    sc = sharded_csr_from_weighted(mesh, M, **kw)
    fpad = np.zeros((f.shape[0], cps * mesh.size), np.float32)
    fpad[:, :f.shape[1]] = f
    f_loc = torch.as_tensor(fpad[:, sc.c0:sc.c0 + cps])
    e = make_sharded_apply_small(mesh, sc)(f_loc)
    gi = make_sharded_apply_ice(mesh, sc)(torch.as_tensor(g))
    # round trip E <- I <- E with the coupler's f64 repair on each leg
    evi, ive = sharded_view_pair(mesh, M, **kw)
    h = torch.as_tensor(np.nan_to_num(fpad[:, sc.c0:sc.c0 + cps]) + 1.0)
    m0 = mesh.sum_ranks(weighted_mass(h, evi.Mw))[0]
    e2 = repair_mass(torch.nan_to_num(apply_view(evi, h), nan=0.0), evi.wM,
                     m0)
    m1 = weighted_mass(e2, evi.wM)
    e2 = e2.float()
    ms = weighted_mass(e2, ive.Mw)
    i2 = repair_mass(torch.nan_to_num(apply_view(ive, e2), nan=0.0), ive.wM,
                     ms, totals=mesh.sum_ranks)
    m2 = mesh.sum_ranks(weighted_mass(i2, ive.wM))[0]
    return {"e": e.numpy(), "gi": gi.numpy(), "c0": sc.c0, "cps": cps,
            "round_trip": float(((m1 - m0).abs() / m0.abs()).max()),
            "round_trip2": float(((m2 - ms).abs() / ms.abs()).max())}


def _build(mesh, specA, specI, maskI):
    from icebin_tpu_torch.grid import Grid
    from icebin_tpu_torch.parallel.build import sharded_exchange_grid
    gI = port_spec(*specI)
    if maskI is not None:
        gI = Grid(gI, mask=maskI)
    xg = sharded_exchange_grid(mesh, port_spec(*specA), gI, subdiv=1)
    return {"iA": xg.iA, "iI": xg.iI, "area": xg.area,
            "centroid": xg.centroid}


def sia_case(device=CPU):
    """The SIA step's config, first state and two steps of forcing: a dome
    on a rough bed, melt on its warm side, calving at thin margins."""
    from icebin_tpu_torch.models.ice_sheet import IceSheetConfig, init_state
    cfg = IceSheetConfig(nx=SIA_NX, ny=SIA_NY, dx=25e3, dy=20e3,
                         calv_thk=400.0)
    rng = np.random.default_rng(11)
    bed = rng.uniform(-50.0, 150.0, (SIA_NY, SIA_NX))
    st = init_state(cfg, bed=bed, device=device, dome_height=2500.0)
    forc = [(rng.uniform(-2e-5, 3e-5, SIA_NY * SIA_NX),
             rng.uniform(258.0, 280.0, SIA_NY * SIA_NX),
             rng.uniform(-0.5, 0.5, SIA_NY * SIA_NX)) for _ in range(2)]
    return cfg, st, [tuple(torch.as_tensor(a, dtype=torch.float32,
                                           device=device) for a in f)
                     for f in forc]


def _sia(mesh):
    """Two steps of the sharded SIA step on the rank's rows; the gathered
    state and per-cell books, and the rank's clamp partials."""
    from icebin_tpu_torch.models.ice_sheet import IceSheetState
    from icebin_tpu_torch.parallel.coupled import (make_sharded_ice_step,
                                                   rows_of)
    cfg, st, forc = sia_case()
    r0, ny_l, rows = rows_of(mesh, SIA_NY)

    def blk(a):
        a = a.reshape(SIA_NY, SIA_NX)
        b = a[r0:r0 + rows]
        return torch.cat([b] + [a[-1:]] * (ny_l - rows)) if rows < ny_l \
            else b

    state = IceSheetState(H=blk(st.H), bed=blk(st.bed), t=st.t,
                          enth=blk(st.enth))
    step = make_sharded_ice_step(mesh, ny_real=SIA_NY)
    out = []
    for smb, ts, ef in forc:
        state, fx = step(cfg, state, blk(smb), blk(ts), 86400.0 * 30,
                         blk(ef))
        cells = {k: getattr(fx, k)[:rows].numpy() for k in
                 ("runoff", "basal_melt", "calving", "enth_runoff",
                  "enth_calving", "latent_pdd")}
        cells.update(H=state.H[:rows].numpy(), enth=state.enth[:rows].numpy(),
                     pad_ok=bool((state.H[rows:] == state.H[rows - 1]).all()),
                     mass_clamp=float(fx.mass_clamp),
                     enth_clamp=float(fx.enth_clamp))
        out.append(cells)
    return out


def _twod(mesh, evi_arrays, H0, bed, nx, ny, dx, dy, fE):
    """The 2-D step on a (2, 2) mesh (tests/test_parallel.py:135's setup)."""
    from icebin_tpu_torch.models.ice_sheet import IceSheetConfig, init_state
    from icebin_tpu_torch.parallel.coupled import (make_mesh_2d,
                                                   make_sharded_step_2d,
                                                   shard_coupled_setup_2d)
    from icebin_tpu_torch.regrid.sparse import WeightedMatrix
    m2 = make_mesh_2d((2, 2), backend="gloo", device="cpu")
    cfg = IceSheetConfig(nx=nx, ny=ny, dx=dx, dy=dy, n_substeps_max=8)
    state = init_state(cfg, bed=bed, H0=H0, device=CPU)
    evi = WeightedMatrix(*evi_arrays)
    ops = shard_coupled_setup_2d(m2, evi, state, cfg)
    fn = make_sharded_step_2d(m2, cfg, evi.shape[0], 86400.0 * 30)
    H1, fI, fE_out = fn(ops, torch.as_tensor(fE), torch.ones(2),
                        torch.zeros(2))
    return {"H": H1.numpy(), "fI": fI.numpy(), "fE": fE_out.numpy(),
            "iy": m2.axis("icey").index, "ix": m2.axis("icex").index}


def _fields(mesh):
    """global_field's scatter of rank 0's y-blocks, replicated_field's
    broadcast and local_ice_range."""
    from icebin_tpu_torch.parallel.distributed import (global_field,
                                                       local_ice_range,
                                                       replicated_field)
    mine = HALO if mesh.rank == 0 else None
    return {"block": global_field(mesh, mine).numpy(),
            "repl": replicated_field(mesh, mine).numpy(),
            "range": local_ice_range(mesh, 1000)}


def rank_program(mesh, cases):
    """Every case of this world size, on this rank."""
    from icebin_tpu_torch.parallel.dryrun import run_dryrun
    out = {}
    if cases.get("fields"):
        out["fields"] = _fields(mesh)
    if cases.get("dryrun"):
        out["dryrun"] = run_dryrun(mesh)
    if "halo" in cases:
        x = cases["halo"]
        out["halo_rows"] = _halo(mesh, x, 0)
        out["halo_cols"] = _halo(mesh, np.ascontiguousarray(x.T), 1)
    if "applies" in cases:
        out["applies"] = _applies(mesh, *cases["applies"])
    for k, args in cases.get("builds", {}).items():
        out[f"build_{k}"] = _build(mesh, *args)
    if cases.get("sia"):
        out["sia"] = _sia(mesh)
    if "twod" in cases:
        out["twod"] = _twod(mesh, *cases["twod"])
    return out


# -- the JAX package's side and the spawns -----------------------------------

def synth_matrix(ny):
    from tests.test_pallas_bdt import synth
    return synth(nx=256, ny=ny)


def apply_case(ny):
    M = synth_matrix(ny)
    rng = np.random.default_rng(0)
    f = rng.uniform(0.5, 1.5, (8, M.shape[1]))
    f[1, ::5] = np.nan
    g = rng.uniform(0.5, 1.5, (8, M.shape[0]))
    return M, ((M.rows, M.cols, M.vals, M.shape), ny, 256,
               f.astype(np.float32), g.astype(np.float32))


def build_cases():
    from tests.helpers import toy_grids
    specA, specI = toy_grids((96, 96), (8, 10))
    specA2, specI2 = toy_grids((60, 54), (4, 5))
    maskI = np.random.default_rng(3).uniform(size=specI2.ncells) < 0.7
    return {"plain": (spec_numbers(specA), spec_numbers(specI), None),
            "masked": (spec_numbers(specA2), spec_numbers(specI2), maskI)}


def twod_setup():
    from tests.test_parallel import setup_sharded
    from icebin_tpu.regrid.matrices import RegridParams
    gr, ice_cfg, state, ive, evi = setup_sharded(nx=256, ny=16)
    rm = gr.regrid_matrices("s", np.asarray(state.elevmask()))
    M = rm.matrix("EvI", RegridParams(scale=True, correctA=True))
    rng = np.random.default_rng(0)
    fE = np.stack([1e-5 * rng.uniform(0.5, 1, gr.nE),
                   np.full(gr.nE, 300.0)]).astype(np.float32)
    return gr, ice_cfg, state, evi, M, fE


def shared_spawn(tmp_path_factory, key, fn, n, cases):
    """``launch(fn, n)`` once per test run: xdist workers share the result
    through a file under the run's base temporary directory, under a file
    lock (the first worker to need it spawns the ranks).  The ranks run at
    a lower priority, so the suite's other workers (the JAX package's
    8-device mesh tests among them) keep their cores."""
    import fcntl
    import os
    import pickle
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent                # shared by the run's workers
    path = root / f"torch_ranks_{key}.pkl"
    with open(root / f"torch_ranks_{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            out = launch(fn, n, backend="gloo", device="cpu", args=(cases,),
                         timeout=SPAWN_TIMEOUT, nice=10)
            path.write_bytes(pickle.dumps(out))
        return pickle.loads(path.read_bytes())


HALO = np.random.default_rng(5).standard_normal(HALO_SHAPE).astype(
    np.float32)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return shared_spawn(tmp_path_factory, "parallel2", rank_program, 2,
                        {"halo": HALO, "applies": apply_case(24)[1],
                         "builds": {"plain": build_cases()["plain"]},
                         "sia": True, "fields": True})


@pytest.fixture(scope="module")
def ranks3(tmp_path_factory):
    return shared_spawn(tmp_path_factory, "parallel3", rank_program, 3,
                        {"halo": HALO, "applies": apply_case(25)[1],
                         "sia": True, "dryrun": True})


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    gr, cfg, state, evi, M, fE = twod_setup()
    return shared_spawn(tmp_path_factory, "parallel4", rank_program, 4, {
        "twod": ((M.rows, M.cols, M.vals, M.shape), np.asarray(state.H),
                 np.asarray(state.bed), cfg.nx, cfg.ny, cfg.dx, cfg.dy, fE),
        "dryrun": True})


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    return shared_spawn(tmp_path_factory, "parallel8", rank_program, 8,
                        {"halo": HALO, "builds": build_cases()})


def world(request, n):
    return request.getfixturevalue(f"ranks{n}")


# -- halo ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 8])
def test_halo_rows_and_cols_match_shard_map(request, n):
    """Ghost rows and columns of every rank, widths 1 and 2, bit for bit
    the JAX package's halo exchange inside its shard_map
    (tests/test_parallel.py:44), and the padded blocks the single-rank
    lattice's edge padding."""
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from icebin_tpu.parallel.halo import (halo_exchange_cols,
                                          halo_exchange_rows)
    from icebin_tpu.parallel.mesh import ICE_AXIS, make_mesh
    res = world(request, n)
    mesh = make_mesh(n)
    x = jnp.asarray(HALO)
    for w in (1, 2):
        rows = shard_map(lambda b: halo_exchange_rows(b, w, ICE_AXIS),
                         mesh=mesh, in_specs=P(ICE_AXIS),
                         out_specs=P(ICE_AXIS), check_vma=False)(x)
        cols = shard_map(lambda b: halo_exchange_cols(b, w, ICE_AXIS),
                         mesh=mesh, in_specs=P(None, ICE_AXIS),
                         out_specs=P(None, ICE_AXIS), check_vma=False)(x.T)
        got_r = np.concatenate([r["halo_rows"][w] for r in res], axis=0)
        got_c = np.concatenate([r["halo_cols"][w] for r in res], axis=1)
        np.testing.assert_array_equal(got_r, np.asarray(rows))
        np.testing.assert_array_equal(got_c, np.asarray(cols))
        if w == 1:
            ny_l = HALO.shape[0] // n
            padded = np.pad(HALO, ((1, 1), (0, 0)), mode="edge")
            for k, r in enumerate(res):
                np.testing.assert_array_equal(
                    r["halo_rows"][1], padded[k * ny_l:(k + 1) * ny_l + 2])


# -- sharded applies ------------------------------------------------------------

@pytest.mark.parametrize("n,ny", [(2, 24), (3, 25)])
def test_sharded_applies(request, n, ny):
    """K2's partials summed across ranks and K1 on each rank's rows, at 2
    ranks and a ragged 3 (25 rows of 256 cells): every rank's E result the
    same bits, both directions within 5e-7 of the f64 oracle and within
    2e-5 of the JAX package's sharded Pallas applies (interpret mode,
    tests/test_parallel_pallas.py:27-59), and a repaired round trip
    conserving mass to 1e-10."""
    import jax.numpy as jnp
    from icebin_tpu.parallel.mesh import make_mesh
    from icebin_tpu.parallel.pallas_spmv import (
        make_sharded_apply_ice, make_sharded_apply_small,
        sharded_pallas_from_weighted)
    from tests.test_pallas_bdt import oracle_ice, oracle_small
    res = [r["applies"] for r in world(request, n)]
    M, (_, _, _, f, g) = apply_case(ny)
    nI, nE = M.shape[1], M.shape[0]
    for r in res[1:]:
        np.testing.assert_array_equal(r["e"], res[0]["e"])
    gi = np.concatenate([r["gi"] for r in res], axis=1)[:, :nI]
    f64 = f.astype(np.float64)
    ref_s = oracle_small(M, f64)
    ref_i = oracle_ice(M, g.astype(np.float64))
    rel = lambda a, b: np.max(np.abs(a - b) / (np.abs(b) + 1e-9))
    assert rel(res[0]["e"], ref_s) < 5e-7
    assert rel(gi, ref_i) < 5e-7

    mesh = make_mesh(n)
    spm = sharded_pallas_from_weighted(mesh, M, small_axis="rows", nv=8,
                                       cells_per_shard=res[0]["cps"])
    fb = spm.ice_to_blocked_global(jnp.asarray(f), nI)
    e_j = np.asarray(spm.template.e3_to_small(
        make_sharded_apply_small(mesh, spm)(fb)))[:, :nE]
    gi_j = np.asarray(spm.blocked_global_to_ice(
        make_sharded_apply_ice(mesh, spm)(
            spm.template.small_to_e3(jnp.asarray(g))), nI))
    assert rel(res[0]["e"], e_j) < 2e-5
    assert rel(gi, gi_j) < 2e-5
    for r in res:
        assert r["round_trip"] < 1e-10
        assert r["round_trip2"] < 1e-10


# -- sharded exchange build -----------------------------------------------------

def port_host_build(specA, specI, maskI):
    from icebin_tpu_torch.grid import Grid, make_exchange_grid
    gI = port_spec(*specI)
    return make_exchange_grid(port_spec(*specA),
                              gI if maskI is None else Grid(gI, mask=maskI),
                              subdiv=1, device=CPU)


@pytest.mark.parametrize("n,case", [(2, "plain"), (8, "plain"),
                                    (8, "masked")])
def test_sharded_build_bit_for_bit(request, n, case):
    """The exchange build with the clip decomposed over ranks (K3's plain
    version here) on every rank bit for bit the port's single-rank build
    (cf. tests/test_sharded_build.py:30), masked and uneven too (54 rows
    over 8 ranks, A windows spanning several ranks; :54); against the JAX
    package's sharded build (its f64 XLA clip) the same pairs, areas
    within 1e-6 of their ice cell."""
    from icebin_tpu.grid.spec import Grid as RefGrid
    from icebin_tpu.parallel.build import sharded_exchange_grid
    from icebin_tpu.parallel.mesh import make_mesh
    from tests.helpers import toy_grids
    args = build_cases()[case]
    host = port_host_build(*args)
    for r in world(request, n):
        got = r[f"build_{case}"]
        for k in ("iA", "iI", "area", "centroid"):
            np.testing.assert_array_equal(got[k], getattr(host, k), k)
    specA, specI = (toy_grids((96, 96), (8, 10)) if case == "plain"
                    else toy_grids((60, 54), (4, 5)))
    gI = specI if args[2] is None else RefGrid(specI, mask=args[2])
    ref = sharded_exchange_grid(make_mesh(n), specA, gI, subdiv=1,
                                engine="jax")
    np.testing.assert_array_equal(host.iA, ref.iA)
    np.testing.assert_array_equal(host.iI, ref.iI)
    areasI = specI.cell_areas()[ref.iI]
    assert np.max(np.abs(host.area - ref.area) / areasI) < 1e-6
    if args[2] is not None:
        assert set(np.unique(host.iI)) <= set(np.nonzero(args[2])[0])


# -- the sharded SIA step ---------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
def test_sharded_sia_step_bit_for_bit(request, n):
    """Two steps of the halo-exchanged SIA + enthalpy step on a 25-row
    lattice (ragged at 2 and 3 ranks; melt, calving and clamps active):
    every physical cell's state and fluxes bit for bit the port's
    single-rank step_coupled, as the reference states of its own step
    (icebin_tpu/parallel/coupled.py:164-168); pad rows copy the last real
    row; the clamp books' rank partials add up to the single-rank totals
    (1e-6 of the larger, their f32 sums' order differs)."""
    from icebin_tpu_torch.models.ice_sheet import step_coupled
    res = world(request, n)
    cfg, st, forc = sia_case()
    for k, (smb, ts, ef) in enumerate(forc):
        st, fx = step_coupled(cfg, st, smb, ts, 86400.0 * 30, ef)
        got = {key: np.concatenate([r["sia"][k][key] for r in res])
               for key in ("H", "enth", "runoff", "basal_melt", "calving",
                           "enth_runoff", "enth_calving", "latent_pdd")}
        want = dict(H=st.H, enth=st.enth, runoff=fx.runoff,
                    basal_melt=fx.basal_melt, calving=fx.calving,
                    enth_runoff=fx.enth_runoff,
                    enth_calving=fx.enth_calving, latent_pdd=fx.latent_pdd)
        for key, w in want.items():
            np.testing.assert_array_equal(got[key], w.numpy(), key)
        assert all(r["sia"][k]["pad_ok"] for r in res)
        for key in ("mass_clamp", "enth_clamp"):
            tot = sum(r["sia"][k][key] for r in res)
            ref = float(getattr(fx, key))
            assert abs(tot - ref) <= 1e-6 * max(abs(ref), abs(tot), 1e-30)
    assert float(fx.calving.sum()) > 0 and float(fx.runoff.sum()) > 0


# -- the 2-D decomposition -----------------------------------------------------

def test_2d_step_matches_single_device(ranks4):
    """(2, 2) mesh, tests/test_parallel.py:135's setup (256 x 16 lattice):
    one EvI pack applied both ways, halos on both axes, the E sums over the
    whole mesh; H, fI and fE_out against the single-device JAX step at that
    test's tolerances."""
    import jax.numpy as jnp
    from icebin_tpu.models.ice_sheet import step
    from icebin_tpu.ops.bdt import apply_bdt, apply_bdt_T
    gr, cfg, state, evi, M, fE = twod_setup()
    ny_l, nx_l = cfg.ny // 2, cfg.nx // 2
    H = np.zeros((cfg.ny, cfg.nx))
    fI = np.zeros((2, cfg.ny, cfg.nx))
    for r in ranks4:
        t = r["twod"]
        ys = slice(t["iy"] * ny_l, (t["iy"] + 1) * ny_l)
        xs = slice(t["ix"] * nx_l, (t["ix"] + 1) * nx_l)
        H[ys, xs] = t["H"]
        fI[:, ys, xs] = t["fI"].reshape(2, ny_l, nx_l)
        np.testing.assert_array_equal(t["fE"], ranks4[0]["twod"]["fE"])
    fI_ref = apply_bdt_T(evi, jnp.asarray(fE), scale=True, fill=jnp.nan)
    smb = jnp.where(jnp.isfinite(fI_ref[0]), fI_ref[0], 0.0)
    st_ref = step(cfg, state, smb, 86400.0 * 30)
    np.testing.assert_allclose(H, np.asarray(st_ref.H), atol=1e-5)
    fI_ref0 = np.nan_to_num(np.asarray(fI_ref), nan=0.0)
    np.testing.assert_allclose(fI.reshape(2, -1), fI_ref0, rtol=5e-7,
                               atol=1e-7)
    Hr = np.asarray(st_ref.H).reshape(-1)
    icy = Hr > 1.0
    bed = np.asarray(state.bed).reshape(-1)
    outI = np.stack([np.where(icy, Hr + bed, 0.0), np.where(icy, Hr, 0.0),
                     icy.astype(np.float32)])
    fE_ref = np.asarray(apply_bdt(evi, jnp.asarray(outI), scale=True,
                                  fill=jnp.nan))
    a = ranks4[0]["twod"]["fE"]
    ok = np.isfinite(fE_ref)
    np.testing.assert_array_equal(np.isfinite(a), ok)
    np.testing.assert_allclose(a[ok], fE_ref[ok], rtol=5e-7, atol=1e-4)


# -- the mesh's own contract --------------------------------------------------

def test_global_and_replicated_fields(ranks2):
    """global_field scatters rank 0's y-blocks (each rank its own),
    replicated_field broadcasts rank 0's array, local_ice_range cuts
    contiguous ranges."""
    blocks = np.concatenate([r["fields"]["block"] for r in ranks2])
    np.testing.assert_array_equal(blocks, HALO)
    for k, r in enumerate(ranks2):
        np.testing.assert_array_equal(r["fields"]["repl"], HALO)
        assert r["fields"]["range"] == (500 * k, 500 * (k + 1))


@pytest.mark.parametrize("n,path", [(3, "1-D"), (4, "2-D")])
def test_dryrun(request, n, path):
    """parallel/dryrun.py (``__graft_entry__.py:76``'s twin) on 3 ranks
    (the 1-D demonstration step) and 4 (the 2-D one): the demonstration
    step, the sharded applies, a mesh coupler step with a regeneration and
    a window of 3, each transport identity < 1e-10."""
    for r in request.getfixturevalue(f"ranks{n}"):
        d = r["dryrun"]
        assert (d["ranks"], d["step"]) == (n, path)
        assert d["transport"] < 1e-10

def test_nccl_needs_a_device_per_rank():
    """NCCL with more ranks than this host's CUDA devices raises before
    any rank starts (here: no CUDA device at all), and on the CPU; gloo
    takes the CPU."""
    from icebin_tpu_torch.parallel.mesh import rank_device
    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="nccl"):
        launch(rank_program, n_dev + 1, backend="nccl", device="cuda",
               args=({},))
    with pytest.raises(ValueError, match="nccl"):
        rank_device("nccl", "cpu", 1, 0)
    assert rank_device("gloo", "cpu", 4, 3) == CPU
