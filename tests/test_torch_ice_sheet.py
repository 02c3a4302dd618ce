"""Port's SIA ice model (icebin_tpu_torch.models.ice_sheet) vs the reference
(icebin_tpu.models.ice_sheet) on the same seeded forcing.

Three coupled steps on a 48x48 dome with PDD melt (tsurf), a column energy
input (enth_flux) and margin calving all on.  Tolerances: with f64 state
both models evaluate the same expressions in the same order, so they agree
to 1e-10 relative (summation-order round-off only); with f32 state the
substep loop amplifies single-ulp differences in reductions (the CFL
maximum, the clamp sums), so they agree to 1e-5 of each field's scale.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icebin_tpu.models import ice_sheet as ref

from icebin_tpu_torch.models import ice_sheet as port

# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch from contending with the other workers for the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = {"float64": 1e-10, "float32": 1e-5}


def forcing(cfg, seed=0):
    """(smb [kg m-2 s-1], tsurf [K], enth_flux [W m-2]) as flat numpy."""
    rng = np.random.default_rng(seed)
    n = cfg.nx * cfg.ny
    y, x = np.meshgrid(np.arange(cfg.ny), np.arange(cfg.nx), indexing="ij")
    r = np.hypot(x - (cfg.nx - 1) / 2, y - (cfg.ny - 1) / 2) / (cfg.nx / 2)
    smb = (0.3 - 0.6 * r.reshape(-1)) / (365.2425 * 86400) * ref.RHO_ICE
    smb += 1e-6 * rng.uniform(-1, 1, n)
    tsurf = 262.0 + 16.0 * r.reshape(-1) + rng.uniform(-1, 1, n)  # warm margin
    enth = 0.06 + 2.0 * rng.uniform(0, 1, n)
    return smb, tsurf, enth


def close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err < tol, f"{what}: {err:.3e} >= {tol:.0e}"


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_step_coupled_matches_reference(dtype):
    kw = dict(nx=48, ny=48, dx=20e3, dy=20e3, calv_thk=400.0, dtype=dtype)
    cfg_j, cfg_t = ref.IceSheetConfig(**kw), port.IceSheetConfig(**kw)
    st_j = ref.init_state(cfg_j, dome_height=2500.0)
    st_t = port.init_state(cfg_t, device=CPU, dome_height=2500.0)
    close(st_t.H, st_j.H, 1e-15 if dtype == "float64" else 1e-7, "H0")
    dt = 86400.0 * 30
    tol = TOL[dtype]
    for k in range(3):
        smb, ts, ef = forcing(cfg_j, seed=k)
        st_j, fx_j = ref.step_coupled(cfg_j, st_j, jnp.asarray(smb),
                                      jnp.asarray(ts), dt, jnp.asarray(ef))
        st_t, fx_t = port.step_coupled(cfg_t, st_t, torch.as_tensor(smb),
                                       torch.as_tensor(ts), dt,
                                       torch.as_tensor(ef))
        assert st_t.H.dtype == cfg_t.torch_dtype
        assert st_t.t.dtype == torch.float64
        close(st_t.H, st_j.H, tol, f"H step {k}")
        close(st_t.enth, st_j.enth, tol, f"enth step {k}")
        assert float(st_t.t) == float(st_j.t)
        for name in port.IceFluxes._fields:
            close(getattr(fx_t, name), getattr(fx_j, name), tol,
                  f"{name} step {k}")
    # every ablation path actually ran
    assert float(fx_t.runoff.max()) > 0
    assert float(fx_t.calving.max()) > 0
    assert float(fx_t.basal_melt.max()) > 0


def test_step_without_ablation_matches_reference():
    """``step`` (no tsurf, no energy input): the reference's legacy path."""
    cfg_j = ref.IceSheetConfig(nx=32, ny=24, dx=20e3, dy=25e3)
    cfg_t = port.IceSheetConfig(nx=32, ny=24, dx=20e3, dy=25e3)
    st_j = ref.init_state(cfg_j)
    st_t = port.init_state(cfg_t, device=CPU)
    smb = np.random.default_rng(3).uniform(-1e-5, 1e-5, 32 * 24)
    for _ in range(2):
        st_j = ref.step(cfg_j, st_j, jnp.asarray(smb), 86400.0 * 90)
        st_t = port.step(cfg_t, st_t, torch.as_tensor(smb), 86400.0 * 90)
    close(st_t.H, st_j.H, 1e-5, "H")
    close(st_t.enth, st_j.enth, 1e-5, "enth")


def test_gradient_edges_match_numpy():
    """The SIA cross-slopes use jnp.gradient (numpy's edge_order=1: central
    inside, one-sided first differences on both edges); torch.gradient's
    default must give the same values, edges included."""
    a = np.random.default_rng(1).normal(size=(7, 9))
    t = torch.as_tensor(a)
    for dim in (0, 1):
        want = np.gradient(a, axis=dim)
        got = torch.gradient(t, dim=dim)[0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    got = torch.gradient(t, dim=0)[0].numpy()
    np.testing.assert_allclose(got[0], a[1] - a[0], atol=1e-15)
    np.testing.assert_allclose(got[-1], a[-1] - a[-2], atol=1e-15)


@pytest.mark.parametrize("fn", ["sia_flux_div_ghosted",
                                "sia_flux_div_energy_ghosted"])
def test_flux_divergences_match_reference(fn):
    """The ghosted SIA divergences (and the CFL diffusivity) on a padded
    f64 dome with a rough bed: same expressions, f64 round-off apart."""
    rng = np.random.default_rng(5)
    cfg = ref.IceSheetConfig(nx=30, ny=20, dx=10e3, dy=12e3, dtype="float64")
    st = ref.init_state(cfg, bed=rng.uniform(-50, 300, (20, 30)))
    pad = lambda a: np.pad(np.asarray(a), 1, mode="edge")
    Hg, bg = pad(st.H), pad(st.bed)
    Ug = pad(st.enth) * rng.uniform(0.5, 1.5, Hg.shape)
    args = [Hg, bg + Hg] + ([Ug] if fn.endswith("energy_ghosted") else [])
    want = getattr(ref, fn)(*map(jnp.asarray, args), cfg.dx, cfg.dy)
    got = getattr(port, fn)(*map(torch.as_tensor, args), cfg.dx, cfg.dy)
    assert len(got) == len(want)
    for g, w, name in zip(got, want, ("div", "divE/Dmax", "Dmax")):
        close(g, w, 1e-12, name)
