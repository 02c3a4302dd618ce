"""The port's ModelE boundary against the reference's
(tests/test_modele_adapter.py): layout permutations and Fortran marshalling,
``ModelEAdapter.couple_native`` (two ranks' multivecs) and ``topo()`` on the
toy grids of ``make_adapter``, the gcmce shim driven from Python, and the
port's gcmce_* C ABI built with g++ and loaded by ctypes.  The multivec
copy itself is held bit for bit in tests/test_torch_host.py.

Tolerances: the layout functions are copies, so they agree bit for bit; coupled outputs, TOPO fields and held state are held to
tests/test_torch_coupler.py's 1e-5 of each row's scale, for its reasons
(the port's exchange grid comes from its f32 clip, its applies sum f32
values in f64 and its f32 ice model amplifies single-ulp differences).
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icebin_tpu.coupler.coupler import CouplerConfig as RefConfig
from icebin_tpu.grid import proj as ref_proj, spec as ref_spec
from icebin_tpu.models import modele_adapter as ref_ad
from icebin_tpu.regrid.gcmregridder import GCMRegridder as RefRegridder

import icebin_tpu_torch as port
from icebin_tpu_torch.grid import proj as port_proj, spec as port_spec
from icebin_tpu_torch.models import gcmce_shim
from icebin_tpu_torch.models import modele_adapter as port_ad

from test_torch_coupler import FIELD_TOL, close

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
SCALE = 25e3
HCDEFS = [0.0, 800.0, 2500.0]
DT = 86400.0 * 30
REGEN = 2


def toy_specs(spec, proj):
    """``make_adapter``'s grids (tests/test_modele_adapter.py:71-76), in
    ``spec``/``proj``'s package."""
    specA = spec.GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                                latb=np.linspace(30.0, 80.0, 6))
    specI = spec.GridSpecXY(xb=np.linspace(0.0, 40.0 * SCALE, 31),
                            yb=np.linspace(30.0 * SCALE, 80.0 * SCALE, 31),
                            projection=proj.PlateCarree(scale=SCALE))
    return specA, specI


def make_ref():
    specA, specI = toy_specs(ref_spec, ref_proj)
    gr = RefRegridder(specA, hcdefs=HCDEFS)
    gr.add_sheet("s", specI, subdiv=1, engine="numpy")
    return ref_ad.ModelEAdapter(gr, RefConfig(dt=DT, regen_every=REGEN,
                                              matrix_dtype=jnp.float64))


def make_port(device=CPU):
    specA, specI = toy_specs(port_spec, port_proj)
    gr = port.GCMRegridder(specA, HCDEFS, device=device)
    gr.add_sheet("s", specI, subdiv=1)
    return port_ad.ModelEAdapter(
        gr, port.CouplerConfig(dt=DT, regen_every=REGEN), device=device)


# -- layout and wire format: copies, bit for bit ----------------------------

@pytest.mark.parametrize("shape", [(18,), (2, 18), (3, 2, 18)])
def test_E_layout_permutations_match_reference(shape):
    f = np.random.default_rng(len(shape)).uniform(size=shape)
    for name in ("to_modele_E", "from_modele_E"):
        np.testing.assert_array_equal(getattr(port_ad, name)(f, 6, 3),
                                      getattr(ref_ad, name)(f, 6, 3))
    np.testing.assert_array_equal(
        port_ad.from_modele_E(port_ad.to_modele_E(f, 6, 3), 6, 3), f)


def test_fortran_marshalling_matches_reference():
    im, jm, nhc = 4, 3, 2
    c_view = np.random.default_rng(0).uniform(size=(nhc, jm, im))
    flat = port_ad.fortran_ijh_to_flatE(c_view, im * jm, nhc)
    np.testing.assert_array_equal(
        flat, ref_ad.fortran_ijh_to_flatE(c_view, im * jm, nhc))
    back = port_ad.flatE_to_fortran_ijh(flat, im, jm, nhc)
    np.testing.assert_array_equal(
        back, ref_ad.flatE_to_fortran_ijh(flat, im, jm, nhc))
    np.testing.assert_array_equal(back, c_view)
    with pytest.raises(ValueError):
        port_ad.fortran_ijh_to_flatE(c_view[0], im * jm, nhc)
    with pytest.raises(ValueError):
        port_ad.fortran_ijh_to_flatE(c_view, im * jm + 1, nhc)


# -- the adapter against the reference --------------------------------------

def forcing_modele(nA, nhc, seed):
    """(8, nE) GCM forcing in ModelE's ihc-major layout."""
    rng = np.random.default_rng(seed)
    f = np.zeros((8, nA * nhc))
    f[0] = 1e-5 * rng.uniform(0.5, 1.0, nA * nhc)
    f[1] = 5.0
    f[4] = -5.0
    return port_ad.to_modele_E(f, nA, nhc)


@pytest.fixture(scope="module")
def adapters():
    """Both adapters through 3 steps (a regeneration after step 2) fed by
    two 'ranks', each owning half the E cells, with GCM-held state."""
    aj, at = make_ref(), make_port()
    nA, nhc = at.nA, at.nhc
    nE = nA * nhc
    held = np.random.default_rng(9).uniform(0.5, 2.0, (2, nE))
    aj.set_held_state("s", held)
    at.set_held_state("s", held)
    for a in (aj, at):
        a.set_start_time(0.0)
    steps = []
    for k in range(REGEN + 1):
        f = forcing_modele(nA, nhc, seed=k)
        half = nE // 2
        out = []
        for a in (aj, at):
            a.add_rank_output(np.arange(half), f[:, :half])
            a.add_rank_output(np.arange(half, nE), f[:, half:])
            out.append(a.couple_native(float(k))["s"])
        steps.append(out)
    return aj, at, steps


def test_couple_native_matches_reference(adapters):
    aj, at, steps = adapters
    for k, (oj, ot) in enumerate(steps):
        assert ot["fE_out_modele"].shape == (10, at.gr.nE)
        for key in ("fE_out_modele", "fA_out", "fhc", "elevE"):
            close(ot[key], oj[key], FIELD_TOL, f"{key} step {k}")
    for r in at.coupler.ledger.to_rows():
        assert abs(r["s.mass_in_E"] - r["s.mass_delivered_I"]) < (
            1e-10 * abs(r["s.mass_in_E"]))


def test_topo_matches_reference(adapters):
    aj, at, _ = adapters
    (fj, ej, uj), (fp, ep, up) = aj.topo(), at.topo()
    assert fp.shape == (at.nhc,) + at.gr.specA.shape[::-1]
    for got, want, what in ((fp, fj, "fhc"), (ep, ej, "elevE")):
        close(got.reshape(at.nhc, -1), want.reshape(at.nhc, -1), FIELD_TOL,
              what)
    np.testing.assert_array_equal(up, uj)
    s = fp.sum(axis=0)
    np.testing.assert_allclose(s[s > 0], 1.0, rtol=1e-12)


def test_held_state_through_e1ve0_matches_reference(adapters):
    aj, at, _ = adapters
    rows = at.coupler.ledger.to_rows()
    assert "s.held_mass" in rows[REGEN - 1]     # remapped at the regeneration
    close(at.held_state("s"), aj.held_state("s"), FIELD_TOL, "held state")


def test_couple_native_rejects_wrong_field_count():
    at = make_port()
    at.add_rank_output(np.arange(4), np.ones((3, 4)))
    with pytest.raises(ValueError):
        at.couple_native(0.0)


# -- the shim from Python, and the C ABI ------------------------------------

def write_config(tmp_path):
    """Grid files and a RunConfig JSON for gcmce_new (the port's writers;
    the reference reads the same schema)."""
    from icebin_tpu_torch.io.ncio import write_grid
    from icebin_tpu_torch.utils.config import RunConfig, SheetConfig
    specA, specI = toy_specs(port_spec, port_proj)
    pa, pi = str(tmp_path / "a.nc"), str(tmp_path / "i.nc")
    write_grid(pa, specA)
    write_grid(pi, specI)
    cfgp = str(tmp_path / "run.json")
    RunConfig(gridA_file=pa, hcdefs=HCDEFS, dt_seconds=DT,
              regen_every=REGEN, sheets=[SheetConfig(
                  name="s", grid_file=pi, subdiv=1)]).to_json(cfgp)
    return cfgp


def test_shim_round_trip_on_cpu(tmp_path):
    """gcmce_* from Python with device='cpu', the buffers as memoryviews as
    the C layer passes them, and overwritten by the caller once each call
    returns: bit for bit an adapter driven directly."""
    h = gcmce_shim.gcmce_new(write_config(tmp_path), device="cpu")
    try:
        assert gcmce_shim.gcmce_dims(h) == (6, 5, 3)
        gcmce_shim.gcmce_set_start_time(h, 0.0)
        direct = make_port()
        nE = direct.gr.nE
        f = forcing_modele(direct.nA, direct.nhc, seed=0)
        half = nE // 2
        for lo, hi in ((0, half), (half, nE)):
            idx = np.arange(lo, hi, dtype=np.int64)
            vals = np.ascontiguousarray(f[:, lo:hi])
            gcmce_shim.gcmce_add_gcm_outpute(h, memoryview(idx),
                                             memoryview(vals), hi - lo, 8)
            direct.add_rank_output(idx.copy(), vals.copy())
            idx[:], vals[:] = 0, np.nan     # the GCM reuses its buffers
        fhc, elevE = np.zeros(nE), np.zeros(nE)
        under = np.zeros(nE, np.int32)
        assert gcmce_shim.gcmce_couple_native(
            h, 0.0, memoryview(fhc), memoryview(elevE),
            memoryview(under)) == 0
        direct.couple_native(0.0)
        want = direct.topo()
        for got, w in zip((fhc, elevE, under), want):
            np.testing.assert_array_equal(got, w.reshape(-1))
        ad = gcmce_shim._handles[h]
        assert ad.coupler.ledger.to_rows() == direct.coupler.ledger.to_rows()
        assert torch.equal(ad.coupler.sheets["s"].state.H,
                           direct.coupler.sheets["s"].state.H)
        s = fhc.reshape(3, 5, 6).sum(axis=0)
        assert (np.abs(s[s > 0] - 1.0) < 1e-9).all()
    finally:
        gcmce_shim.gcmce_delete(h)
    assert h not in gcmce_shim._handles


def _exports(path):
    """{name: normalised signature} of a .cc file's extern "C" functions."""
    body = Path(path).read_text().split('extern "C" {', 1)[1]
    sigs = re.findall(r"^(\w[\w\s\*]*?)\b(gcmce_\w+)\(([^)]*)\)\s*\{", body,
                      flags=re.M)
    return {name: (" ".join(ret.split()), " ".join(args.split()))
            for ret, name, args in sigs}


def test_c_abi_matches_reference_exports():
    """A GCM relinks without a source change: the same gcmce_* functions
    with the same signatures as native/gcmce.cc, forwarding to the port's
    shim and not the reference's."""
    ours = ROOT / "icebin_tpu_torch" / "native" / "gcmce.cc"
    theirs = _exports(ROOT / "native" / "gcmce.cc")
    assert len(theirs) == 6
    assert _exports(ours) == theirs
    src = ours.read_text()
    assert '"icebin_tpu_torch.models.gcmce_shim"' in src
    assert '"icebin_tpu.' not in src


def test_c_abi_builds_and_refuses_the_cpu(tmp_path):
    """The C ABI builds here with g++ and loads through ctypes; gcmce_new
    asks for the card, so without one it returns a negative handle and
    registers no coupler (nothing runs on the CPU)."""
    from icebin_tpu_torch.ops._build_gcmce import gcmce_library
    lib = ctypes.CDLL(str(gcmce_library()))
    lib.gcmce_new.restype = ctypes.c_int
    before = dict(gcmce_shim._handles)
    h = lib.gcmce_new(write_config(tmp_path).encode())
    if torch.cuda.is_available():
        assert h > 0
        lib.gcmce_delete(h)
        return
    assert h < 0
    assert gcmce_shim._handles == before
    im, jm, nhc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    assert lib.gcmce_dims(h, ctypes.byref(im), ctypes.byref(jm),
                          ctypes.byref(nhc)) == -1


def test_c_abi_builder_raises_with_the_compiler_output(tmp_path,
                                                       monkeypatch):
    """A source that does not compile raises with g++'s message; no library
    is left behind (the reference's builder returns None instead)."""
    from icebin_tpu_torch.ops import _build_gcmce
    bad = tmp_path / "gcmce.cc"
    bad.write_text("int gcmce_new(const char* p) { return missing; }\n")
    monkeypatch.setattr(_build_gcmce, "SOURCE", bad)
    monkeypatch.setattr(_build_gcmce, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="missing"):
        _build_gcmce.gcmce_library()
    assert not list((tmp_path / "build").rglob("*.so"))


def test_shim_refuses_cuda_without_a_card(tmp_path):
    """The shim's default device is the card: without one it raises."""
    cfg = write_config(tmp_path)
    if torch.cuda.is_available():
        gcmce_shim.gcmce_delete(gcmce_shim.gcmce_new(cfg))
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gcmce_shim.gcmce_new(cfg)
