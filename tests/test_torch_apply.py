"""Port's regrid applies (icebin_tpu_torch.ops) vs the reference's Pallas
applies (icebin_tpu.ops.pallas_bdt, interpret mode on the CPU) on the same
seeded inputs.

Tolerance 2e-5 relative, the reference suite's own bound for its f32
applies (tests/test_pallas_bdt.py): both sides round inputs to f32, and the
reference runs in its accurate mode (passes=6, precision HIGHEST, ~1e-7
raw), the one the port's f64-summing kernels correspond to.
The raw accuracy contract against the f64 oracle is 5e-7
(tests/test_accuracy_contract.py BOUND_6PASS).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from icebin_tpu.ops import pallas_bdt as ref
from icebin_tpu.regrid.matrices import RegridParams
from icebin_tpu.regrid.sparse import WeightedMatrix

from icebin_tpu_torch.ops.apply import (apply_ice, apply_ice_ref,
                                        apply_small, apply_small_ref,
                                        apply_view, spmm_dest_ice,
                                        spmm_dest_small,
                                        spmm_dest_small_ref, spmm_ref)
from icebin_tpu_torch.ops.csr import csr_pack, csr_view_pair
from icebin_tpu_torch.regrid.sparse import WeightedMatrix as PortMatrix

from helpers import toy_elevmask, toy_regridder

# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch from contending with the other workers for the cores
torch.set_num_threads(1)

TOL = 2e-5
CPU = torch.device("cpu")


def synth(nx=256, ny=24, ratio=16, nhc=3, seed=0):
    """EvI-shaped synthetic matrix (same generator as the reference's
    tests/test_pallas_bdt.py)."""
    rng = np.random.default_rng(seed)
    nI = nx * ny
    ii = np.arange(nI)
    ix, iy = ii % nx, ii // nx
    nxa = -(-nx // ratio)
    a = (iy // ratio) * nxa + ix // ratio
    nA = nxa * (-(-ny // ratio))
    elev = rng.uniform(0, 3400, nI)
    hc = np.linspace(0, 3500, nhc)
    k = np.clip(np.searchsorted(hc, elev) - 1, 0, nhc - 2)
    t = (elev - hc[k]) / np.diff(hc)[0]
    area = rng.uniform(20e6, 30e6, nI)
    rows = np.concatenate([a * nhc + k, a * nhc + k + 1])
    cols = np.concatenate([ii, ii])
    vals = np.concatenate([area * (1 - t), area * t])
    keep = rng.uniform(size=len(rows)) > 0.1
    return WeightedMatrix(rows=rows[keep], cols=cols[keep], vals=vals[keep],
                          shape=(nA * nhc, nI))


def to_port(M):
    """The port's own WeightedMatrix of a reference one, from the same
    numbers (the two packages' classes are distinct)."""
    return PortMatrix(rows=M.rows, cols=M.cols, vals=M.vals, shape=M.shape)


def rel_err(got, want, scale=None):
    """Max |got - want| over ``scale`` (default |want|): the magnitude the
    f32 rounding of each output is relative to."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want) if scale is None else np.asarray(scale)
    return np.max(np.abs(got - want) / (scale + 1e-9))


def both_directions(M, pm, pack, nvar, seed, scale=True):
    """(port, reference) outputs of apply_small and apply_ice."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.5, 1.5, (nvar, M.shape[1]))
    f[0, ::7] = np.nan                       # masked sources count as 0
    g = rng.uniform(0.5, 1.5, (nvar, M.shape[0]))
    g[-1, ::5] = np.inf
    out = []
    for fn_t, fn_j, x in ((apply_small, ref.apply_small, f),
                          (apply_ice, ref.apply_ice, g)):
        got = fn_t(pack, torch.as_tensor(x, dtype=torch.float32),
                   scale=scale)
        want = fn_j(pm, jnp.asarray(x, jnp.float32), scale=scale, passes=6)
        out.append((got.numpy(), np.asarray(want)))
    return out


@pytest.mark.parametrize("nv,nvar", [(8, 8), (8, 10), (16, 10), (16, 18)])
def test_applies_match_reference(nv, nvar):
    """Both directions, NaN/inf sources, field counts below, at and above
    the pack width (wider inputs run in nv-wide groups)."""
    M = synth(seed=7)
    pm = ref.pallas_from_weighted(M, small_axis="rows", nv=nv)
    pack = csr_pack(to_port(M), small_axis="rows", nv=nv, device=CPU)
    for got, want in both_directions(M, pm, pack, nvar, seed=nv + nvar):
        assert got.shape == want.shape
        assert rel_err(got, want) < TOL


def test_unscaled_and_overflow_pack():
    """scale=False, against a reference pack whose tile cap demotes
    entries to its COO overflow epilogue (max_tiles_per_block=2)."""
    M = synth()
    pm = ref.pallas_from_weighted(M, small_axis="rows", nv=8,
                                  max_tiles_per_block=2)
    assert pm.ov_s is not None and pm.ov_s.size > 0
    pack = csr_pack(to_port(M), small_axis="rows", nv=8, device=CPU)
    for scale in (True, False):
        for got, want in both_directions(M, pm, pack, 8, seed=3,
                                         scale=scale):
            assert rel_err(got, want) < TOL


def test_dest_small_f64_sums_round_to_the_f32_apply():
    """apply_small and the K2-order plain version with f64 outputs (a mesh
    rank's partials) keep the sums unrounded: rounded to f32 they are the
    f32 apply bit for bit, scaled and not; other dtypes are refused."""
    M = to_port(synth(seed=9))
    pack = csr_pack(M, small_axis="rows", nv=8, device=CPU)
    f = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (11, M.shape[1])).astype(np.float32))
    x = f[:8].t().contiguous()
    for scale in (True, False):
        got = apply_small(pack, f, scale, dtype=torch.float64)
        assert got.dtype == torch.float64
        assert torch.equal(got.float(), apply_small(pack, f, scale))
        k2 = spmm_dest_small_ref(pack.small, x, scale, dtype=torch.float64)
        assert k2.dtype == torch.float64
        assert torch.equal(k2.float(),
                           spmm_dest_small_ref(pack.small, x, scale))
    with pytest.raises(ValueError, match="float32 or float64"):
        spmm_dest_small(pack.small, x, dtype=torch.float16)


def test_apply_view_fill_and_unit_conversion():
    """apply_view: zero-weight destinations get ``fill``; var_factor then
    var_offset apply after the scale; 1-D fields keep their shape."""
    M = synth(seed=5)
    # an E row with no entries: zero weight, so it must come back as fill
    keep = M.rows != M.rows[0]
    M = WeightedMatrix(rows=M.rows[keep], cols=M.cols[keep],
                       vals=M.vals[keep], shape=M.shape)
    vj_f, vj_r = ref.pallas_view_pair(M, small_axis="rows", nv=16)
    vt_f, vt_r = csr_view_pair(to_port(M), nv=16, device=CPU)
    rng = np.random.default_rng(4)
    fac = rng.uniform(0.5, 2.0, 4)
    off = rng.uniform(-5.0, 5.0, 4)
    for vt, vj, n_src in ((vt_f, vj_f, M.shape[1]), (vt_r, vj_r, M.shape[0])):
        assert vt.logical_shape == vj.logical_shape
        np.testing.assert_allclose(vt.wM.numpy(), np.asarray(vj.wM),
                                   rtol=1e-6)
        np.testing.assert_allclose(vt.Mw.numpy(), np.asarray(vj.Mw),
                                   rtol=1e-6)
        f = rng.uniform(0.5, 1.5, (4, n_src))
        for fill in (math.nan, -1.0):
            got = apply_view(vt, torch.as_tensor(f, dtype=torch.float32),
                             var_factor=torch.as_tensor(fac),
                             var_offset=torch.as_tensor(off),
                             fill=fill).numpy()
            want = np.asarray(ref.apply_view(
                vj, jnp.asarray(f, jnp.float32),
                var_factor=jnp.asarray(fac, jnp.float32),
                var_offset=jnp.asarray(off, jnp.float32), fill=fill,
                passes=6))
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            ok = np.isfinite(want)
            # the offset can cancel the scaled value, so each output is
            # held relative to the sum of its terms' magnitudes
            terms = np.abs(want - off[:, None]) + np.abs(off[:, None])
            assert rel_err(got[ok], want[ok], terms[ok]) < TOL
        got1 = apply_view(vt, torch.as_tensor(f[0], dtype=torch.float32))
        assert got1.shape == (vt.logical_shape[0],)
    zero_w = (vt_f.wM == 0).numpy()
    assert zero_w.any()
    assert np.isnan(apply_view(vt_f, torch.ones(M.shape[1]))
                    .numpy()[zero_w]).all()


def test_wide_sparse_e_space():
    """E spaces as wide as global EC: realized rows clustered in two
    buckets of a 40,000-row space (the reference compacts these onto
    per-section kernel calls)."""
    rng = np.random.default_rng(4)
    n_i, n_s = 2048, 40000
    rows = np.concatenate([rng.integers(3 * 4096, 3 * 4096 + 3000, 4000),
                           rng.integers(7 * 4096, 7 * 4096 + 3000, 4000)])
    cols = rng.integers(0, n_i, rows.size)
    vals = rng.uniform(0.1, 2.0, rows.size)
    M = WeightedMatrix(rows=rows, cols=cols, vals=vals, shape=(n_s, n_i))
    pm = ref.pallas_from_weighted(M, small_axis="rows", nv=8, e_sec=512)
    assert pm.nesec == 2
    pack = csr_pack(to_port(M), small_axis="rows", nv=8, device=CPU)
    for got, want in both_directions(M, pm, pack, 8, seed=1):
        assert rel_err(got, want) < TOL


def test_raw_accuracy_contract_vs_f64_oracle():
    """Raw (unrepaired) error on a temperature-like field < 5e-7 of the
    field scale in both directions, on the reference's accuracy-contract
    toy (toy_regridder nI=(96, 96))."""
    gr = toy_regridder(nI=(96, 96))
    rm = gr.regrid_matrices("toy", toy_elevmask(gr.sheets["toy"].specI))
    Me = rm.matrix("EvI", RegridParams(scale=True, correctA=True))
    pack = csr_pack(to_port(Me), small_axis="rows", nv=16, device=CPU)
    rng = np.random.default_rng(0)
    S = sp.coo_matrix((Me.vals, (Me.rows, Me.cols)), shape=Me.shape).tocsr()
    for x, Md, w, apply in ((260.0 + rng.uniform(0, 30, (16, Me.shape[1])),
                             S, Me.wM, apply_small),
                            (260.0 + rng.uniform(0, 30, (16, Me.shape[0])),
                             S.T.tocsr(), Me.Mw, apply_ice)):
        want = np.where(w > 0, (Md @ x.T).T / np.where(w > 0, w, 1.0), 0.0)
        got = apply(pack, torch.as_tensor(x, dtype=torch.float32)).numpy()
        err = np.abs(np.where(w > 0, got, 0.0) - want).max() / np.abs(
            want).max()
        assert err < 5e-7, err


def test_plain_versions_and_wrapper_checks():
    """apply_*_ref are the plain versions the CPU wrappers run (equal
    results); the kernel wrappers reject what the kernels do not take."""
    M = synth(seed=2)
    pack = csr_pack(to_port(M), small_axis="rows", nv=8, device=CPU)
    f = torch.as_tensor(np.random.default_rng(0).uniform(
        0.5, 1.5, (8, M.shape[1])), dtype=torch.float32)
    assert torch.equal(apply_small(pack, f), apply_small_ref(pack, f))
    g = apply_small(pack, f)
    assert torch.equal(apply_ice(pack, g), apply_ice_ref(pack, g))
    x = f.t().contiguous()
    assert torch.equal(spmm_dest_small(pack.small, x),
                       spmm_ref(pack.small, x))
    with pytest.raises(ValueError):
        spmm_dest_small(pack.small, x.double())       # f64 field
    with pytest.raises(ValueError):
        spmm_dest_ice(pack.ice, x)                     # wrong source size
    with pytest.raises(ValueError):
        spmm_dest_small(pack.small, f.t())             # not contiguous
    with pytest.raises(ValueError):
        spmm_dest_small(pack.small, x.to("meta"))      # foreign device
