"""The stage-2 regrid kernels' plain versions and packing on the CPU
(icebin_tpu_torch.ops.apply, ops.csr, tools.sweep_spmm); the CUDA kernels
are held to them bit for bit on the card (tests/test_torch_cuda.py).

* The dest-small kernel (K2) sums in its own order (csrc/spmm.cu's header):
  its plain version ``spmm_dest_small_ref`` is held to the port's f64
  ``spmm_ref`` within one f32 ulp (both sum exact f64 products and round
  once, in different orders), to the JAX package's ``apply_small``
  (interpret mode) within 2e-5 relative (tests/test_torch_apply.py's bound
  for the reference's split-bf16 products), and bit for bit to a scalar
  numpy evaluation of the stated order on ``probe_k2.order_case``'s
  cancelling data, on which that order gives other bits than the stage-1
  order (checked).
* The pack's live-row list (longest first) and K2's slices, also for a CSR
  made by ``dataclasses.replace``, which must derive its own.
* The dest-ice kernel (K1) now runs ``apply_ice`` in the (nv, n) layout:
  against the JAX package's ``apply_ice`` within 2e-5, and bit for bit the
  row-major path the stage-1 ``apply_ice`` took (a transposed copy in, a
  transposed view out).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icebin_tpu.ops import pallas_bdt as ref
from icebin_tpu.regrid.sparse import WeightedMatrix as RefMatrix

from icebin_tpu_torch.ops import apply as ap
from icebin_tpu_torch.ops.apply import (apply_ice, apply_ice_ref,
                                        spmm_dest_ice, spmm_dest_small,
                                        spmm_dest_small_ref, spmm_ref)
from icebin_tpu_torch.ops.csr import csr_from_coo, csr_pack
from icebin_tpu_torch.ops.k2probe import spmm_small_slots_ref
from icebin_tpu_torch.tools import probe_k2, sweep_spmm

torch.set_num_threads(1)

TOL = 2e-5
CPU = torch.device("cpu")


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want) / (np.abs(want) + 1e-9))


def as_ref(M):
    return RefMatrix(rows=M.rows, cols=M.cols, vals=M.vals, shape=M.shape)


def with_empty_rows(M):
    """``M`` (probe_k2.synth: one row of 600 nonzeros) without its rows
    0-4, which then have zero weight."""
    from icebin_tpu_torch.regrid.sparse import WeightedMatrix
    keep = M.rows >= 5
    return WeightedMatrix(rows=M.rows[keep], cols=M.cols[keep],
                          vals=M.vals[keep], shape=M.shape)


@pytest.fixture(scope="module")
def small_case():
    M = with_empty_rows(probe_k2.synth(seed=3))
    pm = ref.pallas_from_weighted(as_ref(M), small_axis="rows", nv=16)
    return M, pm, csr_pack(M, nv=16, device=CPU).small


@pytest.mark.parametrize("nv", [1, 8, 16, 18, 40])
def test_stage2_plain_matches_spmm_ref_and_jax(small_case, nv):
    """spmm_dest_small_ref within one f32 ulp of spmm_ref and within 2e-5
    of the JAX package's apply_small, with NaN and inf sources, empty rows,
    scale on and off."""
    M, pm, csr = small_case
    assert csr.n_live < csr.n_dst                       # empty rows
    x = probe_k2.fields(M.shape[1], nv, seed=nv)
    xt = torch.as_tensor(x)
    for scale in (True, False):
        got = spmm_dest_small_ref(csr, xt, scale)
        want = spmm_ref(csr, xt, scale)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert np.all(np.abs(got.numpy() - want.numpy())
                      <= np.spacing(np.abs(want.numpy())))
        jx = np.asarray(ref.apply_small(pm, jnp.asarray(x.T), scale=scale,
                                        passes=6)).T
        assert rel_err(got.numpy(), jx) < TOL
    empty = (csr.rowptr[1:] == csr.rowptr[:-1])
    out = spmm_dest_small_ref(csr, xt)
    assert not torch.signbit(out[empty]).any() and not out[empty].any()


def numpy_stage2(csr, x, warps, scale=True):
    """The stated order of the dest-small kernel, scalar by scalar in
    np.float64: slices, lane groups, k, then the fixed combine."""
    rowptr, cols = csr.rowptr.numpy(), csr.cols.numpy()
    vals, winv = csr.vals.numpy(), csr.winv.numpy()
    nv = x.shape[1]
    out = np.zeros((csr.n_dst, nv), np.float32)
    vw = 4 if nv % 4 == 0 else 2 if nv % 2 == 0 else 1
    for r in range(csr.n_dst):
        k0, k1 = int(rowptr[r]), int(rowptr[r + 1])
        n = k1 - k0
        if n == 0:
            continue
        for f0 in range(0, nv, 32 * vw):
            pw = min(32 * vw, nv - f0)
            g = 1
            while g < pw // vw:
                g *= 2
            ng = 32 // g
            for v in range(f0, f0 + pw):
                slices = []
                for w in range(warps):
                    a, b = k0 + n * w // warps, k0 + n * (w + 1) // warps
                    groups = []
                    for grp in range(ng):
                        acc = np.float64(0.0)
                        for k in range(a + grp, b, ng):
                            c = x[cols[k], v]
                            c = c if np.isfinite(c) else np.float32(0.0)
                            acc = acc + np.float64(vals[k]) * np.float64(c)
                        groups.append(acc)
                    t = groups[0]
                    for p in groups[1:]:
                        t = t + p
                    slices.append(t)
                t = slices[0]
                for p in slices[1:]:
                    t = t + p
                out[r, v] = np.float32(t * np.float64(winv[r]) if scale
                                       else t)
    return out


@pytest.mark.parametrize("nv", [1, 5, 20, 136])
def test_stage2_plain_follows_its_stated_order(nv):
    """Bit for bit the scalar evaluation on cancelling data (rows longer
    than 8 slices of 32 lanes; at nv = 136 two passes over the fields), at
    several slice counts; and not the stage-1 order's bits."""
    csr, x = probe_k2.order_case(nv, nv, n_dst=8, long_rows=(90, 300))
    xt = torch.as_tensor(x)
    for warps in (1, 3, 8):
        for scale in (True, False):
            got = spmm_dest_small_ref(csr, xt, scale, warps).numpy()
            want = numpy_stage2(csr, x, warps, scale)
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), (
                warps, scale)
    stage1 = spmm_small_slots_ref(csr, xt, 1)
    assert not torch.equal(spmm_dest_small_ref(csr, xt), stage1)


def test_live_list_and_slices_from_csr_from_coo():
    """csr_from_coo lists the non-empty rows longest first (ties by row),
    and K2's slices cut each into even, contiguous pieces."""
    csr, _ = probe_k2.order_case(0, 1, n_dst=12, long_rows=(45, 70))
    lens = (csr.rowptr[1:] - csr.rowptr[:-1]).tolist()
    want = sorted((r for r in range(csr.n_dst) if lens[r]),
                  key=lambda r: (-lens[r], r))
    assert csr.live.dtype == torch.int32
    assert csr.live.tolist() == want and csr.n_live == len(want)
    for warps in (1, 4, 8):
        sl = ap.small_slices(csr, warps)
        assert sl.shape == (csr.n_live, warps + 1)
        for i, r in enumerate(want):
            k0, n = int(csr.rowptr[r]), lens[r]
            assert sl[i].tolist() == [k0 + n * s // warps
                                      for s in range(warps + 1)]
            assert bool((sl[i, 1:] >= sl[i, :-1]).all())


def test_live_list_rederived_for_replaced_csr():
    """A CSR made by dataclasses.replace (probe_k2's live-row sub-CSR)
    derives its own live list from its rowptr, never the parent's."""
    csr, x = probe_k2.order_case(1, 4, n_dst=12)
    rows = torch.nonzero(csr.rowptr[1:] > csr.rowptr[:-1]).squeeze(1)
    sub = dataclasses.replace(
        csr, rowptr=torch.cat([csr.rowptr[rows], csr.rowptr[-1:]]),
        winv=csr.winv[rows], n_dst=rows.numel())
    lens = (sub.rowptr[1:] - sub.rowptr[:-1]).tolist()
    assert sub.n_live == sub.n_dst == rows.numel() < csr.n_dst
    assert sub.live.tolist() == sorted(range(sub.n_dst),
                                       key=lambda r: (-lens[r], r))
    assert int(sub.live.max()) < sub.n_dst
    # on its live rows the order of each row is the whole CSR's
    xt = torch.as_tensor(x)
    assert torch.equal(spmm_dest_small_ref(sub, xt),
                       spmm_dest_small_ref(csr, xt)[rows])


@pytest.mark.parametrize("nv,nvar", [(8, 10), (16, 18)])
def test_apply_ice_fields_path_matches_jax(nv, nvar):
    """apply_ice through the (nv, n) layout against the JAX package's
    apply_ice (as tests/test_torch_apply.py runs it), NaN and inf sources,
    field counts below, at and above the pack width."""
    M = probe_k2.synth(seed=nv)
    pm = ref.pallas_from_weighted(as_ref(M), small_axis="rows", nv=nv)
    pack = csr_pack(M, small_axis="rows", nv=nv, device=CPU)
    g = np.random.default_rng(nvar).uniform(0.5, 1.5, (nvar, M.shape[0]))
    g[-1, ::5] = np.inf
    g[0, ::7] = np.nan
    for scale in (True, False):
        got = apply_ice(pack, torch.as_tensor(g, dtype=torch.float32),
                        scale=scale)
        want = ref.apply_ice(pm, jnp.asarray(g, jnp.float32), scale=scale,
                             passes=6)
        assert got.shape == want.shape and got.is_contiguous()
        assert rel_err(got.numpy(), np.asarray(want)) < TOL


def test_apply_ice_fields_path_bit_for_bit_the_row_major_path():
    """On the CPU the (nv, n) path gives the row-major path's bits (a
    transposed copy in, K1 on (n, nv), a transposed view out), for 1-D and
    ragged 2-D inputs; spmm_dest_ice on (nv, n_src) is its (n_src, nv)
    result transposed."""
    M = probe_k2.synth(seed=2)
    pack = csr_pack(M, nv=8, device=CPU)
    csr = pack.ice
    f = torch.as_tensor(probe_k2.fields(M.shape[0], 13, seed=1).T.copy())
    old = torch.cat([spmm_ref(csr, f[k:k + 8].t().contiguous()).t()
                     for k in range(0, 13, 8)])
    for fn in (apply_ice, apply_ice_ref):
        assert torch.equal(fn(pack, f), old)
        assert torch.equal(fn(pack, f[3]), old[3])
    x = f[:8].t().contiguous()
    n0 = spmm_dest_ice.launches
    got = spmm_dest_ice(csr, f[:8].contiguous(), fields=True)
    assert spmm_dest_ice.launches == n0                 # the CPU path
    assert got.is_contiguous() and got.shape == (8, csr.n_dst)
    assert torch.equal(got, spmm_dest_ice(csr, x).t())


def test_wrappers_check_the_layout():
    """spmm_dest_ice(fields=True) takes (nv, n_src) only; both wrappers run
    their plain versions on CPU tensors without counting a launch."""
    M = probe_k2.synth(seed=4)
    pack = csr_pack(M, nv=8, device=CPU)
    x = torch.ones((pack.ice.n_src, 4))
    for bad in (x, x.t(), x.t().contiguous().double(), x.t()[:, :-1]):
        with pytest.raises(ValueError):
            spmm_dest_ice(pack.ice, bad, fields=True)
    n0 = spmm_dest_small.launches
    xs = torch.ones((pack.small.n_src, 4))
    assert torch.equal(spmm_dest_small(pack.small, xs),
                       spmm_ref(pack.small, xs))
    assert spmm_dest_small.launches == n0


def test_geometry_rule_has_kernel_instances():
    """The launch rule picks geometries the kernels have instances for, at
    the field counts the port runs."""
    csr = csr_pack(probe_k2.synth(), nv=16, device=CPU).small
    for nv in (1, 8, 16, 18, 40, 64, 136):
        warps, unroll = ap.small_geometry(csr, nv)
        assert warps in sweep_spmm.WARPS and unroll in sweep_spmm.UNROLL
        for fields in (False, True):
            chunk, min_blocks = ap.ice_geometry(nv, fields)
            assert chunk in sweep_spmm.CHUNKS
            assert min_blocks in sweep_spmm.ICE_MINB


def test_sweep_entry_point_on_the_cpu(capsys):
    """python -m icebin_tpu_torch.tools.sweep_spmm --config synth --device
    cpu: one JSON line per case, no time, every plain check true; without
    --device cpu and a card it exits 2."""
    assert sweep_spmm.main(["--config", "synth", "--device", "cpu", "--nv",
                            "16"]) == 0
    import json
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    n_small = len(sweep_spmm.WARPS) * len(sweep_spmm.UNROLL) + 2
    n_ice = 2 * len(sweep_spmm.CHUNKS) * len(sweep_spmm.ICE_MINB) + 3
    assert len(lines) == n_small + n_ice
    assert all(c["ms"] is None and c["device"] == "cpu" for c in lines)
    assert all(c["equals_plain"] in (True, None) for c in lines)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            sweep_spmm.main(["--config", "synth"])
        assert e.value.code == 2
