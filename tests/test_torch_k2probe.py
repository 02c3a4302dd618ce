"""The dest-small probe kernels' plain versions (icebin_tpu_torch.ops.k2probe),
which the CUDA kernels of csrc/k2probe.cu are held to bit for bit on the card
(tests/test_torch_cuda.py):

* against the JAX package: the TPU probes' outputs are the stock dest-small
  kernel's, so slots, group and batch at every parameter are held to
  ``icebin_tpu.ops.pallas_bdt.apply_small(pm, x, scale=True, passes=6)``
  (interpret mode on the CPU) within 2e-5 relative, the bound
  tests/test_torch_apply.py uses for the reference's split-bf16 products,
  on a synthetic EvI-shaped matrix with one row of 600 nonzeros and NaN and
  inf sources, at nv = 16 and 20 (ragged against the batch width);
* against the port's f64 plain apply ``spmm_ref``: within one f32 ulp (both
  sum exact f64 products and round once, in different orders);
* against a scalar numpy evaluation of each stated order (ops/k2probe.py's
  docstring), bit for bit, on ``probe_k2.order_case``: empty rows, rows
  longer than 8 warps of 32 lanes twice over, source rows nothing reads,
  and large terms that cancel, so that every stated order gives other f32
  bits (checked);
* the ablations consume every load: perturbing any vals[k], the winv of any
  row with nonzeros, or any source value the matrix reads changes their
  output; a source row nothing reads leaves it unchanged.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icebin_tpu.ops import pallas_bdt as ref
from icebin_tpu.regrid.sparse import WeightedMatrix as RefMatrix

from icebin_tpu_torch.ops import k2probe as kp
from icebin_tpu_torch.ops.apply import spmm_ref
from icebin_tpu_torch.ops.csr import csr_from_coo, csr_pack
from icebin_tpu_torch.tools import probe_k2

# one intra-op thread: the suite runs in parallel workers, and interpret-mode
# Pallas load has starved the mesh tests' rendezvous before
torch.set_num_threads(1)

TOL = 2e-5
CPU = torch.device("cpu")
OPERATOR = ([(kp.spmm_small_slots, n) for n in kp.SLOTS]
            + [(kp.spmm_small_group, g) for g in kp.GROUPS]
            + [(kp.spmm_small_batch, fb) for fb in kp.BATCH])
OPERATOR_IDS = [f"{w.__name__[11:]}{p}" for w, p in OPERATOR]


@pytest.fixture(scope="module")
def synth_case():
    """(csr, {nv: (port field, JAX apply_small's (n_dst, nv) output)}),
    the reference computed once per module."""
    M = probe_k2.synth()
    assert np.bincount(M.rows).max() > 2 * 8 * 32
    csr = csr_pack(M, nv=16, device=CPU).small
    pm = ref.pallas_from_weighted(
        RefMatrix(rows=M.rows, cols=M.cols, vals=M.vals, shape=M.shape),
        small_axis="rows", nv=16)
    out = {}
    for nv in (16, 20):
        x = probe_k2.fields(M.shape[1], nv, seed=nv)
        want = ref.apply_small(pm, jnp.asarray(x.T), scale=True, passes=6)
        out[nv] = (torch.as_tensor(x), np.asarray(want).T)
    return csr, out


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want) / (np.abs(want) + 1e-9))


@pytest.mark.parametrize("nv", [16, 20])
@pytest.mark.parametrize("wrap,param", OPERATOR, ids=OPERATOR_IDS)
def test_variants_match_the_jax_reference(synth_case, wrap, param, nv):
    csr, cases = synth_case
    x, want = cases[nv]
    n0 = wrap.launches
    got = wrap(csr, x, param)          # CPU tensors: the plain version
    assert wrap.launches == n0
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < TOL


@pytest.mark.parametrize("nv", [16, 20])
@pytest.mark.parametrize("wrap,param", OPERATOR, ids=OPERATOR_IDS)
def test_variants_within_one_ulp_of_spmm_ref(synth_case, wrap, param, nv):
    csr, cases = synth_case
    x = cases[nv][0]
    got = wrap(csr, x, param).numpy()
    want = spmm_ref(csr, x).numpy()
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))


def test_k2_order_at_one_slot_and_one_warp(synth_case):
    """slots(1) and group(1) are both K2's order: equal bit for bit."""
    csr, cases = synth_case
    for x, _ in cases.values():
        assert torch.equal(kp.spmm_small_slots_ref(csr, x, 1),
                           kp.spmm_small_group_ref(csr, x, 1))


def seeded_csr(seed, n_dst=12, n_src=120, long_rows=(45, 70)):
    """COO with empty rows (0, 5, the last), rows of ``long_rows`` > 32
    nonzeros (3 and 7) and rows of 1-6; source rows n_src - 5.. are never
    read."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 7, n_dst)
    lens[[0, 5, n_dst - 1]] = 0
    lens[[3, 7]] = long_rows
    dst = np.repeat(np.arange(n_dst), lens)
    src = np.concatenate([rng.choice(n_src - 5, n, replace=False)
                          for n in lens])
    vals = rng.uniform(0.5, 1.5, len(dst))
    w = rng.uniform(0.5, 2.0, n_dst)
    return csr_from_coo(dst, src, vals, n_dst, n_src, w, device=CPU)


def _tree(lane, dt):
    """K2's shuffle tree over a list of 32 scalars of type ``dt``."""
    lane = list(lane)
    off = 16
    while off:
        for j in range(off):
            lane[j] = dt(lane[j] + lane[j + off])
        off //= 2
    return lane[0]


def numpy_order(csr, x, kind, param):
    """The stated order of ``kind`` at ``param``, scalar by scalar in
    np.float64 (np.float32 for ablate f32)."""
    rowptr, cols = csr.rowptr.numpy(), csr.cols.numpy()
    vals, winv = csr.vals.numpy(), csr.winv.numpy()
    f32 = kind == "ablate" and param == "f32"
    dt = np.float32 if f32 else np.float64
    out = np.zeros((csr.n_dst, x.shape[1]), np.float32)
    for r in range(csr.n_dst):
        k0, k1 = rowptr[r], rowptr[r + 1]
        if k0 == k1:
            continue
        for v in range(x.shape[1]):
            def term(p):
                c = x[cols[k0 + p], v]
                c = c if np.isfinite(c) else np.float32(0.0)
                return dt(dt(vals[k0 + p]) * dt(c))
            n = k1 - k0
            nslot = param if kind in ("slots", "group") else 1
            if kind == "batch":
                total = dt(0.0)
                for p in range(n):
                    total = dt(total + term(p))
            else:
                acc = [[dt(0.0)] * 32 for _ in range(nslot)]
                for p in range(n):
                    q, lane = (p // 32) % nslot, p % 32
                    acc[q][lane] = dt(acc[q][lane] + term(p))
                if kind == "group":
                    warps = [_tree(a, dt) for a in acc]
                    total = warps[0]
                    for t in warps[1:]:
                        total = dt(total + t)
                elif kind == "ablate" and param == "smem":
                    total = acc[0][0]
                    for t in acc[0][1:]:
                        total = dt(total + t)
                else:                          # slots, ablate f32
                    lane = list(acc[0])
                    for a in acc[1:]:
                        lane = [dt(s + t) for s, t in zip(lane, a)]
                    total = _tree(lane, dt)
            out[r, v] = np.float32(dt(total * dt(winv[r])))
    return out


PLAIN = {"slots": (kp.spmm_small_slots_ref, kp.SLOTS),
         "group": (kp.spmm_small_group_ref, kp.GROUPS),
         "batch": (kp.spmm_small_batch_ref, kp.BATCH),
         "ablate": (kp.spmm_small_ablate_ref, kp.MODES)}


@pytest.mark.parametrize("nv", [1, 5])
@pytest.mark.parametrize("kind", sorted(PLAIN))
def test_plain_versions_are_their_stated_order(kind, nv):
    csr, x = probe_k2.order_case(nv, nv)
    plain, params = PLAIN[kind]
    for p in params:
        got = plain(csr, torch.as_tensor(x), p)
        assert got.dtype == torch.float32 and got.shape == (csr.n_dst, nv)
        np.testing.assert_array_equal(got.numpy(),
                                      numpy_order(csr, x, kind, p))
        assert not got[[0, 5, csr.n_dst - 1]].any()     # empty rows are 0


def test_the_orders_differ_on_cancelling_data():
    """probe_k2.order_case's data tells every stated order apart, so
    equality with the numpy evaluation pins each plain version's order."""
    csr, x = probe_k2.order_case(3, 2)
    outs = [plain(csr, torch.as_tensor(x), p)
            for plain, params in PLAIN.values() for p in params
            if not (plain is kp.spmm_small_batch_ref and p != 16)
            and not (plain is kp.spmm_small_group_ref and p == 1)]
    assert len(outs) == 10
    for i, a in enumerate(outs):
        for b in outs[i + 1:]:
            assert not torch.equal(a, b)


@pytest.mark.parametrize("mode", kp.MODES)
def test_ablations_consume_every_load(mode):
    csr = seeded_csr(7)
    nv = 3
    x = np.random.default_rng(8).uniform(0.5, 1.5, (csr.n_src, nv)
                                         ).astype(np.float32)
    read = set(csr.cols.tolist())
    assert len(read) < csr.n_src                      # some rows unread
    base = kp.spmm_small_ablate_ref(csr, torch.as_tensor(x), mode)

    def changed(c=None, xx=None):
        out = kp.spmm_small_ablate_ref(
            c or csr, torch.as_tensor(x if xx is None else xx), mode)
        return not torch.equal(out, base)

    for k in range(csr.vals.numel()):
        vals = csr.vals.clone()
        vals[k] += 0.5
        assert changed(c=type(csr)(**{**csr.__dict__, "vals": vals})), k
    counts = (csr.rowptr[1:] - csr.rowptr[:-1]).tolist()
    for r in range(csr.n_dst):
        winv = csr.winv.clone()
        winv[r] += 0.5
        # an empty row is 0 whatever its winv
        assert changed(c=type(csr)(**{**csr.__dict__, "winv": winv})) == (
            counts[r] > 0), r
    for s in range(csr.n_src):
        for v in range(nv):
            xx = x.copy()
            xx[s, v] += 0.5
            assert changed(xx=xx) == (s in read), (s, v)


def test_wrappers_check_operands():
    csr = seeded_csr(1)
    x = torch.ones((csr.n_src, 4))
    for wrap, params in ((kp.spmm_small_slots, kp.SLOTS),
                         (kp.spmm_small_group, kp.GROUPS),
                         (kp.spmm_small_batch, kp.BATCH),
                         (kp.spmm_small_ablate, kp.MODES)):
        p = params[0]
        assert torch.equal(wrap(csr, x, p), PLAIN[wrap.__name__[11:]][0](
            csr, x, p))
        for bad in (x.double(), x[:-1], x.t().contiguous(), x[:, ::2],
                    x.to("meta")):
            with pytest.raises(ValueError):
                wrap(csr, bad, p)
        for bad_p in (3, 0, "f64", None):
            with pytest.raises(ValueError):
                wrap(csr, x, bad_p)


def test_probe_entry_point_on_the_cpu(capsys):
    """python -m icebin_tpu_torch.tools.probe_k2 --config synth --device
    cpu: one JSON line per case and nv, no time (a CPU time is not the
    card's), every operator variant within the accuracy contract."""
    assert probe_k2.main(["--config", "synth", "--device", "cpu",
                          "--nv", "16", "20"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    per_nv = 3 + len(OPERATOR) + len(kp.MODES) + 1
    assert len(lines) == 2 * per_nv
    assert [c["nv"] for c in lines] == [16] * per_nv + [20] * per_nv
    for c in lines:
        assert c["config"] == "synth" and c["device"] == "cpu"
        assert c["ms"] is None and c["bound_by"] == "bytes"
        if c["kernel"].startswith("spmm_small_"):
            assert c["max_abs_err"] == 0.0 and c["rerun_identical"]
            assert c["launches"] is None
        # f64 sums: the accuracy contract (the f32 ablation, the floor and
        # torch.sparse.mm's f32 sums are not held to it)
        if c["kernel"] == "spmm_dest_small" or (
                c["kernel"].startswith("spmm_small_") and c["param"] != "f32"):
            assert c["raw_err"] < 5e-7, c
    names = {(c["kernel"], c["param"]) for c in lines}
    assert ("spmm_floor_small", None) in names
    live = [c for c in lines if c["param"] == probe_k2.LIVE]
    assert len(live) == 2 and all(c["equals_k2"] for c in live)
    assert ("torch.sparse.mm", None) in names
    assert ("spmm_small_ablate", "smem") in names
    # the field of nv columns is fields(n_src, nv, seed=nv), as in
    # chip_smoke.py phase 13
    M, csr = probe_k2.evi("synth", torch.device("cpu"))
    same = probe_k2.run_cases(M, csr, probe_k2.fields(csr.n_src, 20, seed=20),
                              reps=0)
    assert [c["raw_err"] for c in same] == [c["raw_err"] for c in lines
                                            if c["nv"] == 20]


def test_probe_entry_point_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(SystemExit) as e:
        probe_k2.main(["--config", "synth"])
    assert e.value.code == 2
