"""The dest-ice probe kernels' plain versions (icebin_tpu_torch.ops.k1probe),
which the CUDA kernels of csrc/k1probe.cu are held to bit for bit on the card
(tests/test_torch_cuda.py):

* against the JAX package: the TPU probes' outputs are the stock dest-ice
  kernel's, so every variant that computes K1's function is held to
  ``icebin_tpu.ops.pallas_bdt.apply_ice(pm, x, scale=True, passes=6)``
  (interpret mode on the CPU) within 2e-5 relative, the bound
  tests/test_torch_apply.py uses for the reference's split-bf16 products,
  on the IvE side of probe_k2.synth() with NaN and inf sources, at nv = 16
  and 20 (ragged against the reference's batch of 16);
* against the port's f64 plain apply ``spmm_ref``: the f64 variants within
  one f32 ulp (both sum exact f64 products and round once);
* against a scalar numpy evaluation of each stated order (ops/k1probe.py's
  docstring), bit for bit, on ``probe_k2.order_case``: empty rows, rows of
  1-6, 300 and 700 nonzeros, source rows nothing reads, and large terms
  that cancel, so that the stated orders give other f32 bits (checked);
* the ablations and the stages consume every load their function names:
  perturbing any vals[k], the winv of any row with nonzeros, or any source
  value the matrix reads changes their output where the function reads
  it; a source row nothing reads leaves it unchanged;
* store("rmw") keeps K1's signed zero;
* the probe's cuSPARSE yardsticks (tools/common.py:library_spmm) compute
  K1's function and each lower stage's.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icebin_tpu.ops import pallas_bdt as ref
from icebin_tpu.regrid.sparse import WeightedMatrix as RefMatrix

from icebin_tpu_torch.ops import k1probe as kp
from icebin_tpu_torch.ops.apply import spmm_ref
from icebin_tpu_torch.ops.csr import csr_from_coo, csr_pack
from icebin_tpu_torch.tools import probe_k1, probe_k2
from icebin_tpu_torch.tools.common import library_spmm, same

# one intra-op thread: the suite runs in parallel workers, and interpret-mode
# Pallas load has starved the mesh tests' rendezvous before
torch.set_num_threads(1)

TOL = 2e-5
CPU = torch.device("cpu")
#: the variants that compute K1's function, each with its plain version
OPERATOR = ([(kp.spmm_ice_slots, n) for n in kp.SLOTS]
            + [(kp.spmm_ice_batch, rb) for rb in kp.BATCH]
            + [(kp.spmm_ice_ablate, m) for m in kp.MODES]
            + [(kp.spmm_ice_store, m) for m in kp.STORES])
OPERATOR_IDS = [f"{w.__name__[9:]}-{p}" for w, p in OPERATOR]
#: the variants whose stated order is K1's
K1_ORDER = [(w, p) for w, p in OPERATOR if (w, p) not in (
    (kp.spmm_ice_slots, 2), (kp.spmm_ice_slots, 4),
    (kp.spmm_ice_ablate, "f32"))]
F64 = [c for c in OPERATOR if c != (kp.spmm_ice_ablate, "f32")]
F64_IDS = [f"{w.__name__[9:]}-{p}" for w, p in F64]


def call(wrap, csr, x, p):
    """``wrap`` at ``p`` on the (n_src, nv) field ``x``, the result as
    (n_dst, nv) (store "fields" takes and gives the transposed layout)."""
    if p == "fields":
        return wrap(csr, x.t().contiguous(), p).t()
    return wrap(csr, x, p)


@pytest.fixture(scope="module")
def synth_case():
    """(csr, {nv: (port field, JAX apply_ice's (n_dst, nv) output)}), the
    reference computed once per module."""
    M = probe_k2.synth()
    csr = csr_pack(M, nv=16, device=CPU).ice
    assert csr.n_dst == M.shape[1] and csr.n_src == M.shape[0]
    pm = ref.pallas_from_weighted(
        RefMatrix(rows=M.rows, cols=M.cols, vals=M.vals, shape=M.shape),
        small_axis="rows", nv=16)
    out = {}
    for nv in (16, 20):
        x = probe_k2.fields(M.shape[0], nv, seed=nv)
        want = ref.apply_ice(pm, jnp.asarray(x.T), scale=True, passes=6)
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
    got = call(wrap, csr, x, param)     # CPU tensors: the plain version
    assert wrap.launches == n0
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < TOL


@pytest.mark.parametrize("nv", [16, 20])
@pytest.mark.parametrize("wrap,param", F64, ids=F64_IDS)
def test_variants_within_one_ulp_of_spmm_ref(synth_case, wrap, param, nv):
    csr, cases = synth_case
    x = cases[nv][0]
    got = call(wrap, csr, x, param).numpy()
    want = spmm_ref(csr, x).numpy()
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))


def test_k1_order_variants_are_k1_bit_for_bit(synth_case):
    """slots(1), every batch, ablate(row) and every store follow K1's
    order: K1's bits, signed zeros included, on the synthetic
    IvE and on cancelling data."""
    csr, cases = synth_case
    fields = [(csr, x) for x, _ in cases.values()]
    c, x = probe_k2.order_case(2, 3)
    fields.append((c, torch.as_tensor(x)))
    assert same(kp.spmm_ice_batch_ref(c, fields[-1][1], 8),
                numpy_order(c, x, "batch", 8))
    for c, x in fields:
        k1 = kp.spmm_ice_batch_ref(c, x, 8)
        for wrap, p in K1_ORDER:
            assert same(call(wrap, c, x, p), k1), (wrap.__name__, p)


def numpy_order(csr, x, kind, param, init=None):
    """The stated order of ``kind`` at ``param``, scalar by scalar in
    np.float64 (np.float32 for ablate f32); ``init`` is what store rmw
    reads."""
    rowptr, cols = csr.rowptr.numpy(), csr.cols.numpy()
    vals, winv = csr.vals.numpy(), csr.winv.numpy()
    dt = np.float32 if (kind, param) == ("ablate", "f32") else np.float64
    nslot = param if kind == "slots" else 1
    clean = (kind, param) != ("stage", "gather")
    weights = kind != "stage" or param == "weights"
    scaled = kind != "stage"
    out = np.zeros((csr.n_dst, x.shape[1]), np.float32)
    with np.errstate(invalid="ignore"):     # inf - inf in the gather stage
        for r in range(csr.n_dst):
            for v in range(x.shape[1]):
                acc = [dt(0.0)] * nslot
                if init is not None:
                    acc[0] = dt(init[r, v])
                for p, k in enumerate(range(rowptr[r], rowptr[r + 1])):
                    c = x[cols[k], v]
                    if clean and not np.isfinite(c):
                        c = np.float32(0.0)
                    t = dt(dt(vals[k]) * dt(c)) if weights else dt(c)
                    acc[p % nslot] = dt(acc[p % nslot] + t)
                total = acc[0]
                for a in acc[1:]:
                    total = dt(total + a)
                if scaled:
                    total = dt(total * dt(winv[r]))
                out[r, v] = np.float32(total)
    return torch.as_tensor(out)


PLAIN = {"slots": (kp.spmm_ice_slots_ref, kp.SLOTS),
         "batch": (kp.spmm_ice_batch_ref, kp.BATCH),
         "ablate": (kp.spmm_ice_ablate_ref, kp.MODES),
         "stage": (kp.spmm_ice_stage_ref, kp.LEVELS),
         "store": (kp.spmm_ice_store_ref, kp.STORES)}


@pytest.mark.parametrize("nv", [1, 5])
@pytest.mark.parametrize("kind", sorted(PLAIN))
def test_plain_versions_are_their_stated_order(kind, nv):
    csr, x = probe_k2.order_case(nv, nv)
    assert (csr.rowptr[1:] - csr.rowptr[:-1]).max() >= 9
    plain, params = PLAIN[kind]
    xt = torch.as_tensor(x)
    for p in params:
        got = (plain(csr, xt.t().contiguous(), p).t() if p == "fields"
               else plain(csr, xt, p))
        assert got.dtype == torch.float32 and got.shape == (csr.n_dst, nv)
        assert same(got, numpy_order(csr, x, kind, p)), p
        if (kind, p) != ("stage", "gather"):
            assert not got[[0, 5, csr.n_dst - 1]].any()  # empty rows are 0


def test_the_orders_differ_on_cancelling_data():
    """probe_k2.order_case's data tells the stated orders apart (K1,
    slots 2 and 4, f32) and the stages' functions apart (every vals is 1
    there, so clean and weights agree), so equality with the numpy
    evaluation pins each plain version."""
    csr, x = probe_k2.order_case(3, 2)
    xt = torch.as_tensor(x)
    outs = ([kp.spmm_ice_slots_ref(csr, xt, n) for n in kp.SLOTS]
            + [kp.spmm_ice_ablate_ref(csr, xt, "f32")]
            + [kp.spmm_ice_stage_ref(csr, xt, s) for s in ("gather", "clean")])
    for i, a in enumerate(outs):
        for b in outs[i + 1:]:
            assert not same(a, b)


def seeded_csr(seed, n_dst=12, n_src=120, long_rows=(9, 14)):
    """COO with empty rows (0, 5, the last), rows of ``long_rows`` nonzeros
    (3 and 7) and rows of 1-6; source rows n_src - 5.. are never read."""
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


#: (plain version, parameter, reads vals, reads winv) of the ablations and
#: the stages
CONSUMERS = ([(kp.spmm_ice_ablate_ref, m, True, True) for m in kp.MODES]
             + [(kp.spmm_ice_stage_ref, s, s == "weights", False)
                for s in kp.LEVELS])


@pytest.mark.parametrize("plain,param,reads_vals,reads_winv", CONSUMERS,
                         ids=[f"{p.__name__[9:-4]}-{m}"
                              for p, m, _, _ in CONSUMERS])
def test_variants_consume_every_load(plain, param, reads_vals, reads_winv):
    csr = seeded_csr(7)
    nv = 3
    x = np.random.default_rng(8).uniform(0.5, 1.5, (csr.n_src, nv)
                                         ).astype(np.float32)
    read = set(csr.cols.tolist())
    assert len(read) < csr.n_src                      # some rows unread
    base = plain(csr, torch.as_tensor(x), param)

    def changed(c=None, xx=None):
        out = plain(c or csr, torch.as_tensor(x if xx is None else xx),
                    param)
        return not torch.equal(out, base)

    for k in range(csr.vals.numel()):
        vals = csr.vals.clone()
        vals[k] += 0.5
        assert changed(c=type(csr)(**{**csr.__dict__, "vals": vals})) == (
            reads_vals), k
    counts = (csr.rowptr[1:] - csr.rowptr[:-1]).tolist()
    for r in range(csr.n_dst):
        winv = csr.winv.clone()
        winv[r] += 0.5
        # an empty row is 0 whatever its winv
        assert changed(c=type(csr)(**{**csr.__dict__, "winv": winv})) == (
            reads_winv and counts[r] > 0), r
    for s in range(csr.n_src):
        for v in range(nv):
            xx = x.copy()
            xx[s, v] += 0.5
            assert changed(xx=xx) == (s in read), (s, v)


def test_rmw_keeps_k1_signed_zero():
    """A row whose f64 sum is a tiny negative number rounds to -0.0f; store
    rmw on a zeroed output starts its sum from the +0.0 it reads, as K1
    starts from 0.0, and so writes K1's -0.0 where an f32 add of K1's result
    to the output would write +0.0."""
    csr = csr_from_coo([0, 0, 1], [0, 1, 1], [1e-30, 1e-30, 1.0], 2, 2,
                       [1.0, 1.0], device=CPU)
    x = torch.tensor([[-1e-30], [-2e-30]])
    k1 = kp.spmm_ice_batch_ref(csr, x, 8)
    assert torch.signbit(k1[0, 0]) and k1[0, 0] == 0.0
    out = torch.zeros((2, 1))
    got = kp.spmm_ice_store(csr, x, "rmw", out=out)
    assert got is out and same(got, k1)
    assert not same(torch.zeros(()) + k1, k1)      # the f32 add's +0.0
    assert same(kp.spmm_ice_store(csr, x, "rmw"), k1)


def test_store_writes_into_the_callers_buffer():
    """into and fields write into ``out`` and return it; rmw adds what it
    reads to its f64 sum before the scale."""
    csr = seeded_csr(3)
    x = torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 1.5, (csr.n_src, 4)).astype(np.float32))
    k1 = kp.spmm_ice_batch_ref(csr, x, 8)
    for mode, xin, shape in (("into", x, (csr.n_dst, 4)),
                             ("fields", x.t().contiguous(), (4, csr.n_dst))):
        out = torch.full(shape, 7.0)
        got = kp.spmm_ice_store(csr, xin, mode, out=out)
        assert got is out
        assert same(got if mode == "into" else got.t(), k1)
    held = torch.full((csr.n_dst, 4), 2.0)
    got = kp.spmm_ice_store(csr, x, "rmw", out=held)
    assert same(got, numpy_order(csr, x.numpy(), "store", "rmw",
                                 init=np.full((csr.n_dst, 4), 2.0)))
    assert not same(got, k1)


def test_wrappers_check_operands():
    csr = seeded_csr(1)
    x = torch.ones((csr.n_src, 4))
    for kind, (plain, params) in PLAIN.items():
        wrap = getattr(kp, f"spmm_ice_{kind}")
        p = params[0]
        assert same(wrap(csr, x, p), plain(csr, x, p))
        for bad in (x.double(), x[:-1], x.t().contiguous(), x[:, ::2],
                    x.to("meta")):
            with pytest.raises(ValueError):
                wrap(csr, bad, p)
        for bad_p in (3, 0, "f64", None, 16):
            with pytest.raises(ValueError):
                wrap(csr, x, bad_p)
    xf = x.t().contiguous()
    assert same(kp.spmm_ice_store(csr, xf, "fields").t(),
                kp.spmm_ice_store(csr, x, "into"))
    with pytest.raises(ValueError):
        kp.spmm_ice_store(csr, x, "fields")          # (n_src, nv) given
    for bad_out in (torch.zeros((csr.n_dst, 5)), torch.zeros((4, csr.n_dst)),
                    torch.zeros((csr.n_dst, 4), dtype=torch.float64),
                    torch.zeros((4, csr.n_dst)).t()):
        with pytest.raises(ValueError):
            kp.spmm_ice_store(csr, x, "into", out=bad_out)


def test_probe_entry_point_on_the_cpu(capsys):
    """python -m icebin_tpu_torch.tools.probe_k1 --config synth --device
    cpu: one JSON line per case and nv, no time (a CPU time is not the
    card's), every variant its plain version and its rerun, the K1-order
    variants K1's bits, the f64 ones within the accuracy contract."""
    assert probe_k1.main(["--config", "synth", "--device", "cpu",
                          "--nv", "16", "20"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    per_nv = 3 + len(kp.SLOTS) + len(kp.BATCH) + len(kp.MODES) \
        + len(kp.LEVELS) + len(kp.STORES) + 1 + len(probe_k1.STAGE_LIBRARY)
    assert per_nv == 21 and len(lines) == 2 * per_nv
    assert [c["nv"] for c in lines] == [16] * per_nv + [20] * per_nv
    k1_order = {(w.__name__, p) for w, p in K1_ORDER} | {
        ("spmm_dest_ice", None), ("spmm_dest_ice", probe_k1.APPLY)}
    for c in lines:
        assert c["config"] == "synth" and c["device"] == "cpu"
        assert c["ms"] is None and c["bound_by"] == "bytes"
        if c["kernel"].startswith("spmm_ice_"):
            assert c["max_abs_err"] == 0.0 and c["equals_plain"]
            assert c["rerun_identical"]
            assert c["launches"] is None and c["host_ms"] is None
        if (c["kernel"], c["param"]) in k1_order:
            assert c["equals_k1"], c
            assert c["raw_err"] < 5e-7, c
        if c["kernel"] == "spmm_ice_stage":
            assert c["raw_err"] is None and not c["equals_k1"]
        if c["kernel"] == "torch.sparse.mm":
            assert (c["raw_err"] is None) == (c["param"] is not None)
    names = {(c["kernel"], c["param"]) for c in lines}
    assert {("spmm_floor_ice", None), ("torch.sparse.mm", None),
            ("spmm_ice_store", "fields")} <= names
    assert {("torch.sparse.mm", s) for s in kp.LEVELS} <= names
    # the stages read less: their bound is below K1's
    by = {(c["kernel"], c["param"]): c["bound_ms"] for c in lines
          if c["nv"] == 16}
    assert (by[("spmm_ice_stage", "gather")]
            < by[("spmm_ice_stage", "weights")] < by[("spmm_dest_ice", None)]
            < by[("spmm_ice_store", "rmw")])
    # the field of nv columns is fields(n_src, nv, seed=nv), as in
    # chip_smoke.py phase 14
    M, csr = probe_k1.ive("synth", CPU)
    same_field = probe_k1.run_cases(
        M, csr, probe_k2.fields(csr.n_src, 20, seed=20), reps=0)
    assert [c["raw_err"] for c in same_field] == [c["raw_err"] for c in lines
                                                  if c["nv"] == 20]


@pytest.mark.parametrize("level", [None, *kp.LEVELS])
def test_library_yardsticks_compute_each_function(synth_case, level):
    """The cuSPARSE case of each level (None: K1's function) computes what
    that level's kernel does, to f32 summation, with the same non-finite
    outputs (the gather stage propagates NaN and inf sources)."""
    csr, cases = synth_case
    x = cases[20][0]
    got = library_spmm(csr, x, **probe_k1.STAGE_LIBRARY.get(level, {}))()
    want = (spmm_ref(csr, x) if level is None
            else kp.spmm_ice_stage_ref(csr, x, level))
    assert got.shape == want.shape and got.dtype == torch.float32
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert torch.equal(torch.isnan(want), torch.isnan(got))
    assert bool((got[~fin & ~torch.isnan(want)]
                 == want[~fin & ~torch.isnan(want)]).all())
    assert rel_err(got[fin].numpy(), want[fin].numpy()) < TOL
    assert (level == "gather") == bool((~fin).any())


def test_probe_entry_point_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(SystemExit) as e:
        probe_k1.main(["--config", "synth"])
    assert e.value.code == 2
