"""The books of a coupling step (``ops.books``: ``books_reduce_kernel`` and
``books_stats_kernel`` on the card, their plain versions on the CPU).

On the CPU:
* the coupler's results (every step's fI, fE_out, fA_out, the state and
  every ledger row) on the toy coupler are bit for bit what the coupler
  gave before the books moved into ``ops.books``: the digests below were
  recorded from that code at the same seeds, stepwise, fused, without the
  repair and on a lattice of 40,000 cells (past the 32,768 at which torch's
  CPU sum splits a row: the plain version keeps each sum's shape);
* the plain sums against numpy's f64 sums, within 1e-15 of sum |f w|;
* the kernels' launch tables, read by a numpy model of the kernels (the
  adds in the kernel's order: 16 values a thread 256 apart, the warp and
  block trees, the block partials by the row's last block): the model
  against the plain version within 1e-14 of sum |f w| (another order of
  f64 adds), the repair's write and the ledger row; and the toy coupler
  run through the tables and the model, at most 8 launches a step.

On the card (marker ``cuda``): the kernel bit for bit the model and within
1e-14 of sum |f w| of the plain version at Greenland's and Antarctica's
lattice lengths and at 1, 31 and 2**k +- 1, with NaN, +-inf, zero weights
and pad rows; two launches the same bits; the ledger row bit for bit the
plain arithmetic's from the same sums; the launch counters; the compiled
step's books at most 8 launches a replay and sheet, enqueued with no host
sync.
"""
import contextlib
import ctypes
import hashlib
import json
import math

import numpy as np
import pytest
import torch

import icebin_tpu_torch as port
from icebin_tpu_torch.grid import proj, spec
from icebin_tpu_torch.ops import books
from icebin_tpu_torch.ops.books import (Rows, books_repair, books_repair_ref,
                                        books_stats, books_stats_ref,
                                        books_sum, books_sum_ref)

torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = torch.float64
SUM_TOL = 1e-14
SCALE = 25e3
HCDEFS = [0.0, 500.0, 1000.0, 2000.0, 3000.0]
GREENLAND, ANTARCTICA = 300 * 560, 1120 * 1120
LENGTHS = (1, 31, 2047, 2048, 2049, 4095, 4096, 4097, 65535, 65537)
COUNTED = (books_sum, books_repair, books_stats)


# -- the toy coupler, bit for bit the coupler before ops.books ---------------

def toy(repair=True, n_ice=40, device=CPU):
    specA = spec.GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                                latb=np.linspace(30.0, 80.0, 7))
    specI = spec.GridSpecXY(xb=np.linspace(0.0, 40.0 * SCALE, n_ice + 1),
                            yb=np.linspace(30.0 * SCALE, 80.0 * SCALE,
                                           n_ice + 1),
                            projection=proj.PlateCarree(scale=SCALE))
    gr = port.GCMRegridder(specA, hcdefs=HCDEFS, device=device)
    gr.add_sheet("toy", specI, subdiv=1)
    cfg = port.CouplerConfig(dt=86400.0 * 30, regen_every=3, repair=repair)
    cp = port.GCMCoupler(gr, cfg, device=device)
    cp.sheets["toy"].set_held_state(
        np.random.default_rng(7).uniform(0.5, 2.0, (2, gr.nE)))
    return cp


def forcing_np(t, nE):
    """tests/test_torch_coupler.py's forcing, with NaN in every 7th cell
    of one repaired field."""
    rng = np.random.default_rng(int(t) % 100003)
    f = np.zeros((8, nE))
    f[0] = 1e-5 * rng.uniform(0.5, 1.0, nE)
    f[1] = 5.0
    f[3] = 2.0
    f[4] = -10.0
    f[6] = 2e-6 * rng.uniform(0.0, 1.0, nE)
    f[2, ::7] = np.nan
    return f.astype(np.float32)


def digest(t):
    return hashlib.sha256(
        t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def toy_run(mode, device=CPU):
    """The digests of a toy run: ``stepwise`` (6 ``couple`` steps, a
    regeneration every 3), ``fused`` (one ``run_transient`` of 6),
    ``norepair`` (stepwise without the repair), ``large`` (4 steps on
    200 x 200 cells)."""
    cp = toy(repair=mode != "norepair", n_ice=200 if mode == "large" else 40,
             device=device)
    outs = []
    f = lambda t: torch.as_tensor(forcing_np(t, cp.gr.nE), device=device)
    if mode == "fused":
        outs.append(cp.run_transient(lambda t, s: f(t), 6,
                                     fused=True)["toy"])
    else:
        for _ in range(4 if mode == "large" else 6):
            outs.append(cp.couple({"toy": f(cp.time)})["toy"])
    st = cp.sheets["toy"].state
    d = {f"{k}{i}": digest(o[k]) for i, o in enumerate(outs)
         for k in ("fI", "fE_out", "fA_out")}
    d.update(H=digest(st.H), enth=digest(st.enth))
    keys = [f"toy.{k}" for k in port.IceSheetCoupler.STAT_KEYS]
    rows = [[float(r[k]).hex() for k in keys] for r in cp.ledger.to_rows()]
    d["rows"] = hashlib.sha256(json.dumps(rows).encode()).hexdigest()[:16]
    return d, cp


#: recorded from the coupler before ops.books, at these seeds
PARENT = {
    "stepwise": {
        "fI0": "0a0e2f103fda713d", "fE_out0": "7379286f088033b5",
        "fA_out0": "4558533505abf8cb", "fI1": "3cf880dd74f75430",
        "fE_out1": "6f6ee2b12e0d4ac8", "fA_out1": "918d8e6a09ed865c",
        "fI2": "49d3d8d30db0c9ad", "fE_out2": "5d14302b1cdcd27c",
        "fA_out2": "60ce322cb77d87bd", "fI3": "435ca52548051b82",
        "fE_out3": "7e5355dea6db518f", "fA_out3": "27456298313a3851",
        "fI4": "651b765714d5c755", "fE_out4": "dad51b99b9d75fed",
        "fA_out4": "d37e3aadd5dc6677", "fI5": "1c3db8ef4ff282e9",
        "fE_out5": "61235e9b66d3d610", "fA_out5": "92ecd6bc01759bc6",
        "H": "8d207557c41e5594", "enth": "abdf6b1126a04237",
        "rows": "f619d389c4f075b5"},
    "fused": {
        "fI0": "1c3db8ef4ff282e9", "fE_out0": "61235e9b66d3d610",
        "fA_out0": "92ecd6bc01759bc6", "H": "8d207557c41e5594",
        "enth": "abdf6b1126a04237", "rows": "f619d389c4f075b5"},
    "norepair": {
        "fI0": "a8c583f32ad722c1", "fE_out0": "54151a29173ebac0",
        "fA_out0": "c3aaf5eb196c0b79", "fI1": "d7a97f1106fdad80",
        "fE_out1": "d15357fb696916f2", "fA_out1": "047fa1f1e6328b89",
        "fI2": "743bf76d813937a6", "fE_out2": "e2bc2382e35197f0",
        "fA_out2": "b7c18d6eeb25782a", "fI3": "18811f61ec0d7257",
        "fE_out3": "29320276c11aaf72", "fA_out3": "3409dced191b4182",
        "fI4": "f682896b363c149c", "fE_out4": "3e1cf7b526c3e06b",
        "fA_out4": "46d6bc30485259e1", "fI5": "5419a86de92dbda1",
        "fE_out5": "788379a3ef747153", "fA_out5": "31f95172c1a003b8",
        "H": "62e63fe090836224", "enth": "c76f2bec92356fae",
        "rows": "b62ac8fa1bf46259"},
    "large": {
        "fI0": "bf56aa0593f7a442", "fE_out0": "781ed73d82be5cd9",
        "fA_out0": "eacf7d670cda8aee", "fI1": "301768f993318285",
        "fE_out1": "ec397ce034601dce", "fA_out1": "bf93a96bb1722984",
        "fI2": "1367b0d03a877260", "fE_out2": "21029e8471733d09",
        "fA_out2": "c36eba8893ea7707", "fI3": "536d32bf9892e7f9",
        "fE_out3": "f08c893b97b9ae09", "fA_out3": "ffdad24a1de43f53",
        "H": "9c80c89c9c895e1c", "enth": "09386d72a59b094d",
        "rows": "f1da0e28679b5f96"},
}


@pytest.mark.parametrize("mode", list(PARENT))
def test_toy_coupler_bit_for_bit_before_the_books_moved(mode):
    got, _ = toy_run(mode)
    assert got == PARENT[mode]


# -- inputs --------------------------------------------------------------------

def rows_case(n, seed, nrows=3, dtype=torch.float32, device=CPU):
    """(x (nrows, n) with NaN, +-inf and values of both signs, w (n,) f64
    with zeros, mask (n,) bool) from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nrows, n)) * 10.0 ** rng.uniform(-3, 3,
                                                             (nrows, 1))
    for r in range(nrows):
        bad = rng.choice(n, size=min(n, 3), replace=False)
        x[r, bad[:1]] = np.nan
        x[r, bad[1:2]] = np.inf
        x[r, bad[2:3]] = -np.inf
    w = rng.uniform(0.0, 2.5e7, n)
    w[rng.uniform(size=n) < 0.2] = 0.0
    mask = rng.uniform(size=n) < 0.9
    t = lambda a, d: torch.as_tensor(a, dtype=d, device=device)
    return t(x, dtype), t(w, F64), t(mask, torch.bool)


def abs_scale(groups):
    """Per sum, sum |terms| in f64 (the tolerance's scale)."""
    out = []
    for g in groups:
        if g.w is None:
            x = g.x
            for e in g.extra:
                x = x + e
            x = x.reshape(-1).to(F64)
            if g.mask is not None:
                x = torch.where(g.mask.reshape(-1), x, 0.0)
            out.append(x.abs().sum().reshape(1))
        else:
            x = g.x if g.x.dim() == 2 else g.x[None]
            if g.rows is not None:
                x = x[list(g.rows)]
                if g.scale is not None:
                    x = x * g.scale[list(g.rows)][:, None]
            x = torch.where(torch.isfinite(x), x, 0.0).to(F64)
            out.append((x * g.w.to(F64)).abs().sum(-1))
    return torch.cat(out)


def stage(n, seed, dtype=torch.float32, device=CPU):
    """A stage's groups over rows of ``n``: weighted rows (some gathered
    and scaled, some split), flat sums with and without a mask, and a
    sum of three fields."""
    x, w, mask = rows_case(n, seed, 4, dtype, device)
    y, _, _ = rows_case(n, seed + 1, 2, dtype, device)
    fin = torch.nan_to_num(y, nan=0.0, posinf=1.0, neginf=-1.0)
    scale = torch.as_tensor([0.5, 3.0, 1e-3, 7.0], dtype=dtype,
                            device=device)
    return [Rows(x, w=w), Rows(x, [2, 0], w=w, scale=scale),
            Rows(x, [3, 1], w=w, scale=scale, split=True),
            Rows(x[1], w=w.to(torch.float32)),
            Rows(fin[0], mask=mask), Rows(fin[1]),
            Rows(fin[0], extra=(fin[1], fin[0]))]


# -- the plain version against numpy -------------------------------------------

@pytest.mark.parametrize("n", [1, 31, 4097, 40000])
def test_plain_sums_against_numpy(n):
    groups = stage(n, n)
    got = books_sum_ref(*groups).numpy()
    want = []
    for g in groups:
        if g.w is None:
            x = g.x.numpy().copy()
            for e in g.extra:
                x = x + e.numpy()
            x = x.astype(np.float64)
            if g.mask is not None:
                x = np.where(g.mask.numpy(), x, 0.0)
            want.append([math.fsum(x)])
        else:
            x = g.x.numpy() if g.x.dim() == 2 else g.x.numpy()[None]
            if g.rows is not None:
                x = x[list(g.rows)]
                if g.scale is not None:
                    x = x * g.scale.numpy()[list(g.rows)][:, None]
            x = np.where(np.isfinite(x), x, 0.0).astype(np.float64)
            want.append([math.fsum(r) for r in x * g.w.numpy()])
    want = np.concatenate(want)
    scale = abs_scale(groups).numpy()
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-15 * np.maximum(scale, 1e-300))


# -- a numpy model of the kernels, reading their launch tables -----------------

def _view(ptr, ctype, count):
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def _tree(v):
    """books.cu's block_sum over (..., 256) thread values: the warps by
    shuffles 16, 8, 4, 2, 1 apart, then the 8 warp sums 4, 2, 1 apart."""
    v = v.reshape(*v.shape[:-1], 8, 32).copy()
    for o in (16, 8, 4, 2, 1):
        v[..., :o] = v[..., :o] + v[..., o:2 * o]
    w = v[..., 0].copy()
    for o in (4, 2, 1):
        w[..., :o] = w[..., :o] + w[..., o:2 * o]
    return w[..., 0]


def _ordered(terms, nslices):
    """A row's sum in the kernel's order: each thread PER_THREAD terms 256
    apart from 0.0, the block tree, then the block partials the same
    way."""
    t = np.zeros(nslices * books.SLICE)
    t[:len(terms)] = terms             # +0.0 leaves an rn sum as it is
    acc = np.zeros((nslices, books.THREADS))
    t = t.reshape(nslices, books.PER_THREAD, books.THREADS)
    for k in range(books.PER_THREAD):
        acc = acc + t[:, k]
    part = _tree(acc)
    if nslices == 1:
        return part[0]
    p = np.zeros(-(-nslices // books.THREADS) * books.THREADS)
    p[:nslices] = part
    tot = np.zeros(books.THREADS)
    for row in p.reshape(-1, books.THREADS):
        tot = tot + row
    return _tree(tot)


def model_reduce(b, nblocks):
    """books_reduce_kernel<double> over the table ``b``, in numpy."""
    assert nblocks == b.first[b.ngroups]
    for gi in range(b.ngroups):
        g = b.g[gi]
        xt = ctypes.c_double if g.flags & books._XF64 else ctypes.c_float
        npt = np.float64 if g.flags & books._XF64 else np.float32
        n = g.n
        wt = ctypes.c_double if g.flags & books._WF64 else ctypes.c_float
        rwt = ctypes.c_double if g.flags & books._RWF64 else ctypes.c_float
        for r in range(g.nrows):
            k = g.row[r]
            o, cs = k * g.stride, g.cstride
            at = lambda p: _view(p, xt, o + (n - 1) * cs + 1)[o::cs]
            x0 = at(g.x).copy()
            v = x0.copy()
            if g.scale:
                v = v * _view(g.scale, xt, k + 1)[k]
            if g.y:
                v = v + at(g.y)
            if g.z:
                v = v + at(g.z)
            fin = bool(g.flags & books._FINITE)
            if fin:
                v = np.where(np.isfinite(v), v, npt(0))
            if g.mask:
                v = np.where(_view(g.mask, ctypes.c_ubyte, n) != 0, v,
                             npt(0))
            d = v.astype(np.float64)
            if g.rw:
                wtot = _view(g.wtot, ctypes.c_double, 1)[0]
                corr = ((_view(g.msrc, ctypes.c_double, r + 1)[r]
                         - _view(g.mdst, ctypes.c_double, r + 1)[r])
                        / (wtot if wtot > 0 else 1.0))
                rw = _view(g.rw, rwt, n).astype(np.float64)
                fixed = np.where((rw > 0) & np.isfinite(d), d + corr, d)
                _view(g.out64, ctypes.c_double, (r + 1) * n)[r * n:] = fixed
                if g.dst:
                    dst = at(g.dst)
                    dst[:] = np.where(np.isfinite(x0), fixed.astype(npt),
                                      dst)
                d = np.where(np.isfinite(fixed) | (not fin), fixed, 0.0)
            if g.w:
                d = d * _view(g.w, wt, n).astype(np.float64)
            if g.sum[r] >= 0:
                _view(b.out, ctypes.c_double, g.sum[r] + 1)[g.sum[r]] = \
                    _ordered(d, g.nslices)
    return 0


def model_stats(pre, dl, post, es, st, cell_area, rho, dt, ad):
    """books_stats_kernel, operation by operation, in Python floats."""
    pre, dl, post, es = (list(_view(p, ctypes.c_double, n))
                         for p, n in ((pre, 5), (dl, 7), (post, 7), (es, 7)))
    e = [x * dt for x in es]
    d = [x * dt for x in dl]
    m_in = e[0] + e[1]
    e_in = e[3] + 0.0
    for k in range(4, 7):
        e_in = e_in + e[k]
    e_in = e_in + e[2]
    mass0 = pre[0] * cell_area * rho
    e_store0 = pre[1] * cell_area
    m_delivered = d[0] + d[1]
    m_rain, e_rain = d[1], d[2]
    e_delivered = d[3] + 0.0
    for k in range(4, 7):
        e_delivered = e_delivered + d[k]
    e_delivered = e_delivered + e_rain
    mass1 = post[0] * cell_area * rho
    e_store1 = post[1] * cell_area
    m_returned = post[2] * ad + m_rain
    m_clamp = post[3] * ad
    e_returned = post[4] * ad + e_rain
    e_clamp = post[5] * ad
    e_pdd = post[6] * ad
    m_del_f32 = (pre[2] + pre[3]) * ad
    e_del_f32 = pre[4] * ad
    m_res = (mass1 - mass0 - m_del_f32 + m_returned - m_clamp
             + (m_del_f32 - m_delivered))
    e_res = (e_store1 - e_store0 - e_del_f32 + (e_returned - e_rain)
             + e_clamp + (e_del_f32 + e_rain - e_delivered))
    _view(st, ctypes.c_double, 15)[:] = [
        m_in, m_delivered, mass1, m_returned, m_clamp, m_res, e_in,
        e_delivered, e_pdd, e_store1, e_returned, e_clamp, e_res, m_rain,
        e_rain]
    return 0


class _ModelLibrary:
    """The kernel library's books entry points, modelled on the CPU."""

    def books_reduce(self, ref, nblocks, stream):
        return model_reduce(ref._obj, nblocks)

    def books_stats(self, *a):
        return model_stats(*a[:9])


class _Stream:
    cuda_stream = 0


def use_model(mp):
    """The wrappers' card path on CPU tensors, the model in the kernels'
    place (``mp``: a pytest MonkeyPatch)."""
    mp.setattr(books, "on_cpu", lambda x, what: False)
    mp.setattr(books, "_library", _ModelLibrary)
    mp.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    mp.setattr(torch.cuda, "current_stream", lambda d: _Stream)
    mp.setattr(torch.cuda, "current_device", lambda: 0)
    mp.setattr(books, "_tickets", {})


@pytest.fixture
def modelled(monkeypatch):
    use_model(monkeypatch)
    for k in COUNTED:
        monkeypatch.setattr(k, "launches", 0)


def close_sums(got, want, scale, tol=SUM_TOL):
    got, want, scale = (t.cpu().numpy() for t in (got, want, scale))
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert np.all(err <= tol * np.maximum(scale, 1e-300)), \
        float(np.max(err / np.maximum(scale, 1e-300)))


@pytest.mark.parametrize("n", [*LENGTHS, 40000, 600000])
def test_model_sums_against_the_plain_version(modelled, n):
    groups = stage(n, 3 * n)
    got = books_sum(*groups)
    close_sums(got, books_sum_ref(*groups), abs_scale(groups))
    assert books_sum.launches == 1


@pytest.mark.parametrize("n", [1, 31, 2049, 40000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_model_repair_against_the_plain_version(modelled, n, dtype):
    x, w, _ = rows_case(n, n + 5, 5, dtype)
    m_src = torch.as_tensor([1e4, -3e3, 0.0, 5.0, 2e9][:3], dtype=F64)
    rows = [4, 0, 2]
    sums = books_sum_ref(Rows(x, rows, w=w), Rows(w))
    m_dst, wtot = sums[:3], sums[3]
    xk, xp = x.clone(), x.clone()
    out, ds = books_repair(xk, w, m_src, m_dst, wtot, rows=rows, into=True,
                           sums=[2, 0])
    ref, dref = books_repair_ref(xp, w, m_src, m_dst, wtot, rows=rows,
                                 into=True, sums=[2, 0])
    assert torch.equal(out, ref)                # elementwise: the same bits
    assert torch.equal(xk.nan_to_num(nan=7.0), xp.nan_to_num(nan=7.0))
    assert torch.equal(xk.isnan(), xp.isnan())
    scale = (torch.where(torch.isfinite(ref), ref, 0.0)
             * w).abs().sum(-1)[[2, 0]]
    close_sums(ds, dref, scale)
    assert books_repair.launches == 1
    # without the write into x or the sums, and over every row
    out2, none = books_repair(x, w, m_src[:1].expand(5).contiguous(),
                              books_sum_ref(Rows(x, w=w))[:5], wtot)
    assert none is None and out2.shape == (5, n)


def test_model_ledger_row_is_the_plain_arithmetic(modelled):
    rng = np.random.default_rng(11)
    t = lambda k: torch.as_tensor(rng.standard_normal(k) * 1e12, dtype=F64)
    pre, dl, post, es = t(5), t(7), t(7), t(7)
    pre[2] = -0.0
    kw = dict(cell_area=2.5e7, rho=910.0, dt=86400.0 * 30)
    got = books_stats(pre, dl, post, es, **kw)
    want = books_stats_ref(pre, dl, post, es, **kw)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    assert books_stats.launches == 1


@pytest.mark.parametrize("mode", ["stepwise", "norepair"])
def test_toy_coupler_through_the_launch_tables(modelled, mode):
    """The toy coupler with the books' card path (tables, the model in the
    kernels' place): 8 launches a step with the repair (its sums and
    write, the step's sums, each harvest apply's sums and write, the
    ledger row), 2 without; with it the transport identity < 1e-10."""
    got, cp = toy_run(mode)
    steps = 6
    n = sum(k.launches for k in COUNTED)
    assert n == (8 if mode == "stepwise" else 2) * steps
    assert books_stats.launches == steps
    for row in cp.ledger.to_rows() if mode == "stepwise" else ():
        m = row["toy.mass_in_E"]
        assert abs(m - row["toy.mass_delivered_I"]) < 1e-10 * abs(m)


def test_toy_ledger_through_the_launch_tables_is_close():
    """The modelled card path's first ledger row within 1e-13 of the plain
    path's, each entry of the larger of itself and its book's store (the
    sums' order alone differs; later steps carry the f32 state's rounding
    apart)."""
    _, plain = toy_run("stepwise")
    with pytest.MonkeyPatch.context() as mp:
        use_model(mp)
        _, card = toy_run("stepwise")
    a, b = card.ledger.to_rows()[0], plain.ledger.to_rows()[0]
    for key in port.IceSheetCoupler.STAT_KEYS:
        store = ("toy.ice_mass" if key.startswith("mass")
                 else "toy.energy_storage_I")
        scale = max(abs(b[f"toy.{key}"]), abs(b[store]))
        assert abs(a[f"toy.{key}"] - b[f"toy.{key}"]) <= 1e-13 * scale, key


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def on_card_groups(n, seed, cuda):
    return stage(n, seed, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [*LENGTHS, GREENLAND, ANTARCTICA])
def test_kernel_sums_against_plain_and_model(cuda, n):
    groups = on_card_groups(n, 7 * n + 1, cuda)
    got = books_sum(*groups)
    again = books_sum(*groups)
    assert got.cpu().numpy().tobytes() == again.cpu().numpy().tobytes()
    close_sums(got, books_sum_ref(*groups), abs_scale(groups))
    cpu = [Rows(**{k: (v.cpu() if isinstance(v, torch.Tensor) else
                       tuple(e.cpu() for e in v) if k == "extra" else v)
                   for k, v in vars(g).items()}) for g in groups]
    with pytest.MonkeyPatch.context() as mp:
        use_model(mp)
        model = books_sum(*cpu)
    assert got.cpu().numpy().tobytes() == model.numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 4097, GREENLAND, ANTARCTICA])
def test_kernel_repair_against_plain(cuda, n):
    x, w, _ = rows_case(n, n, 7, torch.float32, cuda)
    rows = [0, 3, 6, 2]
    sums = books_sum(Rows(x, rows, w=w), Rows(w))
    m_src = sums[:4] * 1.001 + 1.0
    xk, xp = x.clone(), x.clone()
    n0 = books_repair.launches
    out, ds = books_repair(xk, w, m_src, sums[:4], sums[4], rows=rows,
                           into=True, sums=[1, 3, 0])
    assert books_repair.launches == n0 + 1
    ref, dref = books_repair_ref(xp, w, m_src, sums[:4], sums[4],
                                 rows=rows, into=True, sums=[1, 3, 0])
    assert torch.equal(out, ref)
    assert torch.equal(xk.nan_to_num(nan=7.0), xp.nan_to_num(nan=7.0))
    scale = (ref * w).abs().sum(-1)[[1, 3, 0]]
    close_sums(ds, dref, scale)


@pytest.mark.cuda
def test_kernel_ledger_row_is_the_torch_epilogue(cuda):
    rng = np.random.default_rng(5)
    t = lambda k: torch.as_tensor(rng.standard_normal(k) * 1e12, dtype=F64,
                                  device=cuda)
    pre, dl, post, es = t(5), t(7), t(7), t(7)
    kw = dict(cell_area=2.5e7, rho=910.0, dt=86400.0 * 30)
    n0 = books_stats.launches
    got = books_stats(pre, dl, post, es, **kw)
    assert books_stats.launches == n0 + 1
    want = books_stats_ref(pre, dl, post, es, **kw)
    assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()


@pytest.mark.cuda
def test_compiled_step_books_launches(cuda):
    """The toy coupler on the card: a compiled window of 3 replays
    enqueued under set_sync_debug_mode("error"), the books' launches per
    replay (the graph's counts) at most 8, its rows bit for bit the eager
    step's, the transport identity < 1e-10."""
    from icebin_tpu_torch.coupler.step_graph import StepGraph
    from icebin_tpu_torch.models.ice_sheet import step_coupled
    a, b = toy(device=cuda), toy(device=cuda)
    sa, sb = a.sheets["toy"], b.sheets["toy"]
    f = lambda k: torch.as_tensor(forcing_np(k * 86400.0 * 30, a.gr.nE),
                                  device=cuda)
    sa.couple_window(torch.stack([f(0)]))        # captures the graph
    sb.ice_step = lambda *x: step_coupled(*x)      # not fusible: eager
    sb.couple_window(torch.stack([f(0)]))
    fE = torch.stack([f(k) for k in (1, 2, 3)])
    torch.cuda.synchronize()
    before = {k: k.launches for k in COUNTED}
    torch.cuda.set_sync_debug_mode("error")
    try:
        w = sa.launch_window(fE)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rows, _ = sa.finish_window(w)
    per = sum(k.launches - before[k] for k in COUNTED)
    assert per == 3 * 8, per
    (g,) = sa._graphs.values()
    assert isinstance(g, StepGraph)
    assert sum(g.launches.get(k, 0) for k in COUNTED) <= 8
    want, _ = sb.couple_window(fE)
    assert np.array_equal(rows, want)
    for r in rows:
        assert abs(r[0] - r[1]) < 1e-10 * abs(r[0])
