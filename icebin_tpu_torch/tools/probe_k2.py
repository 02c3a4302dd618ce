"""The dest-small probe: K2 (``spmm_dest_small``), its stream floor and its
four variants (``ops/k2probe.py``) on one EvI matrix and field, beside
``torch.sparse.mm`` (cuSPARSE) -- the port's counterpart of the TPU probes
``tools/probe_slots.py``, ``probe_group.py``, ``probe_batch.py``,
``probe_batch2.py`` and ``probe_ablate.py``.

    python -m icebin_tpu_torch.tools.probe_k2 [--config 3|5|synth]
        [--nv 16 64] [--device cuda|cpu]

``--config 3`` is bench.py's Greenland 5 km (304 x 544) under ModelE 2x2.5
with 5 elevation classes; ``5`` is Antarctica 5 km on bench.py:101-113's
lattice (1120 x 1120) under the same atmosphere; ``synth`` a small
EvI-shaped matrix with one row of 600 nonzeros.  EvI is built with the
port's own modules from the initial (Vialov dome) ice surface.  The
default device is cuda, which needs a GPU; ``--device cpu`` runs the plain
versions and times nothing.

The cases: K2; K2 on the CSR of its live rows alone (parameter "live
rows": what the empty rows' warps cost); its stream floor; every variant
at every parameter; torch.sparse.mm; each on ``fields(n_src, nv,
seed=nv)``, the field ``chip_smoke.py`` phase 13 runs them on.  Prints one
JSON line per case (kernel and parameter, per ``--nv``): device
ms (CUDA events over REPS calls after a sleep kernel) beside the bound
(``spmm_bound``) and the plain version's ms (one call; K2's is
``spmm_dest_small_ref``, which follows its order), max |kernel - plain|
and whether they agree bit for bit, whether a rerun is bit-identical,
whether the result equals K2's bit for bit (``equals_k2``) and the stage-1
K2's, one warp a row over every row (``equals_stage1``: the order of
``spmm_small_slots_ref(., 1)``, which slots(1) and group(1) keep), the raw
error against the f64 oracle (max |out - oracle| / max |oracle| over rows
of nonzero weight; none for the floor, which computes another function),
and the kernel's launches in the timed calls.  On the CPU every ms is
null: a CPU time is not the card's, and K2's wrapper runs ``spmm_ref``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from icebin_tpu_torch.tools.common import (HCDEFS, antarctica_spec,
                                           card_name, greenland_specs,
                                           library_spmm, max_diff, same,
                                           spmm_bound, time_ms, time_once)

__all__ = ["REPS", "LIVE", "synth", "fields", "order_case", "evi", "cases",
           "raw_error", "run_cases", "main"]

REPS = 50
#: the parameter of K2's case on the CSR of its live rows alone
LIVE = "live rows"


def synth(nx=256, ny=24, ratio=16, nhc=3, long_row=600, seed=0):
    """EvI-shaped WeightedMatrix (the generator of the reference's
    tests/test_pallas_bdt.py) with one more row of ``long_row`` nonzeros,
    longer than 8 warps of 32 lanes twice over, so that every slot and
    group parameter has work."""
    from icebin_tpu_torch.regrid.sparse import WeightedMatrix
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
    extra = np.sort(rng.choice(nI, long_row, replace=False))
    nE = nA * nhc
    return WeightedMatrix(
        rows=np.concatenate([rows[keep], np.full(long_row, nE)]),
        cols=np.concatenate([cols[keep], extra]),
        vals=np.concatenate([vals[keep], rng.uniform(1e6, 5e6, long_row)]),
        shape=(nE + 1, nI))


def fields(n_src, nv, seed=0):
    """(n_src, nv) f32 temperature-like field, 260-290, with NaN and +-inf
    sources (which count as 0)."""
    rng = np.random.default_rng(seed)
    x = (260.0 + 30.0 * rng.uniform(size=(n_src, nv))).astype(np.float32)
    x[::97, 0] = np.nan
    x[5::89, -1] = np.inf
    x[7::101, nv // 2] = -np.inf
    return x


def order_case(seed, nv, device=torch.device("cpu"), n_dst=12,
               long_rows=(300, 700)):
    """(csr on ``device``, (n_src, nv) f32 numpy x) on which the variants'
    summation orders differ in f32.  Every vals is 1 and each row reads its
    own run of sources, so term p of a row is x at its p-th source: +2**45,
    -2**45 or a value in [0.5, 1.5) (NaN or inf at every 17th of those) as
    p % 3 = 0, 1, 2 (a row's last term is small if it has no -2**45 to pair
    with).  The large terms cancel, and an f64 sum loses the small values'
    low bits to them by its order.  Rows 0, 5 and the last are empty, rows
    3 and 7 have ``long_rows`` nonzeros (700 > 2 x 8 warps x 32 lanes), the
    others 1-6; 5 source rows nothing reads."""
    from icebin_tpu_torch.ops.csr import csr_from_coo
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 7, n_dst)
    lens[[0, 5, n_dst - 1]] = 0
    lens[[3, 7]] = long_rows
    dst = np.repeat(np.arange(n_dst), lens)
    src = np.arange(lens.sum())
    p = src - np.repeat(np.cumsum(lens) - lens, lens)
    small = (p % 3 == 2) | ((p % 3 == 0) & (p == np.repeat(lens, lens) - 1))
    n_src = len(src) + 5
    x = rng.uniform(0.5, 1.5, (n_src, nv)).astype(np.float32)
    big = np.where(p % 3 == 0, 2.0 ** 45, -2.0 ** 45).astype(np.float32)
    x[src[~small]] = big[~small, None]
    odd = src[small & (p % 17 == 2)]
    x[odd, 0] = np.nan
    x[odd, -1] = np.inf
    csr = csr_from_coo(dst, src, np.ones(len(src)), n_dst, n_src,
                       rng.uniform(0.5, 2.0, n_dst), device=device)
    return csr, x


def evi(config, device):
    """(M, csr): the EvI WeightedMatrix of ``config`` ("3", "5" or
    "synth"; rows the E side) and its dest-small CSR on ``device``."""
    from icebin_tpu_torch.ops.csr import csr_pack
    if config == "synth":
        M = synth()
        return M, csr_pack(M, nv=16, device=device).small
    from icebin_tpu_torch import (CouplerConfig, GCMRegridder,
                                  IceSheetCoupler)
    if config == "3":
        name, (specA, specI) = "greenland", greenland_specs()
    elif config == "5":
        name, specA = "antarctica", greenland_specs()[0]
        specI = antarctica_spec()
    else:
        raise ValueError(f"config must be 3, 5 or synth, got {config!r}")
    gr = GCMRegridder(specA, HCDEFS, device=device)
    gr.add_sheet(name, specI, subdiv=2)
    cfg = CouplerConfig()
    sc = IceSheetCoupler(gr, name, cfg, device=device)
    return sc.rm.matrix("EvI", cfg.params), sc.mat("EvI").pack.small


def cases():
    """(kernel, parameter, wrapper, plain version, computes K2's operator,
    the field that must hold, or None) for every case a probe runs, K2
    first: on the whole CSR, then on its live rows alone (parameter "live
    rows", K2's bits: ``equals_k2``), then its floor.  slots(1) and
    group(1) keep the stage-1 K2's order (``equals_stage1``)."""
    from icebin_tpu_torch.ops import k2probe as kp
    from icebin_tpu_torch.ops.apply import (spmm_dest_small,
                                            spmm_dest_small_ref)
    from icebin_tpu_torch.ops.floor import (spmm_floor_small,
                                            spmm_floor_small_ref)
    out = [("spmm_dest_small", None, spmm_dest_small, spmm_dest_small_ref,
            True, None),
           ("spmm_dest_small", LIVE, spmm_dest_small, spmm_dest_small_ref,
            True, "equals_k2"),
           ("spmm_floor_small", None, spmm_floor_small, spmm_floor_small_ref,
            False, None)]
    for wrap, ref, params in (
            (kp.spmm_small_slots, kp.spmm_small_slots_ref, kp.SLOTS),
            (kp.spmm_small_group, kp.spmm_small_group_ref, kp.GROUPS),
            (kp.spmm_small_batch, kp.spmm_small_batch_ref, kp.BATCH),
            (kp.spmm_small_ablate, kp.spmm_small_ablate_ref, kp.MODES)):
        out += [(wrap.__name__, p, wrap, ref, True,
                 "equals_stage1" if p == 1 else None) for p in params]
    return out


def raw_error(M, x):
    """A function of an (n_dst, nv) result: max |out - oracle| / max
    |oracle| over the rows of nonzero weight, against the f64 scipy product
    of WeightedMatrix ``M`` and the cleaned numpy field ``x``; None for no
    ``M``."""
    if M is None:
        return lambda out: None
    import scipy.sparse as sp
    w = np.asarray(M.wM)
    live = w > 0
    want = np.asarray(sp.csr_matrix((M.vals, (M.rows, M.cols)), shape=M.shape)
                      @ np.where(np.isfinite(x), x, 0.0).astype(np.float64))
    want[live] /= w[live, None]
    scale = np.abs(want[live]).max() if live.any() else 1.0
    return lambda out: float(np.abs(out.cpu().numpy()[live].astype(np.float64)
                                    - want[live]).max() / scale)


def run_cases(M, csr, x, reps=REPS):
    """Every case of the probe on ``csr`` (the dest-small CSR of
    WeightedMatrix ``M``; None: no raw error) and the (n_src, nv) f32 numpy
    field ``x``: a list of dicts (module docstring), the last
    torch.sparse.mm's, whose ``max_abs_err`` is against K2.  Each kernel is
    timed over ``reps`` calls (none for ``reps=0``, and every ms is then
    None), its wrapper's launch counter set to 0 just before the timed
    calls and read just after."""
    device = csr.device
    xt = torch.as_tensor(x, device=device)
    nv = x.shape[1]
    raw = raw_error(M, x)

    # the CSR of the live rows alone: K2 on it skips the empty rows' warps
    live_rows = torch.nonzero(csr.rowptr[1:] > csr.rowptr[:-1]).squeeze(1)
    sub = dataclasses.replace(
        csr, rowptr=torch.cat([csr.rowptr[live_rows], csr.rowptr[-1:]]),
        winv=csr.winv[live_rows], n_dst=live_rows.numel())

    def whole(out):
        full = torch.zeros((csr.n_dst, nv), dtype=out.dtype, device=device)
        full[live_rows] = out
        return full

    from icebin_tpu_torch.ops.k2probe import spmm_small_slots_ref
    stage1 = spmm_small_slots_ref(csr, xt, 1)
    k2 = None
    res = []
    for name, p, wrap, ref, operator, _ in cases():
        c, args = (sub, ()) if p == LIVE else (csr, () if p is None else (p,))

        def fn():
            return wrap(c, xt, *args)

        ms = launches = None
        if reps:
            wrap.launches = 0
            ms = time_ms(fn, reps)
            launches = wrap.launches
        got, again = fn(), fn()
        want_plain, plain_ms = (time_once(lambda: ref(c, xt, *args)) if reps
                                else (ref(c, xt, *args), None))
        if device.type == "cuda":
            torch.cuda.synchronize()
        if p == LIVE:
            got, again, want_plain = map(whole, (got, again, want_plain))
        if k2 is None:
            k2 = got
        bound_ms, bound_by = spmm_bound(c, nv)
        res.append({
            "kernel": name, "param": p, "ms": ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "plain_ms": plain_ms,
            "max_abs_err": max_diff(got, want_plain),
            "equals_plain": same(got, want_plain),
            "rerun_identical": same(got, again),
            "equals_k2": same(got, k2),
            "equals_stage1": same(got, stage1),
            "raw_err": raw(got) if operator else None,
            "launches": launches})
    spmm = library_spmm(csr, xt)
    lib = spmm()
    bound_ms, bound_by = spmm_bound(csr, nv)
    res.append({"kernel": "torch.sparse.mm", "param": None,
                "ms": time_ms(spmm, reps) if reps else None,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "max_abs_err": max_diff(lib, k2), "raw_err": raw(lib)})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_k2", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="3", choices=["3", "5", "synth"])
    ap.add_argument("--nv", type=int, nargs="+", default=[16, 64])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run the plain "
                 "versions on the CPU")
    M, csr = evi(args.config, device)
    cuda = device.type == "cuda"
    card = card_name() if cuda else "cpu"
    for nv in args.nv:
        x = fields(csr.n_src, nv, seed=nv)
        for case in run_cases(M, csr, x, REPS if cuda else 0):
            print(json.dumps({"config": args.config, "nv": nv,
                              "device": card, **case}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
