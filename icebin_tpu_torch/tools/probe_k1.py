"""The dest-ice probe: K1 (``spmm_dest_ice``), its stream floor and its five
variants (``ops/k1probe.py``) on one IvE matrix and field, beside
``torch.sparse.mm`` (cuSPARSE) -- the port's counterpart of the TPU probes
``tools/probe_slots.py``, ``probe_batch.py``, ``probe_batch2.py``,
``probe_ablate.py``, ``probe_manual6.py``, ``probe_ice_bisect.py``,
``probe_donate.py`` and ``probe_rmw.py`` (their dest-ice kernels).

    python -m icebin_tpu_torch.tools.probe_k1 [--config 3|5|synth]
        [--nv 16 64] [--device cuda|cpu]

``--config 3`` is bench.py's Greenland 5 km (304 x 544) under ModelE 2x2.5
with 5 elevation classes; ``5`` is Antarctica 5 km on bench.py:101-113's
lattice (1120 x 1120) under the same atmosphere; ``synth`` the IvE side of
``probe_k2.synth()``.  IvE is built with the port's own modules from the
initial (Vialov dome) ice surface.  The default device is cuda, which needs
a GPU; ``--device cpu`` runs the plain versions and times nothing.

The cases: K1 on the (n_src, nv) layout; K1 as the stage-1 ``apply_ice``
ran it (parameter "through transposes": the field copied from (nv, n_src)
to (n_src, nv), the result returned as the transposed (nv, n_dst) view;
``apply_ice`` now hands K1 the (nv, n) layout itself); its stream floor
(``floor.cu:spmm_floor_ice``, the TPU bisect's ``stream`` level); every
variant at every parameter; torch.sparse.mm computing K1's function, then
each lower stage's (parameter: the stage); each on ``probe_k2.fields(n_src,
nv, seed=nv)``, the field ``chip_smoke.py`` phase 14 runs them on.
``store("into")`` and ``store("rmw")`` write into one buffer held across
the timed calls (rmw's buffer is zeroed before each checked call, not
before the timed ones).  Prints one JSON line per case (kernel and
parameter, per ``--nv``): device ms (CUDA events over REPS calls after a
sleep kernel) beside the bound (``spmm_bound`` for what the case reads),
the host's wall-clock ms of one synchronised call (``host_ms``: what device
time cannot see, such as the allocation of the output), and the plain
version's ms (one call), max |kernel - plain| and whether they agree bit
for bit, whether a rerun is bit-identical and whether the result equals
K1's bit for bit (``store("fields")`` transposed back), the raw error
against the f64 oracle (max |out - oracle| / max |oracle| over rows of
nonzero weight; none for the floor and the lower stages, which compute
other functions), and the kernel's launches in the timed calls.
On the CPU every ms is null: a CPU time is not the card's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from icebin_tpu_torch.tools.common import (HCDEFS, antarctica_spec,
                                           card_name, greenland_specs,
                                           library_spmm, max_diff, same,
                                           spmm_bound, time_ms, time_once)
from icebin_tpu_torch.tools.probe_k2 import fields, raw_error, synth

__all__ = ["REPS", "APPLY", "STAGE_LIBRARY", "ive", "cases", "host_ms",
           "run_cases", "main"]

REPS = 50
#: the parameter of K1's case run as the stage-1 apply_ice ran it
APPLY = "through transposes"
#: library_spmm's options for the function of each lower stage
STAGE_LIBRARY = {"gather": dict(vals=False, winv=False, clean=False),
                 "clean": dict(vals=False, winv=False),
                 "weights": dict(winv=False)}


def ive(config, device):
    """(M, csr): the IvE WeightedMatrix of ``config`` ("3", "5" or "synth";
    rows the I side) and its dest-ice CSR on ``device``."""
    from icebin_tpu_torch.ops.csr import csr_pack
    if config == "synth":
        M = synth()
        return M.transpose(), csr_pack(M, nv=16, device=device).ice
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
    return sc.rm.matrix("IvE", cfg.params), sc.mat("IvE").pack.ice


def cases():
    """(kernel, parameter, wrapper, plain version, computes K1's function,
    the field that must hold, or None) for every case a probe runs, K1
    first, then K1 through transposes and its floor; the cases in K1's
    order give K1's bits (``equals_k1``)."""
    from icebin_tpu_torch.ops import k1probe as kp
    from icebin_tpu_torch.ops.apply import spmm_dest_ice, spmm_ref
    from icebin_tpu_torch.ops.floor import spmm_floor_ice, spmm_floor_ice_ref
    out = [("spmm_dest_ice", p, spmm_dest_ice, spmm_ref, True, "equals_k1")
           for p in (None, APPLY)]
    out += [("spmm_floor_ice", None, spmm_floor_ice, spmm_floor_ice_ref,
             False, None)]
    out += [("spmm_ice_slots", n, kp.spmm_ice_slots, kp.spmm_ice_slots_ref,
             True, "equals_k1" if n == 1 else None) for n in kp.SLOTS]
    out += [("spmm_ice_batch", rb, kp.spmm_ice_batch, kp.spmm_ice_batch_ref,
             True, "equals_k1") for rb in kp.BATCH]
    out += [("spmm_ice_ablate", m, kp.spmm_ice_ablate, kp.spmm_ice_ablate_ref,
             True, "equals_k1" if m == "row" else None) for m in kp.MODES]
    out += [("spmm_ice_stage", s, kp.spmm_ice_stage, kp.spmm_ice_stage_ref,
             False, None) for s in kp.LEVELS]
    out += [("spmm_ice_store", m, kp.spmm_ice_store, kp.spmm_ice_store_ref,
             True, "equals_k1") for m in kp.STORES]
    return out


def _calls(name, p, wrap, ref, csr, xt, xf):
    """(kernel call, plain call, map of a result to (n_dst, nv), bound, the
    buffer the kernel writes into or None) of one case; ``xt`` is the
    (n_src, nv) field, ``xf`` the same as (nv, n_src)."""
    nv = xt.shape[1]
    rows = (lambda a: a.t()) if p in (APPLY, "fields") else (lambda a: a)
    if p == APPLY:       # the stage-1 apply_ice: one copy in, a view out
        return (lambda: wrap(csr, xf.t().contiguous()).t(),
                lambda: ref(csr, xf.t().contiguous()).t(), rows,
                spmm_bound(csr, nv), None)
    if name == "spmm_ice_store" and p != "fields":
        held = torch.zeros((csr.n_dst, nv), dtype=torch.float32,
                           device=xt.device)
        return (lambda: wrap(csr, xt, p, out=held), lambda: ref(csr, xt, p),
                rows, spmm_bound(csr, nv, reads_out=p == "rmw"), held)
    x = xf if p == "fields" else xt
    args = () if p is None else (p,)
    b = spmm_bound(csr, nv, vals=p not in ("gather", "clean"),
                   winv=p not in ("gather", "clean", "weights"))
    return (lambda: wrap(csr, x, *args), lambda: ref(csr, x, *args), rows,
            b, None)


def host_ms(fn, reps):
    """The host's wall-clock ms of one call of ``fn`` and a synchronisation
    of the card, the mean over ``reps`` after a warm-up: the allocator and
    the launch are in it, which device time does not see."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def run_cases(M, csr, x, reps=REPS):
    """Every case of the probe on ``csr`` (the dest-ice CSR of
    WeightedMatrix ``M``, rows the I side; None: no raw error) and the
    (n_src, nv) f32 numpy field ``x``: a list of dicts (module docstring),
    the torch.sparse.mm ones last, whose ``max_abs_err`` is against K1 or
    against the stage they compute.  Each kernel is timed over ``reps``
    calls (none for ``reps=0``, and every ms is then None), its wrapper's
    launch counter set to 0 just before the timed calls and read just
    after."""
    device = csr.device
    xt = torch.as_tensor(x, device=device)
    xf = xt.t().contiguous()
    raw = raw_error(M, x)
    outs = {}
    res = []
    for name, p, wrap, ref, operator, _ in cases():
        fn, plain, rows, (bound_ms, bound_by), held = _calls(
            name, p, wrap, ref, csr, xt, xf)

        def fresh():
            if held is not None:
                held.zero_()
            return fn().clone()

        ms = launches = wall = None
        if reps:
            wrap.launches = 0
            ms = time_ms(fn, reps)
            launches = wrap.launches
            wall = host_ms(fn, reps)
        got, again = fresh(), fresh()
        want_plain, plain_ms = (time_once(plain) if reps else (plain(), None))
        if device.type == "cuda":
            torch.cuda.synchronize()
        got, again, want_plain = map(rows, (got, again, want_plain))
        outs[(name, p)] = got
        k1 = outs[("spmm_dest_ice", None)]
        res.append({
            "kernel": name, "param": p, "ms": ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "host_ms": wall, "plain_ms": plain_ms,
            "max_abs_err": max_diff(got, want_plain),
            "equals_plain": same(got, want_plain),
            "rerun_identical": same(got, again),
            "equals_k1": same(got, k1),
            "raw_err": raw(got) if operator else None,
            "launches": launches})
    bounds = {c["param"]: (c["bound_ms"], c["bound_by"]) for c in res
              if c["kernel"] == "spmm_ice_stage"}
    bounds[None] = spmm_bound(csr, x.shape[1])
    for p, opts in ((None, {}), *STAGE_LIBRARY.items()):
        spmm = library_spmm(csr, xt, **opts)
        lib = spmm()
        want = outs[("spmm_dest_ice", None) if p is None
                    else ("spmm_ice_stage", p)]
        res.append({"kernel": "torch.sparse.mm", "param": p,
                    "ms": time_ms(spmm, reps) if reps else None,
                    "bound_ms": bounds[p][0], "bound_by": bounds[p][1],
                    "max_abs_err": max_diff(lib, want),
                    "raw_err": raw(lib) if p is None else None})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_k1", description=__doc__,
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
    M, csr = ive(args.config, device)
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
