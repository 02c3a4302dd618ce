"""The launch-geometry sweep of the regrid kernels (``csrc/spmm.cu``): the
dest-small kernel (K2) at every warps-per-row and unroll it has an instance
for, and the dest-ice kernel (K1) at every chunk of fields a thread holds
and register cap, in both field layouts, on the main path's matrices,
beside their stage-1 kernels and ``torch.sparse.mm`` (cuSPARSE).
``ops/apply.py``'s ``small_geometry`` and ``ice_geometry`` are the rules
this sweep settled.

    python -m icebin_tpu_torch.tools.sweep_spmm [--config 3 5] [--nv 16 64]
        [--device cuda|cpu]

``--config 3`` is bench.py's Greenland 5 km under ModelE 2x2.5 with 5
elevation classes, ``5`` Antarctica 5 km on bench.py:101-113's lattice
under the same atmosphere, ``synth`` the matrix of ``probe_k2.synth``; each
gives EvI and AvI (K2) and IvE (K1) from the initial ice surface. The field
of nv columns is ``probe_k2.fields(n_src, nv, seed=nv)`` (NaN and inf
sources). Prints one JSON line per case: the kernel, its matrix (live rows,
nonzeros), nv and geometry, device ms (CUDA events over REPS calls after a
sleep kernel) beside the bound (``spmm_bound``), whether the result is bit
for bit its plain version (K2: ``spmm_dest_small_ref`` at that many warps;
K1 and the stage-1 kernels: K1's order, ``k1probe.spmm_ice_slots_ref(.,
1)``, or ``k2probe.spmm_small_slots_ref(., 1)``), and the card. The stage-1
kernels are ``k2probe.spmm_small_slots(1)`` (the stage-1 K2: a warp a row,
every row) and ``k1probe.spmm_ice_slots(1)`` and ``spmm_ice_ablate("row")``
(the stage-1 K1: a thread an output; and a thread a row, 16 fields a pass).
``--device cpu`` runs the plain versions and times nothing (every ms null:
a CPU time is not the card's).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from icebin_tpu_torch.tools.common import (HCDEFS, antarctica_spec,
                                           card_name, greenland_specs,
                                           library_spmm, same, spmm_bound,
                                           time_ms)
from icebin_tpu_torch.tools.probe_k2 import fields, synth

__all__ = ["REPS", "WARPS", "UNROLL", "CHUNKS", "ICE_MINB", "matrices",
           "sweep", "main"]

REPS = 50
#: the geometries the kernels have instances for
WARPS = (1, 2, 4, 8, 16, 32)
UNROLL = (1, 2, 4)
CHUNKS = (4, 8, 16, 32, 64)
ICE_MINB = (1, 8)


def matrices(config, device):
    """{name: csr}: the dest-small CSRs of EvI and AvI and the dest-ice CSR
    of IvE for ``config`` ("3", "5" or "synth")."""
    from icebin_tpu_torch.ops.csr import csr_pack
    if config == "synth":
        pack = csr_pack(synth(), nv=16, device=device)
        return {"EvI": pack.small, "IvE": pack.ice}
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
    sc = IceSheetCoupler(gr, name, CouplerConfig(), device=device)
    return {"EvI": sc.mat("EvI").pack.small, "AvI": sc.mat("AvI").pack.small,
            "IvE": sc.mat("IvE").pack.ice}


def sweep(csr, name, nv, reps=REPS):
    """The cases of one matrix at nv fields: a list of dicts (module
    docstring); no time for ``reps=0``."""
    from icebin_tpu_torch.ops import k1probe, k2probe
    from icebin_tpu_torch.ops.apply import (_ice, _small,
                                            spmm_dest_small_ref)
    device = csr.device
    xt = torch.as_tensor(fields(csr.n_src, nv, seed=nv), device=device)
    xf = xt.t().contiguous()
    cuda = device.type == "cuda"
    bound_ms, bound_by = spmm_bound(csr, nv)
    small = name != "IvE"
    stage1 = (k2probe.spmm_small_slots_ref(csr, xt, 1) if small
              else k1probe.spmm_ice_slots_ref(csr, xt, 1))
    res = []

    def case(kernel, geometry, fn, want, rows=lambda a: a):
        got = rows(fn()) if cuda else want
        if cuda:
            torch.cuda.synchronize()
        res.append({"kernel": kernel, "matrix": name, "nv": nv,
                    "live_rows": csr.n_live, "nnz": csr.vals.numel(),
                    "geometry": geometry,
                    "ms": time_ms(fn, reps) if cuda and reps else None,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "equals_plain": same(got, want)})

    if small:
        for w in WARPS:
            want = spmm_dest_small_ref(csr, xt, True, w)
            for u in UNROLL:
                case("spmm_dest_small", {"warps": w, "unroll": u},
                     lambda: _small(csr, xt, True, w, u), want)
        case("spmm_small_slots", {"nslot": 1},
             lambda: k2probe.spmm_small_slots(csr, xt, 1), stage1)
    else:
        for ch in CHUNKS:
            for mb in ICE_MINB:
                for f in (False, True):
                    case("spmm_dest_ice",
                         {"chunk": ch, "min_blocks": mb,
                          "layout": "(nv, n)" if f else "(n, nv)"},
                         lambda: _ice(csr, xf if f else xt, True, f, ch, mb),
                         stage1, (lambda a: a.t()) if f else (lambda a: a))
        case("spmm_ice_slots", {"nslot": 1},
             lambda: k1probe.spmm_ice_slots(csr, xt, 1), stage1)
        case("spmm_ice_ablate", {"mode": "row"},
             lambda: k1probe.spmm_ice_ablate(csr, xt, "row"), stage1)
    spmm = library_spmm(csr, xt)
    res.append({"kernel": "torch.sparse.mm", "matrix": name, "nv": nv,
                "live_rows": csr.n_live, "nnz": csr.vals.numel(),
                "geometry": None,
                "ms": time_ms(spmm, reps) if cuda and reps else None,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "equals_plain": None})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sweep_spmm", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--config", nargs="+", default=["3", "5"],
                    choices=["3", "5", "synth"])
    ap.add_argument("--nv", type=int, nargs="+", default=[16, 64])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run the plain "
                 "versions on the CPU")
    card = card_name() if device.type == "cuda" else "cpu"
    ok = True
    for config in args.config:
        for name, csr in matrices(config, device).items():
            for nv in args.nv:
                for c in sweep(csr, name, nv):
                    ok &= c["equals_plain"] is not False
                    print(json.dumps({"config": config, "device": card, **c}),
                          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
