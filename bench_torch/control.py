#!/usr/bin/env python3
"""The control of ``correct``: the plain reference, computed one step below
the configuration's precisions (``reference.prec.CONTROL``: f32 books,
TF32 applies), put in the program's place and held against the reference
with the same numbers the benchmark compares.

    python3 bench_torch/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed both run the cell's periods from the cell's initial state
(the reference's own state carried from period to period, the control
started from it each period) on the seed's forcing and held state; the
periods are the window's first ``sample_periods`` after its warm-up.
Prints one JSON line a seed: the control's reading of every number.  A
sound program must read below the cell's limits, the control above them
(``PERF.md`` gives both readings of every limit).  The benchmark's own
runs never run this.  It runs on the card at the configured lattices; the
CPU tests call ``readings`` on toy lattices.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))


def readings(name, seed, device, res_km=None):
    """The control's reading of each number of cell ``name``."""
    from harness import check, gcm
    from reference.prec import CONTROL, REFERENCE
    import run as bench

    _, cfg, traffic, limits, _ = bench.load_cell(name)
    abi = traffic["driver"] == "abi"
    grid = gcm.load(cfg, traffic["driver"], seed)
    ref = check.inputs(cfg, traffic, seed, device, REFERENCE, grid, res_km)
    ctl = check.inputs(cfg, traffic, seed, device, CONTROL, grid, res_km)
    names = [s.name for s in ref.sheets]
    nA, nhc = ref.sheets[0].xg.nA, ref.hcdefs.numel()
    mt = float(cfg["min_thickness"])
    start, held = check.initial(ref, traffic, seed, device)
    vals, rows = {}, []
    warm = int(traffic["warmup_periods"])
    for p in range(warm + int(traffic["sample_periods"])):
        out, nxt, held1 = check.advance(ref, start, held, p, REFERENCE, abi,
                                        mt)
        if p >= warm:
            step0 = p * ref.K
            c = check.run_period(ctl, start, held, step0 % len(ref.F), step0,
                                 CONTROL, abi, mt)
            rec = check.as_record(c, start, held, step0 % len(ref.F), step0,
                                  nA, nhc, abi)
            rows += rec.rows
            g, _ = check.numbers(rec, out, ref.sheets, nA, nhc, abi)
            for k, v in g.items():
                vals[k] = max(vals.get(k, 0.0), v)
        start, held = nxt, held1
    vals["transport"] = check.transport(rows, names)
    return vals, limits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for seed in a.seeds:
        t = time.perf_counter()
        vals, limits = readings(a.workload, seed, dev)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control": vals, "limits": limits,
                          "fails": sorted(k for k, v in vals.items()
                                          if not v <= limits.get(k, 0.0)),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
