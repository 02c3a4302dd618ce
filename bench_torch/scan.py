#!/usr/bin/env python3
"""The periods of a cell's run, each checked against the plain reference
right after it runs: where in a window's horizon ``correct`` would fail.

    python3 bench_torch/scan.py --workload <cell> --seed <n> \\
        --first <p> --last <p> [--every <k>]

Periods count from the run's first, the warm-up included.  The program
runs the cell's traffic from its set-up without a timed window; every
``k``-th period from ``first`` to ``last`` is held against the reference
from the program's own start state, as ``harness/check.py`` holds a
sampled period.  Prints one JSON line a checked period (its numbers and
those over the cell's limits) and a last line with the largest reading of
each number and the count of periods over.  The benchmark's own runs
never run this.  It runs on the card at the configured lattices; the CPU
tests call ``scan`` on toy lattices.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (str(HERE), str(HERE.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def scan(name, seed, first, last, every, device, res_km=None):
    """Yield (period, {number: reading}, [numbers over their limits]) of
    every ``every``-th period from ``first`` to ``last`` of cell
    ``name``."""
    from harness import check, drivers, gcm
    from reference.prec import REFERENCE
    import run as bench

    _, cfg, traffic, limits, _ = bench.load_cell(name)
    grid = gcm.load(cfg, traffic["driver"], seed)
    drv = drivers.DRIVERS[traffic["driver"]](cfg, traffic, seed, device,
                                             grid, res_km)
    drv.setup()
    abi = traffic["driver"] == "abi"
    inp = check.inputs(cfg, traffic, seed, device, REFERENCE, grid, res_km)
    nA, nhc = inp.sheets[0].xg.nA, inp.hcdefs.numel()
    mt = float(cfg["min_thickness"])
    try:
        for p in range(last + 1):
            if p < first or (p - first) % every:
                drv.period(None, [])
                continue
            rec, _ = drv.kept_period(p, [])
            out = check.run_period(inp, rec.start, rec.held0, rec.month0,
                                   rec.step0, REFERENCE, abi, mt)
            g, _ = check.numbers(rec, out, inp.sheets, nA, nhc, abi)
            g["transport"] = check.transport(rec.rows,
                                             [s.name for s in inp.sheets])
            yield p, g, sorted(k for k, v in g.items()
                               if not v <= limits.get(k, 0.0))
    finally:
        drv.free()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--last", type=int, required=True)
    ap.add_argument("--every", type=int, default=1)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("scan.py: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    worst, n_over = {}, 0
    for p, g, over in scan(a.workload, a.seed, a.first, a.last, a.every,
                           torch.device("cuda", 0)):
        print(json.dumps({"period": p, "numbers": g, "over": over}),
              flush=True)
        n_over += bool(over)
        for k, v in g.items():
            worst[k] = max(worst.get(k, 0.0), v)
    print(json.dumps({"workload": a.workload, "seed": a.seed,
                      "periods": [a.first, a.last, a.every],
                      "periods_over": n_over, "largest": worst,
                      "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
