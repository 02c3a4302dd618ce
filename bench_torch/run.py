#!/usr/bin/env python3
"""The benchmark of ``icebin_tpu_torch`` on an NVIDIA card: one run of one
cell.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The cell is looked up by name in
``BENCHMARK.json``; its configuration (``configs/<config>.json``), traffic
(``traffic/<traffic>.json``), limits (``limits/<cell>.json``), the two
halves of its GCM grid kind (``gcm/<kind>.py``,
``reference/gcm/<kind>.py``), the reference module its configuration
names (``reference/<module>.py``) and each metric's reader
(``metrics/<metric>.py``) are found by name under this directory.  With
``--trace 0`` the last line of standard output is the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, both as one JSON object
with ``correct``; the numbers compared are the last lines of standard
error.  Without a CUDA card (or with fewer than the cell asks for) it
prints no result and exits 2; where the run has loaded JAX or the JAX
package, it exits 3.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import os  # noqa: E402

# one process with few threads: the host's share of a step is single
# threaded numpy and Python, and idle worker threads only add noise
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "2"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def load_cell(name: str):
    """(workload, configuration, traffic, limits, BENCHMARK.json) of cell
    ``name``; stops where the configuration's GCM grid kind is unknown or
    does not drive the traffic (``harness/gcm.py``), where the traffic's
    driver cannot hand the program the configuration's regrid parameters
    (``harness/drivers.py``), or where its ``reference`` names no module
    that judges them (``harness/check.py``)."""
    from harness import check, drivers, gcm, system

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    try:
        gcm.find(cfg, traffic["driver"])
        drivers.DRIVERS[traffic["driver"]].refuse(cfg)
        check.reference(cfg)
    except (gcm.KindError, system.ParamsError, check.ModuleError) as e:
        raise SystemExit(f"run.py: cell {name}: {e}") from None
    return wl, cfg, traffic, limits, bench


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def foreign_modules():
    """Top-level names in ``sys.modules`` of JAX or of the JAX package,
    which a run of the port must not load (the port's own name begins with
    the JAX package's, so whole names are compared)."""
    return sorted({n.split(".")[0] for n in sys.modules}
                  & {"jax", "jaxlib", "flax", "icebin_tpu"})


def cell_metrics(bench, name, trace):
    """The metric entries this cell reports: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if name in m.get("workloads", [name])]


def measure(name, seed, seconds, trace, device, res_km=None, t_start=None):
    """One run of cell ``name``: (result dict, lines to print last on
    standard error)."""
    import torch

    from harness import check, common, drivers, gcm

    wl, cfg, traffic, limits, bench = load_cell(name)
    grid = gcm.load(cfg, traffic["driver"], seed)
    run = drivers.run_cell(cfg, traffic, seed, seconds, device, grid,
                           trace=trace, res_km=res_km, t_start=t_start)
    run.card = common.card() if device.type == "cuda" else "cpu"
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ok, table, where = check.check(cfg, traffic, run, seed, device, limits,
                                   grid, res_km)

    metrics = {}
    for m in cell_metrics(bench, name, trace):
        v = metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": ok, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    notes = [f"cell {name}: {run.steps} steps in {run.window_s:.3f} s, "
             f"{len(run.records)} periods compared (the ledger's largest "
             f"gap at {where}); card {run.card}"]
    ps = sorted(run.period_s)
    notes.append(f"periods: {len(ps)}, s each: min {ps[0]:.4f} median "
                 f"{ps[len(ps) // 2]:.4f} max {ps[-1]:.4f}; first "
                 f"{run.period_s[0]:.4f} last {run.period_s[-1]:.4f}")
    if run.step_s:
        p = common.p95(run.step_s)
        notes.append(f"step_ms_p95 over {len(run.step_s)} steps, "
                     f"{sum(s > p for s in run.step_s)} beyond it")
    if trace:
        tr = run.trace
        if tr is None or not tr.dev or tr.busy_s <= 0:
            raise RuntimeError("the profiler traced no device time")
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
        notes.append(f"spmm.roofline_pct against the H100 SXM data sheet "
                     f"(3.35 TB/s, 67 TFLOP/s f32) on a card of power "
                     f"limit: {run.card}")
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in table.items()}
    lines = [f"compared {k}: {v!r} limit {lim!r}"
             for k, (v, lim) in table.items()]
    return result, notes, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    # every cache of a run lives in the checkout, at a fixed path
    cache = ROOT / "build" / "bench_torch"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    import torch
    wl = load_cell(a.workload)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"run.py: cell {a.workload} needs {wl['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, notes, lines = measure(a.workload, a.seed, a.seconds,
                                   bool(a.trace), torch.device("cuda", 0),
                                   t_start=T0)
    bad = foreign_modules()
    if bad:
        print(f"run.py: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for n in notes:
        print(n, flush=True)
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
