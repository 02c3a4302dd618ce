"""The fold probe: the four sublane<->lane folds of ``ops/foldprobe.py``
(``csrc/foldprobe.cu``) through shared memory and through warp shuffles,
in f32 and f64, on B tiles -- the port's counterpart of the TPU probe
``tools/probe_fold_ops.py``, which asked whether Mosaic compiles these
folds; here every fold compiles and the question is what each route costs.

    python -m icebin_tpu_torch.tools.probe_fold_ops [--device cuda|cpu]
        [--blocks 1 64 64800]

The inputs are the TPU probe's, drawn in its order from
``default_rng(0)``: a (32, 8) and a (4, 64) tile for B = 1, then its (64,
32, 8) block input for B = 64 (and one more (64, 4, 64) draw for the folds
that go back); other B draw from ``default_rng(B)``.  f64 runs the same
values widened.  B = 64,800 is one tile per E row of Greenland's EvI, the
dest-small kernel's warps per launch.

Prints one JSON line per fold, route, type and B: device ms (CUDA events
over REPS calls after a sleep kernel) beside the bound (bytes in and out
over 3.35 TB/s), the plain version's ms (torch.reshape / torch.cat) and the
library ms (the one PyTorch call that makes the same layout as a copy:
``.reshape(...).clone()`` for a reshape, the middle axes of ``view(B, 8,
4, 8)`` (``view(B, 4, 8, 8)`` going back) swapped by ``permute`` and
copied by ``reshape`` for the V1 folds), whether the result is bit for bit
the plain version's and the library's, whether a rerun is bit-identical,
and the kernel's launches in the timed calls.  Then the TPU probe's two
semantic checks, on its (32, 8) tile through both routes: "reshape matches
row-major fold" (and whether the V1 fold does: it must not) and
"slice+concat == V1 fold".  The default device is cuda, which needs a GPU;
``--device cpu`` runs the plain versions and times nothing (every ms null).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from icebin_tpu_torch.ops.foldprobe import (DOWN, FOLDS, ROUTES, fold_tiles,
                                            fold_tiles_ref)
from icebin_tpu_torch.tools.common import bound, card_name, same, time_ms

__all__ = ["REPS", "DTYPES", "tiles", "library_fold", "run_cases",
           "semantic_checks", "main"]

REPS = 50
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def tiles(blocks):
    """(B, 32, 8) and (B, 4, 64) f32 numpy inputs for B = ``blocks`` (module
    docstring)."""
    rng = np.random.default_rng(0)
    x328 = rng.uniform(-1, 1, (32, 8)).astype(np.float32)
    x464 = rng.uniform(-1, 1, (4, 64)).astype(np.float32)
    if blocks == 1:
        return x328[None], x464[None]
    x_big = rng.uniform(-1, 1, (64, 32, 8)).astype(np.float32)
    if blocks == 64:
        return x_big, rng.uniform(-1, 1, (64, 4, 64)).astype(np.float32)
    rng = np.random.default_rng(blocks)
    return (rng.uniform(-1, 1, (blocks, 32, 8)).astype(np.float32),
            rng.uniform(-1, 1, (blocks, 4, 64)).astype(np.float32))


def library_fold(x, fold):
    """A function of no argument: the one PyTorch call that makes ``fold``'s
    layout of ``x`` as a copy."""
    B = x.shape[0]
    if fold == "reshape_down":
        return lambda: x.reshape(B, 4, 64).clone()
    if fold == "reshape_up":
        return lambda: x.reshape(B, 32, 8).clone()
    if fold == "v1_fold":            # rows (r, t) -> (t, r)
        return lambda: x.view(B, 8, 4, 8).permute(0, 2, 1, 3).reshape(
            B, 4, 64)
    return lambda: x.view(B, 4, 8, 8).permute(0, 2, 1, 3).reshape(B, 32, 8)


def run_cases(blocks, device, reps=REPS):
    """Every fold, route and type at each B of ``blocks`` on ``device``: a
    list of dicts (module docstring).  The plain version and the library
    call are timed once per fold, type and B; each kernel's launch counter
    is set to 0 just before its timed calls and read just after.  With
    ``reps=0`` nothing is timed and every ms is None."""
    res = []
    for B in blocks:
        a, b = tiles(B)
        for tname, dtype in DTYPES.items():
            xa = torch.as_tensor(a, device=device).to(dtype)
            xb = torch.as_tensor(b, device=device).to(dtype)
            for fold in FOLDS:
                x = xa if fold in DOWN else xb
                nbytes = 2 * x.numel() * x.element_size()
                bound_ms, bound_by = bound(nbytes, 0)
                lib = library_fold(x, fold)
                want, got_lib = fold_tiles_ref(x, fold), lib()
                plain_ms = lib_ms = None
                if reps:
                    plain_ms = time_ms(lambda: fold_tiles_ref(x, fold), reps)
                    lib_ms = time_ms(lib, reps)
                for route in ROUTES:
                    ms = launches = None
                    if reps:
                        fold_tiles.launches = 0
                        ms = time_ms(lambda: fold_tiles(x, fold, route),
                                     reps)
                        launches = fold_tiles.launches
                    got = fold_tiles(x, fold, route)
                    again = fold_tiles(x, fold, route)
                    res.append({
                        "fold": fold, "route": route, "dtype": tname,
                        "blocks": B, "MB": nbytes / 1e6, "ms": ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "plain_ms": plain_ms, "library_ms": lib_ms,
                        "max_abs_err": float((got - want).abs().max()),
                        "equals_plain": same(got, want),
                        "equals_library": same(got, got_lib),
                        "rerun_identical": same(got, again),
                        "launches": launches})
    return res


def semantic_checks(device):
    """The TPU probe's checks on its (32, 8) tile, through ``fold_tiles``
    on ``device`` by every route: {check: bool}."""
    a = tiles(1)[0]
    x = torch.as_tensor(a, device=device)
    row_major = a[0].reshape(4, 64)
    v1 = np.concatenate([a[0][r * 4:(r + 1) * 4] for r in range(8)], axis=1)

    def every(fold, want):
        return all(np.array_equal(fold_tiles(x, fold, r)[0].cpu().numpy(),
                                  want) for r in ROUTES)

    return {"reshape matches row-major fold": every("reshape_down",
                                                    row_major),
            "slice+concat matches row-major fold": every("v1_fold",
                                                         row_major),
            "slice+concat == V1 fold": every("v1_fold", v1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_fold_ops", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--blocks", type=int, nargs="+", default=[1, 64, 64800])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run the plain "
                 "versions on the CPU")
    cuda = device.type == "cuda"
    card = card_name() if cuda else "cpu"
    for c in run_cases(args.blocks, device, REPS if cuda else 0):
        print(json.dumps({"device": card, **c}), flush=True)
    for check, value in semantic_checks(device).items():
        print(json.dumps({"device": card, "check": check, "value": value}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
