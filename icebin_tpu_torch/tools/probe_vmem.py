"""The on-chip capacity probe: the largest (n, 128) f32 array whose input
and output one kernel holds whole in shared memory, for one block and for
a thread-block cluster of 2, 4, 8 and 16 blocks (``ops/smemprobe.py``,
``csrc/smemprobe.cu``) -- the port's counterpart of the TPU probe
``tools/probe_vmem.py``, which bisects the same pair of buffers in VMEM.

    python -m icebin_tpu_torch.tools.probe_vmem [--device cuda|cpu]

Prints the card's name and power limit, then one JSON line per scope: the
largest n (one row pair, in + out, is 1 KB, so n is also the pair in KB),
the cluster occupancy the card reports at n (null for one block), the
smallest n seen refused with its status and occupancy, the suggested
staging budget (80% of n, as the TPU probe suggests its ``vmem_limit``),
and at n: the kernel's device ms (CUDA events over REPS calls after a
sleep kernel) beside the bound (bytes in and out over 3.35 TB/s), the
plain version's and the library's ms (``x * 2.0`` and ``torch.mul``: the
same one PyTorch call), whether the result is bit for bit ``x * 2.0``, and
the kernel's launches over the bisect and the timed calls.  The default
device is cuda, which needs a GPU; ``--device cpu`` runs the plain version
at n = 224 and bisects nothing: the CPU has no shared memory to fill.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from icebin_tpu_torch.ops.smemprobe import (CLUSTERS, COLS, largest_rows,
                                            rows_data, smem_copy,
                                            smem_copy_ref)
from icebin_tpu_torch.tools.common import bound, card_name, same, time_ms

__all__ = ["REPS", "SCOPES", "BUDGET", "run", "main"]

REPS = 50
SCOPES = (("block", 1),) + tuple(("cluster", c) for c in CLUSTERS)
BUDGET = 0.8                 # the TPU probe's margin for a kernel's scratch


def run(device, reps=REPS):
    """Bisect every scope on ``device``'s card and time the kernel at the
    largest size found: a list of dicts (module docstring).  The launch
    counter is set to 0 just before each scope's bisect and read after its
    timed calls."""
    res = []
    for scope, cluster in SCOPES:
        smem_copy.launches = 0
        found = largest_rows(scope, cluster, device)
        n = found["rows"]
        x = rows_data(n, device)
        ms = time_ms(lambda: smem_copy(x, scope, cluster), reps)
        plain_ms = time_ms(lambda: smem_copy_ref(x), reps)
        library_ms = time_ms(lambda: torch.mul(x, 2.0), reps)
        got, want = smem_copy(x, scope, cluster), smem_copy_ref(x)
        torch.cuda.synchronize(device)
        bound_ms, bound_by = bound(2 * x.numel() * x.element_size(), n * COLS)
        res.append(dict(
            scope=scope, cluster=cluster, **found,
            per_block_kb=-(-n // cluster), budget_kb=int(BUDGET * n),
            ms=ms, bound_ms=bound_ms, bound_by=bound_by, plain_ms=plain_ms,
            library_ms=library_ms,
            max_abs_err=float((got - want).abs().max()),
            equals_plain=same(got, want), launches=smem_copy.launches))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_vmem", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run the plain "
                 "version on the CPU")
    if device.type == "cpu":
        x = rows_data(224, device)
        got = smem_copy(x)
        print(json.dumps({"device": "cpu", "rows": 224,
                          "equals_plain": same(got, smem_copy_ref(x)),
                          "note": "the plain version on the CPU; the CPU "
                                  "has no shared memory to bisect"}),
              flush=True)
        return 0
    card = card_name()
    print(card, flush=True)
    for r in run(device):
        print(json.dumps({"device": card, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
