"""The 95th percentile over every step of the window of a GCM's stall: the
first gcmce_add_gcm_outpute of a step to the return of its
gcmce_couple_native (TOPO buffers filled)."""
from harness.common import p95


def read(run):
    if not run.step_s:
        return None
    return 1e3 * p95(run.step_s)
