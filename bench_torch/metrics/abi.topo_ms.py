"""Host ms a step in ModelEAdapter.topo (the TOPO fields a GCM reads back),
timed by the harness around the call in a --trace 1 window."""


def read(run):
    if not run.topo_s:
        return None
    return 1e3 * sum(run.topo_s) / run.steps
