"""Device ms of a regeneration: the union of the device's operations in
the profiled segment clipped to each of the harness's ``regen``
annotations (a sheet's regenerating ``_regen_if_due`` call), averaged
over the annotations.  Beside ``regen.ms`` (the same calls' host time in
the untraced window) it splits a regeneration into device work and host
glue; it moves steps_per_s."""


def clipped_union_us(intervals, t0, t1) -> float:
    """Length of the union of (start, end) ``intervals`` inside [t0, t1]."""
    total, end = 0.0, t0
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, t1)
        if e > s:
            total += e - s
            end = e
    return total


def read(run):
    tr = run.trace
    if tr is None or not tr.dev:
        return None
    marks = [(s, e) for name, s, e in tr.marks if name == "regen"]
    if not marks:
        return None
    dev = [(s, e) for _, s, e in tr.dev]
    return 1e-3 * sum(clipped_union_us(dev, s, e)
                      for s, e in marks) / len(marks)
