"""Mean host ms of a regeneration: each call of a sheet's _regen_if_due
that regenerates (matrix factory, packs, E1vE0), timed by the harness in a
--trace 1 window."""


def read(run):
    if not run.regen_s:
        return None
    return 1e3 * sum(run.regen_s) / len(run.regen_s)
