"""Coupling steps completed in the window over the window's wall time, in
the one-way cells (no regeneration): every step counts, reruns and
fetches included (each sheet advances one dt a step)."""


def read(run):
    return run.steps / run.window_s
