"""Coupling steps completed in the window over the window's wall time, in
the cells that regenerate: every step counts, regenerations, E1vE0,
captures, reruns, fetches and the C ABI's host work included (each sheet
advances one dt a step)."""


def read(run):
    return run.steps / run.window_s
