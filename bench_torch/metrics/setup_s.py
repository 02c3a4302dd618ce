"""Process start to the first timed step: kernel and C ABI libraries,
exchange grids through the clip kernel, matrices, the warm-up period with
its captures."""


def read(run):
    return run.setup_s
