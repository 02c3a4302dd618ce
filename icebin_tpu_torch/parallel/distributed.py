"""Process groups, rank launch and field placement (port of
``icebin_tpu/parallel/distributed.py``).

The reference joins JAX's multi-controller runtime (``init_multihost``) and
builds global sharded arrays from per-host slabs.  The port runs one
process per rank over ``torch.distributed``:

* ``init_multihost`` joins the process group from explicit arguments or
  from the torchrun environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``), with an explicit collective timeout;
* ``launch`` starts N local rank processes that meet through a file store
  and runs one function in each -- torch's process model standing in for
  the reference's single controller over N devices (the tests, the ``run``
  CLI's ``--mesh`` and ``chip_smoke.py`` start their ranks with it; a
  multi-card host can use torchrun instead);
* ``local_ice_range`` is the rank's contiguous cell range;
* ``global_field`` scatters y-blocks from one rank, ``replicated_field``
  broadcasts one rank's value.

    python -m icebin_tpu_torch.parallel.distributed JOB RANK

is a rank process's own entry (``launch`` starts it).
"""
from __future__ import annotations

import datetime
import importlib
import inspect
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["TIMEOUT", "init_multihost", "launch", "local_ice_range",
           "global_field", "replicated_field"]

#: timeout of every collective of a process group opened here
TIMEOUT = datetime.timedelta(seconds=300)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def init_multihost(init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None, *, backend: str,
                   timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join the process group (once per process, before any collective).

    With no arguments the torchrun environment is read (``env://``);
    otherwise ``init_method`` ("file://...", "tcp://host:port"),
    ``world_size`` and ``rank`` are given explicitly."""
    if init_method is None and world_size is None and rank is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"no process group arguments and no torchrun "
                               f"environment (missing {missing})")
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)


def local_ice_range(mesh, nice: int,
                    cells_per_shard: Optional[int] = None) -> tuple:
    """[start, stop) of the global ice axis this rank owns: contiguous
    ranges of ``cells_per_shard`` cells (default ceil(nice / ranks)), the
    last ones shorter or empty."""
    cps = cells_per_shard or -(-nice // mesh.size)
    return (min(mesh.rank * cps, nice), min((mesh.rank + 1) * cps, nice))


def global_field(mesh, host_value: Optional[np.ndarray], src: int = 0):
    """This rank's y-block of rank ``src``'s ``host_value`` (its leading
    axis a multiple of the ranks; other ranks pass None): a scatter, so
    only the owner's rows reach each rank."""
    if mesh.rank == src:
        a = torch.as_tensor(np.ascontiguousarray(host_value))
        if a.shape[0] % mesh.size:
            raise ValueError(f"{a.shape[0]} rows do not split over "
                             f"{mesh.size} ranks")
        meta = [tuple(a.shape), a.dtype]
    else:
        meta = [None, None]
    with mesh.timer("coll"):
        dist.broadcast_object_list(meta, src)
    shape, dtype = meta
    block = (shape[0] // mesh.size,) + tuple(shape[1:])
    # a set-up path: gloo on a CUDA device scatters host tensors
    comm = torch.device("cpu") if mesh.staged else mesh.device
    out = torch.empty(block, dtype=dtype, device=comm)
    parts = (list(a.to(comm).chunk(mesh.size)) if mesh.rank == src
             else None)
    with mesh.timer("coll"):
        dist.scatter(out, parts, src)
    return out.to(mesh.device)


def replicated_field(mesh, host_value: Optional[np.ndarray], src: int = 0):
    """Rank ``src``'s ``host_value`` on every rank (a broadcast; other
    ranks pass None)."""
    meta = ([np.ascontiguousarray(host_value)] if mesh.rank == src
            else [None])
    with mesh.timer("coll"):
        dist.broadcast_object_list(meta, src)
    return torch.as_tensor(meta[0], device=mesh.device)


# -- launching rank processes ------------------------------------------------

def _target(fn):
    """(module, qualname, directory to import it from) of a module-level
    function (one of a script run as ``__main__`` is imported by the
    script's name)."""
    mod = fn.__module__
    src = os.path.abspath(inspect.getfile(fn))
    path = os.path.dirname(src)
    if mod == "__main__":
        mod = os.path.splitext(os.path.basename(src))[0]
    depth = mod.count(".")
    for _ in range(depth):
        path = os.path.dirname(path)
    return mod, fn.__qualname__, path


def launch(fn, n: int, *, backend: str, device, args: tuple = (),
           timeout: Optional[float] = 600.0, nice: int = 0) -> list:
    """Run ``fn(mesh, *args)`` in ``n`` new rank processes joined into one
    process group and return their results in rank order.

    ``fn`` is a module-level function and ``args`` and its results pickle.
    Each rank runs one intra-op thread, meets the others through a file
    store in a fresh temporary directory and builds its 1-D mesh on
    ``device`` (``make_mesh``); its collectives time out after ``TIMEOUT``.
    The whole launch times out after ``timeout`` seconds (None: no limit
    but the collectives'): the ranks are killed and TimeoutError raised.
    A failed rank raises RuntimeError with the tail of its log.  ``nice``
    lowers the ranks' scheduling priority (a test suite's ranks yield to
    its other workers).
    Kernels are not built here: build them in the caller first, so the
    ranks find them built."""
    from icebin_tpu_torch.parallel.mesh import rank_device
    rank_device(backend, device, n, 0)        # nccl: enough devices?
    with tempfile.TemporaryDirectory() as d:
        job = os.path.join(d, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump({"target": _target(fn), "args": args, "n": n,
                         "backend": backend, "device": str(device),
                         "store": os.path.join(d, "store"),
                         "nice": nice}, f)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
        logs = [open(os.path.join(d, f"rank{r}.log"), "w+")
                for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "icebin_tpu_torch.parallel.distributed",
             job, str(r)], stdout=logs[r], stderr=subprocess.STDOUT,
            env=env, cwd=os.getcwd()) for r in range(n)]
        deadline = time.monotonic() + (timeout or float("inf"))
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{n} ranks did not finish in {timeout:g} s:\n"
                        + _tails(logs))
                if any(p.poll() not in (None, 0) for p in procs):
                    time.sleep(2.0)   # let the others fail on their own
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"ranks {bad} of {n} failed:\n"
                               + _tails(logs, bad))
        out = []
        for r in range(n):
            with open(os.path.join(d, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        for log in logs:
            log.close()
        return out


def _tails(logs, which=None, nbytes=3000) -> str:
    out = []
    for r, log in enumerate(logs):
        if which is not None and r not in which:
            continue
        log.flush()
        log.seek(0)
        out.append(f"--- rank {r} ---\n{log.read()[-nbytes:]}")
    return "\n".join(out)


def _rank_main(job: str, rank: int) -> None:
    """One rank of ``launch``: join, run, write the result, leave."""
    torch.set_num_threads(1)
    with open(job, "rb") as f:
        spec = pickle.load(f)
    if spec["nice"]:
        os.nice(spec["nice"])
    mod, qual, path = spec["target"]
    if path not in sys.path:
        sys.path.insert(0, path)
    fn = importlib.import_module(mod)
    for part in qual.split("."):
        fn = getattr(fn, part)
    from icebin_tpu_torch.parallel.mesh import make_mesh
    init_multihost("file://" + spec["store"], spec["n"], rank,
                   backend=spec["backend"])
    try:
        mesh = make_mesh(spec["n"], backend=spec["backend"],
                         device=spec["device"])
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        out = fn(mesh, *spec["args"])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(os.path.dirname(job), f"out{rank}.pkl"),
              "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
