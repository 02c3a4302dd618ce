"""Rank meshes for ice-domain decomposition (port of
``icebin_tpu/parallel/mesh.py``; ``make_mesh_2d`` ports
``icebin_tpu/parallel/coupled.py:313``).

The reference decomposes the ice lattice's y axis over one axis ("ice") of
a JAX device mesh and runs one program over all devices (``shard_map``).
The port runs one process per rank over ``torch.distributed``: an
``IceMesh`` is this process's view of the decomposition (its rank, the
world size, the process group and the rank's ``torch.device``) plus the
collectives the decomposed code needs, in the port's idiom:

* ``exchange`` (``batch_isend_irecv``) replaces ``ppermute``;
* ``max`` (``all_reduce(MAX)``) replaces ``pmax``: a max is exact, so the
  order of the reduction does not matter;
* ``sum_ranks`` replaces ``psum``: the partials are gathered and added in
  f64 in rank order, so a sum is the same bits on every rank and in every
  run at one world size (``all_reduce(SUM)``'s order belongs to the backend
  and its algorithm, and the port adds no floats in an order it does not
  fix).

Backends are the caller's explicit choice: ``"nccl"`` (CUDA tensors, one
device per rank; more ranks on a host than it has CUDA devices raises) or
``"gloo"`` (on CUDA devices several ranks may share one card).  gloo's
``all_gather`` and ``all_reduce`` take CUDA tensors, but its ``send`` and
``recv`` read host memory: on a CUDA device the point-to-point transfers
(halos, the build's ring) stage through pinned host buffers, kept for reuse
by slot, shape and dtype (``IceMesh.staged``), and the time of those copies
is kept apart (``IceMesh.ms["stage"]``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["ICE_AXIS", "ICE_X", "ICE_Y", "IceMesh", "MeshAxis",
           "make_mesh", "make_mesh_2d", "rank_device"]

ICE_AXIS = "ice"
ICE_Y = "icey"
ICE_X = "icex"

_F64 = torch.float64


@dataclasses.dataclass
class MeshAxis:
    """One axis of a mesh as this rank sees it: its place along the axis
    and the global ranks on it, in order (``group`` is their process group;
    None for the whole world)."""

    name: str
    index: int
    ranks: tuple
    group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def neighbour(self, step: int) -> Optional[int]:
        """Global rank ``step`` places along the axis, or None past an end
        (the axis does not wrap)."""
        k = self.index + step
        return self.ranks[k] if 0 <= k < self.size else None


@dataclasses.dataclass
class IceMesh:
    """This process's rank of a 1-D (``ICE_AXIS``) or 2-D (``ICE_Y`` x
    ``ICE_X``) mesh, and its collectives.  ``ms`` accumulates host ms spent
    in halo exchanges, in the other collectives and in gloo's host staging;
    with ``timing`` on, the device is synchronised before each is timed so
    the time is the communication's own.  ``calls`` counts the
    collectives by kind (one ``max`` a substep of the decomposed SIA).
    At most one ``exchange`` is in flight at a time (its staging buffers
    are reused by the next)."""

    rank: int
    size: int
    backend: str
    device: torch.device
    axes: dict
    shape: tuple
    timing: bool = False
    ms: dict = dataclasses.field(
        default_factory=lambda: {"halo": 0.0, "coll": 0.0, "stage": 0.0})
    calls: dict = dataclasses.field(
        default_factory=lambda: {"gather": 0, "max": 0, "exchange": 0})
    _pinned: dict = dataclasses.field(default_factory=dict, repr=False)
    _in_flight: bool = dataclasses.field(default=False, repr=False)

    def axis(self, name: Optional[str] = None) -> MeshAxis:
        """The axis ``name``; None: the whole mesh in rank order."""
        if name is None:
            return MeshAxis("world", self.rank, tuple(range(self.size)))
        return self.axes[name]

    @property
    def staged(self) -> bool:
        """True when point-to-point transfers copy through pinned host
        memory (gloo on a CUDA device)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @contextlib.contextmanager
    def timer(self, key: str):
        if self.timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        try:
            yield
        finally:
            if self.timing and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.ms[key] += 1e3 * (time.perf_counter() - t)

    def _host(self, slot, t: torch.Tensor) -> torch.Tensor:
        """The pinned host buffer of ``slot`` for t's shape and dtype."""
        key = (slot, tuple(t.shape), t.dtype)
        if key not in self._pinned:
            self._pinned[key] = torch.empty(t.shape, dtype=t.dtype,
                                            pin_memory=True)
        return self._pinned[key]

    def all_gather(self, t: torch.Tensor,
                   axis: Optional[str] = None) -> torch.Tensor:
        """(axis size, *t.shape): every rank's ``t`` in axis order."""
        ax = self.axis(axis)
        x = t.contiguous()
        self.calls["gather"] += 1
        with self.timer("coll"):
            parts = [torch.empty_like(x) for _ in range(ax.size)]
            dist.all_gather(parts, x, group=ax.group)
            return torch.stack(parts)

    def sum_ranks(self, *partials: torch.Tensor, axis: Optional[str] = None):
        """Each partial summed over the ranks of ``axis`` in f64, in rank
        order (one gather for all of them); returns f64 tensors of the
        partials' shapes and memory layouts (a later reduction over a
        total then adds in the order it would over the partial: at one
        rank the totals are the partials, bit for bit downstream too)."""
        flat = torch.cat([p.reshape(-1).to(_F64) for p in partials])
        g = self.all_gather(flat, axis)
        tot = g[0]
        for r in range(1, g.shape[0]):
            tot = tot + g[r]
        out, k = [], 0
        for p in partials:
            out.append(torch.empty_like(p, dtype=_F64).copy_(
                tot[k:k + p.numel()].reshape(p.shape)))
            k += p.numel()
        return tuple(out)

    def max(self, t: torch.Tensor, axis: Optional[str] = None):
        """Elementwise max of ``t`` over the ranks of ``axis``."""
        ax = self.axis(axis)
        x = t.clone(memory_format=torch.contiguous_format)
        self.calls["max"] += 1
        with self.timer("coll"):
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=ax.group)
        return x

    def exchange(self, sends, recvs, key: str = "coll", wait: bool = True):
        """Point-to-point transfers in one batch: ``sends`` are (tensor,
        global rank), ``recvs`` (template tensor giving shape and dtype,
        global rank).  Returns the received tensors in ``recvs``' order on
        this rank's device, or, with ``wait=False``, a function that waits
        for them and returns them (the transfers run meanwhile; the next
        exchange starts after it is called).  Staged, a CUDA tensor is
        copied to the pinned buffer of its place in ``sends`` before the
        batch starts, and each received buffer to the device after it
        ends."""
        if self._in_flight:
            raise RuntimeError("an exchange is in flight: wait for it first")
        ops, bufs = [], []
        for i, (t, peer) in enumerate(sends):
            t = t.contiguous()
            if self.staged and t.is_cuda:
                with self.timer("stage"):
                    t = self._host(("send", i), t).copy_(t)
            ops.append(dist.P2POp(dist.isend, t, peer))
        for i, (t, peer) in enumerate(recvs):
            b = (self._host(("recv", i), t) if self.staged
                 else torch.empty(t.shape, dtype=t.dtype, device=self.device))
            bufs.append(b)
            ops.append(dist.P2POp(dist.irecv, b, peer))
        reqs = dist.batch_isend_irecv(ops) if ops else []
        self.calls["exchange"] += 1
        self._in_flight = True

        def finish():
            with self.timer(key):
                for r in reqs:
                    r.wait()
            self._in_flight = False
            if not self.staged:
                return bufs
            with self.timer("stage"):
                return [b.to(self.device, copy=True) for b in bufs]

        return finish() if wait else finish

    def barrier(self) -> None:
        with self.timer("coll"):
            dist.barrier()


def rank_device(backend: str, device, size: int, rank: int) -> torch.device:
    """The device of ``rank`` of a ``size``-rank group: the CPU, or a CUDA
    device (an explicit index is kept; otherwise the rank's local index
    modulo the host's devices, so gloo ranks share a card when there are
    more ranks than cards).  NCCL needs a CUDA device of its own for every
    rank on the host: more local ranks than devices raise, and so does
    NCCL on the CPU."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    device = torch.device(device)
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl runs on CUDA devices; use gloo on the CPU")
        return device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl" and local_size > n_dev:
        raise ValueError(f"nccl with {local_size} ranks on this host needs "
                         f"{local_size} CUDA devices, it has {n_dev}; use "
                         "fewer ranks, or gloo to share a device")
    if n_dev == 0:
        raise RuntimeError("no CUDA device")
    if device.index is not None and backend == "gloo":
        return device
    return torch.device("cuda", local_rank % n_dev)


def _joined(n, backend, device):
    """(rank, size, rank's device) of the process group, joining a
    one-rank group if none is open."""
    if not dist.is_initialized():
        if n not in (None, 1):
            raise RuntimeError(
                f"a {n}-rank mesh needs the process group: start the ranks "
                "with parallel.distributed.launch or torchrun "
                "(init_multihost)")
        dev = rank_device(backend, device, 1, 0)
        from icebin_tpu_torch.parallel.distributed import TIMEOUT
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    size, rank = dist.get_world_size(), dist.get_rank()
    if n is not None and n != size:
        raise ValueError(f"need {n} ranks, the process group has {size}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    return rank, size, rank_device(backend, device, size, rank)


def make_mesh(n: Optional[int] = None, *, backend: str,
              device) -> IceMesh:
    """1-D mesh over the ``n`` ranks of the process group (default: all),
    on ``device`` ("cpu", "cuda" or "cuda:k").  Without an open process
    group a one-rank group is joined."""
    rank, size, dev = _joined(n, backend, device)
    axis = MeshAxis(ICE_AXIS, rank, tuple(range(size)))
    return IceMesh(rank=rank, size=size, backend=backend, device=dev,
                   axes={ICE_AXIS: axis}, shape=(size,))


def make_mesh_2d(shape, *, backend: str, device) -> IceMesh:
    """(ny_dev, nx_dev) mesh with axes (``ICE_Y``, ``ICE_X``): rank
    iy * nx_dev + ix owns lattice block (iy, ix); each axis has its own
    process group (every rank creates every group, in one order)."""
    ny_dev, nx_dev = shape
    rank, size, dev = _joined(ny_dev * nx_dev, backend, device)
    from icebin_tpu_torch.parallel.distributed import TIMEOUT
    iy, ix = divmod(rank, nx_dev)
    axes = {}
    for ax in range(nx_dev):          # columns of ranks: the y axes
        ranks = tuple(y * nx_dev + ax for y in range(ny_dev))
        g = dist.new_group(list(ranks), timeout=TIMEOUT)
        if ax == ix:
            axes[ICE_Y] = MeshAxis(ICE_Y, iy, ranks, g)
    for ay in range(ny_dev):          # rows of ranks: the x axes
        ranks = tuple(ay * nx_dev + x for x in range(nx_dev))
        g = dist.new_group(list(ranks), timeout=TIMEOUT)
        if ay == iy:
            axes[ICE_X] = MeshAxis(ICE_X, ix, ranks, g)
    return IceMesh(rank=rank, size=size, backend=backend, device=dev,
                   axes=axes, shape=(ny_dev, nx_dev))
