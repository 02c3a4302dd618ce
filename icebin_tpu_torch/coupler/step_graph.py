"""One coupling step as a CUDA graph over static buffers: the port's
counterpart of the reference's ``jax.jit(self._couple_core)``
(``icebin_tpu/coupler/coupler.py:501-509``).

``StepGraph(fn, inputs)`` holds a copy of ``inputs`` as its static input
buffers.  On a CUDA device it runs ``fn`` once eagerly on a side stream
(which builds the kernel library and lets the allocator settle), then
captures ``fn`` over the static buffers into one ``torch.cuda.CUDAGraph``
with its own memory pool; ``run(inputs)`` copies ``inputs`` into the static
buffers and replays the graph.  On the CPU ``run`` calls ``fn`` eagerly on
the same buffers and copies its results into static output buffers, so the
caller sees the same contract on both devices: the outputs ``run`` returns
are overwritten by the next ``run``, and a caller that keeps one copies it
out first.

A capture that fails raises: nothing falls back to running ``fn``
eagerly on the card.

The graph is kept (``keep_graph=True``) beside its instantiation, so that
``rebind`` can point its dest-small launches at a new matrix generation
that the caller has loaded into the buffers the capture read
(``ops.csr.CsrBuffers``): no warm-up, capture or instantiation.
``capture`` captures ``fn`` again where more than that changed; the new
graph takes over the memory pool of the one it replaces, which is then
reset, and the warm-up runs on the side stream the caller gives
(``stream``, the same one every time), so each capture reuses the blocks
the last one freed.

The regrid and books wrappers count their launches in Python
(``.launches`` of ``ops.apply.spmm_dest_small`` and ``spmm_dest_ice``,
``ops.books.books_sum``, ``books_repair`` and ``books_stats``).  Under capture that
code runs once, so the counts a capture adds are taken back and recorded as
the graph's launches, and every replay adds them again: each count stays
the number of times its kernel ran.
"""
from __future__ import annotations

import time

import torch

from icebin_tpu_torch.ops.apply import (rebind_dest_small, spmm_dest_ice,
                                        spmm_dest_small)
from icebin_tpu_torch.ops.books import books_repair, books_stats, books_sum
from icebin_tpu_torch.utils.trace import span

__all__ = ["StepGraph"]

#: the kernel wrappers whose ``.launches`` a replay adds to
COUNTED = (spmm_dest_small, spmm_dest_ice, books_sum, books_repair,
           books_stats)


class StepGraph:
    """``fn(*inputs) -> tuple of tensors`` as one CUDA graph (module
    docstring); ``capture_ms`` is the host time of the last warm-up and
    capture (None on the CPU, where ``graph`` is None)."""

    def __init__(self, fn, inputs, *, stream=None):
        """On the card the warm-up and the capture run on ``stream``."""
        self.fn = fn
        self.stream = stream
        self.inputs = tuple(x.clone() for x in inputs)
        self.outputs = None
        self.graph = None
        self.launches = {}
        self.capture_ms = None
        #: the graph's dest-small launches by CSR, once ``rebind`` found them
        self._found = {}
        self.capture()

    def capture(self) -> None:
        """Capture ``fn`` over the static buffers (on the card; a no-op on
        the CPU), into the memory pool of the graph it replaces."""
        dev = self.inputs[0].device
        if dev.type != "cuda":
            return
        if self.stream is None:
            raise ValueError("a capture on the card needs a side stream")
        old, self.graph, self.outputs = self.graph, None, None
        self._found = {}
        try:
            with span("step.capture"):
                self._capture(dev, None if old is None else old.pool())
        finally:
            if old is not None:
                old.reset()

    def _capture(self, dev, pool) -> None:
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(dev)
        side = self.stream
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(side):
            self.fn(*self.inputs)                  # the warm-up
            before = [k.launches for k in COUNTED]
            try:
                graph.capture_begin(pool=pool)
                try:
                    self.outputs = tuple(self.fn(*self.inputs))
                finally:
                    # ends the capture whatever happened in it (raising if
                    # it was invalidated), so the stream leaves capture
                    graph.capture_end()
            finally:
                captured = [k.launches - n for k, n in zip(COUNTED, before)]
                for k, n in zip(COUNTED, before):
                    k.launches = n
            graph.instantiate()
        main.wait_stream(side)
        self.launches = dict(zip(COUNTED, captured))
        self.graph = graph
        self.capture_ms = 1e3 * (time.perf_counter() - t0)

    def rebind(self, small, nv: int) -> int:
        """Point the graph's dest-small launches at the new generation of
        the CSRs ``small`` (each loaded into the buffers the capture read):
        each launch over one of them takes the live count and geometry
        ``spmm_dest_small`` would give it now (``nv``: the packs' field
        batch).  Returns the launches updated (span ``step.rebind``,
        attribute ``nodes``); 0 on the CPU, which has no graph."""
        if self.graph is None:
            return 0
        want = self.launches.get(spmm_dest_small, 0)
        with span("step.rebind") as sp:
            n = sum(rebind_dest_small(self.graph, csr, nv, self._found, want)
                    for csr in small if csr.n_live > 0)
            if sp is not None:
                sp.attrs["nodes"] = n
        if n != want:
            raise RuntimeError(f"rebind updated {n} of the graph's {want} "
                               f"dest-small launches")
        return n

    def run(self, inputs):
        """Copy ``inputs`` into the static buffers and run the step; returns
        the static outputs (valid until the next ``run``)."""
        for buf, x in zip(self.inputs, inputs):
            if buf is not x:
                buf.copy_(x)
        if self.graph is not None:
            self.graph.replay()
            for k, n in self.launches.items():
                k.launches += n
            return self.outputs
        out = self.fn(*self.inputs)
        if self.outputs is None:
            self.outputs = tuple(o.clone() for o in out)
        else:
            for buf, o in zip(self.outputs, out):
                buf.copy_(o)
        return self.outputs

    def reset(self) -> None:
        """Free the graph, its pool and the static buffers."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.inputs = self.outputs = None
