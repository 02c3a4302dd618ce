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

Memory: on the card the caller gives the side stream (``stream``), and a
caller that captures again and again (a coupler, once a matrix
generation) gives the same one every time, so each warm-up reuses the
blocks the last one freed on it.  It also names the graph the new one
replaces (``replaces``, ``release``d: its static buffers freed, its graph
kept): the new graph is captured into that graph's memory pool, whose
blocks it takes over, and the old graph is then reset.  With a fresh
stream and pool each time the card's reserved memory grows by both every
capture, until a capture (which may not free cached memory) runs out.

The regrid wrappers count their launches in Python (``.launches`` of
``ops.apply.spmm_dest_small`` and ``spmm_dest_ice``).  Under capture that
code runs once, so the counts a capture adds are taken back and recorded as
the graph's launches, and every replay adds them again: each count stays
the number of times its kernel ran.
"""
from __future__ import annotations

import time

import torch

from icebin_tpu_torch.ops.apply import spmm_dest_ice, spmm_dest_small
from icebin_tpu_torch.utils.trace import span

__all__ = ["StepGraph"]

#: the kernel wrappers whose ``.launches`` a replay adds to
COUNTED = (spmm_dest_small, spmm_dest_ice)


class StepGraph:
    """``fn(*inputs) -> tuple of tensors`` as one CUDA graph (module
    docstring); ``capture_ms`` is the host time of the warm-up and capture
    (None on the CPU, where ``graph`` is None)."""

    def __init__(self, fn, inputs, *, stream=None, replaces=None):
        """On the card the warm-up and the capture run on ``stream``, and
        the graph allocates from the pool of ``replaces`` (a released
        ``StepGraph``, reset once this one is captured; a pool of its own
        if None)."""
        self.fn = fn
        self.inputs = tuple(x.clone() for x in inputs)
        self.outputs = None
        self.graph = None
        self.launches = {}
        self.capture_ms = None
        try:
            if self.inputs[0].device.type == "cuda":
                if stream is None:
                    raise ValueError("a capture on the card needs a side "
                                     "stream")
                old = None if replaces is None else replaces.graph
                with span("step.capture"):
                    self._capture(self.inputs[0].device, stream,
                                  None if old is None else old.pool())
        finally:
            if replaces is not None:
                replaces.reset()

    def _capture(self, dev, side, pool) -> None:
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(dev)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
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
        main.wait_stream(side)
        self.launches = dict(zip(COUNTED, captured))
        self.graph = graph
        self.capture_ms = 1e3 * (time.perf_counter() - t0)

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

    def release(self) -> None:
        """Free the static buffers but keep the graph, so that its pool's
        blocks are free for the graph that ``replaces`` it; the graph is
        not run again, and ``reset`` frees it."""
        self.fn = self.inputs = self.outputs = None

    def reset(self) -> None:
        """Free the graph, its pool and the static buffers."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.inputs = self.outputs = None
