"""Spans of the port's host work: where a coupled run's host time goes,
on the same clock as the device's kernels when a profiler is running.

A span is a named interval of host time (``time.perf_counter_ns``), the
index of the span that was open when it began (its parent), and a few
attributes (``sheet``: the ice sheet it worked on).  The program opens
them at its own layer boundaries:

* ``window``: one regeneration window of ``GCMCoupler.run_transient(...,
  fused=True)``; inside it ``window.forcing`` (a sheet's forcing
  assembled), ``window.launch`` (a sheet's K steps enqueued, or a budget
  rerun's) and ``window.fetch`` (the wait for the window's rows);
* ``regen``: a matrix regeneration (``IceSheetCoupler._regen_if_due``),
  its attributes ``path`` ``"device"`` or ``"host"`` and ``grid`` (the
  regridder's ``grid_kind``: ``"lonlat"``, or ``"modele_ocean"`` for
  ModelE's mismatched regridder); inside it
  ``regen.factory`` (the factory and its matrices' entries: on the host
  path with the elevation mask's fetch), ``regen.pack`` (the CSRs: host
  arrays, or built on the device), ``regen.upload`` (host path: the
  packs' copies to the device and what the device derives from them;
  device path: the exchange grid's one upload, at set-up; inside it,
  over ModelE's regridder, ``regen.retarget``: the O-level exchange
  cells moved to A and scaled, attributes ``cells``, the cells moved, and
  ``rescaled``, the A cells whose factor is not 1) and ``regen.e1ve0``
  (E1vE0 and the held state's remap);
* ``regen.topo``: the first fhc and elevE of a matrix generation;
* ``step.capture``: a CUDA graph capture of the compiled step.

No span opens inside a function a CUDA graph captures (it would run once,
at capture) or in the per-step replay loop.

The recorder is off by default; off, ``span`` costs one attribute check
and reads no clock.  On, spans stay in memory until ``drain`` takes them.
While a ``torch.profiler`` is running, each span also opens
``torch.profiler.record_function(PREFIX + name)``, so the profile holds it
beside the CUDA kernels (the profiler gives such a range a device-side
copy as well, which spans the device's idle time between the kernels
launched in it: a reader of device busy time leaves ``PREFIX`` ranges
out).  ``chrome_trace`` turns drained spans into Chrome trace-event JSON,
which Perfetto and ``chrome://tracing`` open.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch

__all__ = ["PREFIX", "Span", "Recorder", "RECORDER", "span", "drain",
           "recording", "chrome_trace"]

#: the name prefix of the spans' ranges in a torch.profiler trace
PREFIX = "icebin."

_OFF = contextlib.nullcontext()


class Span:
    """One finished (or, while open, unfinished: ``end`` None) span."""

    __slots__ = ("name", "start", "end", "parent", "attrs")

    def __init__(self, name: str, parent: Optional[int], attrs: dict):
        self.name = name
        self.parent = parent
        self.attrs = attrs
        self.start = self.end = None

    @property
    def ns(self) -> int:
        return self.end - self.start


class _Open:
    """The context of one span while it is open."""

    __slots__ = ("rec", "sp", "rf")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        stack = rec._stack
        self.rec = rec
        self.sp = Span(name, stack[-1] if stack else None, attrs)
        self.rf = (torch.profiler.record_function(PREFIX + name)
                   if torch.autograd._profiler_enabled() else None)

    def __enter__(self) -> Span:
        rec, sp = self.rec, self.sp
        rec._stack.append(len(rec.spans))
        rec.spans.append(sp)
        if self.rf is not None:
            self.rf.__enter__()
        sp.start = time.perf_counter_ns()
        return sp

    def __exit__(self, *exc) -> None:
        self.sp.end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec._stack.pop()


class Recorder:
    """Spans in one list, in the order they opened; ``on`` switches
    recording."""

    def __init__(self):
        self.on = False
        self.spans: List[Span] = []
        self._stack: List[int] = []

    def span(self, name: str, **attrs):
        """``with rec.span(name, sheet=...):`` around the work; a no-op
        context while the recorder is off."""
        if not self.on:
            return _OFF
        return _Open(self, name, attrs)

    def drain(self) -> List[Span]:
        """The spans recorded so far, taken out of the recorder (call it
        with no span open: a span's parent is its index in this list)."""
        if self._stack:
            raise RuntimeError(f"drain() inside open span "
                               f"{self.spans[self._stack[-1]].name!r}")
        out, self.spans = self.spans, []
        return out


#: the program's recorder
RECORDER = Recorder()
span = RECORDER.span
drain = RECORDER.drain


@contextlib.contextmanager
def recording(rec: Recorder = RECORDER):
    """The recorder on for the block, then back as it was."""
    was, rec.on = rec.on, True
    try:
        yield rec
    finally:
        rec.on = was


def chrome_trace(spans: List[Span]) -> Dict[str, list]:
    """Chrome trace-event JSON of drained spans: one complete event (``"ph":
    "X"``) a finished span, times in µs from the first span's start, the
    span's attributes and parent index under ``args``."""
    done = [(i, s) for i, s in enumerate(spans) if s.end is not None]
    t0 = min((s.start for _, s in done), default=0)
    pid = os.getpid()
    return {"traceEvents": [
        {"name": s.name, "ph": "X", "ts": (s.start - t0) / 1e3,
         "dur": s.ns / 1e3, "pid": pid, "tid": 0,
         "args": {**s.attrs, "index": i, "parent": s.parent}}
        for i, s in done], "displayTimeUnit": "ms"}
